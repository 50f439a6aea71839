"""The twins of list_bins' bins mode and of hash_aggregate held to exon_tpu
at the shapes the Hopper kernels' designs must survive (a block a row with
the row's bins in shared memory or, past SHARED_BINS_MAX, in device memory;
rows aggregated a warp at a time before they reach the table), and the
wrappers' host helpers: the bins variant chosen from num_bins, and the
per-table ctypes arrays of hash_aggregate across a rehash.

(a) bin_vectors: a row of more than 4,096 peaks, empty and NULL rows,
num_bins of 1 and of 30,000, m/z of NaN and +-1e300. The JAX function puts
a NaN m/z into bin 0 (F30), the port drops it; the NaN case is held to the
JAX answer for the same lists with -1e300 in place of NaN, which both drop.
(b) VAR_POP, STDDEV, AVG and COUNT grouped by (chrom, ref) over 100,000
rows in which 4 SNV keys hold ~90 % of the rows, beside a few hundred rare
indel keys, through both grouped AggregateExecs.
Tolerance: exact, except float64 bins and sums, relative 1e-12, and
var/stddev, relative 1e-9 (the two engines add in different orders, and
Σx² − (Σx)²/n cancels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exon_tpu as J
from exon_tpu import batch as jb
from exon_tpu import datatypes as jdt
from exon_tpu import udfs as judfs
from exon_tpu.batch import VarColumn as JVar
from exon_tpu.plan import logical as JL
from exon_tpu.plan import physical as JP
import exon_tpu_torch as T
from exon_tpu_torch import batch as tb
from exon_tpu_torch.kernels import hash_aggregate as hk
from exon_tpu_torch.kernels import list_bins as klb
from exon_tpu_torch.ops.aggregate import GroupedHashAggregate
from exon_tpu_torch.plan import logical as TL
from exon_tpu_torch.plan import physical as TP

BINS_RTOL = 1e-12
FLOAT_RTOL = 1e-12
VAR_RTOL = 1e-9

# ---------------------------------------------------------------------------
# (a) bin_vectors
# ---------------------------------------------------------------------------


def _bins_case(case: str):
    """(offsets, mz, intensity, validity, min_mz, num_bins, bin_width)."""
    rng = np.random.default_rng(len(case))
    lens = rng.integers(0, 60, 40)
    lo, nb, w = 100.0, 1900, 1.0
    if case == "long_row":
        lens[7] = 5_000
    elif case == "empty_rows":
        lens[::2] = 0
        lens[-1] = 0
    elif case == "one_bin":
        nb, w = 1, 1900.0
    elif case == "past_shared":
        nb, w = 30_000, 1900.0 / 30_000
    offs = np.zeros(len(lens) + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    mz = rng.uniform(80, 2100, int(offs[-1]))
    if case == "nan_and_huge":
        mz[rng.random(len(mz)) < 0.1] = np.nan
        mz[rng.random(len(mz)) < 0.05] = 1e300
        mz[rng.random(len(mz)) < 0.05] = -1e300
    valid = rng.random(len(lens)) > 0.1
    return offs, mz, rng.uniform(0, 1e6, len(mz)), valid, lo, nb, w


@pytest.mark.parametrize("case", ["long_row", "empty_rows", "one_bin",
                                  "past_shared", "nan_and_huge"])
def test_bin_vectors_twin_matches_jax(case):
    offs, mz, inten, valid, lo, nb, w = _bins_case(case)
    # the JAX function's answer with NaN read as -1e300: dropped (F30)
    jmz = np.where(np.isnan(mz), -1e300, mz)
    want = np.asarray(judfs.bin_vectors(
        None, JVar(jnp.asarray(jmz), jnp.asarray(offs), jnp.asarray(valid)),
        JVar(jnp.asarray(inten), jnp.asarray(offs), jnp.asarray(valid)),
        lo, nb, w).values)
    got = klb.list_bins_bins_plain(torch.from_numpy(offs),
                                   torch.from_numpy(mz),
                                   torch.from_numpy(inten), lo, w, nb)
    assert got.shape[0] == (len(offs) - 1) * nb
    np.testing.assert_allclose(got.numpy(), want[:got.shape[0]],
                               rtol=BINS_RTOL, atol=0)
    # the CPU wrapper runs the twin
    assert torch.equal(klb.list_bins_bins(
        torch.from_numpy(offs), torch.from_numpy(mz),
        torch.from_numpy(inten), lo, w, nb), got)


@pytest.mark.parametrize("num_bins,variant", [
    (0, "shared"), (1, "shared"), (1900, "shared"),
    (klb.SHARED_BINS_MAX, "shared"), (klb.SHARED_BINS_MAX + 1, "global"),
    (30_000, "global")])
def test_bins_variant_follows_num_bins(num_bins, variant):
    """The row's float64 bins fit a block's 232,448 bytes of opt-in shared
    memory up to SHARED_BINS_MAX; past it the kernel adds in device
    memory."""
    assert klb.SHARED_BINS_MAX * 8 <= 232_448 < (klb.SHARED_BINS_MAX + 1) * 8
    assert klb.bins_variant(num_bins) == variant


# ---------------------------------------------------------------------------
# (b) the var family on hot keys
# ---------------------------------------------------------------------------

SCHEMA = jdt.Schema.of(jdt.Field("chrom", jdt.dictionary),
                       jdt.Field("ref", jdt.utf8),
                       jdt.Field("qual", jdt.float64))
CHROMS = ("chr1", "chr2", "chrX")


def _hot_batches(n: int, n_batches: int, seed: int = 0) -> list:
    """n rows in n_batches: ~90 % SNVs on chr1 (4 keys: A, C, G, T), the
    rest indel REFs of 2-9 bases over three contigs (a few hundred keys),
    qual in [0, 100) with 5 % NULL."""
    rng = np.random.default_rng(seed)
    out = []
    m = n // n_batches
    indels = ["".join(rng.choice(list("ACGT"), k)) for k in
              rng.integers(2, 10, 150)]
    for _ in range(n_batches):
        snv = rng.random(m) < 0.9
        refs = np.where(snv, rng.choice(list("ACGT"), m),
                        rng.choice(indels, m)).tolist()
        data = [r.encode() for r in refs]
        offs = np.zeros(m + 1, np.int32)
        np.cumsum([len(d) for d in data], out=offs[1:])
        chrom = np.where(snv, 0, rng.integers(0, len(CHROMS), m))
        cols = [jb.DictColumn(chrom.astype(np.int32), np.ones(m, bool),
                              CHROMS),
                jb.VarColumn(np.frombuffer(b"".join(data), np.uint8).copy(),
                             offs, np.ones(m, bool)),
                jb.FixedColumn(rng.uniform(0, 100, m), rng.random(m) > 0.05)]
        out.append(jb.Batch(SCHEMA, cols, np.int32(m)))
    return out


class _Input:
    """A stand-in plan node: only its schema is read while typing."""

    def __init__(self, schema):
        self._schema = schema

    def schema(self):
        return self._schema


def _calls(mod):
    c = mod.col
    call = T.AggregateCall if mod is T else J.AggregateCall
    calls = [mod.count(), mod.avg(c("qual")), call("stddev", c("qual")),
             call("var_pop", c("qual"))]
    return calls, ["n", "mean", "sd", "var"]


def _aggregate(mod, batches):
    calls, names = _calls(mod)
    keys = [mod.col("chrom"), mod.col("ref")]
    if mod is J:
        plan = JL.Aggregate(keys, calls, names, _Input(SCHEMA))
        scan = JP.ScanExec(SCHEMA, lambda: iter(batches))
        return JP.AggregateExec(plan.group_exprs, calls, plan.schema(),
                                scan).collect_arrow()
    host = [tb.from_numpy_batch(b) for b in batches]
    plan = TL.Aggregate(keys, calls, names, _Input(host[0].schema))
    scan = TP.ScanExec(host[0].schema, lambda: iter(host), "cpu")
    return TP.AggregateExec(plan.group_exprs, calls, plan.schema(),
                            scan).collect_arrow()


@pytest.mark.parametrize("n_batches", [1, 4])
def test_var_family_on_hot_keys_matches_jax(n_batches):
    batches = _hot_batches(100_000, n_batches)
    got, want = _aggregate(T, batches), _aggregate(J, batches)
    assert got.column_names == want.column_names
    assert got.num_rows == want.num_rows
    assert 300 <= got.num_rows <= 460
    n = got.column("n").to_pylist()
    assert sorted(n)[-4] > 20_000          # the 4 hot (chr1, SNV) groups
    for name in ("chrom", "ref", "n"):
        assert got.column(name).to_pylist() == want.column(name).to_pylist()
    for name, rtol in (("mean", FLOAT_RTOL), ("sd", VAR_RTOL),
                       ("var", VAR_RTOL)):
        g, w = got.column(name), want.column(name)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        np.testing.assert_allclose(
            np.asarray(g.fill_null(0).to_pylist(), np.float64),
            np.asarray(w.fill_null(0).to_pylist(), np.float64),
            rtol=rtol, atol=0, err_msg=name)


# ---------------------------------------------------------------------------
# hash_aggregate's host helpers
# ---------------------------------------------------------------------------


def test_hash_table_ctypes_arrays_follow_a_rehash():
    """The kernel's op and is-float arrays and the table's device pointers
    are built once a table, from its specs and tensors, and the table a
    rehash makes has its own."""
    specs = [(hk.COUNT, False), (hk.SUM, True), (hk.SUMSQ, True),
             (hk.MIN, False), (hk.MAX, True)]
    agg = GroupedHashAggregate(1, specs, torch.device("cpu"))
    old = agg.table
    keys = torch.arange(3000, dtype=torch.int64)[None, :] % 700
    x = torch.linspace(0, 1, 3000, dtype=torch.float64)
    agg.add_batch(keys, torch.ones_like(keys, dtype=torch.uint8), None,
                  [None, x, x, keys[0], x], [torch.ones(3000, dtype=bool)] * 5,
                  0)
    assert agg.table is not old and agg.table.capacity > old.capacity
    for t in (old, agg.table):
        assert list(t.c_ops) == [op for op, _f in specs]
        assert list(t.c_floats) == [int(f) for _op, f in specs]
    assert agg.table.c_ops is not old.c_ops
    assert agg.table.c_table == tuple(x.data_ptr() for x in (
        agg.table.state, agg.table.keys, agg.table.key_valid,
        agg.table.first, agg.table.acc, agg.table.cnt, agg.table.meta))
    assert agg.finalize().num_groups == 700


def test_hash_table_of_no_aggregate_has_empty_arrays():
    t = hk.HashTable.empty(2, (), 16, "cpu")
    assert len(t.c_ops) == 0 and len(t.c_floats) == 0
