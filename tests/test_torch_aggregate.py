"""The grouped hash aggregate of exon_tpu_torch (its CPU twin) held to
exon_tpu's grouped AggregateExec on JAX CPU: count/sum/min/max/avg, NULL
values, NULL keys and first-seen group order across several batches; the
seven var/stddev names grouped and ungrouped (K4b); var-width keys, NULL
apart from '', keys past 32 bytes, mixed dictionary, var-width and int64
keys, SELECT DISTINCT and COUNT(DISTINCT) on a string; a forced 64-bit
hash collision, which the port refuses where the JAX package merges (F3);
and the holistic aggregates (median, string_agg, MIN/MAX over strings and
dictionaries, with count/sum/avg/min/max/var beside them), grouped and
ungrouped, under a fused WHERE that drops whole batches, over an empty
scan, and in SQL over GFF, VCF and query J_agg's FASTA at a small size
(exact).
Tolerance: exact, except float64 sums and averages, relative 1e-12, and
var/stddev results, relative 1e-9 (the two engines add in different
orders, and Σx² − (Σx)²/n cancels)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exon_tpu as J
from exon_tpu import batch as jb
from exon_tpu import datatypes as jdt
from exon_tpu.plan import logical as JL
from exon_tpu.plan.expressions import AggregateCall as JAggregateCall
from exon_tpu.plan import physical as JP
import exon_tpu_torch as T
from exon_tpu_torch import batch as tb
from exon_tpu_torch.kernels import hash_aggregate as hk
from exon_tpu_torch.ops.aggregate import GroupedHashAggregate
from exon_tpu_torch.plan import logical as TL
from exon_tpu_torch.plan import physical as TP

FLOAT_RTOL = 1e-12

SCHEMA = jdt.Schema.of(jdt.Field("chrom", jdt.dictionary),
                       jdt.Field("k", jdt.int64),
                       jdt.Field("v", jdt.int64),
                       jdt.Field("f", jdt.float64))
VOCAB = ["chr1", "chr2", "chrX", "chrM", "chr10"]


def _batches(seed=0, n_batches=4, n=97):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        # every batch has its own vocabulary order, as the decoders make it
        vocab = list(rng.permutation(VOCAB))
        cols = [
            jb.DictColumn(rng.integers(0, len(vocab), n).astype(np.int32),
                          rng.random(n) < 0.9, tuple(vocab)),
            jb.FixedColumn(rng.integers(-3, 4, n).astype(np.int64),
                           rng.random(n) < 0.85),
            jb.FixedColumn(rng.integers(-10**6, 10**6, n).astype(np.int64),
                           rng.random(n) < 0.8),
            jb.FixedColumn(rng.standard_normal(n) * 100, rng.random(n) < 0.8),
        ]
        out.append(jb.Batch(SCHEMA, cols, np.int32(n)))
    return out


class _Input:
    """A stand-in plan node: only its schema is read while typing."""

    def __init__(self, schema):
        self._schema = schema

    def schema(self):
        return self._schema


def _calls(mod):
    """(calls, output names) of the aggregate list, in one engine's types."""
    c = mod.col
    calls = [mod.count(), mod.count(c("v")), mod.sum_(c("v")),
             mod.min_(c("v")), mod.max_(c("v")), mod.avg(c("v")),
             mod.sum_(c("f")), mod.min_(c("f")), mod.max_(c("f")),
             mod.avg(c("f")), mod.sum_(c("v") - c("k"))]
    return calls, [f"a{i}" for i in range(len(calls))]


def _run_jax(keys, batches, pre_filter=None, calls_of=_calls):
    calls, names = calls_of(J)
    schema = batches[0].schema
    plan = JL.Aggregate([J.col(k) for k in keys], calls, names,
                        _Input(schema))
    scan = JP.ScanExec(schema, lambda: iter(batches))
    return JP.AggregateExec(plan.group_exprs, calls, plan.schema(), scan,
                            pre_filter=pre_filter).collect_arrow()


def _run_port(keys, batches, pre_filter=None, calls_of=_calls):
    host = [tb.from_numpy_batch(b) for b in batches]
    schema = host[0].schema
    calls, names = calls_of(T)
    plan = TL.Aggregate([T.col(k) for k in keys], calls, names, _Input(schema))
    scan = TP.ScanExec(schema, lambda: iter(host), "cpu")
    return TP.AggregateExec(plan.group_exprs, calls, plan.schema(), scan,
                            pre_filter=pre_filter).collect_arrow()


def assert_tables_match(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.null_count == w.null_count, name
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if w.type == "double":
            gv = np.asarray(g.fill_null(0).to_pylist(), np.float64)
            wv = np.asarray(w.fill_null(0).to_pylist(), np.float64)
            np.testing.assert_allclose(gv, wv, rtol=FLOAT_RTOL, atol=0)
        else:
            assert g.to_pylist() == w.to_pylist(), name


@pytest.mark.parametrize("keys", [["chrom"], ["k"], ["chrom", "k"]],
                         ids=["dict_key", "int_key_with_nulls", "two_keys"])
def test_grouped_matches_jax(keys):
    batches = _batches()
    assert_tables_match(_run_port(keys, batches), _run_jax(keys, batches))


def test_grouped_with_fused_filter_matches_jax():
    batches = _batches(seed=4)
    want = _run_jax(["chrom"], batches, pre_filter=J.col("k") > 0)
    got = _run_port(["chrom"], batches, pre_filter=T.col("k") > 0)
    assert_tables_match(got, want)


def test_ungrouped_matches_jax():
    batches = _batches(seed=9)
    assert_tables_match(_run_port([], batches), _run_jax([], batches))


def test_table_grows_by_rehash_without_losing_groups():
    n = 5000
    keys = torch.arange(n, dtype=torch.int64).flip(0)[None, :]
    agg = GroupedHashAggregate(1, [(hk.COUNT, False), (hk.SUM, False)],
                               torch.device("cpu"))
    ones = torch.ones(n, dtype=torch.bool)
    for lo in range(0, n, 1000):
        part = keys[:, lo:lo + 1000].contiguous()
        agg.add_batch(part, torch.ones_like(part, dtype=torch.uint8),
                      ones[:1000], [None, part[0]], [ones[:1000]] * 2, lo)
    assert agg.table.capacity >= 2 * n
    res = agg.finalize()
    assert res.keys[0].tolist() == keys[0].tolist()
    assert res.cnt[0].tolist() == [1] * n
    assert res.acc[1].tolist() == keys[0].tolist()


def test_shared_content_hash_raises(monkeypatch):
    monkeypatch.setattr(TP, "_hash_bytes_host", lambda b: 1)
    with pytest.raises(T.ExonError, match="share"):
        _run_port(["chrom"], _batches(n_batches=1))


# ---------------------------------------------------------------------------
# the var/stddev family (K4b) and var-width keys
# ---------------------------------------------------------------------------

VAR_NAMES = ("stddev", "stddev_samp", "stddev_pop", "var", "variance",
             "var_samp", "var_pop")
VAR_RTOL = 1e-9  # Σx² − (Σx)²/n, summed in another order
VSCHEMA = jdt.Schema.of(jdt.Field("chrom", jdt.dictionary),
                        jdt.Field("s", jdt.utf8),
                        jdt.Field("k", jdt.int64),
                        jdt.Field("v", jdt.int64),
                        jdt.Field("f", jdt.float64))
# short strings, the empty string, and long ones that share their first
# 32 bytes
STRINGS = ["", "A", "AC", "ACGT", "T" * 7, "G" * 31 + "A", "G" * 32 + "A",
           "G" * 32 + "C", "N" * 40 + "x", "N" * 40 + "y"]


def _var_batches(seed=0, n_batches=4, n=101, k_range=60):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        vocab = list(rng.permutation(VOCAB))
        picks = rng.integers(0, len(STRINGS), n)
        data = [STRINGS[i].encode() for i in picks]
        offs = np.zeros(n + 1, np.int32)
        np.cumsum([len(d) for d in data], out=offs[1:])
        cols = [
            jb.DictColumn(rng.integers(0, len(vocab), n).astype(np.int32),
                          rng.random(n) < 0.95, tuple(vocab)),
            jb.VarColumn(np.frombuffer(b"".join(data) or b"\0", np.uint8)
                         [: offs[-1]].copy(), offs, rng.random(n) < 0.9),
            jb.FixedColumn(rng.integers(0, k_range, n).astype(np.int64),
                           rng.random(n) < 0.9),
            jb.FixedColumn(rng.integers(-10**4, 10**4, n).astype(np.int64),
                           rng.random(n) < 0.8),
            jb.FixedColumn(rng.uniform(10, 4000, n), rng.random(n) < 0.8),
        ]
        out.append(jb.Batch(VSCHEMA, cols, np.int32(n)))
    return out


def _var_calls(mod, fns=VAR_NAMES):
    c = mod.col
    call = T.AggregateCall if mod is T else JAggregateCall
    calls = [mod.count()]
    for fn in fns:
        calls += [call(fn, c("v")), call(fn, c("f"))]
    return calls, [f"a{i}" for i in range(len(calls))]


def _run_both(keys, batches, calls_of=_var_calls):
    return (_run_port(keys, batches, calls_of=calls_of),
            _run_jax(keys, batches, calls_of=calls_of))


def assert_var_tables_match(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if w.type == "double":
            np.testing.assert_allclose(
                np.asarray(g.fill_null(0).to_pylist(), np.float64),
                np.asarray(w.fill_null(0).to_pylist(), np.float64),
                rtol=VAR_RTOL, atol=0, err_msg=name)
        else:
            assert g.to_pylist() == w.to_pylist(), name


@pytest.mark.parametrize("keys", [["k"], ["chrom"], []],
                         ids=["many_small_groups", "dict_key", "ungrouped"])
def test_var_family_matches_jax(keys):
    # k over 0..599 in 404 rows: many groups of one row (NULL var/stddev
    # for the sample forms, 0 for the population ones)
    got, want = _run_both(keys, _var_batches(seed=3, k_range=600))
    assert_var_tables_match(got, want)
    if keys == ["k"]:
        assert got.column("a1").null_count > 0      # 1-row sample groups
        assert got.column("a5").null_count < got.column("a1").null_count


def test_var_family_of_all_null_input():
    batches = _var_batches(seed=5, n_batches=1)
    b = batches[0]
    for i in (3, 4):
        b.columns[i] = jb.FixedColumn(b.columns[i].values,
                                      np.zeros(b.columns[i].values.shape[0],
                                               bool))
    for keys in (["chrom"], []):
        got, want = _run_both(keys, batches)
        assert_var_tables_match(got, want)
        assert got.column("a2").null_count == got.num_rows


@pytest.mark.parametrize("keys", [["s"], ["chrom", "s", "k"], ["s", "chrom"]],
                         ids=["var_key", "dict_var_int_key", "var_dict_key"])
def test_var_width_keys_match_jax(keys):
    batches = _var_batches(seed=11)
    got, want = _run_both(keys, batches,
                          lambda mod: _var_calls(mod, ("var_samp",)))
    assert_var_tables_match(got, want)
    s = got.column("s").to_pylist()
    if keys == ["s"]:
        # NULL and '' are two groups; the long keys stay apart past 32 bytes
        assert None in s and "" in s
        assert {"G" * 32 + "A", "G" * 32 + "C", "N" * 40 + "x",
                "N" * 40 + "y"} <= set(s)
        assert len(s) == len(STRINGS) + 1


def test_var_width_keys_through_a_growing_table():
    """Enough distinct strings to rehash the table several times: the
    group ids and representatives follow the slots."""
    rng = np.random.default_rng(2)
    batches = []
    for _ in range(3):
        n = 1500
        data = [b"key%d" % v for v in rng.integers(0, 2500, n)]
        offs = np.zeros(n + 1, np.int32)
        np.cumsum([len(d) for d in data], out=offs[1:])
        cols = [jb.DictColumn(np.zeros(n, np.int32), np.ones(n, bool),
                              ("chr1",)),
                jb.VarColumn(np.frombuffer(b"".join(data), np.uint8).copy(),
                             offs, np.ones(n, bool)),
                jb.FixedColumn(np.zeros(n, np.int64), np.ones(n, bool)),
                jb.FixedColumn(rng.integers(0, 100, n).astype(np.int64),
                               np.ones(n, bool)),
                jb.FixedColumn(rng.uniform(0, 1, n), np.ones(n, bool))]
        batches.append(jb.Batch(VSCHEMA, cols, np.int32(n)))
    got, want = _run_both(["s"], batches,
                          lambda mod: _var_calls(mod, ("stddev",)))
    assert got.num_rows > 1500
    assert_var_tables_match(got, want)


@pytest.mark.parametrize("keys", [["s"], ["chrom", "s"]],
                         ids=["var_key", "dict_var_key"])
def test_var_width_keys_under_a_filter_that_drops_whole_batches(keys):
    """The fused WHERE rejects every row of the first two batches, so no
    group exists yet when their keys would be verified."""
    batches = _var_batches(seed=17)
    for b in batches[:2]:
        n = b.columns[2].values.shape[0]
        b.columns[2] = jb.FixedColumn(np.zeros(n, np.int64), np.ones(n, bool))
    calls_of = lambda mod: _var_calls(mod, ("var_pop",))  # noqa: E731
    got = _run_port(keys, batches, pre_filter=T.col("k") > 0,
                    calls_of=calls_of)
    want = _run_jax(keys, batches, pre_filter=J.col("k") > 0,
                    calls_of=calls_of)
    assert got.num_rows > 0
    assert_var_tables_match(got, want)
    # every batch filtered away: no group at all
    got = _run_port(keys, batches[:2], pre_filter=T.col("k") > 0,
                    calls_of=calls_of)
    want = _run_jax(keys, batches[:2], pre_filter=J.col("k") > 0,
                    calls_of=calls_of)
    assert got.num_rows == 0
    assert_var_tables_match(got, want)


def test_forced_hash_collision_raises_where_jax_merges(monkeypatch):
    batches = _var_batches(seed=13, n_batches=2)
    monkeypatch.setattr(TP, "row_hash", lambda offsets, values: torch.zeros(
        offsets.shape[0] - 1, dtype=torch.int64, device=offsets.device))
    with pytest.raises(T.ExonError, match="share the 64-bit row hash"):
        _run_port(["s"], batches, calls_of=_count_calls)
    # the JAX package trusts the hash: every non-NULL string in one group
    monkeypatch.setattr(JP, "_hash_var", lambda v: jnp.zeros(
        v.offsets.shape[0] - 1, jnp.int64))
    want = _run_jax(["s"], batches, calls_of=_count_calls)
    assert want.column("s").null_count == 1
    assert want.num_rows == 2


def _count_calls(mod):
    return [mod.count(), mod.sum_(mod.col("v"))], ["n", "sv"]


@pytest.fixture(scope="module")
def fasta_sessions(tmp_path_factory):
    """A FASTA whose descriptions repeat: missing (NULL), short and over 32
    bytes, registered in both packages (host decode on both sides)."""
    rng = np.random.default_rng(21)
    descs = [None, "x", "sp|P1 kinase", "a" * 33 + " long", "a" * 33 + " lone"]
    lines = []
    for i in range(600):
        d = descs[rng.integers(0, len(descs))]
        lines.append(f">r{i}" + (f" {d}" if d else ""))
        lines.append("ACGT" * int(rng.integers(1, 5)))
    path = tmp_path_factory.mktemp("agg") / "d.fasta"
    path.write_text("\n".join(lines) + "\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EXON_TPU_HOST_DECODE", "1")
        js = J.ExonSession.new_exon()
        js.config.device_batch_size = 128
        ts = T.ExonSession(device="cpu", device_batch_size=128)
        for s in (ts, js):
            s.sql(f"CREATE EXTERNAL TABLE d STORED AS FASTA LOCATION "
                  f"'{path}'")
        yield ts, js


@pytest.mark.parametrize("sql", [
    "SELECT DISTINCT description FROM d",
    "SELECT COUNT(DISTINCT description) AS n FROM d",
    "SELECT description, COUNT(*) AS n, VAR_SAMP(length(sequence)) AS v "
    "FROM d GROUP BY description",
], ids=["distinct", "count_distinct", "group_by_string"])
def test_string_distinct_and_group_by_sql_match_jax(fasta_sessions, sql):
    ts, js = fasta_sessions
    got, want = ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow()
    assert_var_tables_match(got, want)
    assert got.num_rows >= 1


# ---------------------------------------------------------------------------
# the holistic aggregates: median, string_agg and MIN/MAX over strings and
# dictionaries (exon_tpu/plan/physical.py:218-319, 495-535), on the host
# without pyarrow in the port. Tolerance: exact (float results bit for
# bit; both engines add and average in row order in float64).
# ---------------------------------------------------------------------------

HSCHEMA = jdt.Schema.of(jdt.Field("chrom", jdt.dictionary),
                        jdt.Field("s", jdt.utf8),
                        jdt.Field("k", jdt.int64),
                        jdt.Field("v", jdt.int64),
                        jdt.Field("f", jdt.float64),
                        jdt.Field("g", jdt.float32))
# code-point order differs from a naive one: 'Z' < 'a' < 'z' < 'ä' < 'é'
HSTRINGS = ["", "a", "apple", "Z", "z", "ä", "é", "éa", "naïve", "x" * 70]


def _holistic_batches(seed=0, n_batches=3, n=97, k_range=7):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        vocab = list(rng.permutation(VOCAB))
        data = [HSTRINGS[i].encode()
                for i in rng.integers(0, len(HSTRINGS), n)]
        offs = np.zeros(n + 1, np.int32)
        np.cumsum([len(d) for d in data], out=offs[1:])
        cols = [
            jb.DictColumn(rng.integers(0, len(vocab), n).astype(np.int32),
                          rng.random(n) < 0.9, tuple(vocab)),
            jb.VarColumn(np.frombuffer(b"".join(data) or b"\0", np.uint8)
                         [: offs[-1]].copy(), offs, rng.random(n) < 0.85),
            jb.FixedColumn(rng.integers(0, k_range, n).astype(np.int64),
                           rng.random(n) < 0.9),
            jb.FixedColumn(rng.integers(-50, 50, n).astype(np.int64),
                           rng.random(n) < 0.8),
            jb.FixedColumn(rng.standard_normal(n) * 10, rng.random(n) < 0.8),
            jb.FixedColumn((rng.standard_normal(n) / 3).astype(np.float32),
                           rng.random(n) < 0.8),
        ]
        out.append(jb.Batch(HSCHEMA, cols, np.int32(n)))
    return out


def _holistic_calls(mod):
    c = mod.col
    call = T.AggregateCall if mod is T else JAggregateCall
    calls = [mod.count(), call("median", c("v")), call("median", c("f")),
             call("median", c("g")), call("string_agg", c("s")),
             call("string_agg", c("s"), extra=("",)),
             call("string_agg", c("v"), extra=("|",)),
             call("string_agg", c("g"), extra=("; ",)),
             call("string_agg", c("chrom"), extra=(",",)),
             mod.min_(c("s")), mod.max_(c("s")), mod.min_(c("chrom")),
             mod.max_(c("chrom")), mod.count(c("s")), mod.sum_(c("v")),
             mod.avg(c("f")), mod.min_(c("v")), mod.max_(c("f")),
             mod.sum_(c("g")), call("var_samp", c("f")),
             call("stddev_pop", c("v"))]
    return calls, [f"h{i}" for i in range(len(calls))]


def _run_holistic(mod, keys, batches, pre_filter=None, calls_of=None):
    """One engine's AggregateExec over ``batches`` (HSCHEMA, possibly
    none at all)."""
    calls, names = (calls_of or _holistic_calls)(mod)
    if mod is J:
        plan = JL.Aggregate([J.col(k) for k in keys], calls, names,
                            _Input(HSCHEMA))
        scan = JP.ScanExec(HSCHEMA, lambda: iter(batches))
        return JP.AggregateExec(plan.group_exprs, calls, plan.schema(), scan,
                                pre_filter=pre_filter).collect_arrow()
    host = [tb.from_numpy_batch(b) for b in batches]
    schema = tb.from_numpy_batch(jb.Batch(HSCHEMA, [], np.int32(0))).schema \
        if not host else host[0].schema
    plan = TL.Aggregate([T.col(k) for k in keys], calls, names,
                        _Input(schema))
    scan = TP.ScanExec(schema, lambda: iter(host), "cpu")
    return TP.AggregateExec(plan.group_exprs, calls, plan.schema(), scan,
                            pre_filter=pre_filter).collect_arrow()


def assert_exact(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        if want.column(name).type in ("double", "float"):
            g = [None if x is None else np.float64(x).tobytes() for x in g]
            w = [None if x is None else np.float64(x).tobytes() for x in w]
        assert g == w, name


@pytest.mark.parametrize("keys", [["k"], ["chrom"], ["s"], ["chrom", "k"],
                                  []],
                         ids=["int_key", "dict_key", "string_key",
                              "dict_int_keys", "ungrouped"])
def test_holistic_aggregates_match_jax(keys):
    batches = _holistic_batches(seed=1)
    got = _run_holistic(T, keys, batches)
    assert_exact(got, _run_holistic(J, keys, batches))
    assert got.num_rows >= 1


@pytest.mark.parametrize("keys", [["k"], []], ids=["grouped", "ungrouped"])
def test_holistic_aggregates_under_a_filter_that_drops_whole_batches(keys):
    """The fused WHERE (a FilterExec on this path) rejects every row of
    the first two batches; then every row of every batch."""
    batches = _holistic_batches(seed=2, n_batches=4)
    for b in batches[:2]:
        n = b.columns[2].values.shape[0]
        b.columns[2] = jb.FixedColumn(np.zeros(n, np.int64), np.ones(n, bool))
    for part in (batches, batches[:2]):
        got = _run_holistic(T, keys, part, pre_filter=T.col("k") > 0)
        assert_exact(got, _run_holistic(J, keys, part,
                                        pre_filter=J.col("k") > 0))
    assert got.num_rows == (0 if keys else 1)


@pytest.mark.parametrize("keys", [["chrom"], []], ids=["grouped",
                                                      "ungrouped"])
def test_holistic_aggregates_over_an_empty_scan(keys):
    got = _run_holistic(T, keys, [])
    assert_exact(got, _run_holistic(J, keys, []))
    # an ungrouped aggregate over no rows is one row: count 0, NULL others
    assert got.num_rows == (0 if keys else 1)


def test_median_even_odd_and_all_null_groups():
    """k in 0..39 over 97 rows: groups of one, two and more values, some
    with every value NULL."""
    batches = _holistic_batches(seed=3, n_batches=1, k_range=40)
    b = batches[0]
    v = b.columns[3]
    b.columns[3] = jb.FixedColumn(v.values, v.validity
                                  & (b.columns[2].values % 5 != 0))
    calls_of = lambda mod: ([  # noqa: E731
        (T.AggregateCall if mod is T else JAggregateCall)("median", mod.col(c))
        for c in ("v", "f", "g")], ["mv", "mf", "mg"])
    got = _run_holistic(T, ["k"], batches, calls_of=calls_of)
    assert_exact(got, _run_holistic(J, ["k"], batches, calls_of=calls_of))
    assert got.column("mv").null_count > 0


@pytest.fixture(scope="module")
def holistic_sessions(tmp_path_factory):
    """Query J_agg's FASTA at a small size (record numbers spread over
    0-599,999, the shape benchlib.fixtures.make_fasta writes), a GFF and a
    VCF, registered in both packages."""
    from benchlib.fasta_records import fasta_records
    from benchlib.gff_fixture import make_gff
    from benchlib.vcf_fixture import make_vcf

    d = tmp_path_factory.mktemp("holistic")
    idx = np.sort(np.random.default_rng(6).choice(600_000, 1200,
                                                  replace=False)).tolist()
    flat, offs = fasta_records(len(idx), mean_len=130, seed=6)
    with open(d / "a.fasta", "wb") as f:
        for k, i in enumerate(idx):
            f.write(b">sp|P%06d|PROT%d synthetic protein %d\n%s\n"
                    % (i, i, i, flat[offs[k]:offs[k + 1]].tobytes()))
    files = {"a": str(d / "a.fasta"),
             "g": make_gff(1500, seed=5, path=str(d / "g.gff3")),
             "v": make_vcf(3000, seed=3, path=str(d / "v.vcf.gz"))}
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = 500
    ts = T.ExonSession(device="cpu", device_batch_size=500)
    yield ts, js, files


@pytest.mark.parametrize("sql", [
    # query J_agg of the smoke: 60 accession buckets, MAX of the
    # descriptions lexicographic ('… 99999' > '… 100000')
    "SELECT substr(id, 5, 2) AS bucket, COUNT(*) AS n, MIN(id) AS first_id, "
    "MAX(description) AS last_desc, MEDIAN(length(sequence)) AS median_len "
    "FROM fasta_scan('{a}') GROUP BY substr(id, 5, 2)",
    "SELECT type, MIN(seqname) AS lo, MAX(seqname) AS hi, "
    "STRING_AGG(strand, '') AS st, MEDIAN(start) AS m FROM gff_scan('{g}') "
    "GROUP BY type",
    "SELECT MIN(seqname) AS lo, MAX(source) AS hi, MEDIAN(score) AS ms "
    "FROM gff_scan('{g}') WHERE strand = '+'",
    "SELECT ref, MIN(chrom) AS lo, MAX(chrom) AS hi, MEDIAN(pos) AS m, "
    "MEDIAN(qual) AS mq, COUNT(*) AS n FROM vcf_scan('{v}') GROUP BY ref",
    "SELECT MIN(chrom) AS lo, MAX(chrom) AS hi, STRING_AGG(ref, ',') AS r "
    "FROM vcf_scan('{v}') WHERE pos < 30000000",
    "SELECT MIN(chrom) AS lo, MEDIAN(pos) AS m FROM vcf_scan('{v}') WHERE "
    "pos < 0",
], ids=["query_j_agg", "gff_grouped", "gff_ungrouped", "vcf_grouped",
        "vcf_ungrouped", "vcf_no_rows"])
def test_holistic_sql_matches_jax(holistic_sessions, sql):
    ts, js, files = holistic_sessions
    sql = sql.format(**files)
    got = ts.sql(sql).collect_arrow()
    assert_exact(got, js.sql(sql).collect_arrow())
    assert got.num_rows >= 1


@pytest.mark.parametrize("sql", [
    "SELECT ARRAY_AGG(start) AS a FROM gff_scan('{g}')",
    "SELECT seqname, ARRAY_AGG(start) AS a, ARRAY_AGG(strand) AS s, "
    "ARRAY_AGG(phase) AS p FROM gff_scan('{g}') GROUP BY seqname",
    "SELECT type, ARRAY_AGG(score) AS a FROM gff_scan('{g}') WHERE start "
    "< 40000000 GROUP BY type",
    "SELECT ARRAY_AGG(start) AS a FROM gff_scan('{g}') WHERE start < 0",
    "SELECT chrom, ARRAY_AGG(qual) AS q, ARRAY_AGG(ref) AS r FROM "
    "vcf_scan('{v}') GROUP BY chrom",
], ids=["ungrouped", "grouped", "nulls_fused_filter", "no_rows", "vcf"])
def test_array_agg_is_not_ported(holistic_sessions, sql):
    """Since item 2b + 3, array_agg is ported: each group's non-NULL values
    in row order as a list (an empty list where all are NULL, NULL over no
    rows), the JAX package's answer, exact."""
    ts, js, files = holistic_sessions
    sql = sql.format(**files)
    assert_exact(ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow())
