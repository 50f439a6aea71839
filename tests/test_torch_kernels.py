"""The kernel wrappers of exon_tpu_torch: dispatch on the CPU, and kernel vs
plain twin on a CUDA card (tests marked ``cuda``, which skip where there is
none; chip_smoke.py runs the same comparison at the main path's shapes).
Tolerance: exact, except float64 sums and sums of squares in the hash
aggregate, relative 1e-12 (atomic order changes the rounding); the slot the
kernel writes for each row must hold that row's key. The twins of string_cmp, parse_number
and format_int are also held to the JAX functions they replace, bit for
bit, outside the JAX faults F8 and F10 (ROADMAP Queue 3); those of sw_score,
count_bytes, map_bytes and polya_tail are, in test_torch_udfs.py. The SQL
function kernels (span_concat, and the class runs of polya_tail, the
position mode of like_match and the word-start mode of map_bytes) are held
to exon_tpu/ops/sqlfuncs.py's _slice_var, _trim_counts, _concat_cols, _pad,
fn_repeat, fn_initcap and fn_translate and to ops/strings.py's _find_from,
exactly, on seeded strings. On a card, the list kernels (map_bytes' widen
and narrow modes, map_lookup, list_bins in both modes, bins at relative
1e-12) meet their twins and the list take its CPU result; their twins meet
the JAX functions in test_torch_lists.py and test_torch_mzml.py."""

import zlib

import numpy as np
import pytest
import torch

from exon_tpu_torch import kernels
from exon_tpu_torch.kernels import compact_mask as kc
from exon_tpu_torch.kernels import count_bytes as kcb
from exon_tpu_torch.kernels import expand_segments as ke
from exon_tpu_torch.kernels import format_int as kf
from exon_tpu_torch.kernels import gather_spans as kgs
from exon_tpu_torch.kernels import gather_var as kg
from exon_tpu_torch.kernels import hash_aggregate as hk
from exon_tpu_torch.kernels import like_match as kl
from exon_tpu_torch.kernels import line_index as kli
from exon_tpu_torch.kernels import list_bins as klb
from exon_tpu_torch.kernels import map_bytes as kmb
from exon_tpu_torch.kernels import map_lookup as kml
from exon_tpu_torch.kernels import parse_number as kp
from exon_tpu_torch.kernels import polya_tail as kpt
from exon_tpu_torch.kernels import row_hash as kr
from exon_tpu_torch.kernels import sort_keys as kk
from exon_tpu_torch.kernels import span_concat as kconcat
from exon_tpu_torch.kernels import string_cmp as kcmp
from exon_tpu_torch.kernels import string_eq as ks
from exon_tpu_torch.kernels import sw_score as ksw
from exon_tpu_torch.kernels import text_records as ktr
from exon_tpu_torch import batch as tb
from exon_tpu_torch.batch import host_pylists as host_rows
from exon_tpu_torch.errors import ExecutionError as T_ExecutionError
from exon_tpu_torch.ops import layout
from exon_tpu_torch.ops.aggregate import GroupedHashAggregate
from exon_tpu_torch.ops.strings import tokenize_like


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; chip_smoke.py runs these on one")
    return torch.device("cuda")


def _var(rng, n, device):
    lens = rng.integers(0, 50, size=n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    vals = np.frombuffer(b"ACKMW", np.uint8)[rng.integers(0, 5, int(offs[-1]))]
    return (torch.from_numpy(offs.astype(np.int32)).to(device),
            torch.from_numpy(vals.copy()).to(device))


def test_cpu_tensors_run_the_twins_without_launching():
    kernels.reset_launch_counts()
    rng = np.random.default_rng(0)
    offs, vals = _var(rng, 64, "cpu")
    mask = torch.from_numpy(rng.random(64) < 0.5)
    idx, count = kc.compact_mask(mask)
    kg.gather_var(offs, vals, idx[: int(count)])
    kl.like_match(offs, vals, tokenize_like("%KK%"), False)
    agg = GroupedHashAggregate(1, [(hk.COUNT, False)], torch.device("cpu"))
    keys = torch.from_numpy(rng.integers(0, 5, 64))[None, :]
    agg.add_batch(keys, torch.ones_like(keys, dtype=torch.uint8), mask,
                  [None], [mask], 0)
    assert agg.finalize().num_groups > 0
    lo, counts, starts, total = _pairs(rng, 64, 10, "cpu")
    ke.expand_segments(lo, counts, starts, total, 10)
    kr.row_hash(offs, vals)
    ks.string_eq((offs, vals, mask), idx[: int(count)], (offs, vals, mask),
                 idx[: int(count)])
    kk.sort_keys([kk.VarKey(offs, vals, mask, 2)], 64, "cpu")
    text = _text(rng, 300, "cpu", fastq=False)
    nl = kli.line_index(text)
    lines = ktr.text_records(text, nl, nl.shape[0] + 1, False, True)
    dst = (torch.cumsum(lines.body, 0) - lines.body).to(torch.int32)
    kgs.gather_spans(text, lines.start,
                     torch.where(lines.is_hdr, lines.start, lines.end), dst,
                     int(lines.body.sum()))
    kcmp.string_cmp(offs, vals, mask, b"AC", "<=")
    kp.parse_number(offs, vals, mask, True)
    kf.format_int(torch.arange(-5, 5), torch.ones(10, dtype=torch.bool))
    ksw.sw_score(offs, vals, torch.tensor(list(b"ACK"), dtype=torch.uint8))
    ksw.sw_score_pairwise(offs, vals, offs, vals)
    kcb.count_bytes(offs, vals, b"KM")
    kmb.map_bytes(offs, vals, torch.arange(256).to(torch.uint8).flip(0),
                  "mirror")
    keep = kpt.polya_tail(offs, vals)
    dst = (torch.cumsum(keep, 0) - keep).to(torch.int32)
    kgs.gather_spans(vals, offs[:-1], offs[:-1] + keep, dst,
                     int(keep.sum()), ())
    assert kernels.launch_counts() == dict.fromkeys(kernels.KERNEL_MODULES, 0)


def test_other_devices_raise():
    with pytest.raises(RuntimeError, match="no kernel"):
        kc.compact_mask(torch.zeros(4, dtype=torch.bool, device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        kli.line_index(torch.zeros(4, dtype=torch.uint8, device="meta"))


def _text(rng, n_records: int, device, fastq: bool) -> torch.Tensor:
    """FASTA or FASTQ text with CRLF lines, spaces in the headers and empty
    lines, ending without a newline, as a uint8 tensor."""
    parts = []
    for i in range(n_records):
        eol = b"\r\n" if i % 3 == 0 else b"\n"
        hdr = b"r%d%s" % (i, b" d>%d\r" % i if i % 4 else b"")
        body = np.frombuffer(b"ACGT\r", np.uint8)[
            rng.integers(0, 5, rng.integers(0, 200))].tobytes()
        if fastq:
            parts += [b"@" + hdr, body, b"+", body[::-1]]
        else:
            parts += [b">" + hdr, body[:70], body[70:], b""]
        parts[-1] += eol
    text = b"\n".join(parts).rstrip(b"\r\n")
    return torch.from_numpy(np.frombuffer(text, np.uint8).copy()).to(device)


def test_wrappers_check_dtypes():
    with pytest.raises(TypeError):
        kc.compact_mask(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError):
        kg.gather_var(torch.zeros(2, dtype=torch.int64),
                      torch.zeros(1, dtype=torch.uint8),
                      torch.zeros(1, dtype=torch.int32))


_OFFS = torch.tensor([0, 2, 3], dtype=torch.int32)
_VALS = torch.tensor(list(b"ACG"), dtype=torch.uint8)


@pytest.mark.parametrize("call", [
    lambda: ksw.sw_score(_OFFS.long(), _VALS, _VALS),
    lambda: ksw.sw_score(_OFFS, _VALS.to(torch.int32), _VALS),
    lambda: ksw.sw_score(_OFFS, _VALS, _VALS.to(torch.int32)),
    lambda: ksw.sw_score_pairwise(_OFFS, _VALS, _OFFS.long(), _VALS),
    lambda: kcb.count_bytes(_OFFS.long(), _VALS, b"GC"),
    lambda: kcb.count_bytes(_OFFS, _VALS.to(torch.int8), b"GC"),
    lambda: kmb.map_bytes(_OFFS, _VALS, torch.zeros(256, dtype=torch.int32),
                          "mirror"),
    lambda: kmb.map_bytes(_OFFS, _VALS, torch.zeros(255, dtype=torch.uint8),
                          "table"),
    lambda: kmb.map_bytes(_OFFS.long(), _VALS,
                          torch.zeros(256, dtype=torch.uint8), "table"),
    lambda: kmb.map_bytes(_OFFS, _VALS, torch.zeros(256, dtype=torch.uint8),
                          "word_start"),
    lambda: kpt.polya_tail(_OFFS, _VALS.to(torch.int32)),
], ids=["sw_offsets", "sw_values", "sw_query", "sw_pairwise", "count_offsets",
        "count_values", "map_table_dtype", "map_table_shape", "map_offsets",
        "map_word_start_shape", "polya_values"])
def test_new_wrappers_check_dtypes(call):
    with pytest.raises(TypeError):
        call()


@pytest.mark.parametrize("mode", [True, False, 2, "initcap"])
def test_map_bytes_takes_only_its_three_modes(mode):
    with pytest.raises(ValueError, match="mode must be one of"):
        kmb.map_bytes(_OFFS, _VALS, torch.zeros(256, dtype=torch.uint8), mode)


def test_hash_aggregate_refuses_an_integer_sum_of_squares():
    agg = GroupedHashAggregate(1, [(hk.SUMSQ, False)], torch.device("cpu"))
    keys = torch.zeros(1, 4, dtype=torch.int64)
    with pytest.raises(TypeError, match="float64"):
        hk.insert(agg.table, keys, torch.ones_like(keys, dtype=torch.uint8),
                  None, None, 0, [torch.zeros(4, dtype=torch.int64)],
                  [torch.ones(4, dtype=torch.bool)])


def test_hash_aggregate_twin_sumsq_and_slots():
    """The twin on the CPU: Σx² per group in raw mode, the partials added in
    merge mode (a rehash), and each row's slot."""
    rng = np.random.default_rng(10)
    n = 3_000
    specs, keys, kvalid, mask, values, valids = _sumsq_case(rng, n, 40,
                                                            "cpu")
    agg = GroupedHashAggregate(2, specs, torch.device("cpu"))
    agg.reserve(n)
    slots = hk.insert(agg.table, keys, kvalid, mask, None, 0, values, valids,
                      slots=True)
    _check_slots(agg, keys, kvalid, mask, slots)
    agg._rehash(2 * agg.table.capacity)
    res = agg.finalize()
    x, ok = values[1].numpy(), (valids[1] & mask).numpy()
    k = keys.numpy()
    for g in range(res.num_groups):
        rows = np.flatnonzero((k[0] == int(res.keys[0, g]))
                              & (k[1] == int(res.keys[1, g]))
                              & (kvalid[0].numpy() == int(res.key_valid[0, g]))
                              & (kvalid[1].numpy() == int(res.key_valid[1, g]))
                              & mask.numpy())
        v = x[rows][ok[rows]]
        assert int(res.cnt[2][g]) == len(v)
        np.testing.assert_allclose(float(res.acc[2][g]), (v * v).sum(),
                                   rtol=1e-12)


def test_new_wrappers_refuse_mixed_shapes_and_drops():
    with pytest.raises(ValueError, match="row count"):
        ksw.sw_score_pairwise(_OFFS, _VALS, _OFFS[:2], _VALS)
    with pytest.raises(ValueError, match="at most two"):
        kgs.gather_spans(_VALS, _OFFS[:-1], _OFFS[1:], _OFFS[:-1], 3,
                         (1, 2, 3))
    # no byte dropped: the spans copied whole
    got = kgs.gather_spans(_VALS, _OFFS[:-1], _OFFS[1:], _OFFS[:-1], 3, ())
    assert bytes(got.tolist()) == b"ACG"


@pytest.mark.cuda
def test_compact_mask_kernel_matches_twin(card):
    mask = torch.from_numpy(np.random.default_rng(1).random(70_001) < 0.3)
    mask = mask.to(card)
    got, n_got = kc.compact_mask(mask)
    want, n_want = kc.compact_mask_plain(mask)
    assert int(n_got) == int(n_want)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_gather_var_kernel_matches_twin(card):
    rng = np.random.default_rng(2)
    offs, vals = _var(rng, 5000, card)
    idx = torch.from_numpy(rng.integers(0, 5000, 3000).astype(np.int32))
    got = kg.gather_var(offs, vals, idx.to(card))
    want = kg.gather_var_plain(offs, vals, idx.to(card))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("pattern,ci", [("%KK%", False), ("A%", False),
                                        ("%A_C%", False), ("", False),
                                        ("%m%w", True)])
def test_like_match_kernel_matches_twin(card, pattern, ci):
    offs, vals = _var(np.random.default_rng(3), 5000, card)
    chunks = tokenize_like(pattern)
    assert torch.equal(kl.like_match(offs, vals, chunks, ci),
                       kl.like_match_plain(offs, vals, chunks, ci))


def _pairs(rng, n_probe, n_build, device):
    """Match ranges of a join probe: lo, counts (some 0), their layout."""
    counts = rng.integers(0, 4, n_probe).astype(np.int32)
    lo = rng.integers(0, n_build, n_probe).astype(np.int32)
    ends = np.cumsum(counts)
    return (torch.from_numpy(lo).to(device),
            torch.from_numpy(counts).to(device),
            torch.from_numpy(ends - counts).to(device), int(ends[-1]))


@pytest.mark.cuda
def test_expand_segments_kernel_matches_twin(card):
    lo, counts, starts, total = _pairs(np.random.default_rng(5), 20_000, 900,
                                       card)
    got = ke.expand_segments(lo, counts, starts, total, 900)
    want = ke.expand_segments_plain(lo, counts, starts, total, 900)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_row_hash_kernel_matches_twin(card):
    offs, vals = _var(np.random.default_rng(6), 5000, card)
    assert torch.equal(kr.row_hash(offs, vals), kr.row_hash_plain(offs, vals))


@pytest.mark.cuda
def test_string_eq_kernel_matches_twin(card):
    rng = np.random.default_rng(7)
    offs, vals = _var(rng, 3000, card)
    valid = torch.from_numpy(rng.random(3000) < 0.9).to(card)
    col = (offs, vals, valid)
    ia = torch.from_numpy(rng.integers(0, 3000, 20_000).astype(np.int32))
    ib = ia.clone()
    ib[::2] = torch.from_numpy(rng.integers(0, 3000, 10_000).astype(np.int32))
    ia, ib = ia.to(card), ib.to(card)
    got = ks.string_eq(col, ia, col, ib)
    assert torch.equal(got, ks.string_eq_plain(col, ia, col, ib))
    assert 0 < int(got.sum()) < got.shape[0]


@pytest.mark.cuda
@pytest.mark.parametrize("asc,nulls_first", [(True, None), (False, None),
                                             (True, True), (False, False)])
def test_sort_keys_kernel_matches_twin(card, asc, nulls_first):
    rng = np.random.default_rng(8)
    n = 4000
    offs, vals = _var(rng, n, card)

    def valid():
        return torch.from_numpy(rng.random(n) < 0.9).to(card)

    specs = [kk.VarKey(offs, vals, valid(), 7, asc, nulls_first)]
    for dt in (torch.int64, torch.int32, torch.float64, torch.float32,
               torch.bool, torch.int16):
        v = torch.from_numpy(rng.standard_normal(n) * 1e6).to(card)
        specs.append(kk.FixedKey(v.to(dt), valid(), asc, nulls_first))
    assert torch.equal(kk.sort_keys(specs, n, card),
                       kk.sort_keys_plain(specs, n, card))


@pytest.mark.cuda
def test_hash_aggregate_kernel_matches_twin(card):
    rng = np.random.default_rng(4)
    n = 20_000
    specs = [(hk.COUNT, False), (hk.SUM, False), (hk.MIN, False),
             (hk.SUM, True), (hk.MAX, True)]
    keys = torch.from_numpy(rng.integers(0, 300, (2, n))).to(card)
    kvalid = torch.from_numpy(rng.random((2, n)) < 0.95).to(card)
    ints = torch.from_numpy(rng.integers(-10**6, 10**6, n)).to(card)
    floats = torch.from_numpy(rng.standard_normal(n)).to(card)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(card)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(card)
    results = []
    for insert in (hk.insert, hk.insert_plain):
        agg = GroupedHashAggregate(2, specs, card)
        agg.reserve(n)
        insert(agg.table, keys, kvalid.to(torch.uint8), mask, None, 0,
               [None, ints, ints, floats, floats], [valid] * 5)
        results.append(agg.finalize())
    got, want = results
    assert torch.equal(got.keys, want.keys)
    assert torch.equal(got.key_valid, want.key_valid)
    for a in range(len(specs)):
        assert torch.equal(got.cnt[a], want.cnt[a])
    for a in (1, 2, 4):
        assert torch.equal(got.acc[a], want.acc[a])
    torch.testing.assert_close(got.acc[3], want.acc[3], rtol=1e-12, atol=0)


def _sumsq_case(rng, n: int, n_keys: int, device):
    """Two key parts, a var-family pair (SUM and SUMSQ of float64 values
    with NULLs) beside COUNT and an int64 SUM."""
    specs = [(hk.COUNT, False), (hk.SUM, True), (hk.SUMSQ, True),
             (hk.SUM, False)]
    keys = torch.from_numpy(rng.integers(0, n_keys, (2, n))).to(device)
    kvalid = torch.from_numpy(rng.random((2, n)) < 0.95).to(torch.uint8) \
        .to(device)
    floats = torch.from_numpy(rng.uniform(10, 4000, n)).to(device)
    ints = torch.from_numpy(rng.integers(-10**6, 10**6, n)).to(device)
    valid = torch.from_numpy(rng.random(n) < 0.9).to(device)
    mask = torch.from_numpy(rng.random(n) < 0.8).to(device)
    return specs, keys, kvalid, mask, [None, floats, floats, ints], \
        [valid] * 4


def _check_slots(agg, keys, kvalid, mask, slots):
    """Each kept row's slot holds the row's key; a dropped row's is -1."""
    assert torch.equal(slots < 0, ~mask)
    rows = torch.nonzero(mask).flatten()
    s = slots[rows]
    assert torch.equal(agg.table.keys[:, s], keys[:, rows])
    assert torch.equal(agg.table.key_valid[:, s], kvalid[:, rows])


@pytest.mark.cuda
@pytest.mark.parametrize("grow", [False, True], ids=["one_table", "merge"])
def test_hash_aggregate_sumsq_and_slots_match_twin(card, grow, monkeypatch):
    rng = np.random.default_rng(8)
    n = 30_000
    specs, keys, kvalid, mask, values, valids = _sumsq_case(rng, n, 2_000,
                                                            card)
    results = []
    for insert in (hk.insert, hk.insert_plain):
        # the table's own rehash goes through the same function
        monkeypatch.setattr(hk, "insert", insert)
        agg = GroupedHashAggregate(2, specs, card)
        if not grow:
            agg.reserve(n)
        for lo in range(0, n, 5_000):
            hi = lo + 5_000
            if grow:
                # a table sized for this batch alone: the next batches
                # rehash it, re-inserting the partials in merge mode
                agg.reserve(hi - lo)
            slots = insert(agg.table, keys[:, lo:hi].contiguous(),
                           kvalid[:, lo:hi].contiguous(), mask[lo:hi], None,
                           lo, [v if v is None else v[lo:hi] for v in values],
                           [v[lo:hi] for v in valids], slots=True)
            _check_slots(agg, keys[:, lo:hi], kvalid[:, lo:hi], mask[lo:hi],
                         slots)
            agg._groups_bound += hi - lo
        results.append(agg.finalize())
    got, want = results
    assert torch.equal(got.keys, want.keys)
    assert torch.equal(got.key_valid, want.key_valid)
    for a in range(len(specs)):
        assert torch.equal(got.cnt[a], want.cnt[a])
    assert torch.equal(got.acc[3], want.acc[3])
    for a in (1, 2):
        torch.testing.assert_close(got.acc[a], want.acc[a], rtol=1e-12,
                                   atol=0)


@pytest.mark.cuda
def test_hash_aggregate_sumsq_merge_mode_adds_partials(card):
    rng = np.random.default_rng(9)
    n = 4_000
    keys = torch.from_numpy(rng.integers(0, 50, (1, n))).to(card)
    kvalid = torch.ones_like(keys, dtype=torch.uint8)
    partials = torch.from_numpy(rng.uniform(0, 1e6, n)).to(card)
    counts = torch.from_numpy(rng.integers(1, 9, n)).to(card)
    first = torch.arange(n, device=card)
    results = []
    for insert in (hk.insert, hk.insert_plain):
        agg = GroupedHashAggregate(1, [(hk.SUMSQ, True)], card)
        agg.reserve(n)
        insert(agg.table, keys, kvalid, None, first, 0, [partials],
               [counts])
        results.append(agg.finalize())
    got, want = results
    assert torch.equal(got.keys, want.keys)
    assert torch.equal(got.cnt[0], want.cnt[0])
    torch.testing.assert_close(got.acc[0], want.acc[0], rtol=1e-12, atol=0)


class _Input:
    """A stand-in plan node: only its schema is read while typing."""

    def __init__(self, schema):
        self._schema = schema

    def schema(self):
        return self._schema


@pytest.mark.cuda
def test_var_key_group_by_with_whole_batches_filtered_away(card):
    """A string-key GROUP BY whose fused WHERE rejects every row of the
    first batches: key verification (string_eq) runs only on the rows that
    reach a group, and the card's result equals the CPU twins'."""
    import exon_tpu_torch as T
    from exon_tpu_torch import batch as tb
    from exon_tpu_torch import datatypes as tdt
    from exon_tpu_torch.plan import logical as TL
    from exon_tpu_torch.plan import physical as TP

    schema = tdt.Schema.of(tdt.Field("s", tdt.utf8), tdt.Field("k", tdt.int64),
                           tdt.Field("f", tdt.float64))
    rng = np.random.default_rng(12)
    words = ["", "A", "ACGT", "G" * 40 + "A", "G" * 40 + "C", None]
    host = []
    for i in range(4):
        n = 500
        k = rng.integers(1, 5, n) * (i >= 2)  # batches 0 and 1: all k == 0
        host.append(tb.Batch(schema, [
            tb.utf8_column([words[j] for j in rng.integers(0, 6, n)]),
            tb.fixed_column(k.astype(np.int64)),
            tb.fixed_column(rng.uniform(10, 4000, n),
                            rng.random(n) < 0.9)], n))
    calls = [T.count(), T.AggregateCall("stddev", T.col("f"))]
    plan = TL.Aggregate([T.col("s")], calls, ["n", "sd"], _Input(schema))
    out = []
    for dev in ("cpu", card):
        for batches in (host, host[:2]):
            kernels.reset_launch_counts()
            scan = TP.ScanExec(schema, lambda b=batches: iter(b), dev)
            out.append(TP.AggregateExec(
                plan.group_exprs, calls, plan.schema(), scan,
                pre_filter=T.col("k") > 0).collect_arrow())
            if dev == card and batches is host:
                assert ks.launches > 0
    for got, want in zip(out[2:], out[:2]):
        assert got.column("s").to_pylist() == want.column("s").to_pylist()
        assert got.column("n").to_pylist() == want.column("n").to_pylist()
        np.testing.assert_allclose(
            np.asarray(got.column("sd").fill_null(0).to_pylist()),
            np.asarray(want.column("sd").fill_null(0).to_pylist()),
            rtol=1e-12, atol=0)
    assert out[0].num_rows == 6 and out[1].num_rows == 0


@pytest.mark.cuda
def test_line_index_kernel_matches_twin(card):
    text = _text(np.random.default_rng(9), 3000, card, fastq=False)
    for part in (text, text[:4095], text[:4097], text[:17], text[:0]):
        assert torch.equal(kli.line_index(part), kli.line_index_plain(part))


@pytest.mark.cuda
@pytest.mark.parametrize("fastq,want_hdr", [(False, True), (False, False),
                                            (True, True)])
def test_text_records_kernel_matches_twin(card, fastq, want_hdr):
    text = _text(np.random.default_rng(10), 3000, card, fastq)
    nl = kli.line_index_plain(text)
    got = ktr.text_records(text, nl, nl.shape[0] + 1, fastq, want_hdr)
    want = ktr.text_records_plain(text, nl, nl.shape[0] + 1, fastq, want_hdr)
    for field in ("start", "end", "is_hdr", "body", "split", "name_len",
                  "desc_len", "bad"):
        g, w = getattr(got, field), getattr(want, field)
        assert (g is None and w is None) or torch.equal(g, w), field


@pytest.mark.cuda
def test_gather_spans_kernel_matches_twin(card):
    text = _text(np.random.default_rng(11), 3000, card, fastq=False)
    nl = kli.line_index_plain(text)
    lines = ktr.text_records_plain(text, nl, nl.shape[0] + 1, False, True)
    dst = (torch.cumsum(lines.body, 0) - lines.body).to(torch.int32)
    total = int(lines.body.sum())
    stops = torch.where(lines.is_hdr, lines.start, lines.end)
    got = kgs.gather_spans(text, lines.start, stops, dst, total, (13,))
    assert torch.equal(got, kgs.gather_spans_plain(text, lines.start, stops,
                                                   dst, total, (13,)))
    assert int((got == 13).sum()) == 0 and got.shape[0] == total
    hdr = torch.nonzero(lines.is_hdr).flatten()
    start, split = lines.start[hdr] + 1, lines.split[hdr]
    lens = lines.name_len[hdr]
    dst = (torch.cumsum(lens, 0) - lens).to(torch.int32)
    args = (text, start, split, dst, int(lens.sum()), (13, ord(">")))
    assert torch.equal(kgs.gather_spans(*args), kgs.gather_spans_plain(*args))


# -- string_cmp, parse_number and format_int ----------------------------------


@pytest.fixture(scope="module")
def jx():
    """The JAX functions the three kernels replace, on the CPU (imported
    here so that the CUDA cases of this file need no JAX)."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from exon_tpu.batch import VarColumn
    from exon_tpu.plan import expressions as E

    def var(offs, vals, valid):
        return VarColumn(jnp.asarray(vals), jnp.asarray(offs),
                         jnp.asarray(valid))

    return E, var, jnp


def _strings(strs, rng, p_null=0.06):
    """A var-width column of byte strings as numpy (offsets, values,
    validity); a NULL row keeps its bytes, as a decoded NULL may."""
    enc = [s if isinstance(s, bytes) else s.encode() for s in strs]
    offs = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    vals = np.frombuffer(b"".join(enc) or b"", np.uint8).copy()
    return offs, vals, rng.random(len(enc)) >= p_null


def _numerals(rng, n: int) -> list:
    """Seeded numerals: signs, leading zeros, dots, exponents of up to
    three digits, up to 22 digits, junk bytes, empty strings."""
    out = []
    for _ in range(n):
        s = str(rng.choice(["-", "+"])) if rng.random() < 0.3 else ""
        digits = "".join(rng.choice(list("0123456789"),
                                    int(rng.integers(0, 23))))
        if rng.random() < 0.2:
            digits = "0" * int(rng.integers(1, 5)) + digits
        if rng.random() < 0.4:
            k = int(rng.integers(0, len(digits) + 1))
            digits = digits[:k] + "." + digits[k:]
        s += digits
        if rng.random() < 0.3:
            s += str(rng.choice(["e", "E"]))
            if rng.random() < 0.5:
                s += str(rng.choice(["-", "+"]))
            s += "".join(rng.choice(list("0123456789"),
                                    int(rng.integers(0, 4))))
        if rng.random() < 0.1:
            i = int(rng.integers(0, len(s) + 1))
            s = s[:i] + str(rng.choice(list("x .e-+\x00"))) + s[i:]
        out.append(s)
    return out + ["", "0", "-0", "+", "-", ".", ".5", "5.", "1e", "1e+",
                  "1e23", "1e308", "1e309", "-1e-300", "9" * 25,
                  "9223372036854775807", "-9223372036854775808",
                  "0" * 30 + "1", "1" + "0" * 63, "1" + "0" * 64]


def _numeral_column(seed: int):
    rng = np.random.default_rng(seed)
    strs = _numerals(rng, 2000)
    return strs, _strings(strs, rng)


def _f10_int(s: str) -> bool:
    """Numerals whose JAX integer parse is wrong (F10): 20 or more
    significant digits, or a value outside int64."""
    body = s[1:] if s.startswith("-") else s
    if not body.isdigit() or not body.isascii() or len(s) > 20:
        return False
    return len(body.lstrip("0")) >= 20 or \
        not -2 ** 63 <= int(s) < 2 ** 63


def test_parse_number_int_twin_matches_jax(jx):
    E, var, _jnp = jx
    strs, (offs, vals, valid) = _numeral_column(12)
    want = E._cast_utf8_to_number(var(offs, vals, valid), np.int64)
    w_ok, w_val = np.asarray(want.validity), np.asarray(want.values)
    got, ok = kp.parse_number(torch.from_numpy(offs), torch.from_numpy(vals),
                              torch.from_numpy(valid), False)
    ok, got = ok.numpy(), got.numpy()
    f10 = np.array([_f10_int(s) for s in strs]) & valid
    assert 0 < f10.sum() and 300 < ok.sum()
    assert not ok[f10].any()
    keep = ~f10
    assert (ok[keep] == w_ok[keep]).all()
    assert (got[keep & ok] == w_val[keep & ok]).all()
    assert (got[ok] == [int(strs[i]) for i in np.flatnonzero(ok)]).all()


def test_parse_number_float_twin_matches_jax(jx):
    E, var, _jnp = jx
    strs, (offs, vals, valid) = _numeral_column(13)
    want = E._cast_utf8_to_number(var(offs, vals, valid), np.float64)
    w_ok, w_val = np.asarray(want.validity), np.asarray(want.values)
    got, ok = kp.parse_number(torch.from_numpy(offs), torch.from_numpy(vals),
                              torch.from_numpy(valid), True)
    ok, got = ok.numpy(), got.numpy()
    assert (ok == w_ok).all() and 1000 < ok.sum()
    # the JAX package on the CPU flushes a subnormal result to zero; the
    # twin and the kernel keep it, as IEEE division does
    sub = ok & (got != 0) & (np.abs(got) < np.finfo(np.float64).tiny)
    assert (w_val[sub] == 0).all()
    same = ok & ~sub
    assert (got[same].view(np.int64) == w_val[same].view(np.int64)).all()


def test_format_int_twin_matches_jax(jx):
    E, _var, jnp = jx
    rng = np.random.default_rng(14)
    pow10 = 10 ** np.arange(19, dtype=np.int64)
    # every int64 but INT64_MIN (F10): random, small, and each digit count's
    # edges
    ints = np.concatenate([
        rng.integers(-2 ** 63 + 1, 2 ** 63 - 1, 1500, dtype=np.int64),
        rng.integers(-10 ** 6, 10 ** 6, 500), pow10, pow10 - 1, -pow10,
        np.array([0, 2 ** 63 - 1, -2 ** 63 + 1], np.int64)])
    valid = rng.random(len(ints)) < 0.9
    want = E._cast_int_to_utf8(jnp.asarray(ints), jnp.asarray(valid))
    w_offs, w_vals = np.asarray(want.offsets), np.asarray(want.values)
    offs, vals = kf.format_int(torch.from_numpy(ints), torch.from_numpy(valid))
    assert (offs.numpy() == w_offs).all()
    assert vals.shape[0] == int(offs[-1])
    assert (vals.numpy() == w_vals[: int(offs[-1])]).all()
    text = vals.numpy().tobytes()
    o = offs.tolist()
    assert [text[o[i]:o[i + 1]].decode() for i in range(len(ints))] == \
        [str(v) if ok else "" for v, ok in zip(ints.tolist(), valid)]
    # F10: |INT64_MIN| overflows in the JAX function
    offs, vals = kf.format_int(torch.tensor([-2 ** 63]),
                               torch.tensor([True]))
    assert vals.numpy().tobytes() == b"-9223372036854775808"


_CMP_WORDS = [b"", b"a", b"ab", b"abc", b"abd", b"b", b"sp|P100000",
              b"sp|P099999", b"sp|P1000000", b"sp|P10000", b"\xff",
              b"a\x00", b"ACDEFGHIKLMNPQRSTVWY" * 3]


@pytest.mark.parametrize("op", ["<", "<=", ">", ">="])
def test_string_cmp_twin_matches_jax(jx, op):
    E, var, _jnp = jx
    rng = np.random.default_rng(15)
    for literal in (b"", b"a", b"ab", b"sp|P100000", b"b", b"sp|P0",
                    b"zzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzzz", b"\xff\x00"):
        words = [_CMP_WORDS[i] for i in rng.integers(0, len(_CMP_WORDS), 400)]
        offs, vals, valid = _strings(words, rng, 0.1)
        want = np.asarray(E._var_cmp_literal(var(offs, vals, valid), literal,
                                             op))
        got = kcmp.string_cmp(torch.from_numpy(offs), torch.from_numpy(vals),
                              torch.from_numpy(valid), literal, op).numpy()
        # F8: the JAX compare ignores validity
        assert (got == (want & valid)).all(), literal
        py = {"<": lambda a: a < literal, "<=": lambda a: a <= literal,
              ">": lambda a: a > literal, ">=": lambda a: a >= literal}[op]
        assert (got == np.array([py(w) for w in words]) & valid).all()


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["<", "<=", ">", ">="])
def test_string_cmp_kernel_matches_twin(card, op):
    rng = np.random.default_rng(16)
    words = [_CMP_WORDS[i] for i in rng.integers(0, len(_CMP_WORDS), 50_000)]
    cols = [torch.from_numpy(a).to(card) for a in _strings(words, rng, 0.1)]
    # the last two: the longest literal passed by value, and one that
    # needs a device buffer
    for literal in (b"", b"ab", b"sp|P100000", b"sp|P1000000zz",
                    _CMP_WORDS[-1] + b"ACDE", _CMP_WORDS[-1] + b"B" * 20):
        assert torch.equal(kcmp.string_cmp(*cols, literal, op),
                           kcmp.string_cmp_plain(*cols, literal, op))


@pytest.mark.cuda
@pytest.mark.parametrize("floating", [False, True])
def test_parse_number_kernel_matches_twin(card, floating):
    _strs, col = _numeral_column(17)
    cols = [torch.from_numpy(a).to(card) for a in col]
    got, ok = kp.parse_number(*cols, floating)
    want, w_ok = kp.parse_number_plain(*cols, floating)
    assert torch.equal(ok, w_ok)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
def test_format_int_kernel_matches_twin(card):
    rng = np.random.default_rng(18)
    ints = np.concatenate([rng.integers(-2 ** 63, 2 ** 63 - 1, 50_000,
                                        dtype=np.int64),
                           rng.integers(-1000, 1000, 5000),
                           np.array([0, -2 ** 63, 2 ** 63 - 1], np.int64)])
    vals = torch.from_numpy(ints).to(card)
    valid = torch.from_numpy(rng.random(len(ints)) < 0.9).to(card)
    got, want = kf.format_int(vals, valid), kf.format_int_plain(vals, valid)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# -- sw_score, count_bytes, map_bytes and polya_tail --------------------------


def _seqs(rng, n: int, device, max_len: int = 300, alphabet=b"ACGTacgtN",
          p_tail: float = 0.2):
    """Seeded DNA-like rows of 0-max_len bytes, some with an A/a tail and
    some all A, as a device (offsets, values)."""
    rows = []
    letters = np.frombuffer(alphabet, np.uint8)
    for _ in range(n):
        row = letters[rng.integers(0, len(letters),
                                   rng.integers(0, max_len + 1))].tobytes()
        if rng.random() < p_tail:
            row += (b"A", b"a")[rng.integers(0, 2)] * int(rng.integers(1, 40))
        if rng.random() < 0.03:
            row = b"A" * int(rng.integers(0, 60))
        rows.append(row)
    offs = np.zeros(n + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    vals = np.frombuffer(b"".join(rows), np.uint8).copy()
    return torch.from_numpy(offs).to(device), torch.from_numpy(vals).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("query", [b"AGATCGGAAGAGC", b"A", b"ACGT" * 8,
                                   b"ACGT" * 8 + b"G", b"ACGTTGCA" * 9])
def test_sw_score_kernel_matches_twin(card, query):
    # one pass (13, 1, 32 bytes), two passes (33) and three (72 > 64)
    offs, vals = _seqs(np.random.default_rng(19), 3000, card)
    q = torch.tensor(list(query), dtype=torch.uint8, device=card)
    got = ksw.sw_score(offs, vals, q)
    assert torch.equal(got, ksw.sw_score_plain(offs, vals, q))
    assert int(got.max()) > 0


@pytest.mark.cuda
def test_sw_score_pairwise_kernel_matches_twin(card):
    # row i against row i + 1, rows of up to 300 bytes (up to 10 passes)
    offs, vals = _seqs(np.random.default_rng(20), 3001, card)
    a_offs, b_offs = offs[:-1], offs[1:] - offs[1]
    b_vals = vals[int(offs[1]):]
    a_offs = a_offs.contiguous()
    got = ksw.sw_score_pairwise(a_offs, vals, b_offs.contiguous(), b_vals)
    assert torch.equal(got, ksw.sw_score_pairwise_plain(
        a_offs, vals, b_offs.contiguous(), b_vals))


@pytest.mark.cuda
def test_sw_score_kernel_aligns_rows_past_2048_bytes(card):
    # F11: the hit lies past byte 2048 of a 3,000-byte row
    adapter = b"AGATCGGAAGAGC"
    rows = [b"T" * 2900 + adapter + b"T" * 87, b"G" * 2500, adapter]
    offs = torch.tensor(np.cumsum([0] + [len(r) for r in rows]),
                        dtype=torch.int32, device=card)
    vals = torch.tensor(list(b"".join(rows)), dtype=torch.uint8, device=card)
    q = torch.tensor(list(adapter), dtype=torch.uint8, device=card)
    got = ksw.sw_score(offs, vals, q)
    assert got.tolist() == [13, 2, 13]
    assert torch.equal(got, ksw.sw_score_plain(offs, vals, q))
    long_q = torch.tensor(list(rows[0]), dtype=torch.uint8, device=card)
    assert ksw.sw_score(offs, vals, long_q).tolist() == [3000, 2, 13]
    assert torch.equal(ksw.sw_score_pairwise(offs, vals, offs, vals),
                       torch.tensor([3000, 2500, 13], dtype=torch.int32,
                                    device=card))


@pytest.mark.cuda
def test_count_map_and_polya_kernels_match_twins(card):
    offs, vals = _seqs(np.random.default_rng(21), 20_000, card)
    for members in (b"GCgc", b"A", b""):
        assert torch.equal(kcb.count_bytes(offs, vals, members),
                           kcb.count_bytes_plain(offs, vals, members))
    table = torch.from_numpy(np.random.default_rng(22).permutation(256)
                             .astype(np.uint8)).to(card)
    for mode in ("mirror", "table"):
        assert torch.equal(kmb.map_bytes(offs, vals, table, mode),
                           kmb.map_bytes_plain(offs, vals, table, mode))
    keep = kpt.polya_tail(offs, vals)
    assert torch.equal(keep, kpt.polya_tail_plain(offs, vals))
    dst = (torch.cumsum(keep, 0) - keep).to(torch.int32)
    args = (vals, offs[:-1], offs[:-1] + keep, dst, int(keep.sum()), ())
    assert torch.equal(kgs.gather_spans(*args), kgs.gather_spans_plain(*args))


# ---------------------------------------------------------------------------
# the SQL function kernels (K12): span_concat, and the new modes of
# polya_tail (class runs from either end), like_match (first position) and
# map_bytes (word starts); twins against exon_tpu/ops/sqlfuncs.py on the
# CPU, kernels against twins on the card. All exact.
# ---------------------------------------------------------------------------

_WORDS = ["Hello", "World", "  pad  ", "abc", "x1", "naïve", "café", "☃", "é",
          "ACGT", "N", "a", "-", "_", "7th", "", " ", "AGATCGGAAGAGC"]


def _text_rows(rng, n: int) -> list:
    """Seeded strings: words with spaces and punctuation, multi-byte UTF-8,
    empty rows, rows past 64 bytes and rows of one repeated byte."""
    out = []
    for i in range(n):
        k = int(rng.integers(0, 8 if i % 11 else 30))
        s = "".join(str(rng.choice(_WORDS)) + str(rng.choice(["", " ", "|"]))
                    for _ in range(k))
        if i % 17 == 3:
            s = str(rng.choice(["a", " ", "N"])) * int(rng.integers(0, 9))
        out.append(s)
    return out


def _both_vars(rng, n: int, p_null: float = 0.1):
    """The same column for both packages: (JAX VarColumn, port VarColumn,
    its numpy (offsets, values, validity))."""
    from exon_tpu.batch import VarColumn as JVarColumn

    from exon_tpu_torch.batch import VarColumn as TVarColumn

    offs, vals, valid = _strings(_text_rows(rng, n), rng, p_null)
    j = JVarColumn(vals, offs, valid)
    t = TVarColumn(torch.from_numpy(vals), torch.from_numpy(offs),
                   torch.from_numpy(valid))
    return j, t, (offs, vals, valid)


def _rows(col) -> tuple[list, list]:
    """(each row's bytes, NULL rows included; the validity) of a column of
    either package."""
    offs = np.asarray(col.offsets).tolist()
    raw = np.asarray(col.values).tobytes()
    return ([raw[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)],
            np.asarray(col.validity).tolist())


def _same_column(got, want) -> None:
    assert _rows(got) == _rows(want)


def test_slice_var_twins_match_jax(jx):
    from exon_tpu.ops import sqlfuncs as JS

    from exon_tpu_torch.ops import sqlfuncs as TS

    _E, _var, jnp = jx
    rng = np.random.default_rng(31)
    j, t, (offs, _v, _ok) = _both_vars(rng, 400)
    n = np.diff(offs)
    start = (rng.random(400) * (n + 1)).astype(np.int32)
    lens = (rng.random(400) * (n - start + 1)).astype(np.int32)
    _same_column(TS._slice_var(t, torch.from_numpy(start),
                               torch.from_numpy(lens)),
                 JS._slice_var(j, jnp.asarray(start), jnp.asarray(lens)))
    # mirrored: reverse rides map_bytes through the identity table
    _same_column(TS.fn_reverse(None, t),
                 JS._slice_var(j, jnp.zeros(400, jnp.int32), jnp.asarray(n),
                               reverse=True))


@pytest.mark.parametrize("chars", [b" ", b"aA", "é".encode(), b" |N", b""],
                         ids=["space", "two", "multibyte", "three", "empty"])
def test_trim_counts_twin_matches_jax(jx, chars):
    from exon_tpu.ops import sqlfuncs as JS

    rng = np.random.default_rng(32)
    j, t, (offs, _v, _ok) = _both_vars(rng, 400)
    lead, trail = (np.asarray(x) for x in JS._trim_counts(j, chars))
    n = np.diff(offs)
    got_lead = kpt.polya_tail(t.offsets, t.values, chars, from_start=True)
    got_keep = kpt.polya_tail(t.offsets, t.values, chars)
    assert got_lead.numpy().tolist() == lead.tolist()
    assert (n - got_keep.numpy()).tolist() == trail.tolist()


@pytest.mark.parametrize("skip_null", [True, False], ids=["concat", "pipe"])
def test_concat_cols_twin_matches_jax(jx, skip_null):
    from exon_tpu.ops import sqlfuncs as JS

    from exon_tpu_torch.ops import sqlfuncs as TS

    rng = np.random.default_rng(33)
    cols = [_both_vars(rng, 300, p_null=0.3) for _ in range(3)]
    _same_column(TS._concat_cols([c[1] for c in cols], 300, skip_null, None),
                 JS._concat_cols([c[0] for c in cols], 300, skip_null, None))


@pytest.mark.parametrize("width,pad", [(0, "*"), (5, None), (12, "xyz"),
                                       (9, "é"), (70, "ab")],
                         ids=["zero", "space", "cycle", "multibyte", "long"])
@pytest.mark.parametrize("left", [True, False], ids=["lpad", "rpad"])
def test_pad_twin_matches_jax(jx, width, pad, left):
    from exon_tpu.ops import sqlfuncs as JS

    from exon_tpu_torch.ops import sqlfuncs as TS

    rng = np.random.default_rng(34)
    j, t, _np = _both_vars(rng, 300)
    name = "lpad" if left else "rpad"
    _same_column(TS._pad(None, t, width, pad, left, name),
                 JS._pad(None, j, width, pad, left, name))


@pytest.mark.parametrize("k", [0, 1, 3])
def test_repeat_twin_matches_jax(jx, k):
    from exon_tpu.ops import sqlfuncs as JS

    from exon_tpu_torch.ops import sqlfuncs as TS

    rng = np.random.default_rng(35)
    j, t, _np = _both_vars(rng, 300)
    _same_column(TS.fn_repeat(None, t, k), JS.fn_repeat(None, j, k))


@pytest.mark.parametrize("needle", [b"a", b"AGATCGGAAGAGC", "é".encode(),
                                    b"  ", b"World|"],
                         ids=["byte", "adapter", "multibyte", "spaces",
                              "word"])
def test_find_from_twin_matches_jax(jx, needle):
    from exon_tpu.ops import strings as JST

    _E, _var, jnp = jx
    rng = np.random.default_rng(36)
    j, t, (offs, _v, _ok) = _both_vars(rng, 400)
    pos, found = JST._find_from(j, needle, jnp.asarray(offs[:-1]), False)
    want = np.where(np.asarray(found), np.asarray(pos) - offs[:-1], -1)
    got = kl.like_find(t.offsets, t.values, tuple(needle))
    assert got.numpy().tolist() == want.tolist()
    assert (want >= 0).any()


def test_initcap_and_translate_twins_match_jax(jx):
    from exon_tpu.ops import sqlfuncs as JS

    from exon_tpu_torch.ops import sqlfuncs as TS

    rng = np.random.default_rng(37)
    j, t, _np = _both_vars(rng, 400)
    _same_column(TS.fn_initcap(None, t), JS.fn_initcap(None, j))
    for frm, to in (("lo", "LO"), ("ael ", "A"), ("é", "e"), ("xyz", "")):
        _same_column(TS.fn_translate(None, t, frm, to),
                     JS.fn_translate(None, j, frm, to))


def _pieces(rng, n: int, device):
    """Two sources and five pieces: copies of source rows, cycled patterns
    (spans shorter than their pieces), empty pieces."""
    offs, vals = _var(rng, n, device)
    pat = torch.tensor(list(b"xyz"), dtype=torch.uint8, device=device)
    lens = (offs[1:] - offs[:-1]).to(torch.int32)
    zero = torch.zeros_like(lens)
    cut = torch.from_numpy(rng.integers(0, 60, n).astype(np.int32)).to(device)
    three = torch.full_like(lens, 3)
    return [vals, pat], [
        (0, offs[:-1], lens, lens),
        (1, zero, three, cut),
        (0, offs[:-1], lens.clamp(min=1), torch.where(lens > 0, 3 * lens, 0)
         .to(torch.int32)),
        (1, torch.ones_like(lens), torch.full_like(lens, 2), zero),
        (0, offs[:-1], lens, torch.minimum(lens, cut))]


def test_span_concat_twin_assembles_pieces():
    srcs = [torch.tensor(list(b"ABCDE"), dtype=torch.uint8),
            torch.tensor(list(b"xy"), dtype=torch.uint8)]
    i32 = lambda xs: torch.tensor(xs, dtype=torch.int32)  # noqa: E731
    offsets, values = kconcat.span_concat(srcs, [
        (0, i32([0, 2, 4]), i32([2, 2, 1]), i32([2, 5, 0])),
        (1, i32([0, 0, 1]), i32([2, 2, 1]), i32([3, 0, 2]))])
    assert offsets.tolist() == [0, 5, 10, 12]
    assert bytes(values.tolist()) == b"ABxyx" + b"CDCDC" + b"yy"


def test_span_concat_refuses_totals_past_int32():
    src = torch.zeros(1, dtype=torch.uint8)
    big = torch.full((2,), 1 << 30, dtype=torch.int32)
    one = torch.ones(2, dtype=torch.int32)
    with pytest.raises(T_ExecutionError, match="2\\^31"):
        kconcat.span_concat([src], [(0, one - 1, one, big)])


@pytest.mark.cuda
def test_span_concat_kernel_matches_twin(card):
    srcs, pieces = _pieces(np.random.default_rng(41), 20_000, card)
    o1, v1 = kconcat.span_concat(srcs, pieces)
    o2, v2 = kconcat.span_concat_plain(srcs, pieces)
    assert torch.equal(o1, o2) and torch.equal(v1, v2)


@pytest.mark.cuda
@pytest.mark.parametrize("members", [b"Aa", b"N", b" ", b"ACGTacgtN", b""],
                         ids=["polya", "n", "space", "all", "empty"])
def test_polya_tail_class_runs_match_twin(card, members):
    offs, vals = _seqs(np.random.default_rng(42), 20_000, card)
    for from_start in (False, True):
        assert torch.equal(
            kpt.polya_tail(offs, vals, members, from_start),
            kpt.polya_tail_plain(offs, vals, members, from_start))


@pytest.mark.cuda
@pytest.mark.parametrize("needle,ci", [(b"AGATCGGAAGAGC", False), (b"a", False),
                                       (b"acgt", True), (b"A_C", False),
                                       (b"", False)],
                         ids=["adapter", "byte", "ci", "underscore", "empty"])
def test_like_find_kernel_matches_twin(card, needle, ci):
    offs, vals = _seqs(np.random.default_rng(43), 20_000, card)
    got = kl.like_find(offs, vals, tuple(needle), ci)
    assert torch.equal(got, kl.like_find_plain(offs, vals, tuple(needle), ci))


@pytest.mark.cuda
def test_map_bytes_word_start_matches_twin(card):
    from exon_tpu_torch.ops.strings import LOWER, UPPER

    rng = np.random.default_rng(44)
    offs, vals, _ok = _strings(_text_rows(rng, 20_000), rng)
    offs, vals = torch.from_numpy(offs).to(card), torch.from_numpy(vals).to(card)
    lower = torch.from_numpy(LOWER).to(card)
    upper = torch.from_numpy(UPPER).to(card)
    initcap = torch.cat([lower, upper])
    assert torch.equal(kmb.map_bytes(offs, vals, initcap, "word_start"),
                       kmb.map_bytes_plain(offs, vals, initcap, "word_start"))
    for mode in ("table", "mirror"):  # the old modes
        assert torch.equal(kmb.map_bytes(offs, vals, upper, mode),
                           kmb.map_bytes_plain(offs, vals, upper, mode))


@pytest.mark.cuda
def test_sql_functions_on_the_card_match_the_cpu(card, tmp_path):
    """Queries J and K's functions through ExonSession.sql on the card
    equal the CPU run (every kernel against its twin, end to end)."""
    import exon_tpu_torch as T

    rng = np.random.default_rng(45)
    path = tmp_path / "t.fasta"
    path.write_text("".join(
        f">sp|P{i:06d}|PROT{i}" + (f" {s}" if i % 5 else "") + "\n"
        + "".join(rng.choice(list("ACGTKN"), int(rng.integers(0, 200))))
        + "\n" for i, s in enumerate(_text_rows(rng, 3000))))
    sql = (f"SELECT concat_ws('|', upper(id), initcap(trim(description)), "
           f"lpad(CAST(length(sequence) AS VARCHAR), 5, '0'), "
           f"rtrim(left(sequence, coalesce(nullif(strpos(sequence, 'KK'), 0)"
           f" - 1, length(sequence))), 'N'), repeat(substr(id, 5, 2), 3), "
           f"translate(description, 'ae ', 'A'), reverse(id)) AS s "
           f"FROM fasta_scan('{path}')")
    got = T.ExonSession(device="cuda").sql(sql).collect_host()
    want = T.ExonSession(device="cpu").sql(sql).collect_host()
    assert host_rows(got) == host_rows(want)


@pytest.mark.cuda
def test_literal_functions_over_a_table_run_on_the_card(card, tmp_path):
    """A function of literals only over a table (its scan projected to no
    columns) builds its column on the card and launches the kernels there:
    upper on map_bytes, concat_ws and lpad on span_concat; random draws on
    the card."""
    import exon_tpu_torch as T

    path = tmp_path / "t.fasta"
    path.write_text("".join(f">r{i}\nACGT\n" for i in range(1000)))
    sql = ("SELECT upper('abc') AS u, concat_ws('-', 'a', 'b') AS c, "
           "lpad('7', 3, '0') AS p, random() AS r "
           f"FROM fasta_scan('{path}')")
    kernels.reset_launch_counts()
    got = T.ExonSession(device="cuda").sql(sql).collect_host()
    counts = kernels.launch_counts()
    assert counts["map_bytes"] > 0 and counts["span_concat"] > 0
    rows = host_rows(got)
    assert rows[:3] == [["ABC"] * 1000, ["a-b"] * 1000, ["007"] * 1000]
    assert all(0.0 <= r < 1.0 for r in rows[3]) and len(set(rows[3])) > 900


# ---------------------------------------------------------------------------
# Windows (K10): window_bounds and window_frame
# ---------------------------------------------------------------------------

# (fn, frame, offset): every mode of window_frame, over frames that clip,
# come out empty, are wider than LOOP_ROWS, unbounded, and RANGE frames on
# an ASC and a DESC key with NULLs and ties
WINDOW_CASES = (
    [(fn, None, 1) for fn in ("row_number", "rank", "dense_rank",
                              "percent_rank", "cume_dist")]
    + [("ntile", None, 4), ("ntile", None, 1000)]
    + [("lag", None, 1), ("lead", None, 3), ("lag", None, 2)]
    + [(fn, fr, 2) for fn in ("first_value", "last_value", "nth_value")
       for fr in (None, ("rows", -2, 1), ("rows", 3, 5), ("range", -10, 10),
                  ("range", None, 0))]
    + [(fn, fr, 1) for fn in ("count", "sum", "avg", "min", "max")
       for fr in (None, ("rows", -5, 5), ("rows", -100, 0),
                  ("rows", None, -1), ("rows", 2, 1), ("range", -5, 5),
                  ("range", None, 0), ("range", 0, None))])


def _window_batch(rng, n, device, order_nulls=True):
    """A port batch of partition key p, order key o (ties; NULLs, payload
    0), values vi (int64), vf (float32) and vd (float64), 10 % NULL; the
    float values whole numbers, so float32 sums are exact in both
    packages."""
    from exon_tpu_torch.batch import Batch
    from exon_tpu_torch.datatypes import Field, Schema
    from exon_tpu_torch import datatypes as dt

    o_ok = rng.random(n) >= (0.1 if order_nulls else 0.0)
    cols = {
        "p": (rng.integers(0, 6, n).astype(np.int64), np.ones(n, bool)),
        "o": (np.where(o_ok, rng.integers(-40, 40, n), 0).astype(np.int64),
              o_ok),
        "vi": (rng.integers(-1000, 1000, n).astype(np.int64),
               rng.random(n) >= 0.1),
        "vf": (rng.integers(-500, 500, n).astype(np.float32),
               rng.random(n) >= 0.1),
        "vd": (rng.integers(-500, 500, n).astype(np.float64) / 4,
               rng.random(n) >= 0.1),
    }
    types = {"p": dt.int64, "o": dt.int64, "vi": dt.int64, "vf": dt.float32,
             "vd": dt.float64}
    schema = Schema(tuple(Field(k, types[k], True) for k in cols))
    from exon_tpu_torch.batch import FixedColumn
    batch = Batch(schema, [FixedColumn(np.where(ok, v, 0).astype(v.dtype), ok)
                           for v, ok in cols.values()], n)
    return batch.to_device(device), cols


def _port_call(fn, frame, offset, value, desc=False, default=None,
               partition=True, order=True):
    from exon_tpu_torch.plan.expressions import ColumnRef, WindowCall

    child = None if fn in ("row_number", "rank", "dense_rank", "ntile",
                           "percent_rank", "cume_dist") else ColumnRef(value)
    return WindowCall(fn, child, [ColumnRef("p")] if partition else [],
                      [(ColumnRef("o"), not desc)] if order else [], offset,
                      default, frame)


@pytest.mark.parametrize("n", [1, 7, 2048, 2049, 5000])
def test_window_bounds_twin_matches_its_definition(n):
    """Starts and ends of partitions and peer groups against a plain
    Python walk over the sorted key matrix."""
    from exon_tpu_torch.kernels import window_bounds as kwb

    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 4, (3, n)), axis=1)
    keys[1:] = rng.integers(0, 3, (2, n))
    got = [t.numpy() for t in kwb.window_bounds(torch.from_numpy(keys), 1)]
    for i in range(n):
        same_part = [j for j in range(n) if keys[0, j] == keys[0, i]]
        lo, hi = same_part[0], same_part[-1]
        pf = i
        while pf > lo and (keys[:, pf - 1] == keys[:, i]).all():
            pf -= 1
        pl = i
        while pl < hi and (keys[:, pl + 1] == keys[:, i]).all():
            pl += 1
        assert [g[i] for g in got] == [lo, hi, pf, pl], i


@pytest.mark.parametrize("fn,frame,offset", WINDOW_CASES,
                         ids=[f"{f}-{fr}-{o}" for f, fr, o in WINDOW_CASES])
def test_window_twins_match_jax(jx, fn, frame, offset):
    """window_bounds' and window_frame's twins (through the port's
    _window_column) against exon_tpu/plan/window_exec.py's _window_column
    on the same seeded columns, for int64, float32 and float64 values: the
    values exactly where valid, the validity exactly. The keys are int64, so
    neither F19 nor F20 arises."""
    import jax.numpy as jnp
    from exon_tpu.batch import Batch as JBatch, FixedColumn as JFixed
    from exon_tpu.datatypes import Field as JField, Schema as JSchema
    from exon_tpu import datatypes as jdt
    from exon_tpu.plan import window_exec as JW
    from exon_tpu.plan.expressions import ColumnRef as JRef
    from exon_tpu.plan.expressions import WindowCall as JCall
    from exon_tpu_torch.plan import window_exec as TW
    from exon_tpu_torch.plan.planner import infer_window_field

    rng = np.random.default_rng(zlib.crc32(f"{fn}{frame}{offset}".encode()))
    n = 300
    batch, cols = _window_batch(rng, n, "cpu")
    jtypes = {"p": jdt.int64, "o": jdt.int64, "vi": jdt.int64,
              "vf": jdt.float32, "vd": jdt.float64}
    jbatch = JBatch(JSchema(tuple(JField(k, jtypes[k], True) for k in cols)),
                    [JFixed(jnp.asarray(np.where(ok, v, 0).astype(v.dtype)),
                            jnp.asarray(ok)) for v, ok in cols.values()],
                    jnp.asarray(n, jnp.int32))
    for value, desc in (("vi", False), ("vf", True), ("vd", False)):
        call = _port_call(fn, frame, offset, value, desc)
        jcall = JCall(fn, None if call.child is None else JRef(value),
                      [JRef("p")], [(JRef("o"), not desc)], offset, None,
                      frame)
        want, want_ok = (np.asarray(a) for a in JW._window_column(jcall,
                                                                 jbatch))
        perm, bounds = TW._sorted_bounds(call, batch)
        field = infer_window_field(call, "w", batch.schema)
        got = TW._window_column(call, batch, perm, bounds, field)
        assert np.array_equal(got.validity.numpy(), want_ok), value
        ok = want_ok
        assert np.array_equal(got.values.numpy()[ok],
                              want[ok].astype(got.values.numpy().dtype)), \
            value


def test_window_shift_default_twin_matches_jax(jx):
    """lag/lead with a default of the values' type, against
    _window_shift through _window_column."""
    import jax.numpy as jnp
    from exon_tpu.batch import Batch as JBatch, FixedColumn as JFixed
    from exon_tpu.datatypes import Field as JField, Schema as JSchema
    from exon_tpu import datatypes as jdt
    from exon_tpu.plan import window_exec as JW
    from exon_tpu.plan.expressions import ColumnRef as JRef
    from exon_tpu.plan.expressions import WindowCall as JCall
    from exon_tpu_torch.plan import window_exec as TW
    from exon_tpu_torch.plan.planner import infer_window_field

    rng = np.random.default_rng(5)
    batch, cols = _window_batch(rng, 200, "cpu")
    jbatch = JBatch(JSchema(tuple(JField(k, jdt.float32 if k == "vf" else
                                         jdt.float64 if k == "vd" else
                                         jdt.int64, True) for k in cols)),
                    [JFixed(jnp.asarray(v), jnp.asarray(ok))
                     for v, ok in cols.values()], jnp.asarray(200, jnp.int32))
    for fn, off, default, value in (("lag", 1, -7, "vi"),
                                    ("lead", 2, 2.5, "vf"),
                                    ("lag", 3, 0.125, "vd")):
        call = _port_call(fn, None, off, value, default=default)
        jcall = JCall(fn, JRef(value), [JRef("p")], [(JRef("o"), True)],
                      off, default, None)
        want, want_ok = (np.asarray(a) for a in JW._window_column(jcall,
                                                                 jbatch))
        perm, bounds = TW._sorted_bounds(call, batch)
        got = TW._window_column(call, batch, perm, bounds,
                                infer_window_field(call, "w", batch.schema))
        assert np.array_equal(got.validity.numpy(), want_ok)
        assert np.array_equal(got.values.numpy()[want_ok],
                              want[want_ok].astype(got.values.numpy().dtype))


def test_window_wrappers_check_their_inputs():
    from exon_tpu_torch.kernels import window_bounds as kwb
    from exon_tpu_torch.kernels import window_frame as kwf

    with pytest.raises(TypeError):
        kwb.window_bounds(torch.zeros((2, 3), dtype=torch.int32), 1)
    with pytest.raises(ValueError):
        kwb.window_bounds(torch.zeros((2, 3), dtype=torch.int64), 3)
    b = tuple(torch.zeros(3, dtype=torch.int32) for _ in range(4))
    perm = torch.arange(3)
    with pytest.raises(TypeError):
        kwf.window_frame("sum", b, perm)  # needs values
    with pytest.raises(TypeError):
        kwf.window_frame("rank", b[:3] + (torch.zeros(3),), perm)
    with pytest.raises(ValueError):
        kwf.window_frame("median", b, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2048, 2049, 300_001])
def test_window_bounds_kernel_matches_twin(card, n):
    from exon_tpu_torch.kernels import window_bounds as kwb

    rng = np.random.default_rng(n)
    keys = np.sort(rng.integers(0, 40, (4, n)), axis=1)
    keys[2:] = rng.integers(0, 3, (2, n))
    keys = torch.from_numpy(keys).to(card)
    for n_part in (0, 1, 2, 4):
        got = kwb.window_bounds(keys, n_part)
        want = kwb.window_bounds_plain(keys, n_part)
        for g, w in zip(got, want):
            assert torch.equal(g, w), n_part
    empty = kwb.window_bounds(torch.zeros((0, n), dtype=torch.int64,
                                          device=card), 0)
    assert all(torch.equal(t, w) for t, w in zip(
        empty, kwb.window_bounds_plain(keys[:0], 0)))


@pytest.mark.cuda
@pytest.mark.parametrize("fn,frame,offset", WINDOW_CASES,
                         ids=[f"{f}-{fr}-{o}" for f, fr, o in WINDOW_CASES])
def test_window_frame_kernel_matches_twin(card, fn, frame, offset):
    """Every mode on the card against the twin on the card, bit for bit
    (values and validity), over int64, float32 and float64 values and an
    ASC and a DESC key."""
    from exon_tpu_torch.kernels import window_frame as kwf
    from exon_tpu_torch.plan import window_exec as TW

    rng = np.random.default_rng(7)
    batch, _cols = _window_batch(rng, 20_000, card)
    for value, desc in (("vi", False), ("vf", True), ("vd", False)):
        call = _port_call(fn, frame, offset, value, desc)
        perm, bounds = TW._sorted_bounds(call, batch)
        values = valid = fr = None
        if call.child is not None:
            values, valid = TW._values(call, batch)
        if frame is not None:
            fr = TW._frame(call, batch, perm)
        got = kwf.window_frame(fn, bounds, perm, values, valid, fr, offset)
        want = kwf.window_frame_plain(fn, bounds, perm, values, valid, fr,
                                      offset)
        assert torch.equal(got[1], want[1]), value
        assert torch.equal(got[0].view(torch.int64),
                           want[0].view(torch.int64)), value


@pytest.mark.cuda
def test_windows_and_set_operations_on_the_card_match_the_cpu(card,
                                                              tmp_path):
    """A small Query L, INTERSECT ALL, EXCEPT and ROLLUP through
    ExonSession.sql on the card equal the CPU run."""
    import exon_tpu_torch as T
    from benchlib.gff_fixture import make_gff

    gff = make_gff(5000, 3, path=str(tmp_path / "t.gff"))
    queries = [
        "SELECT seqname, start, start - lag(start) OVER (PARTITION BY "
        "seqname ORDER BY start) AS gap, COUNT(*) OVER (PARTITION BY seqname "
        "ORDER BY start RANGE BETWEEN 35000 PRECEDING AND 35000 FOLLOWING) "
        "AS n, MAX(score) OVER (PARTITION BY seqname ORDER BY start ROWS "
        "BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS mx, rank() OVER (PARTITION "
        "BY seqname ORDER BY score DESC) AS r FROM gff_scan('{g}')",
        "SELECT seqname, type FROM gff_scan('{g}') WHERE start < 90000000 "
        "INTERSECT ALL SELECT seqname, type FROM gff_scan('{g}') WHERE "
        "start > 20000000",
        "SELECT seqname, strand FROM gff_scan('{g}') EXCEPT SELECT seqname, "
        "strand FROM gff_scan('{g}') WHERE start < 50000000",
        "SELECT seqname, strand, COUNT(*) AS n FROM gff_scan('{g}') GROUP BY "
        "ROLLUP(seqname, strand)",
    ]
    for sql in queries:
        got = T.ExonSession(device="cuda").sql(sql.format(g=gff))
        want = T.ExonSession(device="cpu").sql(sql.format(g=gff))
        assert host_rows(got.collect_host()) == host_rows(
            want.collect_host()), sql


# ---------------------------------------------------------------------------
# K11b and the map lookup (list, struct and map columns)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.int8, torch.int64])
def test_map_bytes_widen_kernel_matches_twin(card, out):
    rng = np.random.default_rng(1)
    vals = torch.from_numpy(rng.integers(0, 256, 300_001, dtype=np.uint8))
    table = torch.from_numpy(rng.integers(-2**40, 2**40, 256))
    for v in (vals, vals[:1], vals[:0]):
        v, t = v.to(card), table.to(card)
        assert torch.equal(kmb.map_bytes_widen(v, t, out),
                           kmb.map_bytes_widen_plain(v, t, out))


@pytest.mark.cuda
def test_map_bytes_narrow_kernel_matches_twin(card):
    rng = np.random.default_rng(2)
    vals = np.concatenate([rng.integers(-5, 100, 200_000),
                           [2**31 - 1, -2**31, 2**40 + 7, -1, 222]])
    v = torch.from_numpy(vals).to(card)
    assert torch.equal(kmb.map_bytes_narrow(v), kmb.map_bytes_narrow_plain(v))


def _maps(rng, n, device):
    """n maps of 0-12 entries over keys of 0-6 bytes, some NULL keys."""
    per_map = rng.integers(0, 13, n)
    moff = np.zeros(n + 1, np.int32)
    np.cumsum(per_map, out=moff[1:])
    e = int(moff[-1])
    klen = rng.integers(0, 7, e)
    koff = np.zeros(e + 1, np.int32)
    np.cumsum(klen, out=koff[1:])
    kval = np.frombuffer(b"ab", np.uint8)[rng.integers(0, 2, int(koff[-1]))]
    kvalid = rng.random(e) > 0.05
    return tuple(torch.from_numpy(a).to(device)
                 for a in (moff, koff, kval, kvalid))


@pytest.mark.cuda
@pytest.mark.parametrize("key", [b"", b"a", b"ab", b"abab", b"bbbbbb"])
def test_map_lookup_kernel_matches_twin(card, key):
    args = _maps(np.random.default_rng(3), 40_000, card)
    got = kml.map_lookup(*args, key)
    assert torch.equal(got, kml.map_lookup_plain(*args, key))
    assert bool((got >= 0).any())


def _spectra(rng, n, device, edge=False):
    lens = rng.integers(0, 300, n)
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    mz = rng.uniform(50, 2100, int(offs[-1]))
    if edge and len(mz) > 4:
        mz[:4] = [np.nan, 1e300, -1e300, 100.0]
    inten = rng.uniform(0, 1e6, len(mz))
    valid = rng.random(n) > 0.1
    return tuple(torch.from_numpy(a).to(device)
                 for a in (offs, mz, inten, valid))


@pytest.mark.cuda
@pytest.mark.parametrize("edge", [False, True])
def test_list_bins_kernel_matches_twin(card, edge):
    offs, mz, inten, valid = _spectra(np.random.default_rng(4), 20_000, card,
                                      edge)
    for peak, tol in ((500.0, 0.01), (126.1277, 0.5), (100.0, 0.0)):
        assert torch.equal(klb.list_bins_peak(offs, mz, valid, peak, tol),
                           klb.list_bins_peak_plain(offs, mz, valid, peak,
                                                    tol))
    got = klb.list_bins_bins(offs, mz, inten, 100.0, 1.0, 1900)
    want = klb.list_bins_bins_plain(offs, mz, inten, 100.0, 1.0, 1900)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)


def _flat_arrays(col) -> list:
    """Every array of a column, children first to last, on the host."""
    if isinstance(col, tb.StructColumn):
        return [a for k in sorted(col.children)
                for a in _flat_arrays(col.children[k])] + [col.validity]
    if isinstance(col, tb.ListColumn):
        return _flat_arrays(col.child) + [col.offsets, col.validity]
    if isinstance(col, tb.VarColumn):
        return [col.values, col.offsets, col.validity]
    return [col.values, col.validity]


@pytest.mark.cuda
def test_list_take_on_card_matches_cpu(card, tmp_path):
    """take_column of a map column (a list of structs of a string and a list
    of strings) on the card (expand_segments, gather_var), against the same
    take on the CPU."""
    from benchlib.gencode_gff_fixture import make_gencode_gff
    from exon_tpu_torch.formats.gff import GffOptions, decode_host

    data = open(make_gencode_gff(3000, seed=5, path=str(tmp_path / "g.gff3")),
                "rb").read()
    (b,) = decode_host(data, GffOptions(batch_size=5000), ["attributes"])
    idx = torch.from_numpy(np.random.default_rng(5).integers(
        0, b.length, 4000).astype(np.int32))
    want = layout.take_batch(b.to_device("cpu"), idx)
    got = layout.take_batch(b.to_device(card), idx.to(card))
    for x, y in zip(_flat_arrays(got.columns[0]),
                    _flat_arrays(want.columns[0])):
        assert torch.equal(x.cpu(), y)


def _bucket_inputs(rng, n, hashed):
    i64 = np.iinfo(np.int64)
    keys = rng.integers(i64.min, i64.max, n, dtype=np.int64)
    keys[: min(n, 4)] = [0, -1, i64.min, i64.max][: min(n, 4)]
    route = keys if hashed else rng.integers(-1, 9, n).astype(np.int32)
    cols = [rng.random(n) < 0.5, rng.integers(0, 256, n).astype(np.uint8),
            rng.integers(-2**31, 2**31, n).astype(np.int32), keys,
            rng.standard_normal(n), rng.integers(0, 256, (n, 64)).astype(
                np.uint8), rng.integers(-9, 9, (n, 3)).astype(np.int64)]
    return route, rng.random(n) < 0.8, cols


@pytest.mark.cuda
@pytest.mark.parametrize("n,n_parts,cap,hashed,masked", [
    (0, 8, 16, True, True),
    (1, 1, 1, True, False),
    (1000, 8, 64, True, True),          # overflowing buckets
    (100_000, 8, 20_000, True, True),   # lossless
    (100_000, 1000, 256, True, False),
    (70_001, 8, 9_000, False, True),    # given destinations, some outside
])
def test_bucket_pack_kernel_matches_twin(card, n, n_parts, cap, hashed,
                                         masked):
    """bucket_pack against its twin, every output equal: the buckets of
    each column width, the true counts, the destinations and the ranks."""
    from exon_tpu_torch.kernels import bucket_pack as kb

    route, mask, cols = _bucket_inputs(np.random.default_rng(n), n, hashed)
    host = [torch.from_numpy(c) for c in cols]
    m = torch.from_numpy(mask) if masked else None
    want = kb.bucket_pack_plain(torch.from_numpy(route), m, host, n_parts,
                                cap, hashed)
    before = kb.launches
    got = kb.bucket_pack(torch.from_numpy(route).to(card),
                         None if m is None else m.to(card),
                         [c.to(card) for c in host], n_parts, cap, hashed)
    torch.cuda.synchronize()
    assert kb.launches == before + (1 if n else 0)
    for g, w in zip(got[0], want[0]):
        assert torch.equal(g.cpu(), w)
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_distributed_aggregate_on_card_matches_cpu(card, tmp_path):
    """A grouped aggregate over 8 shards of the card (hash_aggregate,
    bucket_pack and the exchange) against the same plan on the CPU."""
    import exon_tpu_torch as T
    from benchlib.gff_fixture import make_gff
    from exon_tpu_torch.config import new_exon_config
    from exon_tpu_torch.parallel import distributed as D

    gf = make_gff(20_000, 3, path=str(tmp_path / "g.gff3"))
    q = (f"SELECT seqname, start / 100000 AS w, COUNT(*) AS n, MIN(start) AS "
         f"lo, SUM(\"end\" - start + 1) AS bp, AVG(\"end\" - start + 1) AS a "
         f"FROM gff_scan('{gf}') WHERE type = 'exon' GROUP BY seqname, "
         f"start / 100000")
    out = []
    for dev in ("cpu", card):
        s = T.ExonSession(dev, device_batch_size=2048, config=new_exon_config(
            distributed=True, n_shards=8))
        kernels.reset_launch_counts()
        out.append(s.sql(q).collect_host())
    # one pack for the card's 8 shards, a second if a bucket overflowed
    assert kernels.launch_counts()["bucket_pack"] in (1, 2)
    assert D.fallbacks == 0
    for a, b in zip(out[0].columns, out[1].columns):
        if isinstance(a, tb.DictColumn):
            assert [a.vocab[i] for i in a.codes] == \
                [b.vocab[i] for i in b.codes]
        else:
            np.testing.assert_allclose(a.values, b.values, rtol=1e-12)


# ---------------------------------------------------------------------------
# hash_aggregate's warp aggregation and list_bins' block-a-row bins, at the
# shapes their designs must survive
# ---------------------------------------------------------------------------

_HASH_P = 1099511628211  # the key hash's multiplier (csrc/hash_aggregate.cu)
_WARP_SPECS = [(hk.COUNT, False), (hk.SUM, False), (hk.MIN, False),
               (hk.MAX, False), (hk.SUM, True), (hk.SUMSQ, True),
               (hk.MIN, True), (hk.MAX, True)]
_WARP_CASES = {"one_key": 4096, "ragged": 1013, "masked": 3000,
               "collision": 2055}


def _warp_case(case: str, merge: bool, device):
    """Two key parts, their validity, the row mask and per aggregate of
    _WARP_SPECS the values and counts (raw: bool validity; merge: int64
    partial counts, some 0) of one warp case:
    one_key: every lane of every warp in one group;
    ragged: n % 32 != 0, so the last warp has lanes past n;
    masked: masked rows, NULL values and NULL key parts interleaved with
    live lanes;
    collision: (5, b) and (6, b - P) in neighbouring lanes, whose 64-bit
    hashes are equal, beside a third key."""
    rng = np.random.default_rng(len(case))
    n = _WARP_CASES[case]
    lane = np.arange(n)
    kvalid = np.ones((2, n), bool)
    if case == "one_key":
        keys = np.full((2, n), 7, np.int64)
    elif case == "collision":
        b = 10**12
        keys = np.stack([np.choose(lane % 3, [5, 6, 9]),
                         np.choose(lane % 3, [b, b - _HASH_P, 9])])
    else:
        keys = rng.integers(0, 5 if case == "ragged" else 3, (2, n))
        kvalid[0] = lane % 4 != 1 if case == "masked" else \
            rng.random(n) < 0.9
    mask = lane % 3 != 1 if case == "masked" else rng.random(n) < 0.9
    if merge:
        counts = [rng.integers(0, 4, n) for _ in _WARP_SPECS]
    else:
        valid = lane % 5 != 2 if case == "masked" else rng.random(n) < 0.9
        counts = [mask] + [valid] * (len(_WARP_SPECS) - 1)
    ints = rng.integers(-10**6, 10**6, n)
    floats = rng.uniform(1.0, 1000.0, n)
    values = [None] + [ints] * 3 + [floats] * 4

    def on(a):
        return None if a is None else torch.from_numpy(np.asarray(a)).to(
            device)

    return (on(keys.astype(np.int64)), on(kvalid.astype(np.uint8)),
            on(mask), [on(v) for v in values], [on(c) for c in counts])


def _assert_same_groups(got, want, specs):
    assert torch.equal(got.keys, want.keys)
    assert torch.equal(got.key_valid, want.key_valid)
    for a, (op, is_float) in enumerate(specs):
        assert torch.equal(got.cnt[a], want.cnt[a])
        if is_float and op in (hk.SUM, hk.SUMSQ):
            torch.testing.assert_close(got.acc[a], want.acc[a], rtol=1e-12,
                                       atol=0)
        elif op != hk.COUNT:
            assert torch.equal(got.acc[a], want.acc[a])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["one_table", "grow", "merge"])
@pytest.mark.parametrize("case", sorted(_WARP_CASES))
def test_hash_aggregate_warp_cases_match_twin(card, case, mode,
                                              monkeypatch):
    """The kernel against its twin on the warp cases: in one table (each
    row's slot holds its key), through a table that grows by rehash (the
    partials re-inserted in merge mode) and on merge-mode input."""
    keys, kvalid, mask, values, counts = _warp_case(case, mode == "merge",
                                                    card)
    n = keys.shape[1]
    results = []
    for insert in (hk.insert, hk.insert_plain):
        monkeypatch.setattr(hk, "insert", insert)
        agg = GroupedHashAggregate(2, _WARP_SPECS, card)
        if mode == "merge":
            agg.reserve(n)
            first = torch.from_numpy(np.random.default_rng(1).permutation(
                n)).to(card)
            slots = insert(agg.table, keys, kvalid, None, first, 0, values,
                           counts, slots=True)
            _check_slots(agg, keys, kvalid, torch.ones_like(mask), slots)
        else:
            step = n if mode == "one_table" else 500
            for lo in range(0, n, step):
                hi = min(n, lo + step)
                agg.reserve(hi - lo)
                slots = insert(agg.table, keys[:, lo:hi].contiguous(),
                               kvalid[:, lo:hi].contiguous(), mask[lo:hi],
                               None, lo,
                               [v if v is None else v[lo:hi] for v in values],
                               [c[lo:hi] for c in counts], slots=True)
                _check_slots(agg, keys[:, lo:hi], kvalid[:, lo:hi],
                             mask[lo:hi], slots)
                agg._groups_bound += hi - lo
        results.append(agg.finalize())
    got, want = results
    _assert_same_groups(got, want, _WARP_SPECS)
    if case == "one_key":
        assert got.num_groups == 1
    if case == "collision":
        # (5, b) and (6, b - P) share a hash and stay two groups
        assert got.num_groups == 3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["one_table", "grow", "merge"])
def test_hash_aggregate_float_min_max_never_take_nan(card, mode):
    """A NaN value never replaces a float64 MIN or MAX accumulator, the
    kernel's rule before its warp aggregation too: a group whose live
    values are all NaN keeps +inf / -inf; the count still counts them. In
    one table, through a table that grows (1,500 keys in batches of 500)
    and on merge-mode input. (The twin and exon_tpu let NaN win: ROADMAP
    Queue 3, F33, open.)"""
    rng = np.random.default_rng(6)
    n = 5000
    k = rng.integers(0, 1500 if mode == "grow" else 40, n)
    x = rng.uniform(-1e3, 1e3, n)
    x[rng.random(n) < 0.3] = np.nan
    x[k == 3] = np.nan                       # a group of NaN alone
    c = rng.integers(0, 3, n) if mode == "merge" else rng.random(n) < 0.8
    keys = torch.from_numpy(k[None, :]).to(card)
    xt, ct = torch.from_numpy(x).to(card), torch.from_numpy(c).to(card)
    agg = GroupedHashAggregate(1, [(hk.MIN, True), (hk.MAX, True)], card)
    step = 500 if mode == "grow" else n
    for lo in range(0, n, step):
        hi = lo + step
        agg.reserve(hi - lo)
        hk.insert(agg.table, keys[:, lo:hi].contiguous(),
                  torch.ones_like(keys[:, lo:hi], dtype=torch.uint8), None,
                  torch.arange(lo, hi, device=card) if mode == "merge"
                  else None, lo, [xt[lo:hi]] * 2, [ct[lo:hi]] * 2)
        agg._groups_bound += hi - lo
    if mode == "grow":
        assert agg.table.capacity > 1024    # the table was rehashed
    res = agg.finalize()
    for g in range(res.num_groups):
        live = (k == int(res.keys[0, g])) & (c > 0)
        v = np.where(np.isnan(x[live]), np.inf, x[live])
        w = np.where(np.isnan(x[live]), -np.inf, x[live])
        assert int(res.cnt[0][g]) == int(c[live].sum())
        assert float(res.acc[0][g]) == v.min(initial=np.inf)
        assert float(res.acc[1][g]) == w.max(initial=-np.inf)
    assert float(res.acc[0][res.keys[0] == 3]) == np.inf


@pytest.mark.cuda
@pytest.mark.parametrize("num_bins", [1900, 30_000])
def test_list_bins_bins_variants_match_twin(card, num_bins):
    """Both bins variants (shared memory at 1,900 bins, device memory past
    SHARED_BINS_MAX) against the twin: rows longer than the block (up to
    5,000 elements), empty rows, m/z outside the range and NaN."""
    rng = np.random.default_rng(num_bins)
    lens = rng.integers(0, 5000, 300)
    lens[::7] = 0
    offs = np.zeros(301, np.int32)
    np.cumsum(lens, out=offs[1:])
    mz = rng.uniform(50, 2100, int(offs[-1]))
    mz[:3] = [np.nan, 1e300, -1e300]
    inten = rng.uniform(0, 1e6, len(mz))
    args = [torch.from_numpy(a).to(card) for a in (offs, mz, inten)]
    width = 1900.0 / num_bins
    assert klb.bins_variant(num_bins) == \
        ("shared" if num_bins == 1900 else "global")
    before = klb.launches
    got = klb.list_bins_bins(*args, 100.0, width, num_bins)
    torch.cuda.synchronize()
    assert klb.launches == before + 1
    want = klb.list_bins_bins_plain(*args, 100.0, width, num_bins)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
