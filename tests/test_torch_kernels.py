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
from exon_tpu_torch.ops.strings import LOWER, UPPER, tokenize_like


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
    lo, counts = _pairs(rng, 64, 10, "cpu")
    ke.expand_segments(lo, counts, 10)
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


# compact_mask's single pass (tiles of 4,096 rows, 16 a thread, a
# decoupled look-back over per-call status words) and map_bytes' table mode
# (one flat pass of 16-byte words): the cases of
# test_torch_redesign_k1a_k2.py, whose twins meet exon_tpu there

_COMPACT_LENGTHS = [0, 1, 15, 16, 17, 4095, 4096, 4097, 3 * 4096 + 15]


def _compact_case(kind: str, n: int) -> np.ndarray:
    if kind == "all_true":
        return np.ones(n, bool)
    if kind == "all_false":
        return np.zeros(n, bool)
    if kind == "alternating":
        return np.arange(n) % 2 == 0
    return np.random.default_rng(n).random(n) < 0.005


def _assert_compact_matches_twin(mask):
    got, n_got = kc.compact_mask(mask)
    want, n_want = kc.compact_mask_plain(mask)
    assert n_got.dim() == 0 and n_got.dtype == torch.int32
    assert int(n_got) == int(n_want)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["all_true", "all_false", "alternating",
                                  "sparse"])
def test_compact_mask_tile_edges_match_twin(card, kind):
    """Each length around a thread's 16 rows and a tile's 4,096, from an
    aligned mask and from a view one byte in (the scalar loads)."""
    for n in _COMPACT_LENGTHS:
        m = _compact_case(kind, n)
        before = kc.launches
        _assert_compact_matches_twin(torch.from_numpy(m).to(card))
        assert kc.launches == before + (n > 0)
        shifted = torch.from_numpy(np.concatenate([[True], m])).to(card)
        _assert_compact_matches_twin(shifted[1:])


@pytest.mark.cuda
def test_compact_mask_past_the_resident_blocks_matches_twin(card):
    """50 M rows: 12,208 tiles, several times the blocks the card holds at
    once, so tiles wait on tiles of blocks that started before them."""
    gen = torch.Generator(device=card)
    gen.manual_seed(50)
    mask = torch.rand(50_000_000, device=card, generator=gen) < 0.3
    _assert_compact_matches_twin(mask)


@pytest.mark.cuda
def test_compact_mask_back_to_back_calls_match_twin(card):
    """200 calls of varying lengths queued on one stream before any is
    read, then 100 more alternating between two streams: a status word or
    ticket left by an earlier call would show as a wrong index."""
    rng = np.random.default_rng(200)
    masks = [torch.from_numpy(rng.random(int(m)) < rng.random()).to(card)
             for m in rng.integers(1, 120_000, 300)]
    torch.cuda.synchronize()
    outs = [kc.compact_mask(m) for m in masks[:200]]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for i, m in enumerate(masks[200:]):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(kc.compact_mask(m))
    torch.cuda.synchronize()
    for m, (got, n_got) in zip(masks, outs):
        want, n_want = kc.compact_mask_plain(m)
        assert int(n_got) == int(n_want)
        assert torch.equal(got, want)


def _cuda_kernels(run, reps: int) -> dict:
    """{kernel name: launches} of the CUDA rows torch.profiler records over
    ``reps`` runs of ``run`` (after one outside the profile). The profiler
    now and then loses a record, so a count may fall short by one."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


@pytest.mark.cuda
def test_compact_mask_and_map_bytes_table_are_one_launch_a_call(card):
    """No count pass, cumsum or fill beside compact_mask's kernel, and no
    zero fill beside map_bytes' table-mode kernel."""
    rng = np.random.default_rng(3)
    mask = torch.from_numpy(rng.random(131_072) < 0.5).to(card)
    seen = _cuda_kernels(lambda: kc.compact_mask(mask), 5)
    assert len(seen) == 1 and 4 <= next(iter(seen.values())) <= 5, seen
    assert "compact_mask_kernel" in next(iter(seen))
    offs, vals = _map_table_case("slack_after", card)
    table = torch.from_numpy(np.random.default_rng(4).permutation(256)
                             .astype(np.uint8)).to(card)
    seen = _cuda_kernels(lambda: kmb.map_bytes(offs, vals, table, "table"), 5)
    assert len(seen) == 1 and 4 <= next(iter(seen.values())) <= 5, seen
    assert "map_table_kernel" in next(iter(seen))


_MAP_TABLE_CASES = ["from_zero", "start_past_zero", "slack_after",
                    "empty_rows", "odd_view", "no_rows"]


def _map_table_case(case: str, device):
    """(offsets, values): offsets that start at 0 or past it, slack bytes
    after offsets[n], empty rows, a values view at an odd offset, no rows;
    test_torch_redesign_k1a_k2.py's _map_case."""
    rng = np.random.default_rng(len(case))
    lens = rng.integers(0, 40, 300)
    if case == "empty_rows":
        lens[::3] = 0
        lens[-5:] = 0
    if case == "no_rows":
        lens = lens[:0]
    start = 37 if case in ("start_past_zero", "odd_view") else 0
    slack = 29 if case in ("slack_after", "odd_view", "no_rows") else 0
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    offs += start
    total = int(offs[-1]) + slack
    text = np.frombuffer(b"acgtNRY09 ,|_-ACGTzZ@[`{\x80\xe9\xff",
                         np.uint8)
    vals = torch.from_numpy(text[rng.integers(0, len(text), total + 3)])
    vals = vals.to(device)
    vals = vals[3:] if case == "odd_view" else vals[:total]
    return torch.from_numpy(offs.astype(np.int32)).to(device), vals


@pytest.mark.cuda
@pytest.mark.parametrize("case", _MAP_TABLE_CASES)
def test_map_bytes_table_cases_match_twin(card, case):
    offs, vals = _map_table_case(case, card)
    for table in (UPPER, LOWER, np.random.default_rng(5).permutation(256)
                  .astype(np.uint8)):
        t = torch.from_numpy(table).to(card)
        before = kmb.launches
        got = kmb.map_bytes(offs, vals, t, "table")
        assert kmb.launches == before + 1
        assert torch.equal(got, kmb.map_bytes_plain(offs, vals, t, "table"))


@pytest.mark.cuda
def test_map_bytes_table_at_every_alignment_matches_twin(card):
    """values at each of the 16 byte offsets from a 16-byte boundary
    (aligned loads, or two aligned loads funnel-shifted), over buffers
    shorter than the 16-byte head and far longer; the rows start a quarter
    of the buffer or 5 bytes in and end as far before its end."""
    rng = np.random.default_rng(16)
    t = torch.from_numpy(rng.permutation(256).astype(np.uint8)).to(card)
    for total in (3, 20, 100_003):
        base = torch.from_numpy(rng.integers(0, 256, total + 16)
                                .astype(np.uint8)).to(card)
        margin = min(5, total // 4)
        lens = rng.integers(0, 30, max(1, total // 10))
        ends = np.minimum(margin + np.cumsum(lens), total - margin)
        offs = torch.from_numpy(np.concatenate([[margin], ends])
                                .astype(np.int32)).to(card)
        for align in range(16):
            vals = base[align:align + total]
            assert (vals.data_ptr() - base.data_ptr()) % 16 == align
            assert torch.equal(kmb.map_bytes(offs, vals, t, "table"),
                               kmb.map_bytes_plain(offs, vals, t, "table"))


@pytest.mark.cuda
def test_gather_var_kernel_matches_twin(card):
    rng = np.random.default_rng(2)
    offs, vals = _var(rng, 5000, card)
    idx = torch.from_numpy(rng.integers(0, 5000, 3000).astype(np.int32))
    got = kg.gather_var(offs, vals, idx.to(card))
    want = kg.gather_var_plain(offs, vals, idx.to(card))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# gather_var's two passes (offsets: tiles of 1,024 taken rows and a
# look-back; copy: 4 KB of 16-byte output words a block, a row search a
# word, funnel-shifted source words) and bucket_pack's two (rank: a look-back a destination;
# move: the scatter and the zeros), at the shapes of
# test_torch_redesign_k1b_k13.py, whose twins meet exon_tpu there


def _assert_gather_matches_twin(offs, vals, idx):
    got = kg.gather_var(offs, vals, idx)
    want = kg.gather_var_plain(offs, vals, idx)
    assert got[0].dtype == torch.int32
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("lens", ["0_1_15_16_17", "short", "long",
                                  "past_the_marks", "empty"])
def test_gather_var_tile_edges_match_twin(card, lens):
    """1 and 1,023 to 3 x 1,024 + 15 taken rows (the offsets pass's
    tiles), of lengths 0, 1, 15, 16 and 17, up to 60, up to 2,000, 10-40 KB
    (more 4 KB copy blocks than the m + 1 the offsets pass marks) or all 0,
    from offsets past 0, from a values view one byte in and from one that
    ends with the last row, unsorted with repeats; m = 0 launches
    nothing."""
    rng = np.random.default_rng(len(lens))
    n = 5000
    pick = {"0_1_15_16_17": lambda: rng.choice([0, 1, 15, 16, 17], n),
            "short": lambda: rng.integers(0, 60, n),
            "long": lambda: rng.integers(0, 2000, n),
            "past_the_marks": lambda: rng.integers(10_000, 40_000, n),
            "empty": lambda: np.zeros(n, np.int64)}[lens]
    offs = np.concatenate([[0], np.cumsum(pick())]) + 37
    base = torch.from_numpy(rng.integers(0, 256, int(offs[-1]) + 8)
                            .astype(np.uint8)).to(card)
    o = torch.from_numpy(offs.astype(np.int32)).to(card)
    for m in (1, kg.TILE - 1, kg.TILE, kg.TILE + 1, 3 * kg.TILE + 15):
        idx = torch.from_numpy(rng.integers(0, n, m).astype(np.int32))
        # values one byte in, and ending with the last row (byte loads
        # within 16 bytes of the end)
        for vals in (base, base[1:], base[:int(offs[-1])]):
            before = kg.launches
            _assert_gather_matches_twin(o, vals, idx.to(card))
            assert kg.launches == before + 1
    before = kg.launches
    new_off, out = kg.gather_var(o, base, torch.zeros(0, dtype=torch.int32,
                                                      device=card))
    assert kg.launches == before and new_off.tolist() == [0]
    assert out.shape == (0,)


@pytest.mark.cuda
def test_gather_var_every_alignment_matches_twin(card):
    """Each taken long row at every source residue 0-15 from a 16-byte
    boundary and every destination residue 0-15 (a pad row of the length
    that brings the output there before it): 256 pairs in one call, again
    from values views 1-15 bytes in, and from views that end with the last
    long row."""
    rng = np.random.default_rng(16)
    lens = list(range(16)) + [16 * 6 + s for s in range(16)]
    # source rows 2j + 1: 16 pads of lengths 0-15, then 16 long rows, the
    # one of residue s starting at s past a 16-byte boundary; rows 2j are
    # the fillers between them
    starts, at = [], 0
    for i, length in enumerate(lens):
        if i >= 16:
            at += (i - 16 - at) % 16
        starts.append(at)
        at += length
    offs = np.zeros(2 * len(lens) + 1, np.int64)
    offs[1::2] = starts
    offs[2::2] = np.asarray(starts) + np.asarray(lens)
    idx, out_len = [], 0
    for s in range(16):
        for t in range(16):
            pad = (t - out_len) % 16
            idx += [2 * pad + 1, 2 * (16 + s) + 1]
            assert (starts[16 + s]) % 16 == s
            out_len += pad + lens[16 + s]
    base = torch.from_numpy(rng.integers(0, 256, at + 32).astype(np.uint8))
    base = base.to(card)
    assert base.data_ptr() % 16 == 0
    o = torch.from_numpy(offs.astype(np.int32)).to(card)
    idx = torch.from_numpy(np.asarray(idx, np.int32)).to(card)
    for shift in range(16):
        _assert_gather_matches_twin(o, base[shift:shift + at + 16], idx)
        _assert_gather_matches_twin(o, base[shift:shift + at], idx)


@pytest.mark.cuda
@pytest.mark.parametrize("repeats", [2048, 5000])
def test_gather_var_refuses_2_31_output_bytes_on_card(card, repeats):
    """One 1 MiB row taken 2,048 times (2^31 bytes) or 5,000 times (past
    2^32, where the status words saturate): ValueError after the offsets
    pass, with nothing of the output's size allocated."""
    row = 1 << 20
    offs = torch.tensor([0, row], dtype=torch.int32, device=card)
    vals = torch.zeros(row, dtype=torch.uint8, device=card)
    idx = torch.zeros(repeats, dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    with pytest.raises(ValueError, match="exceed int32"):
        kg.gather_var(offs, vals, idx)
    assert torch.cuda.max_memory_allocated(card) - base < 1 << 26


@pytest.mark.cuda
def test_gather_var_past_the_resident_blocks_matches_twin(card):
    """50 M taken rows of 0-3 bytes: 48,829 offset tiles, several times the
    blocks the card holds at once."""
    gen = torch.Generator(device=card)
    gen.manual_seed(50)
    n = 1_000_000
    lens = torch.randint(0, 4, (n,), device=card, generator=gen)
    offs = torch.zeros(n + 1, dtype=torch.int32, device=card)
    offs[1:] = torch.cumsum(lens, 0)
    vals = torch.randint(0, 256, (int(offs[-1]),), device=card,
                         generator=gen).to(torch.uint8)
    idx = torch.randint(0, n, (50_000_000,), device=card, generator=gen,
                        dtype=torch.int32)
    _assert_gather_matches_twin(offs, vals, idx)


@pytest.mark.cuda
def test_single_pass_scans_back_to_back_match_twins(card):
    """200 calls of compact_mask, gather_var and bucket_pack in turn,
    queued on one stream before any is read (they share its status words
    and ticket counter), then 100 more alternating between two streams: a
    word or ticket left by an earlier call would show as a wrong output."""
    from exon_tpu_torch.kernels import bucket_pack as kb

    rng = np.random.default_rng(300)
    cases = []
    for i in range(300):
        n = int(rng.integers(1, 60_000))
        if i % 3 == 0:
            cases.append(("compact", torch.from_numpy(
                rng.random(n) < rng.random()).to(card)))
        elif i % 3 == 1:
            offs, vals = _var(rng, n, card)
            cases.append(("gather", offs, vals, torch.from_numpy(
                rng.integers(0, n, int(rng.integers(0, 9000)))
                .astype(np.int32)).to(card)))
        else:
            keys = torch.from_numpy(rng.integers(-2**40, 2**40, n)).to(card)
            parts = int(rng.choice([1, 8, 33]))
            cases.append(("bucket", keys, keys, parts,
                          int(rng.integers(0, 2 * n // parts + 2))))

    def run(case):
        if case[0] == "compact":
            return kc.compact_mask(case[1])
        if case[0] == "gather":
            return kg.gather_var(*case[1:])
        _k, keys, col, parts, cap = case
        return kb.bucket_pack(keys, None, [col], parts, cap)

    def twin(case):
        if case[0] == "compact":
            return kc.compact_mask_plain(case[1])
        if case[0] == "gather":
            return kg.gather_var_plain(*case[1:])
        _k, keys, col, parts, cap = case
        return kb.bucket_pack_plain(keys, None, [col], parts, cap)

    torch.cuda.synchronize()
    outs = [run(c) for c in cases[:200]]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for i, c in enumerate(cases[200:]):
        with torch.cuda.stream(streams[i % 2]):
            outs.append(run(c))
    torch.cuda.synchronize()
    for c, got in zip(cases, outs):
        want = twin(c)
        if c[0] == "bucket":
            got = got[0] + list(got[1:])
            want = want[0] + list(want[1:])
        for a, b in zip(got, want):
            assert torch.equal(a, b), c[0]


@pytest.mark.cuda
def test_gather_var_and_bucket_pack_launches_a_call(card):
    """gather_var: its offsets and copy kernels and the one copy of the
    total to the host; bucket_pack with 17 columns: its rank and move
    kernels, and nothing else (no fill, cumsum or index_select)."""
    from exon_tpu_torch.kernels import bucket_pack as kb

    rng = np.random.default_rng(4)
    offs, vals = _var(rng, 50_000, card)
    idx = torch.from_numpy(rng.integers(0, 50_000, 40_000)
                           .astype(np.int32)).to(card)
    seen = _cuda_kernels(lambda: kg.gather_var(offs, vals, idx), 5)
    kernels_seen = {k: c for k, c in seen.items() if "Memcpy" not in k}
    assert len(kernels_seen) == 2, seen
    assert all(4 <= c <= 5 for c in kernels_seen.values()), seen
    assert any("gather_offsets_kernel" in k for k in kernels_seen)
    assert any("gather_copy_kernel" in k for k in kernels_seen)
    assert len(seen) <= 3, seen
    n = 60_000
    keys = torch.from_numpy(rng.integers(-2**40, 2**40, n)).to(card)
    cols = [torch.from_numpy(c).to(card)
            for c in _bucket_inputs(rng, n, True)[2]]
    cols = (cols * 3)[: kb.MAX_COLS]
    seen = _cuda_kernels(lambda: kb.bucket_pack(keys, None, cols, 8,
                                                16_384), 5)
    assert len(seen) == 2 and all(4 <= c <= 5 for c in seen.values()), seen
    assert any("bucket_rank_kernel" in k for k in seen)
    assert any("bucket_move_kernel" in k for k in seen)


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
    """Match ranges of a join probe: lo and counts (some 0)."""
    counts = rng.integers(0, 4, n_probe).astype(np.int32)
    lo = rng.integers(0, n_build, n_probe).astype(np.int32)
    return (torch.from_numpy(lo).to(device),
            torch.from_numpy(counts).to(device))


def _expand_cases(rng, device):
    """(label, lo, counts, n_build) for expand_segments: C's probe batch
    and one of 1.5 M rows, empty and all-zero inputs, row counts around
    the offsets tile, slots starting just before, at and after every
    multiple of the slot tile, a row of 2^20 slots, one of 2^22 among
    131,071 rows of 0-2 slots, batches where most rows have no slot or
    long runs of rows have none (more rows than a write block stages), an
    empty build side and counts not 16-byte aligned."""
    S = ke.SLOT_TILE

    def case(label, counts, n_build=900):
        counts = np.asarray(counts, np.int32)
        lo = rng.integers(0, max(n_build, 1), counts.shape[0]).astype(
            np.int32)
        return (label, torch.from_numpy(lo).to(device),
                torch.from_numpy(counts).to(device), n_build)

    out = [case("C's probe batch", rng.poisson(1.27, 131_072), 60_991),
           case("1.5 M rows", rng.poisson(1.27, 1_500_000), 60_991),
           case("no rows", []), case("all zero", np.zeros(5000))]
    for d in (-1, 0, 1):
        # rows of 3 slots (after two of none) start at k S + d
        edges = []
        for k in range(1, 6):
            edges += [1] * (k * S + d - sum(edges)) + [0, 0, 3]
        out.append(case(f"slot tile edges {d:+d}", edges))
    out += [case("2^20 slots", [0, 2, 1 << 20, 1, 0, 3]),
            case("skewed", np.insert(rng.integers(0, 3, 131_071), 70_000,
                                     1 << 22)),
            case("sparse", (rng.random(131_073) < 0.002) * 2),
            case("sparse tail", np.r_[np.ones(10), np.zeros(20_000)]),
            case("runs of empty rows", np.tile(np.r_[rng.poisson(
                1.3, 3000), np.zeros(9000)], 11)),
            case("empty build side", rng.integers(0, 4, 3000), 0)]
    for n in (1, 2, 3, 4, 5, 1023, 1024, 1025, 4097, 131_073):
        out.append(case(f"{n} rows of 0-3", rng.integers(0, 4, n)))
    label, lo, counts, nb = case("unaligned", rng.integers(0, 4, 5001))
    out.append((label, lo[1:], counts[1:], nb))
    return out


@pytest.mark.cuda
def test_expand_segments_kernel_matches_twin(card):
    """The two launches and the total's read against the twin, all four
    outputs exactly, at every shape of _expand_cases."""
    for label, lo, counts, n_build in _expand_cases(
            np.random.default_rng(5), card):
        got = ke.expand_segments(lo, counts, n_build)
        want = ke.expand_segments_plain(lo, counts, n_build)
        assert got[3] == want[3], label
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(g, w), label


@pytest.mark.cuda
def test_row_hash_kernel_matches_twin(card):
    offs, vals = _var(np.random.default_rng(6), 5000, card)
    assert torch.equal(kr.row_hash(offs, vals), kr.row_hash_plain(offs, vals))


# row_hash runs a thread's chain a byte a step; sort_keys reads each row in
# place, two chunks a 16-byte word (byte loads only within 16 bytes of the
# end of values), all keys in one launch of up to 16. The cases below put
# rows on each side of every word and chunk edge and of a warp's and a
# tile's rows; "64 KB row", "long rows in a warp" and "wide rows" hold
# long rows beside short ones.
HASH_LENS = [0, 1, 7, 8, 9, 15, 16, 17, 39, 40, 41, 255, 256, 257]
HASH_CASES = ["lengths", "every byte", "64 KB row", "offsets past 0",
              "tight end 5", "tight end 16", "tight end 300", "no rows",
              "one row", "tile edges", "long rows in a warp", "wide rows"]


def _byte_rows(rng, lens) -> list:
    return [bytes(rng.integers(0, 256, int(k), dtype=np.uint8))
            for k in lens]


def hash_case(case: str) -> tuple:
    """numpy (offsets int32, values uint8) of a row_hash case."""
    rng = np.random.default_rng(len(case) + 100)
    pad = tail = 0
    if case == "lengths":
        # every length at every alignment mod 16
        rows, _at = _aligned(_byte_rows(rng, HASH_LENS * 16),
                             [t for t in range(16) for _ in HASH_LENS])
    elif case == "every byte":
        # b + 1 = 256 at b = 255: each value alone, in a run, and in order
        rows = ([bytes([b]) for b in range(256)]
                + [bytes([b]) * 17 for b in range(256)]
                + [bytes(range(256)), bytes(range(255, -1, -1)),
                   b"\xff" * 300, b"\x00" * 257])
    elif case == "64 KB row":
        rows = (_byte_rows(rng, rng.integers(0, 60, 40))
                + _byte_rows(rng, [65_536 + 13])
                + _byte_rows(rng, rng.integers(0, 60, 40)))
    elif case == "offsets past 0":
        rows = _byte_rows(rng, rng.integers(0, 300, 500))
        pad, tail = 13, 29
    elif case.startswith("tight end"):
        rows = _byte_rows(rng, list(rng.integers(0, 70, 40))
                          + [int(case.split()[-1])])
    elif case == "no rows":
        rows = []
    elif case == "one row":
        rows = _byte_rows(rng, [23])
    elif case == "tile edges":
        # 3 tiles of 256 rows and one more
        rows = _byte_rows(rng, rng.integers(0, 60, 3 * 256 + 1))
    elif case == "wide rows":
        # past 256 bytes a row on average: rows of 0-3,000
        lens = rng.integers(0, 3001, 300)
        lens[:20] = [0, 1, 15, 16, 17, 255, 256, 257, 511, 512, 513, 0, 2,
                     31, 32, 33, 1024, 1025, 4096, 4111]
        rows = _byte_rows(rng, lens)
    else:
        assert case == "long rows in a warp"
        lens = rng.integers(0, 60, 300)
        long_at = [0, 31, 32, 33, 63, 64, 100, 101, 102, 103, 104, 299]
        lens[long_at] = rng.integers(257, 3000, len(long_at))
        lens[104] = 511
        lens[299] = 16 * 32 * 3 + 1
        rows = _byte_rows(rng, lens)
    offs, vals, _ok = eq_column(rows, pad=pad, tail=tail)
    return offs, vals


def _on_view(vals: torch.Tensor, off: int) -> torch.Tensor:
    """vals as a view at byte ``off`` of a larger buffer that ends with
    it."""
    base = torch.zeros(vals.shape[0] + off, dtype=torch.uint8,
                       device=vals.device)
    base[off:] = vals
    return base[off:]


def _one_kernel(run, reps: int) -> dict:
    """_cuda_kernels, taken again (up to three profiles in all) where the
    profiler lost the whole window and recorded no kernel."""
    for _ in range(3):
        seen = _cuda_kernels(run, reps)
        if seen:
            break
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("case", HASH_CASES)
def test_row_hash_kernel_matches_twin_at_its_edges(card, case):
    """Every case on values at offsets 0, 1, 3, 7 and 15 of their storage
    (each ending at the case's end), bit for bit; one launch a call."""
    offs, vals = (torch.from_numpy(t).to(card) for t in hash_case(case))
    want = kr.row_hash_plain(offs, vals)
    for off in (0, 1, 3, 7, 15):
        assert torch.equal(kr.row_hash(offs, _on_view(vals, off)), want), off
    if offs.shape[0] > 1:
        seen = _one_kernel(lambda: kr.row_hash(offs, vals), 5)
        assert len(seen) == 1 and "row_hash_kernel" in next(iter(seen)), seen


@pytest.mark.cuda
def test_row_hash_kernel_takes_a_1mb_row(card):
    """A 1 MiB row (one thread's 1 M steps) and its neighbours against the
    host mirror of the hash."""
    from exon_tpu_torch.plan.physical import _hash_bytes_host

    rng = np.random.default_rng(11)
    rows = _byte_rows(rng, [5, (1 << 20) + 7, 300, 0, 40])
    offs, vals, _ok = eq_column(rows)
    got = kr.row_hash(torch.from_numpy(offs).to(card),
                      torch.from_numpy(vals).to(card))
    assert got.cpu().tolist() == [_hash_bytes_host(r) for r in rows]


SORT_CASES = ["lengths", "every byte", "nchunks 1-9", "long rows",
              "offsets past 0", "tight end", "no rows", "one row",
              "tile edges", "fixed kinds", "many keys"]
# (asc, nulls_first): the default placement either way, then NULLS FIRST
# and NULLS LAST
PLACEMENTS = [(True, None), (False, None), (True, True), (False, False)]
INT64_EDGES = [-(1 << 63), -(1 << 63) + 1, -1, 0, 1, (1 << 63) - 1]
# +-0, NaN, +-inf, the least subnormals and the largest finite values
FLOAT_EDGES = {np.float64: [0.0, -0.0, np.nan, np.inf, -np.inf, 5e-324,
                            -5e-324, 1.5, -1.5, 1.7e308, -1.7e308],
               np.float32: [0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45,
                            -1e-45, 1.5, -1.5, 3.4e38, -3.4e38]}


def _var_key(rows: list, rng, nchunks: int, pad: int = 0,
             tail: int = 0) -> dict:
    offs, vals, _ok = eq_column(rows, pad=pad, tail=tail)
    return {"offsets": offs, "values": vals, "nchunks": nchunks,
            "validity": rng.random(len(rows)) >= 0.1}


def _fixed_key(values: np.ndarray, rng) -> dict:
    return {"values": values, "validity": rng.random(len(values)) >= 0.1}


def _fixed_values(rng, dtype, n: int) -> np.ndarray:
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    if np.issubdtype(dtype, np.floating):
        v = (rng.standard_normal(n) * 1e6).astype(dtype)
        edges = FLOAT_EDGES[dtype][:n]
        v[: len(edges)] = np.asarray(edges, dtype)
        return v
    info = np.iinfo(dtype)
    v = rng.integers(info.min, info.max, n, dtype=dtype, endpoint=True)
    edges = [e for e in INT64_EDGES if info.min <= e <= info.max]
    v[: len(edges)] = np.asarray(edges[:n], dtype)
    return v


FIXED_DTYPES = [np.int64, np.int32, np.float64, np.float32, np.bool_,
                np.int16, np.int8, np.uint8]


def sort_case(case: str) -> tuple:
    """(n, keys) of a sort_keys case: each key a dict of numpy arrays,
    "offsets", "values" and "nchunks" for a var key, "values" for a fixed
    one, and "validity"."""
    rng = np.random.default_rng(len(case) + 200)
    if case == "lengths":
        rows, _at = _aligned(_byte_rows(rng, HASH_LENS * 16),
                             [t for t in range(16) for _ in HASH_LENS])
        keys = [_var_key(rows, rng, 33)]
    elif case == "every byte":
        # 0x00, 0x7f, 0x80 and 0xff at every byte of a chunk
        rows = [bytes([b]) * k for b in range(256) for k in (1, 8, 9)]
        rows += [bytes(8 * [0x41]) + bytes([b]) + b"A" * (7 - j)
                 for b in (0, 0x7f, 0x80, 0xff) for j in range(8)]
        keys = [_var_key(rows, rng, 3)]
    elif case == "nchunks 1-9":
        rows = _byte_rows(rng, rng.integers(0, 80, 600))
        keys = [_var_key(rows, rng, c) for c in range(1, 10)]
    elif case == "long rows":
        # a 30,000-byte row cut at 3 chunks, and 39 and 40 chunks (an odd
        # and an even count of 16-byte words) of rows of 100-320 bytes
        rows = _byte_rows(rng, rng.integers(0, 60, 700))
        rows[300] = _byte_rows(rng, [30_000])[0]
        wide = _byte_rows(rng, rng.integers(100, 321, 700))
        keys = [_var_key(rows, rng, 3), _var_key(wide, rng, 39),
                _var_key(wide, rng, 40)]
    elif case == "offsets past 0":
        rows = _byte_rows(rng, rng.integers(0, 70, 500))
        keys = [_var_key(rows, rng, 9, pad=13, tail=29),
                _var_key(rows[::-1], rng, 2, pad=70, tail=3)]
    elif case == "tight end":
        # the last row ends the values buffer at 5, 13 and 300 bytes
        keys = [_var_key(_byte_rows(rng, list(rng.integers(0, 70, 300))
                                    + [k]), rng, c)
                for k, c in ((5, 1), (13, 3), (300, 38))]
    elif case in ("no rows", "one row"):
        n = 0 if case == "no rows" else 1
        keys = [_var_key(_byte_rows(rng, rng.integers(0, 30, n)), rng, 4)]
        keys += [_fixed_key(_fixed_values(rng, dt, n), rng)
                 for dt in FIXED_DTYPES]
    elif case == "tile edges":
        n = 3 * 256 + 1
        keys = [_var_key(_byte_rows(rng, rng.integers(0, 40, n)), rng, 5),
                _fixed_key(_fixed_values(rng, np.int64, n), rng)]
    elif case == "fixed kinds":
        keys = [_fixed_key(_fixed_values(rng, dt, 1000), rng)
                for dt in FIXED_DTYPES]
    else:
        assert case == "many keys"
        # past the 16 keys a launch's parameters hold: 3 launches
        n = 400
        keys = []
        for j in range(35):
            if j % 3 == 0:
                keys.append(_var_key(_byte_rows(rng, rng.integers(0, 30, n)),
                                     rng, 1 + j % 5))
            else:
                keys.append(_fixed_key(_fixed_values(
                    rng, FIXED_DTYPES[j % len(FIXED_DTYPES)], n), rng))
    n = len(keys[0]["validity"])
    return n, keys


def sort_specs(keys: list, placement: tuple, device, shift: int = 0
               ) -> list:
    """kk.VarKey/FixedKey specs of sort_case's keys on ``device``, key j
    under PLACEMENTS[(i + j) % 4] when ``shift`` is set, else all under
    ``placement``."""
    i = PLACEMENTS.index(placement)
    specs = []
    for j, k in enumerate(keys):
        asc, first = PLACEMENTS[(i + j) % 4] if shift else placement
        t = {name: torch.from_numpy(np.ascontiguousarray(k[name])).to(device)
             for name in ("values", "validity", "offsets") if name in k}
        if "offsets" in k:
            specs.append(kk.VarKey(t["offsets"], t["values"], t["validity"],
                                   k["nchunks"], asc, first))
        else:
            specs.append(kk.FixedKey(t["values"], t["validity"], asc, first))
    return specs


@pytest.mark.cuda
@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_keys_kernel_matches_twin_at_its_edges(card, case, placement):
    """Every case, its var keys' values also at offsets 1, 7 and 15 of
    their storage, bit for bit; ceil(keys / 16) launches a call, nothing
    else on the card."""
    n, keys = sort_case(case)
    specs = sort_specs(keys, placement, card, shift=case == "many keys")
    want = kk.sort_keys_plain(specs, n, card)
    assert torch.equal(kk.sort_keys(specs, n, card), want)
    for off in (1, 7, 15):
        moved = [kk.VarKey(s.offsets, _on_view(s.values, off), s.validity,
                           s.nchunks, s.asc, s.nulls_first)
                 if isinstance(s, kk.VarKey) else s for s in specs]
        assert torch.equal(kk.sort_keys(moved, n, card), want), off
    if n:
        seen = _one_kernel(lambda: kk.sort_keys(specs, n, card), 5)
        assert len(seen) == 1 and "sort_keys_kernel" in next(iter(seen)), \
            seen
        launches = -(-len(specs) // kk.MAX_KEYS)
        assert next(iter(seen.values())) in (5 * launches,
                                             5 * launches - 1), seen


@pytest.mark.cuda
def test_sort_keys_is_one_launch_at_c_d_and_l_shapes(card):
    """The key sets of Queries C (ref, start, name, gene_start), D (ref,
    start, name) and L (chrom, pos) in one launch each: no fill of the
    padding row, no other kernel."""
    rng = np.random.default_rng(13)
    n = 20_000
    ref = _var_key([b"chr%d" % k for k in rng.integers(1, 23, n)], rng, 1)
    name = _var_key(_byte_rows(rng, rng.integers(30, 41, n)), rng, 5)
    start = _fixed_key(rng.integers(1, 1 << 28, n), rng)
    gene = _fixed_key(rng.integers(1, 1 << 28, n), rng)
    for keys in ([ref, start, name, gene], [ref, start, name], [ref, start]):
        specs = sort_specs(keys, (True, None), card)
        assert torch.equal(kk.sort_keys(specs, n, card),
                           kk.sort_keys_plain(specs, n, card))
        kernels.reset_launch_counts()
        kk.sort_keys(specs, n, card)
        assert kk.launches == 1
        seen = _one_kernel(lambda: kk.sort_keys(specs, n, card), 5)
        assert len(seen) == 1 and "sort_keys_kernel" in next(iter(seen)), \
            seen


# string_eq reads both rows as 16-byte words, 64 bytes a row a step, and
# stops only between steps: pairs that differ at each byte either side of a
# word and of a step, rows at every alignment in each column, a values
# buffer that ends at its last row (the byte loads of copy16::load_run),
# offsets past 0, NULL against empty, repeats, no pairs, and long keys
EQ_DIFFER_AT = [0, 15, 16, 17, 31, 32, 33, 63, 64, 65]
EQ_CASES = ["null vs empty", "differ at", "alignments", "tight end 5",
            "tight end 16", "tight end 37", "offsets past 0", "repeats",
            "no pairs", "rows 20000", "long keys"]


def eq_column(rows: list, valid=None, pad: int = 0, tail: int = 0) -> tuple:
    """A numpy (offsets, values, validity) of byte rows, after ``pad``
    bytes and before ``tail`` bytes that belong to no row."""
    offs = np.zeros(len(rows) + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    vals = np.frombuffer(b"#" * pad + b"".join(rows) + b"~" * tail,
                         np.uint8).copy()
    ok = np.ones(len(rows), bool) if valid is None else np.asarray(valid)
    return (offs + pad).astype(np.int32), vals, ok


def _eq_rows(rng, n: int, lo: int, hi: int) -> list:
    return [bytes(rng.integers(65, 91, int(k), dtype=np.uint8))
            for k in rng.integers(lo, hi + 1, n)]


def _aligned(rows: list, aligns: list) -> tuple:
    """rows, each after a filler that starts it at its alignment mod 16;
    returns (all rows, the given rows' indices among them)."""
    out, at, pos = [], [], 0
    for r, align in zip(rows, aligns):
        fill = (align - pos) % 16
        out.append(b"f" * fill)
        at.append(len(out))
        out.append(r)
        pos += fill + len(r)
    return out, at


def eq_case(case: str) -> tuple:
    """(a, ia, b, ib) of a string_eq case: two numpy columns and int32
    indices of equal length."""
    rng = np.random.default_rng(len(case))
    a = b = ia = ib = None
    if case == "null vs empty":
        a = eq_column([b"", b"", b"", b"x", b""],
                      [True, False, True, True, False])
        b = eq_column([b"", b"", b"", b"", b"x"],
                      [True, True, False, True, False])
        ia, ib = np.divmod(np.arange(25), 5)
    elif case == "differ at":
        ra, rb = [], []
        for n in (16, 17, 32, 33, 64, 65, 66, 80, 130):
            base = _eq_rows(rng, 1, n, n)[0]
            for k in [k for k in EQ_DIFFER_AT if k < n] + [n - 1]:
                ra.append(base)
                rb.append(base[:k] + bytes([base[k] ^ 0x20]) + base[k + 1:])
            ra.append(base)
            rb.append(base)
        a, b = eq_column(ra), eq_column(rb)
        ia = ib = np.arange(len(ra))
    elif case == "alignments":
        # every length at every alignment in a, and equal and last-byte
        # different partners at every alignment in b
        lens = [1, 15, 16, 17, 40, 64, 65, 100]
        base = [r for n in lens for r in _eq_rows(rng, 1, n, n)]
        other = [r[:-1] + bytes([r[-1] ^ 1]) for r in base]
        ra, at_a = _aligned(base * 16, [t for t in range(16) for _ in lens])
        rb, at_b = _aligned((base + other) * 16,
                            [t for t in range(16) for _ in lens * 2])
        a, b = eq_column(ra), eq_column(rb)
        k = len(lens)
        pairs = [(at_a[ta * k + j], at_b[tb * 2 * k + d * k + j])
                 for ta in range(16) for tb in range(16)
                 for j in range(k) for d in (0, 1)]
        ia, ib = np.asarray(pairs).T
    elif case.startswith("tight end"):
        n = int(case.split()[-1])
        last = _eq_rows(rng, 1, n, n)[0]
        rows = _eq_rows(rng, 40, 0, 70)
        a = eq_column(rows + [last])
        b = eq_column([last, last[:-1] + b"!"] + rows[::-1] + [last])
        ia = np.asarray([40, 40, 40, 0, 39])
        ib = np.asarray([0, 1, 42, 41, 2])
    elif case == "offsets past 0":
        rows = _eq_rows(rng, 300, 0, 90)
        a = eq_column(rows, rng.random(300) >= 0.05, pad=13, tail=29)
        b = eq_column(rows[::-1], pad=70, tail=3)
        ia = rng.integers(0, 300, 2000)
        ib = np.where(rng.random(2000) < 0.7, 299 - ia,
                      rng.integers(0, 300, 2000))
    elif case == "repeats":
        rows = _eq_rows(rng, 50, 0, 70)
        a, b = eq_column(rows), eq_column(rows)
        ia = np.full(1000, 17)
        ib = rng.integers(0, 50, 1000)
        ib[::3] = 17
    elif case == "no pairs":
        a = b = eq_column(_eq_rows(rng, 10, 0, 20))
        ia = ib = np.zeros(0, np.int64)
    elif case == "rows 20000":
        rows = [bytes(rng.choice(np.frombuffer(b"ACKMW", np.uint8),
                                 int(k))) for k in rng.integers(0, 50, 3000)]
        a = b = eq_column(rows, rng.random(3000) < 0.9)
        ia = rng.integers(0, 3000, 20_000)
        ib = ia.copy()
        ib[::2] = rng.integers(0, 3000, 10_000)
    else:
        assert case == "long keys"
        rows = _eq_rows(rng, 2000, 100, 300)
        a = eq_column(rows)
        b = eq_column([r[:-16] + (bytes(rng.integers(65, 91, 16,
                                                     dtype=np.uint8))
                                  if rng.random() < 0.3 else r[-16:])
                       for r in rows])
        ia = ib = rng.permutation(2000)
    return a, ia.astype(np.int32), b, ib.astype(np.int32)


def eq_truth(a, ia, b, ib) -> np.ndarray:
    """Python's answer: both rows valid and equal byte for byte."""
    def row(col, i):
        return col[1][col[0][i]:col[0][i + 1]].tobytes()

    return np.array([bool(a[2][i] and b[2][j] and row(a, i) == row(b, j))
                     for i, j in zip(ia, ib)], bool)


@pytest.mark.cuda
@pytest.mark.parametrize("case", EQ_CASES)
def test_string_eq_kernel_matches_twin(card, case):
    a, ia, b, ib = eq_case(case)
    a, b = ([torch.from_numpy(t).to(card) for t in col] for col in (a, b))
    ia, ib = torch.from_numpy(ia).to(card), torch.from_numpy(ib).to(card)
    got = ks.string_eq(a, ia, b, ib)
    assert torch.equal(got, ks.string_eq_plain(a, ia, b, ib))
    a_, ia_, b_, ib_ = eq_case(case)
    assert (got.cpu().numpy() == eq_truth(a_, ia_, b_, ib_)).all()


@pytest.mark.cuda
def test_string_eq_on_views_at_every_offset_match_twin(card):
    """Both columns' values as views at offsets 0-15 into their storage,
    so that the same rows meet every alignment of the 16-byte words, each
    ending at its last row; one launch a call."""
    a, ia, b, ib = eq_case("alignments")
    ia, ib = torch.from_numpy(ia).to(card), torch.from_numpy(ib).to(card)
    for off in range(16):
        cols = []
        for offs, vals, valid in (a, b):
            base = torch.zeros(len(vals) + off, dtype=torch.uint8,
                               device=card)
            base[off:] = torch.from_numpy(vals).to(card)
            cols.append((torch.from_numpy(offs).to(card), base[off:],
                         torch.from_numpy(valid).to(card)))
        got = ks.string_eq(cols[0], ia, cols[1], ib)
        assert torch.equal(got, ks.string_eq_plain(cols[0], ia, cols[1], ib))
    seen = _cuda_kernels(lambda: ks.string_eq(cols[0], ia, cols[1], ib), 5)
    assert len(seen) == 1 and "string_eq_kernel" in next(iter(seen)), seen


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


# parse_number stages a tile's rows that fit the window (20 bytes for int,
# 64 for float) in 16-byte words and parses each in one pass: the one-pass
# rules' edges, rows either side of each window, long mantissas and
# exponents, offsets past 0 and values past the last row, row counts
# either side of the 256-row tile, and a 10,000-byte row among short ones
NUMERAL_EDGES = [
    "", "-", "+", "-0", "+0", "0", "007", "-007", "+007", "0000", ".5", "5.",
    "-.5", "+5.", ".", "1e5", "1E-5", "1e+5", "1e+", "1e-", "1e", "e5", "E",
    "1.e3", "1.5E+3", "12e0", "1e05", "1.2.3", "1e5.2", "1e5e2", ".e1",
    "1e5+", "1+e5", "--1", "+-1", "-+1", " 1", "1 ", "0x10", "1_0", "1e+-5",
    "..5", "5..", "1.5e", "1.5e-", "9" * 18, "-" + "9" * 18]
NUMERAL_CASES = ["no rows", "edges", "widths", "mantissas", "exponents",
                 "offsets past 0", "rows 1", "rows 255", "rows 256",
                 "rows 257", "rows 131073", "long row"]


def _numeral_bulk(rng, n: int) -> list:
    """n seeded numerals of SQL_gff's and VCF qual's kinds (ints, decimals,
    scientific text), with leading zeros, signs and junk."""
    ints = rng.integers(-10 ** 9, 10 ** 9, n)
    frac = rng.integers(0, 10 ** 6, n)
    exps = rng.integers(-320, 320, n)
    kinds = rng.integers(0, 6, n)
    junk = np.frombuffer(b"0123456789.eE+- x", np.uint8)
    out = []
    for k, i, f, e in zip(kinds.tolist(), ints.tolist(), frac.tolist(),
                          exps.tolist()):
        if k == 0:
            out.append(str(i))
        elif k == 1:
            out.append(f"{i}.{f}")
        elif k == 2:
            out.append(f"{abs(i) % 10}.{f}e{e}")
        elif k == 3:
            out.append("0" * (f % 9) + str(abs(i)))
        elif k == 4:
            out.append(f"{f / 7:.{e % 17}g}")
        else:
            out.append(bytes(junk[rng.integers(0, len(junk),
                                                f % 12)]).decode())
    return out


def numeral_case(case: str) -> tuple:
    """(numerals, offsets, values, validity) of a parse_number case, numpy;
    a NULL row keeps its bytes."""
    rng = np.random.default_rng(len(case) + 31)
    pad = tail = 0
    if case == "no rows":
        strs = []
    elif case == "edges":
        strs = NUMERAL_EDGES * 3
    elif case == "widths":
        strs = ["0" * 15 + "12345", "-" + "0" * 14 + "12345",
                "0" * 16 + "12345", "-" + "0" * 15 + "12345",
                "1" * 19, "0" + "1" * 19, "00" + "1" * 19,
                "0." + "0" * 61 + "5", "0." + "0" * 62 + "5",
                "1" + "0" * 63, "1" + "0" * 64, "-" + "1" * 63,
                "-" + "1" * 64, "+" + "0" * 60 + "1e2", "+" + "0" * 61 + "1e2",
                "1" * 20, "-" + "1" * 19]
    elif case == "mantissas":
        digits = "1234567890123456789012345"
        strs = [z + s + t for z in ("", "0", "000") for s in
                (digits[:18], digits[:19], digits[:25]) for t in ("", ".5")]
        strs += ["0.000" + digits[:k] for k in (18, 19, 25)]
        strs += ["-000" + digits[:19] + "." + digits[:6],
                 "00." + digits + "e3", "0" * 30 + "1"]
    elif case == "exponents":
        strs = ["1e308", "1.7976931348623157e308", "1.8e308", "9e307",
                "1e309", "1e-307", "1e-300", "-1e-300",
                "2.2250738585072014e-308", "4.9e-324", "1e400", "-1e400",
                "0e400", "0e-400", "1e+0308", "1e999999999999999999",
                "123456789012345678e290", "0.000001e-302",
                "1e" + "9" * 19, "1e-" + "1" * 21, "2e+" + "0" * 20 + "3"]
    elif case == "offsets past 0":
        strs = _numeral_bulk(rng, 3000) + NUMERAL_EDGES
        pad, tail = 11, 37
    elif case.startswith("rows "):
        strs = _numeral_bulk(rng, int(case.split()[1]))
    else:
        assert case == "long row"
        strs = _numeral_bulk(rng, 600)
        strs[300] = "1" * 10_000
        strs[301] = "2" * 21
        strs[302] = "3." + "4" * 63
    enc = [s.encode() for s in strs]
    offs = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    vals = np.frombuffer(b"7" * pad + b"".join(enc) + b"8" * tail,
                         np.uint8).copy()
    valid = rng.random(len(enc)) >= 0.05
    return strs, (offs + pad).astype(np.int32), vals, valid


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
@pytest.mark.parametrize("case", ["seed 17"] + NUMERAL_CASES)
def test_parse_number_kernel_matches_twin(card, floating, case):
    col = _numeral_column(17)[1] if case == "seed 17" else \
        numeral_case(case)[1:]
    cols = [torch.from_numpy(a).to(card) for a in col]
    got, ok = kp.parse_number(*cols, floating)
    want, w_ok = kp.parse_number_plain(*cols, floating)
    assert torch.equal(ok, w_ok)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("floating", [False, True])
def test_parse_number_on_views_at_every_offset_match_twin(card, floating):
    """values as a view at offsets 0-15 into its storage, so that the same
    rows meet every alignment of the staged words, ending at its last row;
    one launch a call."""
    _strs, offs, vals, valid = numeral_case("rows 257")
    offs, valid = torch.from_numpy(offs).to(card), \
        torch.from_numpy(valid).to(card)
    for off in range(16):
        base = torch.zeros(len(vals) + off, dtype=torch.uint8, device=card)
        base[off:] = torch.from_numpy(vals).to(card)
        got, ok = kp.parse_number(offs, base[off:], valid, floating)
        want, w_ok = kp.parse_number_plain(offs, base[off:], valid, floating)
        assert torch.equal(ok, w_ok)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    seen = _cuda_kernels(
        lambda: kp.parse_number(offs, base[off:], valid, floating), 5)
    assert len(seen) == 1 and "parse_number_kernel" in next(iter(seen)), seen


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


# -- gather_spans' and sw_score's Hopper designs ------------------------------
# gather_spans: tiles of 16 KB of output, 16-byte words, plain spans (drops
# only at their ends, trimmed) copied by aligned loads, masked spans (a drop
# inside) placed by rank in shared memory. sw_score: pass widths 8, 16 and
# 32 picked from the longest query, padding past the query's end, a query
# profile. These builders are shared with test_torch_redesign_k8c_k9.py,
# which holds the twins to exon_tpu on the same cases.

SPAN_CASES = ["lengths_0_1_15_16_17", "one_mib_span", "every_alignment",
              "crlf", "gt_inside_name", "cr_inside_line", "starts_descending",
              "plain_and_masked_in_one_word", "total_zero"]
SPAN_DROPS = [(), (13,), (13, 62)]


def span_case(case: str) -> tuple:
    """(src uint8, starts, stops int32) of a gather_spans case, numpy."""
    rng = np.random.default_rng(len(case) * 31 + 7)
    letters = np.frombuffer(b"ACGTN", np.uint8)

    def text(n):
        return letters[rng.integers(0, len(letters), n)]

    pieces, starts, stops, at = [], [], [], 0

    def span(body: bytes, gap: int = 1):
        nonlocal at
        b = np.frombuffer(body, np.uint8) if isinstance(body, bytes) else body
        pieces.append(b)
        pieces.append(np.full(gap, 10, np.uint8))
        starts.append(at)
        stops.append(at + len(b))
        at += len(b) + gap

    if case == "lengths_0_1_15_16_17":
        for n in rng.choice([0, 1, 15, 16, 17], 3000):
            span(text(n), int(rng.integers(0, 3)))
    elif case == "one_mib_span":
        big = text(1 << 20)
        big[rng.integers(0, 1 << 20, 5)] = 13   # masked where 13 drops
        span(text(40))
        span(big)
        span(text(17))
    elif case == "every_alignment":
        # each (source, destination) alignment mod 16: a pad span sets the
        # output's, a gap the source's, then a 40-byte span
        out_at = 0
        for sa in range(16):
            for da in range(16):
                span(text((da - out_at) % 16), 0)
                out_at += (da - out_at) % 16
                pad = (sa - at) % 16
                pieces.append(np.full(pad, 10, np.uint8))
                at += pad
                span(text(40), 0)
                out_at += 40
    elif case == "crlf":
        for n in rng.integers(0, 70, 2000):
            span(np.concatenate([text(n), [13]]).astype(np.uint8))
    elif case == "gt_inside_name":
        for i in range(1500):
            name = b">sp|P%05d|N%d" % (i, i) + (b">x" if i % 7 == 0 else b"")
            span(name)
    elif case == "cr_inside_line":
        for n in rng.integers(1, 90, 2000):
            line = text(int(n))
            if rng.random() < 0.1:
                line[rng.integers(0, n)] = 13
            span(line)
    elif case == "starts_descending":
        src = text(50_000)
        src[rng.integers(0, 50_000, 300)] = 13
        st = np.sort(rng.integers(0, 49_000, 2000))[::-1]
        return src, st.astype(np.int32), \
            (st + rng.integers(0, 900, 2000)).astype(np.int32)
    elif case == "plain_and_masked_in_one_word":
        for i in range(1000):
            span(text(7), 0)
            m = text(9)
            m[4] = 13
            span(m, 0)
    elif case == "total_zero":
        for n in rng.integers(0, 5, 500):
            span(np.full(n, 13, np.uint8), 1)
    src = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    return (src.astype(np.uint8), np.asarray(starts, np.int32),
            np.asarray(stops, np.int32))


def span_args(src, starts, stops, drop: tuple, device) -> tuple:
    """gather_spans' arguments: dst the exclusive scan of the kept lengths
    (the total for drop 13 alone is 0 in total_zero only)."""
    dropped = np.isin(src, np.asarray(drop, np.uint8)) if drop else \
        np.zeros(len(src), bool)
    kept_before = np.concatenate([[0], np.cumsum(~dropped)])
    kept = kept_before[stops] - kept_before[starts]
    dst = np.concatenate([[0], np.cumsum(kept)[:-1]]).astype(np.int32)
    return (torch.from_numpy(src.copy()).to(device),
            torch.from_numpy(starts.copy()).to(device),
            torch.from_numpy(stops.copy()).to(device),
            torch.from_numpy(dst).to(device), int(kept.sum()), drop)


SW_QLENS = [1, 7, 8, 9, 13, 16, 17, 31, 32, 33, 64]


def sw_rows(seed: int, n: int = 300, max_len: int = 300) -> tuple:
    """Seeded DNA rows of 0-max_len bytes, every tenth empty, and a validity
    with about 8 % NULL (a NULL row's bytes are dropped, as a scan leaves
    them): (offsets int32, values uint8, validity bool), numpy."""
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(b"ACGT", np.uint8)
    valid = rng.random(n) >= 0.08
    lens = np.where(valid, rng.integers(0, max_len + 1, n), 0)
    lens[::10] = 0
    offs = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offs[1:])
    vals = letters[rng.integers(0, 4, int(offs[-1]))]
    return offs, vals, valid


# like_match (K2a, K2) and line_index (K8a) at their Hopper designs' shapes.
# like_match: a group of 4-32 lanes a row, the row in aligned 16-byte words,
# a chunk's first 17 tokens as bit masks over a two-word window, longer
# chunks checked with byte loads; the pattern by value (INLINE_WORDS int32
# words) or from a device copy. line_index: one single-pass launch over 16 KB
# tiles into n / 16 + 1 positions, once more into an exact buffer past that.
# These cases are shared with test_torch_redesign_k2_k8a.py, which holds
# the twins to exon_tpu on the same cases.

LIKE_CASES = ["rows_0_600", "needle_at_every_offset", "offsets_past_zero",
              "ilike", "overlaps"]
# the TruSeq adapter and the bases after it: chunks of 1-33 bytes are its
# prefixes
X33 = b"AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
LIKE_PATTERNS = (
    [f"%{X33[:k].decode()}%" for k in (1, 2, 13, 16, 17, 18, 33)]
    + ["%C%C", "%AA%AA", "AA%AA", f"{X33[:13].decode()}%", "%GAGC",
       # '_' at a word's edges: inside a 16- and a 17-token window, past it
       "%AGATC_GAAGAGCAC_%", f"%A{'_' * 15}G%", f"%{'_' * 16}A%",
       "%A_A%G_C%", "_%_",
       # a head before the first search, and a tail after the last
       "A%GA%", "AG%A_C%T"])


def like_case(case: str) -> tuple:
    """(offsets int32, values uint8) of a like_match case, numpy."""
    rng = np.random.default_rng(len(case) * 13 + 5)
    letters = np.frombuffer(b"ACGTacgtNn" if case == "ilike" else b"ACGT",
                            np.uint8)

    def text(n):
        return letters[rng.integers(0, len(letters), n)].tobytes()

    head, rows, tail = b"", [], b""
    if case in ("rows_0_600", "offsets_past_zero", "ilike"):
        n = 300 if case == "rows_0_600" else 120
        for i in range(n):
            row = text(int(rng.integers(0, 601)))
            if i % 10 == 0:
                row = b""
            elif rng.random() < 0.35:
                at = int(rng.integers(0, len(row) + 1))
                cut = X33[:int(rng.integers(1, 34))]
                if case == "ilike":
                    cut = bytes(c | 32 if rng.random() < 0.5 else c
                                for c in cut)
                row = row[:at] + cut + row[at:]
            rows.append(row)
        if case == "rows_0_600":
            rows.insert(150, text(35_000) + X33 + text(35_000))
        if case == "offsets_past_zero":
            # 'x' before the first row: exon_tpu's contains counts those
            # bytes into row 0 (F37, test_torch_redesign_k2_k8a.py)
            head, tail = b"x" * 37, text(11)
    elif case == "needle_at_every_offset":
        # the 33-byte needle at every byte of a 16-byte word, rows starting
        # at every alignment too: row (a, b) starts at a mod 16 of the
        # buffer and holds X33 at b mod 16
        at = 0
        for a in range(16):
            for b in range(16):
                lead = text((a - at) % 16)
                rows.append(lead)
                at += len(lead)
                pos = (b - at) % 16 + 16
                row = text(pos) + X33 + text(int(rng.integers(0, 20)))
                rows.append(row)
                at += len(row)
    elif case == "overlaps":
        for _ in range(600):
            rows.append(bytes(rng.choice(list(b"ACx"), int(rng.integers(0, 7)))))
        rows += [b"AAA", b"AAAA", b"AA", b"C", b"CC", b"ACAC", b"AAxAA"]
    lens = [len(r) for r in rows]
    offs = (len(head) + np.concatenate([[0], np.cumsum(lens)])).astype(np.int32)
    vals = np.frombuffer(head + b"".join(rows) + tail, np.uint8).copy()
    return offs, vals


def like_patterns(case: str) -> list:
    """(pattern, case_insensitive) of a case: ILIKE with lower-case
    patterns on the mixed-case rows, LIKE elsewhere."""
    if case == "ilike":
        return [(p.lower(), True) for p in LIKE_PATTERNS]
    return [(p, False) for p in LIKE_PATTERNS]


STRPOS_NEEDLES = [X33[:k] for k in (1, 2, 13, 16, 17, 18, 33)] + [b""]

LINE_CASES = ["short_lines", "crlf", "no_final_newline", "tile_edges"]
LINE_EDGES = [0, 1, 15, 16, 17, 4095, 4096, 4097, 16383, 16384, 16385,
              3 * 16384 + 15]


def line_case(case: str) -> list:
    """The texts (uint8 arrays) of a line_index case, numpy."""
    rng = np.random.default_rng(len(case) * 7 + 3)

    def lines(n_bytes: int, mean: int, end: bytes = b"\n") -> bytes:
        out = bytearray()
        while len(out) < n_bytes:
            out += b"A" * int(rng.integers(0, 2 * mean)) + end
        return bytes(out[:n_bytes])

    if case == "short_lines":
        # runs of bare '\n' between short lines: under 16 bytes a line
        texts = [np.where(rng.random(50_000) < 0.6, 10, 65).astype(np.uint8),
                 np.full(20_000, 10, np.uint8),
                 np.frombuffer(lines(40_000, 4), np.uint8)]
    elif case == "crlf":
        texts = [np.frombuffer(lines(60_000, 60, b"\r\n"), np.uint8)]
    elif case == "no_final_newline":
        texts = [np.frombuffer(lines(30_000, 60) + b"ACGT", np.uint8)]
    else:
        full = np.frombuffer(lines(max(LINE_EDGES), 55), np.uint8)
        texts = [full[:n] for n in LINE_EDGES]
    return [np.ascontiguousarray(t) for t in texts]


# text_records: a lane a line over aligned 16-byte words, body lines past
# ktr.LONG_AT bytes counted by whole warps in 16 KB pieces;
# csrc/format_int.cu: a single-pass offsets scan over 1,024-row tiles, then
# a write pass of 256-row blocks. These cases are shared with
# test_torch_redesign_k8b_cast.py, which holds the twins to exon_tpu.

RECORD_CASES = ["lines_0_600", "long_lines", "one_line", "crlf", "headers",
                "empty_and_bad"]
# the long-line threshold (512 bytes) and its doubles to 4,096, less one,
# at and past each
LONG_EDGES = [16 * 8 * g + d for g in (4, 8, 16, 32) for d in (-1, 0, 1)]


def _bases(rng, n: int, alphabet: bytes = b"ACGT") -> bytes:
    return np.frombuffer(alphabet, np.uint8)[
        rng.integers(0, len(alphabet), n)].tobytes()


def _fastq(rng, seqs, names=None) -> bytes:
    out = []
    for i, seq in enumerate(seqs):
        name = b"@r%d len=%d" % (i, len(seq)) if names is None else names[i]
        qual = bytes(33 + (b % 40) for b in seq)
        out.append(name + b"\n" + seq + b"\n+\n" + qual + b"\n")
    return b"".join(out)


def record_case(case: str) -> list:
    """The (text, fastq) pairs of a text_records case, numpy uint8 texts:
    each runs in its mode, with and without want_hdr."""
    rng = np.random.default_rng(len(case) * 11 + 7)
    if case == "lines_0_600":
        # lines of 0-600 bytes, starting at every offset mod 16
        fa = []
        for i in range(60):
            fa.append(b">s%d desc %d" % (i, i) if i % 3 else b">s%d" % i)
            fa += [_bases(rng, int(rng.integers(0, 601)))
                   for _ in range(int(rng.integers(1, 6)))]
        seqs = [_bases(rng, int(rng.integers(0, 601))) for _ in range(60)]
        texts = [(b"\n".join(fa) + b"\n", False), (_fastq(rng, seqs), True)]
    elif case == "long_lines":
        # lines just under, at and past each width's threshold, one of
        # 70,033 bytes, with '\r' scattered in them; and a long header
        lens = LONG_EDGES + [70_033, 16_383, 16_385, 40_000]
        seqs = []
        for m in lens:
            seq = bytearray(_bases(rng, m))
            seq[::97] = b"\r" * len(seq[::97])
            seqs.append(bytes(seq))
        fa = []
        for i, seq in enumerate(seqs):
            fa += [b">long%d" % i, _bases(rng, int(rng.integers(0, 40))), seq]
        head = b">" + _bases(rng, 9000) + b" " + _bases(rng, 300) + b"\r"
        texts = [(b"\n".join([head] + fa) + b"\n", False),
                 (_fastq(rng, seqs), True)]
    elif case == "one_line":
        # a chunk that is one line with no final newline
        seq = bytearray(_bases(rng, 40_000))
        seq[5::31] = b"\r" * len(seq[5::31])
        texts = [(bytes(seq), False), (bytes(seq), True),
                 (b">only a header\r", False), (b"@r1 one header", True),
                 (b"ACGT", False), (b"\r", True)]
    elif case == "crlf":
        # CRLF text, and lines of bare '\r'
        fa = []
        for i in range(40):
            fa.append(b">c%d crlf record" % i)
            fa += [_bases(rng, int(rng.integers(0, 200))) for _ in range(3)]
        fa += [b"", b"\r", b"\r\r\r", b"A\rC"]
        crlf = b"\r\n".join(fa) + b"\r\n"
        fq = _fastq(rng, [_bases(rng, int(rng.integers(0, 200)))
                          for _ in range(30)]).replace(b"\n", b"\r\n")
        texts = [(crlf, False), (fq, True),
                 (b"\r\n\r\r\n\r\n\r", False),
                 (b"@\r\n\r\n+\r\n\r\n", True)]
    elif case == "headers":
        # the first space at a word's first and last byte, no space, a
        # space after '\r', '>' in FASTA names, a space right after the
        # marker, a bare marker; each header at every offset mod 16
        names = [b"ab\r cd", b"a>b>c desc", b"nospace", b" lead", b"",
                 b"x\r\r y z", b">>> >", b"tail "]
        fa, fq = [], []
        at = 0
        for lead in range(16):
            pad = _bases(rng, (lead - at - 1) % 16)
            fa.append(pad)
            at += len(pad) + 1
            for sp in (0, 15):
                # a name that puts its space at offset sp of a word
                name = _bases(rng, (sp - at - 1) % 16 + 16)
                fa.append(b">" + name + b" desc\r")
                at += len(fa[-1]) + 1
            for name in names:
                fa.append(b">" + name)
                at += len(name) + 2
        for name in names + [b"q" * k + b" d" for k in range(33)]:
            fq.append(b"@" + name)
        texts = [(b"\n".join(fa) + b"\n", False),
                 (_fastq(rng, [_bases(rng, 5)] * len(fq), fq), True)]
    else:  # empty_and_bad
        fa = b"\n\n>a\n\nAC\n\n>b x\n\n\n"
        fq = _fastq(rng, [b"AC", b"", b"G", b"TT"],
                    [b"@ok", b"xbad", b"", b"@ok2 d"]) + b"\n\n\n\n"
        texts = [(np.frombuffer(fa, np.uint8), False),
                 (np.frombuffer(fq, np.uint8), True),
                 (b"\n" * 100, True), (b"\n" * 100, False)]
    return [(np.frombuffer(t, np.uint8).copy() if isinstance(t, bytes)
             else t.copy(), fq) for t, fq in texts]


def record_lines(text) -> tuple:
    """(newline positions, line count) of a text, by the twin."""
    nl = kli.line_index_plain(text)
    n = text.shape[0]
    return nl, nl.shape[0] + int(n > 0 and int(text[-1]) != 10)


# format_int: each digit count's edges, 2^32 and INT64_MAX and MIN + 1 with
# their negatives, NULL rows; row counts either side of a look-back tile
# (1,024 rows) and of a write block (256)
INT_EDGES = sorted({0, 1, 9, 10, 99, 100}
                   | {10 ** k + d for k in range(1, 19) for d in (-1, 0, 1)}
                   | {2 ** 32 - 1, 2 ** 32, 2 ** 32 + 1, 2 ** 63 - 1})
INT_ROWS = [1, 255, 256, 257, 4095, 4096, 4097, 131_073]


def int_case(n: int) -> tuple:
    """(int64 values, validity) of n rows: the edges and their negatives,
    then seeded values of every digit count; a NULL row in 13."""
    rng = np.random.default_rng(n)
    edges = np.asarray([v for e in INT_EDGES for v in (e, -e)], np.int64)
    digits = rng.integers(1, 19, n)
    rand = rng.integers(0, 10 ** digits.astype(np.int64), dtype=np.int64)
    vals = np.concatenate([edges, rand * np.where(rng.random(n) < 0.3, -1, 1)
                           ])[:n]
    return vals, rng.random(n) >= 1 / 13


@pytest.mark.cuda
@pytest.mark.parametrize("case", SPAN_CASES)
@pytest.mark.parametrize("drop", SPAN_DROPS)
def test_gather_spans_design_cases_match_twin(card, case, drop):
    args = span_args(*span_case(case), drop, card)
    got = kgs.gather_spans(*args)
    assert got.shape[0] == args[4]
    assert torch.equal(got, kgs.gather_spans_plain(*args))


@pytest.mark.cuda
def test_gather_spans_on_views_at_every_offset_match_twin(card):
    # the source as a view at offsets 0-15 into its storage, so that the
    # same spans meet every alignment of the 16-byte loads, and a chunk
    # that ends right after its last span
    src, starts, stops = span_case("crlf")
    for off in range(16):
        base = torch.zeros(len(src) + off, dtype=torch.uint8, device=card)
        base[off:] = torch.from_numpy(src).to(card)
        args = span_args(src, starts, stops, (13,), card)
        args = (base[off:],) + args[1:]
        assert torch.equal(kgs.gather_spans(*args),
                           kgs.gather_spans_plain(*args))
    last = int(stops.max())
    args = span_args(src[:last], starts, stops, (13,), card)
    assert torch.equal(kgs.gather_spans(*args), kgs.gather_spans_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("qlen", SW_QLENS)
def test_sw_score_every_width_matches_twin(card, qlen):
    # widths 8 (1, 7, 8), 16 (9, 13, 16), 32 (17, 31, 32) and passes of 32
    # through the edge buffer (33, 64)
    offs, vals, _valid = sw_rows(100 + qlen)
    q = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(qlen).integers(0, 4, qlen)]
    args = (torch.from_numpy(offs).to(card), torch.from_numpy(vals).to(card),
            torch.from_numpy(q.copy()).to(card))
    assert torch.equal(ksw.sw_score(*args), ksw.sw_score_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("max_partner", [8, 16, 32, 64])
def test_sw_score_pairwise_every_width_matches_twin(card, max_partner):
    # partners of 0 to max_partner bytes: each width, empty partners, rows
    # of one pass beside rows of several
    offs, vals, _valid = sw_rows(200 + max_partner)
    b_offs, b_vals, _ = sw_rows(300 + max_partner, max_len=max_partner)
    args = [torch.from_numpy(x).to(card) for x in (offs, vals, b_offs,
                                                  b_vals)]
    assert torch.equal(ksw.sw_score_pairwise(*args),
                       ksw.sw_score_pairwise_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("group", [4, 8, 16, 32, None])
@pytest.mark.parametrize("case", LIKE_CASES)
def test_like_match_design_cases_match_twin(card, case, group, monkeypatch):
    # every group width (None: the wrapper's own pick from the shapes)
    if group is not None:
        monkeypatch.setattr(kl, "group_width", lambda n, nbytes: group)
    offs, vals = (torch.from_numpy(x).to(card) for x in like_case(case))
    for pattern, ci in like_patterns(case):
        chunks = tokenize_like(pattern)
        assert torch.equal(kl.like_match(offs, vals, chunks, ci),
                           kl.like_match_plain(offs, vals, chunks, ci)), \
            pattern
    for needle in STRPOS_NEEDLES:
        for ci in (False, True):
            assert torch.equal(
                kl.like_find(offs, vals, tuple(needle), ci),
                kl.like_find_plain(offs, vals, tuple(needle), ci)), needle


def _long_pattern(seed: int) -> str:
    """A pattern past INLINE_WORDS words, so the kernel reads a device copy:
    chunks of 40-300 tokens taken from one row of the rows_0_600 case, so
    that the row matches."""
    offs, vals = like_case("rows_0_600")
    row = vals[offs[150]:offs[151]].tobytes().decode()
    rng = np.random.default_rng(seed)
    parts = [row[a:a + int(rng.integers(100, 300))]
             for a in 20_000 * np.arange(3) + rng.integers(0, 10_000, 3)]
    pattern = "%" + "%".join(parts) + "%"
    assert len(kl.encode_pattern(tokenize_like(pattern), False)) > \
        kl.INLINE_WORDS
    return pattern


@pytest.mark.cuda
@pytest.mark.parametrize("group", [4, 32])
def test_like_match_long_pattern_from_a_device_copy(card, group, monkeypatch):
    monkeypatch.setattr(kl, "group_width", lambda n, nbytes: group)
    offs, vals = (torch.from_numpy(x).to(card)
                  for x in like_case("rows_0_600"))
    for pattern in (_long_pattern(1), "X" + _long_pattern(2)):
        chunks = tokenize_like(pattern)
        got = kl.like_match(offs, vals, chunks, False)
        assert torch.equal(got, kl.like_match_plain(offs, vals, chunks, False))
    assert bool(kl.like_match(offs, vals, tokenize_like(_long_pattern(1)),
                              False)[150])
    # a first use on another stream, then a use on the default one: each
    # launch waits for the copy
    chunks = tokenize_like(_long_pattern(4))
    with torch.cuda.stream(torch.cuda.Stream()):
        side = kl.like_match(offs, vals, chunks, False)
    torch.cuda.synchronize()
    assert torch.equal(side, kl.like_match(offs, vals, chunks, False))
    assert torch.equal(side, kl.like_match_plain(offs, vals, chunks, False))


@pytest.mark.cuda
def test_like_match_refuses_one_lane_a_row_for_a_search(card, monkeypatch):
    # a lone lane takes anchored chunks alone; the kernel has no search for
    # it, so the launch is refused rather than answering wrongly
    offs, vals = (torch.from_numpy(x).to(card) for x in like_case("overlaps"))
    monkeypatch.setattr(kl, "_searches", lambda chunks: False)
    for pattern in ("AA%AA", "C%", "%C"):
        chunks = tokenize_like(pattern)
        assert torch.equal(kl.like_match(offs, vals, chunks, False),
                           kl.like_match_plain(offs, vals, chunks, False))
    with pytest.raises(RuntimeError, match="like_match failed to launch"):
        kl.like_match(offs, vals, tokenize_like("%C%C"), False)


@pytest.mark.cuda
def test_like_match_and_like_find_do_not_synchronise(card):
    """No upload that drains the stream and no host read: every call,
    a first use of a long pattern too, runs under sync debug mode
    "error"."""
    offs, vals = (torch.from_numpy(x).to(card)
                  for x in like_case("rows_0_600"))
    kl.like_match(offs, vals, tokenize_like("%KK%"), False)  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [kl.like_match(offs, vals, tokenize_like(p), ci)
                for p, ci in like_patterns("rows_0_600")
                + [(_long_pattern(3), False)]]
        outs.append(kl.like_find(offs, vals, tuple(X33[:13])))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(outs[-1], kl.like_find_plain(offs, vals,
                                                    tuple(X33[:13]), False))


@pytest.mark.cuda
@pytest.mark.parametrize("case", LINE_CASES)
def test_line_index_design_cases_match_twin(card, case):
    for text in line_case(case):
        t = torch.from_numpy(text).to(card)
        for part in (t, t[1:]):  # and an unaligned view
            before = kli.launches
            got = kli.line_index(part)
            want = kli.line_index_plain(part)
            assert got.dtype == torch.int32 and torch.equal(got, want)
            past_cap = want.shape[0] > part.shape[0] // 16 + 1
            assert kli.launches - before == (2 if past_cap else 1) or \
                part.shape[0] == 0


@pytest.mark.cuda
def test_line_index_blocks_looping_over_tiles_match_twin(card):
    """Texts of far more 16 KB tiles than the grid has blocks, so each block
    takes several (loading the next while it finishes one): 60-byte lines,
    lines past the first buffer's cap, an unaligned view; each call between
    compact_mask calls on the same status words and ticket counter."""
    rng = np.random.default_rng(17)
    texts = [np.where(rng.random(40 << 20) < 1 / 60, 10, 65),
             np.where(rng.random(20 << 20) < 0.3, 10, 65)]
    texts = [torch.from_numpy(t.astype(np.uint8)).to(card) for t in texts]
    texts.append(texts[0][5:])
    masks = [torch.from_numpy(rng.random(n) < 0.5).to(card)
             for n in (70_000, 5, 300_000)]
    for text, mask in zip(texts, masks):
        before = kc.compact_mask(mask)
        got = kli.line_index(text)
        after = kc.compact_mask(mask)
        assert torch.equal(got, kli.line_index_plain(text))
        want = kc.compact_mask_plain(mask)
        for out in (before, after):
            assert torch.equal(out[0], want[0])
            assert int(out[1]) == int(want[1])


@pytest.mark.cuda
def test_line_index_is_one_launch_a_call(card):
    """One line_index_kernel a call and the count's copy to the host (no
    count pass, zeros or cumsum); a second launch only past the cap."""
    def kernels_of(run):
        # the profiler now and then records no CUDA activity at all in a
        # window (not even the count's copy); such a window is taken again
        for _ in range(3):
            seen = _cuda_kernels(run, 5)
            if seen:
                break
        return seen, {k: c for k, c in seen.items() if "Memcpy" not in k}

    text = torch.from_numpy(line_case("crlf")[0]).to(card)
    seen, kernels_seen = kernels_of(lambda: kli.line_index(text))
    assert len(kernels_seen) == 1, seen
    assert "line_index_kernel" in next(iter(kernels_seen))
    assert 4 <= next(iter(kernels_seen.values())) <= 5, seen
    dense = torch.from_numpy(line_case("short_lines")[1]).to(card)
    seen, kernels_seen = kernels_of(lambda: kli.line_index(dense))
    assert len(kernels_seen) == 1, seen
    assert 9 <= next(iter(kernels_seen.values())) <= 10, seen


def _assert_records_match_twin(text, fastq: bool, want_hdr: bool) -> None:
    nl, n_lines = record_lines(text)
    got = ktr.text_records(text, nl, n_lines, fastq, want_hdr)
    want = ktr.text_records_plain(text, nl, n_lines, fastq, want_hdr)
    for f in ("start", "end", "is_hdr", "body", "split", "name_len",
              "desc_len", "bad"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        assert a is None or (a.dtype == b.dtype and torch.equal(a, b)), f


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 15])
@pytest.mark.parametrize("case", RECORD_CASES)
def test_text_records_design_cases_match_twin(card, case, offset):
    # the lines either side of the long-line threshold, from a chunk at
    # each offset into its card buffer (16-byte aligned or copied to be)
    for text, fastq in record_case(case):
        buf = torch.zeros(len(text) + 16, dtype=torch.uint8, device=card)
        t = buf[offset:offset + len(text)]
        t.copy_(torch.from_numpy(text).to(card))
        for want_hdr in (True, False):
            _assert_records_match_twin(t, fastq, want_hdr)


@pytest.mark.cuda
def test_text_records_long_lines_shared_across_warps_match_twin(card):
    """Several long lines, pieces across 16 KB boundaries, a chunk that is
    one long line (with and without its newline), four unwrapped records,
    and a long-read FASTQ chunk with '\r' in its lines."""
    rng = np.random.default_rng(31)
    lines = [_bases(rng, m) for m in (200_000, 16_384, 16_385, 50_001, 7)]
    lines[1] = lines[1][:100] + b"\r" * 5000 + lines[1][5100:]
    texts = [(b"\n".join(lines) + b"\n", False),
             (lines[0], False), (lines[0] + b"\n", True),
             (b"".join(b">chr%d x\n" % i + _bases(rng, 1 << 20, b"ACGTN")
                       + b"\n" for i in range(4)), False),
             (_fastq(rng, [_bases(rng, int(m)) + b"\r" for m in
                           np.exp(rng.uniform(np.log(1000), np.log(100_000),
                                              40))]), True)]
    for text, fastq in texts:
        t = torch.from_numpy(np.frombuffer(text, np.uint8).copy()).to(card)
        for want_hdr in (True, False):
            _assert_records_match_twin(t, fastq, want_hdr)


@pytest.mark.cuda
def test_text_records_counts_start_at_zero_each_call(card):
    """The pieces' and bad headers' counts live in the look-back
    workspace's status words: a call after one that added to them, and
    after other scans on the same words, starts from zero."""
    rng = np.random.default_rng(37)
    bad = _fastq(rng, [b"AC"] * 9, [b"x%d" % i for i in range(9)])
    long_fa = b">a\n" + _bases(rng, 90_000) + b"\r\n"
    plain = record_case("lines_0_600")[1][0].tobytes()
    mask = torch.from_numpy(rng.random(70_000) < 0.5).to(card)
    for text, fastq in [(bad, True), (plain, True), (long_fa, False),
                        (long_fa, False), (plain, True), (bad, True)]:
        t = torch.from_numpy(np.frombuffer(text, np.uint8).copy()).to(card)
        _assert_records_match_twin(t, fastq, True)
        kc.compact_mask(mask)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    t = torch.from_numpy(np.frombuffer(bad, np.uint8).copy()).to(card)
    torch.cuda.synchronize()
    outs = []
    for i in range(6):
        with torch.cuda.stream(streams[i % 2]):
            nl, n_lines = record_lines(t)
            outs.append(ktr.text_records(t, nl, n_lines, True, True).bad)
    torch.cuda.synchronize()
    assert [int(b) for b in outs] == [9] * 6


@pytest.mark.cuda
def test_text_records_is_two_launches_and_no_sync(card):
    """Two kernels a call (the group pass and the long lines' pass), no
    fill or copy beside them, and no sync: a call runs under sync debug
    mode "error"."""
    text = torch.from_numpy(record_case("long_lines")[0][0]).to(card)
    nl, n_lines = record_lines(text)
    ktr.text_records(text, nl, n_lines, False, True)  # builds
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        lines = ktr.text_records(text, nl, n_lines, False, True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.equal(lines.body, ktr.text_records_plain(
        text, nl, n_lines, False, True).body)
    for _ in range(3):
        seen = _cuda_kernels(lambda: ktr.text_records(text, nl, n_lines,
                                                      False, True), 5)
        if seen:
            break
    assert len(seen) == 2, seen
    assert any("text_lines_kernel" in k for k in seen), seen
    assert any("text_long_lines_kernel" in k for k in seen), seen
    assert all(4 <= c <= 5 for c in seen.values()), seen


@pytest.mark.cuda
@pytest.mark.parametrize("n", INT_ROWS)
def test_format_int_edge_rows_match_twin(card, n):
    ints, valid = int_case(n)
    for v, ok in ((ints, valid), (ints, np.zeros(n, bool)),
                  (np.full(n, -2 ** 63, np.int64), valid)):
        args = (torch.from_numpy(v).to(card), torch.from_numpy(ok).to(card))
        got, want = kf.format_int(*args), kf.format_int_plain(*args)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert got[1].shape[0] == int(got[0][-1])


@pytest.mark.cuda
def test_format_int_is_two_launches_and_one_read(card):
    """The offsets pass and the write pass (no fill, cumsum or lengths
    pass), and one host read, of the total, a call."""
    import warnings

    ints, valid = int_case(INT_ROWS[-1])
    args = (torch.from_numpy(ints).to(card), torch.from_numpy(valid).to(card))
    kf.format_int(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen_warnings:
            warnings.simplefilter("always")
            kf.format_int(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in seen_warnings if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in seen_warnings]
    for _ in range(3):
        seen = _cuda_kernels(lambda: kf.format_int(*args), 5)
        if seen:
            break
    kernels_seen = {k: c for k, c in seen.items() if "Memcpy" not in k}
    assert len(kernels_seen) == 2, seen
    assert any("format_int_offsets_kernel" in k for k in kernels_seen), seen
    assert any("format_int_write_kernel" in k for k in kernels_seen), seen
    assert sum(c for k, c in seen.items() if "Memcpy" in k) <= 5, seen


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


# -- count_bytes and polya_tail: the byte-class designs' shapes ---------------
# Classes by size (members), with byte 0 and bytes >= 128 among them: the
# kernels test each by SWAR on its cubes (byte sets b & m == v; 1, 2, 4 or
# 8 of them, 3 repeating its first) or, with none or more than 8 cubes (the
# 40 scattered bytes), by the 256-bit mask.
BYTECLASSES = {0: b"", 1: b"A", 2: b"Aa", 3: b"N \x00", 4: b"\x00AC\xff",
               5: b"ACGT\x80", 8: b"ACGTacg\x80", 9: b"ACGTacgtN",
               40: bytes(sorted(np.random.default_rng(5).choice(
                   256, 40, replace=False).tolist())),
               200: bytes(v for v in range(256) if v % 32 < 25)}
# runs either side of a word (16), of a thread's walk (256) and of a warp's
# step (512)
RUN_EDGES = (15, 16, 17, 255, 256, 257, 511, 512, 513)
BYTECLASS_CASES = ("mixed", "edges", "row_ends", "long_row", "neighbours",
                   "one_row", "no_rows")


def byteclass_case(name: str, members: bytes, seed: int = 0):
    """(int32 offsets, uint8 values, each row's bytes) of the case ``name``
    for the class ``members``: "mixed", 2,000 rows of 0-300 bytes, half of
    them class bytes, some with class runs at either end; "edges", empty
    rows, rows of 1 byte, all-class rows and runs of RUN_EDGES bytes at
    either end and both; "row_ends", rows of 0-48 bytes, so that row ends
    fall at every offset mod 16; "long_row", a 64 KB row (mixed, all-class,
    and class runs of 30,000 and 35,535 bytes around one other byte) among
    100-byte rows; "neighbours", offsets that start past 0 with class bytes
    just before the first row and just after the last; "one_row"; "no_rows"
    (n = 0, offsets past 0)."""
    rng = np.random.default_rng(seed + 1009 * len(members))
    inside = np.frombuffer(members, np.uint8)
    outside = np.setdiff1d(np.arange(256, dtype=np.uint8), inside)

    def run(k):
        if not len(inside):
            return b""
        return inside[rng.integers(0, len(inside), int(k))].tobytes()

    def other(k):
        return outside[rng.integers(0, len(outside), int(k))].tobytes()

    def mix(k):
        k = int(k)
        pick = rng.random(k) < 0.5 if len(inside) else np.zeros(k, bool)
        out = outside[rng.integers(0, len(outside), k)]
        if len(inside):
            out[pick] = inside[rng.integers(0, len(inside), int(pick.sum()))]
        return out.tobytes()

    rows, pre, post = [], b"", b""
    if name == "mixed":
        for _ in range(2000):
            row = mix(rng.integers(0, 301))
            if rng.random() < 0.3:
                row = run(rng.integers(1, 40)) + row
            if rng.random() < 0.3:
                row += run(rng.integers(1, 40))
            rows.append(row)
    elif name == "edges":
        rows += [b"", other(1), run(1), b"", run(2), other(1) + run(1)]
        for k in RUN_EDGES:
            rows += [run(k), run(k) + other(1), other(1) + run(k),
                     run(k) + other(2) + run(k), run(k) + mix(37) + run(k),
                     mix(k)]
    elif name == "row_ends":
        for k in range(49):
            rows += [mix(k), run(k), other(1) + run(k), run(k) + other(1)]
    elif name == "long_row":
        rows = [mix(100) for _ in range(300)]
        rows[150] = mix(1 << 16)
        rows[200] = run(1 << 16)
        rows[250] = run(30_000) + other(1) + run(35_535)
    elif name == "neighbours":
        rows = [run(3) + mix(rng.integers(0, 200)) + run(5)
                for _ in range(200)]
        pre, post = run(37) or other(37), run(29) or other(29)
    elif name == "one_row":
        rows = [run(20) + mix(50) + run(20)]
    elif name == "no_rows":
        pre = other(7)
    else:
        raise ValueError(name)
    offs = np.full(len(rows) + 1, len(pre), np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    offs[1:] += len(pre)
    vals = np.frombuffer(pre + b"".join(rows) + post, np.uint8).copy()
    return offs.astype(np.int32), vals, rows


def _at_alignment(vals: torch.Tensor, shift: int) -> torch.Tensor:
    """vals copied to a view whose first byte lies ``shift`` bytes past an
    aligned 16-byte word."""
    buf = torch.zeros(vals.shape[0] + 16, dtype=torch.uint8,
                      device=vals.device)
    view = buf[shift:shift + vals.shape[0]]
    view.copy_(vals)
    return view


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("size", sorted(BYTECLASSES))
@pytest.mark.parametrize("name", BYTECLASS_CASES)
def test_byteclass_kernels_match_twins(card, name, size):
    """count_bytes in both modes and polya_tail from either end and both,
    kernel against twin bit for bit, at three alignments of the values."""
    members = BYTECLASSES[size]
    offs, vals, _rows = byteclass_case(name, members)
    o = torch.from_numpy(offs).to(card)
    for shift in (0, 5, 11):
        v = _at_alignment(torch.from_numpy(vals).to(card), shift)
        for share in (False, True):
            assert _same_bits(kcb.count_bytes(o, v, members, share),
                              kcb.count_bytes_plain(o, v, members, share))
        for end in ("end", "start"):
            assert torch.equal(kpt.polya_tail(o, v, members, end),
                               kpt.polya_tail_plain(o, v, members, end))
        got = kpt.polya_tail(o, v, members, "both")
        want = kpt.polya_tail_plain(o, v, members, "both")
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_gc_content_count_bytes_and_trim_are_one_kernel_a_call(card):
    """gc_content is count_bytes' share mode alone; count_bytes and
    polya_tail's both mode one kernel a call; fn_trim one polya_tail
    launch a call."""
    from exon_tpu_torch import udfs
    from exon_tpu_torch.batch import VarColumn
    from exon_tpu_torch.ops import sqlfuncs as S

    offs, vals, _rows = byteclass_case("mixed", b" ")
    o, v = (torch.from_numpy(x).to(card) for x in (offs, vals))
    col = VarColumn(v, o, torch.ones(o.shape[0] - 1, dtype=torch.bool,
                                     device=card))
    # the profiler shows what runs on the card (it may lose a record, so
    # its counts are not read); the wrappers' counters count the launches
    for run, name, mod in (
            (lambda: udfs.gc_content(None, col), "count_bytes_kernel", kcb),
            (lambda: kcb.count_bytes(o, v, b"GCgc"), "count_bytes_kernel",
             kcb),
            (lambda: kpt.polya_tail(o, v, b" ", "both"),
             "polya_tail_kernel", kpt)):
        seen = _cuda_kernels(run, 5)
        assert len(seen) == 1 and name in next(iter(seen)), seen
        before = mod.launches
        run()
        assert mod.launches == before + 1
    seen = _cuda_kernels(lambda: S.fn_trim(None, col), 5)
    assert [k for k in seen if "polya_tail" in k], seen
    before = kpt.launches
    S.fn_trim(None, col)
    assert kpt.launches == before + 1


# -- map_bytes' row modes and widen: their designs' shapes -------------------
# mirror_kernel gives a group of 8 lanes to each row: its aligned 16-byte
# words one load each (reversed), its partial first and last words (which
# neighbouring rows share) byte by byte. word_start_kernel maps 16-byte
# output words flat: a block marks the row starts of its 8 KB tile in a
# mask a word, from the offsets it reads after a search. Both write the
# bytes outside the rows as zeros in the same launch. widen8_kernel maps 16
# bytes a thread. The cases (``map_case``) are the edges of those designs;
# test_torch_redesign_k11b_map.py holds the twins to exon_tpu on them.

MAP_LENGTHS = (0, 1, 15, 16, 17, 31, 32, 33, 255, 256, 257, 511, 512, 513)
MAP_CASES = ("lengths", "long_row", "short_runs", "every_start",
             "word_starts", "neighbours", "odd_bytes", "one_row", "no_rows")
# words, digits, punctuation, spaces and bytes >= 128
_MAP_TEXT = np.frombuffer(b"ACGTNacgtnHelloWORLD0123456789 ,.|-_'\t"
                          b"\x00\x80\xc3\xa9\xff", np.uint8)


def map_case(name: str):
    """(int32 offsets, uint8 values, each row's bytes) of the case ``name``:
    "lengths", rows of each of MAP_LENGTHS bytes (0, 1 and each side of 16,
    32, 256 and 512) in a shuffled order, so their starts fall at many
    offsets mod 16; "long_row", a 64 KB row of every byte value among
    150-byte rows; "short_runs", runs of 1-3-byte rows (and empty ones)
    that share 16-byte words; "every_start", rows of 17 and 33 bytes, so
    that a row starts at every offset mod 16, then rows of 1-48;
    "word_starts", a separator (a space, a digit, punctuation, a byte >=
    128) at each byte of a 16-byte word within rows of letters, and rows
    that follow a row
    ending in an alphanumeric byte; "neighbours", offsets that start past 0
    with alphanumeric bytes just before the first row and slack after the
    last; "odd_bytes", rows of every byte value; "one_row"; "no_rows" (n =
    0, offsets past 0, slack)."""
    rng = np.random.default_rng(7919 * len(name))

    def text(k):
        return _MAP_TEXT[rng.integers(0, len(_MAP_TEXT), int(k))].tobytes()

    rows, pre, post = [], b"", b""
    if name == "lengths":
        lens = list(MAP_LENGTHS) * 4
        rng.shuffle(lens)
        rows = [text(k) for k in lens]
    elif name == "long_row":
        rows = [text(150) for _ in range(300)]
        rows[150] = rng.integers(0, 256, 1 << 16).astype(np.uint8).tobytes()
    elif name == "short_runs":
        rows = [text(k) for k in rng.integers(0, 4, 3000)]
    elif name == "every_start":
        rows = [text(17) for _ in range(16)] + [text(33) for _ in range(16)]
        rows += [text(k) for k in range(1, 49)]
    elif name == "word_starts":
        for sep in (b" ", b"7", b",", b"\x80", b"_"):
            for k in range(16):
                rows.append(b"ab" * 8 + b"x" * k + sep + b"yZ" * 12)
        # a row that follows one ending in an alphanumeric byte, at every
        # offset of a word
        for k in range(16):
            rows += [b"q" * (k + 1), b"zz", b"9" * (k + 3), b"K"]
    elif name == "neighbours":
        rows = [text(rng.integers(0, 200)) for _ in range(200)]
        pre, post = b"Ab9" * 12 + b"A", b"zZ7" * 9 + b"q"
    elif name == "odd_bytes":
        rows = [rng.integers(0, 256, int(k)).astype(np.uint8).tobytes()
                for k in rng.integers(0, 300, 400)]
        rows.append(bytes(range(256)))
    elif name == "one_row":
        rows = [text(100)]
        pre, post = b"x" * 5, b"y" * 9
    elif name == "no_rows":
        pre = b"Ab9 " * 9 + b"A"
        post = b"zZ7" * 9 + b"q"
    else:
        raise ValueError(name)
    offs = np.full(len(rows) + 1, len(pre), np.int64)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    offs[1:] += len(pre)
    vals = np.frombuffer(pre + b"".join(rows) + post, np.uint8).copy()
    return offs.astype(np.int32), vals, rows


def map_tables() -> dict:
    """A table for each mode of map_bytes: the complement for the mirror,
    initcap's lower/upper pair for the word starts, a permutation for the
    table mode."""
    from exon_tpu_torch.ops.strings import LOWER, UPPER
    from exon_tpu_torch.udfs import _COMPLEMENT

    perm = np.random.default_rng(5).permutation(256).astype(np.uint8)
    return {"mirror": _COMPLEMENT,
            "word_start": np.concatenate([LOWER, UPPER]), "table": perm}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mirror", "word_start", "table"])
@pytest.mark.parametrize("name", MAP_CASES)
def test_map_bytes_cases_match_twin(card, name, mode):
    """Every map_case in each mode, at three alignments of the values,
    equal to the twin; one launch a call."""
    offs, vals, _rows = map_case(name)
    o = torch.from_numpy(offs).to(card)
    t = torch.from_numpy(map_tables()[mode]).to(card)
    for shift in (0, 5, 11):
        v = _at_alignment(torch.from_numpy(vals).to(card), shift)
        before = kmb.launches
        got = kmb.map_bytes(o, v, t, mode)
        assert kmb.launches == before + 1
        assert torch.equal(got, kmb.map_bytes_plain(o, v, t, mode)), shift


_WIDEN_LENGTHS = list(range(18)) + [4095, 4096, 4097]


@pytest.mark.cuda
@pytest.mark.parametrize("out", [torch.int8, torch.int64],
                         ids=["int8", "int64"])
def test_map_bytes_widen_lengths_match_twin(card, out):
    """Widen at lengths 0-17 and 4,095-4,097, on values at offsets 0-15 of
    their storage, equal to the twin."""
    rng = np.random.default_rng(17)
    table = torch.from_numpy(rng.integers(-2**40, 2**40, 256)).to(card)
    for n in _WIDEN_LENGTHS:
        vals = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
        vals = vals.to(card)
        for shift in range(16):
            v = _at_alignment(vals, shift)
            got = kmb.map_bytes_widen(v, table, out)
            assert got.dtype == out
            want = kmb.map_bytes_widen_plain(v, table, out)
            assert torch.equal(got, want), (n, shift)


@pytest.mark.cuda
def test_map_bytes_row_modes_are_one_kernel_a_call(card):
    """The mirror and word-start modes each run their kernel alone: no
    memset and no zero fill beside it."""
    offs, vals, _rows = map_case("neighbours")
    o, v = (torch.from_numpy(x).to(card) for x in (offs, vals))
    for mode, name in (("mirror", "mirror_kernel"),
                       ("word_start", "word_start_kernel")):
        t = torch.from_numpy(map_tables()[mode]).to(card)
        seen = _one_kernel(lambda: kmb.map_bytes(o, v, t, mode), 5)
        assert len(seen) == 1 and name in next(iter(seen)), seen
        assert not any("memset" in k.lower() or "fill" in k.lower()
                       for k in seen), seen


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
    got_lead = kpt.polya_tail(t.offsets, t.values, chars, "start")
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
    for end in ("end", "start"):
        assert torch.equal(kpt.polya_tail(offs, vals, members, end),
                           kpt.polya_tail_plain(offs, vals, members, end))


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


# -- span_concat's redesign: the cases its Hopper design must survive --------

# each case's columns and literals; test_torch_redesign_k10a_k12.py holds
# the twin to exon_tpu's functions on them, the CUDA test below the kernel
# to the twin
CONCAT_CASES = ["nulls", "empty", "long separator", "pad 1", "pad several",
                "cut", "repeat 0", "repeat past a tile", "offsets past 0",
                "many pieces", "n 0", "n 1", "tiles"]
# the functions each case runs, through the port's ops/sqlfuncs.py
CONCAT_OPS = ["concat", "pipe", "concat_ws", "lpad", "rpad", "repeat",
              "coalesce"]


def concat_case(case: str) -> dict:
    """numpy columns ``cols`` [(offsets int32, values uint8, validity)] and
    the literals of a span_concat case: ``lit`` (an argument of concat and
    coalesce), ``sep``, ``pad``, ``width`` and ``k`` (repeat's count)."""
    rng = np.random.default_rng(len(case) + 300)
    spec = dict(n=120, ncols=3, maxlen=40, p_null=0.2, lit=b"<lit>",
                sep=b"|", pad=b"ab", width=9, k=2, before=0, after=0)
    spec.update({
        "nulls": dict(n=64, p_null=None),
        "empty": dict(n=50, maxlen=2, lit=b"", sep=b"", pad=b"", width=0),
        "long separator": dict(
            n=40, sep=bytes(rng.integers(32, 127, 600, dtype=np.uint8)),
            pad=bytes(rng.integers(32, 127, 600, dtype=np.uint8)),
            width=700),
        "pad 1": dict(n=100, pad=b"*", width=12),
        "pad several": dict(n=100, pad="é☃".encode(), width=31),
        "cut": dict(n=100, width=3, pad=b"-"),
        "repeat 0": dict(k=0),
        "repeat past a tile": dict(n=20, maxlen=3000, k=3),
        "offsets past 0": dict(before=37, after=11),
        "many pieces": dict(n=50, ncols=40, maxlen=6),
        "n 0": dict(n=0),
        "n 1": dict(n=1),
        "tiles": dict(n=5000, maxlen=24),
    }.get(case, {}))
    n, cols = spec["n"], []
    for c in range(spec["ncols"]):
        lens = rng.integers(0, spec["maxlen"] + 1, n)
        if case == "repeat past a tile":
            lens[:3] = [1, 2999, 4097]
        if case == "empty":
            lens[rng.random(n) < 0.6] = 0
        before, after = spec["before"] + c, spec["after"]
        offs = np.zeros(n + 1, np.int64)
        np.cumsum(lens, out=offs[1:])
        offs += before
        vals = rng.integers(32, 127, int(offs[-1]) + after,
                            dtype=np.uint8)
        if spec["p_null"] is None:  # every pattern of NULLs over 3 columns
            valid = (np.arange(n) >> c) % 2 == 0
        else:
            valid = rng.random(n) >= spec["p_null"]
        cols.append((offs.astype(np.int32), vals, valid))
    return dict(cols=cols, **{k: spec[k] for k in ("lit", "sep", "pad",
                                                   "width", "k")})


def concat_op(S, op: str, case: dict, cols: list):
    """The port's (or, given exon_tpu's sqlfuncs, the JAX package's)
    function ``op`` over a case's columns (VarColumns of that package)."""
    # the literal repeats on every row; with batch None there is one, so
    # a case of no rows leaves it out
    lit = [case["lit"].decode("latin-1")] if cols[0].capacity else []
    if op == "concat":
        return S.fn_concat(None, *cols, *lit)
    if op == "pipe":
        return S.fn_concat_op(None, *cols)
    if op == "concat_ws":
        return S.fn_concat_ws(None, case["sep"].decode("latin-1"), *cols)
    if op in ("lpad", "rpad"):
        return S._pad(None, cols[0], case["width"], case["pad"],
                      op == "lpad", op)
    if op == "repeat":
        return S.fn_repeat(None, cols[0], case["k"])
    return S.fn_coalesce(None, *cols[:3], *lit)


@pytest.mark.cuda
@pytest.mark.parametrize("op", CONCAT_OPS)
@pytest.mark.parametrize("case", CONCAT_CASES)
def test_span_concat_kernel_matches_twin_on_its_cases(card, case, op):
    """The port's function on the card (span_concat's kernel) against the
    same on the CPU (its twin), bit for bit, for every case; two kernels a
    call (the offsets pass, the write pass) beside the total's copy."""
    from exon_tpu_torch.batch import VarColumn as TVar
    from exon_tpu_torch.ops import sqlfuncs as S

    spec = concat_case(case)

    def run(dev):
        cols = [TVar(*(torch.from_numpy(a).to(dev) for a in (v, o, ok)))
                for o, v, ok in spec["cols"]]
        return concat_op(S, op, spec, cols)

    got, want = run(card), run("cpu")
    assert torch.equal(got.offsets.cpu(), want.offsets)
    assert torch.equal(got.values.cpu(), want.values)
    assert torch.equal(got.validity.cpu(), want.validity)
    if case == "tiles" and op == "concat_ws":
        cols = [TVar(*(torch.from_numpy(a).to(card) for a in (v, o, ok)))
                for o, v, ok in spec["cols"]]
        sources, pieces = S.concat_ws_pieces(spec["sep"], cols,
                                              spec["cols"][0][0].shape[0] - 1)
        seen = _one_kernel(lambda: kconcat.span_concat(sources, pieces), 5)
        named = [k for k in seen if "concat" in k]
        assert sorted(named) == sorted(k for k in seen if "kernel" in k), seen
        assert len(named) == 2, seen


@pytest.mark.cuda
def test_span_concat_kernel_takes_every_piece_form(card):
    """Per-row and scalar starts, spans and lengths, inline and device
    literals, every gate, cut, fill and times, against the twin; and past
    MAX_PIECES (a device table)."""
    rng = np.random.default_rng(46)
    n = 3000
    offs, vals = _var(rng, n, card)
    lens = (offs[1:] - offs[:-1]).to(torch.int32)
    valid = torch.from_numpy(rng.random(n) < 0.7).to(card)
    other = torch.from_numpy(rng.random(n) < 0.5).to(card)
    long_lit = bytes(rng.integers(0, 256, 700, dtype=np.uint8))
    srcs = [vals, b"-=", long_lit, torch.from_numpy(
        rng.integers(0, 256, 64, dtype=np.uint8)).to(card)]
    P = kconcat.Piece
    pieces = [P(1, gate="join", valid=valid), P(0, offs, gate="valid",
                                                 valid=valid),
              P(3, 5, span=3, length=lens % 7), P(2, 13, length=40),
              P(1, fill=60, span=1), P(0, offs, times=3, cap=50),
              P(0, offs[:-1], span=lens.clamp(min=1), length=lens * 2),
              P(3, 0, length=64, gate="first", valid=other),
              P(2, gate="first", valid=valid), P(1, 1, length=1, times=5)]
    for ps in (pieces, pieces * 4):  # 10 pieces, then 40
        o1, v1 = kconcat.span_concat(srcs, ps)
        o2, v2 = kconcat.span_concat_plain(srcs, ps)
        assert torch.equal(o1, o2) and torch.equal(v1, v2)


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
               partition=True, order=True, order_key="o"):
    from exon_tpu_torch.plan.expressions import ColumnRef, WindowCall

    child = None if fn in ("row_number", "rank", "dense_rank", "ntile",
                           "percent_rank", "cume_dist") else ColumnRef(value)
    return WindowCall(fn, child, [ColumnRef("p")] if partition else [],
                      [(ColumnRef(order_key), not desc)] if order else [],
                      offset, default, frame)


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


# -- window_bounds' redesign: the cases its Hopper design must survive ------

BOUNDS_TILE = 1024  # kernels/window_bounds.py TILE_ROWS
BOUNDS_CASES = ["one partition", "every row a partition", "all peers",
                "tile edges", "n 1", "n tile - 1", "n tile", "n tile + 1"]


def bounds_case(case: str) -> tuple:
    """numpy int64 (p, o) of a window_bounds case, in sorted (p, o) order:
    a partition key and an order key whose partitions and peer groups
    take the case's shape."""
    rng = np.random.default_rng(len(case) + 400)
    t = BOUNDS_TILE
    n = {"n 1": 1, "n tile - 1": t - 1, "n tile": t, "n tile + 1": t + 1,
         "tile edges": 3 * t + 3}.get(case, 3 * t + 17)
    r = np.arange(n)
    if case == "one partition":
        p, o = np.full(n, 7), np.sort(rng.integers(0, 500, n))
    elif case == "every row a partition":
        p, o = r * 3 - 5, rng.integers(0, 4, n)
    elif case == "all peers":
        p, o = np.full(n, 1), np.full(n, 5)
    elif case == "tile edges":
        # partitions and peer groups start exactly at tile edges and one
        # row either side of them
        edges = [e + d for e in (t, 2 * t, 3 * t) for d in (-1, 0, 1)]
        p = np.searchsorted(np.array(edges[::2]), r, side="right")
        o = np.searchsorted(np.array(edges), r, side="right")
    else:
        p = np.sort(rng.integers(0, 4, n))
        o = np.concatenate([np.sort(rng.integers(0, 20, int(k)))
                            for k in np.bincount(p, minlength=4)])
    return p.astype(np.int64), o.astype(np.int64)


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOUNDS_CASES)
def test_window_bounds_kernel_matches_twin_on_its_cases(card, case):
    """Each case's key matrix (sort_rows over (p, o)) and the bare rows,
    with 0, 1 and 2 partition rows, bit for bit."""
    from exon_tpu_torch.kernels import window_bounds as kwb

    p, o = bounds_case(case)
    keys = torch.from_numpy(np.stack([p, o, o // 3])).to(card)
    for n_part in (0, 1, 2, 3):
        got = kwb.window_bounds(keys, n_part)
        want = kwb.window_bounds_plain(keys.cpu(), n_part)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), n_part


@pytest.mark.cuda
@pytest.mark.parametrize("case", BOUNDS_CASES)
def test_window_bounds_is_two_kernels_and_no_memset(card, case):
    """torch.profiler's records of window_bounds on each case's key
    matrix: two kernels a call and no memset (apart from the twin
    comparison, so a failure says which of the two it is)."""
    from exon_tpu_torch.kernels import window_bounds as kwb

    p, o = bounds_case(case)
    keys = torch.from_numpy(np.stack([p, o, o // 3])).to(card)
    seen = _one_kernel(lambda: kwb.window_bounds(keys, 1), 5)
    assert len(seen) == 2 and all("bounds_" in k for k in seen), seen
    assert not any("memset" in k.lower() for k in seen), seen


# lag/lead offsets and ROWS frames just inside and just past the halo a
# block of window_frame.cu stages (LOOP_ROWS rows on each side)
HALO_CASES = (
    [("lag", None, o) for o in (63, 64, 65, 1000)]
    + [("lead", None, o) for o in (64, 65)]
    + [(fn, fr, 2) for fn in ("min", "max", "first_value", "last_value",
                              "nth_value", "count")
       for fr in (("rows", -64, 0), ("rows", 0, 64), ("rows", -65, -2),
                  ("rows", 3, 65), ("rows", -31, 32))])


def _frame_batch(rng, n, n_parts, device):
    """A port batch for window_frame's shapes: partition key p (n_parts
    partitions, one row each when n_parts == n), order keys o (int64), of
    (float32) and od (float64, a few NaN), each 10 % NULL at payload 0; the
    values vi (int64), vf (float32, a few NaN), vd (float64), v8 (int8)
    and vb (bool), 10 % NULL."""
    from exon_tpu_torch import datatypes as dt
    from exon_tpu_torch.batch import Batch, FixedColumn
    from exon_tpu_torch.datatypes import Field, Schema

    def nulls():
        return rng.random(n) >= 0.1

    od = rng.integers(-60, 60, n).astype(np.float64) / 2
    od[rng.random(n) < 0.02] = np.nan
    vf = rng.integers(-500, 500, n).astype(np.float32)
    vf[rng.random(n) < 0.03] = np.nan
    p = np.arange(n) if n_parts >= n else np.sort(rng.integers(0, n_parts,
                                                                n))
    cols = {
        "p": (dt.int64, p.astype(np.int64), np.ones(n, bool)),
        "o": (dt.int64, rng.integers(-40, 40, n).astype(np.int64), nulls()),
        "of": (dt.float32, rng.integers(-300, 300, n).astype(np.float32) / 4,
               nulls()),
        "od": (dt.float64, od, nulls()),
        "vi": (dt.int64, rng.integers(-1000, 1000, n).astype(np.int64),
               nulls()),
        "vf": (dt.float32, vf, nulls()),
        "vd": (dt.float64, rng.integers(-500, 500, n) / 4, nulls()),
        "v8": (dt.int8, rng.integers(-128, 128, n).astype(np.int8), nulls()),
        "vb": (dt.bool_, rng.random(n) < 0.5, nulls()),
    }
    schema = Schema(tuple(Field(k, t, True) for k, (t, _v, _ok) in
                          cols.items()))
    return Batch(schema, [FixedColumn(np.where(ok, v, 0).astype(v.dtype), ok)
                          for _t, v, ok in cols.values()], n).to_device(device)


def _same_words(got, want) -> bool:
    """Equal bit for bit, but any NaN equals any NaN."""
    g, w = got.view(torch.int64), want.view(torch.int64)
    if got.is_floating_point():
        nan = got.isnan()
        return torch.equal(nan, want.isnan()) and torch.equal(g[~nan],
                                                              w[~nan])
    return torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("fn,frame,offset", WINDOW_CASES + HALO_CASES,
                         ids=[f"{f}-{fr}-{o}" for f, fr, o in
                              WINDOW_CASES + HALO_CASES])
def test_window_frame_kernel_matches_twin(card, fn, frame, offset):
    """Every mode on the card against the twin on the card, bit for bit
    (values and validity; NaN as NaN): 20,000 rows in 6 partitions over
    int64, float32 and float64 values and ASC and DESC keys; then 1, 1,025
    and 3,001 rows in one partition (partitions across tiles, row counts
    not a multiple of the tile), 2,049 rows in 3 and 700 rows of one row
    each, over float32, float64 (NaN keys) and int64 order keys, with
    values of every column type, NaN and NULL among them."""
    from exon_tpu_torch.kernels import window_frame as kwf
    from exon_tpu_torch.plan import window_exec as TW

    rng = np.random.default_rng(7)
    batch, _cols = _window_batch(rng, 20_000, card)
    runs = [(batch, value, "o", desc) for value, desc in
            (("vi", False), ("vf", True), ("vd", False))]
    for n, parts in ((1, 1), (1025, 1), (3001, 1), (2049, 3), (700, 700)):
        b = _frame_batch(rng, n, parts, card)
        runs += [(b, value, key, desc) for value, key, desc in
                 (("vf", "of", False), ("vd", "od", True),
                  ("v8", "o", False), ("vb", "od", False),
                  ("vi", "of", True))]
    for b, value, key, desc in runs:
        call = _port_call(fn, frame, offset, value, desc, order_key=key)
        perm, bounds = TW._sorted_bounds(call, b)
        values = valid = fr = None
        if call.child is not None:
            values, valid = TW._values(call, b)
        if frame is not None:
            fr = TW._frame(call, b, perm)
        got = kwf.window_frame(fn, bounds, perm, values, valid, fr, offset)
        want = kwf.window_frame_plain(fn, bounds, perm, values, valid, fr,
                                      offset)
        label = (b.length, value, key, desc)
        assert torch.equal(got[1], want[1]), label
        assert _same_words(got[0], want[0]), label


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


@pytest.mark.cuda
def test_f35_rollup_under_order_by_on_the_card(card, tmp_path):
    """F35: a ROLLUP's ungrouped branch lands on the card, so the sort above
    the union takes it; the result equals the CPU run, and an ungrouped
    aggregate's columns lie on the card."""
    import exon_tpu_torch as T
    from benchlib.gff_fixture import make_gff

    gff = make_gff(5000, 3, path=str(tmp_path / "t.gff"))
    sql = (f"SELECT seqname, strand, COUNT(*) AS n, SUM(start) AS s FROM "
           f"gff_scan('{gff}') GROUP BY ROLLUP(seqname, strand) ORDER BY "
           "seqname, strand")
    got = T.ExonSession(device="cuda").sql(sql).collect_arrow()
    assert got.equals(T.ExonSession(device="cpu").sql(sql).collect_arrow())
    df = T.ExonSession(device="cuda").sql(
        f"SELECT COUNT(*) AS n, MAX(start) AS m FROM gff_scan('{gff}')")
    (batch,) = list(df._execute(df.logical_plan()).batches())
    assert all(c.values.device.type == "cuda" for c in batch.columns)


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
@pytest.mark.parametrize("n_parts", [1, 8, 33, 100, 3000, 19285])
@pytest.mark.parametrize("n", [2047, 2048, 2049, 3 * 2048 + 15])
def test_bucket_pack_tile_edges_match_twin(card, n, n_parts):
    """Each row count around the rank pass's 2,048-row tile, to 1 to 19,285
    destinations (past 1,228 the counters take more than 48 KB of shared
    memory; at 19,285 one warp a tile), at capacity 0, 1, the largest
    count and one less, masked, with every column width and 17 columns."""
    from exon_tpu_torch.kernels import bucket_pack as kb

    rng = np.random.default_rng(n + n_parts)
    route, mask, cols = _bucket_inputs(rng, n, True)
    host = [torch.from_numpy(c) for c in (cols * 3)[: kb.MAX_COLS]]
    m = torch.from_numpy(mask)
    r = torch.from_numpy(route)
    counts = kb.bucket_pack_plain(r, m, [], n_parts, 0)[1]
    largest = int(counts.max())
    for cap in (0, 1, largest, max(largest - 1, 0)):
        want = kb.bucket_pack_plain(r, m, host, n_parts, cap)
        got = kb.bucket_pack(r.to(card), m.to(card),
                             [c.to(card) for c in host], n_parts, cap)
        for g, w in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_bucket_pack_refuses_destinations_past_its_shared_memory(card):
    from exon_tpu_torch.kernels import bucket_pack as kb

    keys = torch.arange(10, device=card)
    with pytest.raises(ValueError, match="destinations exceed"):
        kb.bucket_pack(keys, None, [keys], kb.MAX_PARTS + 1, 4)


@pytest.mark.cuda
def test_bucket_pack_past_the_resident_blocks_matches_twin(card):
    """50 M rows to 8 destinations: 24,415 rank tiles, several times the
    blocks the card holds at once, each waiting on the tiles before it."""
    from exon_tpu_torch.kernels import bucket_pack as kb

    gen = torch.Generator(device=card)
    gen.manual_seed(51)
    n = 50_000_000
    keys = torch.randint(-2**62, 2**62, (n,), device=card, generator=gen)
    mask = torch.rand(n, device=card, generator=gen) < 0.9
    vals = torch.arange(n, dtype=torch.int32, device=card)
    got = kb.bucket_pack(keys, mask, [vals], 8, n // 8)
    want = kb.bucket_pack_plain(keys, mask, [vals], 8, n // 8)
    for g, w in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
        assert torch.equal(g, w)


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
def test_hash_aggregate_float_min_max_take_nan(card, mode, monkeypatch):
    """A NaN wins a float64 MIN or MAX and is kept, as in exon_tpu's
    .at[].min/max and the twin's scatter_reduce (F33): a group that holds a
    live NaN gives NaN, a group of NaN alone gives NaN, a group with no live
    value keeps the identity +inf / -inf; the count counts the NaNs. In one
    table, through a table that grows (1,500 keys in batches of 500) and on
    merge-mode input; the kernel against numpy and against its twin."""
    rng = np.random.default_rng(6)
    n = 5000
    k = rng.integers(0, 1500 if mode == "grow" else 40, n)
    k[:3] = 4
    x = rng.uniform(-1e3, 1e3, n)
    x[rng.random(n) < 0.02] = np.nan
    x[k == 3] = np.nan                       # a group of NaN alone
    c = rng.integers(0, 3, n) if mode == "merge" else rng.random(n) < 0.8
    c[k == 4] = 0                            # a group with no live value
    keys = torch.from_numpy(k[None, :]).to(card)
    xt, ct = torch.from_numpy(x).to(card), torch.from_numpy(c).to(card)
    results = []
    for insert in (hk.insert, hk.insert_plain):
        monkeypatch.setattr(hk, "insert", insert)
        agg = GroupedHashAggregate(1, [(hk.MIN, True), (hk.MAX, True)], card)
        step = 500 if mode == "grow" else n
        for lo in range(0, n, step):
            hi = lo + step
            agg.reserve(hi - lo)
            insert(agg.table, keys[:, lo:hi].contiguous(),
                   torch.ones_like(keys[:, lo:hi], dtype=torch.uint8), None,
                   torch.arange(lo, hi, device=card) if mode == "merge"
                   else None, lo, [xt[lo:hi]] * 2, [ct[lo:hi]] * 2)
            agg._groups_bound += hi - lo
        if mode == "grow":
            assert agg.table.capacity > 1024    # the table was rehashed
        results.append(agg.finalize())
    got, want = results
    assert torch.equal(got.keys, want.keys)
    for a in range(2):
        assert torch.equal(got.cnt[a], want.cnt[a])
        assert torch.equal(torch.isnan(got.acc[a]), torch.isnan(want.acc[a]))
        both = ~torch.isnan(want.acc[a])
        assert torch.equal(got.acc[a][both], want.acc[a][both])
    nan_groups = 0
    for g in range(got.num_groups):
        live = (k == int(got.keys[0, g])) & (c > 0)
        assert int(got.cnt[0][g]) == int(c[live].sum())
        lo_v, hi_v = float(got.acc[0][g]), float(got.acc[1][g])
        if np.isnan(x[live]).any():
            nan_groups += 1
            assert np.isnan(lo_v) and np.isnan(hi_v)
        else:
            assert lo_v == x[live].min(initial=np.inf)
            assert hi_v == x[live].max(initial=-np.inf)
    assert nan_groups > 1
    assert np.isnan(float(got.acc[0][got.keys[0] == 3]))
    assert float(got.acc[0][got.keys[0] == 4]) == np.inf
    assert float(got.acc[1][got.keys[0] == 4]) == -np.inf


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
