"""The kernel wrappers of exon_tpu_torch: dispatch on the CPU, and kernel vs
plain twin on a CUDA card (tests marked ``cuda``, which skip where there is
none; chip_smoke.py runs the same comparison at the main path's shapes).
Tolerance: exact, except float64 sums in the hash aggregate, relative 1e-12
(atomic order changes the rounding)."""

import numpy as np
import pytest
import torch

from exon_tpu_torch import kernels
from exon_tpu_torch.kernels import compact_mask as kc
from exon_tpu_torch.kernels import expand_segments as ke
from exon_tpu_torch.kernels import gather_spans as kgs
from exon_tpu_torch.kernels import gather_var as kg
from exon_tpu_torch.kernels import hash_aggregate as hk
from exon_tpu_torch.kernels import like_match as kl
from exon_tpu_torch.kernels import line_index as kli
from exon_tpu_torch.kernels import row_hash as kr
from exon_tpu_torch.kernels import sort_keys as kk
from exon_tpu_torch.kernels import string_eq as ks
from exon_tpu_torch.kernels import text_records as ktr
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
