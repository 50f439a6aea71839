"""The twins of gather_var (K1b) and bucket_pack (K13) held to exon_tpu at
the shapes their Hopper kernels' designs must survive, and the workspace of
status words the single-pass scans share (kernels/_lookback.py).

(a) gather_var is an offsets pass over tiles of 1,024 taken rows, 4 a
thread, then a copy over the output in 16-byte words, 4 KB a block, whose
first rows the offsets pass marks for the first m + 1 blocks: row lengths
0, 1, 15, 16 and 17, 1,023, 1,024, 1,025 and 3 x 1,024 + 15 taken rows,
rows of 10-40 KB (blocks past the marks), offsets that start past 0, a
values view at an odd offset, unsorted and repeated indices, no row taken
and a total of 0, through ``ops.layout.take_var``
against ``exon_tpu.ops.layout.take_var``; and the refusal of an output of
2^31 bytes, made from one 1 MiB row taken 2,048 times, so that nothing of
2 GB is allocated.
(b) bucket_pack is a rank pass over tiles of up to 8 warps x 256 rows, a
look-back a destination, then a move pass that scatters the rows and
zeroes the empty slots: 2,047, 2,048, 2,049 and 3 x 2,048 + 15 rows to 1,
8, 33 and 100 destinations, each at bucket capacities 0, 1, the largest
count (exact) and one less (overflowing), masked, with bool, 1-, 4- and
8-byte and [n, w] columns, against ``exon_tpu.parallel.shuffle``'s
``partition_ids`` + ``bucketize`` (buckets, zeros in the empty slots
included, and counts) and a stable numpy sort (destinations and ranks);
17 columns, and the refusal of an 18th.
(c) the workspace: calls numbered by epoch, tickets counted on from call to
call and from kernel to kernel on one stream, growth and the epoch's wrap.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exon_tpu.batch import VarColumn as JVar
from exon_tpu.ops import layout as jlayout
from exon_tpu.parallel import shuffle as JS
import exon_tpu_torch.batch as tb
from exon_tpu_torch.kernels import _lookback
from exon_tpu_torch.kernels import bucket_pack as kb
from exon_tpu_torch.kernels import gather_var as kg
from exon_tpu_torch.ops import layout as tlayout

I64 = np.iinfo(np.int64)

# ---------------------------------------------------------------------------
# (a) gather_var
# ---------------------------------------------------------------------------

GATHER_CASES = ["lengths_0_1_15_16_17", "tile_less_1", "tile", "tile_and_1",
                "three_tiles_and_15", "past_the_marks", "offsets_past_zero",
                "odd_values_view", "unsorted_repeats", "no_rows_taken",
                "total_zero"]


def _gather_case(case: str):
    """(offsets int32 [n + 1], values uint8 torch, indices int32)."""
    rng = np.random.default_rng(len(case) * 7 + 1)
    n = 3000
    lens = rng.choice([0, 1, 15, 16, 17], n)
    if case.startswith(("tile", "three")):
        lens = rng.integers(0, 60, n)
    if case == "past_the_marks":
        lens = rng.integers(10_000, 40_000, n)
    if case == "total_zero":
        lens = np.zeros(n, np.int64)
    start = 37 if case in ("offsets_past_zero", "odd_values_view") else 0
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    offs += start
    total = int(offs[-1]) + 11
    values = torch.from_numpy(rng.integers(0, 256, total + 3)
                              .astype(np.uint8))
    values = values[3:] if case == "odd_values_view" else values[:total]
    m = {"tile_less_1": kg.TILE - 1, "tile": kg.TILE,
         "tile_and_1": kg.TILE + 1, "three_tiles_and_15": 3 * kg.TILE + 15,
         "past_the_marks": 5, "no_rows_taken": 0}.get(case, 2500)
    if case in ("unsorted_repeats", "total_zero", "past_the_marks") or \
            case.startswith(("tile", "three")):
        idx = rng.integers(0, n, m)
    else:
        idx = np.sort(rng.choice(n, m, replace=False))
    return offs.astype(np.int32), values, idx.astype(np.int32)


@pytest.mark.parametrize("case", GATHER_CASES)
def test_take_var_matches_jax(case):
    offs, values, idx = _gather_case(case)
    n, m = offs.shape[0] - 1, idx.shape[0]
    valid = np.random.default_rng(5).random(n) < 0.9
    if case == "odd_values_view":
        assert values.storage_offset() == 3
    jcol = JVar(jnp.asarray(values.numpy()), jnp.asarray(offs),
                jnp.asarray(valid))
    # a count of 0 is a capacity of n out-of-range slots for the JAX take
    jidx = idx if m else np.full(n, n, np.int32)
    total = int((offs[1:] - offs[:-1])[idx].sum())
    want = jlayout.take_var(jcol, jnp.asarray(jidx), np.int32(m),
                            out_vcap=max(total, 1))
    got = tlayout.take_var(tb.VarColumn(values, torch.from_numpy(offs),
                                        torch.from_numpy(valid)),
                           torch.from_numpy(idx))
    want_off = np.asarray(want.offsets)[: m + 1]
    assert got.offsets.dtype == torch.int32
    np.testing.assert_array_equal(got.offsets.numpy(), want_off)
    assert int(want_off[-1]) == total == got.values.shape[0]
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values)[:total])
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity)[:m])


def test_gather_var_refuses_2_31_output_bytes():
    """One 1 MiB row taken 2,048 times makes 2^31 bytes: refused before
    anything of that size is allocated; taken 2,047 times it fits (checked
    on the offsets alone)."""
    row = 1 << 20
    offs = torch.tensor([0, row], dtype=torch.int32)
    values = torch.zeros(row, dtype=torch.uint8)
    with pytest.raises(ValueError, match="exceed int32"):
        kg.gather_var(offs, values, torch.zeros(2048, dtype=torch.int32))
    new_off, _starts, total = kg._new_offsets(
        offs, torch.zeros(2047, dtype=torch.int32))
    assert total == 2047 * row < 1 << 31
    assert int(new_off[-1]) == total


def test_gather_var_twin_keeps_offsets_int32_and_empty_outputs():
    offs = torch.tensor([5, 5, 9], dtype=torch.int32)
    values = torch.arange(12, dtype=torch.uint8)
    new_off, out = kg.gather_var(offs, values,
                                 torch.zeros(0, dtype=torch.int32))
    assert new_off.tolist() == [0] and out.shape == (0,)
    new_off, out = kg.gather_var(offs, values,
                                 torch.tensor([0, 0], dtype=torch.int32))
    assert new_off.dtype == torch.int32 and new_off.tolist() == [0, 0, 0]
    assert out.shape == (0,)
    new_off, out = kg.gather_var(offs, values,
                                 torch.tensor([1, 0, 1], dtype=torch.int32))
    assert new_off.tolist() == [0, 4, 4, 8]
    assert out.tolist() == [5, 6, 7, 8, 5, 6, 7, 8]


# ---------------------------------------------------------------------------
# (b) bucket_pack
# ---------------------------------------------------------------------------


def _keys(rng, n):
    keys = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    edge = np.asarray([0, -1, I64.min, I64.max, 2**32, -2**32], np.int64)
    keys[: min(n, edge.shape[0])] = edge[: min(n, edge.shape[0])]
    return keys


def _columns(rng, n, k=7):
    """k columns cycling through every width the kernel takes."""
    makers = [lambda: rng.random(n) < 0.5,
              lambda: rng.integers(0, 256, n).astype(np.uint8),
              lambda: rng.integers(-2**31, 2**31, n).astype(np.int32),
              lambda: rng.integers(I64.min, I64.max, n, dtype=np.int64),
              lambda: rng.standard_normal(n),
              lambda: rng.integers(0, 256, (n, 13)).astype(np.uint8),
              lambda: rng.integers(-9, 9, (n, 3)).astype(np.int64)]
    return [makers[i % len(makers)]() for i in range(k)]


def _hold_to_jax(keys, mask, cols, n_parts, cap):
    """bucket_pack's twin against partition_ids + bucketize (buckets and
    counts) and a stable numpy sort (destinations and ranks)."""
    buckets, counts, dest, rank = kb.bucket_pack(
        torch.from_numpy(keys), torch.from_numpy(mask),
        [torch.from_numpy(c) for c in cols], n_parts, cap)
    jdest = JS.partition_ids(jnp.asarray(keys), n_parts)
    jcols, jcounts = JS.bucketize(jdest, jnp.asarray(mask),
                                  [jnp.asarray(c) for c in cols], n_parts,
                                  cap)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.dtype == torch.int32
    for t, j in zip(buckets, jcols):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                      j.view(np.uint8))
    want_dest = np.where(mask, np.asarray(jdest), n_parts)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    want_rank = np.full(keys.shape[0], -1)
    for d in range(n_parts):
        rows = np.flatnonzero(want_dest == d)
        want_rank[rows] = np.arange(rows.shape[0])
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    # every slot at or past a destination's count holds zeros
    for t in buckets if cap else []:
        flat = t.numpy().reshape(n_parts, cap, -1).view(np.uint8)
        for d in range(n_parts):
            assert not flat[d, min(int(counts[d]), cap):].any()
    return counts


TILE = kb.MAX_WARPS * kb.WARP_ROWS  # the rank pass's rows a tile


@pytest.mark.parametrize("n_parts", [1, 8, 33, 100])
@pytest.mark.parametrize("n", [TILE - 1, TILE, TILE + 1, 3 * TILE + 15])
def test_bucket_pack_matches_jax(n, n_parts):
    """Each row count around the rank pass's 2,048-row tile, at capacity 0,
    1, the largest count (every row kept) and one less (an overflow)."""
    rng = np.random.default_rng(n * 131 + n_parts)
    keys = _keys(rng, n)
    mask = rng.random(n) < 0.8
    cols = _columns(rng, n)
    largest = int(np.bincount(np.asarray(JS.partition_ids(
        jnp.asarray(keys), n_parts))[mask], minlength=n_parts).max())
    for cap in (0, 1, largest, largest - 1):
        counts = _hold_to_jax(keys, mask, cols, n_parts, cap)
        assert int(counts.max()) == largest
    assert kb.launches == 0  # the twin ran: the tensors lie on the CPU


def test_bucket_pack_seventeen_columns_match_jax():
    rng = np.random.default_rng(17)
    n, n_parts = 2500, 8
    keys = _keys(rng, n)
    cols = _columns(rng, n, kb.MAX_COLS)
    _hold_to_jax(keys, rng.random(n) < 0.9, cols, n_parts, 200)
    with pytest.raises(ValueError, match="columns exceed"):
        kb.bucket_pack(torch.from_numpy(keys), None,
                       [torch.from_numpy(c) for c in
                        _columns(rng, n, kb.MAX_COLS + 1)], n_parts, 200)


@pytest.mark.parametrize("n_parts", [1, 8, 1228, 1229, 5000, 19285])
def test_rank_warps_fit_a_block_shared_memory(n_parts):
    """The rank pass's warps a tile: 8 while (8 + 2) int32 counters a
    destination fit the block's shared memory, fewer past that, one at
    MAX_PARTS; one more destination than MAX_PARTS leaves no warp."""
    warps = kb.rank_warps(n_parts)
    assert 1 <= warps <= kb.MAX_WARPS
    assert (warps + 2) * n_parts * 4 <= kb.SHARED_MAX
    assert warps == kb.MAX_WARPS or (warps + 3) * n_parts * 4 > kb.SHARED_MAX
    assert (n_parts == kb.MAX_PARTS) == (warps == 1)
    assert kb.rank_warps(kb.MAX_PARTS + 1) < 1


# ---------------------------------------------------------------------------
# (c) the workspace of status words
# ---------------------------------------------------------------------------


def _record(calls):
    def launch(status, ticket, base, epoch):
        calls.append((status, ticket, base, epoch))
    return launch


def test_scans_on_one_stream_share_epochs_and_tickets(monkeypatch):
    """Three calls of different kernels on one stream: each a new epoch,
    each ticket base the tiles launched before it, on the same words."""
    monkeypatch.setattr(_lookback, "_workspaces", {})
    cpu, calls = torch.device("cpu"), []
    _lookback.scan(cpu, 3, 40, 5, _record(calls))       # bucket_pack-like
    _lookback.scan(cpu, 3, 7, 7, _record(calls))        # gather_var-like
    _lookback.scan(cpu, 3, 1, 1, _record(calls))        # compact_mask-like
    assert [c[3] for c in calls] == [1, 2, 3]
    assert [c[2] for c in calls] == [0, 5, 12]
    ws = _lookback.workspace(cpu, 3, 1)
    assert {c[0] for c in calls} == {ws.status}
    assert {c[1] for c in calls} == {ws.status + 8 * 40} == {ws.ticket}
    assert (ws.epoch, ws.tickets) == (3, 13)


def test_scan_grows_the_words_and_restarts_the_count(monkeypatch):
    monkeypatch.setattr(_lookback, "_workspaces", {})
    cpu, calls = torch.device("cpu"), []
    _lookback.scan(cpu, 0, 10, 10, _record(calls))
    _lookback.scan(cpu, 0, 11, 11, _record(calls))      # 20 words, cleared
    ws = _lookback.workspace(cpu, 0, 1)
    assert ws.capacity == 20 and not bool(ws.words.any())
    assert calls[1][2:] == (0, 1) and (ws.epoch, ws.tickets) == (1, 11)
    _lookback.scan(cpu, 0, 0, 0, _record(calls))        # at least one word
    assert calls[2][2:] == (11, 2)


def test_scan_clears_the_words_when_the_epoch_wraps(monkeypatch):
    monkeypatch.setattr(_lookback, "_workspaces", {})
    cpu, calls = torch.device("cpu"), []
    _lookback.scan(cpu, 0, 4, 4, _record(calls))
    ws = _lookback.workspace(cpu, 0, 1)
    ws.words.fill_(-1)
    ws.epoch = _lookback.EPOCH_LIMIT
    _lookback.scan(cpu, 0, 4, 4, _record(calls))
    assert calls[1][3] == 1 and not bool(ws.words.any())
    # the counter was cleared with the words: the tickets restart at 0
    assert calls[1][2] == 0 and ws.tickets == 4
