"""expand_segments: repeat row i ``counts[i]`` times into index pairs, with
the counts' offsets and total.

Replaces exon_tpu/ops/layout.py ``expand_segments`` (:308) together with the
index arithmetic of exon_tpu/plan/join_exec.py ``_jit_emit`` (:246-251).
Kernel source: ``csrc/expand_segments.cu``.

``expand_segments(lo, counts, n_build)`` takes int32 ``lo [n]`` (each row's
first match in the sorted build side; zeros where only the row index is
wanted) and int32 ``counts [n]`` (its output slots, none negative). It
returns ``(probe_idx, build_idx, offsets, total)``: int32 ``probe_idx
[total]`` and ``build_idx [total]``, where slot ``offsets[i] + j`` holds
``probe_idx = i`` and ``build_idx = min(lo[i] + j, n_build - 1)`` (0 when
the build side is empty); int64 ``offsets [n + 1]``, the exclusive starts
and then the total; and ``total``, a host int. A total of 2^31 or more
raises: the indices are int32.

On the card a call is two launches around one host read: a single pass
scans the counts into the offsets on the look-back of ``_lookback`` and
notes the row at the start of every output tile of ``SLOT_TILE`` slots,
the total ``offsets[n]`` is read, and a write pass balanced over the
output slots writes both indices in 16-byte stores. Its bound on the
H100: the counts and lo read and the offsets written (16 bytes a row), the
two indices written (8 bytes a slot).
"""

from __future__ import annotations

import threading

import torch

from . import _build, _lookback

launches = 0

_INT32_LIMIT = 1 << 31
_TILE = 256 * 4       # rows of an offsets tile (kTile in the source)
SLOT_TILE = 256 * 4   # slots of a write block (kSlots in the source)
# an output tile's first row for every SLOT_TILE slots of a total below 2^31
_MAX_TILES = -(-(_INT32_LIMIT - 1) // SLOT_TILE)

_first_rows: dict = {}
_lock = threading.Lock()


def _check(lo: torch.Tensor, counts: torch.Tensor) -> None:
    for name, t in (("lo", lo), ("counts", counts)):
        if t.dtype != torch.int32 or t.dim() != 1 or \
                t.shape[0] != lo.shape[0]:
            raise TypeError(f"expand_segments: {name} must be 1-d int32 of "
                            f"{lo.shape[0]} rows, got {t.dtype} "
                            f"{tuple(t.shape)}")
    if counts.device != lo.device:
        raise ValueError("expand_segments: tensors on different devices")


def _check_total(total: int) -> None:
    if total >= _INT32_LIMIT:
        raise ValueError(f"expand_segments: {total} slots exceed int32 "
                         "indices")


def expand_segments_plain(lo: torch.Tensor, counts: torch.Tensor,
                          n_build: int) -> tuple:
    """The plain PyTorch twin."""
    _check(lo, counts)
    dev = lo.device
    n = lo.shape[0]
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(counts, 0, dtype=torch.int64, out=offsets[1:])
    total = int(offsets[-1])
    _check_total(total)
    rid = torch.repeat_interleave(torch.arange(n, device=dev),
                                  counts.to(torch.int64), output_size=total)
    intra = torch.arange(total, device=dev) - offsets[rid]
    build = (lo.to(torch.int64)[rid] + intra).clamp(max=max(n_build - 1, 0))
    return rid.to(torch.int32), build.to(torch.int32), offsets, total


def _first_row(device: torch.device, stream: int) -> torch.Tensor:
    """The int32 [_MAX_TILES] buffer of output tiles' first rows of
    (device, stream): written by the offsets pass, read by the write pass
    of the same call."""
    key = (device.index, stream)
    with _lock:
        buf = _first_rows.get(key)
        if buf is None:
            buf = _first_rows[key] = torch.empty(_MAX_TILES,
                                                 dtype=torch.int32,
                                                 device=device)
    return buf


def expand_segments(lo: torch.Tensor, counts: torch.Tensor, n_build: int
                    ) -> tuple:
    global launches
    if not _build.on_cuda(lo, "expand_segments"):
        return expand_segments_plain(lo, counts, n_build)
    _check(lo, counts)
    dev = lo.device
    n = lo.shape[0]
    offsets = torch.empty(n + 1, dtype=torch.int64, device=dev)
    if n == 0:
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        return empty, empty, offsets.zero_(), 0
    lo, counts = lo.contiguous(), counts.contiguous()
    lib, stream = _build.library(), _build.stream_of(lo)
    first = _first_row(dev, stream)
    tiles = -(-n // _TILE)

    def offsets_pass(status, ticket, base, epoch):
        _build.check(lib.exon_expand_offsets(
            counts.data_ptr(), n, status, ticket, base, epoch,
            offsets.data_ptr(), first.data_ptr(), _MAX_TILES, stream),
            "expand_segments")

    _lookback.scan(dev, stream, tiles, tiles, offsets_pass)
    launches += 1
    total = int(offsets[-1])  # the one host read: the outputs' size
    _check_total(total)
    probe = torch.empty(total, dtype=torch.int32, device=dev)
    build = torch.empty(total, dtype=torch.int32, device=dev)
    if total:
        _build.check(lib.exon_expand_write(
            lo.data_ptr(), offsets.data_ptr(), first.data_ptr(), n, total,
            max(n_build - 1, 0), probe.data_ptr(), build.data_ptr(), stream),
            "expand_segments")
    return probe, build, offsets, total
