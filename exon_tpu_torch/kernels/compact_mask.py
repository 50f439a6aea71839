"""compact_mask: stable compaction of a bool mask into row indices.

Replaces exon_tpu/ops/layout.py ``mask_to_indices`` (:75). Kernel source:
``csrc/compact_mask.cu``. Returns ``(indices int32[n], count)``: the first
``count`` entries are the selected row numbers in ascending order, the rest
hold ``n`` (the JAX function's out-of-range fill), and ``count`` is a 0-d
int32 tensor on the mask's device.

A call is one launch. The kernel's look-back reads the status words of a
workspace that this module keeps per (device, stream): the words, the
ticket counter, the number of tiles launched on them so far and the number
of the last call (the epoch). Calls on one stream run in order, so each
finds the words of the calls before it finished.
"""

from __future__ import annotations

import threading

import torch

from . import _build

launches = 0

_TILE = 4096  # kTile in csrc/compact_mask.cu
_INT32_LIMIT = 1 << 31
_EPOCH_LIMIT = (1 << 31) - 1  # the status word's 31 epoch bits


class _Workspace:
    """Status words [capacity] and the ticket counter after them, in one
    int64 tensor."""

    def __init__(self, tiles: int, device: torch.device):
        self.capacity = tiles
        self.words = torch.zeros(tiles + 1, dtype=torch.int64, device=device)
        self.status = self.words.data_ptr()
        self.ticket = self.status + 8 * tiles
        self.tickets = 0  # tiles launched on the words so far
        self.epoch = 0


_workspaces: dict = {}
_lock = threading.Lock()


def _workspace(device: torch.device, stream: int, tiles: int) -> _Workspace:
    key = (device.index, stream)
    ws = _workspaces.get(key)
    if ws is None or ws.capacity < tiles:
        grown = tiles if ws is None else max(tiles, 2 * ws.capacity)
        ws = _workspaces[key] = _Workspace(grown, device)
    if ws.epoch == _EPOCH_LIMIT:
        ws.words.zero_()
        ws.epoch = 0
    return ws


def compact_mask_plain(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin."""
    n = mask.shape[0]
    idx = torch.nonzero(mask).flatten().to(torch.int32)
    out = torch.full((n,), n, dtype=torch.int32, device=mask.device)
    out[: idx.shape[0]] = idx
    return out, torch.tensor(idx.shape[0], dtype=torch.int32,
                             device=mask.device)


def compact_mask(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError(f"compact_mask needs a 1-d bool mask, got "
                        f"{mask.dtype} {tuple(mask.shape)}")
    n = mask.shape[0]
    if n >= _INT32_LIMIT:
        raise ValueError(f"compact_mask: {n} rows exceed int32 indices")
    if not _build.on_cuda(mask, "compact_mask"):
        return compact_mask_plain(mask)
    mask = mask.contiguous()
    if n == 0:
        both = torch.zeros(1, dtype=torch.int32, device=mask.device)
        return both[:0], both[0]
    # the indices and the count in one allocation
    both = torch.empty(n + 1, dtype=torch.int32, device=mask.device)
    stream = _build.stream_of(mask)
    tiles = (n + _TILE - 1) // _TILE
    with _lock:
        ws = _workspace(mask.device, stream, tiles)
        ws.epoch += 1
        _build.check(_build.library().exon_compact_mask(
            mask.data_ptr(), n, ws.status, ws.ticket, ws.tickets, ws.epoch,
            both.data_ptr(), both.data_ptr() + 4 * n, stream), "compact_mask")
        ws.tickets += tiles
    launches += 1
    return both[:n], both[n]
