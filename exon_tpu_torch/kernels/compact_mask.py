"""compact_mask: stable compaction of a bool mask into row indices.

Replaces exon_tpu/ops/layout.py ``mask_to_indices`` (:75). Kernel source:
``csrc/compact_mask.cu``. Returns ``(indices int32[n], count)``: the first
``count`` entries are the selected row numbers in ascending order, the rest
hold ``n`` (the JAX function's out-of-range fill), and ``count`` is a 0-d
int32 tensor on the mask's device.

A call is one launch, a single pass with a look-back in the status words
of ``_lookback``, which keeps them per (device, stream).
"""

from __future__ import annotations

import torch

from . import _build, _lookback

launches = 0

_TILE = 4096  # kTile in csrc/compact_mask.cu
_INT32_LIMIT = 1 << 31


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

    def one_pass(status, ticket, base, epoch):
        _build.check(_build.library().exon_compact_mask(
            mask.data_ptr(), n, status, ticket, base, epoch, both.data_ptr(),
            both.data_ptr() + 4 * n, stream), "compact_mask")

    _lookback.scan(mask.device, stream, tiles, tiles, one_pass)
    launches += 1
    return both[:n], both[n]
