"""polya_tail: per row, the length left once its trailing run of 'A'/'a'
is stripped.

Replaces the scatter-max of exon_tpu/udfs.py ``trim_polya`` (:131-142).
Kernel source: ``csrc/polya_tail.cu``.

``polya_tail(offsets, values)`` takes int32 offsets ``[n+1]`` and uint8
values and returns int32 ``[n]``: the position after each row's last byte
that is not 'A' or 'a', 0 for an empty or all-A row.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

A, LOWER_A = ord("A"), ord("a")


def polya_tail_plain(offsets: torch.Tensor, values: torch.Tensor
                     ) -> torch.Tensor:
    """The plain PyTorch twin: per byte its row and its position in the
    row, -1 for an A, and the per-row maximum plus one."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    off = offsets.long()
    lens = off[1:] - off[:-1]
    rid = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    rank = torch.arange(rid.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    byte = values[off[:-1][rid] + rank]
    last = torch.where((byte == A) | (byte == LOWER_A), -1, rank)
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out.scatter_reduce_(0, rid, last, "amax")
    return (out + 1).to(torch.int32)


def polya_tail(offsets: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    global launches
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError("polya_tail needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    if offsets.device != values.device:
        raise ValueError("polya_tail: tensors on different devices")
    if not _build.on_cuda(offsets, "polya_tail"):
        return polya_tail_plain(offsets, values)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.int32, device=offsets.device)
    if n == 0:
        return out
    _build.check(_build.library().exon_polya_tail(
        values.data_ptr(), offsets.data_ptr(), n, out.data_ptr(),
        _build.stream_of(values)), "polya_tail")
    launches += 1
    return out
