"""polya_tail: per row, the run of bytes of a byte class at one end.

Replaces the scatter-max of exon_tpu/udfs.py ``trim_polya`` (:131-142) and
the scatter-min/max of exon_tpu/ops/sqlfuncs.py ``_trim_counts`` (:178).
Kernel source: ``csrc/polya_tail.cu``.

``polya_tail(offsets, values, members=b"Aa", from_start=False)`` takes int32
offsets ``[n+1]``, uint8 values and the class as a collection of byte
values, and returns int32 ``[n]``. From the end (the default): the position
after each row's last byte outside the class, 0 for an empty row or one of
class bytes only (``trim_polya``'s kept length with the default class).
From the start: the number of class bytes before the row's first other
byte, the whole length for a row of class bytes only. Validity is not read.
"""

from __future__ import annotations

import torch

from . import _build
from .count_bytes import class_words

launches = 0

POLY_A = b"Aa"


def polya_tail_plain(offsets: torch.Tensor, values: torch.Tensor,
                     members=POLY_A, from_start: bool = False
                     ) -> torch.Tensor:
    """The plain PyTorch twin: per byte its row and its position in the
    row, and the per-row minimum (from the start) or maximum (from the end)
    position of a byte outside the class."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    off = offsets.long()
    lens = off[1:] - off[:-1]
    rid = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    rank = torch.arange(rid.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    byte = values[off[:-1][rid] + rank]
    table = torch.zeros(256, dtype=torch.bool, device=dev)
    table[list(set(members))] = True
    inside = table[byte.long()]
    if from_start:
        out = lens.clone()
        out.scatter_reduce_(0, rid, torch.where(inside, lens[rid], rank),
                            "amin")
        return out.to(torch.int32)
    out = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out.scatter_reduce_(0, rid, torch.where(inside, -1, rank), "amax")
    return (out + 1).to(torch.int32)


def polya_tail(offsets: torch.Tensor, values: torch.Tensor, members=POLY_A,
               from_start: bool = False) -> torch.Tensor:
    global launches
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError("polya_tail needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    if offsets.device != values.device:
        raise ValueError("polya_tail: tensors on different devices")
    if not _build.on_cuda(offsets, "polya_tail"):
        return polya_tail_plain(offsets, values, members, from_start)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.int32, device=offsets.device)
    if n == 0:
        return out
    _build.check(_build.library().exon_polya_tail(
        values.data_ptr(), offsets.data_ptr(), n, *class_words(members),
        int(from_start), out.data_ptr(), _build.stream_of(values)),
        "polya_tail")
    launches += 1
    return out
