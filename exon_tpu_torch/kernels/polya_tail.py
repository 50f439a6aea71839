"""polya_tail: per row, the run of bytes of a byte class at one end, or at
both.

Replaces the scatter-max of exon_tpu/udfs.py ``trim_polya`` (:131-142) and
the scatter-min/max of exon_tpu/ops/sqlfuncs.py ``_trim_counts`` (:178).
Kernel source: ``csrc/polya_tail.cu`` (the class test in
``csrc/byteclass.cuh``).

``polya_tail(offsets, values, members=b"Aa", end="end")`` takes int32
offsets ``[n+1]``, uint8 values and the class as bytes or a collection of
byte values, and returns int32 ``[n]``. With ``end="end"`` (the default):
the position after each row's last byte outside the class, 0 for an empty
row or one of class bytes only (``trim_polya``'s kept length with the
default class). With ``"start"``: the number of class bytes before the
row's first other byte, the whole length for a row of class bytes only.
With ``"both"``: the pair (the start's, the end's) in one launch. Validity
is not read.
"""

from __future__ import annotations

import torch

from . import _build
from .count_bytes import class_key, class_params, class_table

launches = 0

POLY_A = b"Aa"
MODES = {"end": 0, "start": 1, "both": 2}  # the kernel's mode for each end


def _mode(end: str) -> int:
    if end not in MODES:
        raise ValueError(f"polya_tail: end must be one of {sorted(MODES)}, "
                         f"got {end!r}")
    return MODES[end]


def polya_tail_plain(offsets: torch.Tensor, values: torch.Tensor,
                     members=POLY_A, end: str = "end"):
    """The plain PyTorch twin: per byte its row and its position in the
    row, and the per-row minimum (from the start) or maximum (from the end)
    position of a byte outside the class; "both" gives the pair."""
    _mode(end)
    dev = offsets.device
    n = offsets.shape[0] - 1
    off = offsets.long()
    lens = off[1:] - off[:-1]
    rid = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    rank = torch.arange(rid.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    byte = values[off[:-1][rid] + rank]
    inside = class_table(class_key(members), dev)[byte.long()].bool()
    lead = keep = None
    if end != "end":
        lead = lens.clone()
        lead.scatter_reduce_(0, rid, torch.where(inside, lens[rid], rank),
                             "amin")
        lead = lead.to(torch.int32)
    if end != "start":
        keep = torch.full((n,), -1, dtype=torch.int64, device=dev)
        keep.scatter_reduce_(0, rid, torch.where(inside, -1, rank), "amax")
        keep = (keep + 1).to(torch.int32)
    if end == "both":
        return lead, keep
    return lead if end == "start" else keep


def polya_tail(offsets: torch.Tensor, values: torch.Tensor, members=POLY_A,
               end: str = "end"):
    global launches
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError("polya_tail needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    if offsets.device != values.device:
        raise ValueError("polya_tail: tensors on different devices")
    mode = _mode(end)
    if not _build.on_cuda(offsets, "polya_tail"):
        return polya_tail_plain(offsets, values, members, end)
    offsets, values = (t if t.is_contiguous() else t.contiguous()
                       for t in (offsets, values))
    n = offsets.shape[0] - 1
    both = end == "both"
    out = torch.empty(2 * n if both else n, dtype=torch.int32,
                      device=offsets.device)
    if n > 0:
        words, k = class_params(class_key(members))
        p = out.data_ptr()
        _build.check(_build.library().exon_polya_tail(
            values.data_ptr(), values.shape[0], offsets.data_ptr(), n,
            words.ctypes.data, k, mode, p, p + 4 * n if both else p,
            _build.stream_of(values)), "polya_tail")
        launches += 1
    return (out[:n], out[n:]) if both else out
