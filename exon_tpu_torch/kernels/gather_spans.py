"""gather_spans: copy byte spans to their output offsets, dropping '\\r'.

Replaces exon_tpu/ops/device_text.py ``compact`` (:57) as the FASTA and
FASTQ device decoders use it (one keep-mask compaction of the whole chunk
per column). Kernel source: ``csrc/gather_spans.cu``.

``gather_spans(src, starts, stops, dst, total, drop)`` copies, for every
span r, the bytes of ``src[starts[r]:stops[r]]`` that are not in ``drop``
(no, one or two byte values) to ``out[dst[r]:]`` and returns ``out``, a
uint8 tensor of ``total`` bytes. ``starts``, ``stops`` and ``dst`` are int32
``[m]``; ``dst`` must be the exclusive scan of the spans' kept lengths.
``trim_polya`` copies its kept prefixes with no byte dropped.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

CR = 13
TILE = 1024  # output bytes a warp of the copy takes (kTileBytes)


def _drops(drop: tuple) -> tuple[int, int]:
    """The kernel's two drop arguments; -1 matches no byte."""
    if len(drop) > 2:
        raise ValueError(f"gather_spans drops at most two byte values, got "
                         f"{drop!r}")
    return (drop[0], drop[-1]) if drop else (-1, -1)


def gather_spans_plain(src: torch.Tensor, starts: torch.Tensor,
                       stops: torch.Tensor, dst: torch.Tensor, total: int,
                       drop: tuple = (CR,)) -> torch.Tensor:
    """The plain PyTorch twin: a per-byte span index, a keep mask, and each
    kept byte placed at its span's ``dst`` plus its rank in the span."""
    a, b = _drops(drop)
    dev, m = src.device, starts.shape[0]
    lens = (stops.long() - starts.long()).clamp(min=0)
    first = torch.cumsum(lens, 0) - lens
    row = torch.repeat_interleave(torch.arange(m, device=dev), lens)
    pos = torch.arange(row.shape[0], device=dev) - first[row] + \
        starts.long()[row]
    byte = src[pos].to(torch.int32)
    keep = (byte != a) & (byte != b)
    k = keep.long()
    rank = torch.cumsum(k, 0) - k
    dest = dst.long()[row] + rank - rank[first[row]]
    out = torch.zeros(total, dtype=torch.uint8, device=dev)
    out[dest[keep]] = byte[keep].to(torch.uint8)
    return out


def gather_spans(src: torch.Tensor, starts: torch.Tensor, stops: torch.Tensor,
                 dst: torch.Tensor, total: int,
                 drop: tuple = (CR,)) -> torch.Tensor:
    global launches
    if src.dtype != torch.uint8 or src.dim() != 1:
        raise TypeError(f"gather_spans: src must be 1-d uint8, got "
                        f"{src.dtype} {tuple(src.shape)}")
    for name, t in (("starts", starts), ("stops", stops), ("dst", dst)):
        if t.dtype != torch.int32 or t.dim() != 1 or \
                t.shape[0] != starts.shape[0]:
            raise TypeError(f"gather_spans: {name} must be 1-d int32 of one "
                            "length per span")
        if t.device != src.device:
            raise ValueError("gather_spans: tensors on different devices")
    a, b = _drops(drop)
    if not _build.on_cuda(src, "gather_spans"):
        return gather_spans_plain(src, starts, stops, dst, total, drop)
    src, starts, stops, dst = (src.contiguous(), starts.contiguous(),
                               stops.contiguous(), dst.contiguous())
    out = torch.empty(total, dtype=torch.uint8, device=src.device)
    m = starts.shape[0]
    if m == 0 or total == 0:
        return out
    if src.shape[0] >= 2**31 or total >= 2**31:
        raise ValueError("gather_spans: the kernel takes fewer than 2^31 "
                         "source and output bytes")
    # the span holding each tile's first byte, and the output's last byte's,
    # written by the first launch
    marks = torch.empty((total + TILE - 1) // TILE + 1, dtype=torch.int32,
                        device=src.device)
    _build.check(_build.library().exon_gather_spans(
        src.data_ptr(), src.shape[0], starts.data_ptr(), stops.data_ptr(),
        dst.data_ptr(), m, total, a, b, marks.data_ptr(), out.data_ptr(),
        _build.stream_of(src)), "gather_spans")
    launches += 1
    return out
