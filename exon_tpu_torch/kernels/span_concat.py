"""span_concat: output rows assembled from pieces of byte spans.

Replaces the per-row assembly of exon_tpu/ops/sqlfuncs.py: ``_concat_cols``
(:268) for ``concat``, ``||`` and ``concat_ws`` (:325-363), the string
branch of ``fn_coalesce`` (:779), ``_pad`` (:387) and ``fn_repeat`` (:366).
Kernel source: ``csrc/span_concat.cu``.

``span_concat(sources, pieces)`` takes a list of uint8 source buffers and a
list of pieces ``(source index, start, span, length)``, each of the last
three an int32 ``[n]`` tensor, and returns ``(offsets int32 [n+1], values
uint8)``: output row r is its pieces in order, byte i of piece p being
``sources[p's source][start[r] + i % span[r]]`` for ``i < length[r]`` (a
span at least as long as the piece is a plain copy, a shorter one repeats;
the span must be positive wherever the length is). The offsets are
``torch.cumsum`` of the summed lengths, with one host read of the total; a
total past 2^31 - 1 bytes raises ExecutionError, as int32 offsets cannot
address it.
"""

from __future__ import annotations

import torch

from ..errors import ExecutionError
from . import _build

launches = 0

_INT32_LIMIT = 1 << 31


def _offsets(pieces: list, n: int, device) -> tuple[torch.Tensor, int]:
    """Each row's offsets from its pieces' lengths, and the byte total."""
    out = torch.zeros(n + 1, dtype=torch.int64, device=device)
    if pieces:
        lens = torch.stack([p[3] for p in pieces]).to(torch.int64)
        torch.cumsum(lens.clamp(min=0).sum(0), 0, out=out[1:])
    total = int(out[-1])
    if total >= _INT32_LIMIT:
        raise ExecutionError(f"a string function's result holds {total} "
                             "bytes; int32 offsets address fewer than 2^31")
    return out.to(torch.int32), total


def span_concat_plain(sources: list, pieces: list) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
    """The plain PyTorch twin: the same offsets, then per piece a per-byte
    row id and rank, each byte written at its row's running position."""
    dev = pieces[0][1].device
    n = pieces[0][1].shape[0]
    offsets, total = _offsets(pieces, n, dev)
    out = torch.zeros(total, dtype=torch.uint8, device=dev)
    base = offsets[:-1].to(torch.int64)
    for src, start, span, length in pieces:
        ln = length.to(torch.int64).clamp(min=0)
        rid = torch.repeat_interleave(torch.arange(n, device=dev), ln)
        i = torch.arange(rid.shape[0], device=dev) - \
            (torch.cumsum(ln, 0) - ln)[rid]
        w = span.to(torch.int64).clamp(min=1)[rid]
        out[base[rid] + i] = sources[src][start.to(torch.int64)[rid] + i % w]
        base = base + ln
    return offsets, out


def span_concat(sources: list, pieces: list) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    global launches
    if not pieces:
        raise ValueError("span_concat needs at least one piece")
    dev = pieces[0][1].device
    n = pieces[0][1].shape[0]
    for s in sources:
        if s.dtype != torch.uint8 or s.dim() != 1:
            raise TypeError(f"span_concat: a source must be 1-d uint8, got "
                            f"{s.dtype} {tuple(s.shape)}")
        if s.device != dev:
            raise ValueError("span_concat: tensors on different devices")
    for src, *parts in pieces:
        if not 0 <= src < len(sources):
            raise ValueError(f"span_concat: no source {src}")
        for t in parts:
            if t.dtype != torch.int32 or t.shape != (n,):
                raise TypeError("span_concat: a piece's start, span and "
                                f"length must be int32 [{n}]")
            if t.device != dev:
                raise ValueError("span_concat: tensors on different devices")
    if not _build.on_cuda(pieces[0][1], "span_concat"):
        return span_concat_plain(sources, pieces)
    offsets, total = _offsets(pieces, n, dev)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    if n == 0 or total == 0:
        return offsets, out
    sources = [s.contiguous() for s in sources]
    ptrs = torch.tensor([s.data_ptr() for s in sources],
                        dtype=torch.int64).to(dev)
    which = torch.tensor([p[0] for p in pieces], dtype=torch.int32).to(dev)
    start, span, length = (torch.stack([p[k] for p in pieces]).contiguous()
                           for k in (1, 2, 3))
    _build.check(_build.library().exon_span_concat(
        ptrs.data_ptr(), which.data_ptr(), len(pieces), n, start.data_ptr(),
        span.data_ptr(), length.data_ptr(), offsets.data_ptr(),
        out.data_ptr(), _build.stream_of(out)), "span_concat")
    launches += 1
    return offsets, out
