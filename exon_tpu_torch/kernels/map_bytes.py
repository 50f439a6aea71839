"""map_bytes: each byte of a var-width column through a 256-entry table,
each row optionally mirrored, the offsets unchanged.

Replaces exon_tpu/udfs.py ``reverse_complement`` (:87: the mirror index and
the ``_COMPLEMENT`` gather). Kernel source: ``csrc/map_bytes.cu``.

``map_bytes(offsets, values, table, mirror)`` takes int32 offsets
``[n+1]``, uint8 values and a uint8 ``[256]`` table on the same device, and
returns uint8 values of the same size: byte k of row r is
``table[row r's byte k]``, or ``table[row r's byte len - 1 - k]`` with
``mirror``. Bytes outside every row are 0.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0


def map_bytes_plain(offsets: torch.Tensor, values: torch.Tensor,
                    table: torch.Tensor, mirror: bool) -> torch.Tensor:
    """The plain PyTorch twin: a per-byte row id, the mirrored position
    start + (end - 1 - pos), and a gather through the table."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    off = offsets.long()
    lens = off[1:] - off[:-1]
    starts = torch.repeat_interleave(off[:-1], lens)
    ends = torch.repeat_interleave(off[1:], lens)
    rank = torch.arange(starts.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    pos = starts + rank
    src = starts + (ends - 1 - pos) if mirror else pos
    out = torch.zeros_like(values)
    if n:
        out[pos] = table[values[src].long()]
    return out


def map_bytes(offsets: torch.Tensor, values: torch.Tensor,
              table: torch.Tensor, mirror: bool) -> torch.Tensor:
    global launches
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError("map_bytes needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    if table.dtype != torch.uint8 or table.shape != (256,):
        raise TypeError("map_bytes: the table must be uint8 [256]")
    if not (offsets.device == values.device == table.device):
        raise ValueError("map_bytes: tensors on different devices")
    if not _build.on_cuda(offsets, "map_bytes"):
        return map_bytes_plain(offsets, values, table, mirror)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.zeros_like(values)
    if n == 0 or values.shape[0] == 0:
        return out
    _build.check(_build.library().exon_map_bytes(
        values.data_ptr(), offsets.data_ptr(), n, table.contiguous().data_ptr(),
        int(mirror), out.data_ptr(), _build.stream_of(values)), "map_bytes")
    launches += 1
    return out
