"""map_bytes: each byte of a var-width column through a byte table, the
offsets unchanged.

Replaces exon_tpu/udfs.py ``reverse_complement`` (:87: the mirror index and
the ``_COMPLEMENT`` gather), the folds of ops/strings.py ``upper``/``lower``
(:44, :48) and exon_tpu/ops/sqlfuncs.py ``fn_initcap`` (:487). Kernel
source: ``csrc/map_bytes.cu``.

``map_bytes(offsets, values, table, mode)`` takes int32 offsets ``[n+1]``,
uint8 values and a uint8 table on the same device, and returns uint8 values
of the same size. ``mode`` is the kernel's:

- ``"table"``: byte k of row r is ``table[row r's byte k]`` (table [256]);
- ``"mirror"``: it is ``table[row r's byte len - 1 - k]`` (table [256]);
- ``"word_start"``: it is ``table[256 + byte]`` at a word start (the row's
  first byte, or one after a byte that is not ASCII alphanumeric) and
  ``table[byte]`` elsewhere (table [512]).

Bytes outside every row are 0.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0


MODES = {"table": 0, "mirror": 1, "word_start": 2}  # the kernel's modes


def _is_alnum(x: torch.Tensor) -> torch.Tensor:
    return ((x >= ord("0")) & (x <= ord("9"))) | \
        ((x >= ord("A")) & (x <= ord("Z"))) | ((x >= ord("a")) & (x <= ord("z")))


def map_bytes_plain(offsets: torch.Tensor, values: torch.Tensor,
                    table: torch.Tensor, mode: str) -> torch.Tensor:
    """The plain PyTorch twin: a per-byte row id, the mirrored position
    start + (end - 1 - pos), and a gather through the table; in word-start
    mode the byte before each one decides which half of the table it goes
    through."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    off = offsets.long()
    lens = off[1:] - off[:-1]
    starts = torch.repeat_interleave(off[:-1], lens)
    ends = torch.repeat_interleave(off[1:], lens)
    rank = torch.arange(starts.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    pos = starts + rank
    src = starts + (ends - 1 - pos) if mode == "mirror" else pos
    out = torch.zeros_like(values)
    if n == 0:
        return out
    byte = values[src].long()
    if mode != "word_start":
        out[pos] = table[byte]
        return out
    prev = values[(pos - 1).clamp(min=0)]
    at_start = (pos == starts) | ~_is_alnum(prev)
    out[pos] = table[torch.where(at_start, byte + 256, byte)]
    return out


def map_bytes(offsets: torch.Tensor, values: torch.Tensor,
              table: torch.Tensor, mode: str) -> torch.Tensor:
    global launches
    if mode not in MODES:
        raise ValueError(f"map_bytes: mode must be one of {list(MODES)}, "
                         f"got {mode!r}")
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError("map_bytes needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    entries = 512 if mode == "word_start" else 256
    if table.dtype != torch.uint8 or table.shape != (entries,):
        raise TypeError(f"map_bytes: the {mode} table must be uint8 "
                        f"[{entries}]")
    if not (offsets.device == values.device == table.device):
        raise ValueError("map_bytes: tensors on different devices")
    if not _build.on_cuda(offsets, "map_bytes"):
        return map_bytes_plain(offsets, values, table, mode)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.zeros_like(values)
    if n == 0 or values.shape[0] == 0:
        return out
    table = table.contiguous()
    _build.check(_build.library().exon_map_bytes(
        values.data_ptr(), offsets.data_ptr(), n, table.data_ptr(),
        MODES[mode], out.data_ptr(), _build.stream_of(values)), "map_bytes")
    launches += 1
    return out
