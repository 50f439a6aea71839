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

Bytes outside every row are 0. Every mode is one launch a call that
writes every byte of the output, since the rows' bytes are exactly
[offsets[0], offsets[n]): table mode is a flat pass over that range, the
mirror mode a group of 8 lanes a row over its 16-byte words, the
word-start mode a flat pass over 16-byte words that marks each tile's row
starts once; each kernel writes the zeros outside the range itself.

Two more modes are K11b's byte-to-list maps (exon_tpu/udfs.py
``integer_encode_dna`` :106, ``integer_encoding`` :340,
``quality_score_string_to_list`` :115, ``_list_to_string`` :122, and the
FASTA encodings of exon_tpu/formats/fasta_device.py:99-104). The offsets are
unchanged, so they take the flat values alone:

- ``map_bytes_widen(values, table, out_dtype)``: uint8 values through an
  int64 table [256], stored as int8 or int64;
- ``map_bytes_narrow(values)``: int64 values to the uint8 bytes
  ``(int32(x) + 33) & 0xFF``, wrapping as the JAX casts do.
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
    if offsets.dim() != 1 or offsets.shape[0] == 0:
        raise ValueError("map_bytes: offsets need n + 1 >= 1 entries")
    offsets, values = offsets.contiguous(), values.contiguous()
    table = table.contiguous()
    # one launch in every mode: the kernel writes every byte, zeros outside
    # the rows
    out = torch.empty(values.shape[0], dtype=torch.uint8, device=values.device)
    if values.shape[0] == 0:
        return out
    _build.check(_build.library().exon_map_bytes(
        values.data_ptr(), values.shape[0], offsets.data_ptr(),
        offsets.shape[0] - 1, table.data_ptr(), MODES[mode], out.data_ptr(),
        _build.stream_of(values)), "map_bytes")
    launches += 1
    return out


_WIDTHS = {torch.int8: 1, torch.int64: 8}


def map_bytes_widen_plain(values: torch.Tensor, table: torch.Tensor,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch twin: an index_select through the table."""
    return table.index_select(0, values.long()).to(out_dtype)


def map_bytes_widen(values: torch.Tensor, table: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    if values.dtype != torch.uint8 or values.dim() != 1:
        raise TypeError(f"map_bytes_widen needs 1-d uint8 values, got "
                        f"{values.dtype} {tuple(values.shape)}")
    if table.dtype != torch.int64 or table.shape != (256,):
        raise TypeError("map_bytes_widen: the table must be int64 [256]")
    if out_dtype not in _WIDTHS:
        raise TypeError(f"map_bytes_widen: out_dtype must be int8 or int64, "
                        f"got {out_dtype}")
    if values.device != table.device:
        raise ValueError("map_bytes_widen: tensors on different devices")
    if not _build.on_cuda(values, "map_bytes_widen"):
        return map_bytes_widen_plain(values, table, out_dtype)
    values, table = values.contiguous(), table.contiguous()
    out = torch.empty(values.shape[0], dtype=out_dtype, device=values.device)
    if values.shape[0] == 0:
        return out
    _build.check(_build.library().exon_map_bytes_widen(
        values.data_ptr(), values.shape[0], table.data_ptr(),
        _WIDTHS[out_dtype], out.data_ptr(), _build.stream_of(values)),
        "map_bytes_widen")
    launches += 1
    return out


def map_bytes_narrow_plain(values: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin: the JAX casts, int64 to int32 to uint8."""
    return ((values.to(torch.int32) + 33) & 0xFF).to(torch.uint8)


def map_bytes_narrow(values: torch.Tensor) -> torch.Tensor:
    global launches
    if values.dtype != torch.int64 or values.dim() != 1:
        raise TypeError(f"map_bytes_narrow needs 1-d int64 values, got "
                        f"{values.dtype} {tuple(values.shape)}")
    if not _build.on_cuda(values, "map_bytes_narrow"):
        return map_bytes_narrow_plain(values)
    values = values.contiguous()
    out = torch.empty(values.shape[0], dtype=torch.uint8,
                      device=values.device)
    if values.shape[0] == 0:
        return out
    _build.check(_build.library().exon_map_bytes_narrow(
        values.data_ptr(), values.shape[0], out.data_ptr(),
        _build.stream_of(values)), "map_bytes_narrow")
    launches += 1
    return out
