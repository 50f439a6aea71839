"""row_hash: 64-bit content hash of every row of a var-width column.

Replaces exon_tpu/plan/physical.py ``_hash_var`` (:831). Kernel source:
``csrc/row_hash.cu``. ``row_hash(offsets, values)`` returns int64 ``[n]``,
bit for bit ``_hash_bytes_host`` (:819) of each row: the polynomial
``h = h * P + byte + 1`` mod 2^64 in Horner form, plus ``len * SALT``, then
the splitmix64 finalizer, read as signed int64.

The twin computes in int64, whose multiply and add wrap like uint64; CPU
torch has no uint64 ``+``/``>>``, so each logical right shift is an
arithmetic shift with the sign-extended bits masked off.

On the card a thread takes a row and runs the chain a byte a step;
``row_hash.cu``'s head says why, and which redesigns lost to it. The
wrapper checks both tensors at once and allocates the output alone.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

FNV_PRIME = 1099511628211          # 2^40 + 2^8 + 0xb3
HASH_SALT = 0x9E3779B97F4A7C15
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB


def _i64(c: int) -> int:
    """A uint64 constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= (1 << 63) else c


def _srl(h: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (h >> k) & ((1 << (64 - k)) - 1)


def row_hash_plain(offsets: torch.Tensor, values: torch.Tensor
                   ) -> torch.Tensor:
    """The plain PyTorch twin."""
    off = offsets.to(torch.int64)
    starts, lens = off[:-1], off[1:] - off[:-1]
    h = torch.zeros(lens.shape[0], dtype=torch.int64, device=offsets.device)
    maxlen = int(lens.max()) if lens.numel() else 0
    last = max(values.shape[0] - 1, 0)
    for j in range(maxlen):
        b = values[(starts + j).clamp(max=last)].to(torch.int64)
        h = torch.where(j < lens, h * FNV_PRIME + b + 1, h)
    h = h + lens * _i64(HASH_SALT)
    h = h + _i64(_GOLDEN)  # splitmix64 finalizer from here on
    h = (h ^ _srl(h, 30)) * _i64(_MIX1)
    h = (h ^ _srl(h, 27)) * _i64(_MIX2)
    return h ^ _srl(h, 31)


def row_hash(offsets: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    global launches
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or \
            values.dtype != torch.uint8 or values.dim() != 1:
        raise TypeError(f"row_hash: offsets must be 1-d int32 and values "
                        f"1-d uint8, got {offsets.dtype} "
                        f"{tuple(offsets.shape)} and {values.dtype} "
                        f"{tuple(values.shape)}")
    if values.device != offsets.device:
        raise ValueError("row_hash: tensors on different devices")
    if not _build.on_cuda(offsets, "row_hash"):
        return row_hash_plain(offsets, values)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.int64, device=offsets.device)
    if n == 0:
        return out
    _build.check(_build.library().exon_row_hash(
        offsets.data_ptr(), values.data_ptr(), n, out.data_ptr(),
        _build.stream_of(offsets)), "row_hash")
    launches += 1
    return out
