"""sort_keys: the int64 key matrix of an ORDER BY.

Replaces exon_tpu/plan/physical.py ``sort_key_columns`` (:1372) with its
``_to_sortable_i64`` (:1486), ``_invert_key`` (:1499) and the
``gather_prefix`` (exon_tpu/ops/layout.py:60) of var-width keys, which the
twin keeps as a function of its own. Kernel source: ``csrc/sort_keys.cu``.

``sort_keys(specs, n)`` returns int64 ``[C, n]`` whose column-lexicographic
order (row 0 most significant) is the sort order. Row 0 is the padding flag,
all zero because batches hold no padding rows. Each spec then adds rows:

  * ``FixedKey(values, validity, asc, nulls_first)``: a validity row and the
    order-preserving int64 of the value (floats by their IEEE bits);
  * ``VarKey(offsets, values, validity, nchunks, asc, nulls_first)``: a
    validity row and ``nchunks`` rows of 8 big-endian bytes (zero past the
    row's end) with the sign bit flipped, so signed order is byte order.

``nulls_first`` is None for the default placement (ASC: NULLs last, DESC:
first), else True/False. A DESC key's rows hold ``-1 - k``, except an
explicit NULLS FIRST/LAST validity row, whose placement is already final.
One launch writes each spec's rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from . import _build

launches = 0

_SIGN = -(1 << 63)
# value kinds of csrc/sort_keys.cu; other dtypes are widened to int64 first
_KIND = {torch.int64: 0, torch.int32: 1, torch.float64: 2, torch.float32: 3,
         torch.uint8: 4, torch.bool: 4}


@dataclasses.dataclass
class FixedKey:
    values: torch.Tensor
    validity: torch.Tensor
    asc: bool = True
    nulls_first: Optional[bool] = None

    @property
    def rows(self) -> int:
        return 2


@dataclasses.dataclass
class VarKey:
    offsets: torch.Tensor
    values: torch.Tensor
    validity: torch.Tensor
    nchunks: int
    asc: bool = True
    nulls_first: Optional[bool] = None

    @property
    def rows(self) -> int:
        return 1 + self.nchunks


Key = Union[FixedKey, VarKey]


def _nulls_mode(nulls_first: Optional[bool]) -> int:
    return 0 if nulls_first is None else (1 if nulls_first else 2)


def _validity_row(valid: torch.Tensor, asc: bool,
                  nulls_first: Optional[bool]) -> torch.Tensor:
    if nulls_first is None:
        vk = (~valid).to(torch.int64)
        return vk if asc else -1 - vk
    return valid.to(torch.int64) if nulls_first else (~valid).to(torch.int64)


def _sortable(values: torch.Tensor) -> torch.Tensor:
    if values.dtype.is_floating_point:
        bits = values.to(torch.float64).view(torch.int64)
        flipped = torch.where(bits < 0, ~bits, bits | _SIGN)
        return flipped ^ _SIGN
    return values.to(torch.int64)


def gather_prefix(offsets: torch.Tensor, values: torch.Tensor, k: int
                  ) -> torch.Tensor:
    """int64 [n, k]: the first k bytes of each row, zero past its end
    (exon_tpu/ops/layout.py ``gather_prefix``, :60)."""
    off = offsets.to(torch.int64)
    starts, lens = off[:-1], off[1:] - off[:-1]
    pos = torch.arange(k, device=off.device)
    idx = (starts[:, None] + pos[None, :]).clamp(max=max(values.shape[0] - 1,
                                                         0))
    byte = values[idx].to(torch.int64) if values.numel() else \
        torch.zeros_like(idx)
    return torch.where(pos[None, :] < lens[:, None], byte, 0)


def _chunks(key: VarKey) -> torch.Tensor:
    """[nchunks, n] big-endian 8-byte chunks of each row, sign-flipped."""
    pre = gather_prefix(key.offsets, key.values, 8 * key.nchunks)
    out = []
    for c in range(key.nchunks):
        k = torch.zeros(pre.shape[0], dtype=torch.int64, device=pre.device)
        for t in range(8 * c, 8 * c + 8):
            k = (k << 8) | pre[:, t]
        out.append(k ^ _SIGN)
    return torch.stack(out) if out else pre.new_zeros((0, pre.shape[0]))


def sort_keys_plain(specs: list, n: int, device) -> torch.Tensor:
    """The plain PyTorch twin."""
    rows = [torch.zeros((1, n), dtype=torch.int64, device=device)]
    for key in specs:
        rows.append(_validity_row(key.validity, key.asc,
                                  key.nulls_first)[None, :])
        vals = _chunks(key) if isinstance(key, VarKey) else \
            _sortable(key.values)[None, :]
        rows.append(vals if key.asc else -1 - vals)
    return torch.cat(rows)


def _check(key: Key, n: int, device) -> None:
    tensors = ([("validity", key.validity, torch.bool, n)]
               + ([("offsets", key.offsets, torch.int32, n + 1),
                   ("values", key.values, torch.uint8, None)]
                  if isinstance(key, VarKey) else
                  [("values", key.values, None, n)]))
    for name, t, dt, length in tensors:
        if (dt is not None and t.dtype != dt) or t.dim() != 1 or \
                (length is not None and t.shape[0] != length):
            raise TypeError(f"sort_keys: {name} must be 1-d "
                            f"{dt or 'numeric'} of {length} rows, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError("sort_keys: tensors on different devices")


def sort_keys(specs: list, n: int, device) -> torch.Tensor:
    global launches
    # the keys' own device: torch.device("cuda") != its tensors' "cuda:0"
    device = specs[0].validity.device if specs else torch.device(device)
    for key in specs:
        _check(key, n, device)
    if not _build.on_cuda(torch.empty(0, device=device), "sort_keys"):
        return sort_keys_plain(specs, n, device)
    total = 1 + sum(k.rows for k in specs)
    out = torch.empty((total, n), dtype=torch.int64, device=device)
    out[0].zero_()
    if n == 0:
        return out
    lib = _build.library()
    stream = _build.stream_of(out)
    row = 1
    for key in specs:
        mode = _nulls_mode(key.nulls_first)
        valid = key.validity.contiguous()
        if isinstance(key, VarKey):
            offs, vals = key.offsets.contiguous(), key.values.contiguous()
            status = lib.exon_sort_keys_var(
                offs.data_ptr(), vals.data_ptr(), valid.data_ptr(), n,
                key.nchunks, int(key.asc), mode, out[row].data_ptr(), stream)
        else:
            vals = key.values
            if vals.dtype not in _KIND:
                vals = vals.to(torch.int64)
            vals = vals.contiguous()
            status = lib.exon_sort_keys_fixed(
                vals.data_ptr(), _KIND[vals.dtype], valid.data_ptr(), n,
                int(key.asc), mode, out[row].data_ptr(), stream)
        _build.check(status, "sort_keys")
        launches += 1
        row += key.rows
    return out
