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

On the card one launch writes the whole matrix, row 0 included, for up to
``MAX_KEYS`` keys (a call with more takes a launch for each ``MAX_KEYS``).
The keys go by value in the launch's parameters, from a ctypes table the
module fills in place; nothing is uploaded and nothing syncs.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Union

import torch

from . import _build

launches = 0

_SIGN = -(1 << 63)
# value kinds of csrc/sort_keys.cu; other dtypes are widened to int64 first
_KIND = {torch.int64: 0, torch.int32: 1, torch.float64: 2, torch.float32: 3,
         torch.uint8: 4, torch.bool: 4, torch.int16: 5, torch.int8: 6}


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


# at most this many keys go in one launch's parameters
# (csrc/sort_keys.cu kMaxKeys); a call with more takes more launches
MAX_KEYS = 16
_VAR = 7
# a key's 56 bytes in csrc/sort_keys.cu's SortKey, as 7 int64 slots: the
# offsets, values and validity pointers, the values' bytes, kind | nchunks
# << 32, asc | nulls mode << 32, the key's first row of the matrix
KEY_SLOTS = 7
# the key table of a launch, filled in place for every call under
# _table_lock
_TABLE = (ctypes.c_int64 * (KEY_SLOTS * MAX_KEYS))()
_table_lock = threading.Lock()


def _checked(key: Key, n: int, device: int) -> tuple:
    """(offsets or None, values, validity, kind) of ``key``, contiguous,
    after checking their types, shapes and device (``get_device()``'s
    number); a fixed key's values of a type the kernel does not take are
    widened to int64."""
    valid = key.validity
    if isinstance(key, VarKey):
        offs, vals = key.offsets, key.values
        bad = (offs.dtype != torch.int32 or offs.shape != (n + 1,)
               or vals.dtype != torch.uint8 or vals.dim() != 1)
        want = f"int32 offsets [{n + 1}] and 1-d uint8 values"
    else:
        offs, vals = None, key.values
        bad = vals.shape != (n,)
        want = f"values [{n}]"
    if bad or valid.dtype != torch.bool or valid.shape != (n,):
        got = [(t.dtype, tuple(t.shape)) for t in (offs, vals, valid)
               if t is not None]
        raise TypeError(f"sort_keys: a key needs {want} and bool validity "
                        f"[{n}], got {got}")
    if vals.get_device() != device or valid.get_device() != device or \
            (offs is not None and offs.get_device() != device):
        raise ValueError("sort_keys: tensors on different devices")
    if offs is not None:
        return offs.contiguous(), vals.contiguous(), valid.contiguous(), _VAR
    if vals.dtype not in _KIND:
        vals = vals.to(torch.int64)
    return None, vals.contiguous(), valid.contiguous(), _KIND[vals.dtype]


def sort_keys(specs: list, n: int, device) -> torch.Tensor:
    global launches
    # the keys' own device: torch.device("cuda") != its tensors' "cuda:0"
    device = specs[0].validity.device if specs else torch.device(device)
    if not (_build.on_cuda(specs[0].validity, "sort_keys") if specs
            else device.type == "cuda"):
        for key in specs:
            _checked(key, n, -1)
        return sort_keys_plain(specs, n, device)
    out = torch.empty((1 + sum(k.rows for k in specs), n), dtype=torch.int64,
                      device=device)
    index = out.get_device()
    lib = _build.library()
    stream = _build.stream_of(out)
    row = 1
    with _table_lock:
        # no keys: one launch writes row 0
        for first in range(0, max(len(specs), 1), MAX_KEYS):
            group = specs[first:first + MAX_KEYS]
            keep, slots = [], []  # the tensors the launch reads, its table
            for key in group:
                offs, vals, valid, kind = _checked(key, n, index)
                keep.append((offs, vals, valid))
                nchunks = 0 if offs is None else key.nchunks
                slots += [0 if offs is None else offs.data_ptr(),
                          vals.data_ptr(), valid.data_ptr(), vals.shape[0],
                          kind | nchunks << 32,
                          int(key.asc) | _nulls_mode(key.nulls_first) << 32,
                          row]
                row += key.rows
            _TABLE[:len(slots)] = slots
            _build.check(lib.exon_sort_keys(_TABLE, len(group), n,
                                            int(first == 0), out.data_ptr(),
                                            stream), "sort_keys")
            if n:
                launches += 1
    return out
