"""Columnar record batches on torch tensors.

Counterpart of exon_tpu/batch.py:59-130 (columns) and its ``Batch``. The
layout is the same Arrow-style one:

  * ``FixedColumn``  — values ``[n]`` + validity ``[n]``
  * ``VarColumn``    — flat uint8 ``values [nbytes]`` + int32 ``offsets [n+1]``
  * ``DictColumn``   — int32 codes + a host vocabulary tuple

Differences from the JAX package: there is no jit, so there are no pytrees
and no power-of-two capacity buckets. A batch holds exactly ``length`` rows
and its var-width columns exactly their bytes; ``capacity``, ``length`` and
``row_mask()`` are kept so that ported operator code reads line for line.

A batch is either on the host (numpy arrays, as the decoders emit it) or on
a torch device (``to_device``/``to_host`` move it). pyarrow is imported only
inside ``to_arrow``/``from_arrow``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from .datatypes import DataType, Field, Schema, TypeKind, numpy_dtype
from .errors import ExecutionError

_INT32_LIMIT = 1 << 31


@dataclasses.dataclass
class FixedColumn:
    """Fixed-width primitive column. values[n]; validity[n] (True=valid)."""

    values: Any
    validity: Any

    @property
    def capacity(self) -> int:
        return self.values.shape[0]


@dataclasses.dataclass
class VarColumn:
    """Variable-length column: row i spans values[offsets[i]:offsets[i+1]]."""

    values: Any   # uint8 [nbytes]
    offsets: Any  # int32 [n + 1]
    validity: Any  # bool [n]

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    @property
    def value_capacity(self) -> int:
        return self.values.shape[0]


@dataclasses.dataclass
class DictColumn:
    """Dictionary-encoded utf8: int32 codes + a host vocabulary."""

    codes: Any
    validity: Any
    vocab: tuple = ()

    @property
    def capacity(self) -> int:
        return self.codes.shape[0]


Column = Union[FixedColumn, VarColumn, DictColumn]


@dataclasses.dataclass
class Batch:
    """A record batch of exactly ``length`` rows, on the host or a device."""

    schema: Schema
    columns: list
    length: int
    # the device of a batch with no columns (a scan projected to none), so
    # that the literals evaluated over it land there too
    home: Optional[torch.device] = None

    @property
    def capacity(self) -> int:
        if not self.columns:
            return self.length
        return self.columns[0].capacity

    @property
    def device(self) -> Optional[torch.device]:
        """The torch device of the columns; None for a host (numpy) batch."""
        for c in self.columns:
            v = c.codes if isinstance(c, DictColumn) else c.validity
            if isinstance(v, torch.Tensor):
                return v.device
        return self.home

    def column(self, name: str) -> Column:
        return self.columns[self.schema.index_of(name)]

    def row_mask(self) -> torch.Tensor:
        """bool[cap]: True for live rows (all of them: batches are exact)."""
        return torch.ones(self.capacity, dtype=torch.bool, device=self.device)

    def project(self, names: list[str]) -> "Batch":
        cols = [self.column(n) for n in names]
        return Batch(self.schema.project(names), cols, self.length,
                     self.device)

    # -- host <-> device ----------------------------------------------------

    def to_device(self, device) -> "Batch":
        device = torch.device(device)
        return Batch(self.schema,
                     [_map_arrays(c, lambda a: _to_tensor(a, device))
                      for c in self.columns], self.length, device)

    def to_host(self) -> "Batch":
        return Batch(self.schema, [_map_arrays(c, _to_numpy)
                                   for c in self.columns], self.length)

    # -- Arrow interop ------------------------------------------------------

    def to_arrow(self):
        import pyarrow as pa

        host = self.to_host()
        n = self.length
        arrays, fields = [], []
        for col, f in zip(host.columns, self.schema.all_fields):
            arr = _column_to_arrow(col, f.dtype, n)
            arrays.append(arr)
            fields.append(pa.field(f.name, arr.type, f.nullable))
        return pa.RecordBatch.from_arrays(arrays, schema=pa.schema(fields))

    @staticmethod
    def from_arrow(rb, schema: Schema) -> "Batch":
        cols = [_column_from_arrow(rb.column(i), f.dtype)
                for i, f in enumerate(schema.all_fields)]
        return Batch(schema, cols, rb.num_rows)


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _to_numpy(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.cpu().numpy()
    return np.asarray(a)


def _map_arrays(col: Column, fn) -> Column:
    if isinstance(col, FixedColumn):
        return FixedColumn(fn(col.values), fn(col.validity))
    if isinstance(col, VarColumn):
        if col.value_capacity >= _INT32_LIMIT:
            raise ExecutionError(
                f"var-width column holds {col.value_capacity} bytes; int32 "
                "offsets address fewer than 2^31 per batch")
        return VarColumn(fn(col.values), fn(col.offsets), fn(col.validity))
    if isinstance(col, DictColumn):
        return DictColumn(fn(col.codes), fn(col.validity), col.vocab)
    raise TypeError(f"unknown column type {type(col)}")


# ---------------------------------------------------------------------------
# Host-side builders
# ---------------------------------------------------------------------------


def fixed_column(values: np.ndarray,
                 validity: Optional[np.ndarray] = None) -> FixedColumn:
    if validity is None:
        validity = np.ones(len(values), dtype=np.bool_)
    return FixedColumn(values, validity)


def utf8_column(strings: Sequence[Optional[str]]) -> VarColumn:
    """Host VarColumn from Python strings (None = NULL)."""
    parts, offs, valid = [], [0], []
    total = 0
    for s in strings:
        if s is not None:
            b = s.encode()
            parts.append(b)
            total += len(b)
        valid.append(s is not None)
        offs.append(total)
    values = np.frombuffer(b"".join(parts), np.uint8).copy()
    return VarColumn(values, np.asarray(offs, np.int32),
                     np.asarray(valid, np.bool_))


def concat_host(schema: Schema, batches: list[Batch]) -> Batch:
    """Row-concatenate host batches into one (dict columns re-encode onto
    the union of their vocabularies, in first-seen order)."""
    batches = [b.to_host() for b in batches]
    n = sum(b.length for b in batches)
    cols = []
    for i in range(len(schema.all_fields)):
        parts = [b.columns[i] for b in batches]
        cols.append(_concat_columns(parts) if parts else
                    _empty_column(schema.all_fields[i].dtype))
    return Batch(schema, cols, n)


def _concat_columns(parts: list) -> Column:
    first = parts[0]
    valid = np.concatenate([p.validity for p in parts])
    if isinstance(first, FixedColumn):
        return FixedColumn(np.concatenate([p.values for p in parts]), valid)
    if isinstance(first, VarColumn):
        ends = np.cumsum([0] + [int(p.offsets[-1]) for p in parts])
        offs = [np.zeros(1, np.int64)] + [
            p.offsets[1:].astype(np.int64) + base
            for p, base in zip(parts, ends[:-1])]
        return VarColumn(np.concatenate([p.values for p in parts]),
                         np.concatenate(offs).astype(np.int32), valid)
    vocab: dict = {}
    codes = []
    for p in parts:
        remap = np.asarray([vocab.setdefault(s, len(vocab)) for s in p.vocab]
                           or [0], np.int32)
        codes.append(remap[np.clip(p.codes, 0, len(remap) - 1)])
    return DictColumn(np.concatenate(codes), valid, tuple(vocab))


def take_host(batch: Batch, idx: np.ndarray) -> Batch:
    """Row gather over a host batch (numpy arrays), the numpy take that
    stands in for pyarrow's in the sort's run merge."""
    from .formats.textutil import gather_slices

    cols = []
    for c in batch.columns:
        valid = np.asarray(c.validity)[idx]
        if isinstance(c, FixedColumn):
            cols.append(FixedColumn(np.asarray(c.values)[idx], valid))
        elif isinstance(c, DictColumn):
            cols.append(DictColumn(np.asarray(c.codes)[idx], valid, c.vocab))
        else:
            offs = np.asarray(c.offsets).astype(np.int64)
            vals, new_offs = gather_slices(np.asarray(c.values),
                                           offs[:-1][idx], offs[1:][idx])
            cols.append(VarColumn(vals, new_offs.astype(np.int32), valid))
    return Batch(batch.schema, cols, len(idx))


def host_pylists(batch: Batch) -> list[list]:
    """Each column of a host batch as a list of Python values (None for
    NULL, str for strings): what the SQL frontend reads of a subquery."""
    out = []
    for c in batch.columns:
        valid = np.asarray(c.validity)[: batch.length].tolist()
        if isinstance(c, FixedColumn):
            vals = np.asarray(c.values)[: batch.length].tolist()
        elif isinstance(c, DictColumn):
            vocab = list(c.vocab) or [""]
            codes = np.clip(np.asarray(c.codes)[: batch.length], 0,
                            len(vocab) - 1)
            vals = [vocab[k] for k in codes.tolist()]
        else:
            offs = np.asarray(c.offsets).tolist()
            raw = np.asarray(c.values).tobytes()
            vals = [raw[offs[i]:offs[i + 1]].decode()
                    for i in range(batch.length)]
        out.append([v if ok else None for v, ok in zip(vals, valid)])
    return out


def _empty_column(dtype: DataType, n: int = 0) -> Column:
    """A host column of n NULL rows (no rows by default)."""
    none = np.zeros(n, np.bool_)
    if dtype.kind == TypeKind.DICTIONARY:
        return DictColumn(np.zeros(n, np.int32), none, ())
    if dtype.is_var_width:
        return VarColumn(np.zeros(0, np.uint8), np.zeros(n + 1, np.int32),
                         none)
    return FixedColumn(np.zeros(n, numpy_dtype(dtype)), none)


def empty_batch(schema: Schema, n: int = 0) -> Batch:
    """A host batch of n rows, every value NULL (no rows by default)."""
    return Batch(schema, [_empty_column(f.dtype, n)
                          for f in schema.all_fields], n)


# ---------------------------------------------------------------------------
# Columns decoded by the JAX package
# ---------------------------------------------------------------------------


def from_numpy_batch(b) -> Batch:
    """Build a host Batch from an ``exon_tpu`` Batch (numpy or JAX arrays)
    holding the same values: rows past ``b.length`` are dropped and
    var-width columns are rebased to their first live byte."""
    n = int(np.asarray(b.length))
    schema = Schema(tuple(_field_from(f) for f in b.schema.all_fields))
    cols = []
    for c in b.columns:
        kind = type(c).__name__
        valid = np.asarray(c.validity)[:n].astype(np.bool_)
        if kind == "FixedColumn":
            cols.append(FixedColumn(np.asarray(c.values)[:n].copy(), valid))
        elif kind == "DictColumn":
            cols.append(DictColumn(np.asarray(c.codes)[:n].astype(np.int32),
                                   valid, tuple(c.vocab)))
        elif kind == "VarColumn":
            offs = np.asarray(c.offsets)[:n + 1].astype(np.int64)
            vals = np.asarray(c.values)[offs[0]:offs[-1]].copy()
            cols.append(VarColumn(vals, (offs - offs[0]).astype(np.int32),
                                  valid))
        else:
            raise NotImplementedError(
                f"{kind} columns are not ported yet (ROADMAP Queue 1)")
    return Batch(schema, cols, n)


def _field_from(f) -> Field:
    return Field(f.name, _dtype_from(f.dtype), f.nullable)


def _dtype_from(d) -> DataType:
    return DataType(TypeKind(d.kind.value),
                    value_type=None if d.value_type is None
                    else _dtype_from(d.value_type),
                    children=tuple(_field_from(c) for c in d.children))


# ---------------------------------------------------------------------------
# Arrow conversion (host columns)
# ---------------------------------------------------------------------------


def arrow_type(dtype: DataType):
    import pyarrow as pa

    simple = {
        TypeKind.INT8: pa.int8(), TypeKind.INT16: pa.int16(),
        TypeKind.INT32: pa.int32(), TypeKind.INT64: pa.int64(),
        TypeKind.UINT8: pa.uint8(), TypeKind.UINT32: pa.uint32(),
        TypeKind.FLOAT32: pa.float32(), TypeKind.FLOAT64: pa.float64(),
        TypeKind.BOOL: pa.bool_(), TypeKind.UTF8: pa.utf8(),
        TypeKind.LARGE_UTF8: pa.large_utf8(), TypeKind.BINARY: pa.binary(),
        TypeKind.DICTIONARY: pa.utf8(),  # decoded on export
    }
    if dtype.kind in simple:
        return simple[dtype.kind]
    raise NotImplementedError(
        f"{dtype} columns are not ported yet (ROADMAP Queue 1)")


def _column_to_arrow(col: Column, dtype: DataType, n: int):
    import pyarrow as pa

    valid = np.asarray(col.validity)[:n]
    if isinstance(col, FixedColumn):
        vals = np.asarray(col.values)[:n]
        if dtype.kind == TypeKind.BOOL:
            vals = vals.astype(np.bool_)
        mask = ~valid if not valid.all() else None
        return pa.array(vals, type=arrow_type(dtype), mask=mask)
    if isinstance(col, DictColumn):
        vocab = list(col.vocab)
        codes = np.asarray(col.codes)[:n]
        return pa.array([vocab[c] if v and 0 <= c < len(vocab) else None
                         for c, v in zip(codes.tolist(), valid.tolist())],
                        type=pa.utf8())
    offs = np.asarray(col.offsets)[:n + 1].astype(np.int32)
    vals = np.asarray(col.values)[:int(offs[-1]) if n else 0]
    buf_validity = None
    if not valid.all():
        buf_validity = pa.array(valid).buffers()[1]
    arr = pa.StringArray.from_buffers(
        n, pa.py_buffer(offs.tobytes()), pa.py_buffer(vals.tobytes()),
        buf_validity)
    if dtype.kind == TypeKind.LARGE_UTF8:
        arr = arr.cast(pa.large_utf8())
    elif dtype.kind == TypeKind.BINARY:
        arr = arr.cast(pa.binary())
    return arr


def _column_from_arrow(arr, dtype: DataType) -> Column:
    import pyarrow as pa

    arr = arr.combine_chunks() if isinstance(arr, pa.ChunkedArray) else arr
    n = len(arr)
    valid = ~np.asarray(arr.is_null())
    if dtype.is_fixed_width:
        vals = arr.to_numpy(zero_copy_only=False)
        if vals.dtype.kind == "f":
            vals = np.where(valid, vals, 0.0)
        return FixedColumn(np.ascontiguousarray(vals, dtype=numpy_dtype(dtype)),
                           valid)
    if dtype.is_var_width or dtype.kind == TypeKind.DICTIONARY:
        if pa.types.is_large_string(arr.type):
            arr = arr.cast(pa.utf8())
        bufs = arr.buffers()
        offsets = np.frombuffer(bufs[1], dtype=np.int32, count=n + 1,
                                offset=arr.offset * 4).astype(np.int64)
        values = (np.frombuffer(bufs[2], dtype=np.uint8)
                  if bufs[2] is not None else np.zeros(0, np.uint8))
        values = values[offsets[0]:offsets[-1]].copy()
        return VarColumn(values, (offsets - offsets[0]).astype(np.int32),
                         valid)
    raise NotImplementedError(
        f"{dtype} columns are not ported yet (ROADMAP Queue 1)")

