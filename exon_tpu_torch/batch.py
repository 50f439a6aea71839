"""Columnar record batches on torch tensors.

Counterpart of exon_tpu/batch.py:59-130 (columns) and its ``Batch``. The
layout is the same Arrow-style one:

  * ``FixedColumn``  — values ``[n]`` + validity ``[n]``
  * ``VarColumn``    — flat uint8 ``values [nbytes]`` + int32 ``offsets [n+1]``
  * ``DictColumn``   — int32 codes + a host vocabulary tuple
  * ``ListColumn``   — any child column over the flattened elements + int32
                       ``offsets [n+1]`` (exon_tpu/batch.py:134)
  * ``StructColumn`` — named children (exon_tpu/batch.py:153)

A map is a ListColumn over a two-field StructColumn (keys, values), as
exon_tpu/plan/expressions.py ``_is_map_col`` (:706) reads it. Unlike the
JAX package, a list of numbers has one layout: a ListColumn over a
FixedColumn (the JAX package also keeps them as a VarColumn of wide values,
exon_tpu/formats/bam.py:355-361, which ``from_numpy_batch`` converts), and
a VarColumn holds uint8 bytes only. The Arrow export of a struct does not
apply the struct's own validity (its children carry the NULLs), as the JAX
package's does not (:520-526, ROADMAP Queue 3, F23); a map's does, where
the JAX package's exports a NULL map as an empty one (:508-511, F24).

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


@dataclasses.dataclass
class ListColumn:
    """List<child>: row i holds child elements [offsets[i], offsets[i+1])."""

    child: Any     # any column over the flattened elements
    offsets: Any   # int32 [n + 1]
    validity: Any  # bool [n]

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]


@dataclasses.dataclass
class StructColumn:
    """Named children of one row count each."""

    children: dict  # name -> Column
    validity: Any   # bool [n]

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]


Column = Union[FixedColumn, VarColumn, DictColumn, ListColumn, StructColumn]


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
    if isinstance(col, ListColumn):
        if col.child.capacity >= _INT32_LIMIT:
            raise ExecutionError(
                f"list column holds {col.child.capacity} elements; "
                "int32 offsets address fewer than 2^31 per batch")
        return ListColumn(_map_arrays(col.child, fn), fn(col.offsets),
                          fn(col.validity))
    if isinstance(col, StructColumn):
        return StructColumn({k: _map_arrays(c, fn)
                             for k, c in col.children.items()},
                            fn(col.validity))
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
    for i, f in enumerate(schema.all_fields):
        parts = [b.columns[i] for b in batches]
        cols.append(_concat_columns(parts) if parts else
                    _empty_column(f.dtype))
    return Batch(schema, cols, n)


def _rebased_offsets(parts: list, total_of) -> np.ndarray:
    """The int32 offsets of parts laid end to end."""
    ends = np.cumsum([0] + [total_of(p) for p in parts])
    offs = [np.zeros(1, np.int64)] + [
        np.asarray(p.offsets)[1:].astype(np.int64) + base
        for p, base in zip(parts, ends[:-1])]
    return np.concatenate(offs).astype(np.int32)


def _concat_columns(parts: list) -> Column:
    first = parts[0]
    valid = np.concatenate([p.validity for p in parts])
    if isinstance(first, FixedColumn):
        return FixedColumn(np.concatenate([p.values for p in parts]), valid)
    if isinstance(first, VarColumn):
        return VarColumn(np.concatenate([p.values for p in parts]),
                         _rebased_offsets(parts, lambda p: int(p.offsets[-1])),
                         valid)
    if isinstance(first, ListColumn):
        return ListColumn(_concat_columns([p.child for p in parts]),
                          _rebased_offsets(parts, lambda p: p.child.capacity),
                          valid)
    if isinstance(first, StructColumn):
        return StructColumn({k: _concat_columns([p.children[k] for p in parts])
                             for k in first.children}, valid)
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
    return Batch(batch.schema, [_take_host_column(c, idx)
                                for c in batch.columns], len(idx))


def _take_host_column(c: Column, idx: np.ndarray) -> Column:
    from .formats.textutil import gather_slices

    valid = np.asarray(c.validity)[idx]
    if isinstance(c, FixedColumn):
        return FixedColumn(np.asarray(c.values)[idx], valid)
    if isinstance(c, DictColumn):
        return DictColumn(np.asarray(c.codes)[idx], valid, c.vocab)
    if isinstance(c, StructColumn):
        return StructColumn({k: _take_host_column(v, idx)
                             for k, v in c.children.items()}, valid)
    offs = np.asarray(c.offsets).astype(np.int64)
    if isinstance(c, ListColumn):
        src, new_offs = gather_slices(np.arange(c.child.capacity),
                                      offs[:-1][idx], offs[1:][idx])
        return ListColumn(_take_host_column(c.child, src),
                          new_offs.astype(np.int32), valid)
    vals, new_offs = gather_slices(np.asarray(c.values), offs[:-1][idx],
                                   offs[1:][idx])
    return VarColumn(vals, new_offs.astype(np.int32), valid)


def host_pylists(batch: Batch) -> list[list]:
    """Each column of a host batch as a list of Python values (None for
    NULL, str for strings, a list for a list row, a dict for a struct
    row): what the SQL frontend reads of a subquery."""
    return [column_pyvalues(c, batch.length) for c in batch.columns]


def column_pyvalues(c: Column, n: int) -> list:
    """Rows [0, n) of a host column as Python values."""
    valid = np.asarray(c.validity)[:n].tolist()
    if isinstance(c, FixedColumn):
        vals = np.asarray(c.values)[:n].tolist()
    elif isinstance(c, DictColumn):
        vocab = list(c.vocab) or [""]
        codes = np.clip(np.asarray(c.codes)[:n], 0, len(vocab) - 1)
        vals = [vocab[k] for k in codes.tolist()]
    elif isinstance(c, StructColumn):
        kids = {k: column_pyvalues(v, n) for k, v in c.children.items()}
        vals = [{k: kids[k][i] for k in kids} for i in range(n)]
    else:
        offs = np.asarray(c.offsets).tolist()
        if isinstance(c, ListColumn):
            elems = column_pyvalues(c.child, offs[n] if n else 0)
            vals = [elems[offs[i]:offs[i + 1]] for i in range(n)]
        else:
            raw = np.asarray(c.values).tobytes()
            vals = [raw[offs[i]:offs[i + 1]].decode() for i in range(n)]
    return [v if ok else None for v, ok in zip(vals, valid)]


def pyvalues_column(vals: list, dtype: DataType) -> Column:
    """A host column of ``dtype`` from Python values (None is NULL; a list
    row of a LIST type, a dict row of a STRUCT type)."""
    valid = np.asarray([v is not None for v in vals], np.bool_)
    if dtype.is_var_width or dtype.kind == TypeKind.DICTIONARY:
        return utf8_column([None if v is None else str(v) for v in vals])
    if dtype.kind == TypeKind.LIST:
        rows = [v or [] for v in vals]
        offs = np.zeros(len(rows) + 1, np.int64)
        np.cumsum([len(r) for r in rows], out=offs[1:])
        return ListColumn(pyvalues_column([x for r in rows for x in r],
                                          dtype.value_type),
                          offs.astype(np.int32), valid)
    if dtype.kind == TypeKind.STRUCT:
        return StructColumn(
            {f.name: pyvalues_column([None if v is None else v.get(f.name)
                                      for v in vals], f.dtype)
             for f in dtype.children}, valid)
    if not dtype.is_fixed_width:
        raise NotImplementedError(f"Python values of {dtype} are not "
                                  "supported")
    return FixedColumn(np.asarray([0 if v is None else v for v in vals],
                                  dtype=numpy_dtype(dtype)), valid)


def _empty_column(dtype: DataType, n: int = 0) -> Column:
    """A host column of n NULL rows (no rows by default)."""
    none = np.zeros(n, np.bool_)
    if dtype.kind == TypeKind.DICTIONARY:
        return DictColumn(np.zeros(n, np.int32), none, ())
    if dtype.is_var_width:
        return VarColumn(np.zeros(0, np.uint8), np.zeros(n + 1, np.int32),
                         none)
    if dtype.kind in (TypeKind.LIST, TypeKind.MAP):
        return ListColumn(_empty_column(dtype.value_type),
                          np.zeros(n + 1, np.int32), none)
    if dtype.kind == TypeKind.STRUCT:
        return StructColumn({f.name: _empty_column(f.dtype, n)
                             for f in dtype.children}, none)
    return FixedColumn(np.zeros(n, numpy_dtype(dtype)), none)


def empty_like(col: Column, n: int) -> Column:
    """A host column of n NULL rows of ``col``'s layout and value type."""
    none = np.zeros(n, np.bool_)
    if isinstance(col, FixedColumn):
        return FixedColumn(np.zeros(n, _to_numpy(col.values[:0]).dtype), none)
    if isinstance(col, DictColumn):
        return DictColumn(np.zeros(n, np.int32), none, col.vocab)
    if isinstance(col, VarColumn):
        return VarColumn(np.zeros(0, np.uint8), np.zeros(n + 1, np.int32),
                         none)
    if isinstance(col, StructColumn):
        return StructColumn({k: empty_like(c, n)
                             for k, c in col.children.items()}, none)
    return ListColumn(empty_like(col.child, 0), np.zeros(n + 1, np.int32),
                      none)


def empty_batch(schema: Schema, n: int = 0) -> Batch:
    """A host batch of n rows, every value NULL (no rows by default)."""
    return Batch(schema, [_empty_column(f.dtype, n)
                          for f in schema.all_fields], n)


# ---------------------------------------------------------------------------
# Columns decoded by the JAX package
# ---------------------------------------------------------------------------


def from_numpy_batch(b) -> Batch:
    """Build a host Batch from an ``exon_tpu`` Batch (numpy or JAX arrays)
    holding the same values: rows past ``b.length`` are dropped, var-width
    and list columns are rebased to their first live element, and a JAX
    VarColumn of wide values under a LIST type (the JAX package's second
    layout of a list of numbers) becomes a ListColumn over a FixedColumn."""
    n = int(np.asarray(b.length))
    schema = Schema(tuple(_field_from(f) for f in b.schema.all_fields))
    cols = [_from_jax_column(c, f.dtype, 0, n)
            for c, f in zip(b.columns, schema.all_fields)]
    return Batch(schema, cols, n)


def _from_jax_column(c, dtype: DataType, lo: int, hi: int) -> Column:
    """Rows [lo, hi) of a JAX package column as a host column."""
    kind = type(c).__name__
    valid = np.asarray(c.validity)[lo:hi].astype(np.bool_)
    if kind == "FixedColumn":
        return FixedColumn(np.asarray(c.values)[lo:hi].copy(), valid)
    if kind == "DictColumn":
        return DictColumn(np.asarray(c.codes)[lo:hi].astype(np.int32),
                          valid, tuple(c.vocab))
    if kind == "StructColumn":
        return StructColumn({f.name: _from_jax_column(c.children[f.name],
                                                      f.dtype, lo, hi)
                             for f in dtype.children}, valid)
    if kind not in ("VarColumn", "ListColumn"):
        raise NotImplementedError(
            f"{kind} columns are not ported (ROADMAP Queue 1, the "
            "prefix-LIKE pushdown)")
    offs = np.asarray(c.offsets)[lo:hi + 1].astype(np.int64)
    first, last = int(offs[0]), int(offs[-1])
    rebased = (offs - first).astype(np.int32)
    if kind == "ListColumn":
        child = _from_jax_column(c.child, dtype.value_type, first, last)
        return ListColumn(child, rebased, valid)
    vals = np.asarray(c.values)[first:last].copy()
    if dtype.kind == TypeKind.LIST:
        child = FixedColumn(vals.astype(numpy_dtype(dtype.value_type)),
                            np.ones(last - first, np.bool_))
        return ListColumn(child, rebased, valid)
    return VarColumn(vals, rebased, valid)


def _field_from(f) -> Field:
    return Field(f.name, _dtype_from(f.dtype), f.nullable)


def _dtype_from(d) -> DataType:
    return DataType(TypeKind(d.kind.value),
                    value_type=None if d.value_type is None
                    else _dtype_from(d.value_type),
                    children=tuple(_field_from(c) for c in d.children))


# ---------------------------------------------------------------------------
# Arrow conversion (host columns), exon_tpu/batch.py:402-598
# ---------------------------------------------------------------------------


def schema_from_arrow(pa_schema) -> Schema:
    """The port's schema of an Arrow schema (exon_tpu/batch.py:429)."""
    return Schema(tuple(Field(f.name, _dtype_from_arrow(f.type), f.nullable)
                        for f in pa_schema))


def _dtype_from_arrow(t) -> DataType:
    import pyarrow as pa

    from . import datatypes as dt

    for test, dtype in ((pa.types.is_int8, dt.int8),
                        (pa.types.is_int16, dt.int16),
                        (pa.types.is_int32, dt.int32),
                        (pa.types.is_int64, dt.int64),
                        (pa.types.is_uint8, dt.uint8),
                        (pa.types.is_uint32, dt.uint32),
                        (pa.types.is_float32, dt.float32),
                        (pa.types.is_float64, dt.float64),
                        (pa.types.is_boolean, dt.bool_),
                        (pa.types.is_large_string, dt.large_utf8),
                        (pa.types.is_string, dt.utf8),
                        (pa.types.is_binary, dt.binary),
                        (pa.types.is_dictionary, dt.utf8)):
        if test(t):
            return dtype
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        return dt.list_(_dtype_from_arrow(t.value_type))
    if pa.types.is_struct(t):
        return dt.struct([Field(f.name, _dtype_from_arrow(f.type),
                                f.nullable) for f in t])
    if pa.types.is_map(t):
        return dt.map_(_dtype_from_arrow(t.key_type),
                       _dtype_from_arrow(t.item_type))
    raise TypeError(f"unsupported arrow type {t}")


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
    if dtype.kind == TypeKind.LIST:
        return pa.list_(arrow_type(dtype.value_type))
    if dtype.kind == TypeKind.STRUCT:
        return pa.struct([pa.field(f.name, arrow_type(f.dtype), f.nullable)
                          for f in dtype.children])
    kv = dtype.value_type  # MAP
    return pa.map_(arrow_type(kv.children[0].dtype),
                   arrow_type(kv.children[1].dtype))


def _column_to_arrow(col: Column, dtype: DataType, n: int):
    import pyarrow as pa

    valid = np.asarray(col.validity)[:n]
    mask = ~valid if not valid.all() else None
    if isinstance(col, FixedColumn):
        vals = np.asarray(col.values)[:n]
        if dtype.kind == TypeKind.BOOL:
            vals = vals.astype(np.bool_)
        return pa.array(vals, type=arrow_type(dtype), mask=mask)
    if isinstance(col, DictColumn):
        vocab = list(col.vocab)
        codes = np.asarray(col.codes)[:n]
        return pa.array([vocab[c] if v and 0 <= c < len(vocab) else None
                         for c, v in zip(codes.tolist(), valid.tolist())],
                        type=pa.utf8())
    if isinstance(col, StructColumn):
        if not dtype.children:
            # a struct of no fields still has its rows (the JAX export
            # gives none, and its batch fails to build: F27)
            return pa.array([{}] * n, type=pa.struct([]))
        # the struct's own validity stays out, as in the JAX package (F23)
        return pa.StructArray.from_arrays(
            [_column_to_arrow(col.children[f.name], f.dtype, n)
             for f in dtype.children], [f.name for f in dtype.children])
    offs = np.asarray(col.offsets)[:n + 1].astype(np.int32)
    if isinstance(col, ListColumn):
        child = _column_to_arrow(col.child, dtype.value_type,
                                 int(offs[-1]) if n else 0)
        amask = None if mask is None else pa.array(mask)
        if dtype.kind == TypeKind.MAP:
            # a NULL map stays NULL (F24: the JAX package drops the mask)
            return pa.MapArray.from_arrays(pa.array(offs, pa.int32()),
                                           child.field(0), child.field(1),
                                           mask=amask)
        return pa.ListArray.from_arrays(pa.array(offs, pa.int32()), child,
                                        mask=amask)
    vals = np.asarray(col.values)[:int(offs[-1]) if n else 0]
    buf_validity = None
    if mask is not None:
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
    if dtype.kind == TypeKind.STRUCT:
        return StructColumn({f.name: _column_from_arrow(arr.field(f.name),
                                                        f.dtype)
                             for f in dtype.children}, valid)
    off = np.asarray(arr.offsets).astype(np.int64)
    first, count = int(off[0]), int(off[-1] - off[0])
    if dtype.kind == TypeKind.MAP:
        kv = dtype.value_type
        child = StructColumn(
            {kv.children[0].name: _column_from_arrow(
                arr.keys.slice(first, count), kv.children[0].dtype),
             kv.children[1].name: _column_from_arrow(
                 arr.items.slice(first, count), kv.children[1].dtype)},
            np.ones(count, np.bool_))
    else:
        child = _column_from_arrow(arr.values.slice(first, count),
                                   dtype.value_type)
    return ListColumn(child, (off - first).astype(np.int32), valid)
