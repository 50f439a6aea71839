"""Physical operators: streaming batch execution on a torch device.

Counterpart of exon_tpu/plan/physical.py: ``ScanExec``, ``FilterExec`` and
``ProjectExec`` (:85-190), ``AggregateExec`` with its ungrouped (:322)
and grouped (:361) paths, the join keys (:745-805), ``concat_batches``
(:946), ``SortExec`` with its run merge (:1006-1313) and ``LimitExec``
(:1515). Each operator transforms an iterator of batches; there is no jit
step cache: torch runs each batch eagerly.

The grouped path keys rows on int64 parts as ``_group_key_i64`` (:745) does:
fixed-width keys are used as int64 (floats by their bits), dictionary keys
map through the content hash of their vocabulary strings
(``_hash_bytes_host`` :819, copied bit for bit) because every batch has its
own vocabulary, var-width keys through their row hash (``_hash_var`` :831,
the row_hash kernel), and NULL parts hold ``_NULL_KEY_SENT`` (:742). Unlike
the JAX package, the parts are not folded into one 64-bit hash, and no hash
is trusted (ROADMAP Queue 3, F3): the hash table compares every part and its
validity, a dictionary string hash shared by two strings raises, and every
var-width key is compared in full with a representative of its group. The
var/stddev family keeps (Σx, Σx², count) in float64 per group (:444-490,
:693-722) through the table's sum-of-squares op.

The holistic aggregates (``median`` and ``string_agg``, and MIN/MAX over a
string or dictionary column; ``_HOLISTIC_FNS`` :449, the dispatch :218-226,
``_string_minmax`` :228, ``_holistic`` :247 and ``_holistic_value`` :495)
need every value: the group and argument expressions are evaluated on the
device, each batch is copied to the host once, and the groups (exact, in
first-seen order) and their values are computed with numpy, without
pyarrow. ``array_agg`` gives each group's non-NULL values in row order as a
list (an empty list where all are NULL; NULL for no rows at all).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .. import datatypes as dt
from ..batch import (Batch, DictColumn, FixedColumn, ListColumn, Schema,
                     StructColumn, VarColumn, column_pyvalues, concat_host,
                     empty_batch, fixed_column, host_pylists, pyvalues_column,
                     take_host, utf8_column)
from ..errors import ExecutionError, PlanError
from ..kernels import hash_aggregate as hk
from ..kernels.expand_segments import expand_segments
from ..kernels.row_hash import row_hash
from ..kernels.sort_keys import FixedKey, VarKey, sort_keys
from ..kernels.string_eq import string_eq
from ..ops import aggregate as agg_ops
from ..ops import layout as layout_ops
from .expressions import (AggregateCall, Expr, NullsOrder, _as_values,
                          _full, _validity_of, as_bool_mask, eval_expr)
from .logical import VAR_FNS, union_schema


class PhysicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def batches(self) -> Iterator[Batch]:
        raise NotImplementedError

    def children(self) -> list["PhysicalPlan"]:
        return []

    def collect_host(self) -> Batch:
        """The whole result as one host Batch of numpy arrays (needs no
        pyarrow)."""
        return concat_host(self.schema(), list(self.batches()))

    def collect_arrow(self):
        import pyarrow as pa

        from ..batch import arrow_type

        rbs = [b.to_arrow() for b in self.batches() if b.length]
        if not rbs:
            fields = [pa.field(f.name, arrow_type(f.dtype), f.nullable)
                      for f in self.schema().all_fields]
            return pa.table({f.name: pa.array([], f.type) for f in fields},
                            schema=pa.schema(fields))
        return pa.Table.from_batches(rbs)


@dataclasses.dataclass
class ScanExec(PhysicalPlan):
    """Leaf scan: decode stream → batches on ``device``. Host batches are
    moved there; a device decoder's batches pass through
    (``to_device=False``, as exon_tpu/tables.py:288)."""

    out_schema: Schema
    source: Callable[[], Iterator[Batch]]
    device: object = "cpu"
    to_device: bool = True

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        for b in self.source():
            if self.to_device:
                b = b.to_device(self.device)
            elif not b.columns:
                b = dataclasses.replace(b, home=torch.device(self.device))
            yield b


@dataclasses.dataclass
class FilterExec(PhysicalPlan):
    predicate: Expr
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        for b in self.input.batches():
            mask = as_bool_mask(eval_expr(self.predicate, b), b)
            yield layout_ops.filter_batch(b, mask)


@dataclasses.dataclass
class ProjectExec(PhysicalPlan):
    exprs: list
    out_schema: Schema
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        for b in self.input.batches():
            cols = [_to_column(eval_expr(e, b), b) for e in self.exprs]
            yield Batch(self.out_schema, cols, b.length, b.device)


def plan_device(plan: PhysicalPlan) -> Optional[torch.device]:
    """The device a plan's leaves put their batches on: the first scan's
    or VALUES' ``device`` below it; None when no leaf names one."""
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, (ScanExec, ValuesExec)):
            return torch.device(p.device)
        stack.extend(reversed(p.children()))
    return None


def _to_column(v, batch: Batch):
    """An evaluated expression as a column (exon_tpu/plan/physical.py:168):
    a Python scalar fills every row, a string repeats its bytes."""
    if isinstance(v, (FixedColumn, VarColumn, DictColumn, ListColumn,
                      StructColumn)):
        return v
    if isinstance(v, str):
        b, cap = v.encode(), batch.capacity
        vals = torch.from_numpy(np.tile(np.frombuffer(b, np.uint8), cap))
        offs = torch.arange(cap + 1, dtype=torch.int32) * len(b)
        return VarColumn(vals.to(batch.device), offs.to(batch.device),
                         batch.row_mask())
    if not isinstance(v, torch.Tensor):
        v = _full(batch.capacity, v, batch.device)
    return FixedColumn(v, batch.row_mask())


# ---------------------------------------------------------------------------
# Aggregate
# ---------------------------------------------------------------------------

_NULL_KEY_SENT = int(np.int64(np.uint64(0x9E3779B97F4A7C15)))
_FNV_PRIME = 1099511628211          # 2^40 + 2^8 + 0xb3
_HASH_SALT = 0x9E3779B97F4A7C15
# the hash table aggregates behind each call: a var/stddev call keeps Σx
# and Σx² (its count is the table's own, exon_tpu/plan/physical.py:444)
_OPS = {"count": (hk.COUNT,), "sum": (hk.SUM,), "avg": (hk.SUM,),
        "min": (hk.MIN,), "max": (hk.MAX,),
        **{fn: (hk.SUM, hk.SUMSQ) for fn in VAR_FNS}}
# aggregates that need every value, finalized on the host
_HOLISTIC_FNS = ("median", "array_agg", "string_agg")
_STRING_KINDS = ("utf8", "large_utf8", "dictionary", "binary")


def _splitmix_host(h: int) -> int:
    M = (1 << 64) - 1
    h = (h + 0x9E3779B97F4A7C15) & M
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & M
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & M
    return h ^ (h >> 31)


def _hash_bytes_host(s: bytes) -> int:
    """Full-content FNV-style polynomial mod 2^64 (Horner form) + splitmix
    finalizer, as signed int64 (exon_tpu/plan/physical.py:819, unchanged)."""
    M = (1 << 64) - 1
    h = 0
    for b in s:
        h = (h * _FNV_PRIME + b + 1) & M
    h = (h + len(s) * _HASH_SALT) & M
    h = _splitmix_host(h)
    return h - (1 << 64) if h >= (1 << 63) else h


def _key_part(v, vocab_of: dict) -> torch.Tensor:
    """The int64 key part of one evaluated key column, before NULLs are
    masked (exon_tpu/plan/physical.py:760-787): fixed-width values as int64
    (floats by their bits), dictionary codes mapped through the content hash
    of their vocabulary strings, var-width rows through the row_hash kernel.
    ``vocab_of`` maps every string hash seen so far to its string; a hash
    shared by two different strings raises, so equal dictionary parts mean
    equal strings."""
    if isinstance(v, DictColumn):
        hashes = []
        for s in v.vocab:
            h = _hash_bytes_host(s.encode())
            if vocab_of.setdefault(h, s) != s:
                raise ExecutionError(
                    f"keys {vocab_of[h]!r} and {s!r} share the 64-bit "
                    "content hash")
            hashes.append(h)
        table = torch.tensor(hashes or [0], dtype=torch.int64)
        return table.to(v.codes.device)[
            v.codes.long().clamp(0, table.shape[0] - 1)]
    if isinstance(v, FixedColumn):
        return v.values.to(torch.float64).view(torch.int64) \
            if v.values.dtype.is_floating_point else v.values.to(torch.int64)
    if isinstance(v, VarColumn):
        return row_hash(v.offsets, v.values)
    raise NotImplementedError(
        f"{type(v).__name__} keys are not ported yet (ROADMAP Queue 1)")


def join_key_parts(exprs, batch: Batch, vocab_of: dict):
    """Per-part join keys (``_group_key_i64`` / ``_group_key_valid``,
    exon_tpu/plan/physical.py:745,796, without the fold).

    Returns (parts int64 [P, n] with NULL parts set to ``_NULL_KEY_SENT``,
    valid bool [n]: every part non-NULL, the evaluated key columns)."""
    parts, cols = [], []
    valid = torch.ones(batch.length, dtype=torch.bool, device=batch.device)
    for e in exprs:
        v = eval_expr(e, batch)
        if not isinstance(v, (FixedColumn, VarColumn, DictColumn)):
            v = FixedColumn(_to_column(v, batch).values,
                            torch.ones_like(valid))
        parts.append(torch.where(v.validity, _key_part(v, vocab_of),
                                 _NULL_KEY_SENT))
        valid = valid & v.validity
        cols.append(v)
    return torch.stack(parts), valid, cols


def fold_key(parts: torch.Tensor) -> torch.Tensor:
    """One int64 key per row from [P, n] parts, the fold of
    exon_tpu/plan/physical.py:788-792 (int64 multiply and add wrap as the
    uint64 ones do). The join searches on it and then verifies every part."""
    key = parts[0]
    for p in parts[1:]:
        key = key * _FNV_PRIME + p
    return key


@dataclasses.dataclass
class AggregateExec(PhysicalPlan):
    """Group-by + aggregate: count, sum, min, max, avg and the var/stddev
    family."""

    group_exprs: list
    agg_calls: list
    out_schema: Schema
    input: PhysicalPlan
    pre_filter: Optional[Expr] = None  # fused Filter predicate (mask only)

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        for c in self.agg_calls:
            if c.distinct or (c.fn not in _OPS and c.fn not in _HOLISTIC_FNS):
                raise NotImplementedError(
                    f"aggregate {c.display_name()} is not ported yet "
                    "(ROADMAP Queue 1, aggregate)")
        if any(c.fn in _HOLISTIC_FNS for c in self.agg_calls) or \
                self._string_minmax():
            yield self._holistic()
            return
        yield self._grouped() if self.group_exprs else self._ungrouped()

    def _string_minmax(self) -> bool:
        """MIN/MAX over a string or dictionary column compares strings
        exactly, on the holistic path (exon_tpu/plan/physical.py:228)."""
        from .planner import infer_expr_field

        in_schema = self.input.schema()
        for c in self.agg_calls:
            if c.fn in ("min", "max") and c.child is not None:
                try:
                    k = infer_expr_field(c.child, in_schema).dtype.kind.value
                except Exception:
                    return True
                if k in _STRING_KINDS:
                    return True
        return False

    # -- holistic (materializing) aggregates ---------------------------------

    def _holistic(self) -> Batch:
        """(exon_tpu/plan/physical.py:247-319) The group and argument
        expressions on the device (the fused filter as a FilterExec), each
        batch copied to the host once, then exact groups in first-seen
        order and each call's value per group in numpy."""
        from .planner import infer_expr_field

        inner: PhysicalPlan = self.input
        if self.pre_filter is not None:
            inner = FilterExec(self.pre_filter, inner)
        in_schema = inner.schema()
        exprs = list(self.group_exprs) + [c.child for c in self.agg_calls
                                          if c.child is not None]
        schema = Schema(tuple(
            dt.Field(f"__h{i}", infer_expr_field(e, in_schema).dtype, True)
            for i, e in enumerate(exprs)))
        device, parts = None, []
        for b in inner.batches():
            device = b.device
            parts.append(Batch(schema, [_to_column(eval_expr(e, b), b)
                                        for e in exprs], b.length).to_host())
        host = concat_host(schema, parts)
        n_group = len(self.group_exprs)
        if n_group:
            gid, first = _host_groups(host.columns[:n_group], host.length)
        else:  # one group, also over no rows
            gid, first = np.zeros(host.length, np.int64), np.zeros(1, np.int64)
        fields = self.out_schema.all_fields
        keys = take_host(Batch(Schema(schema.all_fields[:n_group]),
                               host.columns[:n_group], host.length), first)
        cols = list(keys.columns)
        at = n_group
        for call, f in zip(self.agg_calls, fields[n_group:]):
            col = None
            if call.child is not None:
                col, at = host.columns[at], at + 1
            cols.append(_holistic_column(call, col, gid, len(first), f.dtype))
        out = Batch(self.out_schema, cols, len(first))
        device = device or plan_device(self.input)
        return out if device is None else out.to_device(device)

    def _mask(self, b: Batch) -> torch.Tensor:
        mask = b.row_mask()
        if self.pre_filter is not None:
            mask = mask & as_bool_mask(eval_expr(self.pre_filter, b), b)
        return mask

    def _values_for_call(self, call: AggregateCall, b: Batch, mask):
        """(values int64/float64 or None, valid bool) of one call; float64
        for the var family (exon_tpu/plan/physical.py:467)."""
        if call.child is None:
            return None, mask
        v = eval_expr(call.child, b)
        valid = mask & _validity_of(v, b)
        if call.fn == "count":
            return None, valid
        vals = _as_values(v, b)
        if not isinstance(vals, torch.Tensor):
            vals = torch.full((b.capacity,), vals, device=b.device)
        if isinstance(v, DictColumn) or vals.dtype == torch.bool:
            raise NotImplementedError(
                f"{call.fn} over a non-numeric column is not ported yet "
                "(ROADMAP Queue 1, aggregate)")
        want = torch.float64 if vals.dtype.is_floating_point \
            or call.fn in VAR_FNS else torch.int64
        return vals.to(want).contiguous(), valid

    # -- ungrouped ----------------------------------------------------------

    def _ungrouped(self) -> Batch:
        if (self.pre_filter is None and isinstance(self.input, ScanExec)
                and all(c.fn == "count" and c.child is None
                        for c in self.agg_calls)):
            # COUNT(*) over a bare scan evaluates no columns: sum the host
            # batch lengths during ingest (exon_tpu/plan/physical.py:323)
            total = sum(hb.length for hb in self.input.source())
            return self._finalize_ungrouped(
                [(total, total)] * len(self.agg_calls), self.input.device)
        device, device_parts = None, []
        for b in self.input.batches():
            device = b.device
            device_parts.append(self._ungrouped_partials(b, self._mask(b)))
        return self._finalize_ungrouped(self._merge_partials(device_parts),
                                        device or plan_device(self.input))

    def _ungrouped_partials(self, b: Batch, mask) -> list:
        """Per call, the batch's partial as 0-d device tensors."""
        parts = []
        for call in self.agg_calls:
            vals, valid = self._values_for_call(call, b, mask)
            c = agg_ops.ungrouped_reduce(None, valid, "count")
            if call.fn == "count":
                parts.append((c, c))
            elif call.fn in ("sum", "avg"):
                parts.append((agg_ops.ungrouped_reduce(vals, valid, "sum"), c))
            elif call.fn in VAR_FNS:
                # (Σx, Σx², count) in float64 (:467-471)
                parts.append(
                    (agg_ops.ungrouped_reduce(vals, valid, "sum"),
                     agg_ops.ungrouped_reduce(vals * vals, valid, "sum"), c))
            else:
                parts.append((agg_ops.ungrouped_reduce(vals, valid, call.fn),
                              c))
        return parts

    def _merge_partials(self, device_parts: list, partials=None) -> list:
        """The batches' partials merged on the host into ``partials`` (one
        host read per batch partial, after the stream has been queued);
        a call with no batch gets its empty partial."""
        partials = list(partials or [None] * len(self.agg_calls))
        for parts in device_parts:
            for j, (call, p) in enumerate(zip(self.agg_calls, parts)):
                p = tuple(x.item() if isinstance(x, torch.Tensor) else x
                          for x in p)
                partials[j] = p if partials[j] is None \
                    else _merge_ungrouped(call.fn, partials[j], p)
        return [p if p is not None else
                ((0.0, 0.0, 0) if call.fn in VAR_FNS else (0, 0))
                for p, call in zip(partials, self.agg_calls)]

    def _finalize_ungrouped(self, partials: list, device) -> Batch:
        """The one result row, moved to ``device`` (the input's) as the
        grouped and holistic results are; a host batch only when no device
        is known."""
        cols = []
        for p, call, f in zip(partials, self.agg_calls,
                              self.out_schema.all_fields):
            if call.fn in VAR_FNS:
                out = _finalize_variance(*p, call.fn)
            elif call.fn == "count":
                out = p[1]
            elif call.fn == "avg":
                out = float(p[0]) / p[1] if p[1] else None
            else:
                out = p[0] if p[1] else None
            npdt = dt.numpy_dtype(f.dtype)
            cols.append(fixed_column(np.asarray([0 if out is None else out],
                                                dtype=npdt),
                                     np.asarray([out is not None])))
        out = Batch(self.out_schema, cols, 1)
        return out if device is None else out.to_device(device)

    # -- grouped ------------------------------------------------------------

    def _key_parts(self, b: Batch, vocab_of: dict):
        """int64 parts [n_group, n], their validity (uint8), each key's kind
        ("dict", "var" or "fixed") and the evaluated key columns."""
        parts, valid, kinds, cols = [], [], [], []
        for e in self.group_exprs:
            v = eval_expr(e, b)
            if isinstance(v, torch.Tensor):
                # a computed key (a UDF's values), all valid
                v = FixedColumn(v, b.row_mask())
            if not isinstance(v, (DictColumn, FixedColumn, VarColumn)):
                raise NotImplementedError(
                    f"group key {e.display_name()} is not ported yet "
                    "(ROADMAP Queue 1, aggregate)")
            parts.append(torch.where(v.validity, _key_part(v, vocab_of),
                                     _NULL_KEY_SENT))
            valid.append(v.validity)
            kinds.append("dict" if isinstance(v, DictColumn) else
                         "var" if isinstance(v, VarColumn) else "fixed")
            cols.append(v)
        return (torch.stack(parts).contiguous(),
                torch.stack(valid).to(torch.uint8).contiguous(), kinds, cols)

    def _grouped(self) -> Batch:
        """Streaming grouped aggregate into one hash table; the output is
        ordered by each group's first-seen row, as in the JAX package.

        A var-width key enters the table as its row hash. The aggregate
        keeps a representative of each group's key bytes, appended as
        groups open, and compares every row's bytes with its group's
        representative (string_eq), so two strings that share the 64-bit
        hash raise instead of merging (ROADMAP Queue 3, F3)."""
        specs: list = []
        vocab_of: dict = {}
        table = None
        base_row = 0
        kinds: list = []
        reps: dict = {}  # var key index -> representatives, by group id
        for b in self.input.batches():
            mask = self._mask(b)
            parts, pvalid, kinds, key_cols = self._key_parts(b, vocab_of)
            vals, valids, batch_specs = self._agg_inputs(b, mask)
            if table is None:
                specs = batch_specs
                table = agg_ops.GroupedHashAggregate(
                    parts.shape[0], specs, parts.device,
                    track_groups="var" in kinds)
            elif batch_specs != specs:
                raise ExecutionError("aggregate input type changed "
                                     "between batches")
            groups = table.add_batch(parts, pvalid, mask, vals, valids,
                                     base_row)
            if groups is not None:
                gid, opened = groups
                for i, kind in enumerate(kinds):
                    if kind == "var":
                        reps[i] = _append_reps(reps.get(i), key_cols[i],
                                               opened)
                        _verify_keys(key_cols[i], gid, reps[i])
            base_row += b.length
        if table is None:
            return empty_batch(self.out_schema)
        return self._finalize_grouped(table.finalize(), kinds, vocab_of,
                                      reps)

    def _agg_inputs(self, b: Batch, mask) -> tuple:
        """(values, valid flags, (op, is_float) specs) of the hash table's
        aggregates over one batch: one per op of each call (``_OPS``)."""
        vals, valids, specs = [], [], []
        for call in self.agg_calls:
            v, ok = self._values_for_call(call, b, mask)
            is_float = v is not None and v.dtype.is_floating_point
            for op in _OPS[call.fn]:
                vals.append(v)
                valids.append(ok)
                specs.append((op, is_float))
        return vals, valids, specs

    def _finalize_grouped(self, res: agg_ops.GroupedResult, kinds,
                          vocab_of: dict, reps: dict) -> Batch:
        g = res.num_groups
        fields = self.out_schema.all_fields
        keys = res.keys.cpu().numpy()
        key_valid = res.key_valid.cpu().numpy()
        cols = []
        for i, (kind, f) in enumerate(zip(kinds, fields)):
            if kind == "dict":
                vocab: dict = {}
                codes = np.asarray(
                    [vocab.setdefault(vocab_of[h], len(vocab)) if ok else 0
                     for h, ok in zip(keys[i].tolist(),
                                      key_valid[i].tolist())], np.int32)
                cols.append(DictColumn(codes, key_valid[i], tuple(vocab)))
            elif kind == "var":
                rep = layout_ops.take_var(reps[i],
                                          res.group_ids.to(torch.int32))
                cols.append(VarColumn(rep.values.cpu().numpy(),
                                      rep.offsets.cpu().numpy(),
                                      key_valid[i]))
            else:
                vals = keys[i].view(np.float64) if f.dtype.kind.value.startswith(
                    "float") else keys[i]
                vals = np.where(key_valid[i], vals, 0).astype(
                    dt.numpy_dtype(f.dtype))
                cols.append(FixedColumn(vals, key_valid[i]))
        n_group = len(self.group_exprs)
        at = 0  # the call's first aggregate in the table
        for j, call in enumerate(self.agg_calls):
            f = fields[n_group + j]
            cnt = res.cnt[at]
            if call.fn == "count":
                vals, valid = cnt, torch.ones_like(cnt, dtype=torch.bool)
            elif call.fn in VAR_FNS:
                vals, valid = _finalize_variance_grouped(
                    res.acc[at], res.acc[at + 1], cnt, call.fn)
            else:
                valid = cnt > 0
                acc = res.acc[at]
                if call.fn == "avg":
                    acc = acc.to(torch.float64) / cnt.clamp(min=1).to(
                        torch.float64)
                vals = torch.where(valid, acc, torch.zeros((), dtype=acc.dtype,
                                                           device=acc.device))
            at += len(_OPS[call.fn])
            cols.append(FixedColumn(
                vals.cpu().numpy().astype(dt.numpy_dtype(f.dtype)),
                valid.cpu().numpy()))
        return Batch(self.out_schema, cols, g).to_device(res.keys.device)


def _host_groups(keys: list, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Exact groups of host key columns: (group id per row, each
    group's first row), groups numbered in first-seen order. NULL is a key
    value of its own, apart from '' and 0."""
    codes = []
    for c in keys:
        valid = np.asarray(c.validity)[:n]
        if isinstance(c, VarColumn):
            offs = np.asarray(c.offsets).tolist()
            raw = np.asarray(c.values).tobytes()
            seen: dict = {}
            code = np.fromiter((seen.setdefault(raw[offs[i]:offs[i + 1]],
                                                len(seen))
                                for i in range(n)), np.int64, n)
        elif isinstance(c, DictColumn):
            code = np.asarray(c.codes)[:n].astype(np.int64)
        else:
            code = np.unique(np.asarray(c.values)[:n],
                             return_inverse=True)[1].reshape(-1)
        codes.append(np.where(valid, code, -1))
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    inv = np.unique(np.stack(codes, axis=1), axis=0,
                    return_inverse=True)[1].reshape(-1)
    first = np.full(int(inv.max()) + 1, n, np.int64)
    np.minimum.at(first, inv, np.arange(n, dtype=np.int64))
    order = np.argsort(first, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return rank[inv], first[order]


def _holistic_column(call: AggregateCall, col, gid: np.ndarray, ng: int,
                     dtype: dt.DataType):
    """One call's host column over ``ng`` groups (``_holistic_value``,
    exon_tpu/plan/physical.py:495-535): ``median`` in float64 (rounded half
    to even for integers), ``string_agg`` joined in row order with its
    values printed as Python prints them, MIN/MAX of strings by their bytes
    (code-point order for UTF-8), ``count`` of non-NULL values,
    ``array_agg`` the group's non-NULL values in row order (NULL only for
    no rows at all), and the other aggregates over the group's non-NULL
    values, NULL where there are none."""
    fn = call.fn
    n = gid.shape[0]
    if fn == "array_agg":
        groups: list = [[] for _ in range(ng)]
        for k, x in zip(gid.tolist(), column_pyvalues(col, n)):
            if x is not None:
                groups[k].append(x)
        rows = np.bincount(gid, minlength=ng) > 0
        return pyvalues_column([g if r else None
                                for g, r in zip(groups, rows.tolist())],
                               dtype)
    if fn == "count":
        rows = gid if col is None else gid[np.asarray(col.validity)[:n]]
        return FixedColumn(np.bincount(rows, minlength=ng).astype(np.int64),
                           np.ones(ng, np.bool_))
    valid = np.asarray(col.validity)[:n]
    g = gid[valid]
    cnt = np.bincount(g, minlength=ng)
    has = cnt > 0
    if fn == "string_agg" or (fn in ("min", "max") and
                              not isinstance(col, FixedColumn)):
        vals = [x for x, ok in zip(host_pylists(Batch(None, [col], n))[0],
                                   valid.tolist()) if ok]
        if fn == "string_agg":
            sep = (call.extra[0] if call.extra else ",") or ""
            groups: list = [[] for _ in range(ng)]
            for k, x in zip(g.tolist(), vals):
                groups[k].append(x if isinstance(x, str) else str(x))
            return utf8_column([sep.join(p) if p else None for p in groups])
        enc = [x.encode() for x in vals]
        distinct = sorted(set(enc))
        rank_of = {s: i for i, s in enumerate(distinct)}
        ranks = np.fromiter((rank_of[s] for s in enc), np.int64, len(enc))
        best = np.full(ng, len(distinct) if fn == "min" else -1, np.int64)
        (np.minimum if fn == "min" else np.maximum).at(best, g, ranks)
        return utf8_column([distinct[k].decode() if ok else None
                            for k, ok in zip(best.tolist(), has.tolist())])
    x = np.asarray(col.values)[:n][valid]
    npdt = dt.numpy_dtype(dtype)
    if fn == "median":
        out = _group_medians(x.astype(np.float64), g, cnt)
        if x.dtype.kind in "iub":
            out = np.rint(out)
    elif fn in ("sum", "avg"):
        if x.dtype.kind == "f":
            # Python's sum of floats (compensated since 3.12), as the JAX
            # package sums its to_pylist values
            acc = np.asarray([sum(p) for p in _group_lists(x, g, cnt)],
                             np.float64)
        else:
            acc = np.zeros(ng, np.int64)
            np.add.at(acc, g, x)
        out = acc.astype(np.float64) / np.maximum(cnt, 1) if fn == "avg" \
            else acc
    elif fn in ("min", "max"):
        lo = fn == "min"
        init = (np.inf if lo else -np.inf) if x.dtype.kind == "f" else \
            (lo if x.dtype.kind == "b" else
             (np.iinfo(x.dtype).max if lo else np.iinfo(x.dtype).min))
        out = np.full(ng, init, x.dtype)
        (np.minimum if lo else np.maximum).at(out, g, x)
    elif fn in VAR_FNS:
        out = np.zeros(ng, np.float64)
        pop = fn.endswith("_pop")
        has = cnt >= (1 if pop else 2)
        for k, xs in enumerate(_group_lists(x, g, cnt)):
            if has[k]:
                var = np.asarray(xs, np.float64).var(ddof=0 if pop else 1)
                out[k] = np.sqrt(var) if fn.startswith("stddev") else var
    else:
        raise ExecutionError(f"aggregate {fn} unsupported in holistic path")
    return FixedColumn(np.where(has, out, 0).astype(npdt), has)


def _group_lists(x: np.ndarray, g: np.ndarray, cnt: np.ndarray) -> list:
    """Each group's values as a list of Python numbers, in row order."""
    xs = x[np.argsort(g, kind="stable")].tolist()
    ends = np.cumsum(cnt).tolist()
    return [xs[e - c:e] for e, c in zip(ends, cnt.tolist())]


def _group_medians(x: np.ndarray, g: np.ndarray, cnt: np.ndarray
                   ) -> np.ndarray:
    """np.median of each group's float64 values: the middle value, or the
    mean of the two middle ones; NaN where a group holds a NaN."""
    order = np.lexsort((x, g))
    xs = x[order]
    start = np.cumsum(cnt) - cnt
    has = cnt > 0
    lo = np.where(has, start + (cnt - 1) // 2, 0)
    hi = np.where(has, start + cnt // 2, 0)
    out = np.zeros(cnt.shape[0], np.float64)
    if xs.shape[0]:
        even = has & (cnt % 2 == 0)
        out = np.where(even, (xs[lo] + xs[hi]) / 2.0, xs[lo])
        nan = np.bincount(g[np.isnan(x)], minlength=cnt.shape[0]) > 0
        out = np.where(nan, np.nan, out)
    return out


def _merge_ungrouped(fn: str, a: tuple, b: tuple) -> tuple:
    """Two host partials of one call (exon_tpu/plan/physical.py:864-886)."""
    if fn not in ("min", "max"):
        return tuple(x + y for x, y in zip(a, b))
    (av, ac), (bv, bc) = a, b
    if ac and bc:
        return (min(av, bv) if fn == "min" else max(av, bv), ac + bc)
    return (bv, ac + bc) if bc else (av, ac + bc)


def _finalize_variance(s: float, ss: float, c: int, fn: str):
    """The host finalize of an ungrouped var/stddev partial
    (exon_tpu/plan/physical.py:915-921)."""
    pop = fn.endswith("_pop")
    if c < (1 if pop else 2):
        return None
    m2 = max(ss - s * s / c, 0.0)
    var = m2 / (c if pop else c - 1)
    return float(np.sqrt(var)) if fn.startswith("stddev") else float(var)


def _finalize_variance_grouped(s, ss, c, fn: str):
    """(values float64, valid) of a grouped var/stddev call from its
    (Σx, Σx², count) partials (``_jit_finalize_grouped``,
    exon_tpu/plan/physical.py:713-722): a sample or population
    denominator, NULL below 2 rows (sample) or 1 row (population)."""
    cf = c.clamp(min=1).to(torch.float64)
    m2 = torch.clamp(ss - s * s / cf, min=0.0)
    pop = fn.endswith("_pop")
    var = m2 / (cf if pop else torch.clamp(cf - 1.0, min=1.0))
    vals = torch.sqrt(var) if fn.startswith("stddev") else var
    valid = c >= (1 if pop else 2)
    return torch.where(valid, vals, 0.0), valid


def _append_reps(reps: Optional[VarColumn], col: VarColumn,
                 opened: torch.Tensor) -> VarColumn:
    """The representatives with the opening rows of this batch's new groups
    appended (a gather_var of the rows, then a concatenation)."""
    new = layout_ops.take_var(col, opened.to(torch.int32))
    if reps is None:
        return new
    return VarColumn(torch.cat([reps.values, new.values]),
                     torch.cat([reps.offsets,
                                new.offsets[1:] + reps.offsets[-1]]),
                     torch.cat([reps.validity, new.validity]))


def _verify_keys(col: VarColumn, gid: torch.Tensor, reps: VarColumn) -> None:
    """Raise unless every live row with a non-NULL key holds the same bytes
    as its group's representative (string_eq over those rows alone; rows
    the mask dropped have no group, and a batch may have none left)."""
    idx, count = layout_ops.mask_to_indices((gid >= 0) & col.validity)
    rows = idx[:int(count)]
    if rows.shape[0] == 0:
        return
    same = string_eq((col.offsets, col.values, col.validity), rows,
                     (reps.offsets, reps.values, reps.validity),
                     gid[rows.long()].to(torch.int32))
    if not bool(same.all()):
        raise ExecutionError(
            "two different group keys share the 64-bit row hash; the "
            "aggregate refuses to merge them")


# ---------------------------------------------------------------------------
# Concatenation
# ---------------------------------------------------------------------------


def concat_batches(schema: Schema, batches: list[Batch], device) -> Batch:
    """Row-concatenate device batches with ``torch.cat`` (the JAX package
    goes through host Arrow, exon_tpu/plan/physical.py:946). Dictionary
    vocabularies are unified on the host in first-seen order and each
    batch's codes remapped through a small device table; var-width offsets
    are rebased after one host read of every batch's byte total."""
    batches = [b for b in batches if b.length]
    if not batches:
        return empty_batch(schema).to_device(device)
    if len(batches) == 1:
        return batches[0]
    cols = [_cat_columns([b.columns[i] for b in batches])
            for i in range(len(schema.all_fields))]
    return Batch(schema, cols, sum(b.length for b in batches),
                 batches[0].device)


def _cat_columns(parts: list):
    first = parts[0]
    valid = torch.cat([p.validity for p in parts])
    if isinstance(first, FixedColumn):
        return FixedColumn(torch.cat([p.values for p in parts]), valid)
    if isinstance(first, VarColumn):
        totals = torch.stack([p.offsets[-1] for p in parts]).tolist()
        bases = np.cumsum([0] + totals).tolist()
        if bases[-1] >= 1 << 31:
            raise ExecutionError(f"concatenated var-width column holds "
                                 f"{bases[-1]} bytes; int32 offsets address "
                                 "fewer than 2^31")
        offs = [first.offsets[:1]] + [p.offsets[1:] + base
                                      for p, base in zip(parts, bases)]
        return VarColumn(torch.cat([p.values for p in parts]),
                         torch.cat(offs).to(torch.int32), valid)
    if isinstance(first, ListColumn):
        bases = np.cumsum([0] + [p.child.capacity for p in parts]).tolist()
        if bases[-1] >= 1 << 31:
            raise ExecutionError(f"concatenated list column holds "
                                 f"{bases[-1]} elements; int32 offsets "
                                 "address fewer than 2^31")
        offs = [first.offsets[:1]] + [p.offsets[1:] + base
                                      for p, base in zip(parts, bases)]
        return ListColumn(_cat_columns([p.child for p in parts]),
                          torch.cat(offs).to(torch.int32), valid)
    if isinstance(first, StructColumn):
        return StructColumn({k: _cat_columns([p.children[k] for p in parts])
                             for k in first.children}, valid)
    vocab: dict = {}
    codes = []
    for p in parts:
        remap = torch.tensor([vocab.setdefault(s, len(vocab))
                              for s in p.vocab] or [0], dtype=torch.int32)
        remap = remap.to(p.codes.device)
        codes.append(remap[p.codes.long().clamp(0, remap.shape[0] - 1)])
    return DictColumn(torch.cat(codes), valid, tuple(vocab))


# ---------------------------------------------------------------------------
# Sort / Limit
# ---------------------------------------------------------------------------

_I64_SIGN = np.int64(-(1 << 63))  # the 1<<63 bit pattern in two's complement


@dataclasses.dataclass
class SortExec(PhysicalPlan):
    """ORDER BY as an external run sort (exon_tpu/plan/physical.py:1006).

    Input batches accumulate into runs of ``EXON_TPU_SORT_RUN_ROWS`` rows
    (default 2^21, read as the JAX package reads it). Each run sorts on the
    device: the sort_keys kernel writes its int64 key matrix and a chain of
    stable ``torch.sort``s orders it, least significant key row first, as
    ``_jit_sort_run`` (:1353-1367) does. One run is the result as it is;
    several are moved to the host with their key matrices and merged
    pairwise in numpy, earlier runs winning ties (:1244-1313). ``fetch``
    (TopK) truncates every run. The JAX package's host-sort shortcut
    (:1056-1073) is not ported: every run sorts on the device, with the same
    key encoding, so the results are the same."""

    keys: list  # [(Expr, ascending)]
    input: PhysicalPlan
    fetch: Optional[int] = None

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        runs = self._runs()
        if not runs:
            return
        if len(runs) == 1:
            yield runs[0][0]
            return
        device = runs[0][0].device
        merged = self._merge(runs)[0]
        if self.fetch is not None and merged.length > self.fetch:
            merged = take_host(merged, np.arange(self.fetch))
        yield merged.to_device(device)

    def merged_run(self) -> Optional[tuple]:
        """The whole input sorted into one host run (host batch, key matrix
        [n, C], chunk widths), or None for an empty input
        (exon_tpu/plan/physical.py:1041). Each run keeps at most ``fetch``
        rows; the merged run is not cut. The distributed sort exchanges
        these runs and merges them with the same ``_merge_runs``."""
        runs = self._runs()
        return self._merge(runs) if runs else None

    def _merge(self, runs: list) -> tuple:
        host_runs = [(b.to_host(), k.T.cpu().numpy(), c) for b, k, c in runs]
        return _merge_runs(host_runs, [a for _e, a in self.keys])

    def _runs(self) -> list:
        """The input's sorted runs: (device batch, key matrix [C, n], chunk
        widths)."""
        run_rows = int(os.environ.get("EXON_TPU_SORT_RUN_ROWS", 1 << 21))
        self._chunks_seen = None
        runs: list = []
        acc: list[Batch] = []
        acc_rows = 0
        for b in self.input.batches():
            if b.length == 0:
                continue
            acc.append(b)
            acc_rows += b.length
            if acc_rows >= run_rows:
                runs.append(self._sorted_run(acc))
                acc, acc_rows = [], 0
        if acc:
            runs.append(self._sorted_run(acc))
        return runs

    def _key_specs(self, batch: Batch) -> list:
        """The sort_keys specs of one run, var-width keys widened to
        earlier runs' chunk counts so that runs merge."""
        specs = sort_key_specs(self.keys, batch, self._chunks_seen)
        self._chunks_seen = [s.nchunks if isinstance(s, VarKey) else 0
                             for s in specs]
        return specs

    def _sorted_run(self, acc: list) -> tuple:
        combined = concat_batches(self.schema(), acc, acc[0].device)
        n = combined.length
        mat = sort_keys(self._key_specs(combined), n, combined.device)
        perm = torch.arange(n, device=combined.device)
        # row 0 is the padding flag, all zero here: its stable sort is the
        # identity, so the chain starts at row 1
        for k in reversed(mat[1:]):
            perm = perm[torch.sort(k[perm], stable=True).indices]
        if self.fetch is not None:
            perm = perm[: self.fetch]
        out = layout_ops.take_batch(combined, perm.to(torch.int32))
        return out, mat[1:, perm], list(self._chunks_seen)


def sort_key_specs(keys: list, batch: Batch,
                   widths: Optional[list] = None) -> list:
    """The sort_keys specs of ``keys`` [(Expr, ascending)] over one batch:
    var-width keys (dictionaries decoded to bytes, so keys compare across
    batches and vocabularies) get enough 8-byte chunks for their longest
    row, widened to ``widths`` (earlier runs' chunk counts) where given.
    Shared by SortExec and WindowExec."""
    specs, var_lens = [], []
    for e, asc in keys:
        nulls_first = None
        if isinstance(e, NullsOrder):
            nulls_first, e = e.first, e.child
        v = eval_expr(e, batch)
        if isinstance(v, DictColumn):
            v = layout_ops.dict_to_var(v)
        if isinstance(v, VarColumn):
            specs.append(VarKey(v.offsets, v.values, v.validity, 0, asc,
                                nulls_first))
            var_lens.append((v.offsets[1:] - v.offsets[:-1]).max())
        elif isinstance(v, FixedColumn):
            specs.append(FixedKey(v.values, v.validity, asc, nulls_first))
        elif isinstance(v, (ListColumn, StructColumn)):
            raise PlanError(f"ORDER BY {e.display_name()}: a list or struct "
                            "sort key is not supported")
        else:
            col = _to_column(v, batch)
            specs.append(FixedKey(col.values, col.validity, asc,
                                  nulls_first))
    maxlens = iter(torch.stack(var_lens).tolist() if var_lens else [])
    for j, s in enumerate(specs):
        if isinstance(s, VarKey):
            s.nchunks = max(1, (next(maxlens) + 7) // 8,
                            widths[j] if widths else 0)
    return specs


def _key_bytes(key_cols: np.ndarray) -> np.ndarray:
    """[n, C] int64 key matrix → 'S(8C)' byte strings whose bytewise order
    equals the column-lexicographic int64 order (physical.py:1244)."""
    n, c = key_cols.shape
    u = (key_cols ^ _I64_SIGN).view(np.uint64)
    be = np.ascontiguousarray(u.astype(">u8"))
    return be.view(f"S{8 * c}").reshape(n)


def _pad_key_matrix(keys: np.ndarray, chunks: list, target: list,
                    specs_asc: list) -> np.ndarray:
    """Insert zero-chunk constant columns so a narrower run's key matrix
    matches the widest run's layout (physical.py:1253). Layout per key:
    validity + chunks for var-width keys, validity + value otherwise."""
    if chunks == target:
        return keys
    cols = []
    pos = 0
    for (nc, tnc), asc in zip(zip(chunks, target), specs_asc):
        if nc == 0:
            cols.append(keys[:, pos:pos + 2])
            pos += 2
            continue
        cols.append(keys[:, pos:pos + 1 + nc])
        pos += 1 + nc
        if tnc > nc:
            const = _I64_SIGN if asc else np.int64(-1) - _I64_SIGN
            cols.append(np.full((keys.shape[0], tnc - nc), const, np.int64))
    return np.concatenate(cols, axis=1)


def _merge_runs(runs: list, asc_flags: list) -> tuple:
    """Pairwise stable merge of sorted (host batch, key matrix, chunk
    widths) runs; earlier runs win ties (physical.py:1277)."""
    items = list(runs)
    while len(items) > 1:
        nxt = [_merge_two(items[i], items[i + 1], asc_flags)
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def _merge_two(a: tuple, b: tuple, asc_flags: list) -> tuple:
    ta, ka, ca = a
    tb, kb, cb = b
    target = [max(x, y) for x, y in zip(ca, cb)]
    ka = _pad_key_matrix(ka, ca, target, asc_flags)
    kb = _pad_key_matrix(kb, cb, target, asc_flags)
    sa, sb = _key_bytes(ka), _key_bytes(kb)
    na, nb = len(sa), len(sb)
    pos_a = np.arange(na, dtype=np.int64) + np.searchsorted(sb, sa,
                                                            side="left")
    pos_b = np.arange(nb, dtype=np.int64) + np.searchsorted(sa, sb,
                                                            side="right")
    take = np.empty(na + nb, np.int64)
    take[pos_a] = np.arange(na, dtype=np.int64)
    take[pos_b] = na + np.arange(nb, dtype=np.int64)
    tab = take_host(concat_host(ta.schema, [ta, tb]), take)
    keys = np.empty((na + nb, ka.shape[1]), np.int64)
    keys[pos_a] = ka
    keys[pos_b] = kb
    return tab, keys, target


@dataclasses.dataclass
class LimitExec(PhysicalPlan):
    """OFFSET/LIMIT over the batch stream (exon_tpu/plan/physical.py:1515)."""

    skip: int
    fetch: Optional[int]
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        skip, fetch = self.skip, self.fetch
        for b in self.input.batches():
            n = b.length
            if skip >= n:
                skip -= n
                continue
            take = n - skip if fetch is None else min(n - skip, fetch)
            if take <= 0:
                return
            yield layout_ops.slice_batch(b, skip, skip + take)
            skip = 0
            if fetch is not None:
                fetch -= take
                if fetch <= 0:
                    return


@dataclasses.dataclass
class UnionExec(PhysicalPlan):
    """UNION ALL of the inputs' batch streams, in order
    (exon_tpu/plan/physical.py:1551-1566). Union is positional: each
    child's batches are rebound to the first input's field names. Where the
    inputs disagree on a string column's encoding (a dictionary in one, a
    var-width column in another), the dictionaries there are decoded to
    bytes (``dict_to_var``), so every batch carries one column type."""

    inputs: list

    def children(self):
        return list(self.inputs)

    def schema(self) -> Schema:
        return union_schema([p.schema() for p in self.inputs])

    def batches(self) -> Iterator[Batch]:
        schema = self.schema()
        decode = [f.dtype.kind != dt.TypeKind.DICTIONARY
                  for f in schema.all_fields]
        for p in self.inputs:
            for b in p.batches():
                cols = [layout_ops.dict_to_var(c)
                        if flat and isinstance(c, DictColumn) else c
                        for c, flat in zip(b.columns, decode)]
                yield Batch(schema, cols, b.length, b.device)


@dataclasses.dataclass
class RepeatExec(PhysicalPlan):
    """Each input row ``count_expr`` times; a NULL or negative count gives
    none (exon_tpu/plan/physical.py:971-1004, the multiset expansion of
    INTERSECT ALL and EXCEPT ALL). The JAX version takes the rows on the
    host through Arrow; here they go out on the device: expand_segments
    (K1c) writes each row's index as many times as its count, after one
    host read of the total, and ``take_batch`` gathers them (gather_var for
    var-width columns)."""

    count_expr: Expr
    input: PhysicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()

    def batches(self) -> Iterator[Batch]:
        for b in self.input.batches():
            if b.length == 0:
                continue
            v = eval_expr(self.count_expr, b)
            cnt = _to_column(v, b).values.to(torch.int64)
            cnt = torch.where(_validity_of(v, b), cnt, 0).clamp(min=0)
            rows, _bi, _offsets, total = expand_segments(
                torch.zeros_like(cnt, dtype=torch.int32),
                cnt.to(torch.int32), 1)
            if total:
                yield layout_ops.take_batch(b, rows)


@dataclasses.dataclass
class ValuesExec(PhysicalPlan):
    """Literal rows as one batch (exon_tpu/plan/physical.py:1570), built on
    the host from Python values (None is NULL) and moved to ``device``."""

    out_schema: Schema
    rows: list
    device: object = "cpu"

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        cols = [pyvalues_column([r[j] for r in self.rows], f.dtype)
                for j, f in enumerate(self.out_schema.all_fields)]
        yield Batch(self.out_schema, cols, len(self.rows)).to_device(
            self.device)
