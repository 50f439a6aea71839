"""Window functions on the device.

Counterpart of exon_tpu/plan/window_exec.py: ``WindowExec`` (:44-64),
``_window_column`` (:80-240) with ``_window_aggregate`` (:263-425),
``_window_shift`` (:438-453), ``_ident`` (:428) and ``_bsearch`` (:243),
and ``WINDOW_FUNCS`` (:37). Each call appends one column to the input,
which is concatenated into one batch on the device first, as the JAX
package does; the rows keep their input order.

Per call: the key matrix of (PARTITION BY, ORDER BY) is built as SortExec
builds it (``sort_key_specs``: dictionaries decoded to bytes, string keys
in 8-byte chunks up to their longest row, NULL placement per key) by
``sort_keys`` (K5) and ordered by a chain of stable ``torch.sort``s, so
ties keep input order as the JAX chain of stable argsorts does
(:111-121). A NULL key's value rows are zeroed, so NULL keys are peers.
``window_bounds`` (K10a) finds every sorted row's partition and peer
group from exact key equality on that matrix, and ``window_frame`` (K10b)
computes the function and writes it back in input order. Calls with the
same PARTITION BY and ORDER BY share one sort.

Two JAX faults are not copied (ROADMAP Queue 3): a string ORDER BY key
orders by its first 8 bytes and PARTITION BY keys on an unverified 64-bit
hash (F19, F20; here every byte of every key counts), and window SUM/AVG
of a float32 column take float32 prefix sums (F22; here float64). A
string or dictionary argument raises PlanError, as a string one does in
the JAX package (a dictionary's codes there come out as text, which pyarrow
refuses), and so does a RANGE frame over a non-numeric key.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import torch

from ..batch import Batch, DictColumn, FixedColumn, Schema, VarColumn, \
    empty_batch
from ..errors import PlanError
from ..kernels.sort_keys import sort_keys
from ..kernels.window_bounds import window_bounds
from ..kernels.window_frame import (AGG_FNS, PICK_FNS, RANGE, RANK_FNS, ROWS,
                                    SHIFT_FNS, Frame, window_frame)
from .expressions import (NullsOrder, WindowCall, _as_values, _full,
                          _torch_dtype, _validity_of, eval_expr)
from .physical import PhysicalPlan, concat_batches, sort_key_specs

# the 16 names of exon_tpu/plan/window_exec.py:37, by window_frame's mode
WINDOW_FUNCS = set(RANK_FNS + SHIFT_FNS + PICK_FNS + AGG_FNS)


@dataclasses.dataclass
class WindowExec(PhysicalPlan):
    calls: list
    names: list
    out_schema: Schema
    input: PhysicalPlan
    device: object = "cpu"

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        for call in self.calls:
            if call.fn not in WINDOW_FUNCS:
                raise PlanError(f"window function {call.fn!r} unsupported")
        in_schema = self.input.schema()
        combined = concat_batches(in_schema, list(self.input.batches()),
                                  self.device)
        if combined.length == 0:
            yield empty_batch(self.out_schema).to_device(combined.device)
            return
        fields = self.out_schema.all_fields[len(in_schema.all_fields):]
        cols = list(combined.columns)
        sorts: dict = {}
        for call, f in zip(self.calls, fields):
            key = repr((call.partition_by, call.order_by))
            if key not in sorts:
                sorts[key] = _sorted_bounds(call, combined)
            cols.append(_window_column(call, combined, *sorts[key], f))
        yield Batch(self.out_schema, cols, combined.length, combined.device)


def sort_rows(call: WindowCall, batch: Batch) -> tuple:
    """(perm, keys, n_part): the rows in (PARTITION BY, ORDER BY) order,
    ties in input order; the int64 key matrix in that order (without
    sort_keys' padding row); how many of its rows are partition keys."""
    keys = [(e, True) for e in call.partition_by] + list(call.order_by)
    n = batch.length
    specs = sort_key_specs(keys, batch)
    mat = sort_keys(specs, n, batch.device)[1:]
    row = 0
    for s in specs:
        # a NULL key's value rows hold 0: NULLs are peers of each other
        mat[row + 1: row + s.rows] = torch.where(
            s.validity, mat[row + 1: row + s.rows], 0)
        row += s.rows
    perm = torch.arange(n, device=batch.device)
    for k in reversed(mat):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    n_part = sum(s.rows for s in specs[:len(call.partition_by)])
    return perm, mat[:, perm], n_part


def _sorted_bounds(call: WindowCall, batch: Batch) -> tuple:
    """(perm, bounds): the sorted rows and each one's partition and peer
    bounds."""
    perm, keys, n_part = sort_rows(call, batch)
    return perm, window_bounds(keys, n_part)


def _values(call: WindowCall, batch: Batch):
    """(values, validity) of the call's argument, fixed-width."""
    v = eval_expr(call.child, batch)
    vals = _as_values(v, batch)  # a string column raises PlanError here
    if isinstance(v, DictColumn):
        raise PlanError("string column used in numeric context")
    if not isinstance(vals, torch.Tensor):
        vals = _full(batch.capacity, vals, batch.device)
    return vals, _validity_of(v, batch)


def _frame(call: WindowCall, batch: Batch, perm: torch.Tensor) -> Frame:
    kind, lo, hi = call.frame
    if kind == "rows":
        return Frame(ROWS, lo, hi)
    # RANGE offsets are value offsets on the single ORDER BY key
    if len(call.order_by) != 1:
        raise PlanError("RANGE frame offsets require exactly one ORDER BY "
                        "key")
    e0, asc0 = call.order_by[0]
    if isinstance(e0, NullsOrder):
        e0 = e0.child
    v0 = eval_expr(e0, batch)
    if isinstance(v0, (VarColumn, DictColumn)) or \
            not isinstance(v0, (FixedColumn, torch.Tensor)):
        raise PlanError("RANGE frame ORDER BY key must be numeric")
    nums = _as_values(v0, batch)
    if nums.dtype == torch.bool:
        raise PlanError("RANGE frame ORDER BY key must be numeric")
    if not nums.dtype.is_floating_point:
        nums = nums.to(torch.int64)
    elif nums.dtype != torch.float32:
        nums = nums.to(torch.float64)
    # a DESC key is negated to ascending (an INT64_MIN key would overflow,
    # as in the JAX package)
    key = nums[perm] if asc0 else -nums[perm]
    return Frame(RANGE, lo, hi, key.contiguous(),
                 _validity_of(v0, batch)[perm].contiguous())


def _window_column(call: WindowCall, batch: Batch, perm: torch.Tensor,
                   bounds: tuple, field) -> FixedColumn:
    fn = call.fn
    values = valid = frame = None
    if fn not in RANK_FNS and call.child is not None:
        values, valid = _values(call, batch)
    if call.frame is not None and fn in AGG_FNS + PICK_FNS:
        frame = _frame(call, batch, perm)
    if fn in SHIFT_FNS + PICK_FNS + AGG_FNS and fn != "count" and \
            values is None:
        raise PlanError(f"window function {fn} needs an argument")
    res, ok = window_frame(fn, bounds, perm, values, valid, frame,
                           call.offset, call.default)
    return FixedColumn(res.to(_torch_dtype(field.dtype)), ok)
