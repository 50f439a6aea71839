"""Expression trees and their evaluation over torch batches.

Counterpart of exon_tpu/plan/expressions.py: the ``Expr`` classes and
helpers (:29-375, with the JAX field names, so that the SQL parser's trees
have the same ``repr``), ``eval_expr`` (:408) for column refs, literals,
aliases, comparison / arithmetic / boolean operators with NULL propagation
and literal folding (:624), NOT, IS NULL, LIKE (:428-436), IN lists, CASE
(:495), CAST (:799) and function calls through the function registry
(``register_function``/``get_function``, :387-405, which also holds each
function's return type: a fixed type, or a callable of the argument types
as exon_tpu/plan/planner.py ``register_function_type`` :25-31 keeps them;
filled by the port's udfs.py and ops/sqlfuncs.py), and
``split_conjunction``/``conjoin`` (:1032,1038). Dictionary columns compare
and cast through their host vocabulary, as ops/strings.py:290 and
expressions.py:571 do. Ordered compares of a var-width column with a
literal run the string_cmp kernel, ``=``/``!=`` of two var-width columns
the string_eq kernel (``_string_col_eq`` :763), CAST of strings to numbers
the parse_number kernel and CAST of integers to strings the format_int
kernel. An ordered compare of two string columns raises PlanError, as in
the JAX package (:676-679). ``a.b``, ``a['k']`` and ``a[1]`` (:461-489)
take a struct's field, a map's value (``_map_lookup`` :716: the map_lookup
kernel finds each row's first entry with the key, the list take of
ops/layout.py gathers its value) or a list's 1-based element
(``_list_element`` :745, an index gather of the child); a missing key or an
element out of range is NULL. A name neither package knows raises
PlanError, and so does a window call met outside a Window node (WindowExec
computes them).

Two JAX faults are not copied (ROADMAP Queue 3): a NULL row never passes a
string compare (F8: the JAX var compares treat it as '', and its ``!=`` of
two columns passes NULL rows), and an ordered compare of a dictionary
column with a literal outside its vocabulary compares the strings (F9: the
JAX rank lookup is approximate). Two string columns compare in every byte,
not a 32-byte prefix and the length (F6). IS NULL reads a list's own
validity, where the JAX ``_validity_of`` (:581) calls every list valid
(F25).

Evaluation returns a Column, a torch tensor of per-row values (all valid),
or a Python scalar (a literal).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np
import torch

from .. import datatypes as dt
from ..batch import (Batch, DictColumn, FixedColumn, ListColumn,
                     StructColumn, VarColumn)
from ..errors import PlanError
from ..kernels.format_int import format_int
from ..kernels.map_lookup import map_lookup
from ..kernels.parse_number import parse_number
from ..kernels.string_cmp import string_cmp
from ..kernels.string_eq import string_eq
from ..ops import layout as layout_ops
from ..ops import strings as str_ops


class Expr:
    """Base expression node."""

    def __eq__(self, other):  # type: ignore[override]
        return BinaryOp("=", self, lit(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinaryOp("!=", self, lit(other))

    def __lt__(self, other):
        return BinaryOp("<", self, lit(other))

    def __le__(self, other):
        return BinaryOp("<=", self, lit(other))

    def __gt__(self, other):
        return BinaryOp(">", self, lit(other))

    def __ge__(self, other):
        return BinaryOp(">=", self, lit(other))

    def __and__(self, other):
        return BinaryOp("and", self, lit(other))

    def __or__(self, other):
        return BinaryOp("or", self, lit(other))

    def __invert__(self):
        return Not(self)

    def __add__(self, other):
        return BinaryOp("+", self, lit(other))

    def __sub__(self, other):
        return BinaryOp("-", self, lit(other))

    def __mul__(self, other):
        return BinaryOp("*", self, lit(other))

    def __truediv__(self, other):
        return BinaryOp("/", self, lit(other))

    def __mod__(self, other):
        return BinaryOp("%", self, lit(other))

    def __hash__(self):
        return hash(repr(self))

    def like(self, pattern: str, escape: Optional[str] = None):
        return Like(self, pattern, case_insensitive=False, escape=escape)

    def ilike(self, pattern: str, escape: Optional[str] = None):
        return Like(self, pattern, case_insensitive=True, escape=escape)

    def is_null(self):
        return IsNull(self, negated=False)

    def is_not_null(self):
        return IsNull(self, negated=True)

    def isin(self, values: list):
        return InList(self, [lit(v) for v in values])

    def between(self, low, high):
        return BinaryOp("and", BinaryOp(">=", self, lit(low)),
                        BinaryOp("<=", self, lit(high)))

    def alias(self, name: str):
        return Alias(self, name)

    def children(self) -> list["Expr"]:
        return []

    def display_name(self) -> str:
        return repr(self)


def lit(v) -> Expr:
    if isinstance(v, Expr):
        return v
    return Literal(v)


def col(name: str) -> "ColumnRef":
    return ColumnRef(name)


@dataclasses.dataclass(repr=True, eq=False)
class ColumnRef(Expr):
    name: str

    def display_name(self) -> str:
        return self.name


@dataclasses.dataclass(eq=False)
class FieldAccess(Expr):
    """Struct-field extraction ``tags."PG"``, parsed for every dotted
    identifier; the planner turns a table qualifier back into a ColumnRef
    (exon_tpu/plan/expressions.py:129)."""

    child: Expr
    field: str

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return self.field


@dataclasses.dataclass(eq=False)
class Subscript(Expr):
    """``expr[index]``: map value, list element or struct field
    (exon_tpu/plan/expressions.py:145)."""

    child: Expr
    index: Expr

    def children(self):
        return [self.child, self.index]

    def display_name(self) -> str:
        return f"{self.child.display_name()}[{self.index.display_name()}]"


@dataclasses.dataclass(eq=False)
class Literal(Expr):
    value: Any

    def display_name(self) -> str:
        if isinstance(self.value, str):
            return f"Utf8(\"{self.value}\")"
        return str(self.value)


@dataclasses.dataclass(eq=False)
class Alias(Expr):
    child: Expr
    name: str

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return self.name


@dataclasses.dataclass(eq=False)
class BinaryOp(Expr):
    op: str  # = != < <= > >= and or + - * / %
    left: Expr
    right: Expr

    def children(self):
        return [self.left, self.right]

    def display_name(self) -> str:
        return f"{self.left.display_name()} {self.op} {self.right.display_name()}"


@dataclasses.dataclass(eq=False)
class Not(Expr):
    child: Expr

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class IsNull(Expr):
    child: Expr
    negated: bool

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class Like(Expr):
    child: Expr
    pattern: str
    case_insensitive: bool
    negated: bool = False
    escape: Optional[str] = None

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class InList(Expr):
    child: Expr
    values: list
    negated: bool = False

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class Cast(Expr):
    child: Expr
    dtype: dt.DataType

    def children(self):
        return [self.child]


@dataclasses.dataclass(eq=False)
class FunctionCall(Expr):
    name: str
    args: list

    def children(self):
        return list(self.args)

    def display_name(self) -> str:
        return f"{self.name}({', '.join(a.display_name() for a in self.args)})"


@dataclasses.dataclass(eq=False)
class NullsOrder(Expr):
    """ORDER BY key wrapper carrying an explicit NULLS FIRST/LAST
    (exon_tpu/plan/expressions.py:297). The sort unwraps it; it is never
    evaluated as a value."""

    child: Expr
    first: bool

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return (self.child.display_name()
                + (" nulls first" if self.first else " nulls last"))


@dataclasses.dataclass(eq=False)
class AggregateCall(Expr):
    """count(*) / count(x) / sum / min / max / avg over an optional child."""

    fn: str
    child: Optional[Expr]  # None → count(*)
    distinct: bool = False
    # extra literal arguments (e.g. string_agg separator)
    extra: tuple = ()

    def children(self):
        return [self.child] if self.child is not None else []

    def display_name(self) -> str:
        inner = self.child.display_name() if self.child else "*"
        return f"{self.fn}({inner})"


@dataclasses.dataclass(repr=True, eq=False)
class Case(Expr):
    """CASE [operand] WHEN … THEN … [ELSE …] END
    (exon_tpu/plan/expressions.py:273): a chain of ``torch.where``s; string
    literal results become a DictColumn whose codes select the branch."""

    operand: Optional[Expr]
    whens: list  # [(when_expr, then_expr)]
    else_: Optional[Expr]

    def children(self):
        out = [self.operand] if self.operand is not None else []
        for w, t in self.whens:
            out.extend([w, t])
        if self.else_ is not None:
            out.append(self.else_)
        return out

    def display_name(self) -> str:
        return "case"


@dataclasses.dataclass(repr=True, eq=False)
class WindowCall(Expr):
    """fn(...) OVER (PARTITION BY … [ORDER BY …])
    (exon_tpu/plan/expressions.py:313); planned into a Window node and
    computed by WindowExec, never evaluated directly."""

    fn: str
    child: Optional[Expr]
    partition_by: list
    order_by: list  # [(expr, asc)]
    offset: int = 1      # lag/lead offset; ntile bucket count
    default: object = None
    # None = the default frame (RANGE UNBOUNDED PRECEDING .. CURRENT ROW,
    # peers share), or ("rows" | "range", lo, hi): row or value offsets
    # relative to the current row (None = unbounded, negative = preceding)
    frame: object = None

    def children(self):
        out = [self.child] if self.child is not None else []
        out.extend(self.partition_by)
        out.extend(e for e, _ in self.order_by)
        return out

    def display_name(self) -> str:
        inner = self.child.display_name() if self.child else ""
        return f"{self.fn}({inner}) over(…)"


@dataclasses.dataclass(repr=True, eq=False)
class Subquery(Expr):
    """Scalar subquery, resolved by the SQL frontend before planning."""

    stmt: object  # sql.ast.SelectStmt

    def children(self):
        return []

    def display_name(self) -> str:
        return "(subquery)"


@dataclasses.dataclass(repr=True, eq=False)
class ExistsSubquery(Expr):
    stmt: object
    negated: bool = False

    def children(self):
        return []

    def display_name(self) -> str:
        return "exists(subquery)"


@dataclasses.dataclass(repr=True, eq=False)
class InSubquery(Expr):
    child: Expr
    stmt: object
    negated: bool = False

    def children(self):
        return [self.child]

    def display_name(self) -> str:
        return "in(subquery)"


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

ScalarFn = Callable[..., Any]
# each name's function and the type it returns: a DataType, or a callable
# of the non-literal arguments' Fields that gives one
_FUNCTIONS: dict[str, tuple[ScalarFn, Any]] = {}
# names the JAX package registers that the port does not carry yet, each
# with its ROADMAP item
_NOT_PORTED: dict[str, str] = {}


def register_function(name: str, fn: ScalarFn, dtype) -> None:
    """``fn(batch, *args)``, whose values have type ``dtype``: a DataType,
    or ``dtype(arg_fields)`` of the Fields of its non-literal arguments."""
    _FUNCTIONS[name.lower()] = (fn, dtype)


def register_not_ported(names, item: str) -> None:
    for name in names:
        _NOT_PORTED[name.lower()] = item


def get_function(name: str) -> tuple[ScalarFn, Any]:
    """The registered function and its return type; NotImplementedError
    naming the ROADMAP item for a JAX function the port does not carry,
    PlanError for a name that neither package knows."""
    entry = _FUNCTIONS.get(name.lower())
    if entry is not None:
        return entry
    item = _NOT_PORTED.get(name.lower())
    if item is not None:
        raise NotImplementedError(f"function {name!r} is not ported yet "
                                  f"(ROADMAP Queue 1, {item})")
    raise PlanError(f"unknown function {name!r}")


def eval_expr(expr: Expr, batch: Batch):
    """Evaluate an expression against a batch (on any device)."""
    if isinstance(expr, Alias):
        return eval_expr(expr.child, batch)
    if isinstance(expr, ColumnRef):
        return batch.column(expr.name)
    if isinstance(expr, Literal):
        return expr.value
    if isinstance(expr, BinaryOp):
        return _eval_binary(expr, batch)
    if isinstance(expr, Not):
        return ~as_bool_mask(eval_expr(expr.child, batch), batch)
    if isinstance(expr, IsNull):
        nulls = ~_validity_of(eval_expr(expr.child, batch), batch)
        return ~nulls if expr.negated else nulls
    if isinstance(expr, Like):
        v = eval_expr(expr.child, batch)
        if isinstance(v, DictColumn):
            m = str_ops.dict_like(v, expr.pattern, expr.case_insensitive,
                                  expr.escape)
        elif isinstance(v, VarColumn):
            m = str_ops.like(v, expr.pattern, expr.case_insensitive,
                             expr.escape)
        else:
            raise PlanError(f"LIKE over non-string value: {expr}")
        return ~m if expr.negated else m
    if isinstance(expr, InList):
        v = eval_expr(expr.child, batch)
        vals = [x.value if isinstance(x, Literal) else x for x in expr.values]
        if isinstance(v, DictColumn):
            m = str_ops.dict_isin(v, [str(x) for x in vals])
        elif isinstance(v, VarColumn):
            m = torch.zeros(v.capacity, dtype=torch.bool,
                            device=v.offsets.device)
            for x in vals:
                m |= str_ops.equals_literal(v, str(x).encode())
        else:
            arr = _as_values(v, batch)
            m = torch.zeros(arr.shape[0], dtype=torch.bool, device=arr.device)
            for x in vals:
                m |= arr == x
        return ~m if expr.negated else m
    if isinstance(expr, Cast):
        return _eval_cast(eval_expr(expr.child, batch), expr.dtype, batch)
    if isinstance(expr, Case):
        return _eval_case(expr, batch)
    if isinstance(expr, FunctionCall):
        fn, _dtype = get_function(expr.name)
        return fn(batch, *[eval_expr(a, batch) for a in expr.args])
    if isinstance(expr, FieldAccess):
        v = eval_expr(expr.child, batch)
        if isinstance(v, StructColumn):
            child = v.children.get(expr.field)
            if child is None:
                raise PlanError(f"no struct field {expr.field!r}; have "
                                f"{sorted(v.children)}")
            return child
        if isinstance(v, ListColumn) and _is_map_col(v):
            return _map_lookup(v, expr.field)
        raise PlanError(f"field access on non-struct value: {expr!r}")
    if isinstance(expr, Subscript):
        v = eval_expr(expr.child, batch)
        if not isinstance(expr.index, Literal):
            raise PlanError("subscript index must be a literal")
        iv = expr.index.value
        if isinstance(v, StructColumn) and isinstance(iv, str):
            child = v.children.get(iv)
            if child is None:
                raise PlanError(f"no struct field {iv!r}")
            return child
        if isinstance(v, ListColumn):
            if _is_map_col(v) and isinstance(iv, str):
                return _map_lookup(v, iv)
            if isinstance(iv, (int, np.integer)) and not isinstance(iv, bool):
                return _list_element(v, int(iv))
        raise PlanError(
            f"subscript {iv!r} unsupported on {type(v).__name__}")
    if isinstance(expr, WindowCall):
        raise PlanError(
            f"window function {expr.fn} outside a Window node: the planner "
            "moves window calls into a WindowExec")
    raise PlanError(f"cannot evaluate {expr!r}")


def _full(n: int, v, device) -> torch.Tensor:
    """A column of one Python scalar, typed as the JAX package types it
    under x64 (bool, int64, float64)."""
    dtype = torch.bool if isinstance(v, (bool, np.bool_)) else \
        torch.float64 if isinstance(v, (float, np.floating)) else torch.int64
    return torch.full((n,), v, dtype=dtype, device=device)


def _eval_case(expr: Case, batch: Batch):
    """One where-chain, first true branch wins (exon_tpu/plan/expressions.py
    :495-568). String THEN/ELSE literals become a DictColumn whose vocab is
    in order of first appearance."""
    cap, dev = batch.capacity, batch.device
    conds = []
    for w, _t in expr.whens:
        c = BinaryOp("=", expr.operand, w) if expr.operand is not None else w
        conds.append(as_bool_mask(eval_expr(c, batch), batch))
    results = [t for _w, t in expr.whens]
    if expr.else_ is not None:
        results.append(expr.else_)

    def is_str_lit(e):
        return isinstance(e, Literal) and (isinstance(e.value, str)
                                           or e.value is None)

    if results and all(is_str_lit(r) for r in results):
        vocab: list = []
        codes_for = []
        for r in results:
            if r.value is None:
                codes_for.append(-1)
            else:
                if r.value not in vocab:
                    vocab.append(r.value)
                codes_for.append(vocab.index(r.value))
        else_code = codes_for[-1] if expr.else_ is not None else -1
        codes = torch.full((cap,), else_code, dtype=torch.int32, device=dev)
        valid = torch.full((cap,), else_code >= 0, dtype=torch.bool,
                           device=dev)
        taken = torch.zeros(cap, dtype=torch.bool, device=dev)
        for m, code in zip(conds, codes_for):
            pick = m & ~taken
            codes = torch.where(pick, code, codes)
            valid = torch.where(pick, code >= 0, valid)
            taken = taken | m
        return DictColumn(codes.clamp(0, max(len(vocab) - 1, 0)),
                          valid & batch.row_mask(), tuple(vocab))

    # numeric / boolean path
    vals_valid = []
    for r in results:
        v = eval_expr(r, batch)
        if isinstance(v, (VarColumn, DictColumn)):
            raise PlanError("CASE with non-literal string results "
                            "is not supported")
        arr = _as_values(v, batch)
        if not isinstance(arr, torch.Tensor):
            if isinstance(r, Literal) and r.value is None:
                # jnp.zeros(cap): float64 under x64
                vals_valid.append((torch.zeros(cap, dtype=torch.float64,
                                               device=dev),
                                   torch.zeros(cap, dtype=torch.bool,
                                               device=dev)))
                continue
            arr = _full(cap, arr, dev)
        vals_valid.append((arr, _validity_of(v, batch)))
    out_dt = vals_valid[0][0].dtype
    for a, _v in vals_valid[1:]:
        out_dt = torch.promote_types(out_dt, a.dtype)
    if expr.else_ is not None:
        out, valid = vals_valid[-1]
        out = out.to(out_dt)
        branch_vv = vals_valid[:-1]
    else:
        out = torch.zeros(cap, dtype=out_dt, device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        branch_vv = vals_valid
    taken = torch.zeros(cap, dtype=torch.bool, device=dev)
    for m, (arr, av) in zip(conds, branch_vv):
        pick = m & ~taken
        out = torch.where(pick, arr.to(out_dt), out)
        valid = torch.where(pick, av, valid)
        taken = taken | m
    return FixedColumn(out, valid & batch.row_mask())


_TORCH_DTYPES = {
    dt.TypeKind.INT8: torch.int8, dt.TypeKind.INT16: torch.int16,
    dt.TypeKind.INT32: torch.int32, dt.TypeKind.INT64: torch.int64,
    dt.TypeKind.UINT8: torch.uint8, dt.TypeKind.FLOAT32: torch.float32,
    dt.TypeKind.FLOAT64: torch.float64, dt.TypeKind.BOOL: torch.bool,
}


def _torch_dtype(dtype: dt.DataType) -> torch.dtype:
    tdt = _TORCH_DTYPES.get(dtype.kind)
    if tdt is None:
        raise NotImplementedError(
            f"CAST to {dtype} is not ported yet (ROADMAP Queue 1, item 2)")
    return tdt


def _eval_cast(v, dtype: dt.DataType, batch: Batch):
    """CAST (exon_tpu/plan/expressions.py:799-843). Literals cast on the
    host; strings parse on the parse_number kernel (a dictionary column
    through its vocabulary, then its codes); integers and booleans format
    on the format_int kernel."""
    from ..datatypes import numpy_dtype

    is_utf8 = dtype.kind in (dt.TypeKind.UTF8, dt.TypeKind.LARGE_UTF8)
    if isinstance(v, str):
        if dtype.is_fixed_width:
            npdt = numpy_dtype(dtype)
            try:
                return np.asarray(
                    float(v) if np.issubdtype(npdt, np.floating)
                    else int(v), dtype=npdt).item()
            except ValueError:
                raise PlanError(
                    f"cannot cast string '{v}' to {dtype}") from None
        return v
    if isinstance(v, (int, float, bool)):
        if is_utf8:
            if isinstance(v, bool):
                return "true" if v else "false"
            return str(v)
        if dtype.is_fixed_width:
            return np.asarray(v).astype(numpy_dtype(dtype)).item()
    if dtype.is_fixed_width and isinstance(v, DictColumn):
        return _cast_dict_to_number(v, dtype)
    if isinstance(v, DictColumn):
        v = layout_ops.dict_to_var(v)
    if dtype.is_fixed_width and isinstance(v, VarColumn):
        return _cast_utf8_to_number(v, dtype)
    if is_utf8:
        if isinstance(v, VarColumn):
            return v
        vals = _as_values(v, batch)
        if not isinstance(vals, torch.Tensor) or \
                vals.dtype.is_floating_point:
            raise PlanError("cast of floats to VARCHAR not supported on "
                            "device")
        offsets, values = format_int(vals.to(torch.int64),
                                     _validity_of(v, batch))
        return VarColumn(values, offsets, _validity_of(v, batch))
    if dtype.is_fixed_width:
        arr = _as_values(v, batch)
        out = arr.to(_torch_dtype(dtype))
        if isinstance(v, FixedColumn):
            # a cast carries NULLs through
            return FixedColumn(out, v.validity)
        return out
    raise PlanError(f"cast to {dtype} not supported on device")


def _cast_utf8_to_number(v: VarColumn, dtype: dt.DataType) -> FixedColumn:
    """parse_number in int or float mode, then the JAX ``astype`` to the
    target (exon_tpu/plan/expressions.py:951-986)."""
    tdt = _torch_dtype(dtype)
    vals, ok = parse_number(v.offsets, v.values, v.validity,
                            tdt.is_floating_point)
    return FixedColumn(vals.to(tdt), ok)


def _cast_dict_to_number(v: DictColumn, dtype: dt.DataType) -> FixedColumn:
    """Parse the vocabulary once, by the same kernel and rules, then map
    the codes: the JAX ``dict_to_var`` + parse gives the same values."""
    dev = v.codes.device
    enc = [s.encode() for s in v.vocab]
    offs = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    flat = np.frombuffer(b"".join(enc), np.uint8).copy()
    vocab = VarColumn(torch.from_numpy(flat).to(dev),
                      torch.from_numpy(offs).to(dev),
                      torch.ones(len(enc), dtype=torch.bool, device=dev))
    parsed = _cast_utf8_to_number(vocab, dtype)
    if not enc:
        return FixedColumn(torch.zeros(v.capacity, device=dev,
                                       dtype=_torch_dtype(dtype)),
                           torch.zeros(v.capacity, dtype=torch.bool,
                                       device=dev))
    codes = v.codes.long().clamp(0, len(enc) - 1)
    ok = parsed.validity[codes] & v.validity
    zero = torch.zeros((), dtype=parsed.values.dtype, device=dev)
    return FixedColumn(torch.where(ok, parsed.values[codes], zero), ok)


def _is_map_col(v: ListColumn) -> bool:
    return isinstance(v.child, StructColumn) and \
        set(v.child.children) in ({"key", "value"}, {"keys", "values"})


def _map_lookup(v: ListColumn, key: str):
    """Each row's value for a string key, NULL where the key is absent or
    the map NULL (exon_tpu/plan/expressions.py:716): the map_lookup kernel
    gives each row's first entry with the key, the list take of the value
    column gathers it."""
    kname = "key" if "key" in v.child.children else "keys"
    kcol = v.child.children[kname]
    if isinstance(kcol, DictColumn):
        kcol = layout_ops.dict_to_var(kcol)
    if not isinstance(kcol, VarColumn):
        raise PlanError("map keys must be strings")
    vcol = v.child.children["value" if kname == "key" else "values"]
    if vcol.capacity == 0:  # no entry at all
        return _all_null(vcol, v.capacity)
    first = map_lookup(v.offsets, kcol.offsets, kcol.values, kcol.validity,
                       key.encode())
    found = (first >= 0) & v.validity
    out = layout_ops.take_column(vcol, first.clamp(min=0))
    return layout_ops.null_where(out, ~found)


def _all_null(like, n: int):
    """n NULL rows of the layout and type of the column ``like``."""
    from ..batch import empty_like

    return Batch(None, [empty_like(like, n)], n).to_device(
        like.validity.device).columns[0]


def _list_element(v: ListColumn, i: int):
    """1-based list element (DataFusion array indexing); out of range or a
    non-positive index gives NULL (exon_tpu/plan/expressions.py:745)."""
    if v.child.capacity == 0:  # no element to gather
        return _all_null(v.child, v.capacity)
    offs = v.offsets
    lens = offs[1:] - offs[:-1]
    ok = v.validity & (lens >= i) if i >= 1 else torch.zeros_like(v.validity)
    idx = (offs[:-1] + (i - 1)).clamp(0, v.child.capacity - 1)
    out = layout_ops.take_column(v.child, idx.to(torch.int32))
    return layout_ops.null_where(out, ~ok)


def _validity_of(v, batch: Batch) -> torch.Tensor:
    if isinstance(v, (FixedColumn, VarColumn, DictColumn, ListColumn,
                      StructColumn)):
        return v.validity
    if isinstance(v, torch.Tensor):
        return torch.ones(v.shape[0], dtype=torch.bool, device=v.device)
    return torch.ones(batch.capacity, dtype=torch.bool, device=batch.device)


def _as_values(v, batch: Batch):
    """Per-row values of a fixed-width operand (or a Python scalar)."""
    if isinstance(v, FixedColumn):
        return v.values
    if isinstance(v, DictColumn):
        return v.codes
    if isinstance(v, (torch.Tensor, int, float, bool)):
        return v
    if isinstance(v, VarColumn):
        raise PlanError("string column used in numeric context")
    raise PlanError(f"cannot coerce {type(v)}")


def as_bool_mask(v, batch: Batch) -> torch.Tensor:
    if isinstance(v, bool):
        return torch.full((batch.capacity,), v, dtype=torch.bool,
                          device=batch.device)
    if isinstance(v, FixedColumn):
        return v.values.bool() & v.validity
    return v.bool()


_CMP = {"=": lambda a, b: a == b, "!=": lambda a, b: a != b,
        "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
        ">": lambda a, b: a > b, ">=": lambda a, b: a >= b}


def _is_scalar(x) -> bool:
    return isinstance(x, (int, float, bool))


def _weak_float(a, b):
    """A Python float with an integer or boolean column computes in
    float64, as JAX's weakly typed float literal does under x64 (torch
    would take its float32 default)."""
    def widen(x, other):
        if isinstance(other, float) and isinstance(x, torch.Tensor) and \
                not x.dtype.is_floating_point:
            return x.to(torch.float64)
        return x

    return widen(a, b), widen(b, a)


def _arith(op: str, a, b):
    a, b = _weak_float(a, b)
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if _is_scalar(a) and _is_scalar(b):
        return _fold(op, a, b)
    floating = any(isinstance(x, float) or (isinstance(x, torch.Tensor)
                                            and x.dtype.is_floating_point)
                   for x in (a, b))
    if op == "/":
        if floating:
            return a / b
        # SQL integer division truncates; a zero divisor yields 0
        safe = torch.where(torch.as_tensor(b) == 0, 1, b)
        return torch.div(a, safe, rounding_mode="trunc").to(torch.int64)
    if op == "%":
        # SQL %: the sign follows the dividend; a zero divisor yields 0
        safe = torch.where(torch.as_tensor(b) == 0, 1, b)
        return torch.fmod(torch.as_tensor(a), safe)
    raise PlanError(f"unknown operator {op}")


def _fold(op: str, a, b):
    """'/' and '%' of two literals, with the JAX package's arithmetic
    (exon_tpu/plan/expressions.py:646-658): integer division divides as
    doubles and truncates, a zero divisor becomes 1, and the remainder takes
    the dividend's sign."""
    floating = isinstance(a, float) or isinstance(b, float)
    if op == "/":
        if not floating:
            return int(np.float64(a) / np.float64(b if b != 0 else 1))
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float64(a) / np.float64(b))
    bz = b if b != 0 else (1.0 if isinstance(b, float) else 1)
    r = np.remainder(a, bz)
    if r != 0 and np.sign(a) != np.sign(bz):
        r = r - bz
    return r.item() if isinstance(r, np.generic) else r


def _eval_binary(expr: BinaryOp, batch: Batch):
    op = expr.op
    if op in ("and", "or"):
        lm = as_bool_mask(eval_expr(expr.left, batch), batch)
        rm = as_bool_mask(eval_expr(expr.right, batch), batch)
        return lm & rm if op == "and" else lm | rm
    lv = eval_expr(expr.left, batch)
    rv = eval_expr(expr.right, batch)
    if op in _CMP:
        lstr = isinstance(lv, (VarColumn, DictColumn, str))
        rstr = isinstance(rv, (VarColumn, DictColumn, str))
        if lstr or rstr:
            return _eval_string_cmp(op, lv, rv)
        m = _CMP[op](*_weak_float(_as_values(lv, batch),
                                  _as_values(rv, batch)))
        valid = _validity_of(lv, batch) & _validity_of(rv, batch)
        if _is_scalar(m):
            return torch.full((batch.capacity,), m, dtype=torch.bool,
                              device=batch.device) & valid
        return m & valid
    a, b = _as_values(lv, batch), _as_values(rv, batch)
    out = _arith(op, a, b)
    if _is_scalar(out):
        return out  # literal folding
    # NULL propagation: a NULL operand nulls the result row
    return FixedColumn(out, _validity_of(lv, batch) & _validity_of(rv, batch))


def _eval_string_cmp(op: str, lv, rv):
    """A string column against a literal or another string column
    (exon_tpu/plan/expressions.py :670-703). NULL rows never pass (F8); a
    dictionary column's ordered compare compares its vocabulary strings on
    the host (F9); two columns compare for ``=``/``!=`` only."""
    swap = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=", "!=": "!="}
    if isinstance(lv, str):
        lv, rv, op = rv, lv, swap[op]
    if not isinstance(rv, str):
        if op in ("=", "!="):
            m = _string_col_eq(lv, rv)
            if op == "=":
                return m
            return ~m & _validity_of(lv, None) & _validity_of(rv, None)
        raise PlanError(
            "ordered compare between two string columns unsupported")
    if isinstance(lv, DictColumn):
        if op == "=":
            return str_ops.dict_equals(lv, rv)
        if op == "!=":
            return ~str_ops.dict_equals(lv, rv) & lv.validity
        lit, cmp = rv.encode(), _CMP[op]
        hits = [i for i, s in enumerate(lv.vocab) if cmp(s.encode(), lit)]
        return str_ops.vocab_mask(lv, hits) & lv.validity
    if isinstance(lv, VarColumn):
        if op in ("=", "!="):
            m = str_ops.equals_literal(lv, rv.encode())
            return (~m if op == "!=" else m) & lv.validity
        return string_cmp(lv.offsets, lv.values, lv.validity, rv.encode(), op)
    raise PlanError(f"string compare over {type(lv)}")


def _string_col_eq(a, b) -> torch.Tensor:
    """Row-by-row equality of two string columns, both rows valid
    (exon_tpu/plan/expressions.py:763): two dictionary columns of one
    vocabulary by their codes, two var-width columns by every byte
    (string_eq); any other pair raises, as in the JAX package."""
    if isinstance(a, DictColumn) and isinstance(b, DictColumn) and \
            a.vocab == b.vocab:
        return (a.codes == b.codes) & a.validity & b.validity
    if isinstance(a, VarColumn) and isinstance(b, VarColumn):
        rows = torch.arange(a.capacity, dtype=torch.int32,
                            device=a.offsets.device)
        return string_eq((a.offsets, a.values, a.validity), rows,
                         (b.offsets, b.values, b.validity), rows)
    raise PlanError("unsupported string column equality")


# ---------------------------------------------------------------------------
# Expression utilities for the planner
# ---------------------------------------------------------------------------


def expr_columns(expr: Expr) -> set[str]:
    out: set[str] = set()

    def walk(e: Expr):
        if isinstance(e, ColumnRef):
            out.add(e.name)
        for c in e.children():
            walk(c)

    walk(expr)
    return out


def split_conjunction(expr: Expr) -> list[Expr]:
    if isinstance(expr, BinaryOp) and expr.op == "and":
        return split_conjunction(expr.left) + split_conjunction(expr.right)
    return [expr]


def conjoin(exprs: list[Expr]) -> Optional[Expr]:
    if not exprs:
        return None
    out = exprs[0]
    for e in exprs[1:]:
        out = BinaryOp("and", out, e)
    return out
