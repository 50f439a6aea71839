"""Expression trees and their evaluation over torch batches.

Counterpart of exon_tpu/plan/expressions.py: the ``Expr`` classes and
builders (:29-120) and ``eval_expr`` (:408) for column refs, literals,
aliases, comparison / arithmetic / boolean operators with NULL propagation
(:624), NOT, IS NULL, LIKE (:428-436), IN lists and ``length()`` (a UDF in
exon_tpu/udfs.py:155). Dictionary columns compare through their host
vocabulary, as ops/strings.py:290 and expressions.py:571 do. Expressions the
slice does not carry (CASE, CAST, map/struct access, ordered string compares,
the other UDFs) raise NotImplementedError naming their ROADMAP item.

Evaluation returns a Column, a torch tensor of per-row values (all valid),
or a Python scalar (a literal).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..batch import Batch, DictColumn, FixedColumn, VarColumn
from ..errors import PlanError
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

    def children(self):
        return [self.child] if self.child is not None else []

    def display_name(self) -> str:
        inner = self.child.display_name() if self.child else "*"
        return f"{self.fn}({inner})"


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

LENGTH_FUNCTIONS = ("length", "char_length", "character_length")


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
    if isinstance(expr, FunctionCall):
        if expr.name.lower() not in LENGTH_FUNCTIONS:
            raise NotImplementedError(
                f"function {expr.name!r} is not ported yet "
                "(ROADMAP Queue 1, UDFs and SQL functions)")
        (arg,) = [eval_expr(a, batch) for a in expr.args]
        return _length(arg)
    raise NotImplementedError(
        f"{type(expr).__name__} expressions are not ported yet "
        "(ROADMAP Queue 1, Scan/Filter/Project and expressions)")


def _length(v) -> torch.Tensor:
    """Byte length per row as int64 (exon_tpu/udfs.py length_fn :155)."""
    if isinstance(v, VarColumn):
        return (v.offsets[1:] - v.offsets[:-1]).to(torch.int64)
    if isinstance(v, DictColumn):
        lens = torch.tensor([len(s.encode()) for s in v.vocab] or [0],
                            dtype=torch.int64).to(v.codes.device)
        return lens[v.codes.long().clamp(0, lens.shape[0] - 1)]
    raise PlanError("length() expects a string column")


def _validity_of(v, batch: Batch) -> torch.Tensor:
    if isinstance(v, (FixedColumn, VarColumn, DictColumn)):
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


def _arith(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if _is_scalar(a) and _is_scalar(b):
        raise NotImplementedError(
            "literal '/' and '%' folding is not ported yet "
            "(ROADMAP Queue 1, Scan/Filter/Project and expressions)")
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
        m = _CMP[op](_as_values(lv, batch), _as_values(rv, batch))
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
    swap = {"<": ">", ">": "<", "<=": ">=", ">=": "<=", "=": "=", "!=": "!="}
    if isinstance(lv, str):
        lv, rv, op = rv, lv, swap[op]
    if not isinstance(rv, str) or op not in ("=", "!="):
        raise NotImplementedError(
            "ordered string compares and column-vs-column string compares "
            "are not ported yet (ROADMAP Queue 2, K2)")
    if isinstance(lv, DictColumn):
        m = str_ops.dict_equals(lv, rv)
    elif isinstance(lv, VarColumn):
        m = str_ops.equals_literal(lv, rv.encode())
    else:
        raise PlanError(f"string compare over {type(lv)}")
    return ~m & lv.validity if op == "!=" else m


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
