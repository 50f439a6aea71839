"""Logical plan nodes: Scan / Filter / Project / Aggregate / Sort / Limit /
Join.

Counterpart of exon_tpu/plan/logical.py:18-152 for the nodes the port
plans. Window, Union, Values and CopyTo are not ported yet (ROADMAP
Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .. import datatypes as dt
from ..datatypes import Field, Schema
from .expressions import AggregateCall, Expr


class LogicalPlan:
    def children(self) -> list["LogicalPlan"]:
        return []

    def schema(self) -> Schema:
        raise NotImplementedError


@dataclasses.dataclass
class Scan(LogicalPlan):
    provider: Any  # tables.FileTable
    table_name: str
    projection: Optional[list[str]] = None

    def schema(self) -> Schema:
        s = self.provider.schema()
        if self.projection is not None:
            return s.project(self.projection)
        return s


@dataclasses.dataclass
class Filter(LogicalPlan):
    predicate: Expr
    input: LogicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()


@dataclasses.dataclass
class Project(LogicalPlan):
    exprs: list[Expr]
    input: LogicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        from .planner import infer_expr_field

        in_schema = self.input.schema()
        return Schema(tuple(infer_expr_field(e, in_schema) for e in self.exprs))


@dataclasses.dataclass
class Aggregate(LogicalPlan):
    group_exprs: list[Expr]
    agg_exprs: list[AggregateCall]
    agg_names: list[str]
    input: LogicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        from .planner import infer_expr_field

        in_schema = self.input.schema()
        fields = [infer_expr_field(e, in_schema) for e in self.group_exprs]
        for call, name in zip(self.agg_exprs, self.agg_names):
            if call.fn == "count":
                fields.append(Field(name, dt.int64, False))
            elif call.fn == "avg":
                fields.append(Field(name, dt.float64, True))
            elif call.child is not None:
                f = infer_expr_field(call.child, in_schema)
                fields.append(Field(name, f.dtype, True))
            else:
                fields.append(Field(name, dt.int64, True))
        return Schema(tuple(fields))


@dataclasses.dataclass
class Sort(LogicalPlan):
    keys: list  # [(Expr, ascending)]
    input: LogicalPlan
    fetch: Optional[int] = None

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()


@dataclasses.dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    on: list  # [(left Expr, right Expr)]
    how: str = "inner"  # inner | left
    filter: Optional[Expr] = None
    # right-child column → output name, pinned at plan time so projection
    # pushdown can't shift the collision suffixes downstream refs rely on
    right_names: Optional[dict] = None

    def children(self):
        return [self.left, self.right]

    def schema(self) -> Schema:
        from .join_exec import join_schema

        out, _ = join_schema(self.left.schema(), self.right.schema(),
                             self.right_names)
        return out


@dataclasses.dataclass
class Limit(LogicalPlan):
    skip: int
    fetch: Optional[int]
    input: LogicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()
