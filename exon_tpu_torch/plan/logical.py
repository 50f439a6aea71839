"""Logical plan nodes: Scan / Filter / Project / Aggregate / Sort / Limit /
Join / Window / Union / Repeat / Values, and the nodes the SQL frontend
builds that the port does not lower yet: CopyTo and Explain.

Counterpart of exon_tpu/plan/logical.py:18-245. ``create_physical_plan``
raises NotImplementedError for CopyTo (ROADMAP Queue 1, item 10) and
Explain (item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from .. import datatypes as dt
from ..datatypes import Field, Schema
from .expressions import AggregateCall, Expr

# the second-moment family (exon_tpu/plan/logical.py:86-88,
# exon_tpu/plan/physical.py:445): float64 results
VAR_FNS = ("stddev", "stddev_samp", "stddev_pop", "var", "variance",
           "var_samp", "var_pop")


class LogicalPlan:
    def children(self) -> list["LogicalPlan"]:
        return []

    def schema(self) -> Schema:
        raise NotImplementedError


@dataclasses.dataclass
class Scan(LogicalPlan):
    provider: Any  # tables.FileTable or tables.VcfTable
    table_name: str
    projection: Optional[list[str]] = None
    # predicates the provider takes over (filter pushdown)
    filters: tuple = ()

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
            elif call.fn == "avg" or call.fn in VAR_FNS:
                fields.append(Field(name, dt.float64, True))
            elif call.fn == "string_agg":
                fields.append(Field(name, dt.utf8, True))
            elif call.fn == "array_agg":
                f = infer_expr_field(call.child, in_schema)
                fields.append(Field(name, dt.list_(f.dtype), True))
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


@dataclasses.dataclass
class Window(LogicalPlan):
    """Append window-function result columns (names) to the input."""

    calls: list  # [WindowCall]
    names: list[str]
    input: LogicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        from .planner import infer_window_field

        in_schema = self.input.schema()
        fields = list(in_schema.all_fields)
        for call, name in zip(self.calls, self.names):
            fields.append(infer_window_field(call, name, in_schema))
        return Schema(tuple(fields))


@dataclasses.dataclass
class Union(LogicalPlan):
    inputs: list[LogicalPlan]

    def children(self):
        return list(self.inputs)

    def schema(self) -> Schema:
        return union_schema([p.schema() for p in self.inputs])


def union_schema(schemas: list) -> Schema:
    """A union's schema: the first input's, except that a string column
    which is a dictionary in one input and var-width in another is utf8
    (UnionExec decodes the dictionaries there)."""
    fields = list(schemas[0].all_fields)
    for i, f in enumerate(fields):
        kinds = {s.all_fields[i].dtype.kind for s in schemas}
        if dt.TypeKind.DICTIONARY in kinds and len(kinds) > 1 and \
                kinds <= {dt.TypeKind.DICTIONARY, dt.TypeKind.UTF8,
                          dt.TypeKind.LARGE_UTF8}:
            fields[i] = Field(f.name, dt.utf8, f.nullable)
    return Schema(tuple(fields))


@dataclasses.dataclass
class Repeat(LogicalPlan):
    """Emit each input row ``count_expr`` times (clipped at 0): the multiset
    expansion behind INTERSECT ALL / EXCEPT ALL."""

    count_expr: object  # Expr
    input: LogicalPlan

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return self.input.schema()


@dataclasses.dataclass
class Values(LogicalPlan):
    """Literal rows (SELECT without FROM, statement results)."""

    out_schema: Schema
    rows: list[tuple]

    def schema(self) -> Schema:
        return self.out_schema


@dataclasses.dataclass
class CopyTo(LogicalPlan):
    """COPY (query) TO 'url' STORED AS <format>."""

    input: LogicalPlan
    target_url: str
    file_format: str
    options: dict

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return Schema.of(Field("count", dt.int64, False))


@dataclasses.dataclass
class Explain(LogicalPlan):
    input: LogicalPlan
    analyze: bool = False

    def children(self):
        return [self.input]

    def schema(self) -> Schema:
        return Schema.of(Field("plan_type", dt.utf8, False),
                         Field("plan", dt.utf8, False))
