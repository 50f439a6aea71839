"""SQL statement AST (bound to plans in sql/frontend.py).

Copied unchanged from exon_tpu/sql/ast.py:1-132 (pure Python, no JAX).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..plan.expressions import Expr


@dataclasses.dataclass
class TableName:
    name: str
    alias: Optional[str] = None


@dataclasses.dataclass
class TableFunc:
    name: str
    args: list
    alias: Optional[str] = None


@dataclasses.dataclass
class SubqueryRef:
    query: "SelectStmt"
    alias: Optional[str] = None


@dataclasses.dataclass
class JoinClause:
    how: str  # inner | left | right | full
    table: Any
    on: Optional[Expr] = None
    using: Optional[list[str]] = None


@dataclasses.dataclass
class SelectStmt:
    projections: list  # [(Expr, alias|None)] or [("*", None)]
    from_: Optional[Any] = None
    joins: list = dataclasses.field(default_factory=list)
    where: Optional[Expr] = None
    group_by: list = dataclasses.field(default_factory=list)
    # GROUPING SETS / ROLLUP / CUBE: list of grouping sets (each a list of
    # exprs drawn from group_by); None = plain GROUP BY
    group_sets: Optional[list] = None
    having: Optional[Expr] = None
    order_by: list = dataclasses.field(default_factory=list)  # [(Expr, asc)]
    limit: Optional[int] = None
    offset: int = 0
    distinct: bool = False
    # DISTINCT ON (exprs): keep the first row per key by ORDER BY
    distinct_on: Optional[list] = None
    # set-operation chain, left-associative: [(op, all_flag, SelectStmt)]
    # op in {"union", "intersect", "except"} (reference: DataFusion set ops)
    set_ops: list = dataclasses.field(default_factory=list)
    ctes: list = dataclasses.field(default_factory=list)  # [(name, SelectStmt)]


@dataclasses.dataclass
class ValuesQuery:
    rows: list  # list[list[Expr]]


@dataclasses.dataclass
class CreateMemoryTable:
    name: str
    columns: list  # [(name, type_name)] — may be empty when AS given
    query: Optional[Any] = None  # SelectStmt | ValuesQuery
    if_not_exists: bool = False


@dataclasses.dataclass
class InsertStmt:
    table: str
    columns: list  # may be empty
    rows: list     # list[list[Expr]]


@dataclasses.dataclass
class CreateExternalTable:
    name: str
    file_format: str
    location: str
    options: dict
    partition_cols: list
    if_not_exists: bool = False


@dataclasses.dataclass
class CopyToStmt:
    source: Any  # SelectStmt | TableName
    target: str
    file_format: Optional[str]
    options: dict


@dataclasses.dataclass
class SetStmt:
    key: str
    value: str


@dataclasses.dataclass
class DescribeStmt:
    name: str


@dataclasses.dataclass
class ShowTablesStmt:
    pass


@dataclasses.dataclass
class ExplainStmt:
    stmt: Any
    analyze: bool = False


@dataclasses.dataclass
class DropTableStmt:
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateFunctionStmt:
    """CREATE FUNCTION — parsed, then rejected like the reference's
    ExonFunctionFactory (function_factory.rs:28-44)."""

    name: str
