"""SQL statement binding + execution against an ExonSession.

Mirrors ExonSession::sql (exon_context_ext.rs:297-311): parses with the
extended parser, intercepts COPY/CREATE EXTERNAL TABLE/SET, and plans
SELECT queries into the logical algebra. UDTFs (fasta_scan('path') …,
exon_context_ext.rs:216-258) resolve to format scans.

Copied from exon_tpu/sql/frontend.py:1-1593 (pure Python, no JAX),
restricted to what the port carries: SELECT (with WHERE, GROUP BY/HAVING,
GROUPING SETS/ROLLUP/CUBE, DISTINCT, DISTINCT ON, window functions,
inner/left/right/full JOIN, UNION/INTERSECT/EXCEPT [ALL], ORDER BY,
LIMIT/OFFSET, subqueries, WITH), CREATE EXTERNAL TABLE, DESCRIBE, SHOW
TABLES and DROP TABLE over the port's formats, ``SET`` (through
``SessionConfig.set_option``), and the memory tables of ``CREATE TABLE t
(cols)``, ``CREATE TABLE t AS SELECT …`` or ``AS VALUES …``, ``INSERT INTO
t VALUES …`` and a bare ``VALUES`` (:150-259; a ``MemTable`` of host
batches, built without pyarrow: a column's type is that of its values, as
pyarrow infers it there). Statements and table kinds the port does not
carry raise NotImplementedError naming their ROADMAP Queue 1 item: COPY
(item 10), EXPLAIN (item 11), PARQUET/Delta tables, partitioned tables and
the indexed tables and ``*_indexed_scan`` region forms of formats other
than VCF (item 2c). CREATE FUNCTION parses and raises PlanError, as in the JAX
package. Set operations, FULL JOIN and GROUPING SETS plan through Union
(and Repeat for INTERSECT ALL / EXCEPT ALL), windows and DISTINCT ON
through Window, as in the JAX package. Subquery results are read through
``collect_host``, so SQL needs no pyarrow.
"""

from __future__ import annotations

import os
from typing import Optional

from .. import datatypes as dt
from ..errors import PlanError, SqlError
from ..plan import logical as L
from ..plan.expressions import (AggregateCall, Alias, BinaryOp, Case,
                                ColumnRef, Expr, FieldAccess, FunctionCall,
                                IsNull, Literal, split_conjunction)
from ..tables import MemTable
from . import ast as A
from .parser import parse_sql

# UDTF name → (format, indexed, extra-arg mapping)
UDTFS = {
    "fasta_scan": ("FASTA", False),
    "fasta_indexed_scan": ("FASTA", True),
    "fastq_scan": ("FASTQ", False),
    "gff_scan": ("GFF", False),
    "gff_indexed_scan": ("GFF", True),
    "gtf_scan": ("GTF", False),
    "bed_scan": ("BED", False),
    "hmm_dom_tab_scan": ("HMMDOMTAB", False),
    "genbank_scan": ("GENBANK", False),
    "fcs_scan": ("FCS", False),
    "mzml_scan": ("MZML", False),
    "bam_scan": ("BAM", False),
    "bam_indexed_scan": ("BAM", True),
    "sam_scan": ("SAM", False),
    "vcf_scan": ("VCF", False),
    "vcf_indexed_scan": ("VCF", True),
    "bcf_scan": ("BCF", False),
    "sdf_scan": ("SDF", False),
    "bigwig_scan": ("BIGWIG_VALUE", False),
}


def execute_sql(session, sql: str):
    from ..dataframe import DataFrame

    stmts = parse_sql(sql)
    if not stmts:
        raise SqlError("empty statement")
    result = None
    for stmt in stmts:
        result = _execute_stmt(session, stmt)
    return result


def _result_df(session, schema: dt.Schema, rows: list):
    from ..dataframe import DataFrame

    return DataFrame(session, L.Values(schema, rows))


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1, item {item})")


def _execute_stmt(session, stmt):
    from ..dataframe import DataFrame

    if isinstance(stmt, A.SelectStmt):
        return DataFrame(session, plan_select(session, stmt))
    if isinstance(stmt, A.CreateExternalTable):
        return _create_external_table(session, stmt)
    if isinstance(stmt, A.CopyToStmt):
        raise _not_ported("COPY", "10: sinks")
    if isinstance(stmt, A.SetStmt):
        session.config.set_option(stmt.key, stmt.value)
        return _status_ok(session)
    if isinstance(stmt, A.DescribeStmt):
        df = session.table(stmt.name)
        schema = df.schema()
        rows = [(f.name, str(f.dtype), "YES" if f.nullable else "NO")
                for f in schema.all_fields]
        return _result_df(session, dt.Schema.of(
            dt.Field("column_name", dt.utf8, False),
            dt.Field("data_type", dt.utf8, False),
            dt.Field("is_nullable", dt.utf8, False)), rows)
    if isinstance(stmt, A.ShowTablesStmt):
        rows = [(name,) for name in sorted(session.tables)]
        return _result_df(session, dt.Schema.of(
            dt.Field("table_name", dt.utf8, False)), rows)
    if isinstance(stmt, A.ExplainStmt):
        raise _not_ported("SQL EXPLAIN", "11: surfaces")
    if isinstance(stmt, A.DropTableStmt):
        if stmt.name.lower() not in session.tables and not stmt.if_exists:
            raise PlanError(f"table {stmt.name!r} not found")
        session.deregister_table(stmt.name)
        return _status_ok(session)
    if isinstance(stmt, A.CreateFunctionStmt):
        # parsed, then rejected as the JAX package rejects it
        # (exon_tpu/sql/frontend.py:124-127)
        raise PlanError(f"Unsupported function definition: {stmt.name}")
    if isinstance(stmt, A.CreateMemoryTable):
        return _create_memory_table(session, stmt)
    if isinstance(stmt, A.InsertStmt):
        return _insert_into(session, stmt)
    if isinstance(stmt, A.ValuesQuery):
        return DataFrame(session, L.Scan(MemTable(*_rows_batch(stmt.rows)),
                                         "values"))
    raise SqlError(f"unsupported statement {type(stmt).__name__}")


def _status_ok(session):
    return _result_df(session, dt.Schema.of(
        dt.Field("status", dt.utf8, False)), [("ok",)])


# the column types of CREATE TABLE t (cols) (exon_tpu/sql/frontend.py:142)
_MEM_TYPE_NAMES = {
    "int": dt.int64, "integer": dt.int64, "bigint": dt.int64,
    "smallint": dt.int64, "tinyint": dt.int64,
    "text": dt.utf8, "varchar": dt.utf8, "char": dt.utf8, "string": dt.utf8,
    "float": dt.float64, "double": dt.float64, "real": dt.float32,
    "boolean": dt.bool_, "bool": dt.bool_,
}


def _value_type(vals: list) -> dt.DataType:
    """The type pyarrow gives a column of these Python values (frontend.py
    ``_rows_to_arrow`` :187 builds it with ``pa.array``)."""
    live = [v for v in vals if v is not None]
    kinds = {type(v) for v in live}
    if kinds and kinds <= {bool}:
        return dt.bool_
    if kinds and kinds <= {int}:
        return dt.int64
    if kinds and kinds <= {int, float}:
        return dt.float64
    if kinds and kinds <= {str}:
        return dt.utf8
    if kinds and kinds <= {list}:
        return dt.list_(_value_type([x for v in live for x in v]))
    if not kinds:
        raise SqlError("a VALUES column of NULLs alone has no type")
    raise SqlError("a VALUES column mixes "
                   f"{', '.join(sorted(k.__name__ for k in kinds))}")


def _rows_batch(rows: list, names: Optional[list] = None,
                types: Optional[list] = None) -> tuple:
    """(schema, [host batch]) of literal rows: columns ``names`` (default
    column1, column2, …) of ``types`` (default: each column's values')."""
    from ..batch import Batch, pyvalues_column

    n_cols = len(rows[0]) if rows else len(names or [])
    if any(len(r) != n_cols for r in rows):
        raise SqlError("VALUES rows differ in length")
    fields, cols = [], []
    for j in range(n_cols):
        vals = [_const_eval(r[j]) for r in rows]
        dtype = types[j] if types else _value_type(vals)
        fields.append(dt.Field(names[j] if names else f"column{j + 1}",
                               dtype, True))
        cols.append(pyvalues_column(vals, dtype))
    schema = dt.Schema(tuple(fields))
    return schema, [Batch(schema, cols, len(rows))] if rows else []


def _create_memory_table(session, stmt: A.CreateMemoryTable):
    """CREATE TABLE t (cols), CREATE TABLE t [(cols)] AS SELECT … or AS
    VALUES … (exon_tpu/sql/frontend.py:171-206)."""
    from ..batch import Batch, column_pyvalues, utf8_column
    from ..dataframe import DataFrame

    if stmt.if_not_exists and stmt.name.lower() in session.tables:
        return _status_ok(session)
    names = [c for c, _t in stmt.columns] or None
    if stmt.query is None:
        types = []
        for _name, tname in stmt.columns:
            if tname not in _MEM_TYPE_NAMES:
                raise SqlError(f"unknown column type {tname!r}")
            types.append(_MEM_TYPE_NAMES[tname])
        schema, parts = _rows_batch([], names, types)
    elif isinstance(stmt.query, A.ValuesQuery):
        schema, parts = _rows_batch(stmt.query.rows, names)
    else:
        host = DataFrame(session, plan_select(session,
                                              stmt.query)).collect_host()
        # the JAX package keeps the collected Arrow table, whose
        # dictionary columns are strings
        fields, cols = [], []
        for i, (f, c) in enumerate(zip(host.schema.all_fields, host.columns)):
            if f.dtype.kind == dt.TypeKind.DICTIONARY:
                f = dt.Field(f.name, dt.utf8, f.nullable)
                c = utf8_column(column_pyvalues(c, host.length))
            fields.append(dt.Field(names[i] if names else f.name, f.dtype,
                                   f.nullable))
            cols.append(c)
        schema = dt.Schema(tuple(fields))
        parts = [Batch(schema, cols, host.length)] if host.length else []
    session.register_table(stmt.name, MemTable(schema, parts))
    return _status_ok(session)


def _insert_into(session, stmt: A.InsertStmt):
    """INSERT INTO a memory table (frontend.py:209-219): its rows take the
    table's column types; the result is one row, the count."""
    provider = session.tables.get(stmt.table.lower())
    if provider is None:
        raise PlanError(f"table {stmt.table!r} not found")
    if not isinstance(provider, MemTable):
        raise PlanError("INSERT INTO requires an in-memory table")
    schema = provider.schema()
    cols = stmt.columns or list(schema.names)
    if sorted(cols) != sorted(schema.names):
        raise PlanError(f"INSERT INTO {stmt.table} must give every column "
                        f"{list(schema.names)}")
    _s, parts = _rows_batch(stmt.rows, cols,
                            [schema.field(c).dtype for c in cols])
    for b in parts:
        provider.insert(b.project(list(schema.names)))
    return _result_df(session, dt.Schema.of(
        dt.Field("count", dt.int64, False)), [(len(stmt.rows),)])


def _create_external_table(session, stmt: A.CreateExternalTable):
    import dataclasses

    from ..tables import alias_extension, get_format, make_provider

    fmt_name = stmt.file_format.upper()
    if fmt_name in ("PARQUET", "DELTATABLE"):
        raise _not_ported(f"{fmt_name} tables", "2c: other formats")
    bare = fmt_name.replace("INDEXED_", "")
    if stmt.partition_cols or (bare != fmt_name and bare != "VCF"):
        raise _not_ported("partitioned tables and indexed tables other "
                          "than VCF", "2c: other formats and region reads")
    spec = get_format(bare)
    options = spec.default_options()
    kw = {}
    alias_ext = alias_extension(bare)
    if alias_ext is not None and hasattr(options, "file_extension"):
        kw["file_extension"] = alias_ext
    for k, v in stmt.options.items():
        key = k.split(".")[-1]
        if hasattr(options, key):
            cur = getattr(options, key)
            if isinstance(cur, bool):
                kw[key] = str(v).strip().lower() in ("true", "1", "yes")
            elif cur is not None and not isinstance(cur, list):
                kw[key] = type(cur)(v)
            else:
                kw[key] = v
    if bare != fmt_name:
        kw["indexed"] = True
    for k, v in session.config.scan_flags(bare).items():
        kw.setdefault(k, v)
    if hasattr(options, "batch_size"):
        kw["batch_size"] = session.device_batch_size
    if kw:
        options = dataclasses.replace(options, **kw)
    if not (stmt.if_not_exists and stmt.name.lower() in session.tables):
        session.register_table(stmt.name,
                               make_provider(stmt.location, spec, options))
    return _result_df(session, dt.Schema.of(
        dt.Field("status", dt.utf8, False)), [("ok",)])


# ---------------------------------------------------------------------------
# SELECT planning
# ---------------------------------------------------------------------------


def _is_star(e) -> bool:
    return isinstance(e, str) and e == "*"


def _contains_agg(e: Expr) -> bool:
    if isinstance(e, AggregateCall):
        return True
    return any(_contains_agg(c) for c in e.children())


def _typed_null_expr(dtype) -> Expr:
    """An all-NULL expression of the given dtype (a CASE that never
    matches, whose THEN literal pins the type)."""
    kind = dtype.kind.value
    dummy = Literal("") if "utf8" in kind or kind == "dictionary" else \
        Literal(False) if kind == "bool" else \
        Literal(0.0) if "float" in kind else Literal(0)
    return Case(None, [(Literal(False), dummy)], None)


def _contains_colref(e: Expr) -> bool:
    if isinstance(e, (ColumnRef, FieldAccess)):
        return True
    return any(_contains_colref(c) for c in e.children())


def _map_expr(e: Expr, f):
    """Rebuild ``e`` with ``f`` applied top-down: if f returns a new node,
    that subtree is replaced wholesale; otherwise children are recursed.
    Works generically over the dataclass Expr hierarchy (lists and
    (when, then) tuple pairs included)."""
    import dataclasses as _dc

    r = f(e)
    if r is not None:
        return r
    if not _dc.is_dataclass(e):
        return e
    kw, changed = {}, False

    def walk(v):
        nonlocal changed
        if isinstance(v, Expr):
            nv = _map_expr(v, f)
            changed = changed or nv is not v
            return nv
        if isinstance(v, (list, tuple)):
            nv = type(v)(walk(i) for i in v)
            return nv
        return v

    for fld in _dc.fields(e):
        kw[fld.name] = walk(getattr(e, fld.name))
    return _dc.replace(e, **kw) if changed else e


# CTE scope stack: WITH bindings visible while planning the attached
# statement (and its subqueries). The reference inherits CTEs from
# DataFusion's SQL frontend.
_CTE_SCOPE: list[dict] = []


def plan_select(session, stmt: A.SelectStmt) -> L.LogicalPlan:
    scope: dict = {}
    if stmt.ctes:
        for name, sub in stmt.ctes:
            _CTE_SCOPE.append(scope)
            try:
                scope[name.lower()] = plan_select(session, sub)
            finally:
                _CTE_SCOPE.pop()
    _CTE_SCOPE.append(scope)
    try:
        return _plan_select_inner(session, stmt)
    finally:
        _CTE_SCOPE.pop()


def _plan_select_inner(session, stmt: A.SelectStmt) -> L.LogicalPlan:
    stmt = _resolve_subqueries(session, stmt)
    if stmt.from_ is None and any(
            not _is_star(e) and _contains_agg(e)
            for e, _ in stmt.projections):
        # aggregate over the implicit one-row dual (SELECT sum(1))
        plan, qual = L.Values(
            dt.Schema((dt.Field("__dummy", dt.int64, False),)), [(0,)]), {}
    else:
        plan, qual = _plan_from(session, stmt)
    if qual:
        stmt = _rewrite_stmt_quals(stmt, qual)

    if stmt.where is not None:
        plan = L.Filter(stmt.where, plan)

    if getattr(stmt, "distinct_on", None):
        # DISTINCT ON (k): keep the first row per key by ORDER BY —
        # row_number() OVER (PARTITION BY k ORDER BY ...) = 1
        if stmt.group_by or any(not _is_star(e) and _contains_agg(e)
                                for e, _ in stmt.projections):
            raise SqlError("DISTINCT ON cannot combine with aggregates")
        from ..plan.expressions import WindowCall
        from ..plan.planner import expr_columns

        names = plan.schema().names
        if not any(_is_star(e) for e, _ in stmt.projections):
            # narrow to referenced columns so the window breaker doesn't
            # materialize unrelated (possibly nested) scan columns
            need = set()
            for e, _ in stmt.projections:
                need |= expr_columns(e)
            for e in stmt.distinct_on:
                need |= expr_columns(e)
            for e, _asc in stmt.order_by:
                need |= expr_columns(e)
            keepn = [n for n in names if n in need]
            if keepn and len(keepn) < len(names):
                plan = L.Project([ColumnRef(n) for n in keepn], plan)
        keep = [ColumnRef(n) for n in plan.schema().names]
        wc = WindowCall("row_number", None, list(stmt.distinct_on),
                        list(stmt.order_by))
        plan = L.Window([wc], ["__don"], plan)
        plan = L.Filter(BinaryOp("=", ColumnRef("__don"), Literal(1)), plan)
        plan = L.Project(keep, plan)

    has_agg = any(not _is_star(e) and _contains_agg(e) for e, _ in stmt.projections) \
        or stmt.group_by or (stmt.having is not None)

    # ORDER BY over aggregate expressions (ORDER BY sum(x) DESC): hoist
    # each such key into a hidden projection, sort by it, strip it after
    hidden_ob: list[str] = []
    if has_agg and stmt.order_by and not stmt.set_ops and not stmt.distinct:
        new_ob, new_projs = [], list(stmt.projections)
        for i, (e, asc) in enumerate(stmt.order_by):
            if _contains_agg(e):
                nm = f"__ob{i}"
                new_projs.append((Alias(e, nm), nm))
                hidden_ob.append(nm)
                new_ob.append((ColumnRef(nm), asc))
            else:
                new_ob.append((e, asc))
        if hidden_ob:
            stmt = __import__("dataclasses").replace(
                stmt, projections=new_projs, order_by=new_ob)

    if has_agg:
        plan = _plan_aggregate(session, stmt, plan)
    else:
        proj_exprs = []
        star = False
        for e, alias in stmt.projections:
            if _is_star(e):
                star = True
                continue
            proj_exprs.append(Alias(e, alias) if alias else e)
        proj_exprs, plan = _extract_windows(proj_exprs, plan)
        if star:
            in_names = plan.schema().names
            proj_exprs = [ColumnRef(n) for n in in_names] + proj_exprs
        if not (star and len(proj_exprs) == len(plan.schema().names)
                and not any(isinstance(p, Alias) for p in proj_exprs)):
            plan = L.Project(proj_exprs, plan)

    if stmt.distinct:
        out_names = plan.schema().names
        plan = L.Aggregate([ColumnRef(n) for n in out_names], [], [], plan)

    for op, all_flag, rhs in stmt.set_ops:
        other = plan_select(session, rhs)
        plan = _plan_set_op(plan, op, all_flag, other)

    if stmt.order_by:
        keys = []
        out_schema = plan.schema()
        for e, asc in stmt.order_by:
            if isinstance(e, Literal) and isinstance(e.value, int):
                keys.append((ColumnRef(out_schema.names[e.value - 1]), asc))
            else:
                keys.append((e, asc))
        # ORDER BY may reference input columns the SELECT list dropped
        # (DataFusion resolves against the pre-projection scope): widen the
        # projection for the sort, then re-project the declared columns
        missing = set()
        from ..plan.planner import expr_columns

        for e, _asc in keys:
            missing |= {c for c in expr_columns(e)
                        if not out_schema.has_field(c)}
        if missing and isinstance(plan, L.Project):
            avail = plan.input.schema()
            if all(avail.has_field(c) for c in missing):
                widened = L.Project(
                    list(plan.exprs) + [ColumnRef(c) for c in sorted(missing)],
                    plan.input)
                plan = L.Project([ColumnRef(n) for n in out_schema.names],
                                 L.Sort(keys, widened))
            else:
                plan = L.Sort(keys, plan)
        else:
            plan = L.Sort(keys, plan)

    if hidden_ob:
        kept = [n for n in plan.schema().names if n not in hidden_ob]
        plan = L.Project([ColumnRef(n) for n in kept], plan)

    if stmt.limit is not None or stmt.offset:
        plan = L.Limit(stmt.offset, stmt.limit, plan)
    return plan


def _plan_set_op(left: L.LogicalPlan, op: str, all_flag: bool,
                 right: L.LogicalPlan) -> L.LogicalPlan:
    """UNION [ALL] / INTERSECT / EXCEPT with set (distinct) semantics.

    The reference inherits these from DataFusion. Columns align by position
    (right side renamed to the left's names); INTERSECT/EXCEPT lower to a
    side-tagged union + grouped min/max filter — one distributed-friendly
    aggregate instead of a join.
    """
    lnames = left.schema().names
    rnames = right.schema().names
    if len(lnames) != len(rnames):
        raise SqlError(
            f"{op.upper()} inputs have different column counts "
            f"({len(lnames)} vs {len(rnames)})")
    # numeric type coercion by position (DataFusion coerces set-op sides
    # to a common type; mixing int and float promotes to float64)
    from ..plan.expressions import Cast

    _NUM = ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
            "uint64", "float32", "float64")
    lfields = left.schema().all_fields
    rfields = right.schema().all_fields
    lcasts: dict[int, object] = {}
    rcasts: dict[int, object] = {}
    for i, (lf, rf) in enumerate(zip(lfields, rfields)):
        lk, rk = lf.dtype.kind.value, rf.dtype.kind.value
        if lk == rk:
            continue
        if lk in _NUM and rk in _NUM:
            tgt = dt.float64 if ("float" in lk or "float" in rk) else dt.int64
            if lk != tgt.kind.value:
                lcasts[i] = tgt
            if rk != tgt.kind.value:
                rcasts[i] = tgt
    if lcasts:
        left = L.Project(
            [Alias(Cast(ColumnRef(n), lcasts[i]), n) if i in lcasts
             else ColumnRef(n) for i, n in enumerate(lnames)], left)
    if list(rnames) != list(lnames) or rcasts:
        right = L.Project(
            [Alias(Cast(ColumnRef(rn), rcasts[i]), ln) if i in rcasts
             else Alias(ColumnRef(rn), ln)
             for i, (rn, ln) in enumerate(zip(rnames, lnames))], right)
    cols = [ColumnRef(n) for n in lnames]
    if op == "union":
        plan = L.Union([left, right])
        if not all_flag:
            plan = L.Aggregate(cols, [], [], plan)
        return plan
    # tag each side, group by all columns, keep groups by side membership
    side = "__setop_side"
    tag_l = L.Project([Alias(ColumnRef(n), n) for n in lnames]
                      + [Alias(Literal(0), side)], left)
    tag_r = L.Project([Alias(ColumnRef(n), n) for n in lnames]
                      + [Alias(Literal(1), side)], right)
    unioned = L.Union([tag_l, tag_r])
    if all_flag:
        # multiset semantics: per distinct row, left count cl = n - cr and
        # right count cr; EXCEPT ALL emits max(cl - cr, 0) copies,
        # INTERSECT ALL emits min(cl, cr) (DataFusion's set-op planner
        # produces the same multiplicity algebra)
        from ..plan.expressions import Case

        agg = L.Aggregate(cols,
                          [AggregateCall("count", None),
                           AggregateCall("sum", ColumnRef(side))],
                          ["__setop_n", "__setop_cr"], unioned)
        n_, cr_ = ColumnRef("__setop_n"), ColumnRef("__setop_cr")
        cl = BinaryOp("-", n_, cr_)
        if op == "except":
            k = BinaryOp("-", cl, cr_)  # RepeatExec clips at 0
        else:
            k = Case(None, [(BinaryOp("<", cl, cr_), cl)], cr_)
        return L.Project(cols, L.Repeat(k, agg))
    agg = L.Aggregate(cols,
                      [AggregateCall("min", ColumnRef(side)),
                       AggregateCall("max", ColumnRef(side))],
                      ["__setop_mn", "__setop_mx"], unioned)
    if op == "intersect":
        pred = BinaryOp("and",
                        BinaryOp("=", ColumnRef("__setop_mn"), Literal(0)),
                        BinaryOp("=", ColumnRef("__setop_mx"), Literal(1)))
    else:  # except: rows only ever seen on the left
        pred = BinaryOp("=", ColumnRef("__setop_mx"), Literal(0))
    return L.Project(cols, L.Filter(pred, agg))


def _extract_windows(proj_exprs: list, plan: L.LogicalPlan):
    """Pull WindowCall subtrees out of the projection list into an L.Window
    node below it; projections then reference the generated columns."""
    import dataclasses as _dc

    from ..plan.expressions import WindowCall

    calls: list = []
    names: list[str] = []

    def rw(e):
        if isinstance(e, WindowCall):
            name = f"__win{len(calls)}"
            calls.append(e)
            names.append(name)
            return ColumnRef(name)
        kids = e.children()
        if not kids:
            return e
        updates = {}
        for fld in _dc.fields(e):
            v = getattr(e, fld.name)
            if isinstance(v, WindowCall):
                updates[fld.name] = rw(v)
            elif isinstance(v, Expr):
                updates[fld.name] = rw(v)
            elif isinstance(v, list) and v and isinstance(v[0], Expr):
                updates[fld.name] = [rw(x) for x in v]
        return _dc.replace(e, **updates) if updates else e

    new_exprs = [rw(e) for e in proj_exprs]
    if not calls:
        return proj_exprs, plan
    return new_exprs, L.Window(calls, names, plan)


def _plan_from(session, stmt: A.SelectStmt):
    """Plan the FROM/JOIN clause. Also returns a qualifier map
    ``alias → {column → output name}`` so downstream expressions can
    resolve ``b.source`` to the suffixed ``source_right`` the join output
    schema actually carries (DataFusion qualifies with the table name; our
    join_schema suffixes collisions instead, join_exec.py:join_schema)."""
    if stmt.from_ is None:
        return _values_row(stmt), {}
    plan = _plan_table_ref(session, stmt.from_)
    qual: dict = {}
    a0 = _ref_alias(stmt.from_)
    if a0:
        qual[a0.lower()] = {n: n for n in plan.schema().names}
    for j in stmt.joins:
        right = _plan_table_ref(session, j.table)
        if j.how == "cross":
            # cross join: constant-key hash join (every row matches)
            pairs = [(Literal(1), Literal(1))]
            filt = None
        elif j.using:
            pairs = [(ColumnRef(c), ColumnRef(c)) for c in j.using]
            filt = None
        else:
            pairs, filt = _join_pairs(j.on, plan.schema(), right.schema())
        lnames = {f.name for f in plan.schema().all_fields}
        rmap = {f.name: (f.name + "_right" if f.name in lnames else f.name)
                for f in right.schema().all_fields}
        ra = _ref_alias(j.table)
        if ra:
            qual[ra.lower()] = dict(rmap)
        if j.how in ("right", "full"):
            plan = _plan_outer_join(plan, right, pairs, filt, j.how, rmap)
        else:
            how = "left" if j.how == "left" else "inner"
            plan = L.Join(plan, right, pairs, how, filt, right_names=rmap)
    return plan, qual


def _plan_outer_join(plan: L.LogicalPlan, right: L.LogicalPlan, pairs,
                     filt, how: str, rmap: dict) -> L.LogicalPlan:
    """RIGHT JOIN = LEFT JOIN with the sides swapped, re-projected to the
    unswapped column layout. FULL JOIN = LEFT JOIN branch UNION ALL the
    unmatched-right rows (detected via a non-null build-side indicator)
    with the left columns as typed NULLs."""
    lf = list(plan.schema().all_fields)
    rf = list(right.schema().all_fields)
    rnames_set = {f.name for f in rf}
    lmap = {f.name: (f.name + "_right" if f.name in rnames_set else f.name)
            for f in lf}
    swapped_pairs = [(r, l) for l, r in pairs]
    filt2 = None
    if filt is not None:
        ren = {f.name: lmap[f.name] for f in lf}
        ren.update({rmap[f.name]: f.name for f in rf})

        def rr(e, _ren=ren):
            if isinstance(e, ColumnRef) and e.name in _ren:
                return ColumnRef(_ren[e.name])
            return None

        filt2 = _map_expr(filt, rr)
    if how == "right":
        sj = L.Join(right, plan, swapped_pairs, "left", filt2,
                    right_names=lmap)
        proj = [Alias(ColumnRef(lmap[f.name]), f.name) for f in lf] + \
               [Alias(ColumnRef(f.name), rmap[f.name]) for f in rf]
        return L.Project(proj, sj)
    left_branch = L.Join(plan, right, pairs, "left", filt,
                         right_names=rmap)
    ind = "__fj_ind"
    plan_ind = L.Project([ColumnRef(f.name) for f in lf] +
                         [Alias(Literal(1), ind)], plan)
    lmap2 = dict(lmap)
    lmap2[ind] = ind + "_right" if ind in rnames_set else ind
    sj2 = L.Join(right, plan_ind, swapped_pairs, "left", filt2,
                 right_names=lmap2)
    unmatched = L.Filter(IsNull(ColumnRef(lmap2[ind]), False), sj2)
    anti = L.Project(
        [Alias(_typed_null_expr(f.dtype), f.name) for f in lf] +
        [Alias(ColumnRef(f.name), rmap[f.name]) for f in rf], unmatched)
    return _plan_set_op(left_branch, "union", True, anti)


def _ref_table_names(stmt) -> set:
    """Lower-cased table names and aliases visible in a SELECT's FROM."""
    names: set = set()

    def add(ref):
        if ref is None:
            return
        alias = getattr(ref, "alias", None)
        if alias:
            names.add(str(alias).lower())
        nm = getattr(ref, "name", None)
        if isinstance(nm, str):
            names.add(nm.lower())

    add(getattr(stmt, "from_", None))
    for j in getattr(stmt, "joins", []) or []:
        add(getattr(j, "table", None))
    return names


def _correlated_quals(expr, corr_tables: set) -> list:
    """FieldAccess(ColumnRef(t), col) nodes whose qualifier t names an
    OUTER table — the correlation references."""
    from ..plan.expressions import ColumnRef, FieldAccess

    out = []

    def walk(x):
        if isinstance(x, FieldAccess) and isinstance(x.child, ColumnRef) \
                and x.child.name.lower() in corr_tables:
            out.append(x)
            return
        for c in x.children():
            walk(c)

    walk(expr)
    return out


def _has_unqualified_ref(expr) -> bool:
    """True when the tree contains a bare ColumnRef (not a table
    qualifier inside FieldAccess(ColumnRef, field))."""
    from ..plan.expressions import ColumnRef, FieldAccess

    if isinstance(expr, ColumnRef):
        return True
    if isinstance(expr, FieldAccess) and isinstance(expr.child, ColumnRef):
        return False
    return any(_has_unqualified_ref(c) for c in expr.children())


def _corr_equalities(sub, outer_stmt):
    """Split sub.where into correlation equalities [(outer, inner)] plus
    the residual conjunction. Returns (keys, rest_where, corr_tables), or
    None when uncorrelated; raises SqlError when correlation isn't a
    conjunction of clean outer = inner equalities."""
    from ..plan.expressions import BinaryOp, split_conjunction

    if sub.where is None:
        return None
    inner = _ref_table_names(sub)
    outer = _ref_table_names(outer_stmt)
    corr_tables = {t for t in outer if t not in inner}
    if not corr_tables:
        return None
    conjs = split_conjunction(sub.where)
    keys, rest = [], []
    for c in conjs:
        if not _correlated_quals(c, corr_tables):
            rest.append(c)
            continue
        ok = isinstance(c, BinaryOp) and c.op == "="
        if ok:
            lcorr = bool(_correlated_quals(c.left, corr_tables))
            rcorr = bool(_correlated_quals(c.right, corr_tables))
            ok = lcorr != rcorr  # exactly one side references the outer
        if not ok:
            raise SqlError(
                "correlated subqueries support conjunctions of outer = "
                "inner equalities; rewrite as a JOIN")
        o, i = (c.left, c.right) if lcorr else (c.right, c.left)
        keys.append((o, i))
    if not keys:
        return None
    new_where = None
    for r in rest:
        new_where = r if new_where is None else BinaryOp("and", new_where, r)
    return keys, new_where, corr_tables


def _join_on(alias: str, keys: list):
    """AND-chain of outer_j = <alias>.__kj equalities."""
    from ..plan.expressions import BinaryOp, ColumnRef, FieldAccess

    on = None
    for j, (o, _i) in enumerate(keys):
        eq = BinaryOp("=", o, FieldAccess(ColumnRef(alias), f"__k{j}"))
        on = eq if on is None else BinaryOp("and", on, eq)
    return on


def _decorrelate_exists(e, outer_stmt, pending, fresh):
    """[NOT] EXISTS with equi-correlation conjuncts. Single key rewrites
    to [NOT] IN (the semi/anti-join shape DataFusion's decorrelation
    produces); multiple keys LEFT JOIN a DISTINCT key set and null-test a
    marker column. Other correlation raises instead of silently binding
    outer-qualified names to same-named inner columns."""
    import dataclasses as _dc

    from ..plan.expressions import (ColumnRef, FieldAccess, InSubquery,
                                    IsNull, Literal)

    sub = e.stmt
    if getattr(sub, "group_by", None) or \
            getattr(sub, "having", None) is not None:
        return None
    ce = _corr_equalities(sub, outer_stmt)
    if ce is None:
        return None
    keys, rest_where, _corr = ce
    if len(keys) == 1:
        (o, i), = keys
        new_sub = _dc.replace(sub, where=rest_where,
                              projections=[(i, None)])
        return InSubquery(o, new_sub, e.negated)
    alias = fresh()
    proj = [(i, f"__k{j}") for j, (_o, i) in enumerate(keys)]
    proj.append((Literal(1), "__m"))
    new_sub = _dc.replace(sub, where=rest_where, projections=proj,
                          distinct=True)
    pending.append(A.JoinClause(how="left",
                                table=A.SubqueryRef(new_sub, alias),
                                on=_join_on(alias, keys)))
    marker = FieldAccess(ColumnRef(alias), "__m")
    # EXISTS → marker present; NOT EXISTS → marker IS NULL (the DISTINCT
    # key set guarantees at most one match, so no row duplication)
    return IsNull(marker, negated=not e.negated)


_AGG_FNS = ("count", "sum", "min", "max", "avg")


def _decorrelate_scalar_agg(e, outer_stmt, pending, fresh):
    """Correlated scalar aggregate subquery → LEFT JOIN on the grouped
    subquery (the standard DataFusion decorrelation): per outer row, the
    aggregate over its matching group (NULL for empty groups; COUNT
    coalesces to 0)."""
    import dataclasses as _dc

    from ..plan.expressions import (ColumnRef, FieldAccess, FunctionCall,
                                    Literal)

    sub = e.stmt
    if getattr(sub, "group_by", None) or \
            getattr(sub, "having", None) is not None or \
            getattr(sub, "set_ops", None) or sub.distinct or \
            sub.limit is not None or len(sub.projections) != 1:
        return None
    proj_e, _pa = sub.projections[0]
    if isinstance(proj_e, str) or not (
            isinstance(proj_e, AggregateCall)
            and proj_e.fn.lower() in _AGG_FNS):
        return None
    ce = _corr_equalities(sub, outer_stmt)
    if ce is None:
        return None
    keys, rest_where, corr_tables = ce
    if _correlated_quals(proj_e, corr_tables):
        return None  # outer refs inside the aggregate: unsupported shape
    alias = fresh()
    proj = [(i, f"__k{j}") for j, (_o, i) in enumerate(keys)]
    proj.append((proj_e, "__v"))
    new_sub = _dc.replace(sub, where=rest_where, projections=proj,
                          group_by=[i for (_o, i) in keys])
    pending.append(A.JoinClause(how="left",
                                table=A.SubqueryRef(new_sub, alias),
                                on=_join_on(alias, keys)))
    val = FieldAccess(ColumnRef(alias), "__v")
    if proj_e.fn.lower() == "count":
        val = FunctionCall("coalesce", [val, Literal(0)])
    return val


def _resolve_subqueries(session, stmt: A.SelectStmt) -> A.SelectStmt:
    """Resolve expression subqueries. Uncorrelated ones evaluate eagerly:
    scalar → Literal, EXISTS → Literal(bool), IN (SELECT …) → InList.
    Correlated ones decorrelate into joins (the standard DataFusion
    approach): EXISTS/IN over outer = inner equality conjunctions become
    semi/anti shapes, correlated scalar aggregates become LEFT JOINs on
    the grouped subquery. Unsupported correlation raises a clear error."""
    import dataclasses as _dc

    from ..plan.expressions import ExistsSubquery, InList, InSubquery, Subquery

    found = [False]
    pending_joins: list = []
    alias_n = [0]

    def fresh_alias() -> str:
        alias_n[0] += 1
        return f"__sq{alias_n[0]}"

    def has_sub(e) -> bool:
        if isinstance(e, (Subquery, ExistsSubquery, InSubquery)):
            return True
        return any(has_sub(c) for c in e.children()) or \
            (isinstance(e, InSubquery) and has_sub(e.child))

    def _corr_of(sub_stmt):
        outer = _ref_table_names(stmt)
        inner = _ref_table_names(sub_stmt)
        corr_tables = {t for t in outer if t not in inner}
        if corr_tables and sub_stmt.where is not None and \
                _correlated_quals(sub_stmt.where, corr_tables):
            return corr_tables
        return None

    def run(sub_stmt):
        from ..batch import host_pylists
        from ..dataframe import DataFrame

        # an outer-qualified reference inside the subquery must not bind to
        # a same-named inner column silently (b.k = a.k would become k = k)
        if _corr_of(sub_stmt):
            raise SqlError(
                "unsupported correlated subquery shape (supported: "
                "EXISTS/IN over outer = inner equality conjunctions, "
                "correlated scalar aggregates); rewrite as a JOIN")
        try:
            plan = plan_select(session, sub_stmt)
        except KeyError as e:
            raise SqlError(
                f"cannot plan subquery (correlated subqueries are not "
                f"supported): {e}") from e
        return host_pylists(DataFrame(session, plan).collect_host())

    def rw(e):
        if isinstance(e, Subquery):
            found[0] = True
            if _corr_of(e.stmt):
                rewritten = _decorrelate_scalar_agg(e, stmt, pending_joins,
                                                    fresh_alias)
                if rewritten is not None:
                    return rewritten
            t = run(e.stmt)
            if len(t) != 1:
                raise SqlError("scalar subquery must return one column")
            if len(t[0]) == 0:
                return Literal(None)
            if len(t[0]) > 1:
                raise SqlError("scalar subquery returned more than one row")
            return Literal(t[0][0])
        if isinstance(e, ExistsSubquery):
            found[0] = True
            rewritten = _decorrelate_exists(e, stmt, pending_joins,
                                            fresh_alias)
            if rewritten is not None:
                return rw(rewritten)
            sub = _dc.replace(e.stmt, limit=1)
            t = run(sub)
            n = len(t[0]) if t else 0
            return Literal(n > 0 if not e.negated else n == 0)
        if isinstance(e, InSubquery):
            found[0] = True
            if _corr_of(e.stmt):
                # correlated IN: membership equality joins the correlation
                # conjunction, then the EXISTS machinery decorrelates
                if e.negated:
                    raise SqlError(
                        "correlated NOT IN is not supported (NULL "
                        "semantics); rewrite as NOT EXISTS")
                sub = e.stmt
                if len(sub.projections) != 1 or \
                        isinstance(sub.projections[0][0], str):
                    raise SqlError("IN subquery must return one column")
                # the operand moves INSIDE the subquery, where a bare
                # (unqualified) column name would silently rebind to a
                # same-named inner column — require qualification
                if _has_unqualified_ref(e.child):
                    raise SqlError(
                        "correlated IN needs a table-qualified operand "
                        "(e.g. a.x IN (...)): an unqualified column would "
                        "rebind inside the subquery")
                y = sub.projections[0][0]
                memb = BinaryOp("=", e.child, y)
                new_where = BinaryOp("and", sub.where, memb) \
                    if sub.where is not None else memb
                return rw(ExistsSubquery(
                    _dc.replace(sub, where=new_where), False))
            t = run(e.stmt)
            if len(t) != 1:
                raise SqlError("IN subquery must return one column")
            vals = [Literal(v) for v in t[0] if v is not None]
            if not vals:
                return Literal(False if not e.negated else True)
            return InList(rw(e.child), vals, e.negated)
        kids = e.children()
        if not kids:
            return e
        updates = {}
        for fld in _dc.fields(e):
            v = getattr(e, fld.name)
            if isinstance(v, Expr):
                updates[fld.name] = rw(v)
            elif isinstance(v, list) and v and isinstance(v[0], Expr):
                updates[fld.name] = [rw(x) for x in v]
            elif isinstance(v, list) and v and isinstance(v[0], tuple) and \
                    len(v[0]) == 2 and isinstance(v[0][0], Expr):
                updates[fld.name] = [(rw(a), rw(b) if isinstance(b, Expr)
                                      else b) for a, b in v]
        return _dc.replace(e, **updates) if updates else e

    def rw_top(e):
        return e if isinstance(e, str) else rw(e)

    # cheap pre-scan: skip the rewrite when no subquery nodes exist
    exprs = [e for e, _ in stmt.projections if not _is_star(e)]
    exprs += [e for e in stmt.group_by]
    exprs += [e for e, _ in stmt.order_by]
    for e in (stmt.where, stmt.having):
        if e is not None:
            exprs.append(e)
    for j in stmt.joins:
        if j.on is not None:
            exprs.append(j.on)
    if not any(has_sub(e) for e in exprs):
        return stmt
    new_stmt = _dc.replace(
        stmt,
        projections=[(rw_top(e), a) for e, a in stmt.projections],
        where=rw(stmt.where) if stmt.where is not None else None,
        group_by=[rw(e) for e in stmt.group_by],
        having=rw(stmt.having) if stmt.having is not None else None,
        order_by=[(rw(e), asc) for e, asc in stmt.order_by],
        joins=[_dc.replace(j, on=rw(j.on) if j.on is not None else None)
               for j in stmt.joins],
    )
    if pending_joins:
        # decorrelation joins add hidden __sq columns; a bare * would leak
        # them into the output
        if any(_is_star(e) for e, _ in new_stmt.projections):
            raise SqlError(
                "correlated subqueries with SELECT * are not supported; "
                "list the output columns explicitly")
        new_stmt = _dc.replace(new_stmt,
                               joins=list(new_stmt.joins) + pending_joins)
    return new_stmt


def _ref_alias(ref) -> Optional[str]:
    alias = getattr(ref, "alias", None)
    if alias:
        return alias
    return getattr(ref, "name", None)


def _rewrite_stmt_quals(stmt: A.SelectStmt, qual: dict) -> A.SelectStmt:
    """Rewrite alias-qualified refs in every expression position of the
    statement to the join-output column names."""
    import dataclasses as _dc

    def rw(e):
        if isinstance(e, str):
            return e
        from ..plan.expressions import FieldAccess

        if isinstance(e, FieldAccess) and isinstance(e.child, ColumnRef):
            m = qual.get(e.child.name.lower())
            if m is not None and e.field in m:
                return ColumnRef(m[e.field])
            return e
        kids = e.children()
        if not kids:
            return e
        updates = {}
        for fld in _dc.fields(e):
            v = getattr(e, fld.name)
            if isinstance(v, Expr):
                updates[fld.name] = rw(v)
            elif isinstance(v, list) and v and isinstance(v[0], Expr):
                updates[fld.name] = [rw(x) for x in v]
        return _dc.replace(e, **updates) if updates else e

    return _dc.replace(
        stmt,
        projections=[(e if _is_star(e) else rw(e), a)
                     for e, a in stmt.projections],
        where=rw(stmt.where) if stmt.where is not None else None,
        group_by=[rw(e) for e in stmt.group_by],
        having=rw(stmt.having) if stmt.having is not None else None,
        order_by=[(rw(e), asc) for e, asc in stmt.order_by],
    )


def _values_row(stmt: A.SelectStmt) -> L.LogicalPlan:
    # SELECT <literals/exprs> with no FROM: evaluate eagerly via a 1-row scan
    fields, row = [], []
    for e, alias in stmt.projections:
        if _is_star(e):
            raise SqlError("SELECT * requires FROM")
        try:
            v = _const_eval(e)
        except SqlError:
            # non-constant (UDF call): run the expressions through the
            # normal device evaluator over a one-row dummy batch
            return _projected_dummy_row(stmt)
        name = alias or e.display_name()
        if isinstance(v, bool):
            fields.append(dt.Field(name, dt.bool_, False))
        elif isinstance(v, int):
            fields.append(dt.Field(name, dt.int64, False))
        elif isinstance(v, float):
            fields.append(dt.Field(name, dt.float64, False))
        elif isinstance(v, list):
            elem = dt.float64 if any(isinstance(x, float) for x in v) \
                else dt.int64
            fields.append(dt.Field(name, dt.list_(elem), True))
        else:
            fields.append(dt.Field(name, dt.utf8, True))
        row.append(v)
    return L.Values(dt.Schema(tuple(fields)), [tuple(row)])


def _projected_dummy_row(stmt: A.SelectStmt) -> L.LogicalPlan:
    from ..plan.expressions import Alias as _Alias

    dummy = L.Values(dt.Schema((dt.Field("__dummy", dt.int64, False),)),
                     [(0,)])
    exprs = []
    for e, alias in stmt.projections:
        exprs.append(_Alias(e, alias) if alias else e)
    return L.Project(exprs, dummy)


def _const_eval(e: Expr):
    if isinstance(e, Literal):
        return e.value
    if isinstance(e, Alias):
        return _const_eval(e.child)
    if isinstance(e, FunctionCall) and e.name == "make_array":
        return [_const_eval(a) for a in e.args]
    if isinstance(e, BinaryOp):
        a, b = _const_eval(e.left), _const_eval(e.right)
        import operator as op

        fns = {"+": op.add, "-": op.sub, "*": op.mul, "/": op.truediv,
               "%": op.mod, "=": op.eq, "!=": op.ne, "<": op.lt,
               "<=": op.le, ">": op.gt, ">=": op.ge,
               "and": lambda x, y: x and y, "or": lambda x, y: x or y}
        return fns[e.op](a, b)
    raise SqlError(f"cannot evaluate constant expression {e!r}")


def _plan_table_ref(session, ref) -> L.LogicalPlan:
    if isinstance(ref, A.TableName):
        key = ref.name.lower()
        for scope in reversed(_CTE_SCOPE):
            if key in scope:
                return scope[key]
        return session.table(ref.name).logical_plan()
    if isinstance(ref, A.SubqueryRef):
        return plan_select(session, ref.query)
    if isinstance(ref, A.TableFunc):
        return _plan_udtf(session, ref)
    raise SqlError(f"unsupported table reference {ref!r}")


def _plan_udtf(session, ref: A.TableFunc) -> L.LogicalPlan:
    name = ref.name.lower()
    if name not in UDTFS:
        raise SqlError(f"unknown table function {ref.name!r}")
    fmt, indexed = UDTFS[name]
    if not ref.args:
        raise SqlError(f"{ref.name} requires a path argument")
    path = str(ref.args[0])
    if indexed and fmt != "VCF":
        raise _not_ported(f"{ref.name} region reads",
                          "2c: other formats and region reads")
    plan = session._read(fmt, path).logical_plan()
    # a second argument is the compression of a plain scan (inferred from
    # the extension), or the region or region file of an indexed one
    # (exon_tpu/sql/frontend.py:1212-1267)
    if indexed and len(ref.args) > 1 and isinstance(ref.args[1], str):
        from ..plan.expressions import col, lit
        from ..region import Region

        arg = ref.args[1]
        region_strs = [arg]
        if ("/" in arg or arg.endswith(".txt")) and os.path.isfile(arg):
            with open(arg) as f:
                region_strs = [ln.strip() for ln in f.read().splitlines()
                               if ln.strip()]
        regions = [Region.parse(r) for r in region_strs]

        def marker(region):
            return FunctionCall("vcf_region_filter",
                                [lit(str(region)), col("chrom"), col("pos")])

        pred = marker(regions[0])
        for r in regions[1:]:
            pred = BinaryOp("or", pred, marker(r))
        plan = L.Filter(pred, plan)
    return plan


def _unqualify(e: Expr, *schemas) -> Expr:
    """Strip table qualifiers parsed as FieldAccess when the base name is
    not a struct column of any input schema."""
    from ..plan.expressions import FieldAccess

    if isinstance(e, FieldAccess) and isinstance(e.child, ColumnRef):
        base = e.child.name
        for s in schemas:
            if s.has_field(base) and \
                    s.field(base).dtype.kind.value == "struct":
                return e
        return ColumnRef(e.field)
    import dataclasses as _dc

    kids = e.children()
    if not kids:
        return e
    updates = {}
    for fld in _dc.fields(e):
        v = getattr(e, fld.name)
        if isinstance(v, Expr):
            updates[fld.name] = _unqualify(v, *schemas)
        elif isinstance(v, list) and v and isinstance(v[0], Expr):
            updates[fld.name] = [_unqualify(x, *schemas) for x in v]
    return _dc.replace(e, **updates)


def _join_pairs(on: Optional[Expr], lschema, rschema):
    if on is None:
        raise SqlError("JOIN requires ON or USING")
    on = _unqualify(on, lschema, rschema)
    pairs = []
    residual = []
    from ..plan.planner import expr_columns

    lcols = {f.name for f in lschema.all_fields}
    rcols = {f.name for f in rschema.all_fields}

    def side(e):
        if isinstance(e, ColumnRef):
            # precedence for ambiguous bare names: left side
            return "l" if e.name in lcols else \
                ("r" if e.name in rcols else None)
        cols = expr_columns(e)
        if not cols:
            return None  # constant — not a key
        inl, inr = cols <= lcols, cols <= rcols
        if inl and not inr:
            return "l"
        if inr and not inl:
            return "r"
        return None  # ambiguous or mixed-side expression

    for c in split_conjunction(on):
        if isinstance(c, BinaryOp) and c.op == "=":
            if isinstance(c.left, ColumnRef) and \
                    isinstance(c.right, ColumnRef):
                # bare names: self-joins resolve each name on both sides
                l, r = c.left, c.right
                if lschema.has_field(l.name) and rschema.has_field(r.name):
                    pairs.append((l, r))
                    continue
                if lschema.has_field(r.name) and rschema.has_field(l.name):
                    pairs.append((r, l))
                    continue
            else:
                sl, sr = side(c.left), side(c.right)
                if sl == "l" and sr == "r":
                    pairs.append((c.left, c.right))
                    continue
                if sl == "r" and sr == "l":
                    pairs.append((c.right, c.left))
                    continue
        residual.append(c)
    if not pairs:
        raise SqlError("JOIN ON must contain at least one equality")
    from ..plan.expressions import conjoin

    return pairs, conjoin(residual)


def _rewrite_distinct_aggs(group_exprs: list, calls: list,
                           plan: L.LogicalPlan):
    """Plan DISTINCT aggregates via a dedup pre-aggregate.

    DataFusion's SingleDistinctToGroupBy rewrite (the reference inherits it):
    ``agg(DISTINCT x) GROUP BY g`` becomes an inner ``GROUP BY g, x`` dedup
    aggregate feeding a plain outer aggregate. Supported when every DISTINCT
    call shares one argument and no non-DISTINCT calls are mixed in;
    anything else raises instead of silently returning the wrong answer.
    """
    import dataclasses as _dc

    # DISTINCT is a no-op for min/max
    calls = [_dc.replace(c, distinct=False)
             if c.distinct and c.fn in ("min", "max") else c for c in calls]
    dcalls = [c for c in calls if c.distinct]
    if not dcalls:
        return group_exprs, calls, plan
    if any(c.child is None for c in dcalls):
        raise SqlError("COUNT(DISTINCT *) is not supported")
    children = {repr(c.child) for c in dcalls}
    ndcalls = [c for c in calls if not c.distinct]
    # non-distinct calls ride through the dedup aggregate as decomposable
    # partials: SUM→SUM(SUM), COUNT→SUM(COUNT), MIN→MIN(MIN), MAX→MAX(MAX)
    # (DataFusion's SingleDistinctToGroupBy does the same; AVG mixed with
    # DISTINCT would need a post-projection and stays unsupported)
    _ND_OUTER = {"sum": "sum", "count": "sum", "min": "min", "max": "max"}
    if len(children) > 1 or any(c.fn not in _ND_OUTER for c in ndcalls):
        raise PlanError(
            "DISTINCT aggregates support one DISTINCT expression, "
            "optionally mixed with SUM/COUNT/MIN/MAX")
    child = dcalls[0].child
    inner_groups = list(group_exprs)
    child_idx = None
    for i, g in enumerate(inner_groups):
        if repr(g) == repr(child):
            child_idx = i
            break
    if child_idx is None:
        child_idx = len(inner_groups)
        inner_groups.append(child)
    inner_calls = [_dc.replace(c, distinct=False) for c in ndcalls]
    inner_names = [f"__nd{j}" for j in range(len(ndcalls))]
    inner = L.Aggregate(inner_groups, inner_calls, inner_names, plan)
    in_names = inner.schema().names
    new_groups = [ColumnRef(in_names[i]) for i in range(len(group_exprs))]
    vref = ColumnRef(in_names[child_idx])
    new_calls = []
    nd_j = 0
    for c in calls:
        if c.distinct:
            new_calls.append(_dc.replace(c, child=vref, distinct=False))
        else:
            new_calls.append(_dc.replace(
                c, fn=_ND_OUTER[c.fn],
                child=ColumnRef(f"__nd{nd_j}"), distinct=False))
            nd_j += 1
    return new_groups, new_calls, inner


def _plan_grouping_sets(session, stmt: A.SelectStmt, plan: L.LogicalPlan
                        ) -> L.LogicalPlan:
    """GROUPING SETS / ROLLUP / CUBE: one aggregate branch per set,
    un-grouped columns projected as typed NULLs, branches UNION ALLed
    (DataFusion plans these natively; the multiset union is equivalent)."""
    import dataclasses as _dc

    from ..plan.planner import infer_expr_field

    all_reprs = {repr(g.child if isinstance(g, Alias) else g)
                 for g in stmt.group_by}
    in_schema = plan.schema()
    out = None
    for S in stmt.group_sets:
        sreprs = {repr(g) for g in S}

        def gr(e, _sr=sreprs):
            # GROUPING(cols...) is a per-branch constant bitmask
            if isinstance(e, FunctionCall) and e.name == "grouping":
                val = 0
                for a in e.args:
                    val = (val << 1) | (0 if repr(a) in _sr else 1)
                return Literal(val)
            return None

        projs = []
        for e, alias in stmt.projections:
            e = _map_expr(e, gr)
            base = e.child if isinstance(e, Alias) else e
            name = alias or (e.name if isinstance(e, Alias) else None)
            if repr(base) in all_reprs and repr(base) not in sreprs:
                f = infer_expr_field(base, in_schema)
                ne = _typed_null_expr(f.dtype)
                projs.append((Alias(ne, name or base.display_name()), name))
            else:
                projs.append((e, alias))
        stmt_b = _dc.replace(stmt, projections=projs, group_by=list(S),
                             group_sets=None)
        branch = _plan_aggregate(session, stmt_b, plan)
        out = branch if out is None else _plan_set_op(
            out, "union", True, branch)
    return out


def _plan_aggregate(session, stmt: A.SelectStmt, plan: L.LogicalPlan
                    ) -> L.LogicalPlan:
    if getattr(stmt, "group_sets", None) is not None:
        return _plan_grouping_sets(session, stmt, plan)
    # GROUP BY may reference projection ALIASES (GROUP BY bucket) or
    # ordinals (GROUP BY 1) — resolve both to the projected expression
    alias_map = {}
    proj_list = [(e, a) for e, a in stmt.projections if not _is_star(e)]
    for e, a in proj_list:
        name = a or (e.name if isinstance(e, Alias) else None)
        if name:
            alias_map[name.lower()] = e.child if isinstance(e, Alias) else e
    in_schema = plan.schema()
    group_exprs = []
    for g in stmt.group_by:
        if isinstance(g, Literal) and isinstance(g.value, int) and \
                1 <= g.value <= len(proj_list):
            e = proj_list[g.value - 1][0]
            group_exprs.append(e.child if isinstance(e, Alias) else e)
        elif isinstance(g, ColumnRef) and not in_schema.has_field(g.name) \
                and g.name.lower() in alias_map:
            group_exprs.append(alias_map[g.name.lower()])
        else:
            group_exprs.append(g)
    stmt = __import__("dataclasses").replace(stmt, group_by=group_exprs)
    group_exprs = list(stmt.group_by)
    calls: list[AggregateCall] = []
    names: list[str] = []
    out_exprs: list[tuple] = []  # (kind, payload, alias) kind: group|agg

    def group_index(e: Expr) -> Optional[int]:
        for i, g in enumerate(group_exprs):
            if repr(g) == repr(e):
                return i
        if isinstance(e, ColumnRef):
            for i, g in enumerate(group_exprs):
                if isinstance(g, ColumnRef) and g.name == e.name:
                    return i
        return None

    for e, alias in stmt.projections:
        if _is_star(e):
            raise SqlError("SELECT * with GROUP BY not supported")
        base = e.child if isinstance(e, Alias) else e
        alias = alias or (e.name if isinstance(e, Alias) else None)
        if isinstance(base, AggregateCall):
            calls.append(base)
            names.append(alias or base.display_name())
            out_exprs.append(("agg", len(calls) - 1, alias))
        else:
            gi = group_index(base)
            if gi is None:
                if _contains_agg(base):
                    # expression over aggregates: hoist each AggregateCall
                    # into the Aggregate node and evaluate the expression
                    # in a post-projection over its output columns
                    def hoist(e):
                        g = group_index(e)
                        if g is not None:
                            return ColumnRef(f"\x00grp:{g}")
                        if isinstance(e, AggregateCall):
                            for i, c in enumerate(calls):
                                if repr(c) == repr(e):
                                    return ColumnRef(names[i])
                            calls.append(e)
                            names.append(f"__agg{len(calls) - 1}")
                            return ColumnRef(names[-1])
                        return None

                    out_exprs.append(
                        ("expr", (_map_expr(base, hoist),
                                  alias or base.display_name()), alias))
                    continue
                if not _contains_colref(base):
                    # constant projection alongside aggregates
                    out_exprs.append(
                        ("expr", (base, alias or base.display_name()),
                         alias))
                    continue
                # implicit group expr (no GROUP BY: scalar agg context error)
                if not stmt.group_by:
                    raise SqlError(
                        f"column {base!r} must appear in GROUP BY")
                raise SqlError(
                    f"projection {base!r} not in GROUP BY")
            out_exprs.append(("group", gi, alias))

    # HAVING: only over aggregate calls already present or new ones
    having = stmt.having
    if having is not None:
        def rewrite_having(e: Expr) -> Expr:
            if isinstance(e, AggregateCall):
                for i, c in enumerate(calls):
                    if repr(c) == repr(e):
                        return ColumnRef(names[i])
                calls.append(e)
                names.append(e.display_name())
                return ColumnRef(names[-1])
            if isinstance(e, BinaryOp):
                return BinaryOp(e.op, rewrite_having(e.left), rewrite_having(e.right))
            return e

        having = rewrite_having(having)

    group_exprs, calls, plan = _rewrite_distinct_aggs(group_exprs, calls, plan)
    agg = L.Aggregate(group_exprs, calls, names, plan)
    out: L.LogicalPlan = agg
    if having is not None:
        out = L.Filter(having, out)
    # final projection to requested order/aliases
    agg_schema = agg.schema()
    n_group = len(group_exprs)
    proj = []
    any_expr = False
    for kind, payload, alias in out_exprs:
        if kind == "expr":
            any_expr = True
            e, outname = payload

            def resolve(x):
                if isinstance(x, ColumnRef) and x.name.startswith("\x00grp:"):
                    return ColumnRef(agg_schema.names[int(x.name[5:])])
                return None

            proj.append(Alias(_map_expr(e, resolve), outname))
            continue
        if kind == "group":
            name = agg_schema.names[payload]
        else:
            name = agg_schema.names[n_group + payload]
        proj.append(Alias(ColumnRef(name), alias) if alias else ColumnRef(name))
    needs_proj = any_expr or \
        [p.name for p in proj] != agg_schema.names
    if needs_proj or having is not None:
        out = L.Project(proj, out)
    return out
