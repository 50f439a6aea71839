"""Type inference, a minimal optimizer and lowering to physical operators.

Counterpart of exon_tpu/plan/planner.py: ``infer_expr_field`` (:34) for the
ported expressions (a function call takes the return type registered
beside its function, where the JAX package keeps a second registry,
:25-31,71-77: a fixed type, or a callable of the Fields of the call's
non-literal arguments; the aggregates' types follow logical.py:86-100),
``optimize`` (:166) reduced to resolving table
qualifiers (:231), filter pushdown into the scan (:385; providers answer
exact/inexact/none), projection pushdown into the scan (:411) and
identity-projection elision (:175), and ``create_physical_plan`` (:551-668)
for Scan / Filter / Project / Aggregate / Sort / Limit / Join / Window /
Union / Repeat / Values, with the same fusion of a Filter directly under an
Aggregate into the aggregate's ``pre_filter`` and of a Limit over a Sort
into a TopK sort. Window calls are typed by ``infer_window_field`` (:147).
Projection pushdown runs through Sort, Window and Join (:460-501), and
drops a Project's unread columns and narrows a Union's inputs, which the
JAX planner does not. CopyTo and Explain raise NotImplementedError naming
their ROADMAP item. With the session config's ``distributed`` on, the
planner tries the distributed operators of parallel/distributed.py first,
as :568-662 does: an Aggregate, a Sort with a fetch and a Limit over a Sort
(TopK), a Sort across processes (a Limit over a Sort whose skip + fetch the
TopK does not take goes there with that fetch), a Window whose calls share
one PARTITION BY, and a Join (the partitioned join under
``partitioned_join``, else the broadcast join); a hook that returns None
leaves the single-device plan.
"""

from __future__ import annotations

from typing import Optional

from .. import datatypes as dt
from ..datatypes import Field, Schema
from ..errors import PlanError
from . import logical as L
from . import physical as P
from .expressions import (AggregateCall, Alias, BinaryOp, Case, Cast,
                          ColumnRef, Expr, FieldAccess, FunctionCall, InList,
                          IsNull, Like, Literal, Not, Subscript, WindowCall,
                          conjoin, expr_columns, get_function,
                          split_conjunction)

_NUMERIC_ORDER = ["int8", "int16", "int32", "int64", "float32", "float64"]


def infer_expr_field(expr: Expr, schema: Schema) -> Field:
    if isinstance(expr, Alias):
        inner = infer_expr_field(expr.child, schema)
        return Field(expr.name, inner.dtype, inner.nullable)
    if isinstance(expr, ColumnRef):
        return schema.field(expr.name)
    if isinstance(expr, Literal):
        v = expr.value
        if isinstance(v, bool):
            return Field(expr.display_name(), dt.bool_, False)
        if isinstance(v, int):
            return Field(expr.display_name(), dt.int64, False)
        if isinstance(v, float):
            return Field(expr.display_name(), dt.float64, False)
        if isinstance(v, str):
            return Field(expr.display_name(), dt.utf8, False)
        if v is None:
            return Field("NULL", dt.utf8, True)
        raise PlanError(f"literal type {type(v)}")
    if isinstance(expr, (Like, IsNull, InList, Not)):
        return Field(expr.display_name(), dt.bool_, True)
    if isinstance(expr, Cast):
        return Field(expr.display_name(), expr.dtype, True)
    if isinstance(expr, Case):
        return _case_field(expr, schema)
    if isinstance(expr, FieldAccess):
        if isinstance(expr.child, ColumnRef) and \
                not schema.has_field(expr.child.name) and \
                schema.has_field(expr.field):
            # a table-qualified ref (a.seqname) before resolution
            return schema.field(expr.field)
        return _access_field(infer_expr_field(expr.child, schema), expr.field,
                             expr.field)
    if isinstance(expr, Subscript):
        child = infer_expr_field(expr.child, schema)
        iv = expr.index.value if isinstance(expr.index, Literal) else None
        if child.dtype.kind == dt.TypeKind.LIST:
            return Field(expr.display_name(), child.dtype.value_type, True)
        if isinstance(iv, str):
            name = expr.display_name() if child.dtype.kind == \
                dt.TypeKind.MAP else iv
            return _access_field(child, iv, name)
        raise PlanError(f"cannot type subscript on {child.dtype}")
    if isinstance(expr, BinaryOp):
        if expr.op in ("=", "!=", "<", "<=", ">", ">=", "and", "or"):
            return Field(expr.display_name(), dt.bool_, True)
        lf = infer_expr_field(expr.left, schema)
        rf = infer_expr_field(expr.right, schema)
        if expr.op == "/":
            out = lf.dtype if lf.dtype.kind.value.startswith("float") else (
                rf.dtype if rf.dtype.kind.value.startswith("float") else dt.int64)
        else:
            out = max([lf.dtype, rf.dtype],
                      key=lambda d: _NUMERIC_ORDER.index(d.kind.value)
                      if d.kind.value in _NUMERIC_ORDER else 0)
        return Field(expr.display_name(), out, True)
    if isinstance(expr, AggregateCall):
        if expr.fn == "count":
            return Field(expr.display_name(), dt.int64, False)
        if expr.fn == "avg" or expr.fn in L.VAR_FNS:
            return Field(expr.display_name(), dt.float64, True)
        if expr.fn == "string_agg":
            return Field(expr.display_name(), dt.utf8, True)
        inner = infer_expr_field(expr.child, schema)
        if expr.fn == "array_agg":
            return Field(expr.display_name(), dt.list_(inner.dtype), True)
        return Field(expr.display_name(), inner.dtype, True)
    if isinstance(expr, FunctionCall):
        _fn, dtype = get_function(expr.name)
        if callable(dtype):
            dtype = dtype([infer_expr_field(a, schema) for a in expr.args
                           if not isinstance(a, Literal)])
        return Field(expr.display_name(), dtype, True)
    if isinstance(expr, WindowCall):
        return infer_window_field(expr, expr.display_name(), schema)
    raise NotImplementedError(
        f"cannot type {expr!r}: not ported yet (ROADMAP Queue 1)")


def _access_field(child: Field, key: str, name: str) -> Field:
    """The type of a struct's field or of a map's value
    (exon_tpu/plan/planner.py:78-120)."""
    if child.dtype.kind == dt.TypeKind.STRUCT:
        for f in child.dtype.children:
            if f.name == key:
                return Field(name, f.dtype, True)
        raise PlanError(f"no field named {key!r} in struct {child.name!r}")
    if child.dtype.kind == dt.TypeKind.MAP:
        kv = child.dtype.value_type
        val = next(f.dtype for f in kv.children
                   if f.name in ("value", "values"))
        return Field(name, val, True)
    raise PlanError(f"field access on non-struct column {child.name!r}")


def infer_window_field(call: WindowCall, name: str, schema: Schema) -> Field:
    """A window call's result type (exon_tpu/plan/planner.py:150-158)."""
    if call.fn in ("row_number", "rank", "dense_rank", "count", "ntile"):
        return Field(name, dt.int64, False)
    if call.fn in ("percent_rank", "cume_dist"):
        return Field(name, dt.float64, False)
    if call.fn == "avg":
        return Field(name, dt.float64, True)
    inner = infer_expr_field(call.child, schema)
    return Field(name, inner.dtype, True)


def _case_field(expr: Case, schema: Schema) -> Field:
    """CASE's type (exon_tpu/plan/planner.py:120-135): utf8 when every
    non-NULL result is a string, else the widest numeric result."""
    results = [t for _w, t in expr.whens]
    if expr.else_ is not None:
        results.append(expr.else_)
    fields = [infer_expr_field(r, schema) for r in results
              if not (isinstance(r, Literal) and r.value is None)]
    if not fields:
        return Field("case", dt.utf8, True)
    if all(f.dtype.kind.value in ("utf8", "dictionary") for f in fields):
        return Field("case", dt.utf8, True)
    order = ["bool"] + _NUMERIC_ORDER
    out = max((f.dtype for f in fields),
              key=lambda d: order.index(d.kind.value)
              if d.kind.value in order else 0)
    return Field("case", out, True)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------


def optimize(plan: L.LogicalPlan) -> L.LogicalPlan:
    return _elide_identity_projects(_push_projection(_push_filters(
        _resolve_field_access(plan))))


def _push_filters(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Hand a Filter's conjuncts to the Scan below it where its provider
    takes them (exon_tpu/plan/planner.py:385-410); exact ones leave the
    residual Filter."""
    if isinstance(plan, L.Filter):
        child = _push_filters(plan.input)
        if isinstance(child, L.Scan):
            pushed, residual = [], []
            for c in split_conjunction(plan.predicate):
                verdict = child.provider.supports_filter_pushdown(c)
                if verdict in ("exact", "inexact"):
                    pushed.append(c)
                if verdict != "exact":
                    residual.append(c)
            if pushed:
                child = L.Scan(child.provider, child.table_name,
                               child.projection, child.filters + tuple(pushed))
            if not residual:
                return child
            return L.Filter(conjoin(residual), child)
        return L.Filter(plan.predicate, child)
    return _with_children(plan, [_push_filters(c) for c in plan.children()])


def _resolve_field_access(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Turn a parse-time dotted ref into a struct or map access where its
    head is a struct or map column of the node's input, and into a plain
    ColumnRef (the dot was a table qualifier) otherwise
    (exon_tpu/plan/planner.py:231)."""
    import dataclasses as _dc

    def resolve(e: Expr, schema: Schema) -> Expr:
        if isinstance(e, FieldAccess):
            child = resolve(e.child, schema)
            if isinstance(child, ColumnRef):
                if schema.has_field(child.name) and schema.field(
                        child.name).dtype.kind.value in ("struct", "map"):
                    return FieldAccess(child, e.field)
                return ColumnRef(e.field)
            return FieldAccess(child, e.field)
        if not e.children():
            return e
        return _dc.replace(e, **{f.name: walk(getattr(e, f.name), schema)
                                 for f in _dc.fields(e)})

    def walk(v, schema):
        # CASE keeps (when, then) pairs in a list
        if isinstance(v, Expr):
            return resolve(v, schema)
        if isinstance(v, (list, tuple)):
            return type(v)(walk(x, schema) for x in v)
        return v

    kids = [_resolve_field_access(c) for c in plan.children()]
    if not kids:
        return plan
    sch = kids[0].schema()
    if isinstance(plan, L.Filter):
        return L.Filter(resolve(plan.predicate, sch), kids[0])
    if isinstance(plan, L.Project):
        return L.Project([resolve(e, sch) for e in plan.exprs], kids[0])
    if isinstance(plan, L.Aggregate):
        return L.Aggregate([resolve(e, sch) for e in plan.group_exprs],
                           [resolve(e, sch) for e in plan.agg_exprs],
                           plan.agg_names, kids[0])
    if isinstance(plan, L.Sort):
        return L.Sort([(resolve(e, sch), asc) for e, asc in plan.keys],
                      kids[0], plan.fetch)
    return _with_children(plan, kids)


def _elide_identity_projects(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Drop Project nodes that are exact identities of their input schema."""
    plan = _with_children(plan, [_elide_identity_projects(c)
                                 for c in plan.children()])
    if isinstance(plan, L.Project):
        names = plan.input.schema().names
        if (len(plan.exprs) == len(names)
                and all(isinstance(e, ColumnRef) for e in plan.exprs)
                and [e.name for e in plan.exprs] == list(names)):
            return plan.input
    return plan


def _push_projection(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Compute required columns top-down; narrow Scan.projection."""

    def required(p: L.LogicalPlan, needed: Optional[set]) -> L.LogicalPlan:
        if isinstance(p, L.Scan):
            if needed is None:
                return p
            # the pushed filters' columns stay in the scan (:420-423)
            for f in p.filters:
                needed = needed | expr_columns(f)
            names = p.provider.schema().names
            cols = [n for n in names if n in needed]
            return L.Scan(p.provider, p.table_name, cols, p.filters)
        if isinstance(p, L.Filter):
            need = None if needed is None else needed | expr_columns(p.predicate)
            return L.Filter(p.predicate, required(p.input, need))
        if isinstance(p, L.Project):
            exprs = p.exprs
            if needed is not None:
                # a column nothing above reads is not computed
                names = p.schema().names
                exprs = [e for e, n in zip(exprs, names)
                         if n in needed] or exprs[:1]
            need = set()
            for e in exprs:
                need |= expr_columns(e)
            return L.Project(exprs, required(p.input, need))
        if isinstance(p, L.Aggregate):
            need = set()
            for e in list(p.group_exprs) + list(p.agg_exprs):
                need |= expr_columns(e)
            if (not p.group_exprs and not need and p.agg_exprs
                    and isinstance(p.input, L.Scan)
                    and all(e.fn == "count" and e.child is None
                            for e in p.agg_exprs)):
                # COUNT(*) over a bare scan reads no column, pushed filters
                # included: a provider that plans a residual filter widens
                # its own scan (:438-456)
                s = p.input
                return L.Aggregate(p.group_exprs, p.agg_exprs, p.agg_names,
                                   L.Scan(s.provider, s.table_name, [],
                                          s.filters))
            return L.Aggregate(p.group_exprs, p.agg_exprs, p.agg_names,
                               required(p.input, need))
        if isinstance(p, L.Limit):
            return L.Limit(p.skip, p.fetch, required(p.input, needed))
        if isinstance(p, L.Sort):
            need = None if needed is None else set(needed)
            if need is not None:
                for e, _asc in p.keys:
                    need |= expr_columns(e)
            return L.Sort(p.keys, required(p.input, need), p.fetch)
        if isinstance(p, L.Window):
            need = None
            if needed is not None:
                need = {n for n in needed if n not in p.names}
                for call in p.calls:
                    for e in call.children():
                        need |= expr_columns(e)
            return L.Window(p.calls, p.names, required(p.input, need))
        if isinstance(p, L.Join):
            return L.Join(*_join_needs(p, needed, required), p.on, p.how,
                          p.filter, p.right_names)
        if isinstance(p, L.Union) and needed is not None:
            return L.Union(_union_needs(p, needed, required))
        return _with_children(p, [required(c, None) for c in p.children()])

    return required(plan, None)


def _join_needs(p: L.Join, needed: Optional[set], required) -> tuple:
    """The join's children narrowed to the columns above it and its keys
    (exon_tpu/plan/planner.py:476-501)."""
    lneed = rneed = None
    if needed is not None:
        lschema, rschema = p.left.schema(), p.right.schema()
        on_cols: set = set()
        for le, re in p.on:
            on_cols |= expr_columns(le) | expr_columns(re)
        if p.filter is not None:
            on_cols |= expr_columns(p.filter)
        all_need = needed | on_cols
        lneed = {n for n in all_need if lschema.has_field(n)}
        rneed = {n for n in all_need if rschema.has_field(n)}
        # renamed output columns map back to the right child's bare names
        reverse = {v: k for k, v in (p.right_names or {}).items()}
        for n in all_need:
            if rschema.has_field(n):
                continue
            bare = reverse.get(n)
            if bare is None and n.endswith("_right"):
                bare = n[:-len("_right")]
            if bare is not None and rschema.has_field(bare):
                rneed.add(bare)
    return required(p.left, lneed), required(p.right, rneed)


def _union_needs(p: L.Union, needed: set, required) -> list:
    """A union's inputs narrowed to the positions above it needs (each
    input projected to its columns there, so a branch never reads a column
    nothing uses). The JAX planner reads every column of every branch;
    the rows are the same."""
    names = p.schema().names
    keep = [i for i, n in enumerate(names) if n in needed] or [0]
    kids = []
    for c in p.inputs:
        cols = [c.schema().names[i] for i in keep]
        kids.append(L.Project([ColumnRef(n) for n in cols],
                              required(c, set(cols))))
    return kids


def _with_children(plan: L.LogicalPlan, kids: list) -> L.LogicalPlan:
    if isinstance(plan, L.Filter):
        return L.Filter(plan.predicate, kids[0])
    if isinstance(plan, L.Project):
        return L.Project(plan.exprs, kids[0])
    if isinstance(plan, L.Aggregate):
        return L.Aggregate(plan.group_exprs, plan.agg_exprs, plan.agg_names,
                           kids[0])
    if isinstance(plan, L.Sort):
        return L.Sort(plan.keys, kids[0], plan.fetch)
    if isinstance(plan, L.Limit):
        return L.Limit(plan.skip, plan.fetch, kids[0])
    if isinstance(plan, L.Join):
        return L.Join(kids[0], kids[1], plan.on, plan.how, plan.filter,
                      plan.right_names)
    if isinstance(plan, L.Window):
        return L.Window(plan.calls, plan.names, kids[0])
    if isinstance(plan, L.Union):
        return L.Union(kids)
    if isinstance(plan, L.Repeat):
        return L.Repeat(plan.count_expr, kids[0])
    if isinstance(plan, L.CopyTo):
        return L.CopyTo(kids[0], plan.target_url, plan.file_format,
                        plan.options)
    if isinstance(plan, L.Explain):
        return L.Explain(kids[0], plan.analyze)
    return plan


# ---------------------------------------------------------------------------
# Lowering
# ---------------------------------------------------------------------------


def create_physical_plan(plan: L.LogicalPlan, device,
                         config=None) -> P.PhysicalPlan:
    """The physical plan of ``plan`` on ``device``. With ``distributed`` on
    in the session ``config``, the plans the mesh takes run over its
    shards (exon_tpu/plan/planner.py:568-662)."""
    dist = config is not None and getattr(config, "distributed", False)
    if dist:
        from ..parallel import distributed as D

    def lower(child):
        return create_physical_plan(child, device, config)

    if isinstance(plan, L.Scan):
        return plan.provider.scan(plan.projection, list(plan.filters),
                                  device=device)
    if isinstance(plan, L.Filter):
        return P.FilterExec(plan.predicate, lower(plan.input))
    if isinstance(plan, L.Project):
        return P.ProjectExec(plan.exprs, plan.schema(), lower(plan.input))
    if isinstance(plan, L.Aggregate):
        if dist:
            found = D.plan_distributed_aggregate(plan, device, config)
            if found is not None:
                return found
        # fuse a directly-underlying Filter into the aggregate: the mask
        # feeds the reductions, skipping row materialization
        pre_filter = None
        inner = plan.input
        if isinstance(inner, L.Filter):
            pre_filter = inner.predicate
            inner = inner.input
        return P.AggregateExec(plan.group_exprs, plan.agg_exprs, plan.schema(),
                               lower(inner), pre_filter=pre_filter)
    if isinstance(plan, L.Sort):
        if dist:
            found = D.plan_distributed_topk(plan, plan.fetch, device, config) \
                or D.plan_distributed_sort(plan, plan.fetch, device, config)
            if found is not None:
                return found
        return P.SortExec(plan.keys, lower(plan.input), plan.fetch)
    if isinstance(plan, L.Limit):
        top = plan.fetch is not None and isinstance(plan.input, L.Sort) and \
            plan.input.fetch is None
        if top and dist:
            fetch = plan.skip + plan.fetch
            found = D.plan_distributed_topk(plan.input, fetch, device,
                                            config) or \
                D.plan_distributed_sort(plan.input, fetch, device, config)
            if found is not None:
                return P.LimitExec(plan.skip, plan.fetch, found)
        # Limit(Sort) → SortExec with fetch (TopK): each sort run truncates
        # to skip + fetch rows (exon_tpu/plan/planner.py:612-620)
        if top:
            child = P.SortExec(plan.input.keys, lower(plan.input.input),
                               fetch=plan.skip + plan.fetch)
            return P.LimitExec(plan.skip, plan.fetch, child)
        return P.LimitExec(plan.skip, plan.fetch, lower(plan.input))
    if isinstance(plan, L.Join):
        from .join_exec import JoinExec

        if dist:
            found = (D.plan_distributed_partitioned_join(plan, device, config)
                     if getattr(config, "partitioned_join", False) else None) \
                or D.plan_distributed_join(plan, device, config)
            if found is not None:
                return found
        return JoinExec(lower(plan.left), lower(plan.right),
                        plan.on, plan.how, plan.filter, plan.schema())
    if isinstance(plan, L.Values):
        return P.ValuesExec(plan.out_schema, plan.rows, device)
    if isinstance(plan, L.Window):
        from .window_exec import WindowExec

        if dist:
            found = D.plan_distributed_window(plan, device, config)
            if found is not None:
                return found
        return WindowExec(plan.calls, plan.names, plan.schema(),
                          lower(plan.input), device)
    if isinstance(plan, L.Union):
        return P.UnionExec([lower(c) for c in plan.inputs])
    if isinstance(plan, L.Repeat):
        return P.RepeatExec(plan.count_expr, lower(plan.input))
    if isinstance(plan, L.CopyTo):
        raise NotImplementedError(
            "COPY is not ported yet (ROADMAP Queue 1, item 10: sinks)")
    if isinstance(plan, L.Explain):
        raise NotImplementedError(
            "EXPLAIN is not ported yet (ROADMAP Queue 1, item 11: surfaces)")
    raise PlanError(f"cannot lower {type(plan).__name__}")
