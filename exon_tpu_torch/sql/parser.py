"""Recursive-descent SQL parser → statement AST.

Covers the reference's SQL surface: DataFusion SELECT queries plus Exon's
COPY/CREATE EXTERNAL TABLE extensions (exon-core/src/sql/parser.rs:26-72).

Copied unchanged from exon_tpu/sql/parser.py:1-1137 (pure Python, no JAX);
it imports the port's ``datatypes``, ``errors`` and ``plan.expressions``.
"""

from __future__ import annotations

from typing import Optional

from .. import datatypes as dt
from ..errors import SqlError
from ..plan.expressions import (AggregateCall, Alias, BinaryOp, Case, Cast,
                                ColumnRef, ExistsSubquery, Expr, FieldAccess,
                                FunctionCall, InList, InSubquery, IsNull,
                                Like, Literal, Not, Subquery, Subscript, WindowCall)
from . import ast as A
from .lexer import Token, tokenize

AGG_FUNCS = {"count", "sum", "min", "max", "avg",
             # second-moment family (device streaming partials)
             "stddev", "stddev_samp", "stddev_pop",
             "var", "variance", "var_samp", "var_pop",
             # holistic (materializing) aggregates
             "median", "array_agg", "string_agg"}

_TYPE_NAMES = {
    "int": dt.int64, "integer": dt.int64, "bigint": dt.int64,
    "smallint": dt.int16, "tinyint": dt.int8,
    "float": dt.float32, "real": dt.float32, "double": dt.float64,
    "boolean": dt.bool_, "bool": dt.bool_,
    "varchar": dt.utf8, "text": dt.utf8, "string": dt.utf8, "utf8": dt.utf8,
}


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0
        # WindowCalls using OVER <name>, resolved by the WINDOW clause
        self._named_over: list = []

    # -- token helpers ------------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def accept_kw(self, *words: str) -> bool:
        t = self.peek()
        if t.kind == "kw" and t.value.lower() in words:
            self.next()
            return True
        return False

    def expect_kw(self, word: str) -> None:
        if not self.accept_kw(word):
            raise SqlError(f"expected {word.upper()} near {self.peek().value!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t.kind == "op" and t.value == op:
            self.next()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise SqlError(f"expected {op!r} near {self.peek().value!r}")

    def ident(self) -> str:
        t = self.next()
        if t.kind not in ("ident", "kw"):
            raise SqlError(f"expected identifier near {t.value!r}")
        return t.value

    # -- statements ---------------------------------------------------------

    def parse_statements(self) -> list:
        out = []
        while self.peek().kind != "eof":
            out.append(self.parse_statement())
            if self.peek().kind == "eof":
                break
            if not self.accept_op(";"):
                raise SqlError(
                    f"unexpected {self.peek().value!r} after statement — "
                    "separate statements with ';'")
            while self.accept_op(";"):
                pass
        return out

    def parse_statement(self):
        t = self.peek()
        word = t.value.lower() if t.kind == "kw" else ""
        if word == "with":
            return self.parse_with()
        if word == "select" or (t.kind == "op" and t.value == "("):
            return self.parse_select()
        if word == "create":
            return self.parse_create()
        if word == "copy":
            return self.parse_copy()
        if word == "set":
            return self.parse_set()
        if word == "describe":
            self.next()
            return A.DescribeStmt(self.qualified_name())
        if word == "show":
            self.next()
            self.expect_kw("tables")
            return A.ShowTablesStmt()
        if word == "explain":
            self.next()
            analyze = self.accept_kw("analyze")
            return A.ExplainStmt(self.parse_statement(), analyze)
        if word == "insert":
            return self.parse_insert()
        if word == "values":
            return self.parse_values()
        if word == "drop":
            self.next()
            self.expect_kw("table")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return A.DropTableStmt(self.qualified_name(), if_exists)
        raise SqlError(f"unsupported statement near {t.value!r}")

    def qualified_name(self) -> str:
        parts = [self.ident()]
        while self.accept_op("."):
            parts.append(self.ident())
        return ".".join(parts)

    # -- SELECT -------------------------------------------------------------

    def parse_select(self) -> A.SelectStmt:
        stmt = self._parse_select_body()
        # set-operation chain (left-associative; reference: DataFusion's
        # UNION/INTERSECT/EXCEPT, including the multiset ALL variants).
        while True:
            if self.accept_kw("union"):
                all_flag = self.accept_kw("all")
                stmt.set_ops = list(stmt.set_ops) + [
                    ("union", all_flag, self._parse_select_body())]
            elif self.accept_kw("intersect"):
                all_flag = self.accept_kw("all")
                stmt.set_ops = list(stmt.set_ops) + [
                    ("intersect", all_flag, self._parse_select_body())]
            elif self.accept_kw("except"):
                if self.accept_kw("all"):
                    stmt.set_ops = list(stmt.set_ops) + [
                        ("except", True, self._parse_select_body())]
                    continue
                stmt.set_ops = list(stmt.set_ops) + [
                    ("except", False, self._parse_select_body())]
            else:
                break
        if self.accept_kw("order"):
            self.expect_kw("by")
            stmt.order_by = [self.parse_order_key()]
            while self.accept_op(","):
                stmt.order_by.append(self.parse_order_key())
        if self.accept_kw("limit"):
            stmt.limit = int(self.next().value)
        if self.accept_kw("offset"):
            stmt.offset = int(self.next().value)
        return stmt

    def _parse_select_body(self) -> A.SelectStmt:
        # named-OVER references scope to their own select body: a subquery
        # in FROM parses after the outer SELECT list, so without a fresh
        # list per body the nested end-of-body check would see the outer
        # body's still-unresolved OVER <name> refs and spuriously fail
        saved = self._named_over
        self._named_over = []
        try:
            return self._parse_select_body_impl()
        finally:
            self._named_over = saved

    def _parse_select_body_impl(self) -> A.SelectStmt:
        if self.accept_op("("):
            inner = self.parse_select()
            self.expect_op(")")
            stmt = inner
        else:
            self.expect_kw("select")
            stmt = A.SelectStmt(projections=[])
            stmt.distinct = self.accept_kw("distinct")
            if stmt.distinct and self.peek().value.lower() == "on" and \
                    self.peek(1).value == "(":
                # DISTINCT ON (exprs): first row per key by ORDER BY
                self.next()
                self.expect_op("(")
                on_exprs = [self.parse_expr()]
                while self.accept_op(","):
                    on_exprs.append(self.parse_expr())
                self.expect_op(")")
                stmt.distinct = False
                stmt.distinct_on = on_exprs
            stmt.projections = self.parse_projections()
            if self.accept_kw("from"):
                stmt.from_ = self.parse_table_ref()
                while True:
                    how = None
                    if self.accept_kw("join") or self.accept_kw("inner"):
                        if self.peek().value.lower() == "join":
                            self.next()
                        how = "inner"
                    elif self.accept_kw("left"):
                        self.accept_kw("outer")
                        self.expect_kw("join")
                        how = "left"
                    elif self.accept_kw("right"):
                        self.accept_kw("outer")
                        self.expect_kw("join")
                        how = "right"
                    elif self.accept_kw("full"):
                        self.accept_kw("outer")
                        self.expect_kw("join")
                        how = "full"
                    elif self.peek().value.lower() == "cross" and \
                            self.peek(1).value.lower() == "join":
                        self.next()
                        self.next()
                        how = "cross"
                    elif self.accept_op(","):
                        how = "cross"  # comma join: filter via WHERE
                    else:
                        break
                    table = self.parse_table_ref()
                    on = using = None
                    if how != "cross" and self.accept_kw("on"):
                        on = self.parse_expr()
                    elif self.accept_kw("using"):
                        self.expect_op("(")
                        using = [self.ident()]
                        while self.accept_op(","):
                            using.append(self.ident())
                        self.expect_op(")")
                    stmt.joins.append(A.JoinClause(how, table, on, using))
            if self.accept_kw("where"):
                stmt.where = self.parse_expr()
            if self.accept_kw("group"):
                self.expect_kw("by")
                w = self.peek()
                word = w.value.lower() if w.kind in ("kw", "ident") else ""
                if word in ("rollup", "cube"):
                    self.next()
                    self.expect_op("(")
                    cols = [self.parse_expr()]
                    while self.accept_op(","):
                        cols.append(self.parse_expr())
                    self.expect_op(")")
                    stmt.group_by = cols
                    if word == "rollup":
                        stmt.group_sets = [cols[:i] for i in
                                           range(len(cols), -1, -1)]
                    else:
                        import itertools
                        stmt.group_sets = [
                            list(c) for r in range(len(cols), -1, -1)
                            for c in itertools.combinations(cols, r)]
                elif word == "grouping" and \
                        self.peek(1).value.lower() == "sets":
                    self.next()
                    self.next()
                    self.expect_op("(")
                    sets = []
                    while True:
                        if self.accept_op("("):
                            s = []
                            if not self.accept_op(")"):
                                s.append(self.parse_expr())
                                while self.accept_op(","):
                                    s.append(self.parse_expr())
                                self.expect_op(")")
                            sets.append(s)
                        else:
                            sets.append([self.parse_expr()])
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                    cols, seen = [], set()
                    for s in sets:
                        for e in s:
                            if repr(e) not in seen:
                                seen.add(repr(e))
                                cols.append(e)
                    stmt.group_by = cols
                    stmt.group_sets = sets
                else:
                    stmt.group_by = [self.parse_expr()]
                    while self.accept_op(","):
                        stmt.group_by.append(self.parse_expr())
            if self.accept_kw("having"):
                stmt.having = self.parse_expr()
            if self.peek().value.lower() == "window" and \
                    self.peek(1).kind == "ident":
                self.next()
                specs = {}
                while True:
                    nm = self.ident().lower()
                    if not self.accept_kw("as"):
                        raise SqlError("expected AS in WINDOW clause")
                    self.expect_op("(")
                    specs[nm] = self._parse_window_spec()
                    self.expect_op(")")
                    if not self.accept_op(","):
                        break
                unresolved = []
                for wc in self._named_over:
                    spec = specs.get(wc.order_by)
                    if spec is None:
                        unresolved.append(wc)
                        continue
                    wc.partition_by, wc.order_by, wc.frame = spec
                self._named_over = unresolved
            if self._named_over:
                names = sorted({w.order_by for w in self._named_over
                                if isinstance(w.order_by, str)})
                self._named_over = []
                raise SqlError(f"unknown window name(s): {names}")
        return stmt

    def parse_with(self) -> A.SelectStmt:
        """WITH name AS (select) [, …] select — CTEs attach to the main
        statement and are planned as scoped named subqueries."""
        self.expect_kw("with")
        ctes = []
        while True:
            name = self.ident()
            self.expect_kw("as")
            self.expect_op("(")
            if self.peek().value.lower() == "with":
                sub = self.parse_with()
            else:
                sub = self.parse_select()
            self.expect_op(")")
            ctes.append((name, sub))
            if not self.accept_op(","):
                break
        stmt = self.parse_statement()
        if not isinstance(stmt, A.SelectStmt):
            raise SqlError("WITH must be followed by SELECT")
        stmt.ctes = ctes + list(stmt.ctes)
        return stmt

    def parse_order_key(self):
        from ..plan.expressions import NullsOrder

        e = self.parse_expr()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        if self.peek().value.lower() == "nulls":
            self.next()
            d = self.next().value.lower()
            if d not in ("first", "last"):
                raise SqlError(f"expected FIRST/LAST near {d!r}")
            e = NullsOrder(e, d == "first")
        return (e, asc)

    def parse_projections(self) -> list:
        out = []
        while True:
            if self.accept_op("*"):
                out.append(("*", None))
            else:
                e = self.parse_expr()
                alias = None
                if self.accept_kw("as"):
                    alias = self.ident()
                elif self.peek().kind == "ident" and self.peek(1).value not in ("(", "."):
                    alias = self.ident()
                out.append((e, alias))
            if not self.accept_op(","):
                break
        return out

    def parse_table_ref(self):
        if self.accept_op("("):
            inner = self.parse_select()
            self.expect_op(")")
            alias = self._maybe_alias()
            return A.SubqueryRef(inner, alias)
        name = self.qualified_name()
        if self.accept_op("("):
            args = []
            if not self.accept_op(")"):
                args.append(self._func_arg())
                while self.accept_op(","):
                    args.append(self._func_arg())
                self.expect_op(")")
            return A.TableFunc(name, args, self._maybe_alias())
        return A.TableName(name, self._maybe_alias())

    def _func_arg(self):
        t = self.peek()
        if t.kind == "str":
            self.next()
            return t.value
        if t.kind == "num":
            self.next()
            return float(t.value) if "." in t.value else int(t.value)
        if t.kind == "kw" and t.value.lower() in ("true", "false"):
            self.next()
            return t.value.lower() == "true"
        return self.parse_expr()

    # idents that start a clause and therefore can't be a bare table alias
    _NO_ALIAS = {"cross", "natural", "lateral", "window"}

    def _maybe_alias(self) -> Optional[str]:
        if self.accept_kw("as"):
            return self.ident()
        t = self.peek()
        if t.kind == "ident" and t.value.lower() not in self._NO_ALIAS:
            return self.ident()
        return None

    # -- CREATE / COPY / SET ------------------------------------------------

    def parse_create(self):
        self.expect_kw("create")
        # lookahead across optional OR REPLACE / TEMPORARY for FUNCTION
        k = 0
        if self.peek(0).value.lower() == "or" and \
                self.peek(1).value.lower() == "replace":
            k = 2
        if self.peek(k).value.lower() == "temporary":
            k += 1
        if self.peek(k).kind in ("kw", "ident") and \
                self.peek(k).value.lower() == "function":
            return self._parse_create_function()
        if not self.accept_kw("external"):
            return self._parse_create_memory()
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.qualified_name()
        partition_cols: list[str] = []
        options: dict = {}
        fmt = None
        location = None
        # clauses in flexible order (LOCATION may precede or follow OPTIONS)
        while True:
            if self.accept_kw("stored"):
                self.expect_kw("as")
                fmt = self.ident()
            elif self.accept_kw("partitioned"):
                self.expect_kw("by")
                self.expect_op("(")
                partition_cols.append(self.ident())
                while self.accept_op(","):
                    partition_cols.append(self.ident())
                self.expect_op(")")
            elif self.accept_kw("options"):
                self.expect_op("(")
                while True:
                    k = self.next().value
                    v = self.next().value
                    options[k.strip("'")] = v
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            elif self.accept_kw("compression"):
                self.expect_kw("type")
                options["format.compression"] = self.ident()
            elif self.accept_kw("location"):
                location = self.next().value
            else:
                break
        if location is None:
            raise SqlError(f"expected LOCATION near {self.peek().value!r}")
        if fmt is None:
            raise SqlError("CREATE EXTERNAL TABLE requires STORED AS <format>")
        return A.CreateExternalTable(name, fmt.upper(), location, options,
                                     partition_cols, if_not_exists)

    def _parse_create_function(self):
        """CREATE [OR REPLACE] [TEMPORARY] FUNCTION name … — parsed whole,
        surfaced as an unsupported-function statement. The reference routes
        it to ExonFunctionFactory which rejects it with UnsupportedFunction
        (session_context/function_factory.rs:28-44); parsing here means the
        user gets that clean error instead of a syntax error."""
        if self.accept_kw("or"):
            self.expect_kw("replace")
        self.accept_kw("temporary")
        if self.peek().value.lower() != "function":
            raise SqlError(f"expected FUNCTION near {self.peek().value!r}")
        self.next()
        name = self.qualified_name()
        # consume the remainder of the statement (args, RETURNS, body)
        while self.peek().kind != "eof" and not (
                self.peek().kind == "op" and self.peek().value == ";"):
            self.next()
        return A.CreateFunctionStmt(name)

    def _parse_create_memory(self) -> "A.CreateMemoryTable":
        """CREATE TABLE name [(col type, …)] [AS SELECT…|AS VALUES …] — the
        in-memory table surface the reference gets from stock DataFusion
        (used by sequence-udfs.slt / quality-score-udfs.slt)."""
        self.expect_kw("table")
        if_not_exists = False
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            if_not_exists = True
        name = self.qualified_name()
        columns: list[tuple[str, str]] = []
        if self.accept_op("("):
            while True:
                cname = self.ident()
                ctype = self.ident()
                # swallow compound types like VARCHAR(10)
                if self.accept_op("("):
                    while not self.accept_op(")"):
                        self.next()
                columns.append((cname, ctype.lower()))
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        query = None
        if self.accept_kw("as"):
            if self.peek().value.lower() == "values":
                query = self.parse_values()
            else:
                query = self.parse_select()
        return A.CreateMemoryTable(name, columns, query, if_not_exists)

    def parse_values(self) -> "A.ValuesQuery":
        self.expect_kw("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.parse_expr()]
            while self.accept_op(","):
                row.append(self.parse_expr())
            self.expect_op(")")
            rows.append(row)
            if not self.accept_op(","):
                break
        return A.ValuesQuery(rows)

    def parse_insert(self) -> "A.InsertStmt":
        self.expect_kw("insert")
        self.expect_kw("into")
        name = self.qualified_name()
        cols = []
        if self.accept_op("("):
            cols.append(self.ident())
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
        vq = self.parse_values()
        return A.InsertStmt(name, cols, vq.rows)

    def parse_copy(self) -> A.CopyToStmt:
        self.expect_kw("copy")
        if self.accept_op("("):
            src = self.parse_select()
            self.expect_op(")")
        else:
            src = A.TableName(self.qualified_name())
        self.expect_kw("to")
        target = self.next().value
        fmt = None
        options: dict = {}
        while True:
            if self.accept_kw("stored"):
                self.expect_kw("as")
                fmt = self.ident().upper()
            elif self.accept_kw("options"):
                self.expect_op("(")
                while True:
                    k = self.next().value
                    v = self.next().value
                    options[k.strip("'")] = v
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            else:
                break
        return A.CopyToStmt(src, target, fmt, options)

    def parse_set(self) -> A.SetStmt:
        self.expect_kw("set")
        key = self.qualified_name()
        self.expect_op("=")
        t = self.next()
        return A.SetStmt(key, t.value)

    # -- expressions --------------------------------------------------------

    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        e = self.parse_and()
        while self.accept_kw("or"):
            e = BinaryOp("or", e, self.parse_and())
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.accept_kw("and"):
            e = BinaryOp("and", e, self.parse_not())
        return e

    def parse_not(self) -> Expr:
        if self.accept_kw("not"):
            return Not(self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> Expr:
        e = self.parse_additive()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "<>", "!=", "<", "<=", ">", ">="):
                self.next()
                op = "!=" if t.value == "<>" else t.value
                e = BinaryOp(op, e, self.parse_additive())
            elif t.kind == "kw" and t.value.lower() in ("like", "ilike"):
                self.next()
                pat = self.next()
                e = Like(e, pat.value, t.value.lower() == "ilike",
                         escape=self._maybe_escape())
            elif t.kind == "kw" and t.value.lower() == "not" and \
                    self.peek(1).value.lower() in ("like", "ilike", "in", "between"):
                self.next()
                nxt = self.next().value.lower()
                if nxt in ("like", "ilike"):
                    pat = self.next()
                    e = Like(e, pat.value, nxt == "ilike", negated=True,
                             escape=self._maybe_escape())
                elif nxt == "in":
                    e = self._parse_in(e, negated=True)
                else:
                    e = self._parse_between(e, negated=True)
            elif t.kind == "kw" and t.value.lower() == "between":
                self.next()
                e = self._parse_between(e, negated=False)
            elif t.kind == "kw" and t.value.lower() == "in":
                self.next()
                e = self._parse_in(e, negated=False)
            elif t.kind == "kw" and t.value.lower() == "is":
                self.next()
                negated = self.accept_kw("not")
                if self.peek().value.lower() == "distinct":
                    # IS [NOT] DISTINCT FROM: null-safe compare, lowered to
                    # (nullity(a) != nullity(b)) OR (a != b) — each side
                    # already evaluates NULL compares to false
                    self.next()
                    if self.peek().value.lower() == "from":
                        self.next()
                    rhs = self.parse_additive()
                    if isinstance(rhs, Literal) and rhs.value is None:
                        e = IsNull(e, negated=not negated)
                    else:
                        distinct = BinaryOp(
                            "or",
                            BinaryOp("!=", IsNull(e, False),
                                     IsNull(rhs, False)),
                            BinaryOp("!=", e, rhs))
                        e = Not(distinct) if negated else distinct
                else:
                    self.expect_kw("null")
                    e = IsNull(e, negated)
            else:
                return e

    def _parse_between(self, e: Expr, negated: bool) -> Expr:
        lo = self.parse_additive()
        self.expect_kw("and")
        hi = self.parse_additive()
        between = BinaryOp("and", BinaryOp(">=", e, lo), BinaryOp("<=", e, hi))
        return Not(between) if negated else between

    def _parse_in(self, e: Expr, negated: bool) -> Expr:
        self.expect_op("(")
        if self.peek().value.lower() in ("select", "with"):
            sub = self.parse_statement() if \
                self.peek().value.lower() == "with" else self.parse_select()
            self.expect_op(")")
            return InSubquery(e, sub, negated)
        vals = [self.parse_expr()]
        while self.accept_op(","):
            vals.append(self.parse_expr())
        self.expect_op(")")
        return InList(e, vals, negated)

    def parse_additive(self) -> Expr:
        e = self.parse_multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                e = BinaryOp(t.value, e, self.parse_multiplicative())
            elif t.kind == "op" and t.value == "||":
                # SQL string concatenation (NULL-propagating, unlike
                # concat() which skips NULLs — DataFusion semantics)
                self.next()
                e = FunctionCall("concat_op", [e, self.parse_multiplicative()])
            else:
                return e

    def parse_multiplicative(self) -> Expr:
        e = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                e = BinaryOp(t.value, e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> Expr:
        if self.accept_op("-"):
            inner = self.parse_unary()
            if isinstance(inner, Literal) and isinstance(inner.value, (int, float)):
                return Literal(-inner.value)
            return BinaryOp("-", Literal(0), inner)
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> Expr:
        e = self.parse_primary()
        while self.accept_op("::"):
            tname = self.ident().lower()
            if tname not in _TYPE_NAMES:
                raise SqlError(f"unknown type {tname!r}")
            e = Cast(e, _TYPE_NAMES[tname])
        return e

    def parse_primary(self) -> Expr:
        t = self.peek()
        if t.kind == "op" and t.value == "(":
            if self.peek(1).value.lower() in ("select", "with"):
                self.next()
                sub = self.parse_statement() if \
                    self.peek().value.lower() == "with" else self.parse_select()
                self.expect_op(")")
                return Subquery(sub)
            self.next()
            e = self.parse_expr()
            self.expect_op(")")
            return e
        if t.kind == "str":
            self.next()
            return Literal(t.value)
        if t.kind == "num":
            self.next()
            if "." in t.value or "e" in t.value.lower():
                return Literal(float(t.value))
            return Literal(int(t.value))
        if t.kind == "kw":
            w = t.value.lower()
            if w == "null":
                self.next()
                return Literal(None)
            if w in ("true", "false"):
                self.next()
                return Literal(w == "true")
            if w == "cast":
                self.next()
                self.expect_op("(")
                inner = self.parse_expr()
                self.expect_kw("as")
                tname = self.ident().lower()
                self.expect_op(")")
                if tname not in _TYPE_NAMES:
                    raise SqlError(f"unknown type {tname!r}")
                return Cast(inner, _TYPE_NAMES[tname])
            if w == "case":
                return self.parse_case()
            if w == "exists":
                self.next()
                self.expect_op("(")
                sub = self.parse_statement() if \
                    self.peek().value.lower() == "with" else self.parse_select()
                self.expect_op(")")
                return ExistsSubquery(sub)
        if t.kind == "op" and t.value == "[":
            # array literal → make_array call (DataFusion sugar)
            self.next()
            elems = []
            if not self.accept_op("]"):
                elems.append(self.parse_expr())
                while self.accept_op(","):
                    elems.append(self.parse_expr())
                self.expect_op("]")
            return FunctionCall("make_array", elems)
        if t.kind in ("ident", "kw"):
            name = self.ident()
            if self.accept_op("("):
                return self._postfix(self._parse_call(name))
            # dotted chains parse as struct field access; the planner's
            # resolve pass turns table-qualifier dots back into ColumnRefs
            return self._postfix(ColumnRef(name))
        raise SqlError(f"unexpected token {t.value!r} in expression")

    def _postfix(self, expr: Expr) -> Expr:
        """Chained ``.field`` / ``[index]`` accesses (struct fields, map
        keys, 1-based list elements — DataFusion subscript surface)."""
        while True:
            if self.accept_op("."):
                expr = FieldAccess(expr, self.ident())
            elif self.peek().kind == "op" and self.peek().value == "[":
                self.next()
                idx = self.parse_expr()
                self.expect_op("]")
                expr = Subscript(expr, idx)
            else:
                return expr

    def parse_case(self) -> Expr:
        self.expect_kw("case")
        operand = None
        if self.peek().value.lower() not in ("when",):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            w = self.parse_expr()
            self.expect_kw("then")
            t = self.parse_expr()
            whens.append((w, t))
        if not whens:
            raise SqlError("CASE requires at least one WHEN")
        else_ = None
        if self.accept_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return Case(operand, whens, else_)

    _WINDOW_FUNCS = {"row_number", "rank", "dense_rank", "lag", "lead",
                     "first_value", "last_value", "nth_value", "ntile",
                     "percent_rank", "cume_dist"}

    def _parse_call(self, name: str) -> Expr:
        lname = name.lower()
        distinct = self.accept_kw("distinct")
        star = False
        if lname in ("substring", "substr") and not distinct:
            # SQL form: substring(s FROM start [FOR length])
            e = self.parse_expr()
            if self.accept_kw("from") or (
                    self.peek().value.lower() == "from" and self.next()):
                args = [e, self.parse_expr()]
                if self.peek().value.lower() == "for":
                    self.next()
                    args.append(self.parse_expr())
                self.expect_op(")")
                return FunctionCall("substr", args)
            args = [e]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return FunctionCall("substr", args)
        if lname == "trim" and not distinct and \
                self.peek().value.lower() in ("both", "leading", "trailing"):
            # SQL form: trim([BOTH|LEADING|TRAILING] [chars] FROM s)
            side = self.next().value.lower()
            chars = None
            if self.peek().value.lower() != "from":
                chars = self.parse_expr()
            self.next()  # FROM
            s = self.parse_expr()
            self.expect_op(")")
            fn = {"both": "btrim", "leading": "ltrim",
                  "trailing": "rtrim"}[side]
            return FunctionCall(fn, [s] + ([chars] if chars else []))
        if lname == "position" and not distinct:
            # SQL form: position(needle IN haystack) — the needle parses
            # below comparison level so IN isn't taken as the operator
            e = self.parse_additive()
            if self.accept_kw("in"):
                hay = self.parse_expr()
                self.expect_op(")")
                return FunctionCall("strpos", [hay, e])
            args = [e]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return FunctionCall("strpos", args)
        if lname == "overlay" and not distinct:
            # SQL form: overlay(s PLACING rep FROM start [FOR length])
            s = self.parse_expr()
            if self.peek().value.lower() == "placing":
                self.next()
                rep = self.parse_expr()
                self.expect_kw("from")
                start = self.parse_expr()
                args = [s, rep, start]
                if self.peek().value.lower() == "for":
                    self.next()
                    args.append(self.parse_expr())
                self.expect_op(")")
                return FunctionCall("overlay", args)
            args = [s]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
            return FunctionCall("overlay", args)
        if self.accept_op(")"):
            args = []
        elif self.accept_op("*"):
            self.expect_op(")")
            star = True
            args = []
        else:
            args = [self.parse_expr()]
            while self.accept_op(","):
                args.append(self.parse_expr())
            self.expect_op(")")
        # aggregate FILTER (WHERE cond) → agg over a CASE indicator
        if self.peek().value.lower() == "filter" and \
                self.peek(1).value == "(" and lname in AGG_FUNCS:
            self.next()
            self.expect_op("(")
            self.expect_kw("where")
            cond = self.parse_expr()
            self.expect_op(")")
            src = args[0] if args else Literal(1)
            args = [Case(None, [(cond, src)], None)]
            star = False
        over = self._maybe_over()
        if over is not None:
            if star and lname != "count":
                raise SqlError(f"{name}(*) not supported")
            if lname not in AGG_FUNCS and lname not in self._WINDOW_FUNCS:
                raise SqlError(f"unsupported window function {name!r}")
            child = args[0] if args else None
            offset, default = 1, None
            if lname in ("lag", "lead"):
                if len(args) > 1:
                    if not isinstance(args[1], Literal):
                        raise SqlError(f"{name} offset must be a literal")
                    offset = int(args[1].value)
                if len(args) > 2:
                    if not isinstance(args[2], Literal):
                        raise SqlError(f"{name} default must be a literal")
                    default = args[2].value
            if lname == "ntile":
                if len(args) != 1 or not isinstance(args[0], Literal):
                    raise SqlError("ntile(n) needs a literal bucket count")
                child, offset = None, int(args[0].value)
            if lname == "nth_value":
                if len(args) != 2 or not isinstance(args[1], Literal) \
                        or int(args[1].value) < 1:
                    raise SqlError("nth_value(expr, n) needs a positive "
                                   "literal n")
                offset = int(args[1].value)
            wc = WindowCall(lname, child, over[0], over[1], offset,
                            default, over[2])
            if over[0] == "\x00named":
                wc.partition_by = []
                self._named_over.append(wc)
            return wc
        if star:
            if lname == "count":
                return AggregateCall("count", None, distinct)
            raise SqlError(f"{name}(*) not supported")
        if lname in ("bool_and", "every", "bool_or"):
            # lower onto min/max over a 0/1 indicator (datafusion builtins)
            if len(args) != 1:
                raise SqlError(f"{name} takes one argument")
            ind = Case(None, [(args[0], Literal(1))], Literal(0))
            mfn = "max" if lname == "bool_or" else "min"
            return BinaryOp("=", AggregateCall(mfn, ind, False), Literal(1))
        if lname == "approx_distinct":
            if len(args) != 1:
                raise SqlError("approx_distinct takes one argument")
            return AggregateCall("count", args[0], True)  # exact count
        if lname == "approx_median":
            if len(args) != 1:
                raise SqlError("approx_median takes one argument")
            return AggregateCall("median", args[0], distinct)
        if lname in ("corr", "covar", "covar_samp", "covar_pop"):
            # lower onto single-argument sum/count partials; pair counting
            # masks each side by the other's nullity so NULLs in either
            # column drop the pair (datafusion's accumulator semantics)
            if len(args) != 2:
                raise SqlError(f"{name} takes two arguments")
            x, y = args
            xy = BinaryOp("*", x, y)
            xm = Case(None, [(IsNull(y, True), x)], None)
            ym = Case(None, [(IsNull(x, True), y)], None)
            n = Cast(AggregateCall("count", xy, False), dt.float64)
            sxy = AggregateCall("sum", xy, False)
            sx = AggregateCall("sum", xm, False)
            sy = AggregateCall("sum", ym, False)
            if lname == "corr":
                sxx = AggregateCall("sum", BinaryOp("*", xm, xm), False)
                syy = AggregateCall("sum", BinaryOp("*", ym, ym), False)
                num = BinaryOp("-", BinaryOp("*", n, sxy),
                               BinaryOp("*", sx, sy))
                vx = BinaryOp("-", BinaryOp("*", n, sxx),
                              BinaryOp("*", sx, sx))
                vy = BinaryOp("-", BinaryOp("*", n, syy),
                              BinaryOp("*", sy, sy))
                den = BinaryOp("*", FunctionCall("sqrt", [vx]),
                               FunctionCall("sqrt", [vy]))
                return Case(None, [(BinaryOp(">", den, Literal(0)),
                                    BinaryOp("/", num, den))], None)
            cov = BinaryOp("-", sxy,
                           BinaryOp("/", BinaryOp("*", sx, sy), n))
            if lname == "covar_pop":
                return Case(None, [(BinaryOp(">", n, Literal(0)),
                                    BinaryOp("/", cov, n))], None)
            return Case(None, [(BinaryOp(">", n, Literal(1)),
                                BinaryOp("/", cov,
                                         BinaryOp("-", n, Literal(1))))],
                        None)
        if lname in AGG_FUNCS:
            child = args[0] if args else None
            extra = ()
            if lname == "string_agg":
                if len(args) != 2 or not isinstance(args[1], Literal):
                    raise SqlError(
                        "string_agg(expr, separator) needs a literal "
                        "separator")
                extra = (args[1].value,)
            elif len(args) > 1:
                raise SqlError(f"{name} takes one argument")
            return AggregateCall(lname, child, distinct, extra)
        return FunctionCall(lname, args)

    def _parse_window_spec(self):
        """The body of a window specification (inside parentheses)."""
        partition_by: list = []
        order_by: list = []
        nxt = self.peek().value.lower()
        if nxt == "partition":
            self.next()
            self.expect_kw("by")
            partition_by.append(self.parse_expr())
            while self.accept_op(","):
                partition_by.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_key())
            while self.accept_op(","):
                order_by.append(self.parse_order_key())
        frame = self._maybe_frame()
        return partition_by, order_by, frame

    def _maybe_over(self):
        t = self.peek()
        if t.kind in ("ident", "kw") and t.value.lower() == "over":
            if self.peek(1).value == "(":
                self.next()
                self.expect_op("(")
                spec = self._parse_window_spec()
                self.expect_op(")")
                return spec
            if self.peek(1).kind == "ident":
                # OVER w — a named window; resolved after the WINDOW clause
                self.next()
                return ("\x00named", self.ident().lower(), None)
        return None

    def _maybe_escape(self):
        """Optional ESCAPE '<ch>' clause after a LIKE pattern."""
        t = self.peek()
        if t.kind in ("kw", "ident") and t.value.lower() == "escape":
            self.next()
            ch = self.next().value
            if len(ch) != 1:
                raise SqlError("ESCAPE must be a single character, got "
                               f"{ch!r}")
            return ch
        return None

    def _maybe_frame(self):
        """ROWS/RANGE [BETWEEN] frame clause → (kind, lo, hi) offsets
        (None = unbounded). The default RANGE frame returns None — the
        engine's running path already has those semantics."""
        t = self.peek()
        word = t.value.lower() if t.kind in ("kw", "ident") else ""
        if word not in ("rows", "range"):
            return None
        self.next()
        kind = word

        def bound():
            w = self.peek().value.lower()
            if w == "unbounded":
                self.next()
                d = self.next().value.lower()
                if d not in ("preceding", "following"):
                    raise SqlError(f"expected PRECEDING/FOLLOWING near {d!r}")
                return None  # clipped at the partition edge either way
            if w == "current":
                self.next()
                if self.peek().value.lower() == "row":
                    self.next()
                return 0
            n = int(self.next().value)
            d = self.next().value.lower()
            if d == "preceding":
                return -n
            if d == "following":
                return n
            raise SqlError(f"expected PRECEDING/FOLLOWING near {d!r}")

        if self.peek().value.lower() == "between":
            self.next()
            lo = bound()
            if not (self.accept_kw("and") or
                    (self.peek().value.lower() == "and" and self.next())):
                raise SqlError("expected AND in frame clause")
            hi = bound()
        else:
            lo = bound()
            hi = 0
        if kind == "range" and lo is None and hi == 0:
            return None  # the default frame
        return (kind, lo, hi)


def parse_sql(sql: str) -> list:
    return Parser(sql).parse_statements()
