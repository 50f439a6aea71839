"""DataFrame API over logical plans.

Counterpart of exon_tpu/dataframe.py for ``filter``, ``select``,
``aggregate``, ``sort`` (:54), ``limit``, ``join`` (:66), ``count``,
``collect_arrow``, ``to_pandas`` (:95) and ``collect_host``, the host
result accessor that needs no pyarrow. Unions and writers are not ported
yet (ROADMAP Queue 1).
"""

from __future__ import annotations

from .batch import Batch
from .plan import logical as L
from .plan.expressions import AggregateCall, Alias, Expr, col
from .plan.planner import create_physical_plan, optimize


class DataFrame:
    def __init__(self, session, plan: L.LogicalPlan):
        self._session = session
        self._plan = plan

    # -- transforms ---------------------------------------------------------

    def filter(self, predicate: Expr) -> "DataFrame":
        return DataFrame(self._session, L.Filter(predicate, self._plan))

    def select(self, *exprs) -> "DataFrame":
        exprs = [col(e) if isinstance(e, str) else e for e in exprs]
        return DataFrame(self._session, L.Project(list(exprs), self._plan))

    def aggregate(self, group_exprs: list, agg_exprs: list) -> "DataFrame":
        group_exprs = [col(e) if isinstance(e, str) else e for e in group_exprs]
        calls, names = [], []
        for e in agg_exprs:
            if isinstance(e, Alias) and isinstance(e.child, AggregateCall):
                calls.append(e.child)
                names.append(e.name)
            elif isinstance(e, AggregateCall):
                calls.append(e)
                names.append(e.display_name())
            else:
                raise TypeError(f"not an aggregate expression: {e}")
        return DataFrame(self._session,
                         L.Aggregate(group_exprs, calls, names, self._plan))

    def sort(self, *keys) -> "DataFrame":
        """Keys are column names, expressions, or (key, ascending) pairs."""
        norm = []
        for k in keys:
            if isinstance(k, tuple):
                norm.append((col(k[0]) if isinstance(k[0], str) else k[0],
                             k[1]))
            else:
                norm.append((col(k) if isinstance(k, str) else k, True))
        return DataFrame(self._session, L.Sort(norm, self._plan))

    def limit(self, fetch: int, skip: int = 0) -> "DataFrame":
        return DataFrame(self._session, L.Limit(skip, fetch, self._plan))

    def join(self, right: "DataFrame", on, how: str = "inner") -> "DataFrame":
        """Equi-join; ``on`` lists column names or (left, right) pairs of
        names or expressions. ``how`` is inner or left."""
        pairs = []
        for item in on:
            if isinstance(item, str):
                pairs.append((col(item), col(item)))
            else:
                lk, rk = item
                pairs.append((col(lk) if isinstance(lk, str) else lk,
                              col(rk) if isinstance(rk, str) else rk))
        return DataFrame(self._session,
                         L.Join(self._plan, right._plan, pairs, how))

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL, by position (exon_tpu/dataframe.py:78)."""
        return DataFrame(self._session, L.Union([self._plan, other._plan]))

    # -- sinks --------------------------------------------------------------

    def count(self) -> int:
        agg = L.Aggregate([], [AggregateCall("count", None)], ["count(*)"],
                          self._plan)
        batch = self._execute(agg).collect_host()
        return int(batch.columns[0].values[0])

    def collect_arrow(self):
        return self._execute(self._plan).collect_arrow()

    def to_pandas(self):
        return self.collect_arrow().to_pandas()

    def collect_host(self) -> Batch:
        """The result as one host Batch of numpy arrays."""
        return self._execute(self._plan).collect_host()

    def schema(self):
        return self._plan.schema()

    def logical_plan(self) -> L.LogicalPlan:
        return self._plan

    # -- execution ----------------------------------------------------------

    def _execute(self, plan: L.LogicalPlan):
        return create_physical_plan(optimize(plan), self._session.device,
                                    self._session.config)
