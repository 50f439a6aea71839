"""F35: an ungrouped aggregate's result batch lies on its input's device, so
every operator above it takes it, as in exon_tpu.

Each query shape that raised before the repair (ORDER BY, HAVING, a WHERE
and a projection over an ungrouped subquery, a GROUP BY over one, ROLLUP,
CUBE and GROUPING SETS that hold the empty set under ORDER BY and under a
window, a UNION ALL of an ungrouped branch and a grouped one, the COUNT(*)
fast path over a bare scan) runs through ``ExonSession.sql`` on seeded
memory tables and a small GFF file, on one device and on 4 logical shards
(``new_exon_config(distributed=True, n_shards=4)``), against exon_tpu on
one device: Arrow schemas, values and nulls equal, in the same row order
where the query fixes it, as sorted rows elsewhere. Then the aggregate's
own batch: every column a torch tensor on the input's device (the CPU
here), for the general path, the COUNT(*) fast path, an input whose filter
keeps no row, and the mesh's ungrouped path."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
from exon_tpu.sql.frontend import MemTable as JMemTable
import exon_tpu_torch as T
from exon_tpu_torch.config import new_exon_config as t_config
from exon_tpu_torch.plan.physical import AggregateExec
from exon_tpu_torch.parallel import distributed as TD

G = "gff_scan('{gff}')"
# name -> (query, whether its ORDER BY fixes the row order)
QUERIES = {
    "order_by": ("SELECT COUNT(*) AS c, SUM(v) AS s, MIN(v) AS lo FROM t "
                 "ORDER BY c", True),
    "having": ("SELECT COUNT(*) AS c, SUM(v) AS s FROM t HAVING "
               "COUNT(*) > 1", True),
    "having_false": ("SELECT COUNT(*) AS c FROM t HAVING COUNT(*) > 1000000",
                     True),
    "where_over_subquery": ("SELECT c, s FROM (SELECT COUNT(*) AS c, SUM(v) "
                            "AS s FROM t) x WHERE c > 1", True),
    "projection_over_subquery": ("SELECT c + 1 AS d, s * 2 AS e, c > 5 AS "
                                 "big FROM (SELECT COUNT(*) AS c, SUM(v) AS "
                                 "s FROM t) x", True),
    "avg_under_order_by": ("SELECT AVG(v) AS a, MAX(w) AS m FROM t WHERE k "
                           "<> 2 ORDER BY a", True),
    "group_by_over_subquery": ("SELECT c, COUNT(*) AS n FROM (SELECT COUNT(*) "
                               "AS c, SUM(v) AS s FROM t) x GROUP BY c",
                               True),
    "rollup_order_by": ("SELECT k, COUNT(*) AS n, SUM(v) AS s FROM t GROUP BY "
                        "ROLLUP(k) ORDER BY k", True),
    "cube_order_by_gff": (f"SELECT seqname, strand, COUNT(*) AS n FROM {G} "
                          "GROUP BY CUBE(seqname, strand) ORDER BY seqname, "
                          "strand", True),
    "grouping_sets_window": ("SELECT k, n, rank() OVER (ORDER BY n DESC, k) "
                             "AS r FROM (SELECT k, COUNT(*) AS n FROM t "
                             "GROUP BY GROUPING SETS ((k), ())) x", False),
    "rollup_window_gff": (f"SELECT seqname, n, row_number() OVER (ORDER BY n "
                          "DESC, seqname) AS rn FROM (SELECT seqname, "
                          f"COUNT(*) AS n FROM {G} GROUP BY ROLLUP(seqname)) "
                          "x", False),
    "union_all": ("SELECT COUNT(*) AS n FROM t UNION ALL SELECT COUNT(*) AS n "
                  "FROM t GROUP BY k", False),
    "union_all_order_by": ("SELECT n FROM (SELECT COUNT(*) AS n FROM t UNION "
                           "ALL SELECT COUNT(*) AS n FROM t GROUP BY k) x "
                           "ORDER BY n", True),
    "count_star_fast_path_gff": (f"SELECT COUNT(*) AS c FROM {G} ORDER BY c",
                                 True),
}


def _table() -> pa.Table:
    """5,000 rows of 5 keys, an int64 with 10 % NULL and an int64 w."""
    rng = np.random.default_rng(35)
    n = 5_000
    valid = rng.random(n) > 0.1
    return pa.table({
        "k": pa.array(rng.integers(0, 5, n), pa.int64()),
        "v": pa.array(rng.integers(-50, 50, n), pa.int64(), mask=~valid),
        "w": pa.array(rng.integers(0, 10**6, n), pa.int64())})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from benchlib.gff_fixture import make_gff

    d = tmp_path_factory.mktemp("f35")
    return {"gff": make_gff(400, 11, path=str(d / "g.gff"))}


@pytest.fixture(scope="module")
def jax_session():
    s = J.ExonSession.new_exon()
    s.register_table("t", JMemTable(_table()))
    return s


def _port(where: str):
    s = T.ExonSession(device="cpu") if where == "one_device" else \
        T.ExonSession.with_config_exon(t_config(distributed=True,
                                                n_shards=4), device="cpu")
    s.register_table("t", _table())
    return s


def _rows(tab: pa.Table) -> list:
    return sorted(zip(*(tab.column(n).to_pylist()
                        for n in tab.column_names)),
                  key=lambda r: tuple((v is None, v) for v in r))


@pytest.mark.parametrize("where", ["one_device", "four_shards"])
@pytest.mark.parametrize("name", list(QUERIES))
def test_f35_query_matches_jax(jax_session, files, name, where):
    sql, ordered = QUERIES[name]
    sql = sql.format(**files)
    want = jax_session.sql(sql).collect_arrow()
    got = _port(where).sql(sql).collect_arrow()
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    if ordered:
        for n in want.column_names:
            g, w = got.column(n), want.column(n)
            assert g.is_null().to_pylist() == w.is_null().to_pylist(), n
            assert g.to_pylist() == w.to_pylist(), n
    else:
        assert _rows(got) == _rows(want)  # NULL sorts as its own value


def _aggregate(plan):
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, AggregateExec):
            return p
        stack.extend(p.children())
    raise AssertionError("no AggregateExec in the plan")


# (query, whether 4 shards route it through DistributedAggregateExec)
UNGROUPED = [
    ("SELECT COUNT(*) AS n, SUM(v) AS s, MIN(v) AS lo, AVG(w) AS a FROM t",
     True),
    ("SELECT COUNT(*) AS n, SUM(v) AS s FROM t WHERE w < 0", True),
    ("SELECT COUNT(*) AS n, VAR_POP(v) AS vp FROM t WHERE w < 0", False),
    ("SELECT COUNT(*) AS c FROM " + G, True),  # one device: the fast path
]


@pytest.mark.parametrize("where", ["one_device", "four_shards"])
@pytest.mark.parametrize("sql,on_mesh", UNGROUPED)
def test_f35_ungrouped_batch_lies_on_the_input_device(files, where, sql,
                                                      on_mesh):
    df = _port(where).sql(sql.format(**files))
    agg = _aggregate(df._execute(df.logical_plan()))
    assert isinstance(agg, TD.DistributedAggregateExec) == (
        where == "four_shards" and on_mesh)
    (batch,) = list(agg.batches())
    assert batch.length == 1 and batch.device == torch.device("cpu")
    for col in batch.columns:
        for arr in (col.values, col.validity):
            assert isinstance(arr, torch.Tensor)
            assert arr.device == torch.device("cpu")
