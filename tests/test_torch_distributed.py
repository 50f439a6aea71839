"""Distributed execution in exon_tpu_torch (slice 10, K13) held to
exon_tpu's on the 8-device JAX CPU mesh.

Every query of tests/test_distributed.py that this slice carries (grouped
counts and multi-aggregates over a GFF, a filtered group, an ungrouped
count, groups by description and by id, the rep-too-long fallback, the
DataFrame API, the five TopK cases and the spill-past-state-cap shape)
runs three ways: through exon_tpu with ``distributed=True`` on its mesh,
through the port with ``device="cpu", n_shards=8``, and through the port on
one device. Fixtures are synthetic (benchlib/gff_fixture.py at 6,000
features and a seeded FASTA), with small batches so that every shard gets
several. The three Arrow tables must agree: integers and strings exactly,
in the same row order; float64 sums and averages at relative 1e-12 (the
shards add their partials in another order than one device). Also: the
plans really go to the mesh (the joins and windows are held in
test_torch_dist_join.py and test_torch_dist_window.py); and Query Q of
chip_smoke.py (exon density per 100 kb window) at a small size,
``start / 100000`` typed int64 by both packages."""

import numpy as np
import pyarrow as pa
import pytest

import exon_tpu as J
import exon_tpu.parallel.distributed as JD
from exon_tpu.config import new_exon_config as j_config
import exon_tpu_torch as T
from exon_tpu_torch.config import new_exon_config as t_config
from exon_tpu_torch.parallel import distributed as TD
from exon_tpu_torch.plan import physical as TP

from benchlib.gff_fixture import make_gff

FLOAT_RTOL = 1e-12
N_SHARDS = 8
BATCH = 512  # rows a scan batch, both packages


@pytest.fixture(scope="module")
def gff(tmp_path_factory):
    return make_gff(6000, 11, path=str(tmp_path_factory.mktemp("gff") /
                                       "g.gff3"))


@pytest.fixture(scope="module")
def big_fasta(tmp_path_factory):
    rng = np.random.default_rng(7)
    lines = []
    for i in range(5000):
        seq = "".join(rng.choice(list("ACGTM"), size=rng.integers(10, 60)))
        lines.append(f">id{i} desc{i % 13}\n{seq}\n")
    p = tmp_path_factory.mktemp("fa") / "big.fasta"
    p.write_text("".join(lines))
    return str(p)


@pytest.fixture(scope="module")
def sessions():
    jax_dist = J.ExonSession.with_config_exon(
        j_config(distributed=True, device_batch_size=BATCH))
    port_dist = T.ExonSession.with_config_exon(
        t_config(distributed=True, n_shards=N_SHARDS,
                 device_batch_size=BATCH), device="cpu")
    port_one = T.ExonSession(device="cpu", device_batch_size=BATCH)
    return jax_dist, port_dist, port_one


def _assert_same(a, b):
    assert a.column_names == b.column_names
    for name in a.column_names:
        x, y = a.column(name).to_pylist(), b.column(name).to_pylist()
        if pa.types.is_floating(a.schema.field(name).type):
            assert [v is None for v in x] == [v is None for v in y], name
            np.testing.assert_allclose(
                [v for v in x if v is not None],
                [v for v in y if v is not None], rtol=FLOAT_RTOL)
        else:
            assert x == y, name


def _three_ways(sessions, q, routed=TD.DistributedAggregateExec):
    jax_dist, port_dist, port_one = sessions
    want = jax_dist.sql(q).collect_arrow()
    df = port_dist.sql(q)
    plan = df._execute(df.logical_plan())
    assert _has(plan, routed), f"{q} did not go to the mesh"
    got = plan.collect_arrow()
    one = port_one.sql(q).collect_arrow()
    _assert_same(want, got)
    _assert_same(one, got)
    return got


def _has(plan, cls) -> bool:
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, cls):
            return True
        stack.extend(p.children())
    return False


@pytest.mark.parametrize("q", [
    "SELECT seqname, count(*) AS n FROM gff_scan('{gff}') GROUP BY seqname",
    "SELECT seqname, count(*) AS n, min(start) AS lo, max(\"end\") AS hi, "
    "sum(start) AS s, avg(start) AS a FROM gff_scan('{gff}') GROUP BY "
    "seqname",
    "SELECT type, count(*) AS n FROM gff_scan('{gff}') WHERE start > "
    "100000000 GROUP BY type",
    "SELECT description, count(*) AS n FROM fasta_scan('{fa}') GROUP BY "
    "description ORDER BY description",
    "SELECT id, count(*) AS n FROM fasta_scan('{fa}') GROUP BY id",
    "SELECT seqname, COUNT(DISTINCT type) AS n FROM gff_scan('{gff}') "
    "GROUP BY seqname ORDER BY seqname",
    "SELECT DISTINCT description FROM fasta_scan('{fa}')",
], ids=["grouped_count_gff", "multi_aggs", "filtered_group",
        "group_by_description", "high_cardinality", "count_distinct",
        "select_distinct"])
def test_grouped_three_ways(sessions, gff, big_fasta, q):
    got = _three_ways(sessions, q.format(gff=gff, fa=big_fasta))
    assert got.num_rows > 0


def test_ungrouped_count_three_ways(sessions, big_fasta):
    got = _three_ways(sessions, "SELECT count(*) FROM fasta_scan('%s') "
                      "WHERE sequence LIKE 'M%%'" % big_fasta)
    assert got.column(0)[0].as_py() > 0


def test_query_q_window_density(sessions, gff):
    """chip_smoke.py's Query Q at 6,000 features: ~2,000 groups over 12
    batches, every shard exchanging partial rows."""
    q = ("SELECT seqname, start / 100000 AS window, COUNT(*) AS n, "
         "MIN(start) AS lo, MAX(\"end\") AS hi, SUM(\"end\" - start + 1) AS "
         "bp, AVG(\"end\" - start + 1) AS mean_bp FROM gff_scan('%s') WHERE "
         "type = 'exon' GROUP BY seqname, start / 100000" % gff)
    TD.reset_stats()
    got = _three_ways(sessions, q)
    want = sessions[0].sql(q).collect_arrow()
    assert got.schema.field("window").type == pa.int64()
    assert want.schema.field("window").type == pa.int64()
    assert got.num_rows > 1000
    assert TD.fallbacks == 0 and TD.exchanged_rows >= got.num_rows


def test_fallback_rep_too_long(sessions, tmp_path):
    longkey = "K" * 300
    p = tmp_path / "long.fasta"
    p.write_text(f">a {longkey}\nACGT\n>b {longkey}\nGGGG\n>c other\nTTTT\n")
    TD.reset_stats()
    _three_ways(sessions, "SELECT description, count(*) AS n FROM "
                "fasta_scan('%s') GROUP BY description ORDER BY n DESC" % p)
    assert TD.fallbacks == 1


def test_dataframe_api(sessions, big_fasta):
    outs = []
    for s, mod in zip(sessions, (J, T, T)):
        count = (J.plan.expressions.AggregateCall("count", None)
                 if mod is J else T.count())
        outs.append(s.read_fasta(big_fasta).aggregate(
            ["description"], [count.alias("n")]).sort(
            "description").collect_arrow())
    assert outs[1].num_rows == 13
    assert sum(outs[1].column("n").to_pylist()) == 5000
    _assert_same(outs[0], outs[1])
    _assert_same(outs[2], outs[1])


@pytest.mark.parametrize("q", [
    "SELECT id, length(sequence) AS n FROM fasta_scan('{fa}') ORDER BY n "
    "DESC, id LIMIT 17",
    "SELECT id, sequence FROM fasta_scan('{fa}') ORDER BY sequence LIMIT 9",
    "SELECT id FROM fasta_scan('{fa}') WHERE sequence LIKE 'M%' ORDER BY id "
    "DESC LIMIT 5",
    "SELECT id FROM fasta_scan('{fa}') ORDER BY id LIMIT 7 OFFSET 3",
    "SELECT seqname, start, \"end\" FROM gff_scan('{gff}') ORDER BY \"end\" "
    "- start DESC, start LIMIT 11",
], ids=["numeric", "string_key", "with_filter", "offset", "gff"])
def test_topk_three_ways(sessions, gff, big_fasta, q):
    got = _three_ways(sessions, q.format(gff=gff, fa=big_fasta),
                      routed=TD.DistributedTopKExec)
    assert got.num_rows > 0


def test_aggregate_past_state_cap(sessions, tmp_path, monkeypatch):
    """The shape of test_distributed.py's spill test: 24 files of 1,000
    records, 90 % on one hot key, the rest unique. The JAX package runs it
    with a 256-group state that spills; the port's tables grow instead."""
    rng = np.random.default_rng(11)
    uid, truth = 0, {}
    for f in range(24):
        lines = []
        for i in range(1000):
            if rng.random() < 0.9 and uid > 0:
                desc = "hotkey"
            else:
                desc = f"u{uid:06d}"
                uid += 1
            truth[desc] = truth.get(desc, 0) + 1
            lines.append(f">f{f}r{i} {desc}\nACGT\n")
        (tmp_path / f"p{f}.fasta").write_text("".join(lines))
    orig = JD.plan_distributed_aggregate

    def small(plan, config):
        ex = orig(plan, config)
        if ex is not None:
            ex.state_cap = 256
            ex.fallback = None
        return ex

    monkeypatch.setattr(JD, "plan_distributed_aggregate", small)
    for s in sessions:
        s.sql(f"CREATE EXTERNAL TABLE t STORED AS FASTA LOCATION "
              f"'{tmp_path}'")
    got = _three_ways(sessions, "SELECT description, count(*) AS n FROM t "
                      "GROUP BY description ORDER BY description")
    want = dict(sorted(truth.items()))
    assert got.column("description").to_pylist() == list(want)
    assert got.column("n").to_pylist() == list(want.values())


def test_config_and_session(monkeypatch):
    cfg = t_config()
    assert (cfg.distributed, cfg.n_shards, cfg.partitioned_join) == \
        (False, 0, False)
    cfg.set_option("exon.distributed", "true")
    cfg.set_option("n_shards", "4")
    assert cfg.distributed and cfg.n_shards == 4
    with pytest.raises(KeyError):
        cfg.set_option("exon.no_such_flag", "true")
    cfg.set_option("exon.vcf_parse_info", "true")
    assert cfg.scan_flags("VCF") == {"parse_info": True}
    monkeypatch.setenv("EXON_TPU_DISTRIBUTED", "1")
    assert t_config().distributed
    monkeypatch.delenv("EXON_TPU_DISTRIBUTED")
    s = T.ExonSession(device="cpu", device_batch_size=99)
    assert s.device_batch_size == 99 and not s.config.distributed


def test_one_shard_plans_on_one_device(gff):
    """A CPU session's mesh defaults to one shard: the single-device plan."""
    one = T.ExonSession.with_config_exon(t_config(distributed=True),
                                         device="cpu")
    df = one.sql("SELECT seqname, count(*) AS n FROM gff_scan('%s') "
                 "GROUP BY seqname" % gff)
    plan = df._execute(df.logical_plan())
    assert _has(plan, TP.AggregateExec)
    assert not _has(plan, TD.DistributedAggregateExec)
