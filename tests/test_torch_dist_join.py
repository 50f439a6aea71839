"""Distributed joins in exon_tpu_torch (slice 11, K13) held to exon_tpu on
its 8-device JAX CPU mesh and to the port on one device.

The broadcast join (``DistributedJoinExec``): every join query of
tests/test_distributed.py (a FASTA joined to ``attributes.ID[1]`` of a GFF,
the expanding join, the join under an aggregate, the left join) on
synthetic fixtures, a LEFT and an inner join with an ON residual, and
queries C and D of chip_smoke.py at a small size. The partitioned join
(``DistributedPartitionedJoinExec``, chosen by ``SET
exon.partitioned_join = true``) over memory tables: the three cases of
``test_partitioned_join_parity``, string keys, unmatched and NULL left
keys, and query D. Each runs through exon_tpu with ``distributed=True``,
through the port with ``device="cpu", n_shards=8`` and through the port on
one device; the Arrow tables must be equal, row for row, integers and
strings exactly. Two JAX faults are shown with both answers: F31 (its
partitioned join drops the NULL-extended rows of a LEFT join with an ON
residual) and F32 (it matches keys on the unverified 64-bit
``_group_key_i64``)."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
from exon_tpu.config import new_exon_config as j_config
import exon_tpu.parallel.distributed as JD
from exon_tpu.plan import physical as JP
from exon_tpu.sql.frontend import MemTable as JMemTable
import exon_tpu_torch as T
from exon_tpu_torch.config import new_exon_config as t_config
from exon_tpu_torch.parallel import distributed as TD
from exon_tpu_torch.plan import physical as TP
from exon_tpu_torch.plan.join_exec import JoinExec

from benchlib.bam_fixture import bam_reads, make_bam
from test_torch_join import _genes_gff, query_c, query_d

N_SHARDS = 8
BATCH = 256  # rows a scan batch, both packages
TEMPLATES, SEED = 400, 21


def _sessions(**kw):
    """(JAX distributed, port on 8 shards, port on one device)."""
    return (J.ExonSession.with_config_exon(j_config(
                distributed=True, device_batch_size=BATCH, **kw)),
            T.ExonSession.with_config_exon(t_config(
                distributed=True, n_shards=N_SHARDS, device_batch_size=BATCH,
                **kw), device="cpu"),
            T.ExonSession(device="cpu", device_batch_size=BATCH))


@pytest.fixture(scope="module")
def sessions():
    return _sessions()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("djoin")
    rng = np.random.default_rng(7)
    lines = []
    for i in range(5000):
        seq = "".join(rng.choice(list("ACGTM"), size=rng.integers(10, 60)))
        lines.append(f">id{i} desc{i % 13}\n{seq}\n")
    (d / "big.fasta").write_text("".join(lines))
    # test_distributed.py's annotation table and reads-vs-annotations pair
    (d / "ann.gff").write_text("".join(
        f"chr1\tsrc\tgene\t{i + 1}\t{i + 10}\t.\t+\t.\tID=id{i}\n"
        for i in range(0, 5000, 7)))
    (d / "reads.gff").write_text("".join(
        f"chr{i % 8}\tsrc\tread\t{i + 1}\t{i + 50}\t.\t+\t.\t"
        f"ID=read{i};Name=some_longish_read_name_{i}\n" for i in range(3000)))
    rows = []
    for i in range(200):
        start = (i % 50) * 7 + 1
        rows.append(f"chr{(start - 1) % 8}\tann\tgene\t{start}\t{start + 99}"
                    f"\t.\t+\t.\tID=gene{i};Name=annotation_with_a_long_name"
                    f"_{i}\n")
    (d / "genes.gff").write_text("".join(rows))
    bam = make_bam(TEMPLATES, SEED, path=str(d / "p.bam"))
    return {"fa": str(d / "big.fasta"), "ann": str(d / "ann.gff"),
            "left": str(d / "reads.gff"), "right": str(d / "genes.gff"),
            "bam": bam, "gff": _genes_gff(d / "g.gff3",
                                          bam_reads(TEMPLATES, SEED))}


def _assert_same(a, b):
    assert a.column_names == b.column_names
    assert a.num_rows == b.num_rows
    for name in a.column_names:
        assert a.column(name).to_pylist() == b.column(name).to_pylist(), name


def _has(plan, cls) -> bool:
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, cls):
            return True
        stack.extend(p.children())
    return False


def _routed(df, cls):
    plan = df._execute(df.logical_plan())
    assert _has(plan, cls), f"{cls.__name__} not in the plan"
    return plan.collect_arrow()


def _three_ways(sessions, q, routed):
    jax_dist, port_dist, port_one = sessions
    got = _routed(port_dist.sql(q), routed)
    _assert_same(jax_dist.sql(q).collect_arrow(), got)
    _assert_same(port_one.sql(q).collect_arrow(), got)
    return got


JOINS = {
    # attributes.ID is a map of lists: [1] takes the first value
    "fasta_attribute_id": "SELECT f.id, g.start FROM fasta_scan('{fa}') f "
    "JOIN gff_scan('{ann}') g ON f.id = g.attributes.ID[1] ORDER BY g.start",
    "expanding": "SELECT a.seqname, a.start, b.\"end\", b.source FROM "
    "gff_scan('{left}') a JOIN gff_scan('{right}') b ON a.seqname = "
    "b.seqname AND a.start = b.start",
    "then_aggregate": "SELECT a.seqname, count(*) AS n FROM gff_scan('{left}')"
    " a JOIN gff_scan('{right}') b ON a.seqname = b.seqname AND a.start = "
    "b.start GROUP BY a.seqname ORDER BY a.seqname",
    "left": "SELECT a.start, b.\"end\" FROM gff_scan('{left}') a LEFT JOIN "
    "gff_scan('{right}') b ON a.seqname = b.seqname AND a.start = b.start",
    # an ON residual: a left row whose every match fails it keeps one
    # NULL-extended row
    "left_residual": "SELECT a.start, a.seqname, b.\"end\" FROM gff_scan("
    "'{left}') a LEFT JOIN gff_scan('{right}') b ON a.seqname = b.seqname "
    "AND a.start = b.start AND b.\"end\" + a.start > 200",
    "inner_residual_filtered_probe": "SELECT a.start, b.source FROM gff_scan("
    "'{left}') a JOIN gff_scan('{right}') b ON a.seqname = b.seqname AND "
    "a.start = b.start AND b.\"end\" + a.start > 200 WHERE a.start > 20",
}


@pytest.mark.parametrize("name", list(JOINS))
def test_broadcast_join_three_ways(sessions, data, name):
    got = _three_ways(sessions, JOINS[name].format(**data),
                      TD.DistributedJoinExec)
    assert got.num_rows > 0


@pytest.mark.parametrize("query,how", [("c", "inner"), ("d", "left"),
                                       ("d", "inner")])
def test_queries_c_and_d_on_shards(sessions, data, query, how):
    """chip_smoke.py's C_dist and D at a small size through the DataFrame
    API: the broadcast join of the reads with the genes, and mate pairing;
    each equal to the JAX mesh's answer and to the port on one device."""
    jax_dist, port_dist, port_one = sessions
    if query == "c":
        make = lambda mod, s: query_c(mod, s, data["bam"], data["gff"])
    else:
        make = lambda mod, s: query_d(mod, s, data["bam"], how)
    got = _routed(make(T, port_dist), TD.DistributedJoinExec)
    assert got.num_rows > 100
    _assert_same(make(J, jax_dist).collect_arrow(), got)
    _assert_same(make(T, port_one).collect_arrow(), got)


def test_query_d_partitioned(data):
    """chip_smoke.py's D_part at a small size: mate pairing under SET
    exon.partitioned_join = true, on the BAM's string key."""
    jax_dist, port_dist, port_one = _sessions()
    for s in (jax_dist, port_dist):
        s.sql("SET exon.partitioned_join = true")
    TD.reset_stats()
    got = _routed(query_d(T, port_dist, data["bam"]),
                  TD.DistributedPartitionedJoinExec)
    assert got.num_rows == TEMPLATES
    assert TD.exchanged_pairs == 2 * TEMPLATES - TEMPLATES // 100
    _assert_same(query_d(J, jax_dist, data["bam"]).collect_arrow(), got)
    _assert_same(query_d(T, port_one, data["bam"]).collect_arrow(), got)


# ---------------------------------------------------------------------------
# The partitioned join over memory tables
# ---------------------------------------------------------------------------


def _int_tables():
    """test_distributed.py's ``join_tables``: 4,000 left rows with keys in
    [0, 800), 1,500 right rows with keys in [0, 1000)."""
    rng = np.random.default_rng(11)
    n_l, n_r = 4000, 1500
    left = pa.table({
        "k": rng.integers(0, 800, size=n_l).astype(np.int64),
        "lval": rng.integers(0, 1000, size=n_l).astype(np.int64),
        "name": pa.array([f"row{i}" for i in range(n_l)]),
    })
    right = pa.table({
        "k": rng.integers(0, 1000, size=n_r).astype(np.int64),
        "rval": rng.integers(0, 1000, size=n_r).astype(np.int64),
    })
    return left, right


def _string_tables():
    names = [f"chr{i}" for i in range(1, 23)]
    left = pa.table({
        "c": pa.array([names[i % len(names)] for i in range(3000)]),
        "v": pa.array(np.arange(3000, dtype=np.int64))})
    right = pa.table({
        "c": pa.array([names[i % 7] for i in range(300)]),
        "w": pa.array(np.arange(300, dtype=np.int64) * 10)})
    return left, right


def _null_key_tables():
    """Left keys with NULLs and keys the right side lacks, string and int
    parts together."""
    rng = np.random.default_rng(5)
    n = 900
    k = rng.integers(0, 60, n)
    left = pa.table({
        "k": pa.array([None if i % 11 == 0 else int(k[i]) for i in range(n)],
                      pa.int64()),
        "s": pa.array([None if i % 17 == 0 else f"s{k[i] % 4}"
                       for i in range(n)]),
        "i": pa.array(np.arange(n, dtype=np.int64))})
    rk = rng.integers(0, 80, 400)
    right = pa.table({
        "k": pa.array([None if i % 13 == 0 else int(rk[i])
                       for i in range(400)], pa.int64()),
        "s": pa.array([f"s{x % 4}" for x in rk]),
        "j": pa.array(np.arange(400, dtype=np.int64))})
    return left, right


PARTITIONED = {
    "inner": (_int_tables, "SELECT l.k, lval, rval FROM l JOIN r ON "
              "l.k = r.k"),
    "left": (_int_tables, "SELECT l.k, lval, rval FROM l LEFT JOIN r ON "
             "l.k = r.k"),
    "where": (_int_tables, "SELECT l.name, rval FROM l JOIN r ON l.k = r.k "
              "WHERE rval > 500"),
    "string_keys": (_string_tables, "SELECT l.c, v, w FROM l JOIN r ON "
                    "l.c = r.c"),
    "left_unmatched": (_int_tables, "SELECT l.k, rval FROM l LEFT JOIN r ON "
                       "l.k = r.k"),
    "left_null_keys": (_null_key_tables, "SELECT l.i, l.k, l.s, r.j FROM l "
                       "LEFT JOIN r ON l.k = r.k AND l.s = r.s"),
    "inner_residual": (_int_tables, "SELECT l.name, l.k, rval FROM l JOIN r "
                       "ON l.k = r.k AND rval > lval"),
}


def _mem_sessions(tables, partitioned=True):
    """(JAX distributed, port on 8 shards, port on one device) with l and
    r registered, the first two under SET exon.partitioned_join."""
    left, right = tables
    out = _sessions()
    for s in out:
        if isinstance(s, J.ExonSession):
            s.register_table("l", JMemTable(left))
            s.register_table("r", JMemTable(right))
        else:
            s.register_table("l", left)
            s.register_table("r", right)
    if partitioned:
        for s in out[:2]:
            assert s.sql("SET exon.partitioned_join = true").collect_arrow(
            ).to_pylist() == [{"status": "ok"}]
    return out


@pytest.mark.parametrize("name", list(PARTITIONED))
def test_partitioned_join_three_ways(name):
    make, q = PARTITIONED[name]
    TD.reset_stats()
    got = _three_ways(_mem_sessions(make()), q,
                      TD.DistributedPartitionedJoinExec)
    assert got.num_rows > 0 and TD.exchanged_pairs > 0
    if name == "left_unmatched":
        assert got.num_rows >= 4000 and None in got.column("rval").to_pylist()


def test_f31_left_join_residual_keeps_null_rows():
    """F31: the JAX partitioned join applies the ON residual as a filter
    after the null extension (distributed.py:2041-2043), so a LEFT join
    loses the left rows whose every match fails it. The port equals the
    JAX single-device answer; the JAX partitioned answer is shown too."""
    left = pa.table({"k": pa.array([1, 2, 3, 4, 5], pa.int64()),
                     "lv": pa.array([10, 20, 30, 40, 50], pa.int64())})
    right = pa.table({"k": pa.array([1, 2, 3, 3], pa.int64()),
                      "rv": pa.array([900, 100, 700, 200], pa.int64())})
    q = "SELECT l.k, lv, rv FROM l LEFT JOIN r ON l.k = r.k AND rv > 500"
    jax_part, port_part, port_one = _mem_sessions((left, right))
    got = _routed(port_part.sql(q), TD.DistributedPartitionedJoinExec)
    jax_one = J.ExonSession.new_exon()
    jax_one.register_table("l", JMemTable(left))
    jax_one.register_table("r", JMemTable(right))
    want = jax_one.sql(q).collect_arrow()
    _assert_same(want, got)
    _assert_same(port_one.sql(q).collect_arrow(), got)
    assert got.to_pydict() == {"k": [1, 2, 3, 4, 5],
                               "lv": [10, 20, 30, 40, 50],
                               "rv": [900, None, 700, None, None]}
    assert jax_part.sql(q).collect_arrow().to_pydict() == {
        "k": [1, 3], "lv": [10, 30], "rv": [900, 700]}


def test_f32_partitioned_join_verifies_every_key_part(monkeypatch):
    """F32: the JAX partitioned join matches on the unverified 64-bit
    ``_group_key_i64``. With every string forced to hash to 0 in both
    packages, the JAX answer pairs every left row with every right row;
    the port routes every pair to one owner and verifies the bytes, so its
    answer is unchanged."""
    import jax.numpy as jnp

    left, right = _string_tables()
    q = "SELECT l.c, v, w FROM l JOIN r ON l.c = r.c"
    jax_part, port_part, port_one = _mem_sessions((left, right))
    want = port_one.sql(q).collect_arrow()
    monkeypatch.setattr(TP, "row_hash", lambda offsets, values: torch.zeros(
        offsets.shape[0] - 1, dtype=torch.int64, device=offsets.device))
    monkeypatch.setattr(JP, "_hash_var", lambda v: jnp.zeros(
        v.offsets.shape[0] - 1, jnp.int64))
    got = _routed(port_part.sql(q), TD.DistributedPartitionedJoinExec)
    _assert_same(want, got)
    # the JAX key step is a cached jit: trace it anew with the forced hash,
    # and again after, with the real one
    JD._pjoin_key_step.cache_clear()
    try:
        assert jax_part.sql(q).collect_arrow().num_rows == 3000 * 300
    finally:
        monkeypatch.undo()
        JD._pjoin_key_step.cache_clear()


def test_partitioned_join_choice_follows_set():
    """SET exon.partitioned_join picks the join: true the partitioned one,
    false the broadcast one over a scan chain, which a memory table is in
    one process; both give the one-device answer."""
    jax_dist, port_dist, port_one = _mem_sessions(_int_tables(),
                                                  partitioned=False)
    q = PARTITIONED["left"][1]
    want = port_one.sql(q).collect_arrow()
    _assert_same(want, _routed(port_dist.sql(q), TD.DistributedJoinExec))
    port_dist.sql("SET exon.partitioned_join = true")
    df = port_dist.sql(q)
    plan = df._execute(df.logical_plan())
    assert not _has(plan, TD.DistributedJoinExec)
    _assert_same(want, _routed(df, TD.DistributedPartitionedJoinExec))
    port_dist.sql("SET exon.partitioned_join = false")
    assert not port_dist.config.partitioned_join


def test_one_shard_join_stays_on_one_device(data):
    """A mesh of one shard plans the single-device JoinExec, under either
    join choice."""
    s = T.ExonSession.with_config_exon(t_config(distributed=True),
                                       device="cpu")
    for flag in ("false", "true"):
        s.sql(f"SET exon.partitioned_join = {flag}")
        df = s.sql(JOINS["left"].format(**data))
        plan = df._execute(df.logical_plan())
        assert _has(plan, JoinExec)
        assert not _has(plan, TD.DistributedJoinExec)
        assert not _has(plan, TD.DistributedPartitionedJoinExec)
