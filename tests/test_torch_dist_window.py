"""PARTITION BY windows on the mesh in exon_tpu_torch (slice 11, K13) held
to exon_tpu on its 8-device JAX CPU mesh and to the port on one device.

``DistributedWindowExec`` routes each row to the shard of its partition
key's hash through bucket_pack and runs WindowExec's path there. Queries:
the window queries of tests/test_distributed.py (ROW_NUMBER and SUM over
PARTITION BY seqname, a ROWS frame under a TopK sort), NULL partition keys
(FASTA records without a description), a dictionary key (a VCF's chrom,
Query L of chip_smoke.py at a small size over a tabix panel), a
two-column key, a string key computed per row, and an empty input. Each
runs through exon_tpu with ``distributed=True``, through the port with
``device="cpu", n_shards=8`` and through the port on one device; the Arrow
tables must be equal, row for row (windows keep input order), integers
and strings exactly, floats at relative 1e-12. Calls over different
PARTITION BYs, and a window with no PARTITION BY, stay on one device."""

import numpy as np
import pyarrow as pa
import pytest

import exon_tpu as J
from exon_tpu.config import new_exon_config as j_config
import exon_tpu_torch as T
from exon_tpu_torch.config import new_exon_config as t_config
from exon_tpu_torch.parallel import distributed as TD
from exon_tpu_torch.plan.window_exec import WindowExec

from benchlib.gff_fixture import make_gff
from test_torch_window import _vcf_text, _write_vcf

FLOAT_RTOL = 1e-12
N_SHARDS = 8
BATCH = 256


@pytest.fixture(scope="module")
def sessions():
    return (J.ExonSession.with_config_exon(j_config(
                distributed=True, device_batch_size=BATCH)),
            T.ExonSession.with_config_exon(t_config(
                distributed=True, n_shards=N_SHARDS,
                device_batch_size=BATCH), device="cpu"),
            T.ExonSession(device="cpu", device_batch_size=BATCH))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = tmp_path_factory.mktemp("dwindow")
    rng = np.random.default_rng(7)
    lines = []
    for i in range(3000):
        seq = "".join(rng.choice(list("ACGTM"), size=rng.integers(10, 60)))
        # every seventh record has no description: a NULL partition key
        desc = "" if i % 7 == 0 else f" desc{i % 13}"
        lines.append(f">id{i}{desc}\n{seq}\n")
    (d / "big.fasta").write_text("".join(lines))
    panel = d / "panel.txt"
    panel.write_text("chr1:1-2000\nchr2:1-3000\nchr10:500-2500\n")
    return {"fa": str(d / "big.fasta"),
            "gff": make_gff(4000, 11, path=str(d / "g.gff3")),
            "vcf": _write_vcf(d / "a.vcf.gz", _vcf_text(
                3, 600, ("chr1", "chr2", "chr10")), index=True),
            "panel": str(panel)}


def _assert_same(a, b):
    assert a.column_names == b.column_names
    assert a.num_rows == b.num_rows
    for name in a.column_names:
        x, y = a.column(name).to_pylist(), b.column(name).to_pylist()
        if pa.types.is_floating(a.schema.field(name).type):
            assert [v is None for v in x] == [v is None for v in y], name
            np.testing.assert_allclose(
                [v for v in x if v is not None],
                [v for v in y if v is not None], rtol=FLOAT_RTOL)
        else:
            assert x == y, name


def _has(plan, cls) -> bool:
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, cls):
            return True
        stack.extend(p.children())
    return False


WINDOWS = {
    # test_distributed.py: test_distributed_window_partition_parity
    "rownumber_and_sum": "SELECT seqname, start, ROW_NUMBER() OVER "
    "(PARTITION BY seqname ORDER BY start, \"end\") AS rn, SUM(start) OVER "
    "(PARTITION BY seqname) AS s FROM gff_scan('{gff}') ORDER BY seqname, "
    "start, \"end\"",
    # test_distributed_rollup_and_frames_parity's window, under a TopK sort
    "rows_frame_topk": "SELECT id, min(length(sequence)) OVER (PARTITION BY "
    "description ORDER BY id ROWS BETWEEN 2 PRECEDING AND CURRENT ROW) AS m "
    "FROM fasta_scan('{fa}') ORDER BY id LIMIT 50",
    "input_order": "SELECT seqname, start, rank() OVER (PARTITION BY seqname "
    "ORDER BY strand, start DESC) AS r, lag(\"end\", 2) OVER (PARTITION BY "
    "seqname ORDER BY strand, start DESC) AS lg, avg(start) OVER (PARTITION "
    "BY seqname ORDER BY start ROWS BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS "
    "a FROM gff_scan('{gff}')",
    "null_partition_keys": "SELECT id, description, count(*) OVER (PARTITION "
    "BY description) AS n, row_number() OVER (PARTITION BY description ORDER "
    "BY length(sequence) DESC, id) AS rn FROM fasta_scan('{fa}')",
    "two_column_key": "SELECT seqname, strand, start, dense_rank() OVER "
    "(PARTITION BY seqname, strand ORDER BY type) AS dr, ntile(4) OVER "
    "(PARTITION BY seqname, strand ORDER BY type) AS nt FROM "
    "gff_scan('{gff}')",
    "computed_string_key": "SELECT id, sum(length(sequence)) OVER (PARTITION "
    "BY substr(id, 1, 4) ORDER BY id) AS s FROM fasta_scan('{fa}')",
    # Query L: chrom is a dictionary column of the VCF scan
    "query_l": "SELECT chrom, pos, qual, pos - lag(pos) OVER (PARTITION BY "
    "chrom ORDER BY pos) AS gap, COUNT(*) OVER (PARTITION BY chrom ORDER BY "
    "pos RANGE BETWEEN 35 PRECEDING AND 35 FOLLOWING) AS cluster_n, "
    "MAX(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 5 "
    "PRECEDING AND 5 FOLLOWING) AS local_max_qual, rank() OVER (PARTITION BY "
    "chrom ORDER BY qual DESC) AS qual_rank FROM "
    "vcf_indexed_scan('{vcf}', '{panel}')",
    "empty_input": "SELECT seqname, row_number() OVER (PARTITION BY seqname "
    "ORDER BY start) AS rn FROM gff_scan('{gff}') WHERE start < 0",
}


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_three_ways(sessions, data, name):
    jax_dist, port_dist, port_one = sessions
    q = WINDOWS[name].format(**data)
    TD.reset_stats()
    df = port_dist.sql(q)
    plan = df._execute(df.logical_plan())
    assert _has(plan, TD.DistributedWindowExec)
    got = plan.collect_arrow()
    _assert_same(jax_dist.sql(q).collect_arrow(), got)
    _assert_same(port_one.sql(q).collect_arrow(), got)
    assert (got.num_rows > 0) == (name != "empty_input")
    if name not in ("empty_input", "rows_frame_topk"):
        assert TD.window_rows == got.num_rows
    if name == "null_partition_keys":
        assert got.column("description").null_count == 3000 // 7 + 1


@pytest.mark.parametrize("q", [
    "SELECT seqname, rank() OVER (PARTITION BY seqname ORDER BY start) AS "
    "a, rank() OVER (PARTITION BY strand ORDER BY start) AS b FROM "
    "gff_scan('{gff}')",
    "SELECT seqname, row_number() OVER (ORDER BY start) AS rn FROM "
    "gff_scan('{gff}')",
], ids=["different_partitions", "no_partition"])
def test_window_off_the_mesh(sessions, data, q):
    """The gate of :1846: calls over different PARTITION BYs, or none, run
    the single-device WindowExec, with the same answer."""
    jax_dist, port_dist, port_one = sessions
    q = q.format(**data)
    df = port_dist.sql(q)
    plan = df._execute(df.logical_plan())
    assert _has(plan, WindowExec)
    assert not _has(plan, TD.DistributedWindowExec)
    got = plan.collect_arrow()
    _assert_same(jax_dist.sql(q).collect_arrow(), got)
    _assert_same(port_one.sql(q).collect_arrow(), got)
