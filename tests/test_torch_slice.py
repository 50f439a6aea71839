"""Queries A and B and the count, end to end at small size through
exon_tpu_torch.ExonSession(device="cpu") and exon_tpu.ExonSession. Arrow
tables must be equal in values, types, nulls and row order. Tolerance:
exact, except float64 sums and averages, relative 1e-12 (summation order)."""

import numpy as np
import pytest

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.bam_fixture import make_bam
from benchlib.gff_fixture import make_gff
from exon_tpu.plan.expressions import FunctionCall as JFunctionCall

FLOAT_RTOL = 1e-12
BATCH = 500


def _write_fasta(path, n=1200, seed=3):
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    parts = []
    for i in range(n):
        body = alphabet[rng.integers(0, 20, rng.integers(120, 680))].tobytes()
        desc = b" protein %d" % i if i % 7 else b""
        parts.append(b">sp|P%06d%s\n" % (i, desc))
        parts.append(b"\n".join(body[j:j + 60] for j in range(0, len(body), 60)))
        parts.append(b"\n")
    path.write_bytes(b"".join(parts))
    return str(path)


@pytest.fixture
def sessions(monkeypatch):
    # the reference decodes on the host, so the comparison isolates operators
    monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    return T.ExonSession(device="cpu", device_batch_size=BATCH), js


def _query_a(mod, func):
    return (func("length", [mod.col("sequence")]) > 300) & \
        mod.col("sequence").like("%KK%")


def _query_b(mod, df):
    c = mod.col
    return df.filter(c("type") == "exon").aggregate(
        ["seqname"], [mod.count().alias("n"), mod.min_(c("start")),
                      mod.max_(c("end")), mod.sum_(c("end") - c("start")),
                      mod.avg(c("end") - c("start"))])


def _assert_equal(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if w.type == "double":
            np.testing.assert_allclose(np.asarray(g.to_pylist(), float),
                                       np.asarray(w.to_pylist(), float),
                                       rtol=FLOAT_RTOL, atol=0)
        else:
            assert g.to_pylist() == w.to_pylist(), name


def test_query_a_filter_project_matches_jax(tmp_path, sessions):
    ts, js = sessions
    path = _write_fasta(tmp_path / "a.fasta")
    got = ts.read_fasta(path).filter(_query_a(T, T.FunctionCall)).select(
        "id", "sequence").collect_arrow()
    want = js.read_fasta(path).filter(_query_a(J, JFunctionCall)).select(
        "id", "sequence").collect_arrow()
    assert got.num_rows > 0
    _assert_equal(got, want)


def test_query_a_count_matches_jax(tmp_path, sessions):
    ts, js = sessions
    path = _write_fasta(tmp_path / "a.fasta")
    got = ts.read_fasta(path).filter(_query_a(T, T.FunctionCall)).count()
    want = js.read_fasta(path).filter(_query_a(J, JFunctionCall)).count()
    assert got == want > 0
    assert ts.read_fasta(path).count() == js.read_fasta(path).count() == 1200


def test_query_b_group_by_matches_jax(tmp_path, sessions):
    ts, js = sessions
    path = make_gff(4000, seed=11, path=str(tmp_path / "b.gff3"))
    got = _query_b(T, ts.read_gff(path)).collect_arrow()
    want = _query_b(J, js.read_gff(path)).collect_arrow()
    assert got.num_rows > 20  # chrM may hold no exon at this size
    _assert_equal(got, want)


def test_query_b_host_result_matches_arrow(tmp_path, sessions):
    ts, _js = sessions
    path = make_gff(4000, seed=11, path=str(tmp_path / "b.gff3"))
    host = _query_b(T, ts.read_gff(path)).collect_host()
    table = _query_b(T, ts.read_gff(path)).collect_arrow()
    keys = host.columns[0]
    assert [keys.vocab[c] for c in keys.codes] == \
        table.column("seqname").to_pylist()
    assert host.columns[1].values.tolist() == table.column("n").to_pylist()


def test_out_of_slice_raises(tmp_path, sessions):
    ts, js = sessions
    path = make_gff(100, seed=1, path=str(tmp_path / "c.gff3"))
    bam = make_bam(20, seed=1, path=str(tmp_path / "c.bam"))
    with pytest.raises(NotImplementedError, match="EXPLAIN"):
        ts.sql("EXPLAIN SELECT 1")
    # item 2b + 3 has landed: GFF attributes (a map) and BAM quality scores
    # (a list) give the JAX package's answer
    assert ts.read_gff(path).collect_arrow().equals(
        js.read_gff(path).collect_arrow())
    assert ts.read_bam(bam).select("name", "quality_score").collect_arrow() \
        .equals(js.read_bam(bam).select("name", "quality_score")
                .collect_arrow())
    assert ts.read_gff(path).select("seqname").limit(3).collect_host() \
        .length == 3


def test_cuda_session_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.ExonSession()
