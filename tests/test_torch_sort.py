"""Sort, TopK and Limit in exon_tpu_torch against exon_tpu at small size:
DESC keys and NULLS FIRST/LAST, multi-run sorts (``EXON_TPU_SORT_RUN_ROWS``
set small, as both packages read it) whose var-width keys widen from run to
run, TopK over several runs, LIMIT across batch boundaries, and the
sort_keys twin against ``sort_key_columns``. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.bam_fixture import make_bam
from benchlib.gff_fixture import make_gff
from exon_tpu import datatypes as jdt
from exon_tpu.batch import Batch as JBatch
from exon_tpu.batch import FixedColumn as JFixedColumn
from exon_tpu.batch import VarColumn as JVarColumn
from exon_tpu.plan.expressions import NullsOrder as JNullsOrder
from exon_tpu.plan.physical import sort_key_columns as j_sort_key_columns
from exon_tpu_torch.kernels.sort_keys import FixedKey, VarKey, sort_keys
from test_torch_join import query_d

BATCH = 300


@pytest.fixture
def sessions(monkeypatch):
    monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    return T.ExonSession(device="cpu", device_batch_size=BATCH), js


def _assert_equal(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert got.column(name).to_pylist() == \
            want.column(name).to_pylist(), name


def _gff(tmp_path, n=1500):
    return make_gff(n, seed=17, path=str(tmp_path / "s.gff3"))


def _long_names_gff(path, n=1200, seed=6) -> str:
    """GFF rows whose seqnames grow from 4 to 18 bytes down the file, so
    later sort runs need more 8-byte key chunks than earlier ones."""
    rng = np.random.default_rng(seed)
    names = ["chr1", "chr22", "chrUn_KI2707", "chrUn_KI270742v1_x"]
    lines = ["##gff-version 3\n"]
    for i in range(n):
        seq = names[min(i * len(names) // n, len(names) - 1)]
        start = int(rng.integers(1, 10_000))
        lines.append(f"{seq}\tX\tgene\t{start}\t{start + 50}\t.\t+\t.\t"
                     f"ID=g{i}\n")
    path.write_text("".join(lines))
    return str(path)


@pytest.mark.parametrize("nulls_first", [True, False])
def test_desc_and_nulls_sort_matches_jax(tmp_path, sessions, nulls_first):
    ts, js = sessions
    path = _gff(tmp_path)

    got = ts.read_gff(path).select("seqname", "start", "end", "phase",
                                   "score").sort(
        (T.NullsOrder(T.col("phase"), nulls_first), False),
        ("end", False), "start").collect_arrow()
    want = js.read_gff(path).select("seqname", "start", "end", "phase",
                                    "score").sort(
        (JNullsOrder(J.col("phase"), nulls_first), False),
        ("end", False), "start").collect_arrow()
    assert got.column("phase").null_count > 0
    _assert_equal(got, want)


def test_default_null_placement_matches_jax(tmp_path, sessions):
    ts, js = sessions
    path = _gff(tmp_path)
    cols = ("type", "phase", "start", "score")
    got = ts.read_gff(path).select(*cols).sort(
        ("phase", False), "type", ("score", True), ("start", False)
    ).collect_arrow()
    want = js.read_gff(path).select(*cols).sort(
        ("phase", False), "type", ("score", True), ("start", False)
    ).collect_arrow()
    _assert_equal(got, want)


@pytest.mark.parametrize("run_rows", [200, 450])
def test_multi_run_sort_with_widening_keys_matches_jax(
        tmp_path, sessions, monkeypatch, run_rows):
    monkeypatch.setenv("EXON_TPU_SORT_RUN_ROWS", str(run_rows))
    ts, js = sessions
    path = _long_names_gff(tmp_path / "l.gff3")
    got = ts.read_gff(path).select("seqname", "start").sort(
        ("seqname", False), "start").collect_arrow()
    want = js.read_gff(path).select("seqname", "start").sort(
        ("seqname", False), "start").collect_arrow()
    assert got.num_rows == 1200
    _assert_equal(got, want)


def test_multi_run_query_d_matches_jax(tmp_path, sessions, monkeypatch):
    monkeypatch.setenv("EXON_TPU_SORT_RUN_ROWS", "150")
    ts, js = sessions
    bam = make_bam(500, seed=8, path=str(tmp_path / "p.bam"))
    got = query_d(T, ts, bam).collect_arrow()
    want = query_d(J, js, bam).collect_arrow()
    assert got.num_rows == 500
    _assert_equal(got, want)


def test_multi_run_topk_matches_jax(tmp_path, sessions, monkeypatch):
    monkeypatch.setenv("EXON_TPU_SORT_RUN_ROWS", "150")
    ts, js = sessions
    bam = make_bam(500, seed=8, path=str(tmp_path / "p.bam"))
    got = query_d(T, ts, bam, "inner").limit(40).collect_arrow()
    want = query_d(J, js, bam, "inner").limit(40).collect_arrow()
    assert got.num_rows == 40
    _assert_equal(got, want)


def test_limit_across_batches_matches_jax(tmp_path, sessions):
    ts, js = sessions
    path = _gff(tmp_path)
    for skip, fetch in ((0, 5), (298, 7), (590, 400), (1490, 50)):
        got = ts.read_gff(path).select("seqname", "start").limit(
            fetch, skip).collect_arrow()
        want = js.read_gff(path).select("seqname", "start").limit(
            fetch, skip).collect_arrow()
        _assert_equal(got, want)


def test_sort_keys_twin_matches_jax():
    rng = np.random.default_rng(12)
    n = 200
    words = ["".join(rng.choice(list("ACGT"), rng.integers(0, 20)))
             for _ in range(n)]
    enc = [w.encode() for w in words]
    offs = np.zeros(n + 1, np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    vals = np.frombuffer(b"".join(enc), np.uint8).copy()
    svalid = rng.random(n) < 0.9
    f = rng.standard_normal(n) * 1e3
    f[::17] = -0.0
    fvalid = rng.random(n) < 0.8
    i = rng.integers(-1000, 1000, n).astype(np.int32)
    ivalid = np.ones(n, bool)

    schema = jdt.Schema.of(jdt.Field("s", jdt.utf8),
                           jdt.Field("f", jdt.float64),
                           jdt.Field("i", jdt.int32))
    batch = JBatch(schema, [
        JVarColumn(jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(svalid)),
        JFixedColumn(jnp.asarray(f), jnp.asarray(fvalid)),
        JFixedColumn(jnp.asarray(i), jnp.asarray(ivalid))], np.int32(n))
    specs = ((J.col("s"), True, 3), (JNullsOrder(J.col("f"), True), False, 0),
             (J.col("i"), False, 0))
    want = np.stack([np.asarray(k) for k in j_sort_key_columns(batch, specs)])

    t = torch.from_numpy
    got = sort_keys([VarKey(t(offs), t(vals), t(svalid), 3, True),
                     FixedKey(t(f), t(fvalid), False, True),
                     FixedKey(t(i), t(ivalid), False)], n, "cpu")
    assert got.numpy().tolist() == want.tolist()
