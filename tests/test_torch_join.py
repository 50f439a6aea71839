"""Joins in exon_tpu_torch against exon_tpu at small size: Query C (reads ⋈
genes on a dictionary + integer key, overlap filter, coordinate sort), its
TopK, Query D (R1 ⟕ R2 on the read name) inner and left, an empty build
side, and the full-key verification the port adds. The kernels' twins are
held to the JAX functions they replace. Tolerance: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.bam_fixture import bam_reads, make_bam
from benchlib.gff_fixture import SEQNAMES
from exon_tpu.batch import VarColumn as JVarColumn
from exon_tpu.ops.layout import expand_segments as j_expand_segments
from exon_tpu.plan.expressions import _string_col_eq as j_string_col_eq
from exon_tpu.plan.physical import _hash_bytes_host as j_hash_bytes_host
from exon_tpu.plan.physical import _hash_var as j_hash_var
from exon_tpu_torch.errors import ExecutionError
from exon_tpu_torch.kernels.expand_segments import expand_segments
from exon_tpu_torch.kernels.row_hash import row_hash
from exon_tpu_torch.kernels.string_eq import string_eq
from exon_tpu_torch.plan import physical as TP

BATCH = 300
W = 100_000
TEMPLATES, SEED = 400, 21


@pytest.fixture
def sessions(monkeypatch):
    monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    return T.ExonSession(device="cpu", device_batch_size=BATCH), js


@pytest.fixture
def files(tmp_path):
    bam = make_bam(TEMPLATES, SEED, path=str(tmp_path / "p.bam"))
    return bam, _genes_gff(tmp_path / "g.gff3", bam_reads(TEMPLATES, SEED))


def _genes_gff(path, r, n=150, seed=5) -> str:
    """Genes placed around picked reads (most in the read's 100 kb bin,
    some in the one before), a few sharing a start, plus exon rows that the
    query filters away."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(r["start"]), n, replace=False)
    pick = np.concatenate([pick, pick[:20]])
    seq = r["reference"][pick]
    start = np.maximum(r["start"][pick] - rng.integers(0, 5000, len(pick)), 1)
    end = start + rng.integers(100, 60_000, len(pick))
    typ = np.where(rng.random(len(pick)) < 0.8, "gene", "exon")
    order = np.lexsort((start, seq))
    lines = ["##gff-version 3\n"] + [
        f"{SEQNAMES[seq[i]]}\tHAVANA\t{typ[i]}\t{start[i]}\t{end[i]}\t.\t"
        f"{'+-'[i % 2]}\t.\tID=g{i}\n" for i in order]
    path.write_text("".join(lines))
    return str(path)


def query_c(mod, s, bam, gff):
    c = mod.col
    reads = s.read_bam(bam).select("name", "reference", "start", "end")
    genes = (s.read_gff(gff).filter(c("type") == "gene")
             .select(c("seqname"), c("start").alias("gene_start"),
                     c("end").alias("gene_end"), c("strand")))
    return (reads.join(genes, on=[("reference", "seqname"),
                                  (c("start") / W, c("gene_start") / W)])
            .filter((c("start") >= c("gene_start"))
                    & (c("start") <= c("gene_end")))
            .sort("reference", "start", "name", "gene_start"))


def query_d(mod, s, bam, how="left", r2_bit=128):
    c = mod.col
    r1 = s.read_bam(bam).filter((c("flag") / 64) % 2 == 1).select(
        "name", "reference", "start", "flag")
    r2 = (s.read_bam(bam).filter((c("flag") / r2_bit) % 2 == 1)
          .select(c("name").alias("mate_name"),
                  c("start").alias("mate_start"),
                  c("flag").alias("mate_flag")))
    return r1.join(r2, on=[("name", "mate_name")], how=how).sort(
        "reference", "start", "name")


def _assert_equal(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert got.column(name).to_pylist() == \
            want.column(name).to_pylist(), name


def test_query_c_matches_jax(sessions, files):
    ts, js = sessions
    got = query_c(T, ts, *files).collect_arrow()
    want = query_c(J, js, *files).collect_arrow()
    assert got.num_rows > 100
    assert len(set(got.column("name").to_pylist())) < got.num_rows
    _assert_equal(got, want)


def test_query_c_topk_matches_jax(sessions, files):
    ts, js = sessions
    got = query_c(T, ts, *files).limit(25, skip=3).collect_arrow()
    want = query_c(J, js, *files).limit(25, skip=3).collect_arrow()
    assert got.num_rows == 25
    _assert_equal(got, want)


@pytest.mark.parametrize("how", ["left", "inner"])
def test_query_d_matches_jax(sessions, files, how):
    ts, js = sessions
    got = query_d(T, ts, files[0], how).collect_arrow()
    want = query_d(J, js, files[0], how).collect_arrow()
    n_orphans = TEMPLATES // 100
    assert got.num_rows == TEMPLATES - (n_orphans if how == "inner" else 0)
    assert got.column("mate_flag").null_count == \
        (n_orphans if how == "left" else 0)
    _assert_equal(got, want)


@pytest.mark.parametrize("how", ["left", "inner"])
def test_join_on_filter_matches_jax(sessions, files, how):
    """A residual ON filter (planned by SQL, built here as a plan node):
    a left join keeps one NULL-extended row for a read whose every match
    fails it."""
    from exon_tpu.plan import logical as JL
    from exon_tpu_torch.plan import logical as TL

    def q(mod, logical, s):
        c = mod.col
        r1 = s.read_bam(files[0]).filter((c("flag") / 64) % 2 == 1).select(
            "name", "start")
        r2 = s.read_bam(files[0]).select(c("name").alias("mate_name"),
                                         c("start").alias("mate_start"))
        on = [(c("name"), c("mate_name"))]
        near = (c("mate_start") - c("start") < 400) & \
            (c("mate_start") > c("start"))
        return mod.DataFrame(s, logical.Join(r1.logical_plan(),
                                             r2.logical_plan(), on, how,
                                             near)).sort("start", "name")

    ts, js = sessions
    got = q(T, TL, ts).collect_arrow()
    want = q(J, JL, js).collect_arrow()
    assert 0 < got.column("mate_start").null_count < got.num_rows \
        if how == "left" else 0 < got.num_rows < TEMPLATES
    _assert_equal(got, want)


def test_left_join_against_an_empty_build_side(sessions, files):
    ts, _js = sessions
    got = query_d(T, ts, files[0], "left", r2_bit=4096).collect_host()
    assert got.length == TEMPLATES
    for name in ("mate_name", "mate_start", "mate_flag"):
        assert not got.column(name).validity.any()
    assert query_d(T, ts, files[0], "inner", r2_bit=4096).collect_host() \
        .length == 0


def test_keys_sharing_a_hash_do_not_match(sessions, files, monkeypatch):
    """Every read name hashes to one value: the search then offers every
    R2 to every R1, and only the full-key check keeps the true mates."""
    ts, _js = sessions
    want = query_d(T, ts, files[0]).collect_arrow()
    monkeypatch.setattr(TP, "row_hash", lambda offsets, values: torch.zeros(
        offsets.shape[0] - 1, dtype=torch.int64))
    got = query_d(T, ts, files[0]).collect_arrow()
    assert got.equals(want)
    names, mates = got.column("name").to_pylist(), \
        got.column("mate_name").to_pylist()
    assert all(m is None or m == n for n, m in zip(names, mates))
    assert sum(m is not None for m in mates) == TEMPLATES - TEMPLATES // 100


def test_dictionary_strings_sharing_a_hash_raise(sessions, files,
                                                 monkeypatch):
    ts, _js = sessions
    monkeypatch.setattr(TP, "_hash_bytes_host", lambda s: 7)
    with pytest.raises(ExecutionError, match="share the 64-bit"):
        query_c(T, ts, *files).collect_arrow()


# -- kernel twins against the JAX functions they replace -------------------


def _var(strings):
    enc = [s.encode() for s in strings]
    offs = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    vals = np.frombuffer(b"".join(enc) or b"\0", np.uint8)[: offs[-1]].copy()
    return vals, offs


def test_expand_segments_twin_matches_jax():
    rng = np.random.default_rng(1)
    counts = rng.integers(0, 5, 300).astype(np.int32)
    lo = rng.integers(0, 50, 300).astype(np.int32)
    ends = np.cumsum(counts)
    total = int(ends[-1])
    probe, build, offsets, got_total = expand_segments(
        torch.from_numpy(lo), torch.from_numpy(counts), 50)
    assert got_total == total
    assert offsets.numpy().tolist() == [0] + ends.tolist()
    rid, intra, jtotal = j_expand_segments(jnp.asarray(counts), total)
    assert int(jtotal) == total
    assert probe.numpy().tolist() == np.asarray(rid).tolist()
    want = np.clip(lo[np.asarray(rid)] + np.asarray(intra), 0, 49)
    assert build.numpy().tolist() == want.tolist()


def test_row_hash_twin_matches_jax():
    rng = np.random.default_rng(2)
    strings = ["", "a", "chr1"] + [
        "".join(rng.choice(list("ACGT:0123456789"), rng.integers(0, 80)))
        for _ in range(200)]
    vals, offs = _var(strings)
    got = row_hash(torch.from_numpy(offs), torch.from_numpy(vals))
    want = j_hash_var(JVarColumn(jnp.asarray(vals), jnp.asarray(offs),
                                 jnp.ones(len(strings), bool)))
    assert got.numpy().tolist() == np.asarray(want).tolist()
    assert got.numpy().tolist() == [j_hash_bytes_host(s.encode())
                                    for s in strings]


def test_string_eq_twin_matches_jax_below_32_bytes():
    rng = np.random.default_rng(3)
    words = ["".join(rng.choice(list("AB"), rng.integers(0, 6)))
             for _ in range(120)]
    a_vals, a_offs = _var(words)
    valid = rng.random(120) < 0.9
    ia = rng.integers(0, 120, 500).astype(np.int32)
    ib = rng.integers(0, 120, 500).astype(np.int32)
    col = (torch.from_numpy(a_offs), torch.from_numpy(a_vals),
           torch.from_numpy(valid))
    got = string_eq(col, torch.from_numpy(ia), col, torch.from_numpy(ib))

    def taken(idx):
        vals, offs = _var([words[i] for i in idx])
        return JVarColumn(jnp.asarray(vals), jnp.asarray(offs),
                          jnp.asarray(valid[idx]))

    want = j_string_col_eq(taken(ia), taken(ib))
    assert got.numpy().tolist() == np.asarray(want).tolist()
    assert 0 < int(got.sum()) < 500


def test_string_eq_compares_past_32_bytes():
    """The JAX check reads 32 bytes and the length; the port every byte."""
    a, b = "x" * 32 + "left", "x" * 32 + "rite"
    vals, offs = _var([a, b])
    col = (torch.from_numpy(offs), torch.from_numpy(vals),
           torch.ones(2, dtype=torch.bool))
    i0, i1 = torch.tensor([0], dtype=torch.int32), torch.tensor(
        [1], dtype=torch.int32)
    assert not bool(string_eq(col, i0, col, i1)[0])
    assert bool(string_eq(col, i0, col, i0)[0])
    one_a = JVarColumn(jnp.asarray(vals[:36]), jnp.asarray(offs[:2]),
                       jnp.ones(1, bool))
    one_b = JVarColumn(jnp.asarray(vals[36:]), jnp.asarray(offs[:2]),
                       jnp.ones(1, bool))
    assert bool(np.asarray(j_string_col_eq(one_a, one_b))[0])
