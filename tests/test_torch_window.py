"""Window functions and the set operators of exon_tpu_torch (slice 8)
against exon_tpu's, on the CPU.

Small seeded files (two BGZF VCFs over different contigs, one with a
``.tbi``, and a GFF) are written under ``tmp_path`` and queried through
``exon_tpu.ExonSession.sql`` and ``exon_tpu_torch.ExonSession(device=
"cpu").sql``: all 16 window functions with and without PARTITION BY and
ORDER BY, ROWS and RANGE frames (unbounded, offsets on either side, frames
that come out empty, ASC and DESC keys, NULL keys, ties), NULLS FIRST/LAST,
lag/lead with a default, nth_value, ntile with more buckets than rows,
string, dictionary, integer and two-column partitions, a named WINDOW,
DISTINCT ON, the six set operations (a dictionary column whose vocabularies
differ between the inputs among them), GROUPING SETS, ROLLUP and CUBE with
grouping(), RIGHT and FULL JOIN, an empty window input and Query L at a
small size.

The Arrow tables are equal: values, types, nulls and row order (every query
here fixes its order: window outputs keep input order, and the set
operations and GROUPING SETS give their groups in first-seen order in both
packages). Tolerance: exact. The float32 ``qual`` values are whole numbers
below 2^24 in sum, so float32 sums are exact in both packages; ``gap`` and
the other integer results are exact by nature.

The JAX faults the port does not copy (ROADMAP Queue 3) are shown with
both answers: F19 (a string window ORDER BY compares 8-byte prefixes), F20
(PARTITION BY and DISTINCT ON key on an unverified 64-bit hash), F21
(``DataFrame.join(how="full")`` is an inner join) and F22 (window SUM/AVG
of a float32 column from float32 prefix differences).
"""

import numpy as np
import pytest

import exon_tpu as J
import exon_tpu_torch as T
from exon_tpu.io.bgzf import compress_bgzf
from exon_tpu.io.index_build import build_tabix_vcf
from exon_tpu.plan import physical as JP
from exon_tpu_torch.plan import physical as TP

BATCH = 128
AVG_RTOL = 1e-5


def _vcf_text(seed: int, n: int, contigs: tuple, ref_len=(1, 7),
              span: int = 3000, ref_prefixes=(b"",)) -> bytes:
    """A coordinate-sorted VCF: positions from a narrow span (so they tie
    and RANGE frames hold several rows), REFs of one of ``ref_prefixes``
    and then ``ref_len`` random bases, whole QUALs with 10 % NULL ('.')."""
    rng = np.random.default_rng(seed)
    head = [b"##fileformat=VCFv4.2"]
    head += [b"##contig=<ID=%s,length=1000000>" % c.encode()
             for c in contigs]
    head.append(b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
    lines = []
    for c in contigs:
        for pos in np.sort(rng.integers(1, span, n)):
            ref = ref_prefixes[rng.integers(len(ref_prefixes))] + rng.choice(
                np.frombuffer(b"ACGT", np.uint8),
                rng.integers(*ref_len)).tobytes()
            qual = b"." if rng.random() < 0.1 else \
                b"%d" % rng.integers(10, 4000)
            lines.append(b"%s\t%d\t.\t%s\tA\t%s\tPASS\tDP=%d" % (
                c.encode(), pos, ref, qual, pos % 97))
    return b"\n".join(head + lines) + b"\n"


def _write_vcf(path, text: bytes, index: bool = False) -> str:
    bg = compress_bgzf(text)
    with open(path, "wb") as f:
        f.write(bg)
    if index:
        with open(str(path) + ".tbi", "wb") as f:
            f.write(build_tabix_vcf(bg))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from benchlib.gff_fixture import make_gff

    d = tmp_path_factory.mktemp("window")
    out = {
        "a": _write_vcf(d / "a.vcf.gz", _vcf_text(
            3, 120, ("chr1", "chr2", "chr10")), index=True),
        "b": _write_vcf(d / "b.vcf.gz", _vcf_text(
            4, 90, ("chr2", "chr3", "chrX"))),
        "gff": make_gff(400, 11, path=str(d / "g.gff")),
    }
    panel = d / "panel.txt"
    panel.write_text("chr1:1-2000\nchr2:1-3000\nchr10:500-2500\n")
    out["panel"] = str(panel)
    return out


@pytest.fixture(scope="module")
def sessions():
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    return T.ExonSession(device="cpu", device_batch_size=BATCH), js


def _assert_equal(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        assert g.to_pylist() == w.to_pylist(), name


def _both(sessions, files, sql: str):
    ts, js = sessions
    sql = sql.format(**files)
    got = ts.sql(sql).collect_arrow()
    _assert_equal(got, js.sql(sql).collect_arrow())
    return got


V = "vcf_scan('{a}')"
W = "vcf_scan('{b}')"
G = "gff_scan('{gff}')"
ALL16 = ("row_number() OVER ({o}) AS rn, rank() OVER ({o}) AS rk, "
         "dense_rank() OVER ({o}) AS dr, percent_rank() OVER ({o}) AS pr, "
         "cume_dist() OVER ({o}) AS cd, ntile(3) OVER ({o}) AS nt, "
         "count(qual) OVER ({o}) AS c, sum(qual) OVER ({o}) AS s, "
         "min(qual) OVER ({o}) AS mn, max(pos) OVER ({o}) AS mx, "
         "avg(qual) OVER ({o}) AS a, lag(pos) OVER ({o}) AS lg, "
         "lead(qual) OVER ({o}) AS ld, first_value(qual) OVER ({o}) AS fv, "
         "last_value(pos) OVER ({o}) AS lv, nth_value(qual, 2) OVER ({o}) "
         "AS nv")

WINDOW_QUERIES = {
    # the 16 functions with and without PARTITION BY and ORDER BY
    "all16_partition_order": f"SELECT chrom, pos, qual, "
    f"{ALL16.format(o='PARTITION BY chrom ORDER BY pos')} FROM {V}",
    "all16_order": f"SELECT chrom, pos, "
    f"{ALL16.format(o='ORDER BY qual DESC')} FROM {V}",
    "all16_partition": f"SELECT chrom, pos, "
    f"{ALL16.format(o='PARTITION BY chrom')} FROM {V}",
    "all16_neither": f"SELECT pos, {ALL16.format(o='')} FROM {V}",
    "rows_frames": "SELECT pos, qual, "
    "sum(pos) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN UNBOUNDED "
    "PRECEDING AND CURRENT ROW) AS run, "
    "min(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 2 "
    "PRECEDING AND 2 FOLLOWING) AS mn, "
    "max(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 3 "
    "FOLLOWING AND 5 FOLLOWING) AS ahead, "
    "count(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 5 "
    "PRECEDING AND 2 PRECEDING) AS behind, "
    "avg(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN CURRENT "
    "ROW AND UNBOUNDED FOLLOWING) AS rest, "
    "first_value(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 1 "
    "FOLLOWING AND 1 FOLLOWING) AS nxt, "
    "last_value(pos) OVER (PARTITION BY chrom ORDER BY pos ROWS 2 "
    "PRECEDING) AS lv, "
    "nth_value(qual, 3) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN "
    "100 PRECEDING AND 100 FOLLOWING) AS nv, "
    "max(pos) OVER (ORDER BY pos ROWS BETWEEN 70 PRECEDING AND CURRENT ROW) "
    "AS wide, "
    "min(pos) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 1 "
    "FOLLOWING AND 1 PRECEDING) AS never FROM " + V,
    "range_frames": "SELECT pos, qual, "
    "count(*) OVER (PARTITION BY chrom ORDER BY pos RANGE BETWEEN 35 "
    "PRECEDING AND 35 FOLLOWING) AS near, "
    "sum(qual) OVER (PARTITION BY chrom ORDER BY pos DESC RANGE BETWEEN 100 "
    "PRECEDING AND CURRENT ROW) AS after, "
    "max(pos) OVER (PARTITION BY chrom ORDER BY qual RANGE BETWEEN 100 "
    "PRECEDING AND 100 FOLLOWING) AS q_asc, "
    "min(pos) OVER (PARTITION BY chrom ORDER BY qual DESC RANGE BETWEEN 50 "
    "PRECEDING AND 10 FOLLOWING) AS q_desc, "
    "avg(pos) OVER (ORDER BY qual NULLS FIRST RANGE BETWEEN CURRENT ROW AND "
    "200 FOLLOWING) AS q_nf, "
    "count(pos) OVER (PARTITION BY chrom ORDER BY qual RANGE BETWEEN "
    "UNBOUNDED PRECEDING AND 5 PRECEDING) AS below, "
    "first_value(qual) OVER (PARTITION BY chrom ORDER BY pos RANGE BETWEEN "
    "30 PRECEDING AND 30 FOLLOWING) AS fv, "
    "last_value(qual) OVER (PARTITION BY chrom ORDER BY pos RANGE BETWEEN "
    "30 PRECEDING AND 30 FOLLOWING) AS lv, "
    "nth_value(pos, 2) OVER (PARTITION BY chrom ORDER BY pos RANGE BETWEEN "
    "CURRENT ROW AND CURRENT ROW) AS tie2 FROM " + V,
    "nulls_order": "SELECT pos, qual, "
    "rank() OVER (ORDER BY qual NULLS FIRST) AS nf, "
    "rank() OVER (ORDER BY qual DESC NULLS LAST) AS dl, "
    "row_number() OVER (PARTITION BY chrom ORDER BY qual) AS asc_last, "
    "cume_dist() OVER (ORDER BY qual DESC) AS desc_first, "
    "dense_rank() OVER (PARTITION BY chrom ORDER BY qual DESC, pos) AS two "
    "FROM " + V,
    "shift_defaults": "SELECT pos, "
    "lag(pos) OVER (PARTITION BY chrom ORDER BY pos) AS prev, "
    "lead(qual, 2) OVER (PARTITION BY chrom ORDER BY pos) AS next2, "
    "lag(pos, 3, -1) OVER (PARTITION BY chrom ORDER BY pos) AS prev3, "
    "lead(qual, 1, 0.5) OVER (PARTITION BY chrom ORDER BY pos) AS nextd, "
    "lag(qual, 2, 7) OVER (ORDER BY pos DESC) AS back, "
    "pos - lag(pos) OVER (PARTITION BY chrom ORDER BY pos) AS gap FROM " + V,
    "ntile_and_nth": "SELECT pos, "
    "ntile(1000) OVER (PARTITION BY chrom ORDER BY pos) AS many, "
    "ntile(7) OVER (ORDER BY pos) AS seven, "
    "nth_value(pos, 5) OVER (PARTITION BY chrom ORDER BY pos) AS fifth, "
    "nth_value(qual, 500) OVER (PARTITION BY chrom) AS past FROM " + V,
    "partitions": "SELECT chrom, ref, pos, "
    "count(*) OVER (PARTITION BY ref) AS by_string, "
    "count(*) OVER (PARTITION BY chrom) AS by_dict, "
    "count(*) OVER (PARTITION BY pos % 7) AS by_int, "
    "row_number() OVER (PARTITION BY chrom, ref ORDER BY pos) AS by_two, "
    "rank() OVER (PARTITION BY chrom ORDER BY ref) AS by_ref "
    "FROM " + V,
    "gff_partitions": "SELECT seqname, strand, start, "
    "row_number() OVER (PARTITION BY seqname, strand ORDER BY start DESC) "
    "AS r, sum(score) OVER (PARTITION BY type ORDER BY start) AS s, "
    "max(score) OVER (PARTITION BY strand ORDER BY start ROWS BETWEEN 4 "
    "PRECEDING AND 4 FOLLOWING) AS m FROM " + G,
    "named_window": "SELECT pos, row_number() OVER w AS r, sum(pos) OVER w "
    "AS s, lag(qual) OVER w AS l FROM " + V +
    " WINDOW w AS (PARTITION BY chrom ORDER BY pos)",
    "distinct_on": "SELECT DISTINCT ON (chrom) chrom, pos, qual FROM " + V
    + " ORDER BY chrom, qual DESC",
    "empty_input": "SELECT pos, row_number() OVER (ORDER BY pos) AS r, "
    "sum(qual) OVER (PARTITION BY chrom) AS s FROM " + V + " WHERE pos < 0",
    # Query L at a small size: the panel's scan through the .tbi
    "query_l": "SELECT chrom, pos, qual, pos - lag(pos) OVER (PARTITION BY "
    "chrom ORDER BY pos) AS gap, COUNT(*) OVER (PARTITION BY chrom ORDER BY "
    "pos RANGE BETWEEN 35 PRECEDING AND 35 FOLLOWING) AS cluster_n, "
    "MAX(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 5 "
    "PRECEDING AND 5 FOLLOWING) AS local_max_qual, rank() OVER (PARTITION BY "
    "chrom ORDER BY qual DESC) AS qual_rank FROM "
    "vcf_indexed_scan('{a}', '{panel}')",
}

SET_QUERIES = {
    "union": f"SELECT chrom, ref FROM {V} UNION SELECT chrom, ref FROM {W}",
    "union_all": f"SELECT chrom, pos FROM {V} UNION ALL SELECT chrom, pos "
    f"FROM {W}",
    "intersect": f"SELECT chrom, ref FROM {V} INTERSECT SELECT chrom, ref "
    f"FROM {W}",
    "except": f"SELECT chrom, ref FROM {V} EXCEPT SELECT chrom, ref FROM {W}",
    "intersect_all": f"SELECT ref FROM {V} INTERSECT ALL SELECT ref FROM {W}",
    "except_all": f"SELECT ref FROM {V} EXCEPT ALL SELECT ref FROM {W}",
    # chrom is a dictionary in both inputs, over other contigs in each: the
    # vocabularies differ, into the aggregate and the sort above the union
    "dictionary_vocabularies": "SELECT chrom, COUNT(*) AS n, MAX(pos) AS mx "
    f"FROM (SELECT chrom, pos FROM {V} UNION ALL SELECT chrom, pos FROM {W}"
    ") t GROUP BY chrom ORDER BY chrom",
    "dictionary_and_string": f"SELECT chrom FROM {V} UNION SELECT ref FROM "
    f"{W}",
    "grouping_sets": f"SELECT chrom, ref, COUNT(*) AS n FROM {V} GROUP BY "
    "GROUPING SETS ((chrom), (ref), ())",
    "rollup": f"SELECT chrom, ref, COUNT(*) AS n, grouping(chrom, ref) AS g "
    f"FROM {V} WHERE qual >= 30 GROUP BY ROLLUP(chrom, ref)",
    "cube": "SELECT seqname, strand, COUNT(*) AS n, SUM(start) AS s, "
    f"grouping(strand) AS g FROM {G} GROUP BY CUBE(seqname, strand)",
    "right_join": f"SELECT a.chrom, a.pos, b.qual FROM {V} a RIGHT JOIN {W} "
    "b ON a.pos = b.pos",
    "full_join": f"SELECT a.chrom, a.pos, b.chrom AS bc, b.pos AS bp FROM "
    f"{V} a FULL JOIN {W} b ON a.pos = b.pos AND a.chrom = b.chrom",
}


@pytest.mark.parametrize("name", list(WINDOW_QUERIES))
def test_window_query_matches_jax(sessions, files, name):
    got = _both(sessions, files, WINDOW_QUERIES[name])
    if name != "empty_input":
        assert got.num_rows > 0


@pytest.mark.parametrize("name", list(SET_QUERIES))
def test_set_operation_matches_jax(sessions, files, name):
    got = _both(sessions, files, SET_QUERIES[name])
    assert got.num_rows > 0


def test_dataframe_union_matches_jax(sessions, files):
    ts, js = sessions
    got = ts.read_vcf(files["a"]).select("chrom", "pos").union(
        ts.read_vcf(files["b"]).select("chrom", "pos")).collect_arrow()
    want = js.read_vcf(files["a"]).select("chrom", "pos").union(
        js.read_vcf(files["b"]).select("chrom", "pos")).collect_arrow()
    _assert_equal(got, want)


@pytest.mark.parametrize("sql,error", [
    ("SELECT lag(ref) OVER (ORDER BY pos) AS x FROM " + V, "PlanError"),
    ("SELECT count(*) OVER (ORDER BY pos, qual RANGE BETWEEN 1 PRECEDING "
     "AND 1 FOLLOWING) AS x FROM " + V, "PlanError"),
    ("SELECT count(*) OVER (ORDER BY ref RANGE BETWEEN 1 PRECEDING AND 1 "
     "FOLLOWING) AS x FROM " + V, "PlanError"),
], ids=["string_value", "range_two_keys", "range_string_key"])
def test_window_errors_match_jax(sessions, files, sql, error):
    ts, js = sessions
    sql = sql.format(**files)
    with pytest.raises(Exception) as want:
        js.sql(sql).collect_arrow()
    with pytest.raises(Exception) as got:
        ts.sql(sql).collect_arrow()
    assert type(got.value).__name__ == type(want.value).__name__ == error


# ---------------------------------------------------------------------------
# Reference faults: both answers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def long_refs(tmp_path_factory):
    """REFs of 9-14 bases over two 8-base prefixes."""
    d = tmp_path_factory.mktemp("long")
    return _write_vcf(d / "l.vcf.gz", _vcf_text(
        8, 200, ("chr1",), ref_len=(1, 7),
        ref_prefixes=(b"ACGTACGT", b"TTTTGGGG")))


def test_f19_string_window_order_compares_every_byte(sessions, long_refs):
    """F19: the JAX window orders a string ORDER BY key by its first 8
    bytes (exon_tpu/plan/window_exec.py:99 through _sort_key_value_raw), so
    REFs that share 8 bytes are peers there: one rank for all of them. The
    port orders by every byte, as a plain Python sort does."""
    ts, js = sessions
    sql = (f"SELECT ref, rank() OVER (ORDER BY ref) AS r FROM "
           f"vcf_scan('{long_refs}')")
    got = ts.sql(sql).collect_arrow()
    want = js.sql(sql).collect_arrow()
    refs = got.column("ref").to_pylist()
    ordered = sorted(refs)
    expect = [ordered.index(r) + 1 for r in refs]
    assert got.column("r").to_pylist() == expect
    jax_ranks = want.column("r").to_pylist()
    prefix = sorted(r[:8] for r in refs)
    assert jax_ranks == [prefix.index(r[:8]) + 1 for r in refs]
    assert jax_ranks != expect


def test_f20_partition_by_and_distinct_on_do_not_trust_a_hash(
        sessions, files, monkeypatch):
    """F20: the JAX window keys PARTITION BY (and so DISTINCT ON) on the
    unverified 64-bit ``_group_key_i64`` (exon_tpu/plan/window_exec.py:117;
    F3). A forced collision (every string hashes to 0) merges every REF
    into one partition there. The port compares the keys' bytes and calls
    no hash: with its row hash forced to 0 too, its answer is unchanged."""
    ts, js = sessions
    part = (f"SELECT ref, count(*) OVER (PARTITION BY ref) AS n FROM "
            f"vcf_scan('{files['a']}')")
    don = (f"SELECT DISTINCT ON (ref) ref, pos FROM vcf_scan('{files['a']}')"
           " ORDER BY ref, pos")
    right = [ts.sql(q).collect_arrow() for q in (part, don)]
    refs = right[0].column("ref").to_pylist()
    assert right[0].column("n").to_pylist() == [refs.count(r) for r in refs]
    assert right[1].num_rows == len(set(refs))
    import jax.numpy as jnp

    monkeypatch.setattr(TP, "row_hash", lambda offsets, values: None)
    monkeypatch.setattr(JP, "_hash_var", lambda v: jnp.zeros(
        v.offsets.shape[0] - 1, jnp.int64))
    for q, want in zip((part, don), right):
        _assert_equal(ts.sql(q).collect_arrow(), want)
    merged = js.sql(part).collect_arrow()
    assert set(merged.column("n").to_pylist()) == {len(refs)}
    assert js.sql(don).collect_arrow().num_rows == 1


@pytest.mark.parametrize("how", ["full", "right", "outer"])
def test_f21_dataframe_join_takes_inner_or_left(sessions, files, how):
    """F21: the JAX JoinExec knows only "left" and gives an inner join for
    any other ``how`` (exon_tpu/plan/join_exec.py:216-219, :280, :297-298).
    The port raises."""
    ts, js = sessions

    def join(s):
        col = (T if s is ts else J).col
        a = s.read_vcf(files["a"]).select("chrom", "pos")
        b = s.read_vcf(files["b"]).select(col("pos").alias("bpos"))
        return a.join(b, on=[("pos", "bpos")], how=how)

    inner = js.read_vcf(files["a"]).select("chrom", "pos").join(
        js.read_vcf(files["b"]).select(J.col("pos").alias("bpos")),
        on=[("pos", "bpos")]).collect_arrow()
    assert join(js).collect_arrow().equals(inner)
    with pytest.raises(NotImplementedError, match="inner or left"):
        join(ts).collect_arrow()


def test_f22_float32_window_sums_in_float64(sessions, tmp_path):
    """F22: window SUM/AVG of a float32 column take float32 prefix sums in
    the JAX package (exon_tpu/plan/window_exec.py:365, :402), and a frame's
    sum is the difference of two of them. On the shape of the VCF qual
    (whole numbers 10-3999, 40,000 rows a contig) the prefixes pass 2^24,
    where float32 stops holding whole numbers: measured here, the JAX sums
    are off by more than AVG_RTOL. The port sums in float64 (as F13): its
    AVG equals the float64 sum exactly and its SUM is that sum rounded
    once to the column's float32."""
    path = _write_vcf(tmp_path / "f22.vcf.gz", _vcf_text(
        22, 40_000, ("chr1",), span=10_000_000))
    ts, js = sessions
    sql = (f"SELECT qual, SUM(qual) OVER (ORDER BY pos ROWS BETWEEN 5 "
           f"PRECEDING AND 5 FOLLOWING) AS s, AVG(qual) OVER (ORDER BY pos "
           f"ROWS BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS a FROM "
           f"vcf_scan('{path}')")
    got = ts.sql(sql).collect_arrow()
    want = js.sql(sql).collect_arrow()
    q = got.column("qual").to_numpy(zero_copy_only=False)
    ok = ~np.isnan(q)
    x = np.where(ok, q, 0).astype(np.float64)
    c = np.convolve(ok.astype(np.float64), np.ones(11), "same")
    exact = np.convolve(x, np.ones(11), "same")
    assert np.cumsum(x)[-1] > 2 ** 24
    port_s = got.column("s").to_numpy(zero_copy_only=False)
    port_a = got.column("a").to_numpy(zero_copy_only=False)
    assert np.array_equal(port_s, exact.astype(np.float32))
    assert np.array_equal(port_a, exact / c)
    jax_s = want.column("s").to_numpy(zero_copy_only=False)
    jax_a = want.column("a").to_numpy(zero_copy_only=False)
    err = np.max(np.abs(jax_a - exact / c) / (exact / c))
    assert err > AVG_RTOL
    assert np.max(np.abs(jax_s - exact) / exact) > AVG_RTOL
