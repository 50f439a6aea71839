"""The VCF path of exon_tpu_torch (slice 6, BASELINE config 3) against
exon_tpu's, on the CPU.

Small seeded VCFs, BGZF with a ``.tbi`` built by
``exon_tpu.io.index_build.build_tabix_vcf`` and the same text without one,
go through ``exon_tpu.ExonSession`` and ``exon_tpu_torch.ExonSession(
device="cpu")``: the decode of every column the port carries, the region
markers in DataFrame and SQL form, ``vcf_indexed_scan`` with a region and a
region file, and Query I (region → ``qual >= 30`` → GROUP BY chrom, ref with
COUNT, AVG, STDDEV and VAR_POP). Arrow tables are equal: values, types,
nulls and row order. Tolerance: exact, except the float64 var/stddev
results, relative 1e-9 (Σx² − (Σx)²/n summed in another order), and AVG
of the float32 ``qual``, relative 1e-5 (the JAX package sums float32, F13).
``benchlib/vcf_fixture.py``'s index is held to ``build_tabix_vcf``'s over
the same BGZF file. The JAX faults the port does not copy (F15) are shown
with both answers.
"""

import numpy as np
import pyarrow as pa
import pytest

import exon_tpu as J
import exon_tpu_torch as T
from benchlib import vcf_fixture
from exon_tpu.errors import InvalidRegionError as JInvalidRegion
from exon_tpu.io.bgzf import compress_bgzf
from exon_tpu.io.index_build import build_tabix_vcf
from exon_tpu.io.indexes import Region as JRegion
from exon_tpu.io.indexes import parse_tabix as jparse_tabix
from exon_tpu.plan.expressions import FunctionCall as JFunctionCall
from exon_tpu_torch.errors import InvalidRegionError
from exon_tpu_torch.indexes import parse_tabix
from exon_tpu_torch.plan import physical as TP
from exon_tpu_torch.region import Region

BATCH = 300
VAR_RTOL = 1e-9
AVG_RTOL = 1e-5
CONTIGS = ("chr1", "chr2", "chrX")
QUERY_I = ("SELECT chrom, ref, COUNT(*) AS n, AVG(qual) AS mean_qual, "
           "STDDEV(qual) AS sd_qual, VAR_POP(qual) AS var_qual FROM "
           "vcf_indexed_scan('{p}', '{r}') WHERE qual >= 30 "
           "GROUP BY chrom, ref")


def _vcf_text(seed: int, n: int, samples: bool = False) -> bytes:
    """A coordinate-sorted VCF over three contigs (and a fourth declared
    one without records): 1-3 base REFs, 5 % NULL QUAL, '.' INFO now and
    then, and optionally a FORMAT column with one sample."""
    rng = np.random.default_rng(seed)
    head = [b"##fileformat=VCFv4.2"]
    head += [b"##contig=<ID=%s,length=1000000>" % c.encode()
             for c in CONTIGS + ("chrY",)]
    head.append(b'##INFO=<ID=DP,Number=1,Type=Integer,Description="d">')
    cols = b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"
    head.append(cols + (b"\tFORMAT\tS1" if samples else b""))
    lines = []
    for c in CONTIGS:
        for pos in np.sort(rng.integers(1, 200_000, n)):
            ref = bytes(rng.choice(list(b"ACGT"), rng.integers(1, 4)))
            qual = b"." if rng.random() < 0.05 else \
                b"%d" % rng.integers(10, 4000)
            info = b"." if rng.random() < 0.1 else b"DP=%d" % (pos % 97)
            line = b"%s\t%d\trs%d\t%s\tA,T\t%s\tPASS\t%s" % (
                c.encode(), pos, pos, ref, qual, info)
            if samples:
                line += b"\tGT:DP\t0/1:%d" % (pos % 13)
            lines.append(line)
    return b"\n".join(head + lines) + b"\n"


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("vcf")
    out = {}
    for name, text in (("plain", _vcf_text(1, 900)),
                       ("samples", _vcf_text(2, 200, samples=True))):
        bg = compress_bgzf(text)
        for kind in ("indexed", "bare"):
            p = str(d / f"{name}_{kind}.vcf.gz")
            with open(p, "wb") as f:
                f.write(bg)
            if kind == "indexed":
                with open(p + ".tbi", "wb") as f:
                    f.write(build_tabix_vcf(bg))
            out[f"{name}_{kind}"] = p
    regions = d / "panel.txt"
    regions.write_text("chr1:1-50000\n\nchrX:100000-150000\nchr2\n")
    out["panel"] = str(regions)
    return out


@pytest.fixture(scope="module")
def sessions():
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    return T.ExonSession(device="cpu", device_batch_size=BATCH), js


def assert_tables_match(got: pa.Table, want: pa.Table, var_cols=(),
                        avg_cols=()):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if name in var_cols or name in avg_cols:
            rtol = VAR_RTOL if name in var_cols else AVG_RTOL
            np.testing.assert_allclose(
                np.asarray(g.fill_null(0).to_pylist(), np.float64),
                np.asarray(w.fill_null(0).to_pylist(), np.float64),
                rtol=rtol, atol=0, err_msg=name)
        else:
            assert g.to_pylist() == w.to_pylist(), name


def _both(sessions, sql: str, **tol):
    ts, js = sessions
    got = ts.sql(sql).collect_arrow()
    assert_tables_match(got, js.sql(sql).collect_arrow(), **tol)
    return got


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["plain_indexed", "plain_bare",
                                  "samples_bare"])
def test_decode_matches_jax(sessions, files, name):
    got = _both(sessions, "SELECT chrom, pos, ref, qual, info, formats FROM "
                f"vcf_scan('{files[name]}')")
    assert got.num_rows == (3 * 900 if name.startswith("plain") else 600)
    assert got.column("qual").null_count > 0
    assert got.column("info").null_count > 0


def test_read_vcf_matches_jax(sessions, files):
    ts, js = sessions
    p = files["plain_indexed"]
    got = ts.read_vcf(p).select("pos", "chrom", "qual").collect_arrow()
    want = js.read_vcf(p).select("pos", "chrom", "qual").collect_arrow()
    assert_tables_match(got, want)


@pytest.mark.parametrize("column", ["id", "alt", "filter"])
def test_list_columns_raise(sessions, files, column):
    """Since item 2b + 3, id, alt and filter are List<Utf8> columns: the
    JAX package's answer, through a filter and a sort."""
    _both(sessions, f"SELECT pos, {column} FROM vcf_scan("
          f"'{files['plain_bare']}') WHERE qual >= 30 ORDER BY pos DESC")


def test_typed_info_raises(sessions, files):
    """Since item 2b + 3, parse_info gives a struct of the header's INFO
    fields: the JAX package's answer (its session config sets the flag)."""
    ts, js = sessions
    df = ts.read_vcf(files["plain_bare"], parse_info=True)
    assert df.schema().field("info").dtype.kind.value == "struct"
    js.config.vcf_parse_info = True
    try:
        want = js.read_vcf(files["plain_bare"]).select("pos", "info") \
            .collect_arrow()
    finally:
        js.config.vcf_parse_info = False
    assert_tables_match(df.select("pos", "info").collect_arrow(), want)


# a VCF with '.' items in every list field, multi-valued ALT/FILTER/ID,
# INFO of each declared kind (Integer 1, Float A, Flag, String .) and two
# samples with FORMAT GT:DP:AD, some values '.'
_TYPED_VCF = b"""##fileformat=VCFv4.2
##contig=<ID=chr1,length=1000000>
##INFO=<ID=DP,Number=1,Type=Integer,Description="depth">
##INFO=<ID=AF,Number=A,Type=Float,Description="freq">
##INFO=<ID=DB,Number=0,Type=Flag,Description="dbsnp">
##INFO=<ID=ANN,Number=.,Type=String,Description="annotation">
##FILTER=<ID=q10,Description="low">
##FORMAT=<ID=GT,Number=1,Type=String,Description="genotype">
##FORMAT=<ID=DP,Number=1,Type=Integer,Description="depth">
##FORMAT=<ID=AD,Number=R,Type=Integer,Description="allele depths">
#CHROM	POS	ID	REF	ALT	QUAL	FILTER	INFO	FORMAT	S1	S2
chr1	100	rs1;rs2	A	C,G	50	PASS	DP=10;AF=0.25,0.5;DB;ANN=x,y	GT:DP:AD	0/1:7:3,4	1/1:.:.
chr1	200	.	C	.	.	.	.	GT:DP:AD	./.:.:.	0/0:3:3,0
chr1	300	rs3	G	T	12.5	q10;PASS	AF=.;ANN=z	GT	0/1	.
chr1	400	rs4	T	A,C,TT	99	q10	DP=.;AF=0.1,.,0.3	GT:AD	1/2:1,.,3	0/1:5,5
"""


@pytest.mark.parametrize("flags", [(False, False), (True, False),
                                   (False, True), (True, True)],
                         ids=["untyped", "info", "formats", "both"])
def test_vcf_list_and_typed_fields_match_jax(tmp_path, sessions, flags):
    """id/alt/filter with '.' items and several values, and info/formats
    untyped and typed (parse_info, parse_formats), through the decoder and
    a session: equal Arrow tables."""
    from exon_tpu.formats import vcf as jvcf
    from exon_tpu_torch.formats import vcf as tvcf

    parse_info, parse_formats = flags
    got = list(tvcf.decode_host(_TYPED_VCF, tvcf.VcfOptions(
        batch_size=3, parse_info=parse_info, parse_formats=parse_formats)))
    want = list(jvcf.decode_host(_TYPED_VCF, jvcf.VcfOptions(
        batch_size=3, parse_info=parse_info, parse_formats=parse_formats)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.to_arrow().equals(w.to_arrow())
    path = tmp_path / "t.vcf"
    path.write_bytes(_TYPED_VCF)
    ts, js = sessions
    js.config.vcf_parse_info, js.config.vcf_parse_formats = flags
    try:
        want = js.read_vcf(str(path)).collect_arrow()
    finally:
        js.config.vcf_parse_info = js.config.vcf_parse_formats = False
    got = ts.read_vcf(str(path), parse_info=parse_info,
                      parse_formats=parse_formats).collect_arrow()
    assert_tables_match(got, want)
    assert got.column("alt").to_pylist() == [["C", "G"], None, ["T"],
                                             ["A", "C", "TT"]]


def test_f25_list_is_null(tmp_path, sessions):
    """F25: IS NULL over a list column reads the list's validity in the
    port ('.' ALT is NULL); the JAX ``_validity_of`` calls every list
    valid, so no row is NULL there."""
    path = tmp_path / "t.vcf"
    path.write_bytes(_TYPED_VCF)
    ts, js = sessions
    sql = f"SELECT pos FROM vcf_scan('{path}') WHERE alt IS NULL"
    assert ts.sql(sql).collect_arrow().column("pos").to_pylist() == [200]
    assert js.sql(sql).collect_arrow().num_rows == 0


def test_create_external_table_stored_as_vcf(sessions, files):
    ts, js = sessions
    for s in (ts, js):
        s.sql(f"CREATE EXTERNAL TABLE calls STORED AS VCF LOCATION "
              f"'{files['plain_indexed']}'")
    _both(sessions, "SELECT chrom, COUNT(*) AS n FROM calls "
          "WHERE vcf_region_filter('chr2:1000-90000', chrom, pos) "
          "GROUP BY chrom")


# ---------------------------------------------------------------------------
# regions
# ---------------------------------------------------------------------------

REGIONS = ["chr1:1000-50000", "chr2", "chrX:150000", "chrX:1-1",
           "chr1:199999-300000", "chrY:1-100", "chr9"]


@pytest.mark.parametrize("kind", ["indexed", "bare"])
@pytest.mark.parametrize("region", REGIONS)
def test_indexed_scan_region_matches_jax(sessions, files, kind, region):
    sql = (f"SELECT chrom, pos, ref, qual FROM vcf_indexed_scan("
           f"'{files['plain_' + kind]}', '{region}')")
    got = _both(sessions, sql)
    if region.split(":")[0] in ("chrY", "chr9"):
        assert got.num_rows == 0  # declared without records, and absent


@pytest.mark.parametrize("kind", ["indexed", "bare"])
def test_region_file_matches_jax(sessions, files, kind):
    got = _both(sessions, f"SELECT chrom, pos, qual FROM vcf_indexed_scan("
                f"'{files['plain_' + kind]}', '{files['panel']}')")
    assert set(got.column("chrom").to_pylist()) == set(CONTIGS)


@pytest.mark.parametrize("kind", ["indexed", "bare"])
def test_marker_in_dataframe_and_sql_forms(sessions, files, kind):
    ts, js = sessions
    p = files["plain_" + kind]
    region = "chr2:5000-120000"
    sql = (f"SELECT pos, ref FROM vcf_scan('{p}') WHERE "
           f"vcf_region_filter('{region}', chrom, pos) AND qual > 100")
    got_sql = _both(sessions, sql)
    for mod, call, s in ((T, T.FunctionCall, ts), (J, JFunctionCall, js)):
        c = mod.col
        df = s.read_vcf(p).filter(call(
            "vcf_region_filter", [mod.lit(region), c("chrom"), c("pos")])
        ).filter(c("qual") > 100).select("pos", "ref")
        assert_tables_match(df.collect_arrow(), got_sql)


def test_count_star_with_region(sessions, files):
    for kind in ("indexed", "bare"):
        _both(sessions, "SELECT COUNT(*) AS n FROM vcf_indexed_scan("
              f"'{files['plain_' + kind]}', 'chr1:20000-80000')")


@pytest.mark.parametrize("region", ["chr1:500-100", "chr1:x-5", ":1-5"])
def test_malformed_region_raises(sessions, files, region):
    ts, js = sessions
    p = files["plain_indexed"]
    sql = f"SELECT pos FROM vcf_indexed_scan('{p}', '{region}')"
    with pytest.raises(InvalidRegionError):
        ts.sql(sql).collect_host()
    with pytest.raises(JInvalidRegion):
        js.sql(sql).collect_arrow()
    marker = (f"SELECT pos FROM vcf_scan('{p}') WHERE "
              f"vcf_region_filter('{region}', chrom, pos)")
    with pytest.raises(InvalidRegionError):
        ts.sql(marker).collect_host()
    with pytest.raises(JInvalidRegion):
        js.sql(marker).collect_arrow()


def test_indexed_table_without_region_raises(sessions, files):
    ts, js = sessions
    p = files["plain_indexed"]
    for s in (ts, js):
        s.sql(f"CREATE EXTERNAL TABLE idx STORED AS INDEXED_VCF "
              f"LOCATION '{p}'")
    with pytest.raises(InvalidRegionError, match="region filter"):
        ts.sql("SELECT pos FROM idx").collect_host()
    with pytest.raises(JInvalidRegion, match="region filter"):
        js.sql("SELECT pos FROM idx").collect_arrow()
    with pytest.raises(InvalidRegionError):
        ts.read_vcf(p, indexed=True).select("pos").collect_host()
    _both(sessions, "SELECT COUNT(*) AS n FROM idx WHERE "
          "vcf_region_filter('chrX', chrom, pos)")


def test_region_marker_outside_a_vcf_scan_raises_plan_error(sessions,
                                                            files):
    ts, _js = sessions
    df = ts.read_vcf(files["plain_bare"]).select(
        T.FunctionCall("vcf_region_filter",
                       [T.lit("chr1"), T.col("chrom"), T.col("pos")]))
    with pytest.raises(T.ExonError, match="should not be called"):
        df.collect_host()


# ---------------------------------------------------------------------------
# Query I (BASELINE config 3)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["indexed", "bare"])
@pytest.mark.parametrize("region", ["chr1:10000-150000", "panel"])
def test_query_i_matches_jax(sessions, files, kind, region):
    r = files["panel"] if region == "panel" else region
    got = _both(sessions, QUERY_I.format(p=files["plain_" + kind], r=r),
                var_cols=("sd_qual", "var_qual"), avg_cols=("mean_qual",))
    assert got.num_rows > 20


def test_query_i_dataframe_twin_plans_the_same_tree(sessions, files):
    ts, _js = sessions
    p, region = files["plain_indexed"], "chr1:10000-150000"
    c = T.col
    twin = (ts.read_vcf(p)
            .filter(T.FunctionCall("vcf_region_filter",
                                   [T.lit(region), c("chrom"), c("pos")]))
            .filter(c("qual") >= 30)
            .aggregate(["chrom", "ref"],
                       [T.count().alias("n"), T.avg(c("qual")).alias(
                           "mean_qual"),
                        T.AggregateCall("stddev", c("qual")).alias("sd_qual"),
                        T.AggregateCall("var_pop", c("qual")).alias(
                            "var_qual")]))
    sql = ts.sql(QUERY_I.format(p=p, r=region))

    def shape(plan):
        own = {k: v for k, v in vars(plan).items()
               if k not in ("input", "source", "out_schema")}
        return (type(plan).__name__, repr(own),
                [shape(k) for k in plan.children()])

    tp = twin._execute(twin.logical_plan())
    sp = sql._execute(sql.logical_plan())
    assert shape(tp) == shape(sp)
    assert isinstance(sp, TP.AggregateExec) and sp.pre_filter is not None
    assert isinstance(sp.input, TP.ScanExec)
    assert_tables_match(twin.collect_arrow(), sql.collect_arrow())


def test_query_i_on_the_fixture_matches_numpy(sessions, tmp_path):
    """The benchlib fixture through Query I, against numpy over its
    arrays: counts exact, groups in first-seen order."""
    ts, _js = sessions
    n = 40_000
    p = vcf_fixture.make_vcf(n, 5, path=str(tmp_path / "g.vcf.gz"))
    r = vcf_fixture.vcf_records(n, 5)
    got = ts.sql(QUERY_I.format(p=p, r="chr2:1-30000000")).collect_host()
    chr2 = vcf_fixture.SEQNAMES.index("chr2")
    keep = ((r["chrom"] == chr2) & (r["pos"] <= 30_000_000)
            & r["qual_valid"] & (r["qual"] >= 30))
    refs = [bytes(r["ref_values"][r["ref_offsets"][i]:r["ref_offsets"][i + 1]])
            for i in np.flatnonzero(keep)]
    groups: dict = {}
    for ref, q in zip(refs, r["qual"][keep]):
        groups.setdefault(ref, []).append(float(q))
    col = got.column("ref")
    names = [bytes(col.values[col.offsets[i]:col.offsets[i + 1]])
             for i in range(got.length)]
    assert names == list(groups)
    assert got.column("n").values.tolist() == [len(v) for v in
                                               groups.values()]
    want = [np.var(v, ddof=0) for v in groups.values()]
    np.testing.assert_allclose(got.column("var_qual").values, want,
                               rtol=VAR_RTOL)


# ---------------------------------------------------------------------------
# the fixture's index
# ---------------------------------------------------------------------------


def test_fixture_index_answers_as_build_tabix_vcf(tmp_path):
    p = vcf_fixture.make_vcf(30_000, 3, path=str(tmp_path / "f.vcf.gz"))
    with open(p, "rb") as f:
        data = f.read()
    with open(p + ".tbi", "rb") as f:
        mine = parse_tabix(f.read())
    ref = jparse_tabix(build_tabix_vcf(data))
    assert mine.names == ref.names
    rng = np.random.default_rng(0)
    regions = [f"{c}:{s}-{s + w}" for c in ("chr1", "chr7", "chrM", "chrY")
               for s, w in zip(rng.integers(1, 240_000_000, 6),
                               (1, 100, 20_000, 3_000_000, 50_000_000,
                                248_000_000))]
    regions += ["chr1", "chr22:1", "chrQ:1-100"]
    for reg in regions:
        got = [(c.vstart, c.vend) for c in mine.query(Region.parse(reg))]
        want = [(c.vstart, c.vend) for c in ref.query(JRegion.parse(reg))]
        assert got == want, reg


# ---------------------------------------------------------------------------
# F15: the JAX indexed path reads overlapping regions twice and decodes a
# chunk without the file's header
# ---------------------------------------------------------------------------


def test_f15_overlapping_regions_are_read_once(sessions, files, tmp_path):
    ts, js = sessions
    panel = tmp_path / "overlap.txt"
    panel.write_text("chr1:1000-60000\nchr1:40000-90000\n")
    sql = ("SELECT pos FROM vcf_indexed_scan('{p}', '" + str(panel) + "')")
    bare = ts.sql(sql.format(p=files["plain_bare"])).collect_arrow()
    got = ts.sql(sql.format(p=files["plain_indexed"])).collect_arrow()
    want = js.sql(sql.format(p=files["plain_indexed"])).collect_arrow()
    # the port: each row once, as the scan without an index and the JAX
    # package's own unindexed path give it
    assert sorted(got.column("pos").to_pylist()) == \
        sorted(bare.column("pos").to_pylist())
    assert_tables_match(bare, js.sql(sql.format(
        p=files["plain_bare"])).collect_arrow())
    # the JAX package: the rows of the overlap twice
    overlap = sum(40000 <= p <= 60000 for p in got.column("pos").to_pylist())
    assert overlap > 0
    assert want.num_rows == got.num_rows + overlap


def test_f15_indexed_chunks_decode_with_the_header(sessions, files):
    ts, js = sessions
    sql = ("SELECT pos, info FROM vcf_indexed_scan('{p}', 'chr2')")
    got = ts.sql(sql.format(p=files["samples_indexed"])).collect_arrow()
    bare = js.sql(sql.format(p=files["samples_bare"])).collect_arrow()
    want = js.sql(sql.format(p=files["samples_indexed"])).collect_arrow()
    # the port's indexed rows equal either package's unindexed ones
    assert_tables_match(got, bare)
    # the JAX package splits a chunk by an empty header: INFO runs on
    # into the FORMAT and sample columns
    info = [v for v in want.column("info").to_pylist() if v is not None]
    assert info and all("\tGT:DP\t" in v for v in info)
