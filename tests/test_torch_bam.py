"""BAM decode in exon_tpu_torch against exon_tpu and against the fixture's
own arrays: every column (quality_score as List<Int64>, tags as a list of
{tag, value} or with parse_tags a struct of the first record's tags), batch
boundaries, NULLs, CIGARs with several operations, aux tags of every type
(A, c, C, s, S, i, I, f, Z, H, B of ints and floats), and the BGZF reader.
Tolerance: exact."""

import gzip
import struct
import zlib

import numpy as np
import pyarrow as pa
import pytest

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.bam_fixture import bam_reads, make_bam
from benchlib.fixtures import _bam_header
from exon_tpu_torch.io import bgzf_decompress

BATCH = 300
COLUMNS = ["name", "flag", "reference", "start", "end", "mapping_quality",
           "cigar", "mate_reference", "sequence"]
OPS = "MIDNSHP=X"


@pytest.fixture
def sessions(monkeypatch):
    monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    return T.ExonSession(device="cpu", device_batch_size=BATCH), js


def _aux(rng, i: int) -> bytes:
    """A record's aux tags: a varying set of every BAM tag type."""
    tags = [b"NMC" + bytes([i % 7]), b"ASs" + struct.pack("<h", -i),
            b"XII" + struct.pack("<I", 3_000_000_000 + i),
            b"XSZread%d\0" % i]
    if i % 2:
        tags.append(b"XFf" + struct.pack("<f", i / 7))
    if i % 3 == 0:
        tags.append(b"RGAZ")
    if i % 4 == 0:
        vals = rng.integers(-5, 5, 3)
        tags.append(b"XBBc" + struct.pack("<I", 3) +
                    struct.pack("<3b", *vals.tolist()))
    if i % 5 == 0:
        tags.append(b"XGBf" + struct.pack("<I", 2) +
                    struct.pack("<2f", 0.5, i / 3))
    if i % 6 == 0:
        tags.append(b"XHH1AE3\0" + b"XCc" + struct.pack("<b", -3))
    return b"".join(tags)


def _record(name: bytes, flag: int, ref: int, pos0: int, mapq: int,
            cigar: list, seq: str, mate_ref: int, aux: bytes = b"") -> bytes:
    l_name = len(name) + 1
    cig = b"".join(struct.pack("<I", n << 4 | OPS.index(op))
                   for n, op in cigar)
    codes = [("=ACMGRSVTWYHKDBN".index(b)) for b in seq] + [0]
    packed = bytes(codes[i] << 4 | codes[i + 1]
                   for i in range(0, len(seq), 2))
    body = struct.pack("<iiBBHHHiiii", ref, pos0, l_name, mapq, 4680,
                       len(cigar), flag, len(seq), mate_ref, pos0, 0)
    body += name + b"\0" + cig + packed + \
        bytes([30 + k % 11 for k in range(len(seq))]) + aux
    return struct.pack("<i", len(body)) + body


def _varied_bam(path, n=700, seed=4, tags=False) -> str:
    """Records with multi-op CIGARs, unmapped reads, '*' names, MAPQ 255,
    empty sequences and unmapped mates (with ``tags``, aux tags of every
    type), gzip-compressed as one member."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        cigar = [(int(rng.integers(1, 60)), OPS[int(k)])
                 for k in rng.integers(0, 9, rng.integers(1, 5))]
        seq = "".join(rng.choice(list("ACGTN"), rng.integers(0, 40)))
        unmapped = i % 17 == 0
        recs.append(_record(
            b"" if i % 23 == 0 else b"read%d:%d" % (i, rng.integers(1e6)),
            int(rng.integers(0, 4096)), -1 if unmapped else i % 3,
            -1 if unmapped else int(rng.integers(0, 10**6)),
            255 if i % 11 == 0 else int(rng.integers(0, 61)), cigar, seq,
            -1 if i % 5 == 0 else (i + 1) % 3,
            _aux(rng, i) if tags else b""))
    data = _bam_header(["chr1", "chr2", "chrX"], [10**7] * 3) + b"".join(recs)
    with open(path, "wb") as f:
        f.write(gzip.compress(data))
    return str(path)


def _assert_equal(got, want):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert got.column(name).to_pylist() == \
            want.column(name).to_pylist(), name


@pytest.mark.parametrize("kind", ["fixture", "varied"])
def test_bam_decode_matches_jax(tmp_path, sessions, kind):
    ts, js = sessions
    path = make_bam(400, seed=3, path=str(tmp_path / "p.bam")) \
        if kind == "fixture" else _varied_bam(tmp_path / "v.bam")
    got = ts.read_bam(path).select(*COLUMNS).collect_arrow()
    want = js.read_bam(path).select(*COLUMNS).collect_arrow()
    assert got.num_rows > BATCH
    _assert_equal(got, want)


def test_bam_projection_and_count_match_jax(tmp_path, sessions):
    ts, js = sessions
    path = _varied_bam(tmp_path / "v.bam")
    c = T.col
    got = ts.read_bam(path).filter(c("start") > 1000).select(
        "end", "name").collect_arrow()
    want = js.read_bam(path).filter(J.col("start") > 1000).select(
        "end", "name").collect_arrow()
    _assert_equal(got, want)
    assert ts.read_bam(path).count() == js.read_bam(path).count() == 700


def test_bam_fixture_matches_its_arrays(tmp_path):
    path = make_bam(1000, seed=9, path=str(tmp_path / "p.bam"))
    r = bam_reads(1000, seed=9)
    host = T.ExonSession(device="cpu", device_batch_size=BATCH).read_bam(
        path).select("name", "reference", "start", "end", "flag",
                     "cigar").collect_host()
    assert host.length == len(r["start"]) == 1990  # 10 orphans
    names = host.column("name")
    assert names.values.tobytes() == b"".join(r["names"][r["template"]])
    ref = host.column("reference")
    assert ref.validity.all()
    assert [ref.vocab[k] for k in ref.codes[:5]] == \
        [f"chr{k + 1}" if k < 22 else ("chrX", "chrY", "chrM")[k - 22]
         for k in r["reference"][:5]]
    for name in ("start", "end", "flag"):
        assert np.array_equal(host.column(name).values, r[name]), name
    assert (np.diff(r["reference"] * 10**9 + r["start"]) >= 0).all()
    # 7-digit template numbers at full scale make these 36-39 bytes
    assert set(np.char.str_len(r["names"])) <= set(range(30, 40))
    assert host.column("cigar").values.tobytes() == b"100M" * host.length


def test_bgzf_reader_matches_gzip(tmp_path):
    path = make_bam(12_000, seed=2, path=str(tmp_path / "p.bam"))
    raw = open(path, "rb").read()
    want = gzip.decompress(raw)
    assert len(want) > 64 * 0xFF00  # many blocks, spread over the pool
    assert bgzf_decompress(raw) == want
    plain = zlib.compress(b"not bgzf " * 1000)
    assert bgzf_decompress(gzip.compress(plain)) == plain


@pytest.mark.parametrize("column", ["quality_score", "tags"])
def test_bam_list_columns_raise(tmp_path, sessions, column):
    """Since item 2b + 3, quality_score (List<Int64>) and tags
    (List<Struct{tag, value}>) are ported: the JAX package's answer through
    a scan, a filter and a sort, over the fixture and over tagged records
    of every aux type."""
    ts, js = sessions
    for path in (make_bam(50, seed=1, path=str(tmp_path / "p.bam")),
                 _varied_bam(tmp_path / "t.bam", n=400, tags=True)):
        got = ts.read_bam(path).filter(T.col("flag") >= 0).select(
            "name", column).collect_arrow()
        want = js.read_bam(path).filter(J.col("flag") >= 0).select(
            "name", column).collect_arrow()
        _assert_equal(got, want)
        sql = (f"SELECT start, {column} FROM bam_scan('{path}') WHERE "
               "start > 1000 ORDER BY start, name")
        _assert_equal(ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow())


@pytest.mark.parametrize("batch", [64, 1000])
def test_bam_parse_tags_struct_matches_jax(tmp_path, batch):
    """parse_tags: tags as a struct of the first record's tags (ints of
    every width and A as int64, f as float32, Z/H as text, B arrays as
    lists), decoded by both packages and read through a session."""
    from exon_tpu.formats import bam as jbam
    from exon_tpu_torch.formats import bam as tbam

    path = _varied_bam(tmp_path / "t.bam", n=300, tags=True)
    data = tbam.inflate(open(path, "rb").read())
    got = list(tbam.decode_host(data, tbam.BamOptions(batch_size=batch,
                                                      parse_tags=True)))
    want = list(jbam.decode_host(data, jbam.BamOptions(batch_size=batch,
                                                       parse_tags=True)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.schema.field("tags").dtype.kind.value == "struct"
        _assert_equal(g.to_arrow(), w.to_arrow())
    df = T.ExonSession(device="cpu").read_bam(path, parse_tags=True)
    assert [f.name for f in df.schema().field("tags").dtype.children] == \
        ["NM", "AS", "XI", "XS", "RG", "XB", "XG", "XH", "XC"]
    _assert_equal(df.select("tags").collect_arrow(), pa.Table.from_batches(
        [w.project(["tags"]).to_arrow() for w in want]))


def test_f27_parse_tags_without_tags(tmp_path):
    """F27: with parse_tags on a BAM whose first record has no tags, the
    tags struct has no fields. The port exports one empty struct a row; the
    JAX export of the struct has no rows, and its batch fails to build."""
    from exon_tpu.formats import bam as jbam
    from exon_tpu_torch.formats import bam as tbam

    path = make_bam(20, seed=1, path=str(tmp_path / "p.bam"))
    data = tbam.inflate(open(path, "rb").read())
    (got,) = tbam.decode_host(data, tbam.BamOptions(parse_tags=True))
    assert got.to_arrow().column("tags").to_pylist() == [{}] * 40
    (want,) = jbam.decode_host(data, jbam.BamOptions(parse_tags=True))
    with pytest.raises(ValueError, match="same length"):
        want.to_arrow()
