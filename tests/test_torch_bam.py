"""BAM decode in exon_tpu_torch against exon_tpu and against the fixture's
own arrays: every ported column, batch boundaries, NULLs, CIGARs with
several operations, and the BGZF reader. Tolerance: exact."""

import gzip
import struct
import zlib

import numpy as np
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


def _record(name: bytes, flag: int, ref: int, pos0: int, mapq: int,
            cigar: list, seq: str, mate_ref: int) -> bytes:
    l_name = len(name) + 1
    cig = b"".join(struct.pack("<I", n << 4 | OPS.index(op))
                   for n, op in cigar)
    codes = [("=ACMGRSVTWYHKDBN".index(b)) for b in seq] + [0]
    packed = bytes(codes[i] << 4 | codes[i + 1]
                   for i in range(0, len(seq), 2))
    body = struct.pack("<iiBBHHHiiii", ref, pos0, l_name, mapq, 4680,
                       len(cigar), flag, len(seq), mate_ref, pos0, 0)
    body += name + b"\0" + cig + packed + bytes([30] * len(seq))
    return struct.pack("<i", len(body)) + body


def _varied_bam(path, n=700, seed=4) -> str:
    """Records with multi-op CIGARs, unmapped reads, '*' names, MAPQ 255,
    empty sequences and unmapped mates, gzip-compressed as one member."""
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
            -1 if i % 5 == 0 else (i + 1) % 3))
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
def test_bam_list_columns_raise(tmp_path, column):
    path = make_bam(50, seed=1, path=str(tmp_path / "p.bam"))
    df = T.ExonSession(device="cpu").read_bam(path)
    with pytest.raises(NotImplementedError, match="item 2"):
        df.select(column).collect_arrow()
