"""FASTA and FASTQ decode on the device (exon_tpu_torch.formats.fasta_device,
formats.fastq.decode_device, ops.device_text) against the JAX package's
device decoders (exon_tpu.formats.fasta_device.decode_fasta_device,
exon_tpu.formats.fastq.decode_device) on CPU JAX, with the port on
``device="cpu"``, where the line_index, text_records and gather_spans twins
run. Each twin is also held to the JAX functions it replaces, and the whole
slice (Query A, the FASTQ adapter screen) to ``exon_tpu.ExonSession`` on its
default (device decode) path. Tolerance: exact equality of Arrow values,
types, nulls and order."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.fastq_fixture import adapter_rows, fastq_reads, make_fastq
from exon_tpu.formats import fasta as jfasta
from exon_tpu.formats import fasta_device as jfasta_device
from exon_tpu.formats import fastq as jfastq
from exon_tpu.ops import device_text as jdt
from exon_tpu.plan.expressions import FunctionCall as JFunctionCall
from exon_tpu_torch.errors import InvalidSequenceError
from exon_tpu_torch.formats import fasta, fasta_device, fastq
from exon_tpu_torch.kernels.gather_spans import gather_spans_plain
from exon_tpu_torch.kernels.line_index import line_index_plain
from exon_tpu_torch.kernels.text_records import text_records_plain
from exon_tpu_torch.plan.physical import ScanExec

FASTA_CASES = [  # tests/test_device_decode.py:12-19
    b">a desc here\nACGT\nACGT\n>b\nTTTT\n",
    b">only one\nAC\n",
    b">x\nACGT",
    b">a\nAC\n>b two words here\nGG\n>c\nTT\n",
    b">crlf test\r\nACGT\r\n>b\r\nGG\r\n",
    b">empty seq\n>next\nAA\n",
]
FASTQ_CASES = [
    b"@r1 d\r\nACGT\r\n+\r\nIIII\r\n@r2\r\nTT\r\n+\r\n!!\r\n",  # test_formats_misc.py:144
    b"@r1 one two\nACGT\n+r1\nIIII\n@r2\n\n+\n\n@@r3 \nA\n+\n@\n",
    b"@x\nAC GT\n+\nI@ I\n",  # no trailing newline on the last line
]
FASTA_PROJECTIONS = [None, ["sequence"], ["id"], ["description", "id"],
                     ["id", "sequence"]]
FASTQ_PROJECTIONS = [None, ["sequence"], ["name", "quality_scores"],
                     ["description"], ["quality_scores", "sequence", "name"]]


def _table(batches) -> pa.Table:
    return pa.Table.from_batches([b.to_arrow() for b in batches])


def _assert_same(got: pa.Table, want: pa.Table):
    assert got.schema == want.schema
    assert got.to_pydict() == want.to_pydict()


def _port_fasta(data, projection=None, **kw):
    return _table(fasta_device.decode_fasta_device(
        data, fasta.FastaOptions(), projection, "cpu", **kw))


def _jax_fasta(data, projection=None):
    return _table(jfasta_device.decode_fasta_device(
        data, jfasta.FastaOptions(), projection))


def _port_fastq(data, projection=None, **kw):
    return _table(fastq.decode_device(data, fastq.FastqOptions(), projection,
                                      "cpu", **kw))


def _jax_fastq(data, projection=None):
    return _table(jfastq.decode_device(data, jfastq.FastqOptions(),
                                       projection))


@pytest.mark.parametrize("projection", FASTA_PROJECTIONS)
@pytest.mark.parametrize("data", FASTA_CASES)
def test_fasta_device_decode_matches_jax(data, projection):
    _assert_same(_port_fasta(data, projection), _jax_fasta(data, projection))


@pytest.mark.parametrize("projection", FASTQ_PROJECTIONS)
@pytest.mark.parametrize("data", FASTQ_CASES)
def test_fastq_device_decode_matches_jax(data, projection):
    _assert_same(_port_fastq(data, projection), _jax_fastq(data, projection))


def _random_line(rng, alphabet: bytes, longest: int) -> bytes:
    a = np.frombuffer(alphabet, np.uint8)
    return a[rng.integers(0, len(a), rng.integers(0, longest + 1))].tobytes()


def _random_fasta(rng) -> bytes:
    eol = b"\r\n" if rng.random() < 0.3 else b"\n"
    parts = [b"\r\n\n"] if rng.random() < 0.1 else []  # blank, no body byte
    for _ in range(rng.integers(1, 12)):
        parts.append(b">" + _random_line(rng, b"ab> \r\t1", 12) + eol)
        for _ in range(rng.integers(0, 4)):
            parts.append(_random_line(rng, b"ACGTNacgt -*\r>", 20) + eol)
    text = b"".join(parts)
    return text[:-len(eol)] if rng.random() < 0.3 else text


def _random_fastq(rng) -> bytes:
    eol = b"\r\n" if rng.random() < 0.3 else b"\n"
    parts = []
    for _ in range(rng.integers(1, 10)):
        parts += [b"@" + _random_line(rng, b"ab@ :\r12", 10),
                  _random_line(rng, b"ACGTN \r", 12),
                  b"+" + _random_line(rng, b"ab", 2),
                  _random_line(rng, b"!#@+IJ \r", 12)]
    text = eol.join(parts)
    # an empty last line needs its newline to count as a line
    return text if parts[-1] and rng.random() < 0.3 else text + eol


@pytest.mark.parametrize("seed", range(4))
def test_random_fasta_texts_match_jax(seed):
    rng = np.random.default_rng([seed, 1])
    for _ in range(50):
        data = _random_fasta(rng)
        _assert_same(_port_fasta(data), _jax_fasta(data))
        _assert_same(_port_fasta(data, max_chunk=int(rng.integers(8, 64))),
                     _jax_fasta(data))


@pytest.mark.parametrize("seed", range(4))
def test_random_fastq_texts_match_jax(seed):
    rng = np.random.default_rng([seed, 2])
    for _ in range(50):
        data = _random_fastq(rng)
        _assert_same(_port_fastq(data), _jax_fastq(data))
        _assert_same(_port_fastq(data, max_chunk=int(rng.integers(8, 64))),
                     _jax_fastq(data))


def test_tiny_max_chunk_keeps_rows_and_order():
    fa = b"".join(b">r%d d%d\nACGT%d\nGG\n" % (i, i, i % 10) for i in range(40))
    batches = list(fasta_device.decode_fasta_device(
        fa, fasta.FastaOptions(), None, "cpu", max_chunk=32))
    assert len(batches) > 10
    _assert_same(_table(batches), _jax_fasta(fa))
    fq = b"".join(b"@q%d x\nAC%d\n+\nII%d\n" % (i, i, i) for i in range(40))
    batches = list(fastq.decode_device(fq, fastq.FastqOptions(), None, "cpu",
                                       max_chunk=20))
    assert len(batches) == 40  # every record is longer than a chunk
    _assert_same(_table(batches), _jax_fastq(fq))
    batches = list(fastq.decode_device(fq, fastq.FastqOptions(), None, "cpu",
                                       max_chunk=100))
    assert 5 < len(batches) < 40
    _assert_same(_table(batches), _jax_fastq(fq))


def test_device_path_is_followed_where_the_host_path_differs():
    # FASTA: the device name drops every '>' and '\r'; the host keeps them
    data = b">a>b\rc x\ry\nAC\rGT\n"
    got = _port_fasta(data)
    _assert_same(got, _jax_fasta(data))
    assert got.to_pydict() == {"id": ["abc"], "description": ["xy"],
                               "sequence": ["ACGT"]}
    host = next(fasta.decode_host(data, fasta.FastaOptions()))
    assert bytes(host.column("id").values) == b"a>b\rc"
    # FASTQ: a '\r' inside a sequence or quality line is dropped
    data = b"@r1\nAC\rGT\n+\nII\rII\n"
    got = _port_fastq(data, ["sequence", "quality_scores"])
    _assert_same(got, _jax_fastq(data, ["sequence", "quality_scores"]))
    assert got.to_pydict() == {"sequence": ["ACGT"],
                               "quality_scores": ["IIII"]}
    host = next(fastq.decode_host(data, fastq.FastqOptions(), ["sequence"]))
    assert bytes(host.column("sequence").values) == b"AC\rGT"


@pytest.mark.parametrize("data", [
    b"junk\n>a\nAC\n",   # sequence bytes before the first header
    b"ACGT\nAC\n",       # no header at all
    b"\n\r\n",           # no header at all, only blank lines
])
def test_fasta_f7_cases_raise(data):
    with pytest.raises(InvalidSequenceError):
        list(fasta_device.decode_fasta_device(data, fasta.FastaOptions()))
    with pytest.raises(InvalidSequenceError):
        list(fasta.decode_host(data, fasta.FastaOptions()))


@pytest.mark.parametrize("data", [
    b"@r1\nAC\n+\nII\n@r2\nAC\n",  # trailing partial record
    b"@r1\nAC\n",                  # a partial record alone
    b"r1\nAC\n+\nII\n",            # header without '@'
    b"@r1\nAC\n+\nII\n\n",         # trailing blank line (the JAX device path)
])
def test_fastq_f7_cases_raise(data):
    with pytest.raises(InvalidSequenceError):
        list(fastq.decode_device(data, fastq.FastqOptions()))
    with pytest.raises(InvalidSequenceError):
        list(fastq.decode_device(data, fastq.FastqOptions(), max_chunk=8))


def test_empty_buffers_yield_nothing():
    assert list(fasta_device.decode_fasta_device(b"", fasta.FastaOptions())) == []
    assert list(fastq.decode_device(b"", fastq.FastqOptions())) == []


# ---------------------------------------------------------------------------
# Twins against the JAX functions they replace
# ---------------------------------------------------------------------------


def _padded(data: bytes):
    """The JAX decoders' padded device buffer: (jnp array, length)."""
    cap = max(1024, 1 << (len(data) - 1).bit_length())
    arr = np.full(cap, 10, np.uint8)
    arr[:len(data)] = np.frombuffer(data, np.uint8)
    return jnp.asarray(arr), len(data)


def _port_lines(data: bytes, fastq_mode: bool):
    chunk = torch.from_numpy(np.frombuffer(data, np.uint8).copy())
    nl = line_index_plain(chunk)
    n_lines = nl.shape[0] + int(bool(data) and data[-1:] != b"\n")
    return chunk, nl, text_records_plain(chunk, nl, n_lines, fastq_mode, True)


def _per_line(mask, line_id, n_lines):
    return np.bincount(line_id[mask], minlength=n_lines)


@pytest.mark.parametrize("seed", range(3))
def test_line_index_twin_matches_line_starts_mask(seed):
    rng = np.random.default_rng([seed, 3])
    for data in [_random_fasta(rng) for _ in range(20)] + FASTA_CASES:
        arr, n = _padded(data)
        want = np.flatnonzero(np.asarray(jdt.line_starts_mask(arr, n)))
        _c, _nl, lines = _port_lines(data, False)
        assert lines.start.tolist() == want.tolist()


@pytest.mark.parametrize("seed", range(3))
def test_text_records_twin_matches_jax_fasta_masks(seed):
    rng = np.random.default_rng([seed, 4])
    for data in [_random_fasta(rng) for _ in range(20)] + FASTA_CASES:
        arr, n = _padded(data)
        a = np.asarray(arr)
        is_hdr, _rec, in_hdr = (np.asarray(x) for x in
                                jdt.record_structure(arr, n, ord(">")))
        ls = np.asarray(jdt.line_starts_mask(arr, n))
        line_id = np.cumsum(ls) - 1
        pos = np.arange(len(a))
        live = pos < n
        first_sp = np.asarray(jdt.first_match_in_segment(
            jnp.asarray((a == 32) & in_hdr), jnp.asarray(is_hdr)))
        _c, _nl, lines = _port_lines(data, False)
        L = lines.start.shape[0]
        body = live & (a != 10) & (a != 13) & ~in_hdr
        name = in_hdr & (a != ord(">")) & (pos < first_sp) & (a != 13)
        desc = in_hdr & (pos > first_sp) & (a != 13)
        starts = lines.start.numpy()
        assert lines.is_hdr.tolist() == is_hdr[starts].tolist()
        assert lines.body.tolist() == _per_line(body, line_id, L).tolist()
        assert lines.name_len.tolist() == _per_line(name, line_id, L).tolist()
        assert lines.desc_len.tolist() == _per_line(desc, line_id, L).tolist()
        hdr = lines.is_hdr.numpy()
        ends = lines.end.numpy()[hdr]
        sp = first_sp[ends - 1]  # the JAX value holds past the first space
        assert lines.split.numpy()[hdr].tolist() == \
            np.where(sp >= 2 ** 30, ends, sp).tolist()
        assert int(lines.bad) == 0


@pytest.mark.parametrize("seed", range(3))
def test_text_records_twin_matches_jax_fastq_masks(seed):
    rng = np.random.default_rng([seed, 5])
    datas = [_random_fastq(rng) for _ in range(20)] + FASTQ_CASES + \
        [b"x1\nA\n+\nI\n@r\nA\n+\nI\n"]
    for data in datas:
        # the masks of exon_tpu/formats/fastq.py _device_decode (:107-147)
        arr, n = _padded(data)
        a = np.asarray(arr)
        pos = np.arange(len(a))
        ls = np.asarray(jdt.line_starts_mask(arr, n))
        line_id = np.cumsum(ls) - 1
        role = line_id % 4
        body = (pos < n) & (a != 10) & (a != 13)
        in_hdr = body & (role == 0)
        hdr_start = ls & (role == 0)
        first_sp = np.asarray(jdt.first_match_in_segment(
            jnp.asarray((a == 32) & in_hdr), jnp.asarray(hdr_start)))
        _c, _nl, lines = _port_lines(data, True)
        L = lines.start.shape[0]
        name = in_hdr & ~hdr_start & (pos < first_sp)
        desc = in_hdr & (pos > first_sp)
        hdr = lines.is_hdr.numpy()
        assert hdr.tolist() == (np.arange(L) % 4 == 0).tolist()
        assert lines.body.numpy()[~hdr].tolist() == \
            _per_line(body & (role != 0), line_id, L)[~hdr].tolist()
        assert lines.name_len.tolist() == _per_line(name, line_id, L).tolist()
        assert lines.desc_len.tolist() == _per_line(desc, line_id, L).tolist()
        assert int(lines.bad) == int((hdr_start & (a != ord("@"))).sum())


@pytest.mark.parametrize("seed", range(3))
def test_gather_spans_twin_matches_jax_compact(seed):
    rng = np.random.default_rng([seed, 6])
    for data in [_random_fasta(rng) for _ in range(20)] + FASTA_CASES:
        arr, n = _padded(data)
        a = np.asarray(arr)
        pos = np.arange(len(a))
        is_hdr, _rec, in_hdr = jdt.record_structure(arr, n, ord(">"))
        in_hdr_np = np.asarray(in_hdr)
        first_sp = np.asarray(jdt.first_match_in_segment(
            jnp.asarray((a == 32) & in_hdr_np), is_hdr))
        keep_seq = (pos < n) & (a != 10) & (a != 13) & ~in_hdr_np
        keep_name = in_hdr_np & (a != ord(">")) & (pos < first_sp) & (a != 13)
        chunk, _nl, lines = _port_lines(data, False)
        for keep, starts, stops, lens, drop in (
                (keep_seq, lines.start,
                 torch.where(lines.is_hdr, lines.start, lines.end),
                 lines.body, (13,)),
                (keep_name, lines.start + 1,
                 torch.where(lines.is_hdr,
                             torch.maximum(lines.split, lines.start + 1),
                             lines.start + 1), lines.name_len,
                 (13, ord(">")))):
            total = int(keep.sum())
            want, _ = jdt.compact(arr, jnp.asarray(keep), len(a))
            dst = (torch.cumsum(lens, 0) - lens).to(torch.int32)
            got = gather_spans_plain(chunk, starts.to(torch.int32),
                                     stops.to(torch.int32), dst, total, drop)
            assert bytes(got.numpy()) == bytes(np.asarray(want)[:total])


# ---------------------------------------------------------------------------
# The slice through the sessions, device decode on both sides
# ---------------------------------------------------------------------------


@pytest.fixture
def device_decode(monkeypatch):
    monkeypatch.delenv("EXON_TPU_HOST_DECODE", raising=False)


def _scans(df):
    plan, stack, out = df._execute(df.logical_plan()), [], []
    stack.append(plan)
    while stack:
        p = stack.pop()
        if isinstance(p, ScanExec):
            out.append(p)
        stack.extend(p.children())
    return out


def test_scan_decodes_on_the_device_unless_told(tmp_path, monkeypatch,
                                                device_decode):
    path = tmp_path / "a.fasta"
    path.write_bytes(FASTA_CASES[0])
    s = T.ExonSession(device="cpu")
    assert [sc.to_device for sc in _scans(s.read_fasta(str(path)))] == [False]
    monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    assert [sc.to_device for sc in _scans(s.read_fasta(str(path)))] == [True]
    assert s.read_fasta(str(path)).collect_host().length == 2


def test_read_fastq_adapter_screen_matches_jax(tmp_path, device_decode):
    path = make_fastq(3000, seed=5, path=str(tmp_path / "reads.fastq"))
    ts = T.ExonSession(device="cpu", device_batch_size=500)
    js = J.ExonSession.new_exon()

    def query(mod, s):
        return s.read_fastq(path).filter(
            mod.col("sequence").like("%AGATCGGAAGAGC%"))

    got = query(T, ts).select("name", "sequence",
                              "quality_scores").collect_arrow()
    want = query(J, js).select("name", "sequence",
                               "quality_scores").collect_arrow()
    _assert_same(got, want)
    n = len(adapter_rows(fastq_reads(3000, seed=5)))
    assert got.num_rows == n > 100
    assert query(T, ts).count() == query(J, js).count() == n
    _assert_same(ts.read_fastq(path).collect_arrow(),
                 js.read_fastq(path).collect_arrow())


def _write_fasta(path, n=900, seed=3):
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


def test_query_a_on_device_decode_matches_jax(tmp_path, device_decode):
    path = _write_fasta(tmp_path / "a.fasta")
    ts = T.ExonSession(device="cpu", device_batch_size=400)
    js = J.ExonSession.new_exon()

    def pred(mod, func):
        return (func("length", [mod.col("sequence")]) > 300) & \
            mod.col("sequence").like("%KK%")

    got = ts.read_fasta(path).filter(pred(T, T.FunctionCall)).select(
        "id", "sequence").collect_arrow()
    want = js.read_fasta(path).filter(pred(J, JFunctionCall)).select(
        "id", "sequence").collect_arrow()
    assert got.num_rows > 0
    _assert_same(got, want)
    assert ts.read_fasta(path).filter(pred(T, T.FunctionCall)).count() == \
        js.read_fasta(path).filter(pred(J, JFunctionCall)).count()
    assert ts.read_fasta(path).count() == js.read_fasta(path).count() == 900
    _assert_same(ts.read_fasta(path).collect_arrow(),
                 js.read_fasta(path).collect_arrow())
