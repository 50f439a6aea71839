"""The twins of map_bytes' mirror and word-start modes (K11
reverse_complement, K12 reverse and initcap) and of its widen mode (K11b
integer_encode_dna, quality_score_string_to_list, integer_encoding and the
FASTA encodings) held to exon_tpu at the shapes their Hopper kernels'
designs must survive; test_torch_kernels.py holds the kernels to the twins
on the same cases on a card.

The mirror kernel gives 8 lanes to a row: its aligned 16-byte words one
load each, reversed, and the bytes of its partial first and last words
(which two rows can share) one by one. The word-start kernel maps 16-byte
output words flat, with the row starts that fall in each word as a mask.
Both write the bytes outside the rows as zeros in the same launch. Widen
to int8 maps 16 bytes a thread. So the cases (``map_case``) are: rows of 0, 1,
15-17, 31-33, 255-257 and 511-513 bytes; a 64 KB row of every byte value
among 150-byte rows; runs of 1-3-byte rows that share a word; row starts
at every offset mod 16; a separator (space, digit, punctuation, a byte
>= 128) at each byte of a word, and rows that follow a row ending in an
alphanumeric byte; offsets past 0 with alphanumeric bytes just before the
first row and slack after the last; rows of every byte value; n of 1 and
0. The port's values are views at an odd offset of their storage.

A row's own bytes must equal exon_tpu's, and the port's bytes outside
every row are 0. exon_tpu's fn_initcap marks a row start at
min(offsets[i], capacity - 1), so an empty last row that ends the buffer
upper-cases the byte before it, the last byte of the row before (F41):
there both answers are asserted. Also: the SQL functions through both
``ExonSession.sql``s over a small FASTQ and FASTA (reverse_complement,
reverse, initcap, integer_encode_dna, the quality string to a list and
back, integer_encoding), both packages' FASTA integer encodings, and the
per-device tables that the callers copy to the card once. Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
from exon_tpu import udfs as JU
from exon_tpu.batch import VarColumn as JVar
from exon_tpu.ops import sqlfuncs as JS
import exon_tpu_torch as T
from exon_tpu_torch import udfs as TU
from exon_tpu_torch.batch import VarColumn
from exon_tpu_torch.formats import fasta_device
from exon_tpu_torch.kernels import map_bytes as kmb
from exon_tpu_torch.ops import sqlfuncs as TS
from exon_tpu_torch.ops import strings as tstrings
from test_torch_kernels import MAP_CASES, map_case, map_tables

ALPHABETS = ("ACGT", "ACGTA", "Hello", "")


def _columns(name: str):
    """The case as a port VarColumn (values a view 3 bytes into their
    storage) and a JAX one, every fifth row NULL, with its numpy
    (offsets, values) and rows."""
    offs, vals, rows = map_case(name)
    valid = np.arange(len(rows)) % 5 != 2
    storage = torch.zeros(vals.shape[0] + 3, dtype=torch.uint8)
    storage[3:] = torch.from_numpy(vals)
    t = VarColumn(storage[3:], torch.from_numpy(offs),
                  torch.from_numpy(valid))
    j = JVar(jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(valid))
    return t, j, offs, rows


def _row_bytes(values, offs) -> list:
    raw = np.asarray(values).tobytes()
    offs = np.asarray(offs)
    return [raw[a:b] for a, b in zip(offs[:-1].tolist(), offs[1:].tolist())]


def _rows_of(col) -> list:
    """Each row's bytes of a column of either package, by its own
    offsets."""
    return _row_bytes(col.values, col.offsets)


def _outside_is_zero(values, offs) -> bool:
    v = np.asarray(values)
    return not v[:offs[0]].any() and not v[offs[-1]:].any()


def _initcap(row: bytes) -> bytes:
    out, prev = bytearray(), None
    for b in row:
        c = chr(b)
        start = prev is None or not (prev.isascii() and prev.isalnum())
        out.append(ord(c.upper() if start else c.lower())
                   if c.isascii() and c.isalpha() else b)
        prev = c
    return bytes(out)


_COMP = bytes.maketrans(b"ACGTacgtNnUu", b"TGCAtgcaNnAa")


@pytest.mark.parametrize("name", MAP_CASES)
def test_reverse_complement_matches_jax(name):
    t, j, offs, rows = _columns(name)
    got = TU.reverse_complement(None, t)
    assert _row_bytes(got.values, offs) == \
        [r[::-1].translate(_COMP) for r in rows]
    assert _outside_is_zero(got.values, offs)
    if name == "no_rows":
        with pytest.raises(TypeError):
            _rows_of(JU.reverse_complement(None, j))
        return
    assert _rows_of(JU.reverse_complement(None, j)) == _rows_of(got)


@pytest.mark.parametrize("name", MAP_CASES)
def test_reverse_matches_jax(name):
    t, j, offs, rows = _columns(name)
    got = TS.fn_reverse(None, t)
    assert _row_bytes(got.values, offs) == [r[::-1] for r in rows]
    assert _outside_is_zero(got.values, offs)
    if name == "no_rows":
        with pytest.raises(TypeError):
            _rows_of(JS.fn_reverse(None, j))
        return
    assert _rows_of(JS.fn_reverse(None, j)) == _rows_of(got)


@pytest.mark.parametrize("name", MAP_CASES)
def test_initcap_matches_jax(name):
    t, j, offs, rows = _columns(name)
    got = TS.fn_initcap(None, t)
    want = [_initcap(r) for r in rows]
    assert _row_bytes(got.values, offs) == want
    assert _outside_is_zero(got.values, offs)
    jax_rows = _rows_of(JS.fn_initcap(None, j))
    cap = offs[-1] if name != "no_rows" else None
    if cap is not None and rows and not rows[-1] and \
            offs[-1] == t.values.shape[0]:
        # F41: the empty last row's start, clipped to the last byte,
        # upper-cases the last byte of the row before
        last = max(i for i, r in enumerate(rows) if r)
        assert jax_rows[:last] == want[:last]
        assert jax_rows[last][:-1] == want[last][:-1]
        assert jax_rows[last][-1:] == bytes([rows[last][-1]]).upper()
    else:
        assert jax_rows == want


@pytest.mark.parametrize("name", MAP_CASES)
def test_row_mode_twins_are_the_per_byte_rule(name):
    """map_bytes_plain in both row modes through a permutation (and its
    512-entry pair), byte for byte against Python."""
    offs, vals, rows = map_case(name)
    perm = map_tables()["table"]
    o, v = torch.from_numpy(offs), torch.from_numpy(vals)
    mirror = kmb.map_bytes_plain(o, v, torch.from_numpy(perm), "mirror")
    assert _row_bytes(mirror, offs) == \
        [bytes(perm[b] for b in r[::-1]) for r in rows]
    pair = np.concatenate([perm, perm[::-1]])
    ws = kmb.map_bytes_plain(o, v, torch.from_numpy(pair), "word_start")
    want = []
    for r in rows:
        at = [k == 0 or not (chr(r[k - 1]).isascii() and
                             chr(r[k - 1]).isalnum()) for k in range(len(r))]
        want.append(bytes(pair[b + 256 * a] for b, a in zip(r, at)))
    assert _row_bytes(ws, offs) == want
    for out in (mirror, ws):
        assert _outside_is_zero(out, offs)


def _list_rows(values, offs) -> list:
    v = np.asarray(values)
    return [v[a:b].tolist() for a, b in zip(offs[:-1].tolist(),
                                            offs[1:].tolist())]


@pytest.mark.parametrize("name", MAP_CASES)
def test_widen_functions_match_jax(name):
    t, j, offs, rows = _columns(name)
    pairs = [(TU.integer_encode_dna(None, t), JU.integer_encode_dna(None, j),
              np.int8),
             (TU.quality_score_string_to_list(None, t),
              JU.quality_score_string_to_list(None, j), np.int64)]
    pairs += [(TU.integer_encoding(None, t, a), JU.integer_encoding(None, j, a),
               np.int64) for a in ALPHABETS]
    for got, want, dtype in pairs:
        assert got.child.values.dtype == torch.from_numpy(
            np.zeros(1, dtype)).dtype
        assert torch.equal(got.offsets, t.offsets)
        assert _list_rows(got.child.values, offs) == \
            _list_rows(np.asarray(want.values).astype(dtype), offs)


@pytest.mark.parametrize("out", [torch.int8, torch.int64], ids=["int8",
                                                                "int64"])
def test_widen_twin_at_the_thread_widths(out):
    """map_bytes_widen_plain at lengths 0-17 and 4,095-4,097 on views at
    offsets 0-15 of their storage, against numpy."""
    rng = np.random.default_rng(11)
    table = rng.integers(-2**40, 2**40, 256)
    for n in list(range(18)) + [4095, 4096, 4097]:
        vals = rng.integers(0, 256, n + 16).astype(np.uint8)
        for shift in range(16):
            v = torch.from_numpy(vals)[shift:shift + n]
            got = kmb.map_bytes_widen(v, torch.from_numpy(table), out)
            want = table[vals[shift:shift + n]].astype(
                np.int8 if out == torch.int8 else np.int64)
            assert got.dtype == out and got.tolist() == want.tolist()


def test_tables_are_copied_once_per_device():
    """The callers' byte tables: two calls give the same tensor object."""
    dev = torch.device("cpu")
    assert tstrings.byte_table(tstrings.UPPER.tobytes(), dev) is \
        tstrings.byte_table(tstrings.UPPER.tobytes(), dev)
    assert TU._complement_table(dev) is TU._complement_table(dev)
    phred = (np.arange(256, dtype=np.int64) - 33).tobytes()
    assert TU._int64_table(phred, dev) is TU._int64_table(phred, dev)
    for enc in fasta_device.ENCODINGS:
        assert fasta_device.encoding_table(enc, dev) is \
            fasta_device.encoding_table(enc, dev)
    # and the widen functions reach them: a second call copies nothing
    col = VarColumn(torch.tensor(list(b"ACGTNx"), dtype=torch.uint8),
                    torch.tensor([0, 6], dtype=torch.int32),
                    torch.ones(1, dtype=torch.bool))
    for fn in (TU.integer_encode_dna, TU.quality_score_string_to_list,
               lambda b, c: TU.integer_encoding(b, c, "ACGT")):
        fn(None, col)
        misses = TU._int64_table.cache_info().misses
        fn(None, col)
        assert TU._int64_table.cache_info().misses == misses


# ---------------------------------------------------------------------------
# both sessions' sql
# ---------------------------------------------------------------------------


def _fasta(path) -> str:
    """Records whose descriptions put word starts after spaces, digits and
    punctuation, with empty and absent descriptions, and DNA bodies of
    0-300 bases over two lines."""
    rng = np.random.default_rng(24)
    words = ["alpha", "B2b", "x-ray", "o'neil", "7th", "é", "hello_world",
             "  ", "ACGT", "n"]
    parts = []
    for i in range(120):
        desc = " ".join(rng.choice(words, int(rng.integers(0, 6))))
        head = b">s%d|P%d" % (i, i) + (b" " + desc.encode() if i % 7 else b"")
        body = bytes(np.frombuffer(b"ACGTN", np.uint8)[
            rng.integers(0, 5, int(rng.integers(0, 300)))])
        parts += [head + b"\n", body[:80] + b"\n", body[80:] + b"\n"]
    path.write_bytes(b"".join(parts))
    return str(path)


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    from benchlib.fastq_fixture import make_fastq

    d = tmp_path_factory.mktemp("k11b")
    fq = make_fastq(300, seed=24, path=str(d / "r.fastq"))
    fa = _fasta(d / "s.fasta")
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = 128
    ts = T.ExonSession(device="cpu", device_batch_size=128)
    for s in (ts, js):
        s.sql(f"CREATE EXTERNAL TABLE fq STORED AS FASTQ LOCATION '{fq}'")
        s.sql(f"CREATE EXTERNAL TABLE fa STORED AS FASTA LOCATION '{fa}'")
    return ts, js, fa


SQL = [
    "SELECT name, reverse_complement(sequence) AS rc FROM fq",
    "SELECT reverse_complement(trim_polya(sequence)) AS h FROM fq "
    "WHERE gc_content(sequence) >= 0.5",
    "SELECT reverse(name) AS r, reverse(sequence) AS s FROM fq",
    "SELECT id, initcap(description) AS d, reverse(id) AS r FROM fa",
    "SELECT initcap(trim(description)) AS d FROM fa",
    "SELECT integer_encode_dna(sequence) AS c FROM fq",
    "SELECT integer_encode_dna(sequence) AS c FROM fa",
    "SELECT quality_score_string_to_list(quality_scores) AS q FROM fq",
    "SELECT quality_score_list_to_string(quality_score_string_to_list("
    "quality_scores)) AS r, quality_scores FROM fq",
    "SELECT integer_encoding(sequence, 'ACGT') AS e, "
    "integer_encoding(description, 'a b') AS f FROM fa",
]


@pytest.mark.parametrize("sql", SQL, ids=[f"q{i}" for i in range(len(SQL))])
def test_sql_functions_match_jax(sessions, sql):
    ts, js, _fa = sessions
    got = ts.sql(sql).collect_arrow()
    want = js.sql(sql).collect_arrow()
    assert got.num_rows > 0
    assert got.schema == want.schema
    for col in want.column_names:
        assert got.column(col).to_pylist() == want.column(col).to_pylist(), \
            col


@pytest.mark.parametrize("kind", ["integer_encode_dna",
                                  "integer_encode_protein"])
def test_fasta_encodings_match_jax(sessions, kind, tmp_path):
    """Both packages' FASTA reads with a sequence_data_type (the port's
    device decode: map_bytes' widen mode to int8 codes)."""
    _ts, _js, fa = sessions
    ts = T.ExonSession(device="cpu", device_batch_size=128)
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = 128
    if kind == "integer_encode_protein":
        prot = tmp_path / "p.fasta"
        prot.write_bytes(open(fa, "rb").read().replace(b"N", b"W"))
        fa = str(prot)
    got = ts.read_fasta(fa, sequence_data_type=kind).collect_arrow()
    want = js.read_fasta(fa, sequence_data_type=kind).collect_arrow()
    assert got.schema.field("sequence").type == pa.list_(pa.int8())
    assert got.equals(want)
