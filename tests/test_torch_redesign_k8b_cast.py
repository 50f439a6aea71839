"""The twins of text_records (K8b) and format_int (CAST int -> utf8) held to
exon_tpu at the shapes their Hopper kernels' designs must survive;
test_torch_kernels.py holds the kernels to the twins on the same cases on a
card.

(a) text_records gives a line to a lane reading aligned 16-byte words,
and a line past its long-line threshold to a warp (a header) or to warps
in 16 KB pieces (a body line). Its cases (``record_case``): lines of
0-600 bytes at every offset mod 16; lines just under, at and past the
long-line threshold (512 bytes) and its doubles to 4,096, one of 70,033
bytes and a 9,303-byte header; a chunk that is one line with no final newline; CRLF text and
lines of bare '\\r'; headers whose first space lies at a word's first and
last byte, with no space, a space after '\\r', '>' in FASTA names; empty
lines and FASTQ headers without '@'.
Each text runs in its mode (FASTA or FASTQ), with and without want_hdr, and
the twin equals the per-line sums of exon_tpu's masks (record_structure,
first_match_in_segment, line_starts_mask; the masks of
formats/fastq.py _device_decode for FASTQ), as test_torch_device_text.py
derives them.
(b) format_int's offsets are a single pass over 1,024-row tiles and its text
a pass of 256-row blocks: the twin equals exon_tpu/plan/expressions.py
_cast_int_to_utf8 (offsets, and bytes within them) at 1-131,073 rows
(``int_case``: each digit count's edges, 2^32 +- 1, INT64_MAX and
INT64_MIN + 1, their negatives, NULL rows). INT64_MIN is held to Python's
str(), since the JAX function overflows on it (F10).
(c) SQL CAST of an integer column to VARCHAR over a GFF read in 700-row
batches, under ORDER BY the string, GROUP BY it, a join on it and
concat_ws, gives exon_tpu's Arrow table: the exact-size text that
plan/physical.py _cat_columns relies on when it concatenates batches.
Every comparison is exact."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.gff_fixture import make_gff
from exon_tpu.ops import device_text as jdt
from exon_tpu.plan import expressions as jexpr
from exon_tpu_torch.kernels import format_int as kf
from exon_tpu_torch.kernels import text_records as ktr
from test_torch_kernels import (INT_ROWS, LONG_EDGES, RECORD_CASES, int_case,
                                record_case, record_lines)

BATCH = 700


# ---------------------------------------------------------------------------
# (a) text_records
# ---------------------------------------------------------------------------


def _padded(text: np.ndarray):
    """exon_tpu's padded device buffer of a text: (numpy array, length)."""
    cap = max(1024, 1 << max(len(text) - 1, 0).bit_length())
    arr = np.full(cap, 10, np.uint8)
    arr[:len(text)] = text
    return arr, len(text)


def _per_line(mask, line_id, n_lines):
    return np.bincount(line_id[mask], minlength=n_lines)


def _jax_lines(text: np.ndarray, fastq: bool) -> dict:
    """Per-line header flags, body, split, name and description lengths and
    the bad-header count from exon_tpu's byte masks."""
    arr, n = _padded(text)
    ja = jnp.asarray(arr)
    pos = np.arange(len(arr))
    ls = np.asarray(jdt.line_starts_mask(ja, n))
    line_id = np.cumsum(ls) - 1
    n_lines = int(ls[:n].sum()) if n else 0
    live = pos < n
    if fastq:
        # exon_tpu/formats/fastq.py _device_decode (:107-147)
        role = line_id % 4
        body_all = live & (arr != 10) & (arr != 13)
        in_hdr = body_all & (role == 0)
        hdr_start = ls & (role == 0)
        first_sp = np.asarray(jdt.first_match_in_segment(
            jnp.asarray((arr == 32) & in_hdr), jnp.asarray(hdr_start)))
        is_hdr = np.arange(n_lines) % 4 == 0
        body = body_all & (role != 0)
        name = in_hdr & ~hdr_start & (pos < first_sp)
        bad = int((hdr_start & live & (arr != ord("@"))).sum())
    else:
        hdr_b, _rec, in_hdr = (np.asarray(x) for x in
                               jdt.record_structure(ja, n, ord(">")))
        first_sp = np.asarray(jdt.first_match_in_segment(
            jnp.asarray((arr == 32) & in_hdr), jnp.asarray(hdr_b)))
        is_hdr = hdr_b[np.flatnonzero(ls[:n])] if n_lines else \
            np.zeros(0, bool)
        body = live & (arr != 10) & (arr != 13) & ~in_hdr
        name = in_hdr & (arr != ord(">")) & (pos < first_sp) & (arr != 13)
        bad = 0
    desc = in_hdr & (pos > first_sp) & (arr != 13)
    return {"is_hdr": is_hdr, "body": _per_line(body, line_id, n_lines),
            "name_len": _per_line(name, line_id, n_lines),
            "desc_len": _per_line(desc, line_id, n_lines),
            "first_sp": first_sp, "bad": bad, "n_lines": n_lines}


@pytest.mark.parametrize("want_hdr", [True, False])
@pytest.mark.parametrize("case", RECORD_CASES)
def test_text_records_twin_matches_jax_masks(case, want_hdr):
    for text, fastq in record_case(case):
        t = torch.from_numpy(text)
        nl, n_lines = record_lines(t)
        lines = ktr.text_records_plain(t, nl, n_lines, fastq, want_hdr)
        want = _jax_lines(text, fastq)
        assert n_lines == want["n_lines"]
        starts = lines.start.numpy()
        ends = lines.end.numpy()
        assert (ends - starts).tolist() == [
            len(x) for x in text.tobytes().split(b"\n")][:n_lines]
        hdr = lines.is_hdr.numpy()
        assert hdr.tolist() == want["is_hdr"].tolist()
        assert lines.body.numpy()[~hdr].tolist() == \
            want["body"][~hdr].tolist()
        assert not lines.body.numpy()[hdr].any()
        assert int(lines.bad) == want["bad"]
        if not want_hdr:
            assert lines.split is None and lines.name_len is None
            continue
        assert lines.name_len.tolist() == want["name_len"].tolist()
        assert lines.desc_len.tolist() == want["desc_len"].tolist()
        # the JAX value holds from the first space to the segment's end
        sp = want["first_sp"][np.maximum(ends[hdr] - 1, starts[hdr])]
        split = np.where((sp >= 2 ** 30) | (sp >= ends[hdr]), ends[hdr], sp)
        assert lines.split.numpy()[hdr].tolist() == split.tolist()
        assert (lines.split.numpy()[~hdr] == ends[~hdr]).all()


def test_record_cases_cover_the_designs_edges():
    """Line starts at every offset mod 16; lines either side of the
    long-line threshold and of its doubles, and one of 70,033 bytes;
    headers whose first space lies at a 16-byte word's first and last
    byte."""
    (fa, _), (fq, _) = record_case("lines_0_600")
    for text in (fa, fq):
        nl, _n = record_lines(torch.from_numpy(text))
        starts = np.concatenate([[0], nl.numpy() + 1])
        assert set((starts % 16).tolist()) == set(range(16))
    (fa, _), _fq = record_case("long_lines")
    lines = fa.tobytes().split(b"\n")
    assert set(LONG_EDGES) | {70_033} <= {len(x) for x in lines}
    # a header past the threshold, which its warp reads
    assert max(len(x) for x in lines if x.startswith(b">")) > ktr.LONG_AT
    (fa, _), _fq = record_case("headers")
    t = torch.from_numpy(fa)
    nl, n_lines = record_lines(t)
    lines = ktr.text_records_plain(t, nl, n_lines, False, True)
    split = lines.split[lines.is_hdr & (lines.split < lines.end)]
    assert {0, 15} <= set((split % 16).tolist())


def test_group_width_and_long_threshold():
    # a lane a line; body lines past 512 bytes go to the second launch, as
    # kLongAt and kPiece in csrc/text_records.cu say
    src = (Path(ktr.__file__).parent / "csrc" / "text_records.cu").read_text()
    assert ktr.LONG_AT == 512 and ktr._PIECE == 16384
    assert "constexpr int kLongAt = 512;" in src
    assert "constexpr int kPiece = 16384;" in src
    assert LONG_EDGES[1] == ktr.LONG_AT


def test_text_records_buffer_layout_holds_every_piece():
    """The one buffer's regions do not overlap, the pieces' list starts on
    an 8-byte boundary and holds the most 16 KB pieces long lines can
    need: a line past the threshold touches at most len / 16384 + 2 of
    them."""
    for n, n_lines, want_hdr in ((134_217_205, 2_413_189, True),
                                 (1 << 27, 8, True), (33, 7, False),
                                 (1, 1, False)):
        bad, pieces, words = ktr._layout(n, n_lines, want_hdr)
        assert bad == (6 if want_hdr else 3) * n_lines
        # bad, then a byte a line of header flags
        assert pieces >= bad + 1 + (n_lines + 3) // 4
        assert pieces % 2 == 0
        cap = (words - pieces) // 2
        # worst case: every line just past the threshold, each straddling
        # two piece boundaries
        longest = ktr.LONG_AT + 1
        n_long = n // longest
        assert cap >= n_long * ((longest - 1) // 16384 + 2)
        assert cap >= n // 16384 + 2


# ---------------------------------------------------------------------------
# (b) format_int
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", INT_ROWS)
def test_format_int_twin_matches_jax_cast(n):
    ints, valid = int_case(n)
    want = jexpr._cast_int_to_utf8(jnp.asarray(ints), jnp.asarray(valid))
    w_offs, w_vals = np.asarray(want.offsets), np.asarray(want.values)
    offs, vals = kf.format_int_plain(torch.from_numpy(ints),
                                     torch.from_numpy(valid))
    assert offs.dtype == torch.int32
    assert offs.numpy().tolist() == w_offs.tolist()
    assert vals.shape[0] == int(offs[-1])  # exact size
    assert vals.numpy().tolist() == w_vals[:int(offs[-1])].tolist()
    text, o = vals.numpy().tobytes(), offs.tolist()
    assert [text[o[i]:o[i + 1]].decode() for i in range(n)] == \
        [str(v) if ok else "" for v, ok in zip(ints.tolist(), valid)]


def test_int_cases_cover_the_edges():
    ints, valid = int_case(INT_ROWS[-1])
    for v in (0, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 1, 2 ** 63 - 1,
              -(2 ** 63 - 1), 10 ** 18, -(10 ** 18) + 1):
        assert v in set(ints.tolist())
    assert not valid.all() and valid.any()
    assert {len(str(abs(int(v)))) for v in ints} == set(range(1, 20))


def test_format_int_int64_min_against_str():
    # F10: exon_tpu's abs overflows on INT64_MIN; the twin writes str()
    vals = torch.tensor([-2 ** 63, 5, -2 ** 63])
    offs, text = kf.format_int_plain(vals, torch.tensor([True, False, True]))
    assert offs.tolist() == [0, 20, 20, 40]
    assert text.numpy().tobytes() == str(-2 ** 63).encode() * 2


def test_format_int_refuses_rows_past_int32_offsets():
    # one element broadcast to the length: nothing of that size is allocated
    n = kf.MAX_ROWS + 1
    big = torch.zeros(1, dtype=torch.int64).expand(n)
    with pytest.raises(ValueError, match="int32 offsets"):
        kf.format_int(big, torch.ones(1, dtype=torch.bool).expand(n))


# ---------------------------------------------------------------------------
# (c) CAST int -> VARCHAR in SQL, several batches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    gff = make_gff(3000, seed=11, path=str(
        tmp_path_factory.mktemp("cast") / "g.gff3"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EXON_TPU_HOST_DECODE", "1")
        js = J.ExonSession.new_exon()
        js.config.device_batch_size = BATCH
        ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
        for s in (ts, js):
            s.sql(f"CREATE EXTERNAL TABLE genes STORED AS GFF LOCATION "
                  f"'{gff}'")
        yield ts, js


CAST_QUERIES = {
    "order_by": "SELECT CAST(start - 50000000 AS VARCHAR) AS s, seqname, "
                "\"end\" FROM genes ORDER BY s, seqname, \"end\"",
    "group_by": "SELECT CAST(start % 97 - 40 AS VARCHAR) AS k, COUNT(*) AS "
                "n, MIN(start) AS lo FROM genes GROUP BY CAST(start % 97 - "
                "40 AS VARCHAR) ORDER BY k",
    "join": "SELECT a.k, a.seqname, b.t FROM (SELECT CAST(start % 500 AS "
            "VARCHAR) AS k, seqname FROM genes WHERE type = 'exon') a JOIN "
            "(SELECT CAST(\"end\" % 500 AS VARCHAR) AS k2, type AS t FROM "
            "genes WHERE type <> 'exon') b ON a.k = b.k2 ORDER BY a.k, "
            "a.seqname, b.t",
    "concat_ws": "SELECT concat_ws('|', seqname, CAST(start AS VARCHAR), "
                 "CAST(start - \"end\" AS VARCHAR)) AS l FROM genes ORDER BY "
                 "l",
}


@pytest.mark.parametrize("name", list(CAST_QUERIES))
def test_sql_cast_to_varchar_over_batches_matches_jax(sessions, name):
    ts, js = sessions
    sql = CAST_QUERIES[name]
    got = ts.sql(sql).collect_arrow()
    want = js.sql(sql).collect_arrow()
    assert got.num_rows > 0
    assert got.schema == want.schema
    for col in want.column_names:
        assert got.column(col).to_pylist() == want.column(col).to_pylist(), \
            col
