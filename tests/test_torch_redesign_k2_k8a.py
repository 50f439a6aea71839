"""The twins of like_match (K2a LIKE, K2 position mode) and line_index
(K8a) held to exon_tpu at the shapes their Hopper kernels' designs must
survive; test_torch_kernels.py holds the kernels to the twins on the same
cases on a card.

(a) like_match searches a row in aligned 16-byte words, a group of lanes a
row, a chunk's first 17 tokens as bit masks over a window of two words and
longer chunks checked byte by byte. Its cases (``like_case``): rows of 0-600
bytes and one of 70,033; the 33-byte TruSeq adapter at every byte of a
16-byte word, in rows that start at every alignment; offsets that start at
37, with 11 bytes after the last row; mixed-case rows under ILIKE; and short
rows of A, C and x for overlapping chunks ('%C%C', '%AA%AA', 'AA%AA' on
'AAA'). Its patterns (``LIKE_PATTERNS``): middle chunks of 1, 2, 13, 16, 17,
18 and 33 bytes, anchored heads and tails, '_' at a window's edges and
past it. The twin equals exon_tpu.ops.strings.like on each; its position
mode equals exon_tpu.ops.sqlfuncs.fn_strpos minus one (strings.py
_find_from under ILIKE), needles of 0-33 bytes.
(b) line_index is one pass over 16 KB tiles into n / 16 + 1 positions: its
cases (``line_case``) are texts whose lines average under 16 bytes (runs of
bare '\\n'), CRLF text, a text with no final newline and lengths at the
word's, a warp load's and the tile's edges. The twin's newlines, each + 1,
are the line starts of exon_tpu.ops.device_text.line_starts_mask after the
first.
The twin also equals exon_tpu's like_regex row by row on every case.
(c) F36: the twin of LIKE with a middle chunk raised where a column's
offsets start past 0 or its values run past the last row; exon_tpu answers.
F37: exon_tpu's '%lit%' path counts the bytes before offsets[0] into row 0
(so the offsets_past_zero case puts 'x' there); both answers are shown.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exon_tpu.batch import VarColumn as JVar
from exon_tpu.ops import device_text as jdt
from exon_tpu.ops import sqlfuncs as jsql
from exon_tpu.ops import strings as jstr
from exon_tpu_torch.batch import VarColumn as TVar
from exon_tpu_torch.kernels import like_match as kl
from exon_tpu_torch.kernels import line_index as kli
from exon_tpu_torch.ops import strings as tstr
from exon_tpu_torch.ops.strings import tokenize_like
from test_torch_kernels import (LIKE_CASES, LINE_CASES, STRPOS_NEEDLES,
                                like_case, like_patterns, line_case)


def _jcol(offs, vals):
    return JVar(jnp.asarray(vals), jnp.asarray(offs),
                jnp.ones(len(offs) - 1, bool))


# ---------------------------------------------------------------------------
# (a) like_match
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", LIKE_CASES)
def test_like_twin_matches_jax_like(case):
    offs, vals = like_case(case)
    t_offs, t_vals = torch.from_numpy(offs), torch.from_numpy(vals)
    col = _jcol(offs, vals)
    for pattern, ci in like_patterns(case):
        want = np.asarray(jstr.like(col, pattern, ci))
        got = kl.like_match_plain(t_offs, t_vals, tokenize_like(pattern), ci)
        assert got.numpy().tolist() == want.tolist(), pattern


@pytest.mark.parametrize("case", LIKE_CASES)
def test_like_twin_matches_a_regex_row_by_row(case):
    # exon_tpu's host form of LIKE (like_regex), one row at a time: the
    # rows' own bytes only, whatever lies before offsets[0]
    offs, vals = like_case(case)
    t_offs, t_vals = torch.from_numpy(offs), torch.from_numpy(vals)
    rows = [vals[a:b].tobytes().decode("latin-1")
            for a, b in zip(offs[:-1], offs[1:])]
    for pattern, ci in like_patterns(case):
        rx = jstr.like_regex(pattern, None, ci)
        want = [rx.match(r) is not None for r in rows]
        got = kl.like_match_plain(t_offs, t_vals, tokenize_like(pattern), ci)
        assert got.numpy().tolist() == want, pattern


@pytest.mark.parametrize("case", LIKE_CASES)
def test_position_mode_twin_matches_jax_strpos(case):
    offs, vals = like_case(case)
    t_offs, t_vals = torch.from_numpy(offs), torch.from_numpy(vals)
    col = _jcol(offs, vals)
    starts = col.offsets[:-1].astype(jnp.int32)
    for needle in STRPOS_NEEDLES:
        want = np.asarray(jsql.fn_strpos(None, col, needle).values) - 1
        got = kl.like_find_plain(t_offs, t_vals, tuple(needle), False)
        assert got.dtype == torch.int32
        assert got.numpy().tolist() == want.tolist(), needle
        if not needle:
            continue
        pos, found = jstr._find_from(col, needle.lower(), starts, True)
        want = np.where(np.asarray(found), np.asarray(pos - starts), -1)
        got = kl.like_find_plain(t_offs, t_vals, tuple(needle.lower()), True)
        assert got.numpy().tolist() == want.tolist(), needle


def test_group_width_covers_a_mean_row_in_one_pass():
    # a pass of G lanes covers 4G - 1 words; A's 400-byte rows take 8,
    # the FASTQ chunk's 146-byte reads 4
    assert kl.group_width(131_072, 52_375_986) == 8
    assert kl.group_width(377_963, 55_410_319) == 4
    assert [kl.group_width(100, 100 * m) for m in (0, 239, 240, 495, 496,
                                                   1007, 1008, 10_000)] == \
        [4, 4, 8, 8, 16, 16, 32, 32]
    assert kl.group_width(0, 0) == 4
    # anchored chunks alone search nothing
    assert [kl._searches(tuple(tokenize_like(p))) for p in
            ("M%", "exact", "a%b", "%", "%%", "%KK%", "a%b%c")] == \
        [False, False, False, False, False, True, True]


def test_encoded_pattern_filters_the_first_17_tokens_most_offsets_first():
    chunks = tokenize_like("%AGATCGGAAGAGCACACGT%")
    enc = kl.encode_pattern(chunks, False)
    tok_at, k, flt_at, nflt = enc[2 + 4:2 + 8]  # chunk 1's record
    chunk = chunks[1]
    assert enc[tok_at:tok_at + k] == list(chunk)
    entries = enc[flt_at:flt_at + nflt]
    for e in entries:
        v, o = e & 0xFF, e >> 8
        assert o == sum(1 << i for i, t in enumerate(chunk[:17]) if t == v)
    counts = [bin(e >> 8).count("1") for e in entries]
    assert counts == sorted(counts, reverse=True)
    assert {e & 0xFF for e in entries} == set(chunk[:17])


# ---------------------------------------------------------------------------
# (b) line_index
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", LINE_CASES)
def test_line_index_twin_matches_jax_line_starts(case):
    for text in line_case(case):
        n = len(text)
        nl = kli.line_index_plain(torch.from_numpy(text.copy())).numpy()
        want = np.flatnonzero(np.asarray(jdt.line_starts_mask(
            jnp.asarray(text), n)))
        starts = np.concatenate([[0], nl.astype(np.int64) + 1])
        assert starts[starts < n].tolist() == want.tolist()
        assert nl.dtype == np.int32 and nl.tolist() == \
            np.flatnonzero(text == 10).tolist()


def test_short_lines_pass_the_kernels_first_buffer():
    # the case the wrapper's second launch exists for: more newlines than
    # the n / 16 + 1 positions of its first buffer
    for text in line_case("short_lines"):
        assert int((text == 10).sum()) > len(text) // 16 + 1


# ---------------------------------------------------------------------------
# (c) F36 and F37
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["%KK%", "%K_%", "A%K%", "%A%K%x"])
@pytest.mark.parametrize("offsets", [[0, 4, 8, 12], [2, 4, 8, 12],
                                     [0, 4, 8, 10], [2, 4, 8, 10],
                                     [3, 3, 8, 14]])
def test_f36_like_twin_past_offsets_zero_and_before_slack(pattern, offsets):
    vals = np.frombuffer(b"xxAKKAxAKxKKyy", np.uint8).copy()
    offs = np.asarray(offsets, np.int32)
    want = np.asarray(jstr.like(_jcol(offs, vals), pattern))
    col = TVar(torch.from_numpy(vals), torch.from_numpy(offs),
               torch.ones(3, dtype=torch.bool))
    got = tstr.like(col, pattern)
    assert got.numpy().tolist() == want.tolist()


def test_f37_jax_contains_counts_the_bytes_before_offsets_zero():
    # exon_tpu's contains (the '%lit%' fast path, ops/strings.py:97-122)
    # maps the bytes before offsets[0] to row 0 (byte_row_ids), so row 0
    # 'Ax' holds 'KK' there; the port reads a row's own bytes
    vals = np.frombuffer(b"KKAxAKKA", np.uint8).copy()
    offs = np.asarray([2, 4, 8], np.int32)
    assert np.asarray(jstr.like(_jcol(offs, vals), "%KK%")).tolist() == \
        [True, True]
    col = TVar(torch.from_numpy(vals), torch.from_numpy(offs),
               torch.ones(2, dtype=torch.bool))
    assert tstr.like(col, "%KK%").tolist() == [False, True]
    assert tstr.like(col, "%K_%").tolist() == [False, True]
