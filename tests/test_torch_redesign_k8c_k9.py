"""The twins of gather_spans (K8c) and sw_score (K9) held to exon_tpu at the
shapes their Hopper kernels' designs must survive; test_torch_kernels.py
holds the kernels to the twins on the same cases on a card.

(a) gather_spans writes its output in 16-byte words, tiles of 16 KB a
block: a plain span (no dropped byte inside; dropped bytes at its ends are
trimmed) is copied by aligned loads at any source and destination
alignment, a masked span (a dropped byte inside) is placed by rank. Its
cases (``span_case``): span lengths 0, 1, 15, 16 and 17, a span of 1 MiB
(with a few '\\r' inside), all 16 x 16 source/destination alignments, CRLF
lines, '>' inside names that start with '>', a stray '\\r' inside lines,
spans whose starts descend and overlap, a plain span and a masked one in
one output word, and a total of 0; each under the drops (), (13,) and
(13, 62). The twin's output equals exon_tpu.ops.device_text.compact of the
spans' bytes, concatenated in span order, under the keep mask of the drops.
(b) sw_score picks a pass width of 8, 16 or 32 from the longest query and
pads past its end: query lengths 1, 7, 8, 9, 13, 16, 17, 31, 32, 33 and 64
over 150 rows of 0-300 bytes with empty and NULL rows, against
exon_tpu.ops.alignment.alignment_scores; the pairwise form with partners
of up to 8, 16, 32 and 64 bytes, empty partners included, against
alignment_scores_pairwise. Rows past 2,048 bytes, which the JAX wrappers
cut (F11), go against a plain numpy Gotoh DP.
Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exon_tpu.batch import VarColumn as JVar
from exon_tpu.ops import alignment as jalign
from exon_tpu.ops import device_text as jdt
from exon_tpu_torch.kernels import gather_spans as kgs
from exon_tpu_torch.kernels import sw_score as ksw
from test_torch_kernels import (SPAN_CASES, SPAN_DROPS, SW_QLENS, span_args,
                                span_case, sw_rows)

NEG = -(1 << 20)

# ---------------------------------------------------------------------------
# (a) gather_spans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop", SPAN_DROPS)
@pytest.mark.parametrize("case", SPAN_CASES)
def test_gather_spans_twin_matches_jax_compact(case, drop):
    src, starts, stops = span_case(case)
    args = span_args(src, starts, stops, drop, "cpu")
    got = kgs.gather_spans_plain(*args)
    cat = np.concatenate([src[s:e] for s, e in zip(starts, stops)])
    keep = ~np.isin(cat, np.asarray(drop, np.uint8)) if drop else \
        np.ones(len(cat), bool)
    want, total = jdt.compact(jnp.asarray(cat), jnp.asarray(keep), len(cat))
    assert int(total) == args[4] == got.shape[0]
    assert bytes(got.numpy()) == bytes(np.asarray(want)[:args[4]])
    if case == "total_zero" and drop:
        assert args[4] == 0


# ---------------------------------------------------------------------------
# (b) sw_score
# ---------------------------------------------------------------------------


def _columns(offs, vals, valid):
    return (torch.from_numpy(offs), torch.from_numpy(vals)), JVar(
        jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(valid))


@pytest.mark.parametrize("qlen", SW_QLENS)
def test_sw_twin_matches_jax_against_every_width(qlen):
    offs, vals, valid = sw_rows(100 + qlen, n=150)
    query = np.frombuffer(b"ACGT", np.uint8)[
        np.random.default_rng(qlen).integers(0, 4, qlen)]
    (t_offs, t_vals), j_col = _columns(offs, vals, valid)
    want = np.asarray(jalign.alignment_scores(j_col, query.tobytes()))
    got = ksw.sw_score_plain(t_offs, t_vals, torch.from_numpy(query.copy()))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    assert got[offs[1:] == offs[:-1]].eq(0).all()  # empty and NULL rows


@pytest.mark.parametrize("max_partner", [8, 16, 32, 64])
def test_sw_pairwise_twin_matches_jax_against_every_width(max_partner):
    offs, vals, valid = sw_rows(200 + max_partner, n=150)
    b_offs, b_vals, b_valid = sw_rows(300 + max_partner, n=150,
                                      max_len=max_partner)
    (ta, va), ja = _columns(offs, vals, valid)
    (tb, vb), jb = _columns(b_offs, b_vals, b_valid)
    want = np.asarray(jalign.alignment_scores_pairwise(ja, jb))
    got = ksw.sw_score_pairwise_plain(ta, va, tb, vb)
    assert got.numpy().tolist() == want.tolist()


def _gotoh(rows: list, queries: list) -> np.ndarray:
    """Plain Gotoh DP, cell by cell, vectorised over the pairs only: match
    +1, mismatch -1, a gap of length L costs -(1 + L), scores clamp at 0;
    each pair's best cell."""
    n = len(rows)
    la = np.array([len(r) for r in rows])
    lb = np.array([len(q) for q in queries])
    a = np.full((n, la.max()), -1)
    b = np.full((n, lb.max()), -2)  # padding matches nothing
    for i, (r, q) in enumerate(zip(rows, queries)):
        a[i, :len(r)] = np.frombuffer(r, np.uint8)
        b[i, :len(q)] = np.frombuffer(q, np.uint8)
    w = lb.max()
    h_prev = np.zeros((n, w + 1), np.int64)
    e = np.full((n, w + 1), NEG, np.int64)
    best = np.zeros(n, np.int64)
    for i in range(la.max()):
        h = np.zeros((n, w + 1), np.int64)
        f = np.full(n, NEG, np.int64)
        for j in range(1, w + 1):
            e[:, j] = np.maximum(h_prev[:, j] - 2, e[:, j] - 1)
            f = np.maximum(h[:, j - 1] - 2, f - 1)
            s = np.where(a[:, i] == b[:, j - 1], 1, -1)
            cell = np.maximum(np.maximum(0, h_prev[:, j - 1] + s),
                              np.maximum(e[:, j], f))
            h[:, j] = np.where((i < la) & (j <= lb), cell, 0)
        best = np.maximum(best, h.max(axis=1))
        h_prev = h
    return best


@pytest.mark.parametrize("form", ["query_13", "query_40", "pairwise"])
def test_sw_twin_past_2048_bytes_matches_numpy_gotoh(form):
    # F11: the JAX wrappers cut rows at 2,048 bytes; the port aligns them
    # whole, in one pass (13) or two (40) of the kernel's widest width
    rng = np.random.default_rng(len(form))
    letters = np.frombuffer(b"ACGT", np.uint8)
    rows = [letters[rng.integers(0, 4, n)].tobytes()
            for n in (2_100, 2_600, 0, 2_049)]
    adapter = letters[rng.integers(0, 4, 40)].tobytes()
    rows[0] = rows[0][:2_060] + adapter + rows[0][2_100:]  # a hit past 2,048
    offs = np.zeros(len(rows) + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    t_offs = torch.from_numpy(offs)
    t_vals = torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8).copy())
    if form == "pairwise":
        queries = [adapter, rows[1][2_500:2_533], b"ACGT", b""]
        q_offs = np.zeros(len(queries) + 1, np.int32)
        np.cumsum([len(q) for q in queries], out=q_offs[1:])
        got = ksw.sw_score_pairwise_plain(
            t_offs, t_vals, torch.from_numpy(q_offs),
            torch.from_numpy(np.frombuffer(b"".join(queries),
                                           np.uint8).copy()))
    else:
        query = adapter[:int(form.split("_")[1])]
        queries = [query] * len(rows)
        got = ksw.sw_score_plain(t_offs, t_vals, torch.from_numpy(
            np.frombuffer(query, np.uint8).copy()))
    want = _gotoh(rows, queries)
    assert got.numpy().tolist() == want.tolist()
    assert int(got[0]) >= len(queries[0])  # the hit past 2,048 is found
