"""The twins of span_concat (K12) and window_bounds (K10a) held to exon_tpu
at the shapes their Hopper kernels' designs must survive;
test_torch_kernels.py holds the kernels to the twins on the same cases on
a card.

(a) span_concat takes its pieces by value (a scalar wherever a field is the
same for every row, literal bytes inline up to INLINE_BYTES, a device table
past MAX_PIECES), its offsets from its own pass and its output in 4 KB
tiles of 16-byte words. Its twin, through the port's fn_concat, ``||``
(fn_concat_op), fn_concat_ws, lpad/rpad (_pad), fn_repeat and the string
fn_coalesce, equals exon_tpu/ops/sqlfuncs.py's functions and a plain
Python reference on ``concat_case``'s cases: NULLs in every pattern over
three columns, empty rows with an empty literal and separator, a separator
and a pad pattern of 600 bytes (past INLINE_BYTES), pad patterns of 1 and
of 5 bytes (multi-byte UTF-8), widths that cut rows, repeat 0, rows of
2,999 and 4,097 bytes repeated 3 times (past a 4,096-byte write tile),
offsets that start past 0 with bytes after the last row, 40 columns
(concat: 40 pieces; concat_ws: 79), no rows, one row, and 5,000 rows (five
offsets tiles). exon_tpu raises on an empty string literal in concat,
concat_ws and coalesce, and on columns of no rows (F39): there the port is
held to the reference and the JAX raise asserted. The piece rules
themselves are held to a Python walk over every form (per-row and scalar
fields, gates, cut, fill, times), and ``tile_words`` to the stage's
budget.

(b) window_bounds writes the starts in a pass from the left and the ends
in a pass from the right, each on its own look-back. Its twin, through the
port's _window_column, equals exon_tpu/plan/window_exec.py's
_window_column over the rank family (row_number, rank, dense_rank,
percent_rank, cume_dist, ntile) on ``bounds_case``'s keys: one partition
across four tiles of 1,024 rows, every row its own partition, all rows
peers, partitions and peer groups starting exactly at tile edges and one
row either side, and n of 1 and of a tile and one less and one more. On
string keys past 8 bytes that share their first 8, the port's bounds are
exact, held to a Python walk over the full strings (F19 and F20 still
hold: the JAX rank is that of the 8-byte prefixes, asserted too). Every
comparison is exact."""

import bisect

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from exon_tpu import datatypes as jdt
from exon_tpu.batch import Batch as JBatch
from exon_tpu.batch import FixedColumn as JFixed
from exon_tpu.batch import VarColumn as JVar
from exon_tpu.datatypes import Field as JField
from exon_tpu.datatypes import Schema as JSchema
from exon_tpu.ops import sqlfuncs as JS
from exon_tpu.plan import window_exec as JW
from exon_tpu.plan.expressions import ColumnRef as JRef
from exon_tpu.plan.expressions import WindowCall as JCall
from exon_tpu_torch import datatypes as dt
from exon_tpu_torch.batch import Batch, FixedColumn, VarColumn
from exon_tpu_torch.datatypes import Field, Schema
from exon_tpu_torch.kernels import span_concat as ks
from exon_tpu_torch.kernels import window_bounds as kwb
from exon_tpu_torch.ops import sqlfuncs as TS
from exon_tpu_torch.plan import window_exec as TW
from exon_tpu_torch.plan.expressions import ColumnRef, WindowCall
from exon_tpu_torch.plan.planner import infer_window_field
from test_torch_kernels import (BOUNDS_CASES, BOUNDS_TILE, CONCAT_CASES,
                                CONCAT_OPS, _rows, bounds_case, concat_case,
                                concat_op)

# ---------------------------------------------------------------------------
# (a) span_concat
# ---------------------------------------------------------------------------


def _port_cols(spec) -> list:
    return [VarColumn(torch.from_numpy(v), torch.from_numpy(o),
                      torch.from_numpy(ok)) for o, v, ok in spec["cols"]]


def _jax_cols(spec) -> list:
    """The same columns for exon_tpu; a buffer of no bytes gets one byte of
    padding, as exon_tpu's own columns keep (``_empty_var``)."""
    return [JVar(jnp.asarray(v if len(v) else np.zeros(1, np.uint8)),
                 jnp.asarray(o), jnp.asarray(ok))
            for o, v, ok in spec["cols"]]


def _reference(op: str, spec) -> tuple[list, list]:
    """(each row's bytes, the validity) of ``op`` by plain Python."""
    cols = [([v[s:e].tobytes() for s, e in zip(o[:-1], o[1:])], ok.tolist())
            for o, v, ok in spec["cols"]]
    n = len(spec["cols"][0][0]) - 1
    lit = [(spec["lit"], True)] if n else []
    rows = [[(c[0][r], c[1][r]) for c in cols] for r in range(n)]
    if op == "concat":
        return ([b"".join(b for b, ok in row + lit if ok) for row in rows],
                [True] * n)
    if op == "pipe":
        return ([b"".join(b for b, _ok in row) for row in rows],
                [all(ok for _b, ok in row) for row in rows])
    if op == "concat_ws":
        return ([spec["sep"].join(b for b, ok in row if ok) for row in rows],
                [True] * n)
    if op in ("lpad", "rpad"):
        w, pad = max(spec["width"], 0), spec["pad"] or b" "
        out = []
        for b, _ok in (row[0] for row in rows):
            fill = (pad * (w // len(pad) + 1))[:max(w - len(b), 0)]
            out.append(b[:w] if len(b) >= w else
                       fill + b if op == "lpad" else b + fill)
        return out, [row[0][1] for row in rows]
    if op == "repeat":
        return ([row[0][0] * max(spec["k"], 0) for row in rows],
                [row[0][1] for row in rows])
    first = [next(((b, ok) for b, ok in row[:3] + lit if ok), (b"", False))
             for row in rows]
    return [b for b, _ok in first], [ok for _b, ok in first]


# exon_tpu raises on an empty string literal in these, and on columns of no
# rows in all of them (F39)
_JAX_RAISES = {("empty", "concat"), ("empty", "concat_ws"),
               ("empty", "coalesce")} | {("n 0", op) for op in CONCAT_OPS}


@pytest.mark.parametrize("op", CONCAT_OPS)
@pytest.mark.parametrize("case", CONCAT_CASES)
def test_span_concat_twin_matches_jax(case, op):
    spec = concat_case(case)
    got = concat_op(TS, op, spec, _port_cols(spec))
    assert got.values.shape[0] == int(got.offsets[-1])
    assert _rows(got) == _reference(op, spec)
    if (case, op) in _JAX_RAISES:
        with pytest.raises(TypeError):
            concat_op(JS, op, spec, _jax_cols(spec))
        return
    assert _rows(got) == _rows(concat_op(JS, op, spec, _jax_cols(spec)))


def _walk(sources: list, pieces: list, n: int) -> list:
    """Each output row by the rules of ks.Piece, one byte at a time."""
    def at(v, r):
        return int(v[r]) if isinstance(v, torch.Tensor) else v

    out = []
    for r in range(n):
        seen, lens, parts = False, [], []
        for p in pieces:
            src = sources[p.src]
            data = bytes(src) if isinstance(src, bytes) else \
                bytes(src.tolist())
            if p.length is None and isinstance(p.start, torch.Tensor):
                start = at(p.start, r)
                base = at(p.start, r + 1) - start
            else:
                start = at(p.start, r)
                base = len(data) - start if p.length is None else \
                    at(p.length, r)
            ln = base * p.times
            if p.cap is not None:
                ln = min(ln, p.cap)
            ok = True if p.valid is None else bool(p.valid[r])
            open_ = {"always": True, "valid": ok, "join": ok and seen,
                     "first": ok and not seen}[p.gate]
            if p.gate in ("valid", "first"):
                seen = seen or ok
            span = max(base if p.span is None else at(p.span, r), 1)
            parts.append((data, start, span, open_))
            lens.append(max(ln, 0) if open_ and p.fill is None else 0)
        others = sum(lens)
        row = b""
        for p, (data, start, span, open_), ln in zip(pieces, parts, lens):
            if p.fill is not None:
                ln = max(p.fill - others, 0) if open_ else 0
            row += bytes(data[start + i % span] for i in range(ln))
        out.append(row)
    return out


def test_span_concat_twin_follows_the_piece_rules():
    """Every piece form against a Python walk: per-row and scalar starts,
    spans and lengths, a column's offsets past 0, literals inline and past
    INLINE_BYTES, the four gates, cut, fill and times, and more pieces than
    MAX_PIECES (the kernel's device table)."""
    rng = np.random.default_rng(47)
    n = 60
    lens = rng.integers(0, 12, n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    offs = torch.from_numpy((offs + 5).astype(np.int32))
    vals = torch.from_numpy(rng.integers(97, 123, int(offs[-1]) + 3,
                                         dtype=np.uint8))
    ln = (offs[1:] - offs[:-1]).to(torch.int32)
    valid = torch.from_numpy(rng.random(n) < 0.6)
    other = torch.from_numpy(rng.random(n) < 0.4)
    long_lit = bytes(rng.integers(65, 91, ks.INLINE_BYTES + 40,
                                  dtype=np.uint8))
    srcs = [vals, b"-=", long_lit]
    P = ks.Piece
    pieces = [P(1, gate="join", valid=valid),
              P(0, offs, gate="valid", valid=valid),
              P(0, 7, span=3, length=ln % 5),
              P(2, 13, length=40), P(1, fill=30, span=1),
              P(0, offs, times=3, cap=20),
              P(0, offs[:-1], span=ln.clamp(min=1), length=ln * 2),
              P(2, gate="first", valid=other), P(1, 1, length=1, times=4),
              (0, offs[:-1], 4, ln)]
    for ps in (pieces, pieces * 4):
        o, v = ks.span_concat(srcs, ps)
        rows = [v[o[r]:o[r + 1]].numpy().tobytes() for r in range(n)]
        assert rows == _walk(srcs, [ks._as_piece(p) for p in ps], n)
        assert v.shape[0] == int(o[-1])
    assert len(pieces * 4) > ks.MAX_PIECES


def test_span_concat_refuses_a_total_past_int32_and_odd_pieces():
    one = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ks.ExecutionError, match="2\\^31"):
        ks.span_concat([torch.zeros(1, dtype=torch.uint8)],
                       [ks.Piece(0, 0, span=1, length=one, times=1 << 30)])
    with pytest.raises(ValueError, match="pass n"):
        ks.span_concat([b"ab"], [ks.Piece(0)], device="cpu")
    with pytest.raises(ValueError, match="gate"):
        ks.span_concat([b"ab"], [ks.Piece(0, gate="some")], n=2,
                       device="cpu")
    with pytest.raises(ValueError, match="needs a length"):
        ks.span_concat([torch.zeros(3, dtype=torch.uint8)],
                       [ks.Piece(0, 1, valid=one > 0)])
    o, v = ks.span_concat([b"ab"], [ks.Piece(0, times=2)], n=3,
                          device="cpu")
    assert o.tolist() == [0, 4, 8, 12] and bytes(v.tolist()) == b"abab" * 3


def test_span_concat_constants_match_the_source():
    from pathlib import Path

    src = (Path(ks.__file__).resolve().parent / "csrc" /
           "span_concat.cu").read_text()
    assert f"kMaxPieces = {ks.MAX_PIECES};" in src
    assert f"kInline = {ks.INLINE_BYTES};" in src
    assert "kTileBytes = kThreads * 16;" in src and ks.TILE_BYTES == 4096
    assert "kTile = kThreads * kRows;" in src and ks.TILE_ROWS == 1024
    assert "sizeof(Piece) == 88" in src and ks.PIECE_SLOTS * 8 == 88
    assert f"kStageRows = {ks.STAGE_ROWS};" in src
    assert f"kStageRuns = {ks.STAGE_RUNS};" in src
    for gate, code in ks.GATES.items():
        assert f"k{gate.capitalize()} = {code};" in src


def test_span_concat_tile_words_follow_the_mean_row():
    """A write block takes more 4 KB tiles the longer the call's rows:
    J's concat_ws (295,660 rows of ~40 bytes, 5 pieces) two, its lpad
    (5-byte rows, 2 pieces) one, a repeat of 1,200-byte rows sixteen; never
    more runs than half the stage holds."""
    assert ks.tile_words(295_660, 11_899_840, 5) == 2
    assert ks.tile_words(295_660, 1_478_300, 2) == 1
    assert ks.tile_words(20_000, 23_852_211, 1) == ks.MAX_WORDS == 16
    assert ks.tile_words(1, 5000, 1) == 16 and ks.tile_words(10, 10, 40) == 1
    for n, total, pieces in ((5000, 61_000, 3), (100, 10 ** 9, 79)):
        w = ks.tile_words(n, total, pieces)
        rows = max(ks.TILE_BYTES * n // total, 1)
        assert w * rows * pieces <= ks.STAGE_RUNS // 2 or w == 1


# ---------------------------------------------------------------------------
# (b) window_bounds
# ---------------------------------------------------------------------------

RANK_FAMILY = [("row_number", 1), ("rank", 1), ("dense_rank", 1),
               ("percent_rank", 1), ("cume_dist", 1), ("ntile", 3)]


def _batches(p, o):
    n = len(p)
    port = Batch(Schema((Field("p", dt.int64, True),
                         Field("o", dt.int64, True))),
                 [FixedColumn(p, np.ones(n, bool)),
                  FixedColumn(o, np.ones(n, bool))], n).to_device("cpu")
    jax = JBatch(JSchema((JField("p", jdt.int64, True),
                          JField("o", jdt.int64, True))),
                 [JFixed(jnp.asarray(p), jnp.asarray(np.ones(n, bool))),
                  JFixed(jnp.asarray(o), jnp.asarray(np.ones(n, bool)))],
                 jnp.asarray(n, jnp.int32))
    return port, jax


@pytest.mark.parametrize("fn,offset", RANK_FAMILY,
                         ids=[f for f, _o in RANK_FAMILY])
@pytest.mark.parametrize("case", BOUNDS_CASES)
def test_window_bounds_twin_matches_jax(case, fn, offset):
    """The rank family through both packages' _window_column (the bounds
    are what each reads: partition starts and ends, peer firsts and
    lasts), on rows given shuffled so that both sort them."""
    p, o = bounds_case(case)
    order = np.random.default_rng(len(case)).permutation(len(p))
    batch, jbatch = _batches(p[order], o[order])
    call = WindowCall(fn, None, [ColumnRef("p")], [(ColumnRef("o"), True)],
                      offset, None, None)
    jcall = JCall(fn, None, [JRef("p")], [(JRef("o"), True)], offset, None,
                  None)
    want, want_ok = (np.asarray(a) for a in JW._window_column(jcall, jbatch))
    perm, bounds = TW._sorted_bounds(call, batch)
    got = TW._window_column(call, batch, perm, bounds,
                            infer_window_field(call, "w", batch.schema))
    assert np.array_equal(got.validity.numpy(), want_ok)
    assert np.array_equal(got.values.numpy(),
                          want.astype(got.values.numpy().dtype))


def _exact_bounds(keys: list, n_part: int) -> list:
    """[seg_start, seg_end, peer_first, peer_last] of rows already sorted,
    from exact equality of their key tuples."""
    n = len(keys)
    out = [[0] * n for _ in range(4)]
    for kind, width in ((0, n_part), (2, len(keys[0]) if n else 0)):
        s = 0
        for r in range(n):
            if r and keys[r][:width] != keys[r - 1][:width]:
                s = r
            out[kind][r] = s
        e = n - 1
        for r in reversed(range(n)):
            if r < n - 1 and keys[r + 1][:width] != keys[r][:width]:
                e = r
            out[kind + 1][r] = e
    return out


def _string_keys(n: int, seed: int) -> tuple[list, list]:
    """Partition and order keys past 8 bytes that share their first 8."""
    rng = np.random.default_rng(seed)
    p = [b"partition-" + bytes([97 + int(x)]) for x in rng.integers(0, 3, n)]
    o = [b"order-ke" + bytes(rng.integers(97, 100, int(k), dtype=np.uint8))
         for k in rng.integers(0, 5, n)]
    return p, o


def _rank(part: list, key: list) -> list:
    """Each row's rank: 1 + the rows of its partition with a smaller
    key."""
    groups: dict = {}
    for pk, k in zip(part, key):
        groups.setdefault(pk, []).append(k)
    for ks_ in groups.values():
        ks_.sort()
    return [bisect.bisect_left(groups[pk], k) + 1
            for pk, k in zip(part, key)]


def _var(rows: list) -> tuple:
    offs = np.zeros(len(rows) + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    vals = np.frombuffer(b"".join(rows) or b"\0", np.uint8).copy()
    return offs, vals, np.ones(len(rows), bool)


@pytest.mark.parametrize("n", [1, BOUNDS_TILE - 1, BOUNDS_TILE + 1, 5000])
def test_window_bounds_twin_is_exact_on_long_string_keys(n):
    """F19/F20: partition and order keys past 8 bytes. The port's bounds
    follow every byte; the JAX rank is that of the 8-byte prefixes."""
    p, o = _string_keys(n, n)
    schema = Schema((Field("p", dt.utf8, True), Field("o", dt.utf8, True)))
    batch = Batch(schema, [VarColumn(*(_var(p)[i] for i in (1, 0, 2))),
                           VarColumn(*(_var(o)[i] for i in (1, 0, 2)))],
                  n).to_device("cpu")
    call = WindowCall("rank", None, [ColumnRef("p")], [(ColumnRef("o"),
                                                        True)], 1, None, None)
    perm, keys, n_part = TW.sort_rows(call, batch)
    order = sorted(range(n), key=lambda i: (p[i], o[i]))
    assert perm.tolist() == order
    bounds = kwb.window_bounds(keys, n_part)
    want = _exact_bounds([(p[i], o[i]) for i in order], 1)
    assert [b.tolist() for b in bounds] == want
    # the JAX rank of the same rows: the rank of the 8-byte prefixes of o
    js = JSchema((JField("p", jdt.utf8, True), JField("o", jdt.utf8, True)))
    jbatch = JBatch(js, [JVar(*(jnp.asarray(a) for a in
                                (_var(p)[1], _var(p)[0], _var(p)[2]))),
                         JVar(*(jnp.asarray(a) for a in
                                (_var(o)[1], _var(o)[0], _var(o)[2])))],
                    jnp.asarray(n, jnp.int32))
    jcall = JCall("rank", None, [JRef("p")], [(JRef("o"), True)], 1, None,
                  None)
    jrank = np.asarray(JW._window_column(jcall, jbatch)[0]).tolist()
    assert jrank == _rank(p, [k[:8] for k in o])
    got = TW._window_column(call, batch, perm, bounds,
                            infer_window_field(call, "w", batch.schema))
    assert got.values.tolist() == _rank(p, o)


def test_two_pass_scans_take_two_epochs(monkeypatch):
    """window_bounds' two passes in one workspace call: the starts pass's
    epoch and tickets, then the ends pass's (epoch + 1, after the starts'
    tiles); the next call comes after both, and the words are cleared
    when fewer than two epochs are left."""
    from exon_tpu_torch.kernels import _lookback

    monkeypatch.setattr(_lookback, "_workspaces", {})
    cpu, calls = torch.device("cpu"), []

    def launch(status, ticket, base, epoch):
        calls.append((base, epoch))

    _lookback.scan(cpu, 5, 8, 8, launch, epochs=2)   # 4 tiles, two passes
    _lookback.scan(cpu, 5, 3, 3, launch)
    assert calls == [(0, 1), (8, 3)]
    ws = _lookback.workspace(cpu, 5, 1)
    ws.words.fill_(-1)
    ws.epoch = _lookback.EPOCH_LIMIT - 1
    _lookback.scan(cpu, 5, 8, 8, launch, epochs=2)
    assert calls[-1] == (0, 1) and not bool(ws.words.any())
    assert (ws.epoch, ws.tickets) == (2, 8)
