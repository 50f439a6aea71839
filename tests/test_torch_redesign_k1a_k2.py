"""The twins of compact_mask (K1a) and of map_bytes' table mode (K2 upper
and lower) held to exon_tpu at the shapes their Hopper kernels' designs
must survive, and the port's grouped float MIN/MAX with NaN held to
exon_tpu (F33).

(a) compact_mask is one single-pass launch over tiles of 4,096 rows, each
thread 16 mask bytes: lengths around the thread's 16 and the tile's 4,096
(0, 1, 15, 16, 17, 4,095, 4,096, 4,097 and 3 x 4,096 + 15) under masks
that are all true, all false, alternating and 0.5 % true, through
``ops.layout.mask_to_indices`` against ``exon_tpu.ops.layout``'s; and the
wrapper's workspace of status words (grown for more tiles, cleared when the
epoch wraps).
(b) map_bytes' table mode maps one byte range, [offsets[0], offsets[n]),
in 16-byte words and writes 0 elsewhere: offsets that start past 0, slack
bytes after offsets[n], empty rows, a values view at an odd offset and no
rows at all, against exon_tpu's ``upper``/``lower`` over the bytes inside
the rows.
(c) F33: grouped MIN/MAX over float64 with NaN (a group of NaN alone, a few
groups with one NaN, one group whose values are all NULL) through the
port's AggregateExec on one device and DistributedAggregateExec on 4 shards,
against exon_tpu on one device: a NaN wins; the all-NULL group is NULL.
Every comparison is exact (NaN positions equal, values equal elsewhere)."""

import math

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
from exon_tpu.batch import VarColumn as JVar
from exon_tpu.ops import layout as jlayout
from exon_tpu.ops import strings as jstrings
from exon_tpu.sql.frontend import MemTable as JMemTable
import exon_tpu_torch as T
from exon_tpu_torch.config import new_exon_config as t_config
from exon_tpu_torch.kernels import _lookback
from exon_tpu_torch.kernels import compact_mask as kc
from exon_tpu_torch.kernels import map_bytes as kmb
from exon_tpu_torch.ops import layout as tlayout
from exon_tpu_torch.ops.strings import LOWER, UPPER
from exon_tpu_torch.parallel import distributed as TD

# ---------------------------------------------------------------------------
# (a) compact_mask
# ---------------------------------------------------------------------------

LENGTHS = [0, 1, 15, 16, 17, 4095, 4096, 4097, 3 * 4096 + 15]


def _mask(kind: str, n: int) -> np.ndarray:
    if kind == "all_true":
        return np.ones(n, bool)
    if kind == "all_false":
        return np.zeros(n, bool)
    if kind == "alternating":
        return np.arange(n) % 2 == 0
    return np.random.default_rng(n).random(n) < 0.005


@pytest.mark.parametrize("kind", ["all_true", "all_false", "alternating",
                                  "sparse"])
@pytest.mark.parametrize("n", LENGTHS)
def test_mask_to_indices_matches_jax(n, kind):
    mask = _mask(kind, n)
    want_idx, want_count = jlayout.mask_to_indices(jnp.asarray(mask))
    got_idx, got_count = tlayout.mask_to_indices(torch.from_numpy(mask))
    assert got_idx.dtype == torch.int32 and got_count.dtype == torch.int32
    assert got_count.dim() == 0
    assert int(got_count) == int(want_count) == int(mask.sum())
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))


def test_compact_workspace_grows_and_clears_on_epoch_wrap(monkeypatch):
    """The status words per (device, stream), kept by kernels/_lookback.py
    for compact_mask (and bucket_pack and gather_var): a call needing more
    tiles gets a larger, cleared workspace, numbered from epoch 0 and ticket
    0; at the last epoch the words are cleared and the count restarts."""
    monkeypatch.setattr(_lookback, "_workspaces", {})
    cpu = torch.device("cpu")
    ws = _lookback.workspace(cpu, 7, 3)
    assert ws.capacity == 3 and ws.words.shape == (4,)
    assert ws.ticket == ws.status + 8 * 3
    ws.epoch, ws.tickets = 5, 9
    assert _lookback.workspace(cpu, 7, 2) is ws        # enough tiles: kept
    assert _lookback.workspace(cpu, 8, 2) is not ws    # another stream
    grown = _lookback.workspace(cpu, 7, 4)
    assert grown is not ws and grown.capacity == 6
    assert (grown.epoch, grown.tickets) == (0, 0)
    assert not bool(grown.words.any())
    grown.words.fill_(-1)
    grown.epoch = _lookback.EPOCH_LIMIT
    assert _lookback.workspace(cpu, 7, 1) is grown
    assert grown.epoch == 0 and not bool(grown.words.any())


def test_compact_mask_refuses_what_the_kernel_cannot_take():
    with pytest.raises(TypeError, match="1-d bool"):
        kc.compact_mask(torch.zeros(4, dtype=torch.uint8))
    with pytest.raises(TypeError, match="1-d bool"):
        kc.compact_mask(torch.zeros((2, 2), dtype=torch.bool))


# ---------------------------------------------------------------------------
# (b) map_bytes' table mode
# ---------------------------------------------------------------------------

MAP_CASES = ["from_zero", "start_past_zero", "slack_after", "empty_rows",
             "odd_view", "no_rows"]


def _map_case(case: str):
    """(offsets int32 [n + 1], values uint8, where the rows' bytes are)."""
    rng = np.random.default_rng(len(case))
    lens = rng.integers(0, 40, 300)
    if case == "empty_rows":
        lens[::3] = 0
        lens[-5:] = 0
    if case == "no_rows":
        lens = lens[:0]
    start = 37 if case in ("start_past_zero", "odd_view") else 0
    slack = 29 if case in ("slack_after", "odd_view", "no_rows") else 0
    offs = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    offs += start
    total = int(offs[-1]) + slack
    text = np.frombuffer(b"acgtNRY09 ,|_-ACGTzZ@[`{\x80\xe9\xff",
                         np.uint8)
    vals = text[rng.integers(0, len(text), total + 3)]
    values = torch.from_numpy(vals)
    values = values[3:] if case == "odd_view" else values[:total]
    return torch.from_numpy(offs.astype(np.int32)), values


@pytest.mark.parametrize("fold", ["upper", "lower"])
@pytest.mark.parametrize("case", MAP_CASES)
def test_map_bytes_table_twin_matches_jax(case, fold):
    offs, values = _map_case(case)
    table = torch.from_numpy(UPPER if fold == "upper" else LOWER)
    n = offs.shape[0] - 1
    jcol = JVar(jnp.asarray(values.numpy()), jnp.asarray(offs.numpy()),
                jnp.ones(n, bool))
    folded = np.asarray(getattr(jstrings, fold)(jcol).values)
    lo, hi = int(offs[0]), int(offs[-1])
    want = np.zeros(values.shape[0], np.uint8)
    want[lo:hi] = folded[lo:hi]
    got = kmb.map_bytes_plain(offs, values, table, "table")
    np.testing.assert_array_equal(got.numpy(), want)
    # the CPU wrapper runs the twin
    assert torch.equal(kmb.map_bytes(offs, values, table, "table"), got)
    if case == "no_rows":
        assert not bool(got.any())


# ---------------------------------------------------------------------------
# (c) F33: grouped float MIN/MAX with NaN
# ---------------------------------------------------------------------------

F33_Q = ("SELECT k, COUNT(x) AS c, COUNT(*) AS n, MIN(x) AS lo, MAX(x) AS "
         "hi FROM t GROUP BY k ORDER BY k")


def _nan_table() -> pa.Table:
    """40,000 rows (5 memory batches) of 12 keys: key 3's values all NaN,
    keys 5 and 9 one NaN each (their first and last row), key 7's all
    NULL, the rest finite with 5 % NULL."""
    rng = np.random.default_rng(33)
    n = 40_000
    k = rng.integers(0, 12, n)
    x = rng.uniform(-1e3, 1e3, n)
    x[k == 3] = np.nan
    x[np.flatnonzero(k == 5)[0]] = np.nan
    x[np.flatnonzero(k == 9)[-1]] = np.nan
    valid = rng.random(n) > 0.05
    valid[k == 7] = False
    valid[np.flatnonzero(k == 5)[0]] = True
    valid[np.flatnonzero(k == 9)[-1]] = True
    return pa.table({"k": pa.array(k, pa.int64()),
                     "x": pa.array(x, pa.float64(), mask=~valid)})


def _same_with_nan(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None or g is None:
            assert g is None and w is None
        elif math.isnan(w):
            assert math.isnan(g)
        else:
            assert g == w


@pytest.mark.parametrize("where", ["one_device", "four_shards"])
def test_f33_float_min_max_nan_wins_as_in_jax(where):
    tab = _nan_table()
    jax_one = J.ExonSession.new_exon()
    jax_one.register_table("t", JMemTable(tab))
    want = jax_one.sql(F33_Q).collect_arrow()
    if where == "one_device":
        port = T.ExonSession(device="cpu")
    else:
        port = T.ExonSession.with_config_exon(
            t_config(distributed=True, n_shards=4), device="cpu")
    port.register_table("t", tab)
    df = port.sql(F33_Q)
    plan = df._execute(df.logical_plan())
    stack, routed = [plan], False
    while stack:
        p = stack.pop()
        routed |= isinstance(p, TD.DistributedAggregateExec)
        stack.extend(p.children())
    assert routed == (where == "four_shards")
    got = plan.collect_arrow()
    assert got.column_names == want.column_names
    for name in ("k", "c", "n"):
        assert got.column(name).to_pylist() == want.column(name).to_pylist()
    for name in ("lo", "hi"):
        _same_with_nan(got.column(name).to_pylist(),
                       want.column(name).to_pylist())
    lo = dict(zip(got.column("k").to_pylist(), got.column("lo").to_pylist()))
    hi = dict(zip(got.column("k").to_pylist(), got.column("hi").to_pylist()))
    for key in (3, 5, 9):                      # a NaN wins
        assert math.isnan(lo[key]) and math.isnan(hi[key])
    assert lo[7] is None and hi[7] is None     # no live value: NULL
    assert all(math.isfinite(lo[key]) and math.isfinite(hi[key])
               for key in (0, 1, 2, 4, 6, 8, 10, 11))
