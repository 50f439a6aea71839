"""expand_segments (K1c) and window_frame (K10b) of exon_tpu_torch held to
exon_tpu on the CPU, at the shapes of their Hopper designs.

(a) expand_segments now lays out its counts itself: ``expand_segments(lo,
counts, n_build)`` returns both index arrays, the offsets and the total.
Its twin (what the wrapper runs on the CPU) is held to
``exon_tpu.ops.layout.expand_segments`` (rid, intra, total), to the
exclusive starts ``ends - counts`` the JAX callers take, and to
``_jit_emit``'s build-index clip (join_exec.py:251), exactly: no rows, all
counts 0, counts of 0-3 at 1 to 131,073 rows (around the offsets tile of
1,024 rows), rows whose slots start just before, at and after every
multiple of the write pass's slot tile, a row of 2^20 slots, a batch where
most rows have no slot, and an empty build side (a JAX batch has a
capacity of at least 1, so its clip's top is 0, the port's). Then the four
callers through both packages' ``ExonSession.sql``, Arrow tables equal:
an inner join, a left join and a join under an ON residual over memory
tables (``JoinExec``), INTERSECT ALL and EXCEPT ALL (``RepeatExec``), a
filter over a GENCODE GFF3's attribute maps and a list UDF's output
(``take_list``), and the partitioned join on 4 shards
(``DistributedPartitionedJoinExec``; the JAX side on its 8-device mesh).

(b) window_frame now reads the column in its own width through perm,
counts COUNT(*) frames without a prefix, gallops for RANGE bounds and
loops over min/max frames of at most LOOP_ROWS rows. Window queries over a
memory table of 3,001 rows (not a multiple of the kernel's 1,024-row tile)
go through both ``ExonSession.sql``s: COUNT(*) and COUNT(col) over RANGE
frames with NULL keys first and last in a partition; ASC and DESC keys of
int64, float64 and float32; ROWS frames and lag/lead offsets just inside
and just past the 64-row halo; MAX and MIN over ROWS frames of up to 64
rows (and 65) with NaN and NULL values; partitions of one row and
partitions of ~1,500 rows that cross tiles; rank with peer groups across
tiles. Arrow tables equal, exactly (a NaN equals a NaN); where F22 makes
the JAX answer differ (SUM and AVG of a float32 column, which the JAX
package takes from float32 prefix differences and the port from float64
ones), at relative 1e-5.

(c) window_frame's wrapper on the kernel's path, its launch replaced by a
stub that unpacks the argument struct: Query L's four calls run no torch
op but their outputs' allocations (torch.profiler), COUNT(*) and the
looped MAX pass no prefix, and each function stages, widens and builds
what its design says.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
import jax.numpy as jnp
from exon_tpu.config import new_exon_config as j_config
from exon_tpu.ops.layout import expand_segments as j_expand
from exon_tpu.sql.frontend import MemTable as JMemTable
import exon_tpu_torch as T
from exon_tpu_torch.config import new_exon_config as t_config
from exon_tpu_torch.kernels import expand_segments as ke
from exon_tpu_torch.parallel import distributed as TD
from exon_tpu_torch.plan import physical as TP

BATCH = 512
F22_RTOL = 1e-5  # float32 SUM/AVG: JAX's float32 prefixes against float64


# ---------------------------------------------------------------------------
# (a) the expand chain
# ---------------------------------------------------------------------------


def _edges(d: int) -> np.ndarray:
    """Rows of one slot, then two rows of none and a row of 3 slots
    starting at k S + d, for the first five multiples of the slot tile."""
    out: list = []
    for k in range(1, 6):
        out += [1] * (k * ke.SLOT_TILE + d - sum(out)) + [0, 0, 3]
    return np.asarray(out)


def _counts(name: str) -> tuple:
    """(counts, n_build) of an expand case."""
    rng = np.random.default_rng(len(name))
    if name == "no rows":
        return np.zeros(0), 50
    if name == "all zero":
        return np.zeros(3000), 50
    if name.startswith("rows "):
        return rng.integers(0, 4, int(name.split()[1])), 900
    if name.startswith("tile edge"):
        return _edges(int(name.split()[-1])), 900
    if name == "2^20 slots":
        return np.array([0, 2, 1 << 20, 1, 0, 3]), 70
    if name == "sparse":
        return (rng.random(20_000) < 0.003) * rng.integers(1, 5, 20_000), 60
    assert name == "empty build side"
    return rng.integers(0, 4, 700), 0


EXPAND_CASES = (["no rows", "all zero"]
                + [f"rows {n}" for n in (1, 2, 5, 1023, 1024, 1025, 4097,
                                         131_073)]
                + ["tile edge -1", "tile edge 0", "tile edge 1",
                   "2^20 slots", "sparse", "empty build side"])


@pytest.mark.parametrize("name", EXPAND_CASES)
def test_expand_chain_matches_jax(name):
    counts, n_build = _counts(name)
    counts = counts.astype(np.int32)
    rng = np.random.default_rng(7)
    lo = rng.integers(0, max(n_build, 1), counts.shape[0]).astype(np.int32)
    probe, build, offsets, total = ke.expand_segments(
        torch.from_numpy(lo), torch.from_numpy(counts), n_build)
    ends = jnp.cumsum(jnp.asarray(counts), dtype=jnp.int32)
    rid, intra, jtotal = j_expand(jnp.asarray(counts), total)
    assert total == int(jtotal) == int(counts.sum())
    assert offsets.dtype == torch.int64 and offsets.shape == (len(counts) + 1,)
    assert offsets[:-1].numpy().tolist() == np.asarray(
        ends - jnp.asarray(counts)).tolist()
    assert int(offsets[-1]) == total
    assert probe.dtype == build.dtype == torch.int32
    assert probe.numpy().tolist() == np.asarray(rid).tolist()
    # _jit_emit: clip(lo[rid] + intra, 0, capacity - 1), capacity >= 1
    want = jnp.clip(jnp.asarray(lo)[rid] + intra, 0, max(n_build, 1) - 1)
    assert build.numpy().tolist() == np.asarray(want).tolist()


def test_expand_refuses_int32_totals():
    """Two rows of 2^30 slots: a total of 2^31 raises before anything is
    laid out, as the int32 indices cannot hold it."""
    counts = torch.tensor([1 << 30, 1 << 30], dtype=torch.int32)
    with pytest.raises(ValueError, match="exceed int32"):
        ke.expand_segments(torch.zeros(2, dtype=torch.int32), counts, 5)


def _join_tables():
    """Left keys 0-300 (a tenth NULL) against right keys 0-400, a few
    matches a key."""
    rng = np.random.default_rng(11)
    k = rng.integers(0, 300, 2500)
    left = pa.table({
        "k": pa.array([None if i % 10 == 0 else int(k[i])
                       for i in range(2500)], pa.int64()),
        "lv": pa.array(rng.integers(0, 1000, 2500).astype(np.int64))})
    right = pa.table({
        "k": pa.array(rng.integers(0, 400, 900).astype(np.int64)),
        "rv": pa.array(rng.integers(0, 1000, 900).astype(np.int64))})
    return left, right


def _register(sessions, tables: dict):
    for s in sessions:
        for name, t in tables.items():
            s.register_table(name, JMemTable(t)
                             if isinstance(s, J.ExonSession) else t)


@pytest.fixture(scope="module")
def one_device():
    """(port on the CPU, exon_tpu), l and r registered."""
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    left, right = _join_tables()
    _register((ts, js), {"l": left, "r": right})
    return ts, js


def _plain(v):
    """A value as a Python one; a NaN equals a NaN."""
    return "nan" if isinstance(v, float) and v != v else v


def _assert_equal(got: pa.Table, want: pa.Table, rtol: dict = None):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        assert [v is None for v in g] == [v is None for v in w], name
        if rtol and name in rtol:
            a = np.array([v for v in g if v is not None], np.float64)
            b = np.array([v for v in w if v is not None], np.float64)
            np.testing.assert_allclose(a, b, rtol=rtol[name], err_msg=name)
        else:
            assert [_plain(v) for v in g] == [_plain(v) for v in w], name


def _plan_has(df, cls) -> bool:
    stack = [df._execute(df.logical_plan())]
    while stack:
        p = stack.pop()
        if isinstance(p, cls):
            return True
        stack.extend(p.children())
    return False


CALLER_SQL = {
    "inner": "SELECT l.k, lv, rv FROM l JOIN r ON l.k = r.k",
    "left": "SELECT l.k, lv, rv FROM l LEFT JOIN r ON l.k = r.k",
    "residual": "SELECT l.k, lv, rv FROM l LEFT JOIN r ON l.k = r.k AND "
                "rv > lv",
    "intersect_all": "SELECT k FROM l WHERE lv < 700 INTERSECT ALL SELECT "
                     "k % 300 AS k FROM r",
    "except_all": "SELECT k FROM l EXCEPT ALL SELECT k FROM r WHERE rv < 500",
}


@pytest.mark.parametrize("name", list(CALLER_SQL))
def test_expand_callers_match_jax(one_device, name):
    ts, js = one_device
    q = CALLER_SQL[name]
    if name.endswith("_all"):
        assert _plan_has(ts.sql(q), TP.RepeatExec)
    got = ts.sql(q).collect_arrow()
    assert got.num_rows > 0
    _assert_equal(got, js.sql(q).collect_arrow())


@pytest.fixture(scope="module")
def gencode(tmp_path_factory):
    from benchlib.gencode_gff_fixture import make_gencode_gff

    path = make_gencode_gff(1500, seed=5, path=str(
        tmp_path_factory.mktemp("k1c") / "g.gff3"))
    out = []
    for s in (T.ExonSession(device="cpu", device_batch_size=BATCH),
              J.ExonSession.new_exon()):
        if isinstance(s, J.ExonSession):
            s.config.device_batch_size = BATCH
        s.sql(f"CREATE EXTERNAL TABLE genes STORED AS GFF LOCATION '{path}'")
        out.append(s)
    return out


LIST_SQL = {
    "attribute maps": "SELECT start, attributes FROM genes WHERE type = "
                      "'gene' AND start % 4 = 1",
    "list udf": "SELECT start, integer_encode_dna(seqname) AS c FROM genes "
                "WHERE strand = '-'",
}


@pytest.mark.parametrize("name", list(LIST_SQL))
def test_take_list_matches_jax(gencode, name):
    ts, js = gencode
    got = ts.sql(LIST_SQL[name]).collect_arrow()
    assert got.num_rows > 0
    _assert_equal(got, js.sql(LIST_SQL[name]).collect_arrow())


def test_partitioned_join_on_4_shards_matches_jax():
    """The partitioned join's owners lay out their candidate pairs with
    expand_segments: 4 shards of the port against the JAX package's
    distributed join and the port on one device."""
    left, right = _join_tables()
    q = "SELECT l.k, lv, rv FROM l JOIN r ON l.k = r.k AND rv < lv"
    jd = J.ExonSession.with_config_exon(j_config(
        distributed=True, device_batch_size=BATCH))
    td = T.ExonSession.with_config_exon(t_config(
        distributed=True, n_shards=4, device_batch_size=BATCH),
        device="cpu")
    one = T.ExonSession(device="cpu", device_batch_size=BATCH)
    _register((jd, td, one), {"l": left, "r": right})
    for s in (jd, td):
        s.sql("SET exon.partitioned_join = true").collect_arrow()
    TD.reset_stats()
    assert _plan_has(td.sql(q), TD.DistributedPartitionedJoinExec)
    got = td.sql(q).collect_arrow()
    assert got.num_rows > 0 and TD.exchanged_pairs > 0
    _assert_equal(got, jd.sql(q).collect_arrow())
    _assert_equal(one.sql(q).collect_arrow(), got)


# ---------------------------------------------------------------------------
# (b) window functions
# ---------------------------------------------------------------------------

N_WIN = 3001


def _window_table() -> pa.Table:
    """3,001 rows: p (two partitions of ~1,500 rows, then 1 row each for the
    last 40 rows), u (unique), order keys k (int64), kf (float32) and kd
    (float64) on a narrow span (ties; RANGE frames of several rows), each
    10 % NULL; t (8 values: peer groups of ~370 rows); values v (int64),
    vf (float32, 3 % NaN) and vd (float64), 10 % NULL."""
    rng = np.random.default_rng(19)
    n = N_WIN
    p = np.where(np.arange(n) < n - 40, rng.integers(0, 2, n),
                 np.arange(n) + 10)

    def nullable(x, frac=0.1):
        return pa.array(x, mask=rng.random(n) < frac)

    vf = rng.integers(-500, 500, n).astype(np.float32)
    vf[rng.random(n) < 0.03] = np.nan
    return pa.table({
        "p": pa.array(p.astype(np.int64)),
        "u": pa.array(np.arange(n, dtype=np.int64)),
        "k": nullable(rng.integers(0, 600, n).astype(np.int64)),
        "kf": nullable((rng.integers(0, 2400, n) / 4).astype(np.float32)),
        "kd": nullable(rng.integers(0, 2400, n) / 4),
        "t": pa.array(rng.integers(0, 8, n).astype(np.int64)),
        "v": nullable(rng.integers(-1000, 1000, n).astype(np.int64)),
        "vf": nullable(vf),
        "vd": nullable(rng.integers(-4000, 4000, n) / 8),
    })


@pytest.fixture(scope="module")
def win():
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    _register((ts, js), {"w": _window_table()})
    return ts, js


def _over(part: str, order: str, frame: str = "") -> str:
    return f"OVER (PARTITION BY {part} ORDER BY {order} {frame})".replace(
        "  ", " ").replace(" )", ")")


R5 = "RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING"
WINDOW_SQL = {
    # COUNT(*) and COUNT(col) over RANGE frames, NULL keys at either end
    "count_range_nulls_last": (
        f"SELECT u, COUNT(*) {_over('p', 'k NULLS LAST', R5)} AS c, "
        f"COUNT(v) {_over('p', 'k NULLS LAST', R5)} AS cv FROM w"),
    "count_range_nulls_first": (
        f"SELECT u, COUNT(*) {_over('p', 'k NULLS FIRST', R5)} AS c, "
        f"COUNT(vd) {_over('p', 'k DESC NULLS FIRST', R5)} AS cv FROM w"),
    # ASC and DESC keys of the three numeric types
    "range_int64_desc": (
        f"SELECT u, COUNT(*) {_over('p', 'k DESC', R5)} AS c, "
        f"MAX(v) {_over('p', 'k DESC', R5)} AS mx, "
        f"first_value(v) {_over('p', 'k DESC', R5)} AS fv FROM w"),
    "range_float64": (
        "SELECT u, COUNT(*) OVER (PARTITION BY p ORDER BY kd RANGE BETWEEN "
        "2 PRECEDING AND 3 FOLLOWING) AS c, SUM(vd) OVER (PARTITION BY p "
        "ORDER BY kd DESC RANGE BETWEEN 1 PRECEDING AND CURRENT ROW) AS s "
        "FROM w"),
    "range_float32": (
        "SELECT u, COUNT(*) OVER (PARTITION BY p ORDER BY kf RANGE BETWEEN "
        "4 PRECEDING AND 4 FOLLOWING) AS c, MIN(v) OVER (PARTITION BY p "
        "ORDER BY kf DESC RANGE BETWEEN 3 PRECEDING AND 1 FOLLOWING) AS mn, "
        "last_value(vd) OVER (PARTITION BY p ORDER BY kf RANGE BETWEEN "
        "CURRENT ROW AND 2 FOLLOWING) AS lv FROM w"),
    # ROWS frames and lag/lead offsets at the 64-row halo
    "halo_shift": (
        f"SELECT u, lag(v, 64) {_over('p', 'u')} AS l64, "
        f"lag(v, 65) {_over('p', 'u')} AS l65, "
        f"lead(vd, 64) {_over('p', 'u')} AS d64, "
        f"lead(vd, 65, -1.5) {_over('p', 'u')} AS d65 FROM w"),
    "halo_rows": (
        "SELECT u, COUNT(v) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN 64 "
        "PRECEDING AND 64 FOLLOWING) AS c, nth_value(v, 3) OVER (PARTITION "
        "BY p ORDER BY k ROWS BETWEEN 65 PRECEDING AND 2 PRECEDING) AS nv, "
        "first_value(vd) OVER (PARTITION BY p ORDER BY u ROWS BETWEEN 3 "
        "FOLLOWING AND 65 FOLLOWING) AS fv FROM w"),
    # MAX/MIN over ROWS frames of up to 64 rows (and 65), NaN and NULL
    "minmax_loop_nan": (
        "SELECT u, MAX(vf) OVER (PARTITION BY p ORDER BY k ROWS BETWEEN 5 "
        "PRECEDING AND 5 FOLLOWING) AS mx, MIN(vf) OVER (PARTITION BY p "
        "ORDER BY u ROWS BETWEEN 31 PRECEDING AND 32 FOLLOWING) AS mn, "
        "MAX(vd) OVER (PARTITION BY p ORDER BY u ROWS BETWEEN 63 PRECEDING "
        "AND CURRENT ROW) AS m64, MIN(v) OVER (PARTITION BY p ORDER BY u "
        "ROWS BETWEEN 64 PRECEDING AND CURRENT ROW) AS m65 FROM w"),
    "minmax_far_rows": (
        "SELECT u, MAX(vf) OVER (PARTITION BY p ORDER BY u ROWS BETWEEN 100 "
        "PRECEDING AND 90 PRECEDING) AS mx, MIN(vd) OVER (PARTITION BY p "
        "ORDER BY u ROWS BETWEEN 2 FOLLOWING AND 70 FOLLOWING) AS mn FROM w"),
    # partitions of one row, and partitions across tiles
    "one_row_partitions": (
        f"SELECT u, rank() {_over('u', 'k')} AS r, lag(v) {_over('u', 'k')}"
        f" AS lg, COUNT(*) {_over('u', 'k', R5)} AS c, "
        f"MAX(vf) OVER (PARTITION BY u ORDER BY k ROWS BETWEEN 1 PRECEDING "
        "AND 1 FOLLOWING) AS mx FROM w"),
    "rank_ties_across_tiles": (
        f"SELECT u, rank() {_over('p', 't')} AS r, "
        f"dense_rank() {_over('p', 't DESC')} AS dr, "
        f"row_number() {_over('p', 't')} AS rn, "
        f"percent_rank() {_over('p', 't')} AS pr, "
        f"cume_dist() {_over('p', 't')} AS cd, ntile(7) {_over('p', 't')} "
        "AS nt FROM w"),
    "default_frames": (
        f"SELECT u, COUNT(*) {_over('p', 'k')} AS c, MAX(vf) "
        f"{_over('p', 'k')} AS mx, first_value(vf) {_over('p', 'kf DESC')} "
        "AS fv, AVG(vd) OVER (PARTITION BY p) AS a FROM w"),
    # F22: SUM/AVG of float32, float32 prefixes in the JAX package
    "f22_float32_sum": (
        "SELECT u, SUM(vf) OVER (PARTITION BY p ORDER BY u ROWS BETWEEN 5 "
        "PRECEDING AND 5 FOLLOWING) AS s, AVG(vf) OVER (PARTITION BY p "
        "ORDER BY k RANGE BETWEEN 5 PRECEDING AND 5 FOLLOWING) AS a FROM w"),
}
F22_COLUMNS = {"f22_float32_sum": {"s": F22_RTOL, "a": F22_RTOL}}


@pytest.mark.parametrize("name", list(WINDOW_SQL))
def test_window_queries_match_jax(win, name):
    ts, js = win
    got = ts.sql(WINDOW_SQL[name]).collect_arrow()
    assert got.num_rows == N_WIN
    _assert_equal(got, js.sql(WINDOW_SQL[name]).collect_arrow(),
                  F22_COLUMNS.get(name))


# ---------------------------------------------------------------------------
# (c) window_frame's wrapper on the kernel's path
# ---------------------------------------------------------------------------


def _kernel_path(monkeypatch):
    """window_frame's CUDA path on CPU tensors: the launch is replaced by a
    stub that records the argument struct, unpacked as the kernel reads
    it."""
    from exon_tpu_torch.kernels import window_frame as kwf

    launched = []

    class Library:
        def exon_window_frame(self, args, stream):
            launched.append(dict(zip(_ARG_NAMES, kwf._ARGS.unpack(args))))
            return 0

    monkeypatch.setattr(kwf._build, "on_cuda", lambda t, name: True)
    monkeypatch.setattr(kwf._build, "library", Library)
    monkeypatch.setattr(kwf._build, "stream_of", lambda t: 0)
    return kwf, launched


_ARG_NAMES = (
    "seg_start", "seg_end", "peer_first", "peer_last", "perm", "values",
    "valid", "cnt", "sum", "dense", "table", "key", "key_valid", "out",
    "out_valid", "n", "offset", "lo_off", "hi_off", "default_word", "mode",
    "fn", "frame", "lo_unbounded", "hi_unbounded", "column", "is_float",
    "key_kind", "levels", "loop", "has_default", "stage")


def test_query_l_calls_run_no_torch_op(monkeypatch):
    """Query L's four calls reach the launch with no torch op but the two
    output allocations (no widening, gather, cast or prefix sum): COUNT(*)
    over RANGE 35 passes no count prefix and stages its keys, lag(pos) and
    MAX(qual) over ROWS 5/5 pass the column in its own width and stage it
    (MAX looping, no sparse table), rank stages nothing."""
    from torch.profiler import ProfilerActivity, profile

    from exon_tpu_torch.plan import window_exec as TW
    from exon_tpu_torch.plan.expressions import ColumnRef, WindowCall

    rng = np.random.default_rng(3)
    n = 5000
    table = pa.table({
        "chrom": pa.array(np.sort(rng.integers(0, 3, n)).astype(np.int64)),
        "pos": pa.array(np.sort(rng.integers(0, 10**6, n)).astype(np.int64)),
        "qual": pa.array(rng.integers(10, 4000, n).astype(np.float32),
                         mask=rng.random(n) < 0.1)})
    ts = T.ExonSession(device="cpu")
    ts.register_table("v", table)
    df = ts.sql("SELECT chrom, pos, qual FROM v")
    batch = next(iter(df._execute(df.logical_plan()).batches()))
    c = ColumnRef
    by_pos = WindowCall("count", None, [c("chrom")], [(c("pos"), True)],
                        frame=("range", -35, 35))
    perm, bounds = TW._sorted_bounds(by_pos, batch)
    qperm, qbounds = TW._sorted_bounds(WindowCall(
        "rank", None, [c("chrom")], [(c("qual"), False)]), batch)
    rng35 = TW._frame(by_pos, batch, perm)
    pos, qual = batch.column("pos"), batch.column("qual")
    kwf, launched = _kernel_path(monkeypatch)
    calls = [("count", bounds, perm, None, None, rng35),
             ("lag", bounds, perm, pos.values, pos.validity, None),
             ("max", bounds, perm, qual.values, qual.validity,
              kwf.Frame(kwf.ROWS, -5, 5)),
             ("rank", qbounds, qperm, None, None, None)]
    for fn, b, p, vals, ok, fr in calls:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            kwf.window_frame(fn, b, p, vals, ok, fr)
        ops = {e.key for e in prof.key_averages()}
        assert ops <= {"aten::empty", "aten::view"}, (fn, ops)
    count, lag, mx, rank = launched
    assert count["cnt"] == 0 and count["stage"] == 2 and count["key"] != 0
    assert lag["stage"] == 1 and lag["column"] == 0 and lag["cnt"] == 0
    assert mx["loop"] == 1 and mx["table"] == 0 and mx["cnt"] == 0
    assert mx["stage"] == 1 and mx["column"] == 2 and mx["is_float"] == 1
    assert rank["stage"] == 0 and rank["values"] == 0
    assert [a["n"] for a in launched] == [n] * 4


def test_kernel_path_builds_the_prefixes_it_needs(monkeypatch):
    """COUNT of a column passes the valid count; sum passes it and the
    float64 sum; min over a RANGE frame the sparse table and the count;
    dense_rank its peer starts; an unsupported column type (float16) is
    widened first; lag past the halo and a ROWS frame past it stage no
    values."""
    kwf, launched = _kernel_path(monkeypatch)
    n = 300
    rng = np.random.default_rng(4)
    b = tuple(torch.zeros(n, dtype=torch.int32) for _ in range(4))
    perm = torch.arange(n)
    vals = torch.from_numpy(rng.random(n).astype(np.float32))
    ok = torch.ones(n, dtype=torch.bool)
    key = torch.arange(n, dtype=torch.int64)
    rng_fr = kwf.Frame(kwf.RANGE, -3, 3, key, ok)
    kwf.window_frame("count", b, perm, vals, ok, kwf.Frame(kwf.ROWS, -2, 2))
    kwf.window_frame("sum", b, perm, vals, ok, kwf.Frame(kwf.ROWS, -2, 2))
    kwf.window_frame("min", b, perm, vals, ok, rng_fr)
    kwf.window_frame("dense_rank", b, perm)
    kwf.window_frame("lag", b, perm, vals.half(), ok, offset=65)
    kwf.window_frame("first_value", b, perm, vals, ok,
                     kwf.Frame(kwf.ROWS, 70, 80))
    count, total, mn, dense, lag, first = launched
    assert count["cnt"] != 0 and count["sum"] == 0
    assert total["cnt"] != 0 and total["sum"] != 0 and total["is_float"] == 1
    assert mn["table"] != 0 and mn["cnt"] != 0 and mn["loop"] == 0
    assert mn["levels"] == n.bit_length() and mn["stage"] == 2
    assert dense["dense"] != 0 and dense["mode"] == 0
    assert lag["column"] == 1 and lag["stage"] == 0 and lag["offset"] == 65
    assert first["stage"] == 0 and first["lo_off"] == 70
