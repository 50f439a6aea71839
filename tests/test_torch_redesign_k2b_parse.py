"""The twins of parse_number (CAST utf8 -> number) and string_eq (K2b) held
to exon_tpu at the shapes their Hopper kernels' designs must survive;
test_torch_kernels.py holds the kernels to the twins on the same cases on a
card.

(a) parse_number stages a 256-row tile's rows that fit the window (20
bytes for int, 64 for float) in 16-byte words and parses each row in one
pass, finding the first '.' and 'e' as it goes. Its twin equals
exon_tpu/plan/expressions.py _cast_utf8_to_number for int64 and float64
targets on ``numeral_case``'s cases: no rows, empty strings and NULL rows,
signs, leading zeros, '.5', '5.', '1e5', '1E-5', '1e+', 'e5', the rows the
one-pass rule must reject as the two passes do ('1.2.3', '1e5.2', '1e5e2',
'.e1'), rows of 20 and 21 bytes and of 64 and 65, mantissas of 18, 19 and
25 significant digits behind leading zeros, exponents near +-308 and
'1e400', offsets past 0 with values past the last row, 1 to 131,073 rows
and a 10,000-byte row among short ones. Where the JAX answer differs, both
answers are asserted: F10's integers of 20 significant digits or outside
int64 (the JAX sum clips its power of ten at 10^18 and wraps; the port is
NULL), and subnormal float results, which the JAX package on the CPU
flushes to zero. Then CAST to BIGINT and DOUBLE over a memory table and
SQL_gff's query over a GFF through both packages' ExonSession.sql.
(b) string_eq reads both rows of a pair as 16-byte words, 64 bytes a row a
step. Its twin equals exon_tpu/plan/expressions.py _string_col_eq over the
pairs' rows on ``eq_case``'s cases (NULL against empty, equal lengths that
differ only at bytes 0-65 and the last, rows at every alignment in each
column, a values buffer that ends at the last row, offsets past 0,
repeated indices, no pairs, long keys) and Python's bytes equality, except
where F6 makes the JAX answer differ: rows that agree in their first 32
bytes and their length are equal to JAX however they differ later. Then a
join on a string key, a GROUP BY over string keys past 32 bytes and a
two-column string compare (F6, both answers) through both sessions.
Every comparison is exact."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import exon_tpu as J
import exon_tpu_torch as T
import jax.numpy as jnp
from benchlib.gff_fixture import make_gff
from exon_tpu.batch import VarColumn as JVarColumn
from exon_tpu.plan import expressions as jexpr
from exon_tpu.sql.frontend import MemTable as JMemTable
from exon_tpu_torch.kernels import parse_number as kp
from exon_tpu_torch.kernels import string_eq as ks
from test_torch_kernels import (EQ_CASES, NUMERAL_CASES, _f10_int, eq_case,
                                eq_truth, numeral_case)

BATCH = 700
TINY = np.finfo(np.float64).tiny


def _jvar(offs, vals, valid):
    return JVarColumn(jnp.asarray(vals), jnp.asarray(offs),
                      jnp.asarray(valid))


# ---------------------------------------------------------------------------
# (a) parse_number
# ---------------------------------------------------------------------------


def _jax_int(s: str) -> int:
    """The JAX integer sum of a numeral: digit * 10^clip(len - 1 - p, 0,
    18), negated after a '-', wrapped to int64 (F10)."""
    neg = s.startswith("-")
    total = sum(int(c) * 10 ** min(len(s) - 1 - p, 18)
                for p, c in enumerate(s) if p >= int(neg))
    total = -total if neg else total
    return (total + 2 ** 63) % 2 ** 64 - 2 ** 63


def _parse(case: str, floating: bool):
    strs, offs, vals, valid = numeral_case(case)
    got, ok = kp.parse_number(torch.from_numpy(offs), torch.from_numpy(vals),
                              torch.from_numpy(valid), floating)
    want = jexpr._cast_utf8_to_number(_jvar(offs, vals, valid),
                                      np.float64 if floating else np.int64)
    return (strs, valid, got.numpy(), ok.numpy(), np.asarray(want.values),
            np.asarray(want.validity))


@pytest.mark.parametrize("case", NUMERAL_CASES)
def test_parse_number_int_twin_matches_jax(case):
    strs, valid, got, ok, w_val, w_ok = _parse(case, False)
    assert got.dtype == np.int64 and got.shape == ok.shape == (len(strs),)
    f10 = np.array([_f10_int(s) for s in strs], bool) & valid
    # F10: NULL in the port, the clipped and wrapped sum in JAX
    assert not ok[f10].any()
    assert w_ok[f10].all()
    assert [int(v) for v in w_val[f10]] == \
        [_jax_int(strs[i]) for i in np.flatnonzero(f10)]
    keep = ~f10
    assert (ok[keep] == w_ok[keep]).all()
    assert (got[keep & ok] == w_val[keep & ok]).all()
    assert (got[~ok] == 0).all()
    assert [int(v) for v in got[ok]] == \
        [int(strs[i]) for i in np.flatnonzero(ok)]


@pytest.mark.parametrize("case", NUMERAL_CASES)
def test_parse_number_float_twin_matches_jax(case):
    strs, valid, got, ok, w_val, w_ok = _parse(case, True)
    assert got.dtype == np.float64 and got.shape == (len(strs),)
    assert (ok == w_ok).all()
    # a subnormal result: kept by the twin (IEEE division), flushed to
    # zero by the JAX package on the CPU
    sub = ok & (got != 0) & (np.abs(got) < TINY)
    assert (w_val[sub] == 0).all()
    # JAX leaves an invalid row's value unmasked; the twin writes 0
    same = ok & ~sub
    assert (got[same].view(np.int64) == w_val[same].view(np.int64)).all()
    assert (got[~ok] == 0).all()


def test_parse_number_one_pass_rejections():
    """The rows one pass must reject as the JAX masks do, and the forms it
    must accept, by value."""
    strs = ["1.2.3", "1e5.2", "1e5e2", ".e1", "1e+", "e5", "1+e5", "..5",
            ".5", "5.", "1e5", "1E-5", "-0", "+.5e+1", "1.e3"]
    enc = [s.encode() for s in strs]
    offs = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    vals = np.frombuffer(b"".join(enc), np.uint8).copy()
    got, ok = kp.parse_number(torch.from_numpy(offs), torch.from_numpy(vals),
                              torch.ones(len(enc), dtype=torch.bool), True)
    assert ok.tolist() == [False] * 8 + [True] * 7
    assert got.tolist() == [0.0] * 8 + [0.5, 5.0, 1e5, 1e-5, -0.0, 5.0,
                                        1000.0]


def _numeral_table() -> pa.Table:
    """Every case's numerals (a tenth NULL) but F10's integers and the
    numerals whose double is subnormal, the two differences the twin tests
    assert with both answers."""
    rng = np.random.default_rng(3)
    rows = []
    for case in NUMERAL_CASES:
        if case == "rows 131073":
            continue
        strs = numeral_case(case)[0]
        enc = [s.encode() for s in strs]
        offs = np.zeros(len(enc) + 1, np.int32)
        np.cumsum([len(e) for e in enc], out=offs[1:])
        vals = np.frombuffer(b"".join(enc), np.uint8).copy()
        dbl, _ok = kp.parse_number(torch.from_numpy(offs),
                                   torch.from_numpy(vals),
                                   torch.ones(len(enc), dtype=torch.bool),
                                   True)
        sub = (dbl != 0) & (dbl.abs() < TINY)
        rows += [s for s, u in zip(strs, sub.tolist())
                 if not u and not _f10_int(s)]
    return pa.table({
        "id": pa.array(np.arange(len(rows)), pa.int64()),
        "s": pa.array([None if rng.random() < 0.1 else s for s in rows],
                      pa.string())})


@pytest.fixture(scope="module")
def sessions():
    """(port on the CPU, exon_tpu), with the numeral table ``nums``."""
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    table = _numeral_table()
    ts.register_table("nums", table)
    js.register_table("nums", JMemTable(table))
    return ts, js


def _assert_equal(got: pa.Table, want: pa.Table) -> None:
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name).to_pylist(), want.column(name).to_pylist()
        assert [v is None for v in g] == [v is None for v in w], name
        assert [v if v == v else "nan" for v in g] == \
            [v if v == v else "nan" for v in w], name


@pytest.mark.parametrize("sql", [
    "SELECT id, CAST(s AS BIGINT) AS i, CAST(s AS DOUBLE) AS d FROM nums",
    "SELECT COUNT(CAST(s AS BIGINT)) AS n, SUM(CAST(s AS BIGINT) % 1000) "
    "AS t, COUNT(CAST(s AS DOUBLE)) AS m FROM nums",
    "SELECT id, s FROM nums WHERE CAST(s AS DOUBLE) > 1.5 ORDER BY id"])
def test_cast_over_a_memory_table_matches_jax(sessions, sql):
    ts, js = sessions
    got = ts.sql(sql).collect_arrow()
    assert got.num_rows > 0
    _assert_equal(got, js.sql(sql).collect_arrow())


def test_sql_gff_cast_round_trip_matches_jax(tmp_path):
    """SQL_gff's query (CAST of start and end to text and back to BIGINT
    and DOUBLE, summed by seqname and strand) over a GFF read in 700-row
    batches."""
    path = make_gff(3000, 7, path=str(tmp_path / "g.gff"))
    sql = ("SELECT seqname, CASE WHEN strand = '+' THEN 'fwd' ELSE 'rev' END "
           "AS dir, COUNT(*) AS n, SUM(CAST(CAST(start AS VARCHAR) AS BIGINT))"
           " AS s, SUM(CAST(CAST(\"end\" AS VARCHAR) AS DOUBLE)) AS e FROM "
           "genes WHERE type = 'exon' GROUP BY seqname, dir ORDER BY seqname,"
           " dir")
    out = []
    for s in (T.ExonSession(device="cpu", device_batch_size=BATCH),
              J.ExonSession.new_exon()):
        if isinstance(s, J.ExonSession):
            s.config.device_batch_size = BATCH
        s.sql(f"CREATE EXTERNAL TABLE genes STORED AS GFF LOCATION '{path}'")
        out.append(s.sql(sql).collect_arrow())
    assert out[0].num_rows > 1
    _assert_equal(*out)


# ---------------------------------------------------------------------------
# (b) string_eq
# ---------------------------------------------------------------------------


def _taken(col, idx):
    """The rows idx of a numpy column as a new (offsets, values,
    validity)."""
    offs, vals, valid = col
    rows = [vals[offs[i]:offs[i + 1]].tobytes() for i in idx]
    out = np.zeros(len(rows) + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=out[1:])
    return out, np.frombuffer(b"".join(rows), np.uint8).copy(), valid[idx]


def _f6(a, ia, b, ib) -> np.ndarray:
    """Pairs JAX calls equal that are not: both valid, one length, the same
    first 32 bytes, a difference after them."""
    out = []
    for i, j in zip(ia, ib):
        ra = a[1][a[0][i]:a[0][i + 1]].tobytes()
        rb = b[1][b[0][j]:b[0][j + 1]].tobytes()
        out.append(bool(a[2][i] and b[2][j] and len(ra) == len(rb)
                        and ra[:32] == rb[:32] and ra != rb))
    return np.array(out, bool)


@pytest.mark.parametrize("case", EQ_CASES)
def test_string_eq_twin_matches_jax(case):
    a, ia, b, ib = eq_case(case)
    got = ks.string_eq(tuple(torch.from_numpy(t) for t in a),
                       torch.from_numpy(ia),
                       tuple(torch.from_numpy(t) for t in b),
                       torch.from_numpy(ib)).numpy()
    assert got.dtype == bool and got.shape == (len(ia),)
    assert (got == eq_truth(a, ia, b, ib)).all()
    if not len(ia):
        return
    want = np.asarray(jexpr._string_col_eq(_jvar(*_taken(a, ia)),
                                           _jvar(*_taken(b, ib))))
    f6 = _f6(a, ia, b, ib)
    # F6: JAX compares 32 bytes and the length
    assert want[f6].all() and not got[f6].any()
    assert (got[~f6] == want[~f6]).all()
    if case in ("differ at", "long keys"):
        assert f6.any()


def _key(rng, prefix: bytes, n: int) -> list:
    """n keys of 33-80 bytes after a shared 40-byte prefix, so that two
    keys agree in their first 32 bytes."""
    return [(prefix + bytes(rng.integers(65, 91, int(k), dtype=np.uint8))
             ).decode() for k in rng.integers(0, 41, n)]


@pytest.fixture(scope="module")
def key_sessions():
    """(port on the CPU, exon_tpu) with tables l and r keyed by long
    strings, and p of string pairs."""
    rng = np.random.default_rng(9)
    keys = _key(rng, b"chr1:" + b"N" * 35, 300) + ["", "short", "x" * 31]
    lk = [keys[i] for i in rng.integers(0, len(keys), 2000)]
    left = pa.table({
        "li": pa.array(np.arange(2000), pa.int64()),
        "k": pa.array([None if i % 11 == 0 else k for i, k in enumerate(lk)],
                      pa.string()),
        "lv": pa.array(rng.integers(0, 1000, 2000).astype(np.int64))})
    rk = [keys[i] for i in rng.integers(0, len(keys), 700)]
    right = pa.table({
        "ri": pa.array(np.arange(700), pa.int64()),
        "k": pa.array(rk, pa.string()),
        "rv": pa.array(rng.integers(0, 1000, 700).astype(np.int64))})
    a = _key(rng, b"M" * 40, 1500)
    b = [s if rng.random() < 0.5 else s[:-1] + chr(ord(s[-1]) ^ 1)
         if rng.random() < 0.5 else s[:20] + "?" + s[21:] for s in a]
    pairs = pa.table({"id": pa.array(np.arange(1500), pa.int64()),
                      "a": pa.array(a, pa.string()),
                      "b": pa.array(b, pa.string())})
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    for name, t in (("l", left), ("r", right), ("p", pairs)):
        ts.register_table(name, t)
        js.register_table(name, JMemTable(t))
    return ts, js, pairs


@pytest.mark.parametrize("sql", [
    "SELECT li, ri, l.k, lv, rv FROM l JOIN r ON l.k = r.k ORDER BY li, ri",
    "SELECT li, ri, l.k, lv, rv FROM l LEFT JOIN r ON l.k = r.k ORDER BY li,"
    " ri",
    "SELECT k, COUNT(*) AS n, SUM(lv) AS s FROM l GROUP BY k ORDER BY k",
    "SELECT COUNT(DISTINCT k) AS n FROM l"])
def test_string_keys_match_jax(key_sessions, sql):
    ts, js, _pairs = key_sessions
    got = ts.sql(sql).collect_arrow()
    assert got.num_rows > 0
    _assert_equal(got, js.sql(sql).collect_arrow())


def test_two_column_compare_f6(key_sessions):
    """WHERE a = b over pairs that are equal, differ in their last byte or
    differ at byte 20: Python's rows in the port; in JAX also the pairs
    that differ only past byte 32 (F6)."""
    ts, js, pairs = key_sessions
    sql = "SELECT id FROM p WHERE a = b ORDER BY id"
    got = ts.sql(sql).collect_arrow().column(0).to_pylist()
    want = js.sql(sql).collect_arrow().column(0).to_pylist()
    a, b = pairs.column("a").to_pylist(), pairs.column("b").to_pylist()
    assert got == [i for i in range(len(a)) if a[i] == b[i]]
    f6 = [i for i in range(len(a)) if a[i] != b[i] and a[i][:32] == b[i][:32]]
    assert f6 and want == sorted(got + f6)
