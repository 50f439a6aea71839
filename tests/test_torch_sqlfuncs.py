"""The SQL functions of exon_tpu_torch (ops/sqlfuncs.py) against exon_tpu's.

The strings of the JAX package's own tests ('Hello World', '  pad  ',
'abcabc'), which those tests hold in memory tables, sit here in a small
FASTA file, as ids, descriptions and sequences,
with empty strings, NULL descriptions, multi-byte UTF-8 and rows past 64
bytes. Each case runs one query through ``exon_tpu.ExonSession.sql`` and
``exon_tpu_torch.ExonSession(device="cpu").sql`` (the kernels' plain twins)
and requires equal Arrow tables: equal types, NULLs and values, strings
byte for byte, floats bit for bit.

(a) Every name that exon_tpu/ops/sqlfuncs.py ``_register_all`` registers
    is called by some case (``test_every_registered_name_is_covered``).
    ``random`` and ``uuid`` are checked for type, range and shape only.
(b) The edge cases: substr starts <= 0, left/right with negative k, rows
    made only of trim bytes, multi-byte trim and pad sets, lpad cutting a
    row, repeat 0, translate deleting bytes, concat_ws with NULLs in every
    position, || with a NULL literal, an empty strpos needle, a string
    coalesce over three columns.
(c) Column = and != on strings, an ordered compare of two string columns
    (PlanError in both), CREATE FUNCTION (PlanError in both).
(d) Queries J and K of the smoke at a small size, and the JAX answers the
    port copies or does not (ROADMAP Queue 3): F8 (a NULL row passes the
    JAX != of two columns), F16 (a string function of literals only over a
    table), F17 (byte-level substr/trim on multi-byte UTF-8), F18 (the
    median of integers rounds half to even).

Tolerance: exact, except the transcendental math functions (sqrt, exp,
ln, log, log2, log10, the trigonometric and hyperbolic functions and their
inverses, cbrt, power with a fractional exponent, log with a base) and
degrees/radians of a product with a constant: relative 1e-15 (about 4.5
ulp). XLA's CPU routines and torch's round some results differently in the
last bit, and XLA folds a division by a constant into a multiplication by
its reciprocal and a product of two constants into one; neither library
rounds these functions correctly, so no exact twin exists. (round and
trunc multiply by the reciprocal as XLA does, and are exact.)
"""

import re

import numpy as np
import pyarrow as pa
import pytest

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.fasta_records import fasta_records
from benchlib.fastq_fixture import make_fastq
from benchlib.gff_fixture import make_gff
from exon_tpu.plan import expressions as JE
from exon_tpu_torch.plan import expressions as TE

BATCH = 700
MATH_RTOL = 1e-15
ADAPTER = "AGATCGGAAGAGC"

# (id, description or None for NULL, sequence)
STRINGS = [
    ("Hello", "Hello World", "ACGTNNNN"),
    ("pad", "  pad  ", "aaaAAA"),
    ("abcabc", "abcabc", ""),
    ("x1", None, "NNNACGTNNN"),
    ("ümlaut", "naïve café ☃ é", "ÄÖÜ"),
    ("long", "x" * 80 + " word-two three_four", "ACGT" * 30),
    ("aa", "aaaa", "aa"),
    ("sp|P000001|PROT1", "synthetic protein 99999", "MKKAGATCGGAAGAGCNN"),
    ("sp|P100000|PROT100000", "synthetic protein 100000", "AGATCGGAAGAGC"),
    ("e", " ", "NNNN"),
    ("b7", None, "GATTACA"),
    ("é", "ééé", "N"),
]


def _write_strings(path) -> str:
    with open(path, "w", encoding="utf-8") as f:
        for i, d, s in STRINGS:
            f.write(f">{i}" + ("" if d is None else f" {d}") + f"\n{s}\n")
    return str(path)


def _write_sprot(path, idx) -> str:
    """Records of benchlib.fixtures.make_fasta's shape, for record numbers
    ``idx`` (spread over 0-599,999, so substr(id, 5, 2) makes 60 groups):
    ``>sp|P%06d|PROT%d synthetic protein %d`` and a protein sequence."""
    flat, offs = fasta_records(len(idx), mean_len=130, seed=8)
    with open(path, "wb") as f:
        for k, i in enumerate(idx):
            f.write(b">sp|P%06d|PROT%d synthetic protein %d\n%s\n"
                    % (i, i, i, flat[offs[k]:offs[k + 1]].tobytes()))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sqlfuncs")
    rng = np.random.default_rng(8)
    idx = np.sort(rng.choice(600_000, 900, replace=False))
    return {
        "s": _write_strings(d / "s.fasta"),
        "fa": _write_sprot(d / "a.fasta", idx.tolist()),
        "fq": make_fastq(1500, seed=4, path=str(d / "q.fastq")),
        "gff": make_gff(1500, seed=5, path=str(d / "g.gff3")),
    }


@pytest.fixture(scope="module")
def sessions(files):
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    for s in (ts, js):
        for name, fmt, key in (("s", "FASTA", "s"), ("fa", "FASTA", "fa"),
                               ("fq", "FASTQ", "fq"), ("genes", "GFF", "gff")):
            s.sql(f"CREATE EXTERNAL TABLE {name} STORED AS {fmt} "
                  f"LOCATION '{files[key]}'")
    yield ts, js


def _values(col) -> list:
    """A column's values; strings as bytes (a byte-level slice of a
    multi-byte character is not UTF-8), floats as their bits."""
    if pa.types.is_string(col.type):
        col = col.cast(pa.binary())
    vals = col.to_pylist()
    if pa.types.is_floating(col.type):
        vals = [None if v is None else np.float64(v).tobytes() for v in vals]
    return vals


def assert_tables_equal(got, want, rtol: float = 0.0) -> None:
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        if rtol and pa.types.is_floating(w.type):
            np.testing.assert_allclose(
                np.asarray(g.fill_null(0).to_pylist(), np.float64),
                np.asarray(w.fill_null(0).to_pylist(), np.float64),
                rtol=rtol, atol=rtol, err_msg=name)
        else:
            assert _values(g) == _values(w), name


# (id, SQL, relative tolerance of float results)
QUERIES = [
    # -- strings on the kernels ---------------------------------------------
    ("case_folds", "SELECT upper(description) AS u, lower(description) AS l, "
     "upper(id) AS ui, lower(sequence) AS ls FROM s", 0),
    ("lengths", "SELECT octet_length(description) AS o, bit_length(id) AS b, "
     "octet_length(sequence) AS os FROM s", 0),
    ("substr", "SELECT substr(description, 2, 3) AS a, substr(description, "
     "-1, 4) AS b, substr(description, 0, 2) AS c, substr(description, 3) AS "
     "d, substring(id, 2) AS e, substring(id FROM 2 FOR 3) AS f FROM s", 0),
    ("substr_edges", "SELECT substr(description, 5, -2) AS a, "
     "substr(description, 100, 2) AS b, substr(id, 2, 0) AS c, substr(id, "
     "-5) AS d, substr(sequence, 1, length(sequence) - 2) AS e FROM s", 0),
    ("left_right", "SELECT left(description, 3) AS a, right(description, 3) "
     "AS b, left(description, -2) AS c, right(description, -2) AS d, "
     "left(id, 0) AS e, right(id, 100) AS f, left(id, -100) AS g FROM s", 0),
    ("reverse", "SELECT reverse(description) AS a, reverse(id) AS b, "
     "reverse(sequence) AS c FROM s", 0),
    ("trim_space", "SELECT trim(description) AS a, ltrim(description) AS b, "
     "rtrim(description) AS c, btrim(description) AS d, trim(BOTH FROM "
     "description) AS e, trim(LEADING FROM description) AS f FROM s", 0),
    ("trim_sets", "SELECT trim(description, 'a') AS a, ltrim(sequence, 'N') "
     "AS b, rtrim(sequence, 'N') AS c, trim(sequence, 'aA') AS d, "
     "btrim(id, 'ae') AS e FROM s", 0),
    ("trim_all_trim_rows", "SELECT rtrim(sequence, 'N') AS a, ltrim("
     "sequence, 'N') AS b, trim(description, 'a') AS c, "
     "trim(description, ' ') AS e FROM s WHERE id IN ('aa', 'e', 'é')", 0),
    ("trim_multibyte_sets", "SELECT trim(description, 'é') AS a, "
     "rtrim(description, '☃ é') AS b, ltrim(description, 'nï') AS c, "
     "trim(id, '') AS d FROM s", 0),
    ("strpos", "SELECT strpos(description, 'l') AS a, instr(sequence, 'ACGT') "
     "AS b, position('|' IN id) AS c, strpos(description, '') AS d, "
     "strpos(description, 'é') AS e, strpos(sequence, 'AGATCGGAAGAGC') AS f "
     "FROM s", 0),
    ("prefix_predicates", "SELECT starts_with(description, 'He') AS a, "
     "ends_with(description, 'bc') AS b, contains(description, 'World') AS c, "
     "starts_with(id, '') AS d, contains(description, '') AS e, "
     "ends_with(sequence, 'NN') AS f FROM s", 0),
    ("predicates_in_where", "SELECT id FROM s WHERE starts_with(id, 'sp') OR "
     "contains(description, 'pad') OR ends_with(sequence, 'NN')", 0),
    ("concat", "SELECT description || '!' AS a, id || description AS b, "
     "concat(description, '-', 'x') AS c, concat(id, description, sequence) "
     "AS d, concat(NULL, 'x', description) AS e FROM s", 0),
    ("concat_null_literal", "SELECT NULL || id AS a, id || NULL AS b, "
     "concat(NULL) AS c FROM s", 0),
    ("concat_ws", "SELECT concat_ws('|', description, id) AS a, "
     "concat_ws('/', id, description) AS b, concat_ws('--', description, "
     "description, id) AS c, concat_ws(',', id) AS d FROM s", 0),
    ("concat_ws_nulls", "SELECT concat_ws('|', NULL, description) AS a, "
     "concat_ws('|', description, NULL, id) AS b, concat_ws('|', id, "
     "description) AS c, concat_ws('|', description, description) AS d, "
     "concat_ws('|', description, id, description) AS e, concat_ws('|', "
     "nullif(id, 'pad'), description, nullif(sequence, '')) AS f FROM s", 0),
    ("repeat", "SELECT repeat(id, 3) AS a, repeat(description, 0) AS b, "
     "repeat(sequence, 1) AS c, repeat(description, 2) AS d FROM s", 0),
    ("pad", "SELECT lpad(trim(description), 8, '*') AS a, rpad(trim("
     "description), 8, '*') AS b, lpad(id, 10) AS c, rpad(id, 10) AS d, "
     "lpad(id, 9, 'xy') AS e, rpad(id, 9, 'xyz') AS f FROM s", 0),
    ("pad_edges", "SELECT lpad(id, 0, '*') AS a, rpad(id, -3) AS b, "
     "lpad(description, 5, '') AS c, lpad(id, 12, 'é') AS d, rpad(description,"
     " 3, 'é☃') AS e, lpad(description, 90, 'ab') AS f FROM s", 0),
    ("translate", "SELECT translate(description, 'lo', 'LO') AS a, "
     "translate(description, 'ael', 'A') AS b, translate(sequence, 'ACGT', "
     "'TGCA') AS c, translate(description, 'x ', '') AS d, translate(id, "
     "'aa', 'b') AS e FROM s", 0),
    ("chr_ascii", "SELECT chr(length(id) + 64) AS a, ascii(description) AS b, "
     "ascii(id) AS c, ascii(sequence) AS d FROM s", 0),
    ("initcap", "SELECT initcap(description) AS a, initcap(id) AS b, "
     "initcap(sequence) AS c, initcap(upper(description)) AS d FROM s", 0),
    ("string_coalesce", "SELECT coalesce(description, id) AS a, "
     "coalesce(NULL, description) AS b, coalesce(description, nullif(id, "
     "'x1'), sequence) AS c, ifnull(description, 'none') AS d, "
     "nvl(description, id) AS e, coalesce(nullif(description, 'abcabc'), "
     "nullif(id, 'abcabc'), sequence) AS f FROM s", 0),
    ("string_nullif", "SELECT nullif(id, description) AS a, "
     "nullif(description, 'Hello World') AS b, nullif(sequence, '') AS c "
     "FROM s", 0),
    ("dictionary_arguments", "SELECT upper(seqname) AS a, substr(source, 2, 3)"
     " AS b, concat_ws(':', seqname, type) AS c, coalesce(seqname, 'x') AS d,"
     " lpad(strand, 3, '.') AS e, strpos(type, 'e') AS f, reverse(type) AS g,"
     " initcap(source) AS h FROM genes", 0),
    ("fastq_functions", "SELECT upper(description) AS a, strpos(sequence, "
     f"'{ADAPTER}') AS b, left(name, 6) AS c, concat_ws('/', name, "
     "description) AS d, rtrim(quality_scores, 'J') AS e FROM fq", 0),
    # -- strings on the host ----------------------------------------------
    ("replace_split_part", "SELECT replace(description, 'a', 'X') AS a, "
     "split_part(description, ' ', 1) AS b, split_part(id, '|', -1) AS c, "
     "split_part(id, '|', 0) AS d, split_part(id, '|', 5) AS e, "
     "replace(id, '', 'q') AS f FROM s", 0),
    ("regexp", "SELECT regexp_replace(description, 'a+', 'b') AS a, "
     "regexp_replace(description, '[a-z]', '_', 'g') AS b, "
     "regexp_replace(id, '(P)(0+)', '\\2\\1') AS c, regexp_like(description, "
     "'^s') AS d, regexp_like(id, 'P', 'i') AS e FROM s", 0),
    ("hashes", "SELECT md5(description) AS a, sha256(id) AS b, "
     "sha512(sequence) AS c FROM s", 0),
    ("to_hex_factorial", "SELECT to_hex(length(sequence)) AS a, to_hex(255) AS"
     " b, factorial(length(id) % 10) AS c, factorial(5) AS d FROM s", 0),
    ("levenshtein_find_in_set", "SELECT levenshtein(id, description) AS a, "
     "levenshtein(id, 'Hello') AS b, find_in_set(id, 'a,pad,Hello') AS c, "
     "find_in_set('b', 'a,b') AS d FROM s", 0),
    ("overlay", "SELECT overlay(description PLACING 'XY' FROM 2) AS a, "
     "overlay(id PLACING 'Q' FROM 1 FOR 3) AS b FROM s", 0),
    # -- numbers (Lib) ------------------------------------------------------
    ("numeric_conditionals", "SELECT coalesce(nullif(length(id), 2), "
     "length(sequence)) AS a, nullif(length(id), 5) AS b, greatest(length(id),"
     " length(sequence), 3) AS c, least(length(id), 4) AS d, "
     "greatest(length(id) * 1.5, length(sequence)) AS e, "
     "coalesce(nullif(length(sequence), 0), -1) AS f FROM s", 0),
    ("gcd_lcm", "SELECT gcd(length(id), 12) AS a, lcm(length(id), 4) AS b, "
     "gcd(12, 18) AS c, lcm(-4, 6) AS d, gcd(0 - length(id), "
     "length(sequence)) AS e FROM s", 0),
    ("rounding", "SELECT abs(length(id) - 10) AS a, round(length(id) / 3.0) AS"
     " b, round(length(id) * 1.25, 1) AS c, trunc(length(id) / 7.0, 2) AS d,"
     " ceil(length(id) / 4.0) AS e, floor(length(id) / 4.0) AS f, "
     "ceiling(length(id)) AS g, round(length(id)) AS h FROM s", 0),
    ("sign_mod_power", "SELECT sign(length(id) - 5) AS a, signum(length(id) - "
     "5.5) AS b, mod(length(id), 3) AS c, mod(length(id), 0) AS d, mod(-7, 3)"
     " AS e, power(2, 10) AS f, power(length(id), 2) AS g, pow(length(id), 3)"
     " AS h, mod(length(id) * 2.5, 1.5) AS i, abs(length(id) * -1.5) AS j "
     "FROM s", 0),
    ("math_exact", "SELECT degrees(length(id) + 0.25) AS a, "
     "radians(length(id) + 0.5) AS b, isnan(length(id) * 1.0) AS c, "
     "atan2(length(id) * 1.0, length(sequence) + 0.5) AS d, "
     "log(length(id) * 2.0) AS e, cbrt(length(id)) AS f, pi() AS g FROM s", 0),
    ("math_literals", "SELECT round(2.5) AS a, round(-2.5) AS b, trunc(2.789, "
     "1) AS c, abs(-5) AS d, sqrt(4.0) AS e, exp(0) AS f, ln(1) AS g, "
     "log(100.0) AS h, log(2, 8) AS i, log2(8) AS j, log10(1000) AS k", 0),
    ("math_logs", "SELECT sqrt(length(sequence) * 1.5) AS a, exp(length(id) / "
     "7.0) AS b, ln(length(id) * 1.1) AS c, log2(length(id) * 1.3) AS d, "
     "log10(length(id) * 2.7) AS e, log(3, length(id) + 1) AS f FROM s",
     MATH_RTOL),
    ("math_trig", "SELECT sin(length(id) * 0.37) AS a, cos(length(id) * 0.37) "
     "AS b, tan(length(id) * 0.37) AS c, asin(length(id) / 25.0) AS d, "
     "acos(length(id) / 25.0) AS e, atan(length(id) * 0.9) AS f FROM s",
     MATH_RTOL),
    ("math_hyperbolic", "SELECT sinh(length(id) / 5.0) AS a, cosh(length(id) /"
     " 5.0) AS b, tanh(length(id) / 5.0) AS c, asinh(length(id) * 0.3) AS d, "
     "acosh(length(id) + 1.5) AS e, atanh(length(id) / 25.0) AS f FROM s",
     MATH_RTOL),
    ("math_powers", "SELECT power(length(id) * 1.1, 1.7) AS a, "
     "cbrt(length(sequence) * 1.0 - 20.0) AS b FROM s", MATH_RTOL),
    # XLA folds the product of two constants (x * 0.1 * 180/pi) first
    ("math_constant_products", "SELECT degrees(length(id) * 0.1) AS a, "
     "radians(length(id) * 10.0) AS b FROM s", MATH_RTOL),
    # -- without FROM ------------------------------------------------------
    ("no_from", "SELECT chr(65) AS a, ascii('Abc') AS b, lower('ABC') AS c, "
     "initcap('hello world') AS d, concat_ws(',', 'a', 'b', 'c') AS e, "
     "repeat('ab', 3) AS f, translate('abc', 'b', '') AS g, lpad('7', 3, '0') "
     "AS h, reverse('abc') AS i, md5('abc') AS j, to_hex(255) AS k, "
     "factorial(5) AS l, upper('abc') AS m", 0),
    ("no_from_conditionals", "SELECT NULL || 'x' AS a, concat(NULL, 'x') AS b,"
     " coalesce(NULL, NULL, 7) AS c, ifnull(NULL, 5) AS d, nullif(3, 3) AS e,"
     " nullif(3, 4) AS f, trim('xxabcxx', 'x') AS g, strpos('hello', 'l') AS"
     " h, left('hello', -2) AS i, substr('hello', 0, 3) AS j", 0),
    # -- string compares of two columns ------------------------------------
    ("column_equality", "SELECT id = description AS a, description = "
     "description AS b, sequence = id AS c FROM s", 0),
    ("column_inequality_no_nulls", "SELECT id != sequence AS a, "
     "id <> reverse(id) AS b FROM s", 0),
    ("column_equality_where", "SELECT id FROM s WHERE reverse(id) = id OR "
     "upper(description) = description", 0),
    # -- the smoke's queries J and K at a small size ----------------------
    ("query_j", "SELECT substr(id, 4, strpos(substr(id, 4), '|') - 1) AS "
     "accession, concat_ws('|', upper(right(id, length(id) - strpos(substr("
     "id, 4), '|') - 3)), initcap(trim(description)), lpad(CAST(length("
     "sequence) AS VARCHAR), 5, '0')) AS label FROM fa WHERE strpos("
     "sequence, 'KK') > 0", 0),
    ("query_k", "SELECT length(t) AS len, COUNT(*) AS n, SUM(length(sequence) "
     "- length(t)) AS removed FROM (SELECT sequence, rtrim(left(sequence, "
     f"coalesce(nullif(strpos(sequence, '{ADAPTER}'), 0) - 1, "
     "length(sequence))), 'N') AS t FROM fq) GROUP BY length(t) ORDER BY len",
     0),
]


@pytest.mark.parametrize("sql,rtol", [q[1:] for q in QUERIES],
                         ids=[q[0] for q in QUERIES])
def test_sql_function_matches_jax(sessions, sql, rtol):
    ts, js = sessions
    want = js.sql(sql).collect_arrow()
    assert want.num_rows > 0
    assert_tables_equal(ts.sql(sql).collect_arrow(), want, rtol)


def _sqlfunc_names() -> list:
    """The names exon_tpu/ops/sqlfuncs.py registers."""
    from exon_tpu.ops import sqlfuncs as JS

    return sorted(n for n, f in JE._FUNCTIONS.items()
                  if f.__module__ == JS.__name__)


def test_every_registered_name_is_covered():
    names = _sqlfunc_names()
    assert len(names) == 86
    text = " ".join(q[1] for q in QUERIES).lower()
    for name in names:
        assert name in TE._FUNCTIONS, name
        if name == "concat_op":
            assert "||" in text
        elif name not in ("random", "uuid"):
            assert re.search(rf"\b{name}\s*\(", text), name


def test_random_and_uuid(sessions):
    """Type, range and shape: both draw fresh values."""
    ts, js = sessions
    sql = "SELECT random() AS r, uuid() AS u, id FROM s"
    got, want = ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow()
    assert got.schema == want.schema
    r = np.asarray(got.column("r").to_pylist())
    assert r.shape == (len(STRINGS),) and ((r >= 0) & (r < 1)).all()
    assert len(set(r.tolist())) == len(STRINGS)
    u = got.column("u").to_pylist()
    assert all(re.fullmatch(r"[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}", x)
               for x in u) and len(set(u)) == len(u)


@pytest.mark.parametrize("sql", [
    "SELECT id FROM s WHERE id < description",
    "SELECT id FROM s WHERE sequence >= id",
    "SELECT seqname FROM genes WHERE seqname = source",
    "CREATE FUNCTION f(a BIGINT) RETURNS BIGINT LANGUAGE SQL RETURN a + 1",
], ids=["ordered_lt", "ordered_ge", "two_vocabularies", "create_function"])
def test_refused_in_both_packages(sessions, sql):
    ts, js = sessions
    with pytest.raises(Exception) as want:
        js.sql(sql).collect_arrow()
    with pytest.raises(Exception) as got:
        ts.sql(sql).collect_arrow()
    assert type(got.value).__name__ == type(want.value).__name__ == \
        "PlanError"


def test_f8_column_inequality_with_null_rows(sessions):
    """F8: the JAX != of two string columns passes a row where either is
    NULL; in the port a NULL row never passes a string compare."""
    ts, js = sessions
    sql = "SELECT id != description AS ne, description IS NULL AS n FROM s"
    got, want = ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow()
    null = got.column("n").to_pylist()
    assert any(null)
    g, w = got.column("ne").to_pylist(), want.column("ne").to_pylist()
    assert [a for a, n in zip(g, null) if not n] == \
        [b for b, n in zip(w, null) if not n]
    assert all(w[i] and not g[i] for i in range(len(null)) if null[i])


@pytest.mark.parametrize("expr,want", [
    ("upper('abc')", "ABC"), ("concat_ws(',', 'a', 'b')", "a,b"),
    ("rtrim('aa', 'a')", ""), ("concat_ws('', 'x', id)", None)],
    ids=["upper", "concat_ws", "rtrim", "empty_separator"])
def test_f16_one_row_literal_columns(sessions, expr, want):
    """F16: the JAX package makes a string literal a column of one row. A
    string function of literals only over a table gives one row, which a
    batch of several cannot hold (its Arrow export raises), and an empty
    concat_ws separator is a gather from no bytes (TypeError). The port
    repeats a literal on every row."""
    ts, js = sessions
    sql = f"SELECT {expr} AS v, id FROM s"
    with pytest.raises(Exception):
        js.sql(sql).collect_arrow()
    got = ts.sql(sql).collect_arrow().column("v").to_pylist()
    ids = [i for i, _d, _s in STRINGS]
    assert got == ([want] * len(STRINGS) if want is not None
                   else ["x" + i for i in ids])


@pytest.mark.parametrize("host_decode", [False, True],
                         ids=["device_decode", "host_decode"])
def test_a_scan_of_no_columns_carries_the_sessions_device(
        sessions, monkeypatch, host_decode):
    """A scan projected to no columns yields batches that still name the
    session's device, and so does a projection to none of a device batch:
    a function of literals only over a table (upper, concat_ws, random)
    builds its column there, where before it fell back to the CPU."""
    import torch
    from exon_tpu_torch.batch import Batch, Schema

    if host_decode:
        monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    ts, _js = sessions
    df = ts.sql("SELECT upper('x') AS u, concat_ws('-', 'a', 'b') AS c, "
                "random() AS r FROM s")
    plan = df._execute(df.logical_plan())
    while plan.children():
        plan = plan.children()[0]
    scanned = list(plan.batches())
    assert scanned and all(b.device == torch.device("cpu") for b in scanned)
    if not host_decode:  # the host decoder keeps its id column
        assert not any(b.columns for b in scanned)
    meta = Batch(Schema.of(), [], 3).to_device("meta")
    assert meta.device == meta.project([]).device == torch.device("meta")


def test_f17_byte_level_slices_of_multibyte_strings(sessions):
    """F17: substr, left, right and trim count bytes in both packages;
    DataFusion counts characters. On 'naïve café ☃ é' (ï, é are 2 bytes,
    ☃ 3) the port gives the JAX bytes, not DataFusion's characters."""
    ts, js = sessions
    sql = ("SELECT substr(description, 3, 2) AS a, left(description, 3) AS b,"
           " right(description, 2) AS c, trim(description, 'é') AS d "
           "FROM s WHERE id = 'ümlaut'")
    got, want = ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow()
    assert_tables_equal(got, want)
    text = "naïve café ☃ é"
    chars = [text[2:4], text[:3], text[-2:]]
    raw = text.encode()
    bytes_ = [raw[2:4], raw[:3], raw[-2:]]
    assert _values(got.column("a")) + _values(got.column("b")) + \
        _values(got.column("c")) == bytes_
    assert [c.encode() for c in chars] != bytes_
    # trim's set is bytes: 'é' strips 0xC3 and 0xA9 from both ends
    assert _values(got.column("d")) == [raw.strip("é".encode())]


def test_f18_median_of_integers_rounds_half_to_even(sessions):
    """F18: the JAX median of an integer column is np.median in float64,
    rounded by np.rint (half to even); DataFusion averages the two middle
    integers in integer arithmetic. The port follows JAX: lengths 2 and 13
    give rint(7.5) = 8, where the integer mean is 15 // 2 = 7."""
    ts, js = sessions
    sql = ("SELECT MEDIAN(length(sequence)) AS m, MEDIAN(length(sequence) "
           "* 1.0) AS f FROM s WHERE id IN ('aa', 'sp|P100000|PROT100000')")
    got, want = ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow()
    assert_tables_equal(got, want)
    assert got.column("m").to_pylist() == [8] != [(2 + 13) // 2]
    assert got.column("f").to_pylist() == [7.5]
