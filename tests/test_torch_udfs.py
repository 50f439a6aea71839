"""The sequence UDFs of exon_tpu_torch against exon_tpu's.

(a) SQL over in-repo fixtures (a DNA FASTA file, FASTQ, BAM and GFF)
through ``exon_tpu.ExonSession.sql`` and
``exon_tpu_torch.ExonSession(device="cpu").sql`` gives equal Arrow tables
for every ported UDF: alignment_score (a literal on either side, a second
column, the ignored band), gc_content, reverse_complement, trim_polya,
length, the twelve SAM-flag predicates, is_mapped, chrom_match,
interval_match and region_match, over var-width, dictionary and NULL
inputs. Tolerance: exact (float32 bit for bit), except AVG over the float32
gc_content, relative 1e-5: the JAX grouped aggregate sums a float32 column
in float32, the port in float64 (F13, ROADMAP Queue 3).
(b) The kernels' plain twins against the JAX functions they replace:
sw_score on 200 seeded pairs (lengths 0-300, alphabets of 4 and 20 letters,
queries longer than rows, NULL rows) and count_bytes, map_bytes and
polya_tail through gc_content, reverse_complement and trim_polya (all-A,
empty and NULL rows, lowercase, U and N, dictionary inputs); every flag on
every bit. All exact.
(c) The JAX faults the port does not copy: F11 (alignment past 2048
bytes), F12 (a column with no bytes), F13, and an empty query.
(d) Every JAX function the port does not carry raises NotImplementedError
naming its ROADMAP item (the SQL functions and the list UDFs, which did
until items 8 and 2b + 3 landed, now give the JAX package's answer); an
unknown name raises PlanError.
"""

import numpy as np
import pytest
import torch

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.bam_fixture import make_bam
from benchlib.fastq_fixture import make_fastq
from benchlib.gff_fixture import make_gff
from exon_tpu import udfs as judfs
from exon_tpu.batch import DictColumn as JDict
from exon_tpu.batch import FixedColumn as JFixed
from exon_tpu.batch import VarColumn as JVar
from exon_tpu.errors import PlanError as JPlanError
from exon_tpu.ops import alignment as jalign
from exon_tpu.plan.expressions import FunctionCall as JFunctionCall
from exon_tpu_torch import udfs as tudfs
from exon_tpu_torch.batch import DictColumn as TDict
from exon_tpu_torch.batch import FixedColumn as TFixed
from exon_tpu_torch.batch import VarColumn as TVar
from exon_tpu_torch.errors import PlanError
from exon_tpu_torch.kernels import sw_score as ksw

BATCH = 700
AVG_F32_RTOL = 1e-5
ADAPTER = "AGATCGGAAGAGC"


def _dp(a: bytes, b: bytes) -> int:
    """Plain Smith-Waterman (Gotoh): match +1, mismatch -1, a gap of length
    L costs -(1 + L), scores clamp at 0; the best cell."""
    neg = -(1 << 20)
    best = 0
    h_prev = [0] * (len(b) + 1)
    e = [neg] * (len(b) + 1)
    for ca in a:
        h = [0] * (len(b) + 1)
        f = neg
        for j, cb in enumerate(b, 1):
            e[j] = max(h_prev[j] - 2, e[j] - 1)
            f = max(h[j - 1] - 2, f - 1)
            h[j] = max(0, h_prev[j - 1] + (1 if ca == cb else -1), e[j], f)
            best = max(best, h[j])
        h_prev = h
    return best


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


def _dna_rows(rng, n: int, max_len: int = 300) -> list:
    """Seeded DNA rows over ACGTN, lowercase and U; some with an A/a tail,
    some all A, some empty."""
    letters = np.frombuffer(b"ACGTNacgtnU", np.uint8)
    rows = []
    for i in range(n):
        row = letters[rng.integers(0, len(letters),
                                   rng.integers(0, max_len + 1))].tobytes()
        if rng.random() < 0.25:
            row += (b"A", b"a", b"Aa")[i % 3] * int(rng.integers(1, 30))
        if i % 37 == 5:
            row = b"A" * int(rng.integers(1, 50))
        if i % 41 == 7:
            row = b""
        rows.append(row)
    return rows


def _write_dna(path, n=250, seed=31):
    """A FASTA file of DNA records with 60-byte lines; every third record
    has a DNA description, the others none (NULL)."""
    rng = np.random.default_rng(seed)
    parts = []
    for i, body in enumerate(_dna_rows(rng, n, max_len=200)):
        desc = b" ACGTGGCCAAA%d" % i if i % 3 == 0 else b""
        parts.append(b">d%06d%s\n" % (i, desc))
        parts.extend(body[j:j + 60] + b"\n" for j in range(0, len(body), 60))
    path.write_bytes(b"".join(parts))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("udfs")
    return {
        "gff": make_gff(2000, seed=5, path=str(d / "g.gff3")),
        "bam": make_bam(300, seed=3, path=str(d / "r.bam")),
        "fq": make_fastq(600, seed=4, path=str(d / "q.fastq")),
        "dna": _write_dna(d / "d.fasta"),
    }


@pytest.fixture(scope="module")
def sessions(files):
    # the reference decodes on the host, so the comparison isolates the
    # functions and their operators
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("EXON_TPU_HOST_DECODE", "1")
        js = J.ExonSession.new_exon()
        js.config.device_batch_size = BATCH
        ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
        for s in (ts, js):
            for name, fmt, key in (("genes", "GFF", "gff"),
                                   ("reads", "BAM", "bam"),
                                   ("dna", "FASTA", "dna"),
                                   ("fq", "FASTQ", "fq")):
                s.sql(f"CREATE EXTERNAL TABLE {name} STORED AS {fmt} "
                      f"LOCATION '{files[key]}'")
        yield ts, js


def _assert_equal(got, want, float_rtol=0.0):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got.column(name), want.column(name)
        assert g.is_null().to_pylist() == w.is_null().to_pylist(), name
        gl, wl = g.to_pylist(), w.to_pylist()
        if w.type in ("double", "float"):
            if float_rtol:
                np.testing.assert_allclose(np.asarray(gl, float),
                                           np.asarray(wl, float),
                                           rtol=float_rtol, atol=0)
                continue
            gl = [None if v is None else np.float64(v).tobytes() for v in gl]
            wl = [None if v is None else np.float64(v).tobytes() for v in wl]
        assert gl == wl, name


# ---------------------------------------------------------------------------
# (a) SQL through both packages
# ---------------------------------------------------------------------------

_FLAGS = ", ".join(f"{f}(flag) AS {f}" for f in judfs.SAM_FLAGS)
_LONG_Q = "ACGTTGCAAGT" * 7  # 77 bytes: three passes of the kernel

# (name, SQL, AVG over float32?)
QUERIES = [
    ("dna_udfs", "SELECT id, alignment_score(sequence, 'ACGTTGCA') AS s, "
     "gc_content(sequence) AS gc, reverse_complement(sequence) AS rc, "
     "trim_polya(sequence) AS t, length(sequence) AS l, "
     "character_length(sequence) AS cl, char_length(id) AS il FROM dna", 0),
    ("dna_long_query", f"SELECT id, alignment_score(sequence, '{_LONG_Q}') "
     "AS s FROM dna", 0),
    ("dna_literal_first", "SELECT alignment_score('GATTACA', sequence) AS s "
     "FROM dna", 0),
    ("dna_pairwise", "SELECT id, alignment_score(sequence, "
     "reverse_complement(sequence)) AS s FROM dna", 0),
    ("dna_band", "SELECT alignment_score(sequence, 'ACGT', 5) AS s FROM dna",
     0),
    ("null_description", "SELECT id, gc_content(description) AS gc, "
     "alignment_score(description, 'ACGT') AS s, trim_polya(description) "
     "AS t, reverse_complement(description) AS rc FROM dna", 0),
    ("udf_filters", "SELECT id, gc_content(sequence) AS gc FROM dna WHERE "
     "gc_content(sequence) > 0.3 AND length(trim_polya(sequence)) < "
     "length(sequence)", 0),
    ("query_f_adapter_screen", "SELECT name, alignment_score(sequence, "
     f"'{ADAPTER}') AS score FROM fq WHERE alignment_score(sequence, "
     f"'{ADAPTER}') >= 11", 0),
    ("query_h_sql", "SELECT name, reverse_complement(trim_polya(sequence)) "
     "AS rc FROM fq WHERE gc_content(sequence) >= 0.55", 0),
    ("fastq_pairwise", "SELECT alignment_score(sequence, quality_scores) AS "
     "s FROM fq", 0),
    ("query_g_gc_per_reference", "SELECT reference, COUNT(*) AS n, "
     "AVG(gc_content(sequence)) AS gc FROM reads WHERE is_first_segment(flag) "
     "AND NOT is_mate_unmapped(flag) GROUP BY reference", 1),
    ("bam_flags", f"SELECT name, flag, {_FLAGS}, is_mapped(flag) AS m "
     "FROM reads", 0),
    ("bam_group_by_flag", "SELECT is_reverse_complemented(flag) AS r, "
     "COUNT(*) AS n FROM reads GROUP BY r ORDER BY r", 0),
    ("bam_region", "SELECT name, start FROM reads WHERE region_match("
     "reference, start, 'chr1:1,000-120,000,000') OR (chrom_match("
     "reference, 'chr2') AND interval_match(start, '1000-50000000'))", 0),
    ("gff_region", "SELECT seqname, start FROM genes WHERE region_match("
     "seqname, start, 'chr2:1-100000000') AND interval_match(\"end\", "
     "'-150000000')", 0),
    ("gff_whole_contig", "SELECT COUNT(*) AS n FROM genes WHERE "
     "region_match(seqname, start, 'chrX') OR interval_match(start, "
     "'200000000-')", 0),
    ("var_chrom_match", "SELECT id FROM dna WHERE chrom_match(id, "
     "'d000007') OR region_match(id, length(sequence), 'd000009:1-500')",
     0),
    ("dict_inputs", "SELECT seqname, gc_content(seqname) AS gc, "
     "reverse_complement(seqname) AS rc, trim_polya(type) AS t, "
     "length(type) AS l FROM genes", 0),
    ("literals", "SELECT gc_content('GGCC') AS g, reverse_complement('AAGG') "
     "AS r, trim_polya('ACGTAAaa') AS t, alignment_score('ACGT', 'TACGTT') "
     "AS a, length('hello') AS l, chrom_match('chr1', 'chr1') AS c", 0),
]


@pytest.mark.parametrize("name,sql,avg_f32", QUERIES,
                         ids=[q[0] for q in QUERIES])
def test_udf_query_matches_jax(sessions, name, sql, avg_f32):
    ts, js = sessions
    want = js.sql(sql).collect_arrow()
    got = ts.sql(sql).collect_arrow()
    assert want.num_rows > 0, name
    _assert_equal(got, want, AVG_F32_RTOL if avg_f32 else 0.0)


def test_query_f_scores_against_a_plain_dp(sessions, files):
    """Query F: exact adapter copies score 13, and every row's score is the
    plain DP's."""
    from benchlib.fastq_fixture import adapter_rows, fastq_reads

    ts, _js = sessions
    got = ts.sql(f"SELECT alignment_score(sequence, '{ADAPTER}') AS s "
                 "FROM fq").collect_arrow().column("s").to_pylist()
    reads = fastq_reads(600, 4)["sequences"]
    assert got == [_dp(bytes(r), ADAPTER.encode()) for r in reads]
    assert np.flatnonzero(np.asarray(got) == 13).tolist() == \
        adapter_rows(fastq_reads(600, 4)).tolist()


def test_query_h_dataframe_matches_jax(sessions, files):
    ts, js = sessions

    def frame(s, f, c):
        return s.read_fastq(files["fq"]).filter(
            f("gc_content", [c("sequence")]) >= 0.55).select(
            "name", f("reverse_complement",
                      [f("trim_polya", [c("sequence")])]).alias("rc"))

    _assert_equal(frame(ts, T.FunctionCall, T.col).collect_arrow(),
                  frame(js, JFunctionCall, J.col).collect_arrow())


@pytest.mark.parametrize("text,sql,want", [
    (">s1\nACGTACGT\n>s2\nTTTT\n>s3\nACGT\n",
     "alignment_score(sequence, 'ACGT')", [4, 1, 4]),
    (">s1\nGGCC\n>s2\nATAT\n", "gc_content(sequence)", [1.0, 0.0]),
    (">s1\nACGT\n>s2\nAAGG\n", "reverse_complement(sequence)",
     ["ACGT", "CCTT"]),
], ids=["alignment_score", "gc_content", "reverse_complement"])
def test_jax_udf_cases(tmp_path, text, sql, want):
    """The cases of tests/test_udfs_cli_ffi.py:18-84, on both packages."""
    path = tmp_path / "a.fasta"
    path.write_text(text)
    query = f"SELECT {sql} AS v FROM fasta_scan('{path}')"
    for s in (T.ExonSession(device="cpu"), J.ExonSession.new_exon()):
        assert s.sql(query).collect_arrow().column("v").to_pylist() == want


# ---------------------------------------------------------------------------
# (b) the twins against the JAX functions
# ---------------------------------------------------------------------------


def _columns(rows: list, valid: np.ndarray):
    """The same var-width column for both packages (values, offsets,
    validity), built from numpy."""
    offs = np.zeros(len(rows) + 1, np.int32)
    np.cumsum([len(r) for r in rows], out=offs[1:])
    vals = np.frombuffer(b"".join(rows), np.uint8).copy()
    import jax.numpy as jnp

    return (TVar(torch.from_numpy(vals), torch.from_numpy(offs),
                 torch.from_numpy(valid)),
            JVar(jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(valid)))


def _pairs(seed: int = 41, n: int = 200):
    """200 seeded (row, query) pairs: lengths 0-300 over 4 or 20 letters,
    some queries longer than their rows, about 8 % NULL rows (bytes
    kept)."""
    rng = np.random.default_rng(seed)
    dna = np.frombuffer(b"ACGT", np.uint8)
    protein = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    rows, queries = [], []
    for i in range(n):
        letters = dna if i % 2 else protein
        la = int(rng.integers(0, 301))
        lb = int(rng.integers(la, 301)) if i % 5 == 0 else \
            int(rng.integers(0, 301))
        rows.append(letters[rng.integers(0, len(letters), la)].tobytes())
        queries.append(letters[rng.integers(0, len(letters), lb)].tobytes())
    return rows, queries, rng.random(n) >= 0.08


def test_sw_twin_matches_jax_pairwise():
    rows, queries, valid = _pairs()
    ta, ja = _columns(rows, valid)
    tb, jb = _columns(queries, np.ones(len(queries), bool))
    want = np.asarray(jalign.alignment_scores_pairwise(ja, jb))
    got = ksw.sw_score_pairwise(ta.offsets, ta.values, tb.offsets, tb.values)
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    sample = range(0, 200, 9)
    assert [int(got[i]) for i in sample] == \
        [_dp(rows[i], queries[i]) for i in sample]


@pytest.mark.parametrize("qlen", [1, 13, 33, 77, 400])
def test_sw_twin_matches_jax_against_a_query(qlen):
    rows, _queries, valid = _pairs(seed=42 + qlen)
    rng = np.random.default_rng(qlen)
    query = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, qlen)]
    ta, ja = _columns(rows, valid)
    want = np.asarray(jalign.alignment_scores(ja, query.tobytes()))
    got = ksw.sw_score(ta.offsets, ta.values, torch.from_numpy(query.copy()))
    assert got.numpy().tolist() == want.tolist()


def _byte_rows():
    """Rows for the byte UDFs: all-A, empty, NULL (with bytes), lowercase,
    U and N, tails of A and a."""
    rng = np.random.default_rng(43)
    rows = _dna_rows(rng, 300, max_len=120) + [
        b"", b"A", b"a", b"AAAA", b"aAaA", b"NNNN", b"UuUu", b"GCgcAT",
        b"AAAC", b"CAAA", b"ACGTacgtNnUu" * 9 + b"aaa"]
    valid = rng.random(len(rows)) >= 0.05
    return rows, valid


def _var_equal(t: TVar, j: JVar) -> None:
    offs = np.asarray(j.offsets)
    assert t.offsets.numpy().tolist() == offs.tolist()
    n = int(offs[-1])
    assert t.values.numpy()[:n].tobytes() == np.asarray(j.values)[:n].tobytes()
    assert t.validity.numpy().tolist() == np.asarray(j.validity).tolist()


def test_byte_twins_match_jax():
    rows, valid = _byte_rows()
    t, j = _columns(rows, valid)
    gc_t = tudfs.gc_content(None, t)
    gc_j = np.asarray(judfs.gc_content(None, j))
    assert gc_t.dtype == torch.float32
    assert gc_t.numpy().tobytes() == gc_j.astype(np.float32).tobytes()
    _var_equal(tudfs.reverse_complement(None, t),
               judfs.reverse_complement(None, j))
    _var_equal(tudfs.trim_polya(None, t), judfs.trim_polya(None, j))
    trimmed = tudfs.trim_polya(None, t)
    assert [bytes(trimmed.values[a:b].tolist()) for a, b in
            zip(trimmed.offsets[:-1].tolist(), trimmed.offsets[1:].tolist())
            ] == [r.rstrip(b"Aa") for r in rows]


def test_byte_twins_match_jax_on_dictionary_columns():
    import jax.numpy as jnp

    vocab = ("chr1", "GGCCAAA", "", "aaaa", "ACGTN", "UUAa")
    rng = np.random.default_rng(44)
    codes = rng.integers(0, len(vocab), 500).astype(np.int32)
    valid = rng.random(500) >= 0.1
    t = TDict(torch.from_numpy(codes), torch.from_numpy(valid), vocab)
    j = JDict(jnp.asarray(codes), jnp.asarray(valid), vocab)
    assert tudfs.gc_content(None, t).numpy().tobytes() == \
        np.asarray(judfs.gc_content(None, j)).astype(np.float32).tobytes()
    _var_equal(tudfs.reverse_complement(None, t),
               judfs.reverse_complement(None, j))
    assert tudfs.length_fn(None, t).numpy().tolist() == \
        np.asarray(judfs.length_fn(None, j)).tolist()
    # F14: JAX's dict_to_var pads the values past the last row, and the
    # JAX trim_polya counts the padding into the last row
    got, want = tudfs.trim_polya(None, t), judfs.trim_polya(None, j)
    g_off, w_off = got.offsets.numpy(), np.asarray(want.offsets)
    assert g_off[:-1].tolist() == w_off[:-1].tolist()
    n = int(g_off[-2])
    assert got.values.numpy()[:n].tobytes() == \
        np.asarray(want.values)[:n].tobytes()
    last = vocab[codes[-1]].encode().rstrip(b"Aa") if valid[-1] else b""
    assert got.values.numpy()[n:].tobytes() == last
    assert w_off[-1] - w_off[-2] > len(last)


@pytest.mark.parametrize("name", list(judfs.SAM_FLAGS) + ["is_mapped"])
def test_flag_predicate_on_every_bit(name):
    import jax.numpy as jnp

    flags = np.arange(1 << 12, dtype=np.int32)
    valid = flags % 7 != 0
    t_fn = tudfs.is_mapped if name == "is_mapped" else \
        tudfs._make_flag_fn(tudfs.SAM_FLAGS[name])
    j_fn = judfs.is_mapped if name == "is_mapped" else \
        judfs._make_flag_fn(judfs.SAM_FLAGS[name])
    got = t_fn(None, TFixed(torch.from_numpy(flags), torch.from_numpy(valid)))
    want = np.asarray(j_fn(None, JFixed(jnp.asarray(flags),
                                        jnp.asarray(valid))))
    assert got.numpy().tolist() == want.tolist()
    bit = 0x4 if name == "is_mapped" else tudfs.SAM_FLAGS[name]
    assert got.numpy().tolist() == (((flags & bit) != 0) ^
                                    (name == "is_mapped")).tolist()


# ---------------------------------------------------------------------------
# (c) the JAX faults the port does not copy
# ---------------------------------------------------------------------------


def test_f11_alignment_past_2048_bytes(tmp_path):
    row = "T" * 2900 + ADAPTER + "T" * 87
    path = tmp_path / "long.fasta"
    path.write_text(f">long\n{row}\n>short\n{ADAPTER}\n")
    sql = (f"SELECT alignment_score(sequence, '{ADAPTER}') AS s FROM "
           f"fasta_scan('{path}')")
    got = T.ExonSession(device="cpu").sql(sql).collect_arrow()
    want = J.ExonSession.new_exon().sql(sql).collect_arrow()
    assert got.column("s").to_pylist() == \
        [_dp(row.encode(), ADAPTER.encode()), 13] == [13, 13]
    # JAX scores only the first 2048 bytes, all T
    assert want.column("s").to_pylist() == [1, 13]


def test_f12_a_column_with_no_bytes():
    rows, valid = [b"", b"", b""], np.array([True, False, True])
    t, j = _columns(rows, valid)
    assert ksw.sw_score(t.offsets, t.values,
                        torch.tensor(list(b"ACGT"), dtype=torch.uint8)
                        ).tolist() == [0, 0, 0]
    assert ksw.sw_score_pairwise(t.offsets, t.values, t.offsets,
                                 t.values).tolist() == [0, 0, 0]
    with pytest.raises(TypeError):
        jalign.alignment_scores(j, b"ACGT")


def test_f13_avg_of_a_float32_udf_sums_in_float64(sessions):
    """AVG(gc_content) over 600 reads: the port's float64 sum agrees with
    numpy's to 1e-12; the JAX float32 sum drifts further."""
    from benchlib.fastq_fixture import fastq_reads

    ts, js = sessions
    sql = "SELECT AVG(gc_content(sequence)) AS gc FROM fq"
    seqs = fastq_reads(600, 4)["sequences"]
    gc = np.asarray([np.float32(sum(b in b"GCgc" for b in bytes(s)))
                     / np.float32(len(s)) for s in seqs], np.float32)
    exact = float(gc.astype(np.float64).mean())
    got = ts.sql(sql).collect_arrow().column("gc").to_pylist()[0]
    want = js.sql(sql).collect_arrow().column("gc").to_pylist()[0]
    assert abs(got - exact) <= 1e-12 * exact
    assert abs(want - exact) > 1e-9 * exact
    assert abs(want - exact) <= AVG_F32_RTOL * exact


def test_null_rows_score_zero_as_in_jax(sessions):
    ts, js = sessions
    sql = ("SELECT alignment_score(description, 'ACGT') AS s, "
           "gc_content(description) AS gc FROM dna WHERE description IS NULL")
    got = ts.sql(sql).collect_arrow()
    _assert_equal(got, js.sql(sql).collect_arrow())
    assert set(got.column("s").to_pylist()) == {0}
    assert set(got.column("gc").to_pylist()) == {0.0}


def test_empty_query_raises(sessions):
    ts, js = sessions
    sql = "SELECT alignment_score(sequence, '') AS s FROM dna"
    with pytest.raises(PlanError, match="query is empty"):
        ts.sql(sql).collect_arrow()
    with pytest.raises(ValueError):
        js.sql(sql).collect_arrow()
    with pytest.raises(PlanError, match="int32"):
        ts.sql("SELECT alignment_score(sequence, 'A', 'x') FROM dna"
               ).collect_arrow()


# ---------------------------------------------------------------------------
# (d) what the port does not carry
# ---------------------------------------------------------------------------

# a region marker that a ported provider plans away reaches execution here
# (no indexed table below it) and raises PlanError, as in the JAX package
_PLANNED_AWAY = "should not be called"
NOT_PORTED = (
    # item 2b + 3 (the list UDFs, K11b) has landed: these give the JAX
    # package's answer (item None), as does a list literal
    [(f"{n}(sequence)", None) for n in tudfs.LIST_UDFS]
    + [(f"{n}('chr1:1-10', id, 1)",
        _PLANNED_AWAY if n in tudfs.PUSHED_REGION_FILTERS else "item 2c")
       for n in tudfs.REGION_FILTER_UDFS]
    # item 8 (the SQL functions) has landed: these now give the JAX
    # package's answer (item None)
    + [(f"{n}(id)", None) for n in ("upper", "lower", "levenshtein",
                                    "coalesce", "abs", "md5")]
    + [("substring(id FROM 1 FOR 3)", None),
       ("position('A' IN sequence)", None),
       ("overlay(id PLACING 'x' FROM 1)", None),
       ("id || 'x'", None),
       ("[1, 2]", None)])


@pytest.mark.parametrize("expr,item", NOT_PORTED,
                         ids=[e.split("(")[0] + str(i)
                              for i, (e, _) in enumerate(NOT_PORTED)])
def test_not_ported_function_raises(sessions, expr, item):
    """NotImplementedError naming the ROADMAP item; a function whose item
    has landed (item None) gives what the JAX package gives: an equal
    table, or the same error class."""
    ts, js = sessions
    if item is None:
        sql = f"SELECT {expr} AS v FROM dna"
        try:
            want = js.sql(sql).collect_arrow()
        except Exception as e:  # noqa: BLE001 - the class is compared
            with pytest.raises(Exception) as got:
                ts.sql(sql).collect_arrow()
            assert type(got.value).__name__ == type(e).__name__
            return
        assert ts.sql(sql).collect_arrow().equals(want)
        return
    if item == _PLANNED_AWAY:
        for s, err in ((ts, PlanError), (js, JPlanError)):
            with pytest.raises(err, match=item):
                s.sql(f"SELECT {expr} AS v FROM dna").collect_arrow()
        return
    with pytest.raises(NotImplementedError, match=item):
        ts.sql(f"SELECT {expr} AS v FROM dna").collect_arrow()


def test_unknown_function_raises_plan_error(sessions):
    ts, js = sessions
    for s in (ts, js):
        with pytest.raises(Exception, match="unknown function") as e:
            s.sql("SELECT no_such_fn(id) AS v FROM dna").collect_arrow()
        assert type(e.value).__name__ == "PlanError"
