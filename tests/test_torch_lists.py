"""List, struct and map columns of exon_tpu_torch against exon_tpu's
(ROADMAP item 2b + 3, the K11b kernels and the map lookup).

(a) The twelve list UDFs through both ``ExonSession.sql``s over a FASTQ, a
DNA FASTA and a GENCODE-shaped GFF3 (``benchlib/gencode_gff_fixture.py``):
integer_encode_dna, integer_encoding (a repeated alphabet byte, unknown
bytes), the Phred conversions under both names and their round trip,
make_array, array_element (in range, past the end, 0, on a string) and
array_length, locate_regex; a list of strings raises PlanError in both.
(b) The FASTA integer encodings on the host decode and on the device decode
(map_bytes' widen mode), against the JAX decoders of the same kind, and the
invalid bytes that raise. (c) GFF3 attribute lookups (``a['k']``, ``a.k``,
``a['k'][i]``, absent keys, multi-valued ``tag``) and GTF-style
``parse_attributes`` against the JAX parser's arrays. (d) Filter, Sort
(and TopK) and Union carrying list, struct and map columns, and inner and
left joins against the scan's own rows.
(e) ``from_numpy_batch`` on both JAX layouts of a list of numbers, padded as
the JAX package pads a device batch. (f) The JAX faults the port does not
copy or the conventions it follows (F23, F24, F26, F29). The new kernel
modes meet their twins on a card in test_torch_kernels.py (marker ``cuda``).
Tolerance: exact (Arrow tables equal in values, types, nulls and order).
"""

import numpy as np
import pyarrow as pa
import pytest

import exon_tpu as J
import exon_tpu_torch as T
from benchlib.fastq_fixture import make_fastq
from benchlib.gencode_gff_fixture import make_gencode_gff
from exon_tpu import batch as jb
from exon_tpu.errors import InvalidSequenceError as JInvalidSequence
from exon_tpu.errors import PlanError as JPlanError
from exon_tpu.formats import attrmap as jattrmap
from exon_tpu_torch import batch as tb
from exon_tpu_torch.errors import InvalidSequenceError, PlanError
from exon_tpu_torch.formats import attrmap as tattrmap

BATCH = 256


def _dna_fasta(path, n=300, seed=8, alphabet=b"ACGTN") -> str:
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n):
        body = bytes(np.frombuffer(alphabet, np.uint8)[
            rng.integers(0, len(alphabet), int(rng.integers(0, 150)))])
        parts.append(b">r%d%s\n" % (i, b" desc" if i % 4 else b""))
        parts.extend(body[j:j + 60] + b"\n" for j in range(0, len(body), 60))
    path.write_bytes(b"".join(parts))
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("lists")
    return {
        "fq": make_fastq(500, seed=6, path=str(d / "q.fastq")),
        "dna": _dna_fasta(d / "d.fasta"),
        "prot": _dna_fasta(d / "p.fasta", seed=9,
                           alphabet=b"ABCDEFGHIKLMNOPQRSTUVWYXZ"),
        "gff": make_gencode_gff(2500, seed=3, path=str(d / "g.gff3")),
    }


@pytest.fixture(scope="module")
def sessions(files):
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    for s in (ts, js):
        for name, fmt, key in (("fq", "FASTQ", "fq"), ("dna", "FASTA", "dna"),
                               ("genes", "GFF", "gff")):
            s.sql(f"CREATE EXTERNAL TABLE {name} STORED AS {fmt} "
                  f"LOCATION '{files[key]}'")
    return ts, js


def assert_same(got: pa.Table, want: pa.Table):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        assert got.column(name).to_pylist() == \
            want.column(name).to_pylist(), name
    assert got.equals(want)


def _both(sessions, sql: str) -> pa.Table:
    ts, js = sessions
    got = ts.sql(sql).collect_arrow()
    assert_same(got, js.sql(sql).collect_arrow())
    return got


# ---------------------------------------------------------------------------
# (a) the list UDFs
# ---------------------------------------------------------------------------

LIST_UDF_SQL = [
    "SELECT name, integer_encode_dna(sequence) AS c FROM fq",
    "SELECT id, integer_encode_dna(sequence) AS c FROM dna",
    "SELECT integer_encode_dna(description) AS c FROM dna",
    "SELECT integer_encoding(sequence, 'ACGTA') AS e FROM fq",
    "SELECT integer_encoding(sequence, 'xyz') AS e FROM dna",
    "SELECT quality_score_string_to_list(quality_scores) AS q FROM fq",
    "SELECT quality_scores_to_list(quality_scores) AS q FROM fq",
    "SELECT quality_score_list_to_string(quality_score_string_to_list("
    "quality_scores)) AS r, quality_scores FROM fq",
    "SELECT quality_scores_to_string(quality_scores_to_list(quality_scores)) "
    "AS r FROM fq WHERE quality_scores_to_string(quality_scores_to_list("
    "quality_scores)) = quality_scores",
    "SELECT quality_scores_to_string(integer_encode_dna(sequence)) AS r "
    "FROM fq",
    "SELECT make_array(1, 2, 3) AS m, id FROM dna",
    "SELECT array_element(quality_scores_to_list(quality_scores), 1) AS a, "
    "array_element(quality_scores_to_list(quality_scores), 150) AS b, "
    "array_element(quality_scores_to_list(quality_scores), 151) AS c, "
    "array_element(quality_scores_to_list(quality_scores), 0) AS d FROM fq",
    "SELECT array_element(integer_encode_dna(sequence), 70) AS a FROM dna",
    "SELECT array_length(quality_scores_to_list(quality_scores)) AS n, "
    "array_length(sequence) AS m FROM fq",
    "SELECT array_length(integer_encode_dna(sequence)) AS n, "
    "array_element(sequence, 2) AS b FROM dna",
    "SELECT id, locate_regex(sequence, 'A[CG]T') AS l FROM dna",
    "SELECT locate_regex(description, 'es') AS l FROM dna",
    "SELECT name FROM fq WHERE array_length(integer_encoding(sequence, "
    "'ACGT')) > 100 ORDER BY name LIMIT 7",
]


@pytest.mark.parametrize("sql", LIST_UDF_SQL,
                         ids=[f"q{i}" for i in range(len(LIST_UDF_SQL))])
def test_list_udfs_match_jax(sessions, sql):
    assert _both(sessions, sql).num_rows > 0


@pytest.mark.parametrize("sql", [
    "SELECT array_element(attributes['tag'], 1) AS a FROM genes",
    "SELECT array_length(attributes['tag']) AS a FROM genes",
    "SELECT locate_regex(sequence, id) AS l FROM dna",
], ids=["element", "length", "pattern_column"])
def test_list_udfs_reject_as_jax(sessions, sql):
    """A list of strings (``_as_var`` converts only lists of fixed values)
    and a column pattern raise PlanError in both packages."""
    ts, js = sessions
    with pytest.raises(PlanError):
        ts.sql(sql).collect_arrow()
    with pytest.raises(JPlanError):
        js.sql(sql).collect_arrow()


# ---------------------------------------------------------------------------
# (b) the FASTA integer encodings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
@pytest.mark.parametrize("kind,key", [("integer_encode_dna", "dna"),
                                      ("integer_encode_protein", "prot")])
def test_fasta_encodings_match_jax(files, monkeypatch, host, kind, key):
    """sequence_data_type on the device decode (map_bytes' widen mode over
    the gathered bytes) and the host decode, against the JAX decoder of the
    same kind."""
    if host:
        monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    js = J.ExonSession.new_exon()
    js.config.device_batch_size = BATCH
    ts = T.ExonSession(device="cpu", device_batch_size=BATCH)
    got = ts.read_fasta(files[key], sequence_data_type=kind).collect_arrow()
    want = js.read_fasta(files[key], sequence_data_type=kind).collect_arrow()
    assert got.schema.field("sequence").type == pa.list_(pa.int8())
    assert_same(got, want)


@pytest.mark.parametrize("host", [False, True], ids=["device", "host"])
def test_fasta_encoding_rejects_bad_bytes(files, monkeypatch, host):
    if host:
        monkeypatch.setenv("EXON_TPU_HOST_DECODE", "1")
    ts, js = T.ExonSession(device="cpu"), J.ExonSession.new_exon()
    with pytest.raises(InvalidSequenceError):
        ts.read_fasta(files["prot"], sequence_data_type=(
            "integer_encode_dna")).collect_arrow()
    with pytest.raises(JInvalidSequence):
        js.read_fasta(files["prot"], sequence_data_type=(
            "integer_encode_dna")).collect_arrow()


# ---------------------------------------------------------------------------
# (c) GFF attributes and nested access
# ---------------------------------------------------------------------------

ATTR_SQL = [
    "SELECT start, attributes FROM genes",
    "SELECT attributes['gene_type'] AS t, attributes['gene_type'][1] AS t1, "
    "attributes.gene_name AS g, attributes['missing'] AS m FROM genes",
    "SELECT attributes['tag'] AS t, attributes['tag'][2] AS t2, "
    "attributes['tag'][9] AS t9, attributes.Parent[1] AS p FROM genes",
    "SELECT attributes['gene_type'][1] AS gene_type, COUNT(*) AS n FROM "
    "genes WHERE type = 'gene' AND attributes['level'][1] IN ('1', '2') "
    "GROUP BY attributes['gene_type'][1] ORDER BY n DESC, gene_type",
    "SELECT type, COUNT(*) AS n FROM genes WHERE attributes['tag'][1] IS "
    "NOT NULL AND attributes['exon_number'][1] = '2' GROUP BY type ORDER BY "
    "type",
    "SELECT start FROM genes WHERE attributes.transcript_type[1] LIKE "
    "'%coding' ORDER BY start LIMIT 5",
]


@pytest.mark.parametrize("sql", ATTR_SQL,
                         ids=[f"q{i}" for i in range(len(ATTR_SQL))])
def test_gff_attribute_lookups_match_jax(sessions, sql):
    assert _both(sessions, sql).num_rows > 0


def test_gff_attribute_lookup_counts_genes(sessions, files):
    """N's census against the generator's own arrays."""
    from benchlib.gencode_gff_fixture import GENE_TYPES, gencode_features

    got = _both(sessions, ATTR_SQL[3])
    f = gencode_features(2500, seed=3)
    genes = (f["type"] == 0) & (f["level"] <= 1)
    counts = np.bincount(f["gene_type"][genes], minlength=len(GENE_TYPES))
    want = sorted(((GENE_TYPES[k], int(c)) for k, c in enumerate(counts)
                   if c), key=lambda t: (-t[1], t[0]))
    assert list(zip(got.column("gene_type").to_pylist(),
                    got.column("n").to_pylist())) == want


def _gtf_text(n=400, seed=2) -> bytes:
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        attrs = [f'gene_id "g{i % 37}"', f'transcript_id "t{i}"']
        if i % 3:
            attrs.append(f'exon_number "{1 + i % 5}"')
        if i % 7 == 0:
            attrs.append('tag "basic"')
        text = "; ".join(attrs) + (";" if i % 2 else "")
        if i % 11 == 0:
            text = ""
        lines.append(f"chr{1 + i % 3}\tsrc\texon\t{int(rng.integers(1, 9e5))}"
                     f"\t{i + 9}\t.\t+\t.\t{text}")
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("style", ["gtf", "gff"])
def test_parse_attributes_matches_jax(style):
    """The attribute parser on both styles, every array of its map column
    (map offsets and validity, keys, value lists and items) equal to the
    JAX parser's."""
    from exon_tpu_torch.formats.textutil import LineIndex, split_fields

    text = _gtf_text() if style == "gtf" else _gtf_text().replace(
        b'"', b"").replace(b" ", b"=").replace(b";=", b";")
    arr = np.frombuffer(text, np.uint8)
    li = LineIndex(arr)
    fs, fe, _present = split_fields(arr, li.starts, li.ends, 9)
    got = tattrmap.parse_attributes(arr, fs[:, 8], fe[:, 8], style)
    want = jattrmap.parse_attributes(arr, fs[:, 8], fe[:, 8], style)

    def arrays(m):
        kv = m.child
        vals = kv.children["values"]
        return [m.offsets, m.validity, kv.validity,
                kv.children["keys"].offsets, kv.children["keys"].values,
                vals.offsets, vals.validity, vals.child.offsets,
                vals.child.values]

    for g, w in zip(arrays(got), arrays(want)):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_nested_access_errors_match_jax(sessions):
    ts, js = sessions
    for sql in ("SELECT attributes[start] FROM genes",
                "SELECT start['x'] FROM genes"):
        with pytest.raises(PlanError):
            ts.sql(sql).collect_arrow()
        with pytest.raises(JPlanError):
            js.sql(sql).collect_arrow()


# ---------------------------------------------------------------------------
# (d) operators carrying list, struct and map columns
# ---------------------------------------------------------------------------

CARRY_SQL = [
    "SELECT start, attributes FROM genes WHERE strand = '+' AND start % 3 "
    "= 0",
    "SELECT start, attributes, integer_encode_dna(seqname) AS c FROM genes "
    "ORDER BY start DESC, type",
    "SELECT start, attributes['tag'] AS t FROM genes ORDER BY start LIMIT 11",
    "SELECT attributes FROM genes WHERE type = 'gene' UNION ALL SELECT "
    "attributes FROM genes WHERE type = 'CDS'",
    "SELECT name, quality_scores_to_list(quality_scores) AS q FROM fq WHERE "
    "name LIKE '%:1:%' ORDER BY name",
]


@pytest.mark.parametrize("sql", CARRY_SQL,
                         ids=["filter", "sort", "topk", "union",
                              "fastq_sort"])
def test_operators_carry_nested_columns(sessions, sql):
    assert _both(sessions, sql).num_rows > 0


def _scan_rows(ts) -> list:
    scan = ts.sql("SELECT start, type, attributes FROM genes").collect_arrow()
    return list(zip(*(scan.column(k).to_pylist()
                      for k in ("start", "type", "attributes"))))


def test_f29_join_carries_lists_past_its_input(sessions):
    """F29: a join whose output has more rows than its input (a gene, its
    first transcript and first exon share a start). The port takes each
    output row's map whole, the map its row holds in the scan, for an inner
    and a left join (checked against the scan's rows). The JAX
    ``take_column`` keeps a list's child at its input capacity: its inner
    join's maps overrun their buffers and the export fails."""
    ts, js = sessions
    rows = _scan_rows(ts)
    by_row: dict = {}
    for st, ty, at in rows:
        by_row.setdefault((st, ty), []).append(at)
    sql = ("SELECT a.start, a.type, a.attributes, b.type AS bt FROM genes a "
           "JOIN genes b ON a.start = b.start ORDER BY a.start, a.type, bt")
    got = ts.sql(sql).collect_arrow()
    assert got.num_rows > len(rows)
    for st, ty, at in zip(*(got.column(k).to_pylist()
                            for k in ("start", "type", "attributes"))):
        assert at in by_row[(st, ty)]
    with pytest.raises(pa.ArrowInvalid):
        js.sql(sql).collect_arrow()
    names: dict = {}
    for st, ty, at in rows:
        if ty == "gene":
            names.setdefault(st, []).append(dict(at)["gene_name"][0])
    got = ts.sql("SELECT a.start, b.attributes['gene_name'][1] AS g FROM "
                 "genes a LEFT JOIN (SELECT start, attributes FROM genes "
                 "WHERE type = 'gene') b ON a.start = b.start").collect_arrow()
    want = sorted((st, g) for st, _ty, _at in rows
                  for g in names.get(st, [None]))
    assert sorted(zip(got.column("start").to_pylist(),
                      got.column("g").to_pylist()),
                  key=lambda t: (t[0], t[1] or "")) == \
        sorted(want, key=lambda t: (t[0], t[1] or ""))


# ---------------------------------------------------------------------------
# (e) the JAX package's two layouts of a list of numbers
# ---------------------------------------------------------------------------


def test_from_numpy_batch_takes_both_jax_layouts():
    """A JAX batch holding one list<int64> as a VarColumn of wide values and
    the same list as a ListColumn over a FixedColumn, padded as the JAX
    package pads a device batch, becomes one port layout with the JAX
    package's Arrow export; a list of strings and a struct too."""
    from exon_tpu import datatypes as jdt

    rng = np.random.default_rng(4)
    lens = rng.integers(0, 6, 9)
    offs = np.zeros(10, np.int32)
    np.cumsum(lens, out=offs[1:])
    vals = rng.integers(-50, 50, int(offs[-1]))
    valid = rng.random(9) > 0.2
    strs = jb.utf8_column([f"s{i}" for i in range(int(offs[-1]))])
    schema = jdt.Schema.of(
        jdt.Field("var", jdt.list_(jdt.int64)),
        jdt.Field("list", jdt.list_(jdt.int64)),
        jdt.Field("strs", jdt.list_(jdt.utf8)),
        jdt.Field("st", jdt.struct([jdt.Field("a", jdt.int64),
                                    jdt.Field("b", jdt.list_(jdt.utf8))])))
    cols = [jb.VarColumn(vals, offs, valid),
            jb.ListColumn(jb.fixed_column(vals), offs, valid),
            jb.ListColumn(strs, offs, valid),
            jb.StructColumn({"a": jb.fixed_column(np.arange(9)),
                             "b": jb.ListColumn(strs, offs, valid)},
                            np.ones(9, bool))]
    jbatch = jb.Batch(schema, cols, np.int32(9)).to_device()
    assert jbatch.capacity > 9  # padded rows and elements
    got = tb.from_numpy_batch(jbatch)
    assert isinstance(got.columns[0], tb.ListColumn)
    assert isinstance(got.columns[0].child, tb.FixedColumn)
    assert np.array_equal(got.columns[0].child.values,
                          got.columns[1].child.values)
    assert got.to_arrow().equals(jbatch.to_arrow())
    assert tb.Batch.from_arrow(got.to_arrow(), got.schema).to_arrow().equals(
        got.to_arrow())


# ---------------------------------------------------------------------------
# (f) faults and conventions
# ---------------------------------------------------------------------------


def test_f23_struct_validity_is_not_exported():
    """F23 (a convention followed): a NULL struct row exports as a valid
    struct whose children carry the NULLs, as the JAX export does; with the
    struct's own mask Arrow would give a NULL row."""
    child = tb.ListColumn(tb.FixedColumn(np.arange(3.0), np.ones(3, bool)),
                          np.array([0, 3, 3], np.int32),
                          np.array([True, False]))
    col = tb.StructColumn({"mz": child}, np.array([True, False]))
    dtype = T.datatypes.struct([T.datatypes.Field(
        "mz", T.datatypes.list_(T.datatypes.float64))])
    schema = T.Schema.of(T.datatypes.Field("mz", dtype))
    got = tb.Batch(schema, [col], 2).to_arrow().column(0).to_pylist()
    assert got == [{"mz": [0.0, 1.0, 2.0]}, {"mz": None}]
    jcol = jb.StructColumn({"mz": jb.ListColumn(
        jb.fixed_column(np.arange(3.0)), np.array([0, 3, 3], np.int32),
        np.array([True, False]))}, np.array([True, False]))
    want = jb._column_to_arrow(jcol, J.datatypes.struct([J.datatypes.Field(
        "mz", J.datatypes.list_(J.datatypes.float64))]), 2)
    assert want.to_pylist() == got
    masked = pa.StructArray.from_arrays(
        [pa.array([[0.0, 1.0, 2.0], None])], ["mz"],
        mask=pa.array([False, True]))
    assert masked.to_pylist() == [{"mz": [0.0, 1.0, 2.0]}, None]


def test_f24_null_map_is_exported_null(tmp_path):
    """F24: a GFF line with an empty attribute field has a NULL map. The
    port exports NULL; the JAX export drops the map's mask and gives an
    empty map."""
    from exon_tpu.formats import gff as jgff
    from exon_tpu_torch.formats import gff as tgff

    data = (b"chr1\tx\tgene\t1\t2\t.\t+\t.\tID=a\n"
            b"chr1\tx\tgene\t3\t4\t.\t+\t.\t\n")
    (got,) = tgff.decode_host(data, tgff.GffOptions(), ["attributes"])
    (want,) = jgff.decode_host(data, jgff.GffOptions(), ["attributes"])
    assert got.to_arrow().column(0).to_pylist() == [[("ID", ["a"])], None]
    assert want.to_arrow().column(0).to_pylist() == [[("ID", ["a"])], []]


def _tiny_mzml(path) -> str:
    """Three spectra of float64 m/z and intensity arrays, uncompressed."""
    import base64

    def arr(vals, acc):
        text = base64.b64encode(np.asarray(vals, "<f8").tobytes()).decode()
        return ('<binaryDataArray><cvParam accession="MS:1000523"/>'
                f'<cvParam accession="{acc}"/><binary>{text}</binary>'
                "</binaryDataArray>")

    spectra = "".join(
        f'<spectrum id="scan={i}"><binaryDataArrayList>'
        f'{arr([100.0 + i, 200.5 + i, 300.25], "MS:1000514")}'
        f'{arr([1.0, 2.0, 3.0], "MS:1000515")}</binaryDataArrayList>'
        "</spectrum>" for i in range(3))
    path.write_text(f'<mzML xmlns="http://psi.hupo.org/ms/mzml"><run>'
                    f"<spectrumList>{spectra}</spectrumList></run></mzML>")
    return str(path)


def test_f26_subscript_on_jax_var_layout(tmp_path, sessions):
    """F26: ``a[i]`` on a list of numbers. The JAX package keeps mzML peaks
    as a VarColumn of float64 and its subscript raises PlanError there; the
    port's one list layout gives the element, what array_element gives in
    both packages."""
    path = _tiny_mzml(tmp_path / "t.mzML")
    ts, js = sessions
    sql = f"SELECT mz.mz[2] AS e FROM mzml_scan('{path}')"
    got = ts.sql(sql).collect_arrow().column("e").to_pylist()
    want = js.sql(f"SELECT array_element(mz.mz, 2) AS e FROM mzml_scan("
                  f"'{path}')").collect_arrow().column("e").to_pylist()
    assert got == want == [200.5, 201.5, 202.5]
    with pytest.raises(JPlanError, match="subscript"):
        js.sql(sql).collect_arrow()


def _scan_rows(ts) -> list:
    scan = ts.sql("SELECT start, type, attributes FROM genes").collect_arrow()
    return list(zip(*(scan.column(k).to_pylist()
                      for k in ("start", "type", "attributes"))))


def test_f29_join_carries_lists_past_its_input(sessions):
    """F29: a join whose output has more rows than its input (a gene, its
    first transcript and first exon share a start). The port takes each
    output row's map whole, the map its row holds in the scan, for an inner
    and a left join (checked against the scan's rows). The JAX
    ``take_column`` keeps a list's child at its input capacity: its inner
    join's maps overrun their buffers and the export fails."""
    ts, js = sessions
    rows = _scan_rows(ts)
    by_row: dict = {}
    for st, ty, at in rows:
        by_row.setdefault((st, ty), []).append(at)
    sql = ("SELECT a.start, a.type, a.attributes, b.type AS bt FROM genes a "
           "JOIN genes b ON a.start = b.start ORDER BY a.start, a.type, bt")
    got = ts.sql(sql).collect_arrow()
    assert got.num_rows > len(rows)
    for st, ty, at in zip(*(got.column(k).to_pylist()
                            for k in ("start", "type", "attributes"))):
        assert at in by_row[(st, ty)]
    with pytest.raises(pa.ArrowInvalid):
        js.sql(sql).collect_arrow()
    names: dict = {}
    for st, ty, at in rows:
        if ty == "gene":
            names.setdefault(st, []).append(dict(at)["gene_name"][0])
    got = ts.sql("SELECT a.start, b.attributes['gene_name'][1] AS g FROM "
                 "genes a LEFT JOIN (SELECT start, attributes FROM genes "
                 "WHERE type = 'gene') b ON a.start = b.start").collect_arrow()
    want = sorted((st, g) for st, _ty, _at in rows
                  for g in names.get(st, [None]))
    assert sorted(zip(got.column("start").to_pylist(),
                      got.column("g").to_pylist()),
                  key=lambda t: (t[0], t[1] or "")) == \
        sorted(want, key=lambda t: (t[0], t[1] or ""))


# ---------------------------------------------------------------------------
# (e) the JAX package's two layouts of a list of numbers
# ---------------------------------------------------------------------------


def test_from_numpy_batch_takes_both_jax_layouts():
    """A JAX batch holding one list<int64> as a VarColumn of wide values and
    the same list as a ListColumn over a FixedColumn, padded as the JAX
    package pads a device batch, becomes one port layout with the JAX
    package's Arrow export; a list of strings and a struct too."""
    from exon_tpu import datatypes as jdt

    rng = np.random.default_rng(4)
    lens = rng.integers(0, 6, 9)
    offs = np.zeros(10, np.int32)
    np.cumsum(lens, out=offs[1:])
    vals = rng.integers(-50, 50, int(offs[-1]))
    valid = rng.random(9) > 0.2
    strs = jb.utf8_column([f"s{i}" for i in range(int(offs[-1]))])
    schema = jdt.Schema.of(
        jdt.Field("var", jdt.list_(jdt.int64)),
        jdt.Field("list", jdt.list_(jdt.int64)),
        jdt.Field("strs", jdt.list_(jdt.utf8)),
        jdt.Field("st", jdt.struct([jdt.Field("a", jdt.int64),
                                    jdt.Field("b", jdt.list_(jdt.utf8))])))
    cols = [jb.VarColumn(vals, offs, valid),
            jb.ListColumn(jb.fixed_column(vals), offs, valid),
            jb.ListColumn(strs, offs, valid),
            jb.StructColumn({"a": jb.fixed_column(np.arange(9)),
                             "b": jb.ListColumn(strs, offs, valid)},
                            np.ones(9, bool))]
    jbatch = jb.Batch(schema, cols, np.int32(9)).to_device()
    assert jbatch.capacity > 9  # padded rows and elements
    got = tb.from_numpy_batch(jbatch)
    assert isinstance(got.columns[0], tb.ListColumn)
    assert isinstance(got.columns[0].child, tb.FixedColumn)
    assert np.array_equal(got.columns[0].child.values,
                          got.columns[1].child.values)
    assert got.to_arrow().equals(jbatch.to_arrow())
    assert tb.Batch.from_arrow(got.to_arrow(), got.schema).to_arrow().equals(
        got.to_arrow())


# ---------------------------------------------------------------------------
# (f) faults and conventions
# ---------------------------------------------------------------------------


def test_f23_struct_validity_is_not_exported():
    """F23 (a convention followed): a NULL struct row exports as a valid
    struct whose children carry the NULLs, as the JAX export does; with the
    struct's own mask Arrow would give a NULL row."""
    child = tb.ListColumn(tb.FixedColumn(np.arange(3.0), np.ones(3, bool)),
                          np.array([0, 3, 3], np.int32),
                          np.array([True, False]))
    col = tb.StructColumn({"mz": child}, np.array([True, False]))
    dtype = T.datatypes.struct([T.datatypes.Field(
        "mz", T.datatypes.list_(T.datatypes.float64))])
    schema = T.Schema.of(T.datatypes.Field("mz", dtype))
    got = tb.Batch(schema, [col], 2).to_arrow().column(0).to_pylist()
    assert got == [{"mz": [0.0, 1.0, 2.0]}, {"mz": None}]
    jcol = jb.StructColumn({"mz": jb.ListColumn(
        jb.fixed_column(np.arange(3.0)), np.array([0, 3, 3], np.int32),
        np.array([True, False]))}, np.array([True, False]))
    want = jb._column_to_arrow(jcol, J.datatypes.struct([J.datatypes.Field(
        "mz", J.datatypes.list_(J.datatypes.float64))]), 2)
    assert want.to_pylist() == got
    masked = pa.StructArray.from_arrays(
        [pa.array([[0.0, 1.0, 2.0], None])], ["mz"],
        mask=pa.array([False, True]))
    assert masked.to_pylist() == [{"mz": [0.0, 1.0, 2.0]}, None]


def test_f24_null_map_is_exported_null(tmp_path):
    """F24: a GFF line with an empty attribute field has a NULL map. The
    port exports NULL; the JAX export drops the map's mask and gives an
    empty map."""
    from exon_tpu.formats import gff as jgff
    from exon_tpu_torch.formats import gff as tgff

    data = (b"chr1\tx\tgene\t1\t2\t.\t+\t.\tID=a\n"
            b"chr1\tx\tgene\t3\t4\t.\t+\t.\t\n")
    (got,) = tgff.decode_host(data, tgff.GffOptions(), ["attributes"])
    (want,) = jgff.decode_host(data, jgff.GffOptions(), ["attributes"])
    assert got.to_arrow().column(0).to_pylist() == [[("ID", ["a"])], None]
    assert want.to_arrow().column(0).to_pylist() == [[("ID", ["a"])], []]


def test_f26_subscript_on_jax_var_layout(tmp_path, sessions):
    """F26: ``a[i]`` on a list of numbers. The JAX package keeps mzML peaks
    as a VarColumn of float64 and its subscript raises PlanError there; the
    port's one list layout gives the element, what array_element gives in
    both packages."""
    from benchlib.fixtures import make_mzml

    path = make_mzml(12)
    ts, js = sessions
    sql = f"SELECT mz.mz[2] AS e FROM mzml_scan('{path}')"
    got = ts.sql(sql).collect_arrow().column("e").to_pylist()
    want = js.sql(f"SELECT array_element(mz.mz, 2) AS e FROM mzml_scan("
                  f"'{path}')").collect_arrow().column("e").to_pylist()
    assert got == want and len(got) == 12
    with pytest.raises(JPlanError, match="subscript"):
        js.sql(sql).collect_arrow()
