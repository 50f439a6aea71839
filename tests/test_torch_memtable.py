"""SQL SET and memory tables in exon_tpu_torch (slice 11, item 14) held to
exon_tpu: ``SET``, ``CREATE TABLE t (cols)``, ``CREATE TABLE t AS VALUES``
and ``AS SELECT``, ``INSERT INTO … VALUES``, a bare ``VALUES``, DESCRIBE,
SHOW TABLES and DROP TABLE, run statement by statement through both
``ExonSession.sql``s, and their errors. An Arrow table given to
``register_table`` is a memory table too. The Arrow tables of every
statement must be equal: values, types and nulls. A session flag set by
SQL reaches the scans that read it (``exon.vcf_parse_info``)."""

import numpy as np
import pyarrow as pa
import pytest

import exon_tpu as J
from exon_tpu.sql.frontend import MemTable as JMemTable
import exon_tpu_torch as T
from exon_tpu_torch.errors import PlanError, SqlError
from exon_tpu_torch.tables import MEM_BATCH_ROWS, MemTable

from benchlib.gff_fixture import make_gff


@pytest.fixture
def sessions():
    return T.ExonSession(device="cpu"), J.ExonSession.new_exon()


@pytest.fixture(scope="module")
def gff(tmp_path_factory):
    return make_gff(300, 11, path=str(tmp_path_factory.mktemp("mem") /
                                      "g.gff3"))


SCRIPTS = {
    "set": ["SET exon.partitioned_join = true", "SET exon.distributed = false",
            "SET batch_size = 4096", "SET n_shards = 2"],
    "create_insert_select": [
        "CREATE TABLE t (k INT, name VARCHAR, x DOUBLE, ok BOOLEAN, "
        "f REAL)", "DESCRIBE t", "SELECT * FROM t",
        "INSERT INTO t VALUES (1, 'a', 1.5, true, 0.5), (2, NULL, 3, false,"
        " 2), (NULL, 'c', NULL, NULL, NULL)",
        "INSERT INTO t (k, name, x, ok, f) VALUES (7, 'd', -1, true, 8)",
        "SELECT * FROM t", "SELECT k, name FROM t WHERE x > 0 ORDER BY k",
        "SELECT name, count(*) AS n, sum(x) AS s FROM t GROUP BY name "
        "ORDER BY name", "SHOW TABLES", "DESCRIBE t"],
    "create_as_values": [
        "CREATE TABLE v AS VALUES (1, 'q', 2.5), (2, 'r', 3), (3, NULL, "
        "NULL)", "DESCRIBE v", "SELECT * FROM v",
        "INSERT INTO v VALUES (4, 's', 1)", "SELECT column1, column3 FROM v "
        "WHERE column2 IS NOT NULL"],
    "create_as_values_named": [
        "CREATE TABLE w (a BIGINT, b TEXT) AS VALUES (5, 'x'), (6, 'y')",
        "DESCRIBE w", "SELECT b, a * 2 AS twice FROM w"],
    "create_as_select": [
        "CREATE TABLE g AS SELECT seqname, start, \"end\" - start AS len "
        "FROM gff_scan('{gff}') WHERE type = 'exon'", "DESCRIBE g",
        "SELECT seqname, count(*) AS n, max(len) AS m FROM g GROUP BY "
        "seqname ORDER BY seqname"],
    "if_not_exists": [
        "CREATE TABLE e (k INT)", "INSERT INTO e VALUES (1), (2)",
        "CREATE TABLE IF NOT EXISTS e (z TEXT)", "SELECT * FROM e",
        "DROP TABLE e", "SHOW TABLES"],
    "bare_values": ["VALUES (1, 2.5, 'x'), (3, 4, NULL)",
                    "VALUES (true), (false), (NULL)"],
    "join_memory_and_file": [
        "CREATE TABLE seqs AS VALUES ('chr1', 1), ('chr2', 2), ('chrZ', 9)",
        "SELECT column2, count(*) AS n FROM gff_scan('{gff}') g JOIN seqs "
        "ON g.seqname = seqs.column1 GROUP BY column2 ORDER BY column2"],
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_statements_match_jax(sessions, gff, name):
    ts, js = sessions
    for sql in SCRIPTS[name]:
        sql = sql.format(gff=gff)
        got, want = ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow()
        assert got.equals(want), (sql, got, want)
    if name == "set":
        assert ts.config.partitioned_join and not ts.config.distributed
        assert (ts.config.batch_size, ts.config.n_shards) == (4096, 2)


@pytest.mark.parametrize("sql,error", [
    ("CREATE TABLE bad (x FOO)", "SqlError"),
    ("INSERT INTO genes VALUES (1, 2)", "PlanError"),
    ("INSERT INTO nowhere VALUES (1)", "PlanError"),
    ("SET exon.no_such_flag = true", "KeyError"),
    ("SET no_such_option = 1", "KeyError"),
], ids=["unknown_type", "insert_file_table", "insert_missing", "set_flag",
        "set_option"])
def test_statement_errors_match_jax(sessions, gff, sql, error):
    ts, js = sessions
    for s in sessions:
        s.sql(f"CREATE EXTERNAL TABLE genes STORED AS GFF LOCATION '{gff}'")
    for s in (ts, js):
        with pytest.raises(Exception) as e:
            s.sql(sql).collect_arrow()
        assert type(e.value).__name__ == error


def test_port_only_errors(sessions):
    """The port raises where pyarrow would: an all-NULL VALUES column has no
    type, a column may not mix strings and numbers, and an INSERT names
    every column of its table."""
    ts, _js = sessions
    for sql in ("VALUES (NULL), (NULL)", "VALUES (1), ('a')"):
        with pytest.raises(SqlError):
            ts.sql(sql)
    ts.sql("CREATE TABLE t (a INT, b INT)")
    with pytest.raises(PlanError, match="every column"):
        ts.sql("INSERT INTO t (a) VALUES (1)")


def test_register_arrow_table(sessions):
    """An Arrow table registered is a MemTable of host batches, scanned in
    batches of MEM_BATCH_ROWS rows: ints, floats, strings with NULLs, a
    dictionary (decoded to strings) and a list column."""
    ts, js = sessions
    n = 2 * MEM_BATCH_ROWS + 5
    rng = np.random.default_rng(3)
    tab = pa.table({
        "k": pa.array(rng.integers(0, 50, n).astype(np.int64)),
        "x": pa.array(rng.random(n)),
        "s": pa.array([None if i % 9 == 0 else f"s{i % 17}"
                       for i in range(n)]),
        "d": pa.array([f"d{i % 3}" for i in range(n)]).dictionary_encode(),
        "l": pa.array([[i, i + 1] if i % 5 else None for i in range(n)],
                      pa.list_(pa.int64())),
    })
    ts.register_table("m", tab)
    js.register_table("m", JMemTable(tab.set_column(
        3, "d", tab.column("d").cast(pa.utf8()))))
    assert isinstance(ts.tables["m"], MemTable)
    df = ts.table("m")
    sizes = [b.length for b in df._execute(df.logical_plan()).batches()]
    assert sizes == [MEM_BATCH_ROWS, MEM_BATCH_ROWS, 5]
    for sql in ("SELECT * FROM m", "SELECT d, s, count(*) AS n, sum(x) AS t "
                "FROM m GROUP BY d, s ORDER BY d, s", "DESCRIBE m"):
        got, want = ts.sql(sql).collect_arrow(), js.sql(sql).collect_arrow()
        assert got.schema == want.schema
        for c in got.column_names:
            x, y = got.column(c).to_pylist(), want.column(c).to_pylist()
            if c == "t":  # float64 sums, added in another order
                np.testing.assert_allclose(x, y, rtol=1e-12)
            else:
                assert x == y, c


def test_set_parse_flag_reaches_the_scan(sessions, tmp_path):
    """SET exon.vcf_parse_info = true gives later VCF scans in SQL the
    typed INFO struct, as read_vcf(parse_info=True) does, and as the JAX
    session's flag does."""
    lines = [b"##fileformat=VCFv4.2", b"##contig=<ID=chr1,length=100000>",
             b'##INFO=<ID=DP,Number=1,Type=Integer,Description="Depth">',
             b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO"]
    lines += [b"chr1\t%d\t.\tA\tC\t%d\tPASS\tDP=%d" % (100 * i, i, i % 7)
              for i in range(1, 40)]
    path = tmp_path / "a.vcf"
    path.write_bytes(b"\n".join(lines) + b"\n")
    path = str(path)
    ts, js = sessions
    q = f"SELECT chrom, pos, info FROM vcf_scan('{path}')"
    plain = ts.sql(q).collect_arrow()
    for s in (ts, js):
        s.sql("SET exon.vcf_parse_info = true")
    got = ts.sql(q).collect_arrow()
    assert got.schema != plain.schema
    assert got.equals(ts.read_vcf(path, parse_info=True).select(
        "chrom", "pos", "info").collect_arrow())
    assert got.equals(js.sql(q).collect_arrow())
