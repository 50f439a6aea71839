"""exon_tpu_torch stands alone: in a subprocess where jax, pyarrow,
exon_tpu and triton cannot be imported, the package imports and runs
Query B, a small Query D (mate pairing: a left join on the read name and
a sort), a small FASTQ adapter screen on the device decode path and SQL
(CREATE EXTERNAL TABLE, CASE, CAST, ordered string compares), on the CPU
through the pyarrow-free host accessor. The checks are exact against
numpy on the generators' arrays. No module of the package names jax or
exon_tpu in an import statement."""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import sys
    for name in ("jax", "pyarrow", "exon_tpu", "triton"):
        sys.modules[name] = None
    import numpy as np
    import exon_tpu_torch as T
    from benchlib.gff_fixture import FEATURE_TYPES, SEQNAMES, gff_features, make_gff

    path = make_gff(3000, seed=2, path=sys.argv[1])
    c = T.col
    host = (T.ExonSession(device="cpu", device_batch_size=700)
            .read_gff(path).filter(c("type") == "exon")
            .aggregate(["seqname"], [T.count().alias("n"),
                                     T.max_(c("end"))])
            .collect_host())
    f = gff_features(3000, seed=2)
    m = f["type"] == FEATURE_TYPES.index("exon")
    seq, end = f["seqname"][m], f["end"][m]
    _u, first = np.unique(seq, return_index=True)
    order = seq[np.sort(first)]
    keys = host.columns[0]
    assert [keys.vocab[k] for k in keys.codes] == [SEQNAMES[s] for s in order]
    assert host.columns[1].values.tolist() == \\
        np.bincount(seq)[order].tolist()
    assert host.columns[2].values.tolist() == \\
        [int(end[seq == s].max()) for s in order]
    leaked = [m for m in ("jax", "pyarrow", "exon_tpu", "triton")
              if sys.modules.get(m) is not None]
    assert not leaked, leaked
    print("standalone ok", host.length)
""")


def test_port_runs_without_jax_pyarrow_or_exon_tpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT,
                           str(tmp_path / "b.gff3")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "standalone ok" in proc.stdout


SCRIPT_D = textwrap.dedent("""
    import sys
    for name in ("jax", "pyarrow", "exon_tpu", "triton"):
        sys.modules[name] = None
    import numpy as np
    import exon_tpu_torch as T
    from benchlib.bam_fixture import bam_reads, make_bam
    from benchlib.gff_fixture import SEQNAMES

    path = make_bam(300, seed=4, path=sys.argv[1])
    c = T.col
    s = T.ExonSession(device="cpu", device_batch_size=128)
    r1 = s.read_bam(path).filter((c("flag") / 64) % 2 == 1).select(
        "name", "reference", "start", "flag")
    r2 = s.read_bam(path).filter((c("flag") / 128) % 2 == 1).select(
        c("name").alias("mate_name"), c("start").alias("mate_start"))
    host = r1.join(r2, on=[("name", "mate_name")], how="left").sort(
        "reference", "start", "name").collect_host()
    r = bam_reads(300, seed=4)
    first = r["flag"] != 147
    # reference sorts by its name's bytes: chr1 < chr10 < ... < chrY
    order = np.lexsort((r["names"][r["template"][first]], r["start"][first],
                        np.asarray(SEQNAMES)[r["reference"][first]]))
    assert host.length == 300
    assert host.column("start").values.tolist() == \\
        r["start"][first][order].tolist()
    mates = host.column("mate_start")
    want = r["mate_start"][first][order]
    assert mates.validity.tolist() == (want > 0).tolist()
    assert mates.values[want > 0].tolist() == want[want > 0].tolist()
    leaked = [m for m in ("jax", "pyarrow", "exon_tpu", "triton")
              if sys.modules.get(m) is not None]
    assert not leaked, leaked
    print("standalone ok", host.length)
""")


def test_port_joins_and_sorts_without_jax_pyarrow_or_exon_tpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT_D,
                           str(tmp_path / "p.bam")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "standalone ok 300" in proc.stdout


SCRIPT_E = textwrap.dedent("""
    import os, sys
    for name in ("jax", "pyarrow", "exon_tpu", "triton"):
        sys.modules[name] = None
    os.environ.pop("EXON_TPU_HOST_DECODE", None)
    import exon_tpu_torch as T
    from benchlib.fastq_fixture import adapter_rows, fastq_reads, make_fastq

    path = make_fastq(1500, seed=6, path=sys.argv[1])
    s = T.ExonSession(device="cpu")
    host = s.read_fastq(path).filter(
        T.col("sequence").like("%AGATCGGAAGAGC%")).select(
        "name", "sequence").collect_host()
    r = fastq_reads(1500, seed=6)
    rows = adapter_rows(r)
    names = host.column("name")
    got = [bytes(names.values[a:b]) for a, b in
           zip(names.offsets[:-1], names.offsets[1:])]
    assert got == r["names"][rows].tolist()
    assert host.column("sequence").values.tobytes() == \\
        r["sequences"][rows].tobytes()
    leaked = [m for m in ("jax", "pyarrow", "exon_tpu", "triton")
              if sys.modules.get(m) is not None]
    assert not leaked, leaked
    print("standalone ok", host.length)
""")


def test_port_decodes_fastq_on_the_device_path_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT_E,
                           str(tmp_path / "r.fastq")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "standalone ok" in proc.stdout


SCRIPT_SQL = textwrap.dedent("""
    import sys
    for name in ("jax", "pyarrow", "exon_tpu", "triton"):
        sys.modules[name] = None
    import numpy as np
    import exon_tpu_torch as T
    from benchlib.gff_fixture import FEATURE_TYPES, SEQNAMES, gff_features, make_gff

    path = make_gff(3000, seed=3, path=sys.argv[1])
    s = T.ExonSession(device="cpu", device_batch_size=700)
    s.sql(f"CREATE EXTERNAL TABLE genes STORED AS GFF LOCATION '{path}'")
    host = s.sql(
        "SELECT seqname, CASE WHEN strand = '+' THEN 'fwd' ELSE 'rev' END "
        "AS dir, COUNT(*) AS n, SUM(CAST(CAST(start AS VARCHAR) AS BIGINT)) "
        "AS s, SUM(CAST(CAST(\\"end\\" AS VARCHAR) AS DOUBLE)) AS e "
        "FROM genes WHERE type = 'exon' AND seqname >= 'chr2' "
        "GROUP BY seqname, dir").collect_host()
    f = gff_features(3000, seed=3)
    names = np.asarray(SEQNAMES)[f["seqname"]]
    m = (f["type"] == FEATURE_TYPES.index("exon")) & (names >= "chr2")
    fwd = f["strand"] == 0
    want = {}
    for i in np.flatnonzero(m):
        k = (names[i], "fwd" if fwd[i] else "rev")
        n, a, b = want.get(k, (0, 0, 0.0))
        want[k] = (n + 1, a + int(f["start"][i]), b + float(f["end"][i]))
    seq, d = host.columns[0], host.columns[1]
    got = {(seq.vocab[seq.codes[i]], d.vocab[d.codes[i]]):
           (int(host.columns[2].values[i]), int(host.columns[3].values[i]),
            float(host.columns[4].values[i])) for i in range(host.length)}
    assert got.keys() == want.keys()
    for k, (n, a, b) in want.items():
        assert got[k][:2] == (n, a) and abs(got[k][2] - b) <= 1e-9 * b, k
    leaked = [m for m in ("jax", "pyarrow", "exon_tpu", "triton")
              if sys.modules.get(m) is not None]
    assert not leaked, leaked
    print("standalone ok", host.length)
""")


def test_port_runs_sql_without_jax_pyarrow_or_exon_tpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SCRIPT_SQL,
                           str(tmp_path / "s.gff3")], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "standalone ok" in proc.stdout


PORT_MODULES = sorted(
    str(p.relative_to(ROOT))
    for p in pathlib.Path(ROOT, "exon_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("module", PORT_MODULES)
def test_port_module_imports_neither_jax_nor_exon_tpu(module):
    tree = ast.parse(pathlib.Path(ROOT, module).read_text())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    roots = {n.split(".")[0] for n in names}
    assert not roots & {"jax", "jaxlib", "exon_tpu"}, roots
