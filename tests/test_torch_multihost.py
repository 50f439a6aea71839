"""Multi-process distributed execution of exon_tpu_torch: 2 and 3 gloo
processes × 4 CPU shards each, over the FASTA files of
tests/test_multihost.py (4 files, and 9 files: the uneven 5/4 and 3/3/3
splits, where a process runs out of files a wave early and takes empty
waves).

Each process is ``python tests/test_torch_multihost.py worker ...`` (the
``__main__`` block below), started over ``tcp://127.0.0.1:<free port>``
through the session's ``EXON_TPU_*`` variables, with a time limit of its
own; it runs every query of ``QUERIES`` through ``ExonSession.sql``, checks
that its plan holds the distributed operator named there, and writes what
it got as JSON: the aggregates and the TopK of tests/test_multihost.py, a
broadcast join (its build side an aggregate on the mesh, or a memory
table), a LEFT join with an ON residual, a PARTITION BY window, the
partitioned join under ``SET exon.partitioned_join = true``, a full ORDER
BY (``DistributedSortExec``), and a LIMIT and an OFFSET past the TopK's
largest fetch (``MAX_DIST_TOPK``, set to 16 in the workers), which go to
the distributed sort with their skip + fetch. The answers must be
identical on every process and equal to the answer of one process on one
device (sorted, where the query has no ORDER BY); every process must have
decoded only its own files (``iter_scan_files`` gave it ``files[p::P]``),
but for the build side of a broadcast join, which every process reads
whole."""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER_TIMEOUT = 120  # seconds, each process
LOCAL_SHARDS = 4


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _write_files(d: str, n_files: int, per_file: int) -> None:
    os.makedirs(d, exist_ok=True)
    for f in range(n_files):
        lines = []
        for i in range(per_file):
            desc = f"group{i % 5}"
            seq = ("ACGT" if i % 3 else "TTGA") * 4
            lines.append(f">f{f}r{i} {desc}\n{seq}\n")
        with open(os.path.join(d, f"part{f}.fasta"), "w") as fh:
            fh.write("".join(lines))


def _run_workers(tmp_path, data_dir: str, n_procs: int) -> dict:
    port = _free_port()
    procs, outs = [], []
    for pid in range(n_procs):
        out = str(tmp_path / f"result_{pid}.json")
        outs.append(out)
        env = dict(os.environ)
        env.update({"EXON_TPU_COORDINATOR": f"127.0.0.1:{port}",
                    "EXON_TPU_NUM_PROCESSES": str(n_procs),
                    "EXON_TPU_PROCESS_ID": str(pid),
                    "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "worker", data_dir,
             out], env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    errs = []
    try:
        for p in procs:
            _out, err = p.communicate(timeout=WORKER_TIMEOUT)
            errs.append(err.decode(errors="replace")[-3000:])
    except subprocess.TimeoutExpired:
        pytest.fail("multi-process workers timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0] * n_procs, errs
    results = [json.load(open(o)) for o in outs]
    for r in results[1:]:
        assert r["answers"] == results[0]["answers"]
    for pid, r in enumerate(results):
        mine = len(range(pid, r["n_files"], n_procs))
        for name, calls in r["shard_calls"].items():
            # a broadcast join's build side reads every file
            whole = r["n_files"] if QUERIES[name][2] else mine
            assert calls and all(tot == r["n_files"] and got in (mine, whole)
                                 for tot, got in calls), (name, calls)
            assert any(got == mine for _tot, got in calls), (name, calls)
    want = _one_process(data_dir)
    for name, (_q, ordered, _b) in QUERIES.items():
        got = results[0]["answers"][name]
        if not ordered:
            got, want[name] = _sorted(got), _sorted(want[name])
        assert got == want[name], name
    return results[0]["answers"]


def _sorted(rows: list) -> list:
    return sorted(rows, key=lambda r: json.dumps(r, sort_keys=True))


def _one_process(data_dir: str) -> dict:
    """Every query's answer from one process on one device."""
    import exon_tpu_torch as T

    s = T.ExonSession(device="cpu")
    for sql in SETUP:
        s.sql(sql.format(data_dir=data_dir))
    return {name: json.loads(json.dumps(s.sql(q).collect_arrow().to_pylist()))
            for name, (q, _o, _b) in QUERIES.items()}


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """The answers of 2 processes over 4 files of 50 records."""
    tmp_path = tmp_path_factory.mktemp("two_process")
    data_dir = str(tmp_path / "fasta")
    _write_files(data_dir, 4, 50)
    return _run_workers(tmp_path, data_dir, 2)


def test_two_process_parity(two_process):
    got = two_process
    assert got["count_star"] == [{"n": 200}]
    assert got["group_by"] == [
        {"description": f"group{i}", "n": 40} for i in range(5)]
    expect = []
    for d in range(5):
        c = sum(1 for i in range(50) if i % 5 == d and i % 3 != 0) * 4
        expect.append({"description": f"group{d}", "n": c})
    assert got["filtered_group_by"] == expect
    ids = sorted(f"f{f}r{i}" for f in range(4) for i in range(0, 50, 5))
    assert got["topk"] == [
        {"id": i, "description": "group0"} for i in ids[:4]]


@pytest.mark.parametrize("n_procs", [2, 3])
def test_uneven_files(tmp_path, n_procs):
    """9 files over 2 processes (5/4) or 3 (3/3/3), 4 shards each."""
    data_dir = str(tmp_path / "fasta9")
    _write_files(data_dir, 9, 20)
    got = _run_workers(tmp_path, data_dir, n_procs)
    assert got["count_star"] == [{"n": 180}]
    assert got["group_by"] == [
        {"description": f"group{i}", "n": 36} for i in range(5)]
    expect = []
    for d in range(5):
        c = sum(1 for i in range(20) if i % 5 == d and i % 3 != 0) * 9
        expect.append({"description": f"group{d}", "n": c})
    assert got["filtered_group_by"] == expect
    ids = sorted(f"f{f}r{i}" for f in range(9) for i in range(0, 20, 5))
    assert got["topk"] == [
        {"id": i, "description": "group0"} for i in ids[:4]]


SETUP = ["CREATE EXTERNAL TABLE t STORED AS FASTA LOCATION '{data_dir}'",
         "CREATE TABLE m AS VALUES ('group1', 10), ('group3', 30), "
         "('group9', 90)"]
SMALL_TOPK = 16  # MAX_DIST_TOPK in the workers
# name: (SQL, whether its ORDER BY fixes the row order, whether its plan
# holds a broadcast join, whose build side every process reads whole)
QUERIES = {
    "count_star": ("SELECT COUNT(*) AS n FROM t", True, False),
    "group_by": ("SELECT description, COUNT(*) AS n FROM t GROUP BY "
                 "description ORDER BY description", True, False),
    "filtered_group_by": ("SELECT description, COUNT(*) AS n FROM t WHERE "
                          "sequence LIKE 'AC%' GROUP BY description ORDER BY "
                          "description", True, False),
    "topk": ("SELECT id, description FROM t ORDER BY description, id "
             "LIMIT 4", True, False),
    "join": ("SELECT a.id, b.n FROM t a JOIN (SELECT description, COUNT(*) "
             "AS n FROM t GROUP BY description) b ON a.description = "
             "b.description", False, True),
    "left_join_residual": ("SELECT a.id, b.id AS bid FROM t a LEFT JOIN t b "
                           "ON a.id = b.id AND b.sequence LIKE 'TT%'", False,
                           True),
    "memory_join": ("SELECT t.id, m.column2 FROM t JOIN m ON t.description "
                    "= m.column1", False, True),
    "window": ("SELECT id, row_number() OVER (PARTITION BY description ORDER "
               "BY id) AS rn, count(*) OVER (PARTITION BY description) AS n "
               "FROM t", False, False),
    "partitioned_join": ("SELECT a.id, b.description FROM t a JOIN t b ON "
                         "a.id = b.id", False, False),
    "partitioned_left_join": ("SELECT a.id, b.id AS bid FROM t a LEFT JOIN t "
                              "b ON a.id = b.id AND b.sequence LIKE 'TT%'",
                              False, False),
    "order_by": ("SELECT id, description FROM t ORDER BY description DESC, "
                 "id", True, False),
    "limit_past_topk": (f"SELECT id FROM t ORDER BY id LIMIT "
                        f"{SMALL_TOPK + 1}", True, False),
    "offset_past_topk": (f"SELECT id FROM t ORDER BY id DESC LIMIT 10 OFFSET "
                         f"{SMALL_TOPK - 5}", True, False),
}


def _worker(data_dir: str, out_path: str) -> None:
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    import exon_tpu_torch as T
    from exon_tpu_torch import tables
    from exon_tpu_torch.parallel import distributed as D

    calls = []
    orig = tables.iter_scan_files

    def spy(files):
        got = orig(files)
        calls.append((len(list(files)), len(got)))
        return got

    tables.iter_scan_files = spy
    D.MAX_DIST_TOPK = SMALL_TOPK
    s = T.ExonSession(device="cpu")  # the process group starts here
    assert dist.is_initialized() and s.config.distributed
    s.config.n_shards = LOCAL_SHARDS
    for sql in SETUP:
        s.sql(sql.format(data_dir=data_dir))
    routed = {
        "count_star": D.DistributedAggregateExec,
        "group_by": D.DistributedAggregateExec,
        "filtered_group_by": D.DistributedAggregateExec,
        "topk": D.DistributedTopKExec, "join": D.DistributedJoinExec,
        "left_join_residual": D.DistributedJoinExec,
        "memory_join": D.DistributedJoinExec,
        "window": D.DistributedWindowExec,
        "partitioned_join": D.DistributedPartitionedJoinExec,
        "partitioned_left_join": D.DistributedPartitionedJoinExec,
        "order_by": D.DistributedSortExec,
        "limit_past_topk": D.DistributedSortExec,
        "offset_past_topk": D.DistributedSortExec}
    answers, shard_calls = {}, {}
    for name, (q, _ordered, _build) in QUERIES.items():
        flag = "true" if name.startswith("partitioned") else "false"
        s.sql(f"SET exon.partitioned_join = {flag}")
        df = s.sql(q)
        plan = df._execute(df.logical_plan())
        stack, seen = [plan], []
        while stack:
            seen.append(stack.pop())
            stack.extend(seen[-1].children())
        assert any(isinstance(p, routed[name]) for p in seen), name
        calls.clear()
        answers[name] = plan.collect_arrow().to_pylist()
        shard_calls[name] = list(calls)
    n_files = len(os.listdir(data_dir))
    with open(out_path, "w") as f:
        json.dump({"answers": answers, "shard_calls": shard_calls,
                   "n_files": n_files}, f, sort_keys=True)
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2], sys.argv[3])
