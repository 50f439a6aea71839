"""Multi-process distributed execution of exon_tpu_torch: 2 and 3 gloo
processes × 4 CPU shards each, over the FASTA files of
tests/test_multihost.py (4 files, and 9 files: the uneven 5/4 and 3/3/3
splits, where a process runs out of files a wave early and takes empty
waves).

Each process is ``python tests/test_torch_multihost.py worker ...`` (the
``__main__`` block below), started over ``tcp://127.0.0.1:<free port>``
through the session's ``EXON_TPU_*`` variables, with a time limit of its
own; it runs ``count_star``, ``group_by``, ``filtered_group_by`` and
``topk`` through ``ExonSession.sql``, plans the sorts the port does not
carry across processes, and writes what it got as JSON. The
answers must be those tests/test_multihost.py asserts, identical on every
process, and every process must have decoded only its own files
(``iter_scan_files`` gave it ``files[p::P]`` and nothing else)."""

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
        assert r["shard_calls"] and all(
            tot == r["n_files"] and got == mine
            for tot, got in r["shard_calls"]), r["shard_calls"]
    return results[0]["answers"]


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


def test_multi_process_sort_the_topk_cannot_take_raises(two_process):
    """A sort across processes is not ported: a LIMIT past the TopK's
    largest fetch, or with skip + fetch past it, raises on every process as
    a bare ORDER BY does, rather than sorting the whole scan on each."""
    for name in ("limit_past_topk", "offset_past_topk", "order_by"):
        assert "not ported yet (ROADMAP Queue 1, item 12)" in \
            two_process[name], (name, two_process[name])


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


def _worker(data_dir: str, out_path: str) -> None:
    import torch.distributed as dist

    sys.path.insert(0, REPO)
    import exon_tpu_torch as T
    from exon_tpu_torch import tables
    from exon_tpu_torch.parallel import distributed as D

    shard_calls = []
    orig = tables.iter_scan_files

    def spy(files):
        got = orig(files)
        shard_calls.append((len(list(files)), len(got)))
        return got

    tables.iter_scan_files = spy
    s = T.ExonSession(device="cpu")  # the process group starts here
    assert dist.is_initialized() and s.config.distributed
    s.config.n_shards = LOCAL_SHARDS
    s.sql(f"CREATE EXTERNAL TABLE t STORED AS FASTA LOCATION '{data_dir}'")

    def rows(q, routed):
        df = s.sql(q)
        plan = df._execute(df.logical_plan())
        stack, seen = [plan], []
        while stack:
            seen.append(stack.pop())
            stack.extend(seen[-1].children())
        assert any(isinstance(p, routed) for p in seen), q
        return plan.collect_arrow().to_pylist()

    agg, top = D.DistributedAggregateExec, D.DistributedTopKExec
    answers = {
        "count_star": rows("SELECT COUNT(*) AS n FROM t", agg),
        "group_by": rows("SELECT description, COUNT(*) AS n FROM t GROUP BY "
                         "description ORDER BY description", agg),
        "filtered_group_by": rows(
            "SELECT description, COUNT(*) AS n FROM t WHERE sequence LIKE "
            "'AC%' GROUP BY description ORDER BY description", agg),
        "topk": rows("SELECT id, description FROM t ORDER BY description, "
                     "id LIMIT 4", top),
    }
    cap = D.MAX_DIST_TOPK
    for name, q in (
            ("limit_past_topk", f"SELECT id FROM t ORDER BY id LIMIT {cap + 1}"),
            ("offset_past_topk",
             f"SELECT id FROM t ORDER BY id LIMIT {cap} OFFSET 1"),
            ("order_by", "SELECT id FROM t ORDER BY id")):
        df = s.sql(q)
        try:
            df._execute(df.logical_plan())
            answers[name] = "planned"
        except NotImplementedError as e:
            answers[name] = str(e)
    n_files = len(os.listdir(data_dir))
    with open(out_path, "w") as f:
        json.dump({"answers": answers, "shard_calls": shard_calls,
                   "n_files": n_files}, f, sort_keys=True)
    dist.destroy_process_group()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(sys.argv[2], sys.argv[3])
