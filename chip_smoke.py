"""Smoke run of exon_tpu_torch on one CUDA card: build, kernels, main path.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), and whether jax
   and pyarrow are installed (informational: the port needs neither).
2. Build: compile the CUDA kernels from exon_tpu_torch/kernels/csrc.
3. Kernels vs twins: each kernel runs at the main path's shapes on inputs
   made from a numpy seed and is compared with its plain PyTorch twin run on
   the same card; median times of 20 CUDA-event-timed runs of each.
4. Main path, through ExonSession(device="cuda") on generated data at full
   scale: Query A (FASTA filter/project), its count, Query B (GFF filter →
   group-by), Query C (BAM reads ⋈ GFF genes on chromosome and 100 kb bin,
   overlap filter, coordinate sort), its TopK ``limit(1000)``, and Query D
   (mate pairing: R1 ⟕ R2 on the read name, coordinate sort). Each is
   checked against numpy computations from the generators' own arrays. The
   launch counts are set to 0 before each query and read after it; each
   query must have launched every kernel of its path.
5. Where the time goes in queries C and D: the join and the sort alone on
   device batches already in memory, with the kernels and with every
   wrapper's twin patched in (median of 5 host-clock runs ending in a
   sync); then one run of each query under torch.profiler, with the device
   time of its CUDA kernels and copies and the largest of them.

The line before the last is a JSON object with each kernel's numbers; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ROWS = 131_072               # session device_batch_size (1 << 17)
MEAN_LEN = 400                 # Swiss-Prot-like sequence length
FASTA_RECORDS = 560_000        # Swiss-Prot scale (BASELINE config 1)
GFF_FEATURES = 3_400_000       # GENCODE human scale (BASELINE config 2)
GFF_SEED = 7
N_TEMPLATES = 1_425_000        # 2,835,750 BAM records (BASELINE config 4)
BAM_SEED = 13
W = 100_000                    # Query C's bin width
FLOAT_RTOL = 1e-12             # float64 sums: atomic order changes rounding
REPS = 20

KERNELS = {
    "compact_mask": ("exon_tpu/ops/layout.py:75", "compact_mask.cu"),
    "gather_var": ("exon_tpu/ops/layout.py:149", "gather_var.cu"),
    "like_match": ("exon_tpu/ops/strings.py:177", "like_match.cu"),
    "hash_aggregate": ("exon_tpu/ops/aggregate.py:80", "hash_aggregate.cu"),
    "expand_segments": ("exon_tpu/ops/layout.py:308", "expand_segments.cu"),
    "row_hash": ("exon_tpu/plan/physical.py:831", "row_hash.cu"),
    "string_eq": ("exon_tpu/plan/expressions.py:763", "string_eq.cu"),
    "sort_keys": ("exon_tpu/plan/physical.py:1372", "sort_keys.cu"),
}
# the kernels each main-path query runs
PATH_KERNELS = {
    "A": ("compact_mask", "gather_var", "like_match"),
    "count": ("like_match",),
    "B": ("hash_aggregate",),
    "C": ("compact_mask", "gather_var", "expand_segments", "sort_keys"),
    "C_top": ("compact_mask", "gather_var", "expand_segments", "sort_keys"),
    "D": ("compact_mask", "gather_var", "expand_segments", "row_hash",
          "string_eq", "sort_keys"),
}


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def median_ms(fn, torch) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 1 and 2
# ---------------------------------------------------------------------------


def phase_device(torch) -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0])
    for mod in ("jax", "pyarrow"):
        found = importlib.util.find_spec(mod) is not None
        print(f"{mod} installed: {found} (not needed by exon_tpu_torch)")
    return name


def phase_build() -> None:
    from exon_tpu_torch.kernels import _build

    _build.build()
    log = _build.build_log
    print(f"build: {log['seconds']:.2f} s ({'cached' if log['cached'] else 'nvcc'}"
          f") -> {log['path']}")
    for line in log.get("output", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _build.library()


# ---------------------------------------------------------------------------
# Phase 3: kernels vs twins
# ---------------------------------------------------------------------------


def _var_column(rng, n: int, torch):
    lens = rng.integers(120, 2 * MEAN_LEN - 120, size=n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    vals = alphabet[rng.integers(0, 20, size=int(offs[-1]))]
    vals[offs[:-1][rng.random(n) < 0.23]] = ord("M")
    return (torch.from_numpy(offs.astype(np.int32)).cuda(),
            torch.from_numpy(vals).cuda())


def _exact(name: str, a, b) -> float:
    if a.shape != b.shape or not bool((a == b).all()):
        fail(f"{name}: kernel and twin disagree")
    return 0.0


def check_compact(rng, torch) -> dict:
    from exon_tpu_torch.kernels import compact_mask as k

    mask = torch.from_numpy(rng.random(N_ROWS) < 0.5).cuda()
    got, n_got = k.compact_mask(mask)
    want, n_want = k.compact_mask_plain(mask)
    torch.cuda.synchronize()
    err = _exact("compact_mask", got, want) + _exact("compact_mask count",
                                                       n_got, n_want)
    return {"max_abs_err": err,
            "ms": median_ms(lambda: k.compact_mask(mask), torch),
            "plain_ms": median_ms(lambda: k.compact_mask_plain(mask), torch),
            "shape": f"{N_ROWS} rows"}


def check_gather(rng, torch, offs, vals) -> dict:
    from exon_tpu_torch.kernels import gather_var as k

    idx = torch.from_numpy(np.flatnonzero(rng.random(N_ROWS) < 0.5)
                           .astype(np.int32)).cuda()
    o1, v1 = k.gather_var(offs, vals, idx)
    o2, v2 = k.gather_var_plain(offs, vals, idx)
    torch.cuda.synchronize()
    err = _exact("gather_var offsets", o1, o2) + _exact("gather_var values",
                                                        v1, v2)
    return {"max_abs_err": err,
            "ms": median_ms(lambda: k.gather_var(offs, vals, idx), torch),
            "plain_ms": median_ms(lambda: k.gather_var_plain(offs, vals, idx),
                                  torch),
            "shape": f"{N_ROWS} rows, {vals.shape[0]} bytes, "
                     f"{idx.shape[0]} taken"}


def check_like(torch, offs, vals) -> dict:
    from exon_tpu_torch.kernels import like_match as k
    from exon_tpu_torch.ops.strings import tokenize_like

    times = {}
    for pattern, ci in (("%KK%", False), ("M%", False), ("%A_C%", False),
                        ("exact", False), ("m%kk%w", True)):
        chunks = tokenize_like(pattern)
        got = k.like_match(offs, vals, chunks, ci)
        want = k.like_match_plain(offs, vals, chunks, ci)
        torch.cuda.synchronize()
        _exact(f"like_match {pattern!r}", got, want)
        times[pattern] = (
            median_ms(lambda: k.like_match(offs, vals, chunks, ci), torch),
            median_ms(lambda: k.like_match_plain(offs, vals, chunks, ci),
                      torch), int(got.sum()))
        print(f"  like {pattern!r} ci={ci}: {times[pattern][2]} rows match, "
              f"kernel {times[pattern][0]:.4f} ms, twin "
              f"{times[pattern][1]:.4f} ms")
    return {"max_abs_err": 0.0, "ms": times["%KK%"][0],
            "plain_ms": times["%KK%"][1],
            "shape": f"{N_ROWS} rows, {vals.shape[0]} bytes, '%KK%'"}


def check_hash(rng, torch) -> dict:
    from exon_tpu_torch.kernels import hash_aggregate as hk
    from exon_tpu_torch.ops.aggregate import GroupedHashAggregate

    specs = [(hk.COUNT, False), (hk.MIN, False), (hk.MAX, False),
             (hk.SUM, False), (hk.SUM, True), (hk.MIN, True), (hk.MAX, True)]
    out = {}
    for label, n, n_keys, perm in (("25 keys", N_ROWS, 25, False),
                                   ("1M keys", 1 << 20, 1 << 20, True)):
        keys = rng.permutation(n_keys) if perm else rng.integers(0, n_keys, n)
        parts = torch.from_numpy(keys.astype(np.int64)[None, :]).cuda()
        pvalid = torch.ones_like(parts, dtype=torch.uint8)
        mask = torch.from_numpy(rng.random(n) < 0.9).cuda()
        ints = torch.from_numpy(rng.integers(-10**9, 10**9, n)).cuda()
        floats = torch.from_numpy(rng.standard_normal(n) * 1e3).cuda()
        valid = torch.from_numpy(rng.random(n) < 0.95).cuda()
        values = [None, ints, ints, ints, floats, floats, floats]
        valids = [valid] * len(specs)

        def run(insert):
            agg = GroupedHashAggregate(1, specs, parts.device)
            agg.reserve(n)
            insert(agg.table, parts, pvalid, mask, None, 0, values, valids)
            return agg

        got, want = run(hk.insert).finalize(), run(hk.insert_plain).finalize()
        torch.cuda.synchronize()
        _exact(f"hash_aggregate {label} keys", got.keys, want.keys)
        err = 0.0
        for a, (op, is_float) in enumerate(specs):
            _exact(f"hash_aggregate {label} count {a}", got.cnt[a], want.cnt[a])
            if op == hk.COUNT:
                continue
            if is_float and op == hk.SUM:
                diff = (got.acc[a] - want.acc[a]).abs()
                scale = want.acc[a].abs().clamp(min=1.0)
                if bool((diff > FLOAT_RTOL * scale).any()):
                    fail(f"hash_aggregate {label}: float sums differ beyond "
                         f"rtol {FLOAT_RTOL}")
                err = max(err, float(diff.max()))
            else:
                _exact(f"hash_aggregate {label} acc {a}", got.acc[a],
                       want.acc[a])

        def timed(insert) -> float:
            # each run inserts into a fresh table made outside the timing
            times = []
            for _ in range(REPS + 1):
                agg = GroupedHashAggregate(1, specs, parts.device)
                agg.reserve(n)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                insert(agg.table, parts, pvalid, mask, None, 0, values, valids)
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            return float(np.median(times[1:]))

        ms, plain = timed(hk.insert), timed(hk.insert_plain)
        print(f"  hash_aggregate {label}: {got.num_groups} groups, "
              f"{n} rows, kernel {ms:.4f} ms, twin {plain:.4f} ms, "
              f"max float-sum diff {err:.3e}")
        out[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                      "shape": f"{n} rows, {got.num_groups} groups"}
    res = dict(out["25 keys"])
    res["max_abs_err"] = max(o["max_abs_err"] for o in out.values())
    return res


def _names_column(names: np.ndarray, torch):
    """Device (offsets, values) of a numpy bytes array of read names."""
    lens = np.char.str_len(names).astype(np.int64)
    offs = np.zeros(len(names) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    vals = np.frombuffer(b"".join(names.tolist()), np.uint8).copy()
    return (torch.from_numpy(offs.astype(np.int32)).cuda(),
            torch.from_numpy(vals).cuda())


def check_expand(rng, torch) -> dict:
    from exon_tpu_torch.kernels import expand_segments as k

    # Query C: 131,072 reads per probe batch, ~1.27 gene slots per read
    n_build = 60_991
    counts = rng.poisson(1.27, N_ROWS).astype(np.int32)
    ends = np.cumsum(counts)
    lo = torch.from_numpy(rng.integers(0, n_build, N_ROWS).astype(np.int32))
    args = (lo.cuda(), torch.from_numpy(counts).cuda(),
            torch.from_numpy(ends - counts).cuda(), int(ends[-1]), n_build)
    got, want = k.expand_segments(*args), k.expand_segments_plain(*args)
    torch.cuda.synchronize()
    _exact("expand_segments probe", got[0], want[0])
    _exact("expand_segments build", got[1], want[1])
    return {"max_abs_err": 0.0,
            "ms": median_ms(lambda: k.expand_segments(*args), torch),
            "plain_ms": median_ms(lambda: k.expand_segments_plain(*args),
                                  torch),
            "shape": f"{N_ROWS} probe rows, {int(ends[-1])} slots"}


def check_row_hash(torch, names) -> dict:
    from exon_tpu_torch.kernels import row_hash as k

    out = {}
    for label, rows in (("probe", names[:N_ROWS]), ("build", names)):
        offs, vals = _names_column(rows, torch)
        _exact(f"row_hash {label}", k.row_hash(offs, vals),
               k.row_hash_plain(offs, vals))
        out[label] = {
            "max_abs_err": 0.0,
            "ms": median_ms(lambda: k.row_hash(offs, vals), torch),
            "plain_ms": median_ms(lambda: k.row_hash_plain(offs, vals),
                                  torch),
            "shape": f"{len(rows)} names, {vals.shape[0]} bytes"}
    print(f"  row_hash build side: {out['build']['shape']}, kernel "
          f"{out['build']['ms']:.4f} ms, twin {out['build']['plain_ms']:.4f} ms")
    return out["probe"]


def check_string_eq(rng, torch, names) -> dict:
    from exon_tpu_torch.kernels import string_eq as k

    # Query D: each R1 name against the R2 row its hash found, most equal
    a = _names_column(names[:N_ROWS], torch) + (
        torch.ones(N_ROWS, dtype=torch.bool, device="cuda"),)
    b = _names_column(names, torch) + (
        torch.ones(len(names), dtype=torch.bool, device="cuda"),)
    ia = np.arange(N_ROWS, dtype=np.int32)
    ib = np.where(rng.random(N_ROWS) < 0.9, ia,
                  rng.integers(0, len(names), N_ROWS)).astype(np.int32)
    ia, ib = torch.from_numpy(ia).cuda(), torch.from_numpy(ib).cuda()
    got = k.string_eq(a, ia, b, ib)
    _exact("string_eq", got, k.string_eq_plain(a, ia, b, ib))
    return {"max_abs_err": 0.0,
            "ms": median_ms(lambda: k.string_eq(a, ia, b, ib), torch),
            "plain_ms": median_ms(lambda: k.string_eq_plain(a, ia, b, ib),
                                  torch),
            "shape": f"{N_ROWS} pairs, {int(got.sum())} equal"}


def check_sort_keys(rng, torch, names) -> dict:
    from benchlib.gff_fixture import SEQNAMES
    from exon_tpu_torch.kernels import sort_keys as k

    out = {}
    # Query C: ~1.5 M rows; reference, start, name, gene_start → 13 rows;
    # Query D: ~1.43 M rows; reference, start, name → 11 rows
    for label, n, gene in (("C", 1_500_000, True), ("D", 1_425_000, False)):
        ref = _names_column(np.asarray([s.encode() for s in SEQNAMES])[
            rng.integers(0, len(SEQNAMES), n)], torch)
        name = _names_column(names[rng.integers(0, len(names), n)], torch)
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        start = torch.from_numpy(rng.integers(1, 248_000_000, n)).cuda()
        specs = [k.VarKey(*ref, valid, 1), k.FixedKey(start, valid),
                 k.VarKey(*name, valid, 5)]
        if gene:
            specs.append(k.FixedKey(start - 1000, valid))
        got = k.sort_keys(specs, n, "cuda")
        _exact(f"sort_keys {label}", got, k.sort_keys_plain(specs, n, "cuda"))
        out[label] = {
            "max_abs_err": 0.0,
            "ms": median_ms(lambda: k.sort_keys(specs, n, "cuda"), torch),
            "plain_ms": median_ms(
                lambda: k.sort_keys_plain(specs, n, "cuda"), torch),
            "shape": f"{n} rows x {got.shape[0]} key rows"}
    print(f"  sort_keys Query D shape: {out['D']['shape']}, kernel "
          f"{out['D']['ms']:.4f} ms, twin {out['D']['plain_ms']:.4f} ms")
    return out["C"]


def phase_kernels(torch) -> dict:
    from benchlib.bam_fixture import template_names

    rng = np.random.default_rng(1234)
    offs, vals = _var_column(rng, N_ROWS, torch)
    names = template_names(N_TEMPLATES, BAM_SEED)[: N_TEMPLATES - 14_250]
    results = {
        "compact_mask": check_compact(rng, torch),
        "gather_var": check_gather(rng, torch, offs, vals),
        "like_match": check_like(torch, offs, vals),
        "hash_aggregate": check_hash(rng, torch),
        "expand_segments": check_expand(rng, torch),
        "row_hash": check_row_hash(torch, names),
        "string_eq": check_string_eq(rng, torch, names),
        "sort_keys": check_sort_keys(rng, torch, names),
    }
    for name, r in results.items():
        print(f"kernel {name}: matches twin ({r['shape']}); median of {REPS}: "
              f"kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms")
    return results


# ---------------------------------------------------------------------------
# Phase 4: main path
# ---------------------------------------------------------------------------


def _expected_a(flat: np.ndarray, offs: np.ndarray):
    lens = np.diff(offs)
    kk = np.flatnonzero((flat[:-1] == ord("K")) & (flat[1:] == ord("K")))
    rec = np.searchsorted(offs, kk, side="right") - 1
    inside = kk + 2 <= offs[rec + 1]
    has_kk = np.zeros(len(lens), bool)
    has_kk[rec[inside]] = True
    return np.flatnonzero((lens > 300) & has_kk)


def _check_a(host, flat, offs, sel) -> None:
    from exon_tpu_torch.formats.textutil import gather_slices

    if host.length != len(sel):
        fail(f"query A: {host.length} rows, expected {len(sel)}")
    ids = b"".join(b"sp|P%06d|PROT%d" % (i, i) for i in sel.tolist())
    idc, seqc = host.column("id"), host.column("sequence")
    if idc.values.tobytes() != ids:
        fail("query A: ids differ from the generated records")
    vals, want_offs = gather_slices(flat, offs[:-1][sel], offs[1:][sel])
    if not (np.array_equal(seqc.offsets.astype(np.int64), want_offs)
            and np.array_equal(seqc.values, vals)):
        fail("query A: sequences differ from the generated records")


def _check_b(host, feats) -> None:
    from benchlib.gff_fixture import FEATURE_TYPES, SEQNAMES

    m = feats["type"] == FEATURE_TYPES.index("exon")
    seq, start, end = feats["seqname"][m], feats["start"][m], feats["end"][m]
    _u, first = np.unique(seq, return_index=True)
    order = seq[np.sort(first)]
    n = np.bincount(seq, minlength=len(SEQNAMES))
    span = end - start
    sums = np.zeros(len(SEQNAMES), np.int64)
    np.add.at(sums, seq, span)
    mins = np.full(len(SEQNAMES), np.iinfo(np.int64).max)
    np.minimum.at(mins, seq, start)
    maxs = np.full(len(SEQNAMES), np.iinfo(np.int64).min)
    np.maximum.at(maxs, seq, end)
    if host.length != len(order):
        fail(f"query B: {host.length} groups, expected {len(order)}")
    keyc = host.columns[0]
    names = [keyc.vocab[c] for c in keyc.codes.tolist()]
    if names != [SEQNAMES[s] for s in order]:
        fail("query B: group keys or their first-seen order differ")
    want = [n[order], mins[order], maxs[order], sums[order],
            sums[order] / n[order]]
    for col, w, name in zip(host.columns[1:], want,
                            ("n", "min", "max", "sum", "avg")):
        if not col.validity.all() or not np.array_equal(col.values, w):
            fail(f"query B: column {name} differs")


def _names_of(col) -> np.ndarray:
    """A host VarColumn of names as a numpy bytes array."""
    offs = col.offsets.astype(np.int64)
    lens = np.diff(offs)
    width = int(lens.max()) if len(lens) else 1
    idx = offs[:-1, None] + np.arange(width)
    mat = np.where(np.arange(width) < lens[:, None],
                   col.values[np.minimum(idx, max(len(col.values) - 1, 0))], 0)
    return np.ascontiguousarray(mat.astype(np.uint8)).view(f"S{width}").ravel()


def _codes_of(col, names) -> np.ndarray:
    """A host DictColumn as codes into ``names`` (-1 for NULL)."""
    table = np.asarray([names.index(v) for v in col.vocab] or [0])
    return np.where(col.validity, table[col.codes], -1)


def _values_of(col) -> np.ndarray:
    """A host column's values as numpy (strings as bytes or str)."""
    from exon_tpu_torch.batch import DictColumn, VarColumn

    if isinstance(col, VarColumn):
        return _names_of(col)
    if isinstance(col, DictColumn):
        return np.asarray(list(col.vocab) or [""])[col.codes]
    return col.values


def _rank(names) -> np.ndarray:
    """Byte order of each name: the order a string sort key gives them."""
    return np.argsort(np.argsort(np.asarray(names)))


def _expected_c(reads, feats):
    """Query C from the generators' arrays: (read rows, gene rows, pairs
    emitted by the equi-join before the overlap filter)."""
    from benchlib.gff_fixture import FEATURE_TYPES

    genes = np.flatnonzero(feats["type"] == FEATURE_TYPES.index("gene"))
    gkey = feats["seqname"][genes] * 4096 + feats["start"][genes] // W
    order = np.argsort(gkey, kind="stable")
    rkey = reads["reference"] * 4096 + reads["start"] // W
    lo = np.searchsorted(gkey[order], rkey, "left")
    cnt = np.searchsorted(gkey[order], rkey, "right") - lo
    ridx = np.repeat(np.arange(len(rkey)), cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    gidx = genes[order[np.repeat(lo, cnt) + np.arange(len(ridx)) - first]]
    start = reads["start"][ridx]
    keep = (start >= feats["start"][gidx]) & (start <= feats["end"][gidx])
    return ridx[keep], gidx[keep], len(ridx)


def _check_c(host, reads, feats, label: str) -> int:
    from benchlib.gff_fixture import SEQNAMES

    ridx, gidx, pairs = _expected_c(reads, feats)
    if host.length != len(ridx):
        fail(f"query {label}: {host.length} rows, expected {len(ridx)}")
    got = {
        "reference": _codes_of(host.column("reference"), SEQNAMES),
        "start": host.column("start").values,
        "name": _names_of(host.column("name")),
        "gene_start": host.column("gene_start").values,
        "end": host.column("end").values,
        "seqname": _codes_of(host.column("seqname"), SEQNAMES),
        "gene_end": host.column("gene_end").values,
        "strand": _codes_of(host.column("strand"), ["+", "-"]),
    }
    want = {
        "reference": reads["reference"][ridx], "start": reads["start"][ridx],
        "name": reads["names"][reads["template"][ridx]],
        "gene_start": feats["start"][gidx], "end": reads["end"][ridx],
        "seqname": feats["seqname"][gidx], "gene_end": feats["end"][gidx],
        "strand": feats["strand"][gidx],
    }
    rank = _rank(SEQNAMES)
    order_keys = ("gene_start", "name", "start")
    got_order = np.lexsort(tuple(got[k] for k in order_keys)
                           + (rank[got["reference"]],))
    if not np.array_equal(got_order, np.arange(host.length)):
        fail(f"query {label}: rows are not in (reference, start, name, "
             "gene_start) order")
    # rows that tie on every sort key compare as a set: order both sides
    # by every column before comparing
    def full(d):
        return np.lexsort(tuple(d[k] for k in reversed(list(want))))

    g, w = full(got), full(want)
    for k in want:
        if not np.array_equal(got[k][g], want[k][w]):
            fail(f"query {label}: column {k} differs")
    print(f"query {label}: {pairs} join pairs, {host.length} rows after the "
          "overlap filter, every column and the order match numpy")
    return pairs


def _check_d(host, reads) -> int:
    from benchlib.bam_fixture import FLAG_R2
    from benchlib.gff_fixture import SEQNAMES

    r1 = np.flatnonzero(reads["flag"] != FLAG_R2)
    names = reads["names"][reads["template"][r1]]
    order = np.lexsort((names, reads["start"][r1],
                        _rank(SEQNAMES)[reads["reference"][r1]]))
    r1, names = r1[order], names[order]
    mate = reads["mate_start"][r1]
    paired = mate > 0
    if host.length != len(r1):
        fail(f"query D: {host.length} rows, expected {len(r1)}")
    checks = {
        "name": (_names_of(host.column("name")), names),
        "reference": (_codes_of(host.column("reference"), SEQNAMES),
                      reads["reference"][r1]),
        "start": (host.column("start").values, reads["start"][r1]),
        "flag": (host.column("flag").values, reads["flag"][r1]),
        "mate_start": (host.column("mate_start").values[paired],
                       mate[paired]),
        "mate_flag": (host.column("mate_flag").values[paired],
                      np.full(paired.sum(), FLAG_R2)),
        "mate_name": (_names_of(host.column("mate_name"))[paired],
                      names[paired]),
    }
    for k, (g, w) in checks.items():
        if not np.array_equal(g, w):
            fail(f"query D: column {k} differs")
    for k in ("mate_name", "mate_start", "mate_flag"):
        if not np.array_equal(host.column(k).validity, paired):
            fail(f"query D: NULL mates of {k} differ")
    n_null = int((~paired).sum())
    print(f"query D: {host.length} rows, {n_null} with NULL mates; every "
          "column and the order match numpy")
    return n_null


def _decode_seconds(df) -> float:
    """Host decode alone: the plan's scans iterated without the device."""
    from exon_tpu_torch.plan.physical import ScanExec

    plan = df._execute(df.logical_plan())
    scans, stack = [], [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, ScanExec):
            scans.append(p)
        stack.extend(p.children())
    t = time.perf_counter()
    for scan in scans:
        for _b in scan.source():
            pass
    return time.perf_counter() - t


def _query_c(T, session, bam, gf):
    c = T.col
    reads = session.read_bam(bam).select("name", "reference", "start", "end")
    genes = (session.read_gff(gf).filter(c("type") == "gene")
             .select(c("seqname"), c("start").alias("gene_start"),
                     c("end").alias("gene_end"), c("strand")))
    return (reads.join(genes, on=[("reference", "seqname"),
                                  (c("start") / W, c("gene_start") / W)])
            .filter((c("start") >= c("gene_start"))
                    & (c("start") <= c("gene_end")))
            .sort("reference", "start", "name", "gene_start"))


def _query_d(T, session, bam):
    c = T.col
    r1 = session.read_bam(bam).filter((c("flag") / 64) % 2 == 1).select(
        "name", "reference", "start", "flag")
    r2 = (session.read_bam(bam).filter((c("flag") / 128) % 2 == 1)
          .select(c("name").alias("mate_name"),
                  c("start").alias("mate_start"),
                  c("flag").alias("mate_flag")))
    return r1.join(r2, on=[("name", "mate_name")], how="left").sort(
        "reference", "start", "name")


def phase_main_path(torch) -> dict:
    import exon_tpu_torch as T
    from benchlib.bam_fixture import bam_reads, make_bam
    from benchlib.fasta_records import fasta_file_size, fasta_records
    from benchlib.fixtures import make_fasta
    from benchlib.gff_fixture import gff_features, make_gff
    from exon_tpu_torch import kernels

    t0 = time.perf_counter()
    fa = make_fasta(FASTA_RECORDS, mean_len=MEAN_LEN, seed=42)
    flat, offs = fasta_records(FASTA_RECORDS, MEAN_LEN, seed=42)
    if os.path.getsize(fa) != fasta_file_size(offs):
        fail("FASTA fixture does not match the replayed records")
    gf = make_gff(GFF_FEATURES, GFF_SEED)
    feats = gff_features(GFF_FEATURES, GFF_SEED)
    bam = make_bam(N_TEMPLATES, BAM_SEED)
    reads = bam_reads(N_TEMPLATES, BAM_SEED)
    n_bam = len(reads["start"])
    print(f"data: {fa} ({os.path.getsize(fa)} bytes, {FASTA_RECORDS} records)"
          f", {gf} ({os.path.getsize(gf)} bytes, {GFF_FEATURES} features), "
          f"{bam} ({os.path.getsize(bam)} bytes, {n_bam} records); "
          f"{time.perf_counter() - t0:.1f} s to generate")
    sel = _expected_a(flat, offs)

    session = T.ExonSession(device="cuda")
    pred = (T.FunctionCall("length", [T.col("sequence")]) > 300) & \
        T.col("sequence").like("%KK%")
    queries = {
        "A": (lambda: session.read_fasta(fa).filter(pred).select(
            "id", "sequence").collect_host(), FASTA_RECORDS),
        "count": (lambda: session.read_fasta(fa).filter(pred).count(),
                  FASTA_RECORDS),
        "B": (lambda: session.read_gff(gf).filter(
            T.col("type") == "exon").aggregate(
            ["seqname"], [T.count().alias("n"), T.min_(T.col("start")),
                          T.max_(T.col("end")),
                          T.sum_(T.col("end") - T.col("start")),
                          T.avg(T.col("end") - T.col("start"))]
        ).collect_host(), GFF_FEATURES),
        "C": (lambda: _query_c(T, session, bam, gf).collect_host(),
              n_bam + GFF_FEATURES),
        "C_top": (lambda: _query_c(T, session, bam, gf).limit(
            1000).collect_host(), n_bam + GFF_FEATURES),
        "D": (lambda: _query_d(T, session, bam).collect_host(), 2 * n_bam),
    }
    results, stats, counts = {}, {}, {}
    for q, (run, rows_in) in queries.items():
        kernels.reset_launch_counts()
        t = time.perf_counter()
        results[q] = run()
        torch.cuda.synchronize()
        stats[q] = [time.perf_counter() - t, rows_in]
        counts[q] = kernels.launch_counts()
        missing = [k for k in PATH_KERNELS[q] if counts[q][k] == 0]
        if missing:
            fail(f"query {q} never launched its kernels {missing}")
        print(f"launches in query {q}: "
              f"{ {k: v for k, v in counts[q].items() if v} }")

    _check_a(results["A"], flat, offs, sel)
    if results["count"] != len(sel):
        fail(f"count: {results['count']}, expected {len(sel)}")
    _check_b(results["B"], feats)
    _check_c(results["C"], reads, feats, "C")
    top, full = results["C_top"], results["C"]
    if top.length != 1000:
        fail(f"query C_top: {top.length} rows, expected 1000")
    for name in top.schema.names:
        a, b = top.column(name), full.column(name)
        if not (np.array_equal(_values_of(a), _values_of(b)[:1000])
                and np.array_equal(a.validity, b.validity[:1000])):
            fail(f"query C_top: column {name} differs from query C's first "
                 "1000 rows")
    print("query C_top: the first 1000 rows of query C")
    _check_d(results["D"], reads)
    decode = {"C": _decode_seconds(_query_c(T, session, bam, gf)),
              "D": _decode_seconds(_query_d(T, session, bam))}
    decode["C_top"] = decode["C"]
    for q, (sec, rows_in) in stats.items():
        out = results[q] if q == "count" else results[q].length
        share = f", host decode alone {decode[q]:.3f} s " \
            f"({100 * decode[q] / sec:.1f} % of wall)" if q in decode else ""
        print(f"query {q}: {out} rows out, {sec:.3f} s wall, "
              f"{rows_in / sec:,.0f} input rows/s (host decode included)"
              f"{share}")
    print("main path: queries A, count, B, C, C_top and D match the "
          "generators' arrays")
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS}


# ---------------------------------------------------------------------------
# Phase 5: where the time goes in queries C and D
# ---------------------------------------------------------------------------


def _find(plan, cls):
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, cls):
            return p
        stack.extend(p.children())
    fail(f"no {cls.__name__} in the plan")


@contextlib.contextmanager
def _twins():
    """Every kernel wrapper on the join and sort path replaced by its plain
    twin, where the operators look it up."""
    from exon_tpu_torch.kernels import (compact_mask, expand_segments,
                                        gather_var, row_hash, sort_keys,
                                        string_eq)
    from exon_tpu_torch.ops import layout
    from exon_tpu_torch.plan import join_exec, physical

    swaps = [(join_exec, "expand_segments", expand_segments),
             (join_exec, "string_eq", string_eq),
             (physical, "row_hash", row_hash),
             (physical, "sort_keys", sort_keys),
             (layout, "gather_var", gather_var),
             (layout, "compact_mask", compact_mask)]
    saved = [getattr(mod, name) for mod, name, _k in swaps]
    for mod, name, k in swaps:
        setattr(mod, name, getattr(k, f"{name}_plain"))
    try:
        yield
    finally:
        for (mod, name, _k), f in zip(swaps, saved):
            setattr(mod, name, f)


def _host_ms(fn, torch, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` ending in a sync, after one warm
    run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times))


def _join_and_sort_ms(df, torch, label: str) -> None:
    """The query's join and its sort on device batches already in memory
    (no scan), with the kernels and with every wrapper's twin."""
    from exon_tpu_torch.plan import join_exec, physical

    class InMemory(physical.PhysicalPlan):
        def __init__(self, plan):
            self.out_schema, self.held = plan.schema(), list(plan.batches())

        def schema(self):
            return self.out_schema

        def batches(self):
            return iter(self.held)

    plan = df._execute(df.logical_plan())
    sort, join = _find(plan, physical.SortExec), _find(plan, join_exec.JoinExec)
    join.left, join.right = InMemory(join.left), InMemory(join.right)
    sort.input = InMemory(sort.input)
    for part, run in (("join", lambda: list(join.batches())),
                      ("sort", lambda: list(sort.batches()))):
        rows = sum(b.length for b in run())
        ms = _host_ms(run, torch)
        with _twins():
            plain_rows = sum(b.length for b in run())
            plain_ms = _host_ms(run, torch)
        if plain_rows != rows:
            fail(f"query {label} {part}: {rows} rows with kernels, "
                 f"{plain_rows} with twins")
        print(f"query {label} {part} alone: {rows} rows out; median of 5: "
              f"kernels {ms:.2f} ms, twins {plain_ms:.2f} ms")


def _device_profile(run, torch, label: str) -> None:
    """One run of the query under torch.profiler: wall, and the device time
    of its CUDA kernels and copies (each counted once)."""
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if device_ms <= 0:
        fail(f"query {label}: the profile shows no device time")
    htod = [e for e in rows if e.key.startswith("Memcpy HtoD")]
    print(f"query {label} profiled: {wall:.3f} s wall, {device_ms:.1f} ms "
          f"on the device ({100 * device_ms / (1e3 * wall):.2f} % of wall), "
          f"HtoD {sum(e.self_device_time_total for e in htod) / 1e3:.1f} ms "
          f"in {sum(e.count for e in htod)} copies")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x {e.count:5d}  "
              f"{e.key[:80]}")


def phase_breakdown(torch) -> None:
    import exon_tpu_torch as T
    from benchlib.bam_fixture import make_bam
    from benchlib.gff_fixture import make_gff

    session = T.ExonSession(device="cuda")
    bam, gf = make_bam(N_TEMPLATES, BAM_SEED), make_gff(GFF_FEATURES, GFF_SEED)
    queries = {"C": lambda: _query_c(T, session, bam, gf),
               "D": lambda: _query_d(T, session, bam)}
    for label, query in queries.items():
        _join_and_sort_ms(query(), torch, label)
        _device_profile(lambda: query().collect_host(), torch, label)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not installed: {e}")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "exon_tpu_torch")):
        fail(f"exon_tpu_torch is not beside {__file__}")
    sys.path.insert(0, root)
    name = phase_device(torch)
    phase_build()
    results = phase_kernels(torch)
    counts = phase_main_path(torch)
    phase_breakdown(torch)
    kernels = []
    for k, (replaces, src) in KERNELS.items():
        r = results[k]
        kernels.append({"name": k, "route": "cuda",
                        "source": f"exon_tpu_torch/kernels/csrc/{src}",
                        "replaces": replaces, "launches": counts[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
