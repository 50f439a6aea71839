"""Distributed execution over a mesh of shards (K13).

Counterpart of exon_tpu/parallel/distributed.py: ``DistributedAggregateExec``
(:718-1086), ``DistributedTopKExec`` (:1506-1697), ``DistributedJoinExec``
(:1218-1345), ``DistributedWindowExec`` (:1698-1843),
``DistributedSortExec`` (:1887-1928) and ``DistributedPartitionedJoinExec``
(:1959-2211), with their planner hooks (:1347-1505, :1640, :1846, :1930,
:2214), the wave loop (``lockstep_wave_iter`` :401) and the host data
plane of a multi-process run (``allgather_pickled`` :270,
``_sync_template`` :296). The operators are built from the port's own
parts, not block by block from the JAX code:

- The scan's batches are dealt round-robin, in stream order, to the shards
  of the mesh, one wave of ``n_local`` batches at a time; a wave advances
  the rank space by ``cap × n_shards`` (:1024), ``cap`` being the longest
  batch of the wave over every process, so each row's first-seen rank is
  ``wave base + global shard × cap + row``.
- Aggregate: each shard folds its batches into a ``HashTable`` of its own
  (kernels/hash_aggregate.py, raw mode). At the end the groups of every
  shard (their key parts, ``first``, accumulators and counts) go to
  bucket_pack, routed by a hash of their key parts, in one call a card
  over its shards' tables in shard order, and through the exchange of
  shuffle.py to their owner, which inserts what it receives into a fresh
  table in merge mode (``first`` kept as a minimum). The owners' groups
  are emitted together in first-seen order, the order of the single-device
  ``AggregateExec`` (:24-28). Group identity is the key parts, compared in
  full by hash_aggregate: the hash only routes rows (the JAX state keys
  groups on the unverified ``_group_key_i64``, :522; ROADMAP F3). A string
  key travels as its ``rep_w``-byte prefix in 8 int64 parts and its length
  in a ninth, as ``VarRep`` (:103) carries it; a longer live key makes the
  aggregate fall back to the single-device plan (``RepTooLongError``) and
  counts in ``fallbacks``. The table grows, so the JAX package's per-device
  state cap and its exchange-and-spill loop (:758-795) have no counterpart.
- TopK: each shard sorts each of its batches (sort_keys + ``torch.sort``,
  ``SortExec`` with a fetch) and keeps its top k; the candidates, gathered
  over the processes, are finished by one more ``SortExec`` with the fetch.
- Joins: the broadcast join probes each shard's batches against one build
  side a card; the partitioned join sends (key, row) pairs of both sides
  to the key's owner and verifies every matched pair (ROADMAP F31, F32).
- Windows: each row goes to the shard of its PARTITION BY key's hash, the
  shard runs WindowExec's path, the results go back to input order.
- Sort across processes: each process sorts its files, the runs are
  exchanged once and merged on the host.

With several processes each decodes only its own files (``iter_scan_files``
under ``scan_shard_context``), every process takes the same number of
waves (a process whose files are done takes empty ones), and every process
ends with the whole result. The JAX package's host-function gates
(``contains_host_fn``) have no counterpart: the port traces no step, and
every function of it runs eagerly on each batch, on the mesh as on one
device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..batch import (Batch, DictColumn, FixedColumn, Schema, VarColumn,
                     concat_host, empty_batch, take_host)
from ..errors import ExecutionError
from ..kernels.bucket_pack import bucket_pack
from ..kernels.expand_segments import expand_segments
from ..kernels.sort_keys import gather_prefix
from ..ops import aggregate as agg_ops
from ..ops import layout as layout_ops
from ..plan.expressions import as_bool_mask, eval_expr
from ..plan.join_exec import JoinExec, verify_pairs
from ..plan.physical import (_NULL_KEY_SENT, AggregateExec, PhysicalPlan,
                             SortExec, _key_part, _merge_runs, _to_column,
                             concat_batches, fold_key, join_key_parts)
from .mesh import Mesh, make_mesh, process_count, scan_shard_context
from .shuffle import any_process, exchange

DEFAULT_REP_W = 64    # the string key bytes a group row carries (:61)
MAX_DIST_TOPK = 1 << 16  # the largest fetch the mesh takes (:1636)

# since reset_stats(): aggregates that fell back to the single-device plan,
# the group rows and bytes the aggregate exchange has moved, the (key, row)
# pairs the partitioned join has routed and the rows the windows have
fallbacks = 0
exchanged_rows = 0
exchanged_bytes = 0
exchanged_pairs = 0
window_rows = 0


def reset_stats() -> None:
    global fallbacks, exchanged_rows, exchanged_bytes, exchanged_pairs,         window_rows
    fallbacks = exchanged_rows = exchanged_bytes = exchanged_pairs =         window_rows = 0


class RepTooLongError(ExecutionError):
    """A group key exceeded rep_w bytes: fall back to one device."""


# ---------------------------------------------------------------------------
# Waves and the host data plane of a multi-process run
# ---------------------------------------------------------------------------


def allgather_pickled(obj) -> list:
    """One picklable host object from every process, in process order,
    identical on all of them (``all_gather_object``; one process: [obj])."""
    if process_count() <= 1:
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


def _sync_template(tpl):
    """Agree on a template over the processes: each passes what it has seen
    (None where it saw nothing) and gets the first process's that is not
    None, or None when none saw anything."""
    if process_count() <= 1:
        return tpl
    return next((o for o in allgather_pickled(tpl) if o is not None), None)


def _multihost_shardable(node) -> bool:
    """A multi-process run needs a scan whose provider splits its files per
    process (``iter_scan_files``); any other would feed its whole rows from
    every process."""
    return process_count() <= 1 or \
        getattr(node.provider, "shards_files", False)


def _scan_chain(node) -> bool:
    """Whether the logical subtree is row-wise operators over one scan of
    a provider that splits its files per process (:355)."""
    from ..plan import logical as L

    while isinstance(node, (L.Filter, L.Project)):
        node = node.input
    return isinstance(node, L.Scan) and _multihost_shardable(node)


def lockstep_wave_iter(batches: Iterator[Batch], mesh: Mesh):
    """Yield (this process's batches of one wave, the wave's cap) until the
    stream of every process is done. With several processes each pull from
    the stream runs under the process's scan-shard context, and a small
    all-gather a wave keeps every process on the same wave count and cap
    (a process whose files are done yields empty waves)."""
    multi = mesh.n_processes > 1
    while True:
        wave = []
        for _ in range(mesh.n_local):
            if multi:
                with scan_shard_context(mesh.process_index, mesh.n_processes):
                    b = next(batches, None)
            else:
                b = next(batches, None)
            if b is None:
                break
            wave.append(b)
        cap = max((b.length for b in wave), default=0)
        if multi:
            seen = allgather_pickled((bool(wave), cap))
            if not any(have for have, _cap in seen):
                return
            cap = max(c for _have, c in seen)
        elif not wave:
            return
        yield wave, cap


def apply_stages(stages: tuple, batch: Batch,
                 compact_last: bool = False) -> tuple:
    """The fused Filter/Project chain over one batch (:473): (batch, mask).
    A filter compacts the rows, as ``FilterExec`` does, but for the last
    stage when ``compact_last`` is False: its predicate is returned as the
    mask, which an aggregate consumes without moving rows."""
    mask = batch.row_mask()
    for i, (kind, payload, out_schema) in enumerate(stages):
        if kind == "filter":
            pred = as_bool_mask(eval_expr(payload, batch), batch)
            if i == len(stages) - 1 and not compact_last:
                mask = pred
            else:
                batch = layout_ops.filter_batch(batch, pred)
                mask = batch.row_mask()
        else:
            cols = [_to_column(eval_expr(e, batch), batch) for e in payload]
            batch = Batch(out_schema, cols, batch.length, batch.device)
    return batch, mask


def _on(batch: Batch, device) -> Batch:
    return batch if batch.device == torch.device(device) else \
        batch.to_device(device)


# ---------------------------------------------------------------------------
# The aggregate
# ---------------------------------------------------------------------------


def _dist_key_parts(group_exprs: list, b: Batch, mask,
                    vocab_of: dict) -> tuple:
    """int64 key parts [n_parts, n], their validity (uint8), each key's
    kind ("dict", "fixed" or "var") and whether a live string key is longer
    than ``DEFAULT_REP_W`` (a 0-d device bool). Fixed and dictionary keys are one
    part each, as ``AggregateExec`` makes them (dictionary strings through
    their verified content hash); a string key is rep_w / 8 words of its
    zero-padded prefix and its length."""
    parts, valid, kinds = [], [], []
    too_long = torch.zeros((), dtype=torch.bool, device=b.device)
    for e in group_exprs:
        v = eval_expr(e, b)
        if isinstance(v, torch.Tensor):
            v = FixedColumn(v, b.row_mask())
        if isinstance(v, VarColumn):
            off = v.offsets.to(torch.int64)
            lens = off[1:] - off[:-1]
            words = gather_prefix(v.offsets, v.values, DEFAULT_REP_W).to(
                torch.uint8).view(torch.int64)
            for p in list(words.T) + [lens]:
                parts.append(torch.where(v.validity, p, 0))
                valid.append(v.validity)
            too_long = too_long | (mask & v.validity & (lens > DEFAULT_REP_W)).any()
            kinds.append("var")
        elif isinstance(v, (DictColumn, FixedColumn)):
            parts.append(torch.where(v.validity, _key_part(v, vocab_of),
                                     _NULL_KEY_SENT))
            valid.append(v.validity)
            kinds.append("dict" if isinstance(v, DictColumn) else "fixed")
        else:
            raise NotImplementedError(
                f"group key {e.display_name()} is not ported yet "
                "(ROADMAP Queue 1, aggregate)")
    return (torch.stack(parts).contiguous(),
            torch.stack(valid).to(torch.uint8).contiguous(), kinds, too_long)


def _var_key(words: torch.Tensor, lens: torch.Tensor,
             valid: torch.Tensor) -> VarColumn:
    """A string key column from its prefix words [rep_w / 8, g] and
    lengths."""
    pre = words.T.contiguous().view(torch.uint8)
    keep = torch.arange(pre.shape[1], device=pre.device)[None, :] < \
        lens[:, None]
    offsets = torch.zeros(lens.shape[0] + 1, dtype=torch.int32,
                          device=lens.device)
    offsets[1:] = torch.cumsum(lens, 0)
    return VarColumn(pre[keep], offsets, valid)


@dataclasses.dataclass
class DistributedAggregateExec(AggregateExec):
    """Grouped or ungrouped count/sum/min/max/avg over a Filter/Project
    chain on one scan, data-parallel over the shards of ``mesh``.
    ``input`` is the scan; ``stages`` the chain, scan side first."""

    stages: tuple = ()
    mesh: Optional[Mesh] = None
    fallback: Optional[Callable[[], PhysicalPlan]] = None

    def batches(self) -> Iterator[Batch]:
        global fallbacks
        try:
            out = self._run()
        except RepTooLongError:
            if self.fallback is None:
                raise
            fallbacks += 1
            yield from self.fallback().batches()
            return
        yield out

    def _run(self) -> Batch:
        if not self.group_exprs:
            return self._run_ungrouped()
        tables, kinds, vocab_of = self.fold(self.input.batches())
        return self._finish(tables, kinds, vocab_of)

    def _waves(self, batches: Iterator[Batch]):
        """(local shard, its batch after the stages, its mask, the rank of
        its row 0) for every batch of the stream."""
        base = 0
        for wave, cap in lockstep_wave_iter(iter(batches), self.mesh):
            for s, b in enumerate(wave):
                b = _on(b, self.mesh.devices[s])
                b, mask = apply_stages(self.stages, b)
                yield s, b, mask, base + (self.mesh.first_shard + s) * cap
            base += cap * self.mesh.n_shards

    def fold(self, batches: Iterator[Batch]) -> tuple:
        """Each shard's batches into its own hash table: (tables, one per
        local shard or None for a shard that saw no batch, key kinds,
        dictionary strings by hash). Raises RepTooLongError on every
        process when any saw a live string key longer than rep_w."""
        tables = [None] * self.mesh.n_local
        kinds, vocab_of, too_long = None, {}, []
        for s, b, mask, base in self._waves(batches):
            parts, pvalid, kinds, long_ = _dist_key_parts(
                self.group_exprs, b, mask, vocab_of)
            vals, valids, specs = self._agg_inputs(b, mask)
            if tables[s] is None:
                tables[s] = agg_ops.GroupedHashAggregate(
                    parts.shape[0], specs, b.device)
            elif tables[s].specs != tuple(specs):
                raise ExecutionError("aggregate input type changed "
                                     "between batches")
            tables[s].add_batch(parts, pvalid, mask, vals, valids, base)
            too_long.append(long_)
        if any_process(self.mesh, any(bool(f) for f in too_long)):
            raise RepTooLongError(
                f"a group key exceeds rep_w={DEFAULT_REP_W} bytes")
        return tables, kinds, vocab_of

    def exchange_inputs(self, tables: list, tpl: tuple) -> list:
        """Per card of the mesh, bucket_pack's inputs: (route keys int64
        [m], columns [keys [m, n_parts], key validity uint8 [m, n_parts],
        first [m], accumulators and counts int64 [m, n_aggs]]) of the groups
        of the card's shards, their tables concatenated in shard order."""
        n_parts, specs = tpl[0], tpl[1]
        out = []
        for dev, on_dev in itertools.groupby(
                zip(self.mesh.devices, tables), key=lambda x: x[0]):
            rows = [t.rows() for _d, t in on_dev if t is not None]
            if rows:
                keys, kv, first, acc, cnt = (
                    torch.cat([r[i] for r in rows], dim=-1) for i in range(5))
            else:
                z = torch.zeros
                keys, kv = z(n_parts, 0, dtype=torch.int64, device=dev), \
                    z(n_parts, 0, dtype=torch.uint8, device=dev)
                first = z(0, dtype=torch.int64, device=dev)
                acc = cnt = z(len(specs), 0, dtype=torch.int64, device=dev)
            out.append((fold_key(keys), [keys.T.contiguous(),
                                         kv.T.contiguous(), first,
                                         acc.T.contiguous(),
                                         cnt.T.contiguous()]))
        return out

    def _exchange(self, inputs: list) -> list:
        """The groups to their owners: one bucket_pack a card, then
        shuffle.exchange; per local shard its received columns. Buckets
        start at twice a uniform share and grow to the largest count when
        one overflows."""
        global exchanged_rows, exchanged_bytes
        n = self.mesh.n_shards
        packed, sent = [], []
        for route, cols in inputs:
            m = route.shape[0]
            cap = agg_ops._pow2_at_least(max(64, 2 * m // n))
            out, counts, _d, _r = bucket_pack(route, None, cols, n, cap)
            counts = counts.tolist()
            if max(counts, default=0) > cap:
                cap = max(counts)
                out, _c, _d, _r = bucket_pack(route, None, cols, n, cap)
            packed.append(out)
            sent.append(counts)
            exchanged_rows += m
            exchanged_bytes += m * sum(
                c.element_size() * (c.numel() // max(c.shape[0], 1))
                for c in cols)
        return exchange(self.mesh, packed, sent)

    def _finish(self, tables: list, kinds, vocab_of: dict) -> Batch:
        specs = next((t.specs for t in tables if t is not None), None)
        n_parts = next((t.table.keys.shape[0] for t in tables
                        if t is not None), None)
        tpl = _sync_template(None if specs is None
                             else (n_parts, specs, kinds))
        if tpl is None:
            return empty_batch(self.out_schema).to_device(
                self.mesh.devices[0])
        n_parts, specs, kinds = tpl
        recv = self._exchange(self.exchange_inputs(tables, tpl))
        owned = []
        for (keys, kv, first, acc, cnt), dev in zip(recv, self.mesh.devices):
            merged = agg_ops.GroupedHashAggregate(n_parts, specs, dev)
            merged.add_partials(
                keys.T.contiguous(), kv.T.contiguous(), first,
                [acc[:, a].view(torch.float64) if f else acc[:, a]
                 for a, (_op, f) in enumerate(specs)],
                [cnt[:, a] for a in range(len(specs))])
            owned.append(merged.rows())
        rows = self._gather_rows(owned)
        return self._emit(rows, specs, kinds, self._sync_vocab(vocab_of))

    def _gather_rows(self, owned: list) -> tuple:
        """The owners' groups together, ordered by first-seen rank, on the
        first shard's device (over every process)."""
        dev = self.mesh.devices[0]
        cat = [torch.cat([o[i].to(dev) for o in owned], dim=-1)
               for i in range(5)]
        if self.mesh.n_processes > 1:
            host = allgather_pickled([c.cpu().numpy() for c in cat])
            cat = [torch.from_numpy(np.concatenate([h[i] for h in host],
                                                   axis=-1)).to(dev)
                   for i in range(5)]
        order = torch.argsort(cat[2], stable=True)
        return tuple(c[..., order] for c in cat)

    def _sync_vocab(self, vocab_of: dict) -> dict:
        """The dictionary strings by content hash over every process; a hash
        two strings share raises, as ``_key_part`` does in one process."""
        merged = dict(vocab_of)
        for other in allgather_pickled(vocab_of):
            for h, s in other.items():
                if merged.setdefault(h, s) != s:
                    raise ExecutionError(
                        f"keys {merged[h]!r} and {s!r} share the 64-bit "
                        "content hash")
        return merged

    def _emit(self, rows: tuple, specs: tuple, kinds: list,
              vocab_of: dict) -> Batch:
        """The output batch through ``AggregateExec._finalize_grouped``: one
        key part a key (a string key's bytes as its representative)."""
        keys, kv, first, acc, cnt = rows
        g = first.shape[0]
        one, valid, reps, at = [], [], {}, 0
        for i, kind in enumerate(kinds):
            if kind == "var":
                w = DEFAULT_REP_W // 8
                kvi = kv[at].bool()
                reps[i] = _var_key(keys[at:at + w], keys[at + w], kvi)
                one.append(torch.zeros_like(keys[at]))
                valid.append(kvi)
                at += w + 1
            else:
                one.append(keys[at])
                valid.append(kv[at].bool())
                at += 1
        res = agg_ops.GroupedResult(
            torch.stack(one), torch.stack(valid),
            [acc[a].view(torch.float64) if f else acc[a]
             for a, (_op, f) in enumerate(specs)],
            [cnt[a] for a in range(len(specs))],
            torch.arange(g, device=first.device))
        return self._finalize_grouped(res, kinds, vocab_of, reps)

    def _run_ungrouped(self) -> Batch:
        device_parts = [self._ungrouped_partials(b, mask)
                        for _s, b, mask, _base in self._waves(
                            self.input.batches())]
        partials = self._merge_partials(device_parts)
        if self.mesh.n_processes > 1:
            every = allgather_pickled(partials)
            partials = self._merge_partials(every[1:], every[0])
        return self._finalize_ungrouped(partials, self.mesh.devices[0])


# ---------------------------------------------------------------------------
# TopK (ORDER BY … LIMIT k)
# ---------------------------------------------------------------------------


class _Materialized(PhysicalPlan):
    def __init__(self, schema: Schema, batches: list):
        self._schema = schema
        self._batches = batches

    def schema(self) -> Schema:
        return self._schema

    def batches(self) -> Iterator[Batch]:
        return iter(self._batches)


@dataclasses.dataclass
class DistributedTopKExec(PhysicalPlan):
    """Sort + Limit over the mesh (:1506): each shard keeps the top
    ``fetch`` rows of each of its batches (sort_keys + ``torch.sort``); the
    candidates of every shard and process are finished by one more sort
    with the fetch, on ``device``."""

    keys: list          # [(Expr, ascending)]
    fetch: int
    out_schema: Schema
    input: PhysicalPlan  # the scan
    stages: tuple
    mesh: Mesh
    device: object = "cuda"

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.input]

    def batches(self) -> Iterator[Batch]:
        cands = []
        for wave, _cap in lockstep_wave_iter(iter(self.input.batches()),
                                             self.mesh):
            for s, b in enumerate(wave):
                b = _on(b, self.mesh.devices[s])
                b, _mask = apply_stages(self.stages, b, compact_last=True)
                if b.length:
                    cands.extend(SortExec(
                        self.keys, _Materialized(self.out_schema, [b]),
                        self.fetch).batches())
        if self.mesh.n_processes > 1:
            every = allgather_pickled([b.to_host() for b in cands])
            cands = [b for host in every for b in host]
        cands = [_on(b, self.device) for b in cands]
        yield from SortExec(self.keys, _Materialized(self.out_schema, cands),
                            self.fetch).batches()


# ---------------------------------------------------------------------------
# The broadcast join
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedJoinExec(PhysicalPlan):
    """Inner or left equi-join with the build (right) side broadcast and the
    probe stream dealt over the shards (:1218). The build side is collected
    and sorted once a card (``JoinExec._build_side``) and shared by the
    card's shards; in a multi-process run every process builds it from the
    whole file set, as :1253 does. The probe scan's batches go round-robin
    to the shards a wave at a time; each shard runs ``JoinExec``'s probe
    (searchsorted, expand_segments, every key part verified) on its batch
    after the fused Filter/Project stages. Output comes wave-major, then in
    global shard order: the probe stream's order, as from ``JoinExec``."""

    probe: PhysicalPlan   # the probe side's scan
    stages: tuple         # the Filter/Project chain over it, scan side first
    build: PhysicalPlan
    on: list              # [(left_expr, right_expr)]
    how: str              # inner | left
    filter: Optional[object]
    out_schema: Schema
    mesh: Mesh

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.probe, self.build]

    def batches(self) -> Iterator[Batch]:
        join = JoinExec(self.probe, self.build, self.on, self.how,
                        self.filter, self.out_schema)
        rschema = self.build.schema()
        parts = [b for b in self.build.batches() if b.length]
        vocab_of: dict = {}
        builds = {}
        if parts:
            whole = concat_batches(rschema, parts, parts[0].device)
            for dev in dict.fromkeys(self.mesh.devices):
                builds[dev] = join._build_side(_on(whole, dev), vocab_of)
        for wave, _cap in lockstep_wave_iter(iter(self.probe.batches()),
                                             self.mesh):
            outs = []
            for s, b in enumerate(wave):
                dev = self.mesh.devices[s]
                b, _mask = apply_stages(self.stages, _on(b, dev),
                                        compact_last=True)
                if b.length == 0:
                    continue
                if not builds:
                    if self.how == "left":
                        outs.append(join._unmatched(b, rschema))
                    continue
                out = join._probe(b, builds[dev], vocab_of)
                if out is not None:
                    outs.append(out)
            if self.mesh.n_processes > 1:
                every = allgather_pickled([o.to_host() for o in outs])
                outs = [_on(o, self.mesh.devices[0])
                        for host in every for o in host]
            yield from outs


# ---------------------------------------------------------------------------
# Rows to the shard that owns their key
# ---------------------------------------------------------------------------


def _collect_rows(plan: PhysicalPlan, mesh: Mesh) -> Batch:
    """``plan``'s rows as one batch on the first shard's device. In a
    multi-process run each process decodes its own files and the rows of
    every process are gathered to each, in process order (as the JAX
    package gathers its Arrow tables, :1741-1766, :2065-2084). Returns
    (batch, first row of this process's own rows, their count)."""
    dev = mesh.devices[0]
    schema = plan.schema()
    if mesh.n_processes == 1:
        b = concat_batches(schema, [_on(b, dev) for b in plan.batches()], dev)
        return b, 0, b.length
    with scan_shard_context(mesh.process_index, mesh.n_processes):
        local = concat_batches(schema, [_on(b, dev) for b in plan.batches()],
                               dev)
    every = allgather_pickled(local.to_host())
    base = sum(b.length for b in every[:mesh.process_index])
    return concat_host(schema, every).to_device(dev), base, local.length


def _bucket(mesh: Mesh, route: torch.Tensor, mask, cols: list) -> tuple:
    """One bucket_pack of ``cols`` to the mesh's shards by the hash of
    ``route``, the buckets sized from a first, counting call (capacity 0),
    so none overflows: (buckets, counts as a host list)."""
    n = mesh.n_shards
    _o, counts, _d, _r = bucket_pack(route, mask, [], n, 0)
    counts = counts.tolist()
    out, _c, _d, _r = bucket_pack(route, mask, cols, n, max(counts, default=0))
    return out, counts


# ---------------------------------------------------------------------------
# PARTITION BY windows
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedWindowExec(PhysicalPlan):
    """Window calls that share one non-empty PARTITION BY, data-parallel
    over the shards (:1698). Each row goes to shard ``hash(partition key) %
    n_shards`` through bucket_pack, routed by the fold of its
    ``join_key_parts``, so that a dictionary key and a string key route
    alike and NULL keys form one partition on one shard. Only the columns
    the calls read travel to the shards (:1774-1782). Each shard runs
    WindowExec's own path over its rows, in input order (sort_keys and
    stable sorts, window_bounds, window_frame; exact on every key byte), and
    each call's column is scattered back to input order and appended to the
    input rows. In a multi-process run each process decodes its own files,
    the rows of every process are gathered to each, each process computes
    its own shards, and their columns are gathered back."""

    calls: list
    names: list
    out_schema: Schema
    input: PhysicalPlan
    mesh: Mesh

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.input]

    def batches(self) -> Iterator[Batch]:
        global window_rows
        from ..plan.expressions import _torch_dtype, expr_columns
        from ..plan.window_exec import _sorted_bounds, _window_column

        mesh, dev0 = self.mesh, self.mesh.devices[0]
        in_schema = self.input.schema()
        whole, _base, _own = _collect_rows(self.input, mesh)
        n = whole.length
        if n == 0:
            yield empty_batch(self.out_schema).to_device(dev0)
            return
        need: set = set()
        for c in self.calls:
            for e in c.children():
                need |= expr_columns(e)
        sub = whole.project([f for f in in_schema.names if f in need]
                            or in_schema.names[:1])
        parts, _valid, _cols = join_key_parts(self.calls[0].partition_by,
                                              whole, {})
        rows = torch.arange(n, dtype=torch.int32, device=dev0)
        (buckets,), counts = _bucket(mesh, fold_key(parts), None, [rows])
        window_rows += n
        fields = self.out_schema.all_fields[len(in_schema.all_fields):]
        outs = [(torch.zeros(n, dtype=_torch_dtype(f.dtype), device=dev0),
                 torch.zeros(n, dtype=torch.bool, device=dev0))
                for f in fields]
        owned = []
        for s, dev in enumerate(mesh.devices):
            g = mesh.first_shard + s
            idx = buckets[g, :counts[g]]
            owned.append(idx)
            if idx.numel() == 0:
                continue
            shard = _on(layout_ops.take_batch(sub, idx), dev)
            sorts: dict = {}
            for (vals, valid), call, f in zip(outs, self.calls, fields):
                key = repr((call.partition_by, call.order_by))
                if key not in sorts:
                    sorts[key] = _sorted_bounds(call, shard)
                col = _window_column(call, shard, *sorts[key], f)
                vals[idx.long()] = col.values.to(dev0)
                valid[idx.long()] = col.validity.to(dev0)
        if mesh.n_processes > 1:
            mine = torch.cat(owned).long()
            every = allgather_pickled(
                (mine.cpu().numpy(), [(v[mine].cpu().numpy(),
                                       m[mine].cpu().numpy())
                                      for v, m in outs]))
            for idx, cols in every:
                idx = torch.from_numpy(idx).to(dev0)
                for (vals, valid), (v, m) in zip(outs, cols):
                    vals[idx] = torch.from_numpy(v).to(dev0)
                    valid[idx] = torch.from_numpy(m).to(dev0)
        yield Batch(self.out_schema, list(whole.columns)
                    + [FixedColumn(v, m) for v, m in outs], n, dev0)


# ---------------------------------------------------------------------------
# The partitioned join
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Side:
    batch: Batch        # every row of the side, on the first shard's device
    parts: torch.Tensor  # int64 [P, n] key parts
    valid: torch.Tensor  # bool [n]: every key part non-NULL
    cols: list          # the evaluated key columns
    own: tuple          # (first row, count) of this process's own rows


def _collect_side(plan: PhysicalPlan, exprs: list, mesh: Mesh,
                  vocab_of: dict) -> _Side:
    """One side of the partitioned join, collected once with its key parts
    (:2046)."""
    batch, base, n_own = _collect_rows(plan, mesh)
    parts, valid, cols = join_key_parts(exprs, batch, vocab_of)
    return _Side(batch, parts, valid, cols, (base, n_own))


@dataclasses.dataclass
class DistributedPartitionedJoinExec(PhysicalPlan):
    """Inner or left equi-join with both sides hash-partitioned over the
    shards (:1959), chosen by the session's ``partitioned_join``. Each side
    is collected once on the first shard's device with its key parts. Only
    (folded key, row id) pairs travel: one bucket_pack a side, its buckets
    sized from a first counting call (no overflow and no retry, where the
    JAX package grows them ×4), then the exchange to each key's owner. The
    owner sorts its build keys, searches them with its probe keys and lays
    out the candidate pairs with expand_segments. Every key part of every
    pair is then verified (string_eq on strings; the JAX package trusts the
    64-bit ``_group_key_i64``, ROADMAP Queue 3, F32). The pairs are sorted
    to (left row, right row) order, the order of ``JoinExec``; the ON
    residual is applied to them before a LEFT join's null extension, as
    ``JoinExec._probe`` does (the JAX package filters after it and drops
    the NULL-extended rows, F31); both sides are gathered with
    ``take_batch``. In a multi-process run each process decodes its own
    files, both sides are gathered to every process (as :2076-2084 does),
    each process sends the pairs of its own rows through the exchange, and
    the verified pairs of every owner are gathered to every process."""

    left: PhysicalPlan
    right: PhysicalPlan
    on: list
    how: str              # inner | left
    filter: Optional[object]
    out_schema: Schema
    mesh: Mesh

    def schema(self) -> Schema:
        return self.out_schema

    def children(self):
        return [self.left, self.right]

    def batches(self) -> Iterator[Batch]:
        vocab_of: dict = {}
        lside = _collect_side(self.left, [le for le, _r in self.on],
                              self.mesh, vocab_of)
        rside = _collect_side(self.right, [re for _l, re in self.on],
                              self.mesh, vocab_of)
        if lside.batch.length == 0:
            return
        li, ri = self._pairs(lside, rside)
        out = self._emit(lside, rside, li, ri)
        if out is not None:
            yield out

    def _pairs(self, lside: _Side, rside: _Side) -> tuple:
        """The verified (left row, right row) pairs of every owner, int64
        on the first shard's device. A pair travels as its folded key and
        row id, int64 and int32."""
        global exchanged_pairs
        mesh, dev0 = self.mesh, self.mesh.devices[0]
        recv = []
        for side in (lside, rside):
            base, n_own = side.own
            key = fold_key(side.parts[:, base:base + n_own])
            rows = torch.arange(base, base + n_own, dtype=torch.int32,
                                device=dev0)
            mask = side.valid[base:base + n_own]
            out, counts = _bucket(mesh, key, mask, [key, rows])
            recv.append(exchange(mesh, [out], [counts]))
            exchanged_pairs += sum(counts)
        li, ri = [], []
        for (lk, lr), (rk, rr) in zip(*recv):
            perm = torch.sort(rk, stable=True).indices
            rk, rr = rk[perm], rr[perm]
            lo = torch.searchsorted(rk, lk, side="left")
            cnt = (torch.searchsorted(rk, lk, side="right") - lo).to(
                torch.int32)
            pi, bi, _offsets, total = expand_segments(lo.to(torch.int32),
                                                      cnt, rk.shape[0])
            if total == 0:
                continue
            li.append(lr[pi.long()].to(dev0))
            ri.append(rr[bi.long()].to(dev0))
        empty = torch.zeros(0, dtype=torch.int32, device=dev0)
        li = torch.cat(li) if li else empty
        ri = torch.cat(ri) if ri else empty
        ok = verify_pairs(lside.parts, lside.cols, rside.parts, rside.cols,
                          li, ri)
        sel, count = layout_ops.mask_to_indices(ok)
        sel = sel[:int(count)].long()
        li, ri = li[sel].long(), ri[sel].long()
        if mesh.n_processes > 1:
            every = allgather_pickled((li.cpu().numpy(), ri.cpu().numpy()))
            li = torch.from_numpy(np.concatenate([a for a, _b in every])
                                  ).to(dev0)
            ri = torch.from_numpy(np.concatenate([b for _a, b in every])
                                  ).to(dev0)
        return li, ri

    def _emit(self, lside: _Side, rside: _Side, li, ri) -> Optional[Batch]:
        """The output rows of the pairs, in (left row, right row) order."""
        n_left, dev0 = lside.batch.length, self.mesh.devices[0]
        left_join = self.how == "left"
        if left_join:
            # a left row with no pair keeps one row, its right side NULL
            hit = torch.zeros(n_left, dtype=torch.bool, device=dev0)
            hit[li] = True
            lone, count = layout_ops.mask_to_indices(~hit)
            lone = lone[:int(count)].long()
            li = torch.cat([li, lone])
            ri = torch.cat([ri, torch.full_like(lone, -1)])
        n = li.shape[0]
        if n == 0:
            return None
        perm = torch.sort(ri, stable=True).indices
        perm = perm[torch.sort(li[perm], stable=True).indices]
        li, ri = li[perm], ri[perm]
        left = layout_ops.take_batch(lside.batch, li.to(torch.int32))
        if rside.batch.length:
            right = layout_ops.take_batch(rside.batch,
                                          ri.clamp(min=0).to(torch.int32))
        else:
            right = empty_batch(rside.batch.schema, n).to_device(dev0)
        miss = ri < 0
        if self.filter is not None:
            raw = Batch(self.out_schema, left.columns + right.columns, n)
            ok = as_bool_mask(eval_expr(self.filter, raw), raw) & ~miss
            if left_join:
                # a left row none of whose pairs passed the residual keeps
                # its first row, null-extended (join_exec.py:280-297)
                surv = torch.zeros(n_left, dtype=torch.uint8,
                                   device=dev0).scatter_reduce(
                    0, li, ok.to(torch.uint8), "amax")
                first = torch.ones(n, dtype=torch.bool, device=dev0)
                first[1:] = li[1:] != li[:-1]
                miss = first & (surv[li] == 0)
                ok |= miss
            sel, count = layout_ops.mask_to_indices(ok)
            sel = sel[:int(count)]
            left = layout_ops.take_batch(left, sel)
            right = layout_ops.take_batch(right, sel)
            miss = miss[sel.long()]
        right_cols = [layout_ops.null_where(c, miss) for c in right.columns] \
            if left_join else right.columns
        return Batch(self.out_schema, left.columns + right_cols, left.length,
                     dev0)


# ---------------------------------------------------------------------------
# A full ORDER BY over several processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DistributedSortExec(PhysicalPlan):
    """ORDER BY across processes (:1887): each process sorts only its own
    files into one run (``SortExec.merged_run``: the device sort of each
    run, the host merge of the runs), the runs (host batch, key matrix,
    chunk widths) are exchanged once and merged by ``_merge_runs``, which
    pads a run's narrower var-width keys (``_pad_key_matrix``) and lets
    earlier runs win ties, so ties go process-major. Every process ends with
    the whole result. ``fetch`` cuts each run and the merge: a LIMIT the
    TopK does not take comes here with its skip + fetch."""

    keys: list          # [(Expr, ascending)]
    input: PhysicalPlan
    fetch: Optional[int]
    mesh: Mesh
    device: object = "cuda"

    def schema(self) -> Schema:
        return self.input.schema()

    def children(self):
        return [self.input]

    def batches(self) -> Iterator[Batch]:
        inner = SortExec(self.keys, self.input, self.fetch)
        with scan_shard_context(self.mesh.process_index,
                                self.mesh.n_processes):
            run = inner.merged_run()
        runs = [r for r in allgather_pickled(run) if r is not None]
        if not runs:
            return
        merged = _merge_runs(runs, [a for _e, a in self.keys])[0]
        if self.fetch is not None and merged.length > self.fetch:
            merged = take_host(merged, np.arange(self.fetch))
        yield merged.to_device(self.device)


# ---------------------------------------------------------------------------
# Planner hooks
# ---------------------------------------------------------------------------


def _config_mesh(config, device) -> Optional[Mesh]:
    """The session's mesh when distributed execution is on (:1490)."""
    if config is None or not getattr(config, "distributed", False):
        return None
    return make_mesh(config.n_shards or None, device)


def _chain(node) -> tuple:
    """(stages scan side first, the node under the Filter/Project chain)."""
    from ..plan import logical as L

    stages = []
    while isinstance(node, (L.Filter, L.Project)):
        if isinstance(node, L.Filter):
            stages.append(("filter", node.predicate, None))
        else:
            stages.append(("project", tuple(node.exprs), node.schema()))
        node = node.input
    return tuple(reversed(stages)), node


def _scan_input(node, device) -> Optional[tuple]:
    """(stages, the lowered scan) when ``node`` is a Filter/Project chain
    over one scan whose rows the mesh can take: split per process in a
    multi-process run, and without list, struct or map columns (:1465,
    :1672)."""
    from ..plan import logical as L
    from ..plan.planner import create_physical_plan

    stages, scan = _chain(node)
    if not isinstance(scan, L.Scan) or not _multihost_shardable(scan):
        return None
    if any(f.dtype.kind.value in ("list", "struct", "map")
           for f in scan.schema().all_fields):
        return None
    return stages, create_physical_plan(scan, device)


def _shards(config, device) -> Optional[Mesh]:
    """The session's mesh when it has more than one shard."""
    mesh = _config_mesh(config, device)
    return mesh if mesh is not None and mesh.n_shards > 1 else None


def plan_distributed_aggregate(agg_plan, device, config
                               ) -> Optional[PhysicalPlan]:
    """A DistributedAggregateExec for an L.Aggregate over a scan chain the
    mesh takes (:1401), else None: count/sum/min/max/avg, MIN/MAX not over
    strings."""
    from ..plan.planner import create_physical_plan, infer_expr_field

    mesh = _shards(config, device)
    if mesh is None:
        return None
    in_schema = agg_plan.input.schema()
    for call in agg_plan.agg_exprs:
        if call.distinct or call.fn not in ("count", "sum", "min", "max",
                                            "avg"):
            return None
        if call.fn in ("min", "max") and call.child is not None and \
                infer_expr_field(call.child, in_schema).dtype.kind.value in (
                    "utf8", "large_utf8", "dictionary", "binary"):
            return None
    found = _scan_input(agg_plan.input, device)
    if found is None:
        return None
    stages, scan = found
    return DistributedAggregateExec(
        list(agg_plan.group_exprs), list(agg_plan.agg_exprs),
        agg_plan.schema(), scan, stages=stages, mesh=mesh,
        fallback=lambda: create_physical_plan(agg_plan, device))


def plan_distributed_topk(sort_plan, fetch, device, config
                          ) -> Optional[PhysicalPlan]:
    """A DistributedTopKExec for Sort(keys) + a fetch over a scan chain
    (:1640), else None."""
    mesh = _shards(config, device)
    if mesh is None or fetch is None or fetch > MAX_DIST_TOPK:
        return None
    found = _scan_input(sort_plan.input, device)
    if found is None:
        return None
    stages, scan = found
    return DistributedTopKExec(list(sort_plan.keys), fetch,
                               sort_plan.schema(), scan, stages, mesh, device)


def plan_distributed_sort(sort_plan, fetch, device, config
                          ) -> Optional[PhysicalPlan]:
    """A DistributedSortExec for a Sort over a scan chain in a
    multi-process run (:1930), else None; ``fetch`` cuts it."""
    from ..plan.planner import create_physical_plan

    if process_count() <= 1 or not _scan_chain(sort_plan.input):
        return None
    mesh = _config_mesh(config, device)
    if mesh is None:
        return None
    return DistributedSortExec(list(sort_plan.keys),
                               create_physical_plan(sort_plan.input, device),
                               fetch, mesh, device)


def plan_distributed_window(win_plan, device, config
                            ) -> Optional[PhysicalPlan]:
    """A DistributedWindowExec when every call shares one non-empty
    PARTITION BY and is a window function (:1846), over a scan chain in a
    multi-process run; else None."""
    from ..plan.planner import create_physical_plan
    from ..plan.window_exec import WINDOW_FUNCS

    if process_count() > 1 and not _scan_chain(win_plan.input):
        return None
    mesh = _shards(config, device)
    calls = win_plan.calls
    if mesh is None or not calls or not calls[0].partition_by:
        return None
    first = [repr(e) for e in calls[0].partition_by]
    if not all(c.fn in WINDOW_FUNCS and
               [repr(e) for e in c.partition_by] == first for c in calls):
        return None
    return DistributedWindowExec(
        list(calls), list(win_plan.names), win_plan.schema(),
        create_physical_plan(win_plan.input, device, config), mesh)


def plan_distributed_join(join_plan, device, config
                          ) -> Optional[PhysicalPlan]:
    """A DistributedJoinExec for an inner or left L.Join whose probe (left)
    side is a Filter/Project chain over a scan the mesh takes (:1347), else
    None; the build side lowers as usual."""
    from ..plan import logical as L
    from ..plan.planner import create_physical_plan

    mesh = _shards(config, device)
    if mesh is None or join_plan.how not in ("inner", "left"):
        return None
    stages, scan = _chain(join_plan.left)
    if not isinstance(scan, L.Scan) or not _multihost_shardable(scan):
        return None
    return DistributedJoinExec(
        create_physical_plan(scan, device), stages,
        create_physical_plan(join_plan.right, device, config),
        list(join_plan.on), join_plan.how, join_plan.filter,
        join_plan.schema(), mesh)


def plan_distributed_partitioned_join(join_plan, device, config
                                      ) -> Optional[PhysicalPlan]:
    """A DistributedPartitionedJoinExec for an inner or left L.Join under
    ``partitioned_join`` (:2214), else None (the planner then tries the
    broadcast join). A multi-process run needs both sides scan chains."""
    from ..plan.planner import create_physical_plan

    if process_count() > 1 and not (_scan_chain(join_plan.left) and
                                    _scan_chain(join_plan.right)):
        return None
    mesh = _shards(config, device)
    if mesh is None or join_plan.how not in ("inner", "left"):
        return None
    return DistributedPartitionedJoinExec(
        create_physical_plan(join_plan.left, device, config),
        create_physical_plan(join_plan.right, device, config),
        list(join_plan.on), join_plan.how, join_plan.filter,
        join_plan.schema(), mesh)
