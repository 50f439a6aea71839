"""The hash-partition shuffle between the shards of a mesh.

Counterpart of exon_tpu/parallel/shuffle.py. ``partition_ids`` (:39) and
``bucketize`` (:51) run on the bucket_pack kernel, which also fuses them:
each shard's rows go to ``[n_shards, bucket_cap]`` buckets by destination,
with their true counts, so that an overflow is always seen, never silent.
The exchange that ``lax.all_to_all`` does there (``hash_partition_shuffle``
:87) is, between the shards of one process, a slice of each owner's bucket
from every source (a shard's pack, or one pack over every shard of a card);
across processes it is ``torch.distributed.all_to_all_single`` over the
processes' buffers. The per-pair counts travel first, and then only the
live rows, where the JAX package sends every bucket padded to its
capacity. ``overflow`` is global, as there. ``distributed_group_count`` and
``distributed_group_sum`` (:118, :135) count or add each owner's rows with
``index_add_`` and sum the owners' partials.

``hash_partition_shuffle`` takes one entry per local shard in each of its
list arguments and returns one per local shard, each on its shard's
device.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

# partition_ids (:39) alone is elementwise torch; the shuffle's path runs
# it fused into bucket_pack
from ..kernels.bucket_pack import bucket_pack, partition_ids  # noqa: F401
from .mesh import Mesh


def bucketize(dest: torch.Tensor, mask: torch.Tensor, cols: list,
              n_parts: int, bucket_cap: int) -> tuple:
    """Scatter rows into per-destination buckets [n_parts, bucket_cap]
    (shuffle.py:51). Returns (bucketed columns, counts int32 [n_parts]):
    the counts are the true totals before rows past ``bucket_cap`` drop."""
    out, counts, _dest, _rank = bucket_pack(dest.to(torch.int32), mask,
                                            cols, n_parts, bucket_cap,
                                            hashed=False)
    return out, counts


def any_process(mesh: Mesh, flag: bool) -> bool:
    """``flag`` of any process (a psum of flags in the JAX package)."""
    if mesh.n_processes == 1:
        return bool(flag)
    t = torch.tensor([int(flag)], dtype=torch.int64, device=mesh.comm_device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def psum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over every process (``lax.psum`` over processes)."""
    if mesh.n_processes == 1:
        return x
    t = x.to(mesh.comm_device)
    dist.all_reduce(t)
    return t.to(x.device)


def exchange(mesh: Mesh, buckets: list, sent: list) -> list:
    """Bucketed rows to their owners. ``buckets`` holds one source a
    bucket_pack call, in shard order (a local shard, or every shard of a
    card packed together): ``buckets[g][k]`` is its column k,
    ``[n_shards, cap, ...]``, and ``sent[g][d]`` the rows of its bucket d to
    send (the count, at most cap). Returns per local shard d its received
    columns on d's device: the rows of process 0 first, and within a process
    those of its sources in order."""
    if mesh.n_processes > 1:
        return _exchange_processes(mesh, buckets, sent)
    out = []
    for d, dev in enumerate(mesh.devices):
        cols = []
        for k in range(len(buckets[0])):
            got = [b[k][d, :c[d]].to(dev) for b, c in zip(buckets, sent)]
            cols.append(got[0] if len(got) == 1 else torch.cat(got))
        out.append(cols)
    return out


def _row_bytes(b: torch.Tensor) -> int:
    return b.element_size() * math.prod(b.shape[2:])


def _as_bytes(x: torch.Tensor) -> torch.Tensor:
    """[rows, ...] → uint8 [rows, row bytes]."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:])).view(torch.uint8)


def _from_bytes(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """uint8 [rows, row bytes] (a column slice of the records) → rows
    shaped and typed as bucket ``like``."""
    out = torch.empty(r.shape, dtype=torch.uint8, device=r.device)
    return out.copy_(r).view(like.dtype).reshape(
        (r.shape[0],) + tuple(like.shape[2:]))


def _exchange_processes(mesh: Mesh, buckets: list, sent: list) -> list:
    """The exchange across processes: the rows for each (process, local
    shard) by one ``all_to_all_single``, then every live row as one byte
    record (its columns side by side) by another, with uneven splits."""
    P, L, cdev = mesh.n_processes, mesh.n_local, mesh.comm_device
    # to[q][d]: the rows of every source here for process q's shard d
    to = [[sum(c[q * L + d] for c in sent) for d in range(L)]
          for q in range(P)]
    recv_cnt = torch.empty((P, L), dtype=torch.int64, device=cdev)
    dist.all_to_all_single(recv_cnt, torch.tensor(to, dtype=torch.int64,
                                                  device=cdev))
    rc = recv_cnt.tolist()  # rc[p][d]: rows from process p for my shard d
    widths = [_row_bytes(b) for b in buckets[0]]
    pieces = [torch.cat([_as_bytes(b[q * L + d, :c[q * L + d]]) for b in src],
                        dim=1).to(cdev)
              for q in range(P) for d in range(L)
              for src, c in zip(buckets, sent) if c[q * L + d]]
    send = torch.cat(pieces) if pieces else \
        torch.zeros((0, sum(widths)), dtype=torch.uint8, device=cdev)
    out_splits = [sum(r) for r in rc]
    recv = torch.empty((sum(out_splits), sum(widths)), dtype=torch.uint8,
                       device=cdev)
    dist.all_to_all_single(recv, send, out_splits, [sum(t) for t in to])
    parts = recv.split([rc[p][d] for p in range(P) for d in range(L)])
    out = []
    for d, dev in enumerate(mesh.devices):
        rows = torch.cat([parts[p * L + d] for p in range(P)]).to(dev)
        cols, at = [], 0
        for b, w in zip(buckets[0], widths):
            cols.append(_from_bytes(rows[:, at:at + w], b))
            at += w
        out.append(cols)
    return out


def hash_partition_shuffle(mesh: Mesh, keys: list, masks: list, cols: list,
                           bucket_cap: int) -> tuple:
    """Rows to the shard owning hash(key) (shuffle.py:87): keys[s] int64
    [n], masks[s] bool [n] and cols[s] (a list of columns) per local shard.
    Returns ([(recv_keys, recv_cols) per local shard], overflow): overflow
    is True on every process when any shard had a bucket past
    ``bucket_cap``, whose rows past it were dropped."""
    packed, sent, over = [], [], False
    for s in range(mesh.n_local):
        out, counts, _dest, _rank = bucket_pack(
            keys[s], masks[s], [keys[s]] + list(cols[s]), mesh.n_shards,
            bucket_cap)
        counts = counts.tolist()
        over = over or max(counts, default=0) > bucket_cap
        packed.append(out)
        sent.append([min(c, bucket_cap) for c in counts])
    recv = exchange(mesh, packed, sent)
    return [(r[0], r[1:]) for r in recv], any_process(mesh, over)


def distributed_group_count(mesh: Mesh, codes: list, masks: list,
                            num_groups: int, bucket_cap: int) -> torch.Tensor:
    """Group-by count across the mesh (shuffle.py:118): rows shuffled to
    their key's owner, counted there, the owners' counts summed. Returns
    int64 [num_groups] on the first shard's device."""
    recv, _ = hash_partition_shuffle(
        mesh, [c.to(torch.int64) for c in codes], masks,
        [[] for _ in codes], bucket_cap)
    out = torch.zeros(num_groups, dtype=torch.int64, device=mesh.devices[0])
    for k, _cols in recv:
        local = torch.zeros(num_groups, dtype=torch.int64, device=k.device)
        local.index_add_(0, k.clamp(0, num_groups - 1), torch.ones_like(k))
        out += local.to(out.device)
    return psum(mesh, out)


def distributed_group_sum(mesh: Mesh, codes: list, values: list, masks: list,
                          num_groups: int, bucket_cap: int) -> torch.Tensor:
    """Group-by sum across the mesh (shuffle.py:135), in the values'
    dtype."""
    recv, _ = hash_partition_shuffle(
        mesh, [c.to(torch.int64) for c in codes], masks,
        [[v] for v in values], bucket_cap)
    out = torch.zeros(num_groups, dtype=values[0].dtype,
                      device=mesh.devices[0])
    for k, (v,) in recv:
        local = torch.zeros(num_groups, dtype=v.dtype, device=k.device)
        local.index_add_(0, k.clamp(0, num_groups - 1), v)
        out += local.to(out.device)
    return psum(mesh, out)
