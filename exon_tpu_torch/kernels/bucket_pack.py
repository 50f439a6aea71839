"""bucket_pack: rows into per-destination buckets, stably, in one sequence.

Replaces exon_tpu/parallel/shuffle.py ``partition_ids`` (:39) and
``bucketize`` (:51), the head of the hash-partition shuffle. Kernel source:
``csrc/bucket_pack.cu``. The destinations are the murmur fmix32 finalizer
of each int64 key's low 32 bits modulo ``n_parts`` (``hashed``), or given as
int32. Masked rows, and given destinations outside ``[0, n_parts)``, take
no slot. Returns ``(buckets, counts, dest, rank)``:

- ``buckets``: per column a zeroed ``[n_parts, bucket_cap, ...]`` buffer
  holding each kept row at ``[dest, rank]``, rows in input order within a
  destination;
- ``counts``: int32 ``[n_parts]``, the rows of each destination before any
  is dropped, so that ``counts > bucket_cap`` shows an overflow;
- ``dest``: int32 ``[n]``, ``n_parts`` for a row that takes no slot;
- ``rank``: int32 ``[n]``, each row's stable rank within its destination
  (-1 for a row that takes no slot), also past ``bucket_cap``.

A column is any tensor with ``n`` rows whose row is 1, 4 or 8-byte
elements (bool, uint8, int32, int64, float64, ...) or a ``[n, w]`` matrix of
them; up to 17 columns.

On the card a call is two launches whatever its column count: the rank
pass, a single pass with a look-back per destination in the status words
of ``_lookback`` (up to 19,285 destinations, the shared memory of one warp's
counters), and the move pass, which scatters the rows and zeroes the empty
slots, so the buckets are allocated unfilled.
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from . import _build, _lookback

launches = 0

WARP_ROWS = 256           # kWarpRows in csrc/bucket_pack.cu
MAX_WARPS = 8             # kMaxWarps
SHARED_MAX = 232_448 - 1024  # kSharedMax: dynamic shared memory a block
MAX_PARTS = SHARED_MAX // 12  # one warp: (1 + 2) int32 counters a part
MAX_COLS = 17             # kMaxCols
_INT32_LIMIT = 1 << 31
_M32 = 0xFFFFFFFF


def partition_ids(keys: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Destination partition per int64 key (parallel/shuffle.py:39): the
    low 32 bits through murmur's fmix32, modulo ``n_parts``, as int32. The
    uint32 arithmetic runs in int64, masked to 32 bits after each multiply
    (the low 32 bits of a wrapped int64 product are exact)."""
    h = keys.to(torch.int64) & _M32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    h = h ^ (h >> 16)
    return (h % n_parts).to(torch.int32)


def _destinations(route, mask, n_parts: int, hashed: bool) -> torch.Tensor:
    dest = partition_ids(route, n_parts) if hashed else route.to(torch.int32)
    drop = (dest < 0) | (dest >= n_parts)
    if mask is not None:
        drop = drop | ~mask
    return torch.where(drop, n_parts, dest).to(torch.int32)


def bucket_pack_plain(route, mask, cols: list, n_parts: int,
                      bucket_cap: int, hashed: bool = True):
    """The plain PyTorch twin: a stable argsort of the destinations,
    ``bincount`` for the counts and ``index_copy_`` for the scatter, as
    ``bucketize`` computes them."""
    n = route.shape[0]
    dev = route.device
    dest = _destinations(route, mask, n_parts, hashed)
    order = torch.argsort(dest, stable=True)
    ds = dest[order].long()
    every = torch.bincount(ds, minlength=n_parts + 1)
    starts = torch.cumsum(every, 0) - every
    pos = torch.arange(n, device=dev) - starts[ds]
    live = ds < n_parts
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[order] = torch.where(live, pos, -1).to(torch.int32)
    ok = live & (pos < bucket_cap)
    flat = (ds * bucket_cap + pos)[ok]
    rows = order[ok]
    out = []
    for c in cols:
        buf = torch.zeros((n_parts * bucket_cap,) + tuple(c.shape[1:]),
                          dtype=c.dtype, device=dev)
        buf.index_copy_(0, flat, c[rows])
        out.append(buf.view((n_parts, bucket_cap) + tuple(c.shape[1:])))
    return out, every[:n_parts].to(torch.int32), dest, rank


def rank_warps(n_parts: int) -> int:
    """Warps of the rank pass's tile: 8, fewer where (warps + 2) int32
    counters a destination would pass a block's shared memory."""
    return min(MAX_WARPS, SHARED_MAX // (4 * n_parts) - 2)


# the move pass's columns: source address, bucket address and row bytes
# each, filled in place for every call under _args_lock
_ARGS = (ctypes.c_int64 * (3 * MAX_COLS))()
_args_lock = threading.Lock()


def bucket_pack(route: torch.Tensor, mask, cols: list, n_parts: int,
                bucket_cap: int, hashed: bool = True):
    """See the module docstring. ``route`` is int64 keys (``hashed``) or
    int32 destinations; ``mask`` is bool [n] or None."""
    global launches
    n = route.shape[0]
    want = torch.int64 if hashed else torch.int32
    if route.dtype != want or route.dim() != 1:
        raise TypeError(f"bucket_pack: route must be {want} [n]")
    if mask is not None and (mask.dtype != torch.bool or mask.shape != (n,)):
        raise TypeError("bucket_pack: mask must be bool [n]")
    if len(cols) > MAX_COLS:
        raise ValueError(f"bucket_pack: {len(cols)} columns exceed {MAX_COLS}")
    widths = []  # each column's row bytes
    for c in cols:
        if c.shape[:1] != (n,) or c.element_size() not in (1, 4, 8):
            raise TypeError("bucket_pack: every column needs n rows of 1-, "
                            "4- or 8-byte elements")
        widths.append(c.element_size() * math.prod(c.shape[1:]))
    if n_parts < 1 or bucket_cap < 0 or n >= _INT32_LIMIT or \
            n_parts * max(bucket_cap, 1) >= 1 << 62:
        raise ValueError("bucket_pack: bad n_parts, bucket_cap or row count")
    if not _build.on_cuda(route, "bucket_pack"):
        return bucket_pack_plain(route, mask, cols, n_parts, bucket_cap,
                                 hashed)
    if n_parts > MAX_PARTS:
        raise ValueError(f"bucket_pack: {n_parts} destinations exceed the "
                         f"{MAX_PARTS} the card's kernel takes")
    dev = route.device
    route = route.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    # destinations, ranks and counts in one allocation
    dest, rank, counts = torch.empty(2 * n + n_parts, dtype=torch.int32,
                                     device=dev).split([n, n, n_parts])
    if n == 0:
        counts.zero_()
        return [torch.zeros((n_parts, bucket_cap) + c.shape[1:],
                            dtype=c.dtype, device=dev) for c in cols], \
            counts, dest, rank
    # the buckets, left as allocated: the move pass writes every slot
    outs = [torch.empty((n_parts, bucket_cap) + c.shape[1:], dtype=c.dtype,
                        device=dev) for c in cols]
    lib = _build.library()
    stream = _build.stream_of(route)
    warps = rank_warps(n_parts)
    tiles = -(-n // (warps * WARP_ROWS))

    def rank_pass(status, ticket, base, epoch):
        _build.check(lib.exon_bucket_rank(
            n, route.data_ptr() if hashed else None,
            None if hashed else route.data_ptr(),
            mask.data_ptr() if mask is not None else None, n_parts, warps,
            status, ticket, base, epoch, dest.data_ptr(), rank.data_ptr(),
            counts.data_ptr(), stream), "bucket_pack")

    _lookback.scan(dev, stream, tiles * n_parts, tiles, rank_pass)
    if cols and bucket_cap:
        srcs = [c.contiguous() for c in cols]
        args = [x for c, o, w in zip(srcs, outs, widths)
                for x in (c.data_ptr(), o.data_ptr(), w)]
        with _args_lock:
            _ARGS[:len(args)] = args
            _build.check(lib.exon_bucket_move(
                n, dest.data_ptr(), rank.data_ptr(), counts.data_ptr(),
                n_parts, bucket_cap, len(cols), _ARGS, stream),
                "bucket_pack")
    launches += 1
    return outs, counts, dest, rank
