"""hash_aggregate: grouped count/sum/min/max and sum-of-squares partials in
one hash table.

Replaces the JAX package's per-batch sort-based group tables and their
merges (exon_tpu/ops/aggregate.py ``sort_group_ids`` :80 and
``grouped_reduce_codes`` :30, exon_tpu/plan/physical.py :565-692). Kernel
source: ``csrc/hash_aggregate.cu``.

A ``HashTable`` holds the slots (layout in the kernel source). ``insert``
adds rows to it: in raw mode each row is a key and per-aggregate values with
validity flags; in merge mode each row is a partial (count and accumulator)
and its first-seen row number, as the table's own growth re-inserts them.
SUMSQ (K4b, the Σx² partial of the var/stddev family, exon_tpu/plan/
physical.py:467-471) adds x² of float64 values in raw mode and the partial
itself in merge mode. On request ``insert`` also returns each row's slot
(-1 for a row the mask drops), written by the kernel in the same pass.
Slots are found by content, so two tables that saw the same rows hold the
same groups in possibly different slots; ``occupied`` lists the full ones.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from . import _build

launches = 0

COUNT, SUM, MIN, MAX, SUMSQ = 0, 1, 2, 3, 4
MAX_AGGS = 32  # kMaxAggs in csrc/hash_aggregate.cu
_I64_MAX = (1 << 63) - 1
_I64_MIN = -(1 << 63)


@dataclasses.dataclass
class HashTable:
    capacity: int            # a power of two
    specs: tuple             # per aggregate: (op, is_float)
    state: torch.Tensor      # int32 [cap]: 0 empty, 1 being written, 2 full
    keys: torch.Tensor       # int64 [n_parts, cap]
    key_valid: torch.Tensor  # uint8 [n_parts, cap]
    first: torch.Tensor      # int64 [cap]
    acc: torch.Tensor        # int64 [n_aggs, cap] (float64 bits where float)
    cnt: torch.Tensor        # int64 [n_aggs, cap]
    meta: torch.Tensor       # int64 [2]: groups created, overflow flag

    @staticmethod
    def empty(n_parts: int, specs: tuple, capacity: int, device) -> "HashTable":
        if capacity & (capacity - 1):
            raise ValueError(f"capacity {capacity} is not a power of two")
        if len(specs) > MAX_AGGS:
            raise ValueError(f"{len(specs)} aggregates exceed {MAX_AGGS}")
        acc = torch.zeros(len(specs), capacity, dtype=torch.int64,
                          device=device)
        for a, (op, is_float) in enumerate(specs):
            if op in (MIN, MAX):
                if is_float:
                    acc[a].view(torch.float64).fill_(
                        float("inf") if op == MIN else float("-inf"))
                else:
                    acc[a].fill_(_I64_MAX if op == MIN else _I64_MIN)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(*shape, dtype=dtype, device=device)

        return HashTable(capacity, tuple(specs), zeros(capacity,
                                                       dtype=torch.int32),
                         zeros(n_parts, capacity),
                         zeros(n_parts, capacity, dtype=torch.uint8),
                         torch.full((capacity,), _I64_MAX, dtype=torch.int64,
                                    device=device),
                         acc, zeros(len(specs), capacity), zeros(2))

    def acc_values(self, a: int) -> torch.Tensor:
        """Aggregate a's accumulators in their own dtype."""
        return self.acc[a].view(torch.float64) if self.specs[a][1] \
            else self.acc[a]


def insert_plain(t: HashTable, parts, part_valid, row_mask, first_in,
                 base_row: int, values, counts, slots: bool = False):
    """The plain PyTorch twin of ``insert``: new groups take the lowest
    free slots instead of their hash slot; every group's partials are the
    same as the kernel's, and so is the group behind each returned slot."""
    dev = parts.device
    n_parts, n = parts.shape
    slot_out = torch.full((n,), -1, dtype=torch.int64, device=dev) \
        if slots else None
    rows = torch.arange(n, device=dev) if row_mask is None \
        else torch.nonzero(row_mask).flatten()
    if rows.numel() == 0:
        return slot_out
    occupied = torch.nonzero(t.state == 2).flatten()
    old = torch.cat([t.keys[:, occupied], t.key_valid[:, occupied].long()])
    new = torch.cat([parts[:, rows], part_valid[:, rows].long()])
    uniq, inv = torch.unique(torch.cat([old, new], dim=1), dim=1,
                             return_inverse=True)
    slot_of = torch.full((uniq.shape[1],), -1, dtype=torch.int64, device=dev)
    slot_of[inv[:occupied.shape[0]]] = occupied
    fresh = torch.nonzero(slot_of < 0).flatten()
    free = torch.nonzero(t.state == 0).flatten()[: fresh.shape[0]]
    if free.shape[0] < fresh.shape[0]:
        t.meta[1] = 1
        return slot_out
    slot_of[fresh] = free
    t.state[free] = 2
    t.keys[:, free] = uniq[:n_parts, fresh]
    t.key_valid[:, free] = uniq[n_parts:, fresh].to(torch.uint8)
    t.meta[0] += fresh.shape[0]
    slot = slot_of[inv[occupied.shape[0]:]]
    if slots:
        slot_out[rows] = slot
    first = first_in[rows] if first_in is not None else base_row + rows
    t.first.scatter_reduce_(0, slot, first, "amin")
    for a, (op, _is_float) in enumerate(t.specs):
        c = counts[a][rows].to(torch.int64)
        t.cnt[a].index_add_(0, slot, c)
        if op == COUNT:
            continue
        live = c > 0
        s, v = slot[live], values[a][rows][live]
        acc = t.acc_values(a)
        if op == SUM:
            acc.index_add_(0, s, v)
        elif op == SUMSQ:
            acc.index_add_(0, s, v if first_in is not None else v * v)
        else:
            acc.scatter_reduce_(0, s, v, "amin" if op == MIN else "amax")
    return slot_out


def insert(t: HashTable, parts: torch.Tensor, part_valid: torch.Tensor,
           row_mask, first_in, base_row: int, values: list,
           counts: list, slots: bool = False):
    """Add rows to ``t``; with ``slots``, return int64 [n]: each row's slot
    in ``t``, -1 where ``row_mask`` drops the row.

    parts int64 [n_parts, n] and part_valid uint8 [n_parts, n] are the key
    columns; row_mask (bool [n] or None) drops rows before they form groups.
    Raw mode (first_in None): values[a] are int64/float64 [n] (None for
    COUNT) and counts[a] bool [n] validity; row r's first-seen number is
    base_row + r. Merge mode: values[a] are partial accumulators, counts[a]
    int64 partial counts and first_in int64 [n] first-seen numbers.
    """
    global launches
    n_parts, n = parts.shape
    if parts.dtype != torch.int64 or part_valid.dtype != torch.uint8 or \
            part_valid.shape != parts.shape:
        raise TypeError("hash_aggregate: parts must be int64 and part_valid "
                        "uint8 of the same shape")
    if n_parts != t.keys.shape[0] or len(values) != len(t.specs) or \
            len(counts) != len(t.specs):
        raise ValueError("hash_aggregate: inputs do not match the table")
    merge = first_in is not None
    for a, (op, is_float) in enumerate(t.specs):
        if op == SUMSQ and not is_float:
            raise TypeError("hash_aggregate: a sum of squares is float64")
        want = torch.float64 if is_float else torch.int64
        if op != COUNT and (values[a].dtype != want or values[a].shape != (n,)):
            raise TypeError(f"hash_aggregate: aggregate {a} needs {want} [n]")
        cdt = torch.int64 if merge else torch.bool
        if counts[a].dtype != cdt or counts[a].shape != (n,):
            raise TypeError(f"hash_aggregate: counts {a} must be {cdt} [n]")
    if not _build.on_cuda(parts, "hash_aggregate"):
        return insert_plain(t, parts, part_valid, row_mask, first_in,
                            base_row, values, counts, slots)
    slot_out = torch.empty(n, dtype=torch.int64, device=parts.device) \
        if slots else None
    if n == 0:
        return slot_out
    parts, part_valid = parts.contiguous(), part_valid.contiguous()
    # keep holds every contiguous copy until the launch: a copy freed
    # earlier could be handed to the next allocation before the kernel runs
    keep = [parts, part_valid]
    n_aggs = len(t.specs)
    ops = (ctypes.c_int32 * n_aggs)(*[op for op, _f in t.specs])
    floats = (ctypes.c_int32 * n_aggs)(*[int(f) for _op, f in t.specs])
    vptrs, cptrs = [], []
    for a in range(n_aggs):
        v = values[a].contiguous() if values[a] is not None else None
        c = counts[a].contiguous()
        keep += [v, c]
        vptrs.append(v.data_ptr() if v is not None else 0)
        cptrs.append(c.data_ptr())
    mask_ptr = None
    if row_mask is not None:
        row_mask = row_mask.contiguous()
        keep.append(row_mask)
        mask_ptr = row_mask.data_ptr()
    first_ptr = None
    if merge:
        first_in = first_in.contiguous()
        keep.append(first_in)
        first_ptr = first_in.data_ptr()
    lib = _build.library()
    status = lib.exon_hash_aggregate(
        n, n_parts, parts.data_ptr(), part_valid.data_ptr(), mask_ptr,
        first_ptr, base_row, int(merge), n_aggs, ops, floats,
        (ctypes.c_uint64 * n_aggs)(*vptrs), (ctypes.c_uint64 * n_aggs)(*cptrs),
        t.capacity, t.state.data_ptr(), t.keys.data_ptr(),
        t.key_valid.data_ptr(), t.first.data_ptr(), t.acc.data_ptr(),
        t.cnt.data_ptr(), t.meta.data_ptr(),
        slot_out.data_ptr() if slots else None, _build.stream_of(parts))
    _build.check(status, "hash_aggregate")
    launches += 1
    return slot_out
