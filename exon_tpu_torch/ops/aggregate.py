"""Aggregation: the grouped hash aggregate and the ungrouped reductions.

Counterpart of exon_tpu/ops/aggregate.py. The grouped path replaces
``sort_group_ids`` (:80) and ``grouped_reduce_codes`` (:30) and the JAX
package's per-batch group tables with one hash table that lives across the
whole stream (the hash_aggregate kernel). ``ungrouped_reduce`` (:63) stays
plain torch: each reduction is one library call.
"""

from __future__ import annotations

import dataclasses

import torch

from ..errors import ExecutionError
from ..kernels import hash_aggregate as hk
from ..kernels.compact_mask import compact_mask

_MIN_CAPACITY = 1024


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class GroupedResult:
    """Groups in first-seen order: key parts [n_parts, g], key validity,
    per aggregate the accumulator (its own dtype) and non-null count, and
    each group's dense id where the aggregate tracks them."""

    keys: torch.Tensor
    key_valid: torch.Tensor
    acc: list
    cnt: list
    group_ids: "torch.Tensor | None" = None  # with track_groups

    @property
    def num_groups(self) -> int:
        return self.keys.shape[1]


class GroupedHashAggregate:
    """Streaming grouped aggregate over int64 key parts.

    ``specs`` holds (op, is_float) per aggregate, ops from
    kernels.hash_aggregate (COUNT, SUM, MIN, MAX, SUMSQ). The table starts
    small and doubles by rehash so that its load factor stays at or below
    one half; the host reads the group count (one small copy) only when the
    rows added since the last read could pass that bound.

    With ``track_groups`` every group also gets a dense id, in the order of
    its first row, kept per slot and carried through each rehash by the
    kernel's slot output; ``add_batch`` then returns each row's group id and
    the rows that opened new groups, so that a caller can keep one
    representative row per group.
    """

    def __init__(self, n_parts: int, specs: list, device,
                 track_groups: bool = False):
        self.specs = tuple(specs)
        self.table = hk.HashTable.empty(n_parts, self.specs, _MIN_CAPACITY,
                                        device)
        self._groups_bound = 0  # upper bound on the table's group count
        self.group_of_slot = torch.full((_MIN_CAPACITY,), -1,
                                        dtype=torch.int64, device=device) \
            if track_groups else None
        self.num_groups = 0  # ids handed out

    def add_batch(self, parts: torch.Tensor, part_valid: torch.Tensor,
                  row_mask: torch.Tensor, values: list, valids: list,
                  base_row: int):
        """Insert a batch. With ``track_groups``: (group id int64 [n], -1
        where ``row_mask`` drops the row; the rows, ascending, that opened
        new groups, whose ids follow the earlier ones in that order)."""
        n = parts.shape[1]
        self.reserve(n)
        slots = hk.insert(self.table, parts, part_valid, row_mask, None,
                          base_row, values, valids,
                          slots=self.group_of_slot is not None)
        self._groups_bound += n
        if slots is not None:
            return self._assign_groups(slots)
        return None

    def add_partials(self, parts: torch.Tensor, part_valid: torch.Tensor,
                     first: torch.Tensor, acc: list, cnt: list) -> None:
        """Merge partial groups (``rows()`` of other tables) into this one:
        counts and sums add, min/max reduce, ``first`` keeps the least."""
        n = parts.shape[1]
        self.reserve(n)
        hk.insert(self.table, parts, part_valid, None, first, 0, acc, cnt)
        self._groups_bound += n

    def rows(self) -> tuple:
        """The table's groups as partial rows, in slot order: key parts
        int64 [n_parts, g], their validity uint8, first int64 [g], and the
        accumulators and counts int64 [n_aggs, g] (float64 bits where the
        aggregate is float)."""
        self._read_meta()
        t = self.table
        slots = self._occupied()
        return (t.keys[:, slots], t.key_valid[:, slots], t.first[slots],
                t.acc[:, slots], t.cnt[:, slots])

    def _assign_groups(self, slot: torch.Tensor):
        live = slot >= 0
        at = slot.clamp(min=0)
        gid = torch.where(live, self.group_of_slot[at], -1)
        new_rows = torch.nonzero(live & (gid < 0)).flatten()
        if new_rows.numel() == 0:
            return gid, new_rows
        # the first row of each new slot opens its group
        s = slot[new_rows]
        first = torch.full_like(self.group_of_slot, slot.shape[0])
        first.scatter_reduce_(0, s, new_rows, "amin")
        opened = new_rows[first[s] == new_rows]
        self.group_of_slot[slot[opened]] = self.num_groups + torch.arange(
            opened.shape[0], device=slot.device)
        self.num_groups += opened.shape[0]
        return torch.where(live, self.group_of_slot[at], -1), opened

    def _read_meta(self) -> int:
        groups, overflow = self.table.meta.tolist()
        if overflow:
            raise ExecutionError("hash aggregate table overflowed")
        return groups

    def reserve(self, n: int) -> None:
        cap = self.table.capacity
        if 2 * (self._groups_bound + n) <= cap:
            return
        groups = self._read_meta()
        self._groups_bound = groups
        if 2 * (groups + n) <= cap:
            return
        self._rehash(_pow2_at_least(4 * (groups + n)))

    def _occupied(self) -> torch.Tensor:
        idx, count = compact_mask(self.table.state == 2)
        return idx[: int(count)].long()

    def _rehash(self, capacity: int) -> None:
        old = self.table
        slots = self._occupied()
        self.table = hk.HashTable.empty(old.keys.shape[0], self.specs,
                                        capacity, old.state.device)
        track = self.group_of_slot is not None
        if track:
            old_groups = self.group_of_slot
            self.group_of_slot = torch.full((capacity,), -1,
                                            dtype=torch.int64,
                                            device=old.state.device)
        if slots.numel() == 0:
            return
        moved = hk.insert(
            self.table, old.keys[:, slots].contiguous(),
            old.key_valid[:, slots].contiguous(), None, old.first[slots], 0,
            [old.acc_values(a)[slots] for a in range(len(self.specs))],
            [old.cnt[a][slots] for a in range(len(self.specs))], slots=track)
        if track:
            self.group_of_slot[moved] = old_groups[slots]

    def finalize(self) -> GroupedResult:
        """The groups, ordered by their first-seen global row number."""
        self._read_meta()
        t = self.table
        slots = self._occupied()
        order = torch.argsort(t.first[slots], stable=True)
        slots = slots[order]
        return GroupedResult(
            t.keys[:, slots], t.key_valid[:, slots].bool(),
            [t.acc_values(a)[slots] for a in range(len(self.specs))],
            [t.cnt[a][slots] for a in range(len(self.specs))],
            None if self.group_of_slot is None else self.group_of_slot[slots])


def _fill(dtype: torch.dtype, high: bool):
    if dtype.is_floating_point:
        return float("inf") if high else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if high else info.min


def ungrouped_reduce(values, mask: torch.Tensor, fn: str) -> torch.Tensor:
    """Masked scalar reduction (exon_tpu/ops/aggregate.py :63)."""
    if fn == "count":
        return mask.sum(dtype=torch.int64)
    if fn == "sum":
        return torch.where(mask, values, 0).sum()
    if fn in ("min", "max"):
        fill = _fill(values.dtype, fn == "min")
        v = torch.where(mask, values, fill)
        if v.numel() == 0:
            return torch.tensor(fill, dtype=values.dtype, device=values.device)
        return v.min() if fn == "min" else v.max()
    raise ValueError(fn)
