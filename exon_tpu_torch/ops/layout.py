"""Row selection and gather over torch columns.

Counterpart of exon_tpu/ops/layout.py: ``mask_to_indices`` (:75) runs the
compact_mask kernel, ``take_var`` (:149) the gather_var kernel (which does
the work of ``take_offsets`` :111, ``relayout_values`` :127 and
``byte_row_ids`` :27), ``take_fixed``/``take_dict`` (:91, :101) are
``index_select``, and ``take_batch``/``filter_batch`` (:204, :222) compose
them. Batches are exact, so a take returns exactly ``count`` rows.
``dict_to_var`` (:275) is a gather_var over the vocabulary. A list column
(:175-187) is taken by its rows' new offsets, each element's source index
from the expand_segments kernel (K1c) and a take of the child by the same
function; a struct column (:171) by a take of each child.
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import (Batch, Column, DictColumn, FixedColumn, ListColumn,
                     StructColumn, VarColumn)
from ..kernels.compact_mask import compact_mask
from ..kernels.expand_segments import expand_segments
from ..kernels.gather_var import gather_var


def mask_to_indices(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Stable compaction of a bool mask: (indices int32[n], count int32);
    slots past count hold n."""
    return compact_mask(mask)


def take_fixed(col: FixedColumn, indices: torch.Tensor) -> FixedColumn:
    idx = indices.long()
    return FixedColumn(col.values.index_select(0, idx),
                       col.validity.index_select(0, idx))


def take_dict(col: DictColumn, indices: torch.Tensor) -> DictColumn:
    idx = indices.long()
    return DictColumn(col.codes.index_select(0, idx),
                      col.validity.index_select(0, idx), col.vocab)


def take_var(col: VarColumn, indices: torch.Tensor) -> VarColumn:
    offsets, values = gather_var(col.offsets, col.values, indices)
    return VarColumn(values, offsets, col.validity.index_select(0,
                                                                indices.long()))


def take_list(col: ListColumn, indices: torch.Tensor) -> ListColumn:
    """Rows ``indices`` of a list column: expand_segments lays out the
    taken rows' lengths (the new offsets, one host read of their total)
    and gives each element's source index, and the child is taken at
    those indices. A total past int32 raises there."""
    idx = indices.long()
    off = col.offsets.to(torch.int32)
    starts = off[:-1].index_select(0, idx)
    lens = off[1:].index_select(0, idx) - starts
    _rows, src, new_off, _total = expand_segments(starts, lens,
                                                  col.child.capacity)
    return ListColumn(take_column(col.child, src), new_off.to(torch.int32),
                      col.validity.index_select(0, idx))


def take_column(col: Column, indices: torch.Tensor) -> Column:
    if isinstance(col, FixedColumn):
        return take_fixed(col, indices)
    if isinstance(col, DictColumn):
        return take_dict(col, indices)
    if isinstance(col, VarColumn):
        return take_var(col, indices)
    if isinstance(col, ListColumn):
        return take_list(col, indices)
    if isinstance(col, StructColumn):
        return StructColumn({k: take_column(v, indices)
                             for k, v in col.children.items()},
                            col.validity.index_select(0, indices.long()))
    raise TypeError(f"take_column: {type(col)}")


def null_where(col: Column, null_mask: torch.Tensor) -> Column:
    """The column with the rows of ``null_mask`` NULL; a struct's children
    too, since its export reads their validity (ROADMAP Queue 3, F23)."""
    import dataclasses

    if isinstance(col, StructColumn):
        return StructColumn({k: null_where(v, null_mask)
                             for k, v in col.children.items()},
                            col.validity & ~null_mask)
    return dataclasses.replace(col, validity=col.validity & ~null_mask)


def take_batch(batch: Batch, indices: torch.Tensor) -> Batch:
    """Row gather over a whole batch: exactly len(indices) rows."""
    return Batch(batch.schema, [take_column(c, indices)
                                for c in batch.columns], indices.shape[0],
                 indices.device)


def filter_batch(batch: Batch, mask: torch.Tensor) -> Batch:
    """Materialize the rows where mask is set. The FilterExec kernel path:
    one compaction, one host read of the count, one gather per column."""
    idx, count = mask_to_indices(mask)
    return take_batch(batch, idx[: int(count)])


def slice_batch(batch: Batch, start: int, stop: int) -> Batch:
    """Rows [start, stop) of a device batch (a gather, as LIMIT's
    ``_jit_limit_slice`` in exon_tpu/plan/physical.py:1504)."""
    return take_batch(batch, torch.arange(start, stop, dtype=torch.int32,
                                          device=batch.device))


def dict_to_var(col: DictColumn) -> VarColumn:
    """Decode dictionary codes into a var-width column: a gather_var over
    the vocabulary with the codes as indices; NULL rows become empty, as in
    exon_tpu/ops/layout.py ``dict_to_var`` (:275)."""
    dev = col.codes.device
    enc = [s.encode() for s in col.vocab] + [b""]  # the last row for NULLs
    offs = np.zeros(len(enc) + 1, np.int32)
    np.cumsum([len(e) for e in enc], out=offs[1:])
    flat = np.frombuffer(b"".join(enc), np.uint8).copy()
    idx = torch.where(col.validity,
                      col.codes.clamp(0, max(len(col.vocab) - 1, 0)),
                      len(col.vocab)).to(torch.int32)
    offsets, values = gather_var(torch.from_numpy(offs).to(dev),
                                 torch.from_numpy(flat).to(dev), idx)
    return VarColumn(values, offsets, col.validity)
