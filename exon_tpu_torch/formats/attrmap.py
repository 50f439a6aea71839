"""Vectorized attribute-map parsing for GFF/GTF.

Copy of exon_tpu/formats/attrmap.py (both styles), unchanged but for a
batch whose attributes hold no key-value separator or no byte at all,
which the JAX copy cannot parse (ROADMAP Queue 3, F28).

GFF3: ``key=val1,val2;key2=val3``  →  Map<Utf8, List<Utf8>>
GTF:  ``key "val"; key2 "val2";``  →  Map<Utf8, List<Utf8>> (single values)

Reference semantics: exon-gff/src/config.rs (map schema) and noodles'
gff/gtf attribute parsers. Parsing here is flat-buffer numpy: one pass finds
separators, entries/items become slice ranges, no per-row loops.
"""

from __future__ import annotations

import numpy as np

from ..batch import ListColumn, StructColumn, VarColumn
from .textutil import cumsum_exclusive, gather_slices


def _entry_bounds(a: np.ndarray, roff: np.ndarray, sep: int
                  ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split each row region [roff[i], roff[i+1]) at ``sep`` bytes.

    Returns (entry_starts, entry_ends, entry_row) flattened, in order.
    """
    n = len(roff) - 1
    seps = np.flatnonzero(a == sep)
    starts_all = np.sort(np.concatenate([roff[:-1], seps + 1]))
    ends_all = np.sort(np.concatenate([seps, roff[1:]]))
    rows = np.searchsorted(roff[1:], starts_all, side="right")
    # clip: a separator at the very end of the buffer creates a start == end
    rows = np.clip(rows, 0, n - 1) if n else rows
    return starts_all, ends_all, rows


def _strip(a: np.ndarray, starts: np.ndarray, ends: np.ndarray,
           chars: bytes = b" ") -> tuple[np.ndarray, np.ndarray]:
    """Trim leading/trailing bytes in ``chars`` from each slice (≤2 rounds
    per side, enough for '; ' + quote patterns)."""
    if len(a) == 0:  # no byte to strip (the JAX copy indexes a[-1], F28)
        return starts, ends
    for _ in range(2):
        for c in chars:
            lead = (starts < ends) & (a[np.clip(starts, 0, len(a) - 1)] == c)
            starts = np.where(lead, starts + 1, starts)
            trail = (starts < ends) & (a[np.clip(ends - 1, 0, len(a) - 1)] == c)
            ends = np.where(trail, ends - 1, ends)
    return starts, ends


def parse_attributes(arr: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                     style: str) -> ListColumn:
    """Parse per-row attribute strings into a Map column.

    style: 'gff' (k=v1,v2; separators ';') or 'gtf' (k "v"; separators ';').
    """
    n = len(starts)
    a, roff = gather_slices(arr, starts, ends)
    es, ee, erow = _entry_bounds(a, roff, ord(";"))
    es, ee = _strip(a, es, ee, b" ")
    nonempty = es < ee
    es, ee, erow = es[nonempty], ee[nonempty], erow[nonempty]
    n_entries = len(es)

    # key/value split
    if style == "gff":
        sep_byte = ord("=")
    else:
        sep_byte = ord(" ")
    seps = np.flatnonzero(a == sep_byte)
    i = np.searchsorted(seps, es)
    # with no separator in the batch every key runs to its entry's end (the
    # JAX copy indexes the empty separator array and raises, F28)
    kend = np.where(i < len(seps), seps[np.clip(i, 0, max(len(seps) - 1, 0))],
                    ee) if len(seps) else ee.copy()
    kend = np.minimum(kend, ee)
    vstart = np.minimum(kend + 1, ee)
    if style == "gtf":
        # strip quotes around the value
        vstart, vend = _strip(a, vstart, ee.copy(), b'"')
    else:
        vend = ee

    key_vals, key_offs = gather_slices(a, es, kend)

    # per-entry value items
    if style == "gff":
        # sub-split value region at ','
        voff = np.zeros(n_entries + 1, dtype=np.int64)
        v_flat, v_roff = gather_slices(a, vstart, vend)
        is_, ie_, irow = _entry_bounds(v_flat, v_roff, ord(","))
        item_vals, item_offs = gather_slices(v_flat, is_, ie_)
        items_per_entry = np.bincount(irow, minlength=n_entries) if n_entries else np.zeros(0, np.int64)
        item_list_offsets = cumsum_exclusive(items_per_entry)
    else:
        item_vals, item_offs = gather_slices(a, vstart, vend)
        item_list_offsets = np.arange(n_entries + 1, dtype=np.int64)

    entries_per_row = np.bincount(erow, minlength=n) if n else np.zeros(0, np.int64)
    map_offsets = cumsum_exclusive(entries_per_row)

    items_col = VarColumn(item_vals, item_offs.astype(np.int32),
                          np.ones(len(item_offs) - 1, bool))
    values_col = ListColumn(items_col, item_list_offsets.astype(np.int32),
                            np.ones(n_entries, bool))
    keys_col = VarColumn(key_vals, key_offs.astype(np.int32),
                         np.ones(n_entries, bool))
    kv = StructColumn({"keys": keys_col, "values": values_col},
                      np.ones(n_entries, bool))
    validity = (ends - starts) > 0
    return ListColumn(kv, map_offsets.astype(np.int32), validity)
