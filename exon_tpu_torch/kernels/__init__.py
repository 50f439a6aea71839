"""Hand-written CUDA kernels of the port, one wrapper module each.

Every wrapper takes torch tensors. For tensors on the CPU it runs its plain
PyTorch twin, which lives in the same module; for CUDA tensors it launches
its kernel (built on first use by ``_build``) or raises. There is no
fallback from one to the other. Each wrapper module keeps ``launches``, a
plain count of the kernel launches it made; ``launch_counts()`` reads them
and ``reset_launch_counts()`` sets them to zero.
"""

from __future__ import annotations

from . import (bucket_pack, compact_mask, count_bytes, expand_segments,
               format_int, gather_spans, gather_var, hash_aggregate,
               like_match, line_index, list_bins, map_bytes, map_lookup,
               parse_number, polya_tail, row_hash, sort_keys, span_concat,
               string_cmp, string_eq, sw_score, text_records, window_bounds,
               window_frame)

KERNEL_MODULES = {
    "compact_mask": compact_mask,
    "gather_var": gather_var,
    "like_match": like_match,
    "hash_aggregate": hash_aggregate,
    "expand_segments": expand_segments,
    "row_hash": row_hash,
    "string_eq": string_eq,
    "sort_keys": sort_keys,
    "line_index": line_index,
    "text_records": text_records,
    "gather_spans": gather_spans,
    "string_cmp": string_cmp,
    "parse_number": parse_number,
    "format_int": format_int,
    "sw_score": sw_score,
    "count_bytes": count_bytes,
    "map_bytes": map_bytes,
    "polya_tail": polya_tail,
    "span_concat": span_concat,
    "window_bounds": window_bounds,
    "window_frame": window_frame,
    "map_lookup": map_lookup,
    "list_bins": list_bins,
    "bucket_pack": bucket_pack,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
