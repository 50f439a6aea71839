"""map_lookup: per map row, the first entry whose key equals a literal.

Replaces the search of exon_tpu/plan/expressions.py ``_map_lookup`` (:716:
``equals_literal`` over the keys and a scatter-min of the matching entry
ids into their rows). Kernel source: ``csrc/map_lookup.cu``.

``map_lookup(map_offsets, key_offsets, key_values, key_validity, literal)``
takes the map's int32 offsets ``[n+1]`` (into its entries), the keys' int32
offsets ``[E+1]``, uint8 bytes and bool validity ``[E]``, and the literal
key (bytes, at most 1,024 of them on the card). It returns int32 ``[n]``:
the index of the row's first entry whose valid key equals the literal, or
-1. The map's own validity is not read.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

MAX_LITERAL = 1024  # the kernel's launch-parameter literal


def map_lookup_plain(map_offsets: torch.Tensor, key_offsets: torch.Tensor,
                     key_values: torch.Tensor, key_validity: torch.Tensor,
                     literal: bytes) -> torch.Tensor:
    """The plain PyTorch twin: a match flag per entry (length, then every
    byte), then a scatter-min of the matching entry ids into their rows."""
    dev = map_offsets.device
    n = map_offsets.shape[0] - 1
    moff = map_offsets.long()
    n_ent = int(moff[-1]) if n else 0
    koff = key_offsets.long()[:n_ent + 1]
    match = key_validity[:n_ent] & ((koff[1:] - koff[:-1]) == len(literal))
    if literal and n_ent:
        cand = torch.nonzero(match).flatten()
        lit = torch.tensor(list(literal), dtype=torch.uint8, device=dev)
        pos = koff[cand].unsqueeze(1) + torch.arange(len(literal), device=dev)
        match[cand] = (key_values[pos] == lit).all(dim=1)
    ent = torch.arange(n_ent, device=dev)
    row = torch.repeat_interleave(torch.arange(n, device=dev),
                                  moff[1:] - moff[:-1])
    first = torch.full((n,), n_ent, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, row, torch.where(match, ent, n_ent), "amin")
    return torch.where(first < n_ent, first, -1).to(torch.int32)


def map_lookup(map_offsets: torch.Tensor, key_offsets: torch.Tensor,
               key_values: torch.Tensor, key_validity: torch.Tensor,
               literal: bytes) -> torch.Tensor:
    global launches
    for name, t, dt in (("map_offsets", map_offsets, torch.int32),
                        ("key_offsets", key_offsets, torch.int32),
                        ("key_values", key_values, torch.uint8),
                        ("key_validity", key_validity, torch.bool)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"map_lookup: {name} must be 1-d {dt}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != map_offsets.device:
            raise ValueError("map_lookup: tensors on different devices")
    if not _build.on_cuda(map_offsets, "map_lookup"):
        return map_lookup_plain(map_offsets, key_offsets, key_values,
                                key_validity, literal)
    if len(literal) > MAX_LITERAL:
        raise ValueError(f"map_lookup: a {len(literal)}-byte key; the "
                         f"kernel takes at most {MAX_LITERAL}")
    map_offsets, key_offsets, key_values, key_validity = (
        t.contiguous() for t in (map_offsets, key_offsets, key_values,
                                 key_validity))
    n = map_offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.int32, device=map_offsets.device)
    if n == 0:
        return out
    _build.check(_build.library().exon_map_lookup(
        map_offsets.data_ptr(), key_offsets.data_ptr(), key_values.data_ptr(),
        key_validity.data_ptr(), n, bytes(literal), len(literal),
        out.data_ptr(), _build.stream_of(map_offsets)), "map_lookup")
    launches += 1
    return out
