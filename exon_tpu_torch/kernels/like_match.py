"""like_match: SQL LIKE / ILIKE per row over uint8 values + int32 offsets.

Replaces exon_tpu/ops/strings.py ``like`` (:177) and the predicates it
dispatches to. Kernel source: ``csrc/like_match.cu``.
``like_match(offsets, values, chunks, case_insensitive)`` takes the pattern
as ``tokenize_like`` chunks (tuples of byte values, -1 for '_') and returns
bool ``[n]`` without validity masking.

``like_find(offsets, values, chunk, case_insensitive)`` is the kernel's
position mode, in place of ops/strings.py ``_find_from`` (:229) as
ops/sqlfuncs.py ``fn_strpos`` (:231) uses it: int32 ``[n]``, the leftmost
start of ``chunk`` (a tuple of byte values, -1 for any byte) in each row,
relative to the row start, or -1 where the row does not hold it.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0


def encode_pattern(chunks: list[tuple], case_insensitive: bool) -> list[int]:
    """The kernel's int32 pattern layout: [c, ci, bounds[c+1], tokens]."""
    bounds = [0]
    tokens: list[int] = []
    for c in chunks:
        tokens.extend(c)
        bounds.append(len(tokens))
    return [len(chunks), int(case_insensitive)] + bounds + tokens


def _upper(x: torch.Tensor) -> torch.Tensor:
    return torch.where((x >= ord("a")) & (x <= ord("z")), x - 32, x)


def like_match_plain(offsets: torch.Tensor, values: torch.Tensor,
                     chunks: list[tuple], case_insensitive: bool
                     ) -> torch.Tensor:
    """The plain PyTorch twin: _like_general's greedy match, vectorized
    over the flat buffer as the JAX function does it."""
    dev = offsets.device
    off = offsets.to(torch.int64)
    starts, ends = off[:-1], off[1:]
    n = starts.shape[0]
    nbytes = values.shape[0]
    vals = values.to(torch.int64)
    if case_insensitive:
        vals = _upper(vals)

    def token(ch: int) -> int:
        return ch - 32 if case_insensitive and ord("a") <= ch <= ord("z") \
            else ch

    def byte_at(pos: torch.Tensor) -> torch.Tensor:
        if nbytes == 0:
            return torch.zeros_like(pos)
        return vals[pos.clamp(0, nbytes - 1)]

    def match_at(chunk, pos: torch.Tensor) -> torch.Tensor:
        ok = pos + len(chunk) <= ends
        for t, ch in enumerate(chunk):
            if ch >= 0:
                ok &= byte_at(pos + t) == token(ch)
        return ok

    rid = torch.repeat_interleave(torch.arange(n, device=dev), ends - starts)
    j = torch.arange(nbytes, device=dev)

    def find_from(chunk, frm: torch.Tensor):
        hit = j + len(chunk) <= ends[rid]
        hit &= j >= frm[rid]
        for t, ch in enumerate(chunk):
            if ch >= 0:
                hit &= byte_at(j + t) == token(ch)
        sentinel = nbytes + 1
        pos = torch.full((n,), sentinel, dtype=torch.int64, device=dev)
        pos.scatter_reduce_(0, rid, torch.where(hit, j, sentinel), "amin")
        return pos, pos < sentinel

    if len(chunks) == 1:
        c = chunks[0]
        return match_at(c, starts) & (ends - starts == len(c))
    first, *mid, last = chunks
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    p = starts
    if first:
        ok = match_at(first, p)
        p = p + len(first)
    for c in mid:
        if not c:
            continue
        pos, found = find_from(c, p)
        ok &= found
        p = torch.where(found, pos + len(c), p)
    if last:
        anchor = ends - len(last)
        ok &= anchor >= p
        ok &= match_at(last, anchor.clamp(min=0))
    return ok


def like_find_plain(offsets: torch.Tensor, values: torch.Tensor,
                    chunk: tuple, case_insensitive: bool) -> torch.Tensor:
    """The plain PyTorch twin of the position mode: _find_from's hit mask
    over the row bytes and a per-row min of the hits."""
    dev = offsets.device
    off = offsets.to(torch.int64)
    starts, ends = off[:-1], off[1:]
    n, nbytes = starts.shape[0], values.shape[0]
    if not chunk:  # an empty chunk matches at every row's start
        return torch.zeros(n, dtype=torch.int32, device=dev)
    vals = values.to(torch.int64)
    if case_insensitive:
        vals = _upper(vals)
    lens = ends - starts
    rid = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    rank = torch.arange(rid.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    hit = rank + len(chunk) <= lens[rid]
    for t, ch in enumerate(chunk):
        if ch >= 0:
            c = ch - 32 if case_insensitive and ord("a") <= ch <= ord("z") \
                else ch
            at = (starts[rid] + rank + t).clamp(max=max(nbytes - 1, 0))
            hit &= vals[at] == c
    pos = lens.clone()  # no hit: the row's length, never a start
    pos.scatter_reduce_(0, rid, torch.where(hit, rank, lens[rid]), "amin")
    return torch.where(pos < lens, pos, -1).to(torch.int32)


def _check(name: str, offsets: torch.Tensor, values: torch.Tensor) -> None:
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError(f"{name} needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    if offsets.device != values.device:
        raise ValueError(f"{name}: tensors on different devices")


def like_find(offsets: torch.Tensor, values: torch.Tensor, chunk: tuple,
              case_insensitive: bool = False) -> torch.Tensor:
    global launches
    _check("like_find", offsets, values)
    if not _build.on_cuda(offsets, "like_find"):
        return like_find_plain(offsets, values, chunk, case_insensitive)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.int32, device=offsets.device)
    if n == 0:
        return out
    pat = torch.tensor(encode_pattern([tuple(chunk)], case_insensitive),
                       dtype=torch.int32).to(offsets.device)
    _build.check(_build.library().exon_like_find(
        offsets.data_ptr(), values.data_ptr(), n, pat.data_ptr(),
        out.data_ptr(), _build.stream_of(values)), "like_find")
    launches += 1
    return out


def like_match(offsets: torch.Tensor, values: torch.Tensor,
               chunks: list[tuple], case_insensitive: bool) -> torch.Tensor:
    global launches
    _check("like_match", offsets, values)
    if not _build.on_cuda(offsets, "like_match"):
        return like_match_plain(offsets, values, chunks, case_insensitive)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.bool, device=offsets.device)
    if n == 0:
        return out
    pat = torch.tensor(encode_pattern(chunks, case_insensitive),
                       dtype=torch.int32).to(offsets.device)
    lib = _build.library()
    _build.check(lib.exon_like_match(offsets.data_ptr(), values.data_ptr(), n,
                                     pat.data_ptr(), out.data_ptr(),
                                     _build.stream_of(values)),
                 "like_match")
    launches += 1
    return out
