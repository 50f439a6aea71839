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

A call uploads nothing and does not synchronise: the pattern's encoding is
built once per pattern and passed in the kernel's parameters, or, past
``INLINE_WORDS``, copied once per pattern and device from pinned memory
without a sync. The wrapper picks the lanes a row from the pattern and the
shapes alone.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

launches = 0

INLINE_WORDS = 256  # kInlineWords in csrc/like_match.cu
WINDOW = 17  # kWindow: the tokens a chunk's filter covers
WORDS = 4  # kWords: 16-byte words a lane a pass


def _fold(t: int) -> int:
    return t - 32 if ord("a") <= t <= ord("z") else t


def encode_pattern(chunks: list[tuple], case_insensitive: bool) -> list[int]:
    """The kernel's int32 pattern layout: [c, ci], then a record a chunk
    (where its tokens start, their count, where its filter entries start,
    their count; starts index this list), then the tokens, then the filter
    entries. Tokens are byte values (upper-cased under ILIKE) or -1 for '_'.
    A chunk's filter entries are value | offsets << 8 for each distinct
    value of its first WINDOW tokens, offsets the bit set of the positions
    that hold it, most positions first."""
    folded = [[_fold(t) if case_insensitive and t >= 0 else t for t in c]
              for c in chunks]
    entries = []
    for c in folded:
        at: dict[int, int] = {}
        for i, t in enumerate(c[:WINDOW]):
            if t >= 0:
                at[t] = at.get(t, 0) | 1 << i
        entries.append([v | o << 8 for v, o in sorted(
            at.items(), key=lambda e: (-bin(e[1]).count("1"), e[1]))])
    tok_at = 2 + 4 * len(chunks)
    flt_at = tok_at + sum(map(len, folded))
    records: list[int] = []
    for c, e in zip(folded, entries):
        records += [tok_at, len(c), flt_at, len(e)]
        tok_at += len(c)
        flt_at += len(e)
    return [len(chunks), int(case_insensitive)] + records + \
        [t for c in folded for t in c] + [x for e in entries for x in e]


@functools.lru_cache(maxsize=1024)
def _encoded(chunks: tuple, case_insensitive: bool) -> np.ndarray:
    return np.asarray(encode_pattern(list(chunks), case_insensitive),
                      dtype=np.int32)


@functools.lru_cache(maxsize=64)
def _device_copy(chunks: tuple, case_insensitive: bool,
                 device: torch.device) -> tuple:
    """(pinned host copy, device copy, the copy's event) of a pattern too
    long to pass by value: the copy runs on the stream current at its first
    use, without a sync, and the pinned tensor stays referenced beside it."""
    host = torch.from_numpy(_encoded(chunks, case_insensitive)).pin_memory()
    dev = host.to(device, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, dev, done


def group_width(n: int, nbytes: int) -> int:
    """Lanes a row (4, 8, 16 or 32) for a search: the least whose pass,
    WORDS * G - 1 words of 16 bytes, covers a row of the mean length and
    its alignment."""
    words = nbytes // max(n, 1) // 16 + 1
    return next((g for g in (4, 8, 16) if WORDS * g - 1 >= words), 32)


def _searches(chunks: tuple) -> bool:
    """Whether the pattern has a middle chunk to search for (else each row
    is one or two anchored compares, a lane's work)."""
    return any(chunks[1:-1])


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

    if n == 0:
        return torch.zeros(0, dtype=torch.bool, device=dev)
    j = torch.arange(nbytes, device=dev)
    # each byte's row: the first whose end is past it (a byte before
    # offsets[0] or past offsets[n] fails the bounds of find_from)
    rid = torch.searchsorted(ends, j, right=True).clamp(max=n - 1)

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


def _launch(entry, name: str, offsets: torch.Tensor, values: torch.Tensor,
            chunks: tuple, case_insensitive: bool, search: bool,
            out: torch.Tensor) -> None:
    pat = _encoded(chunks, bool(case_insensitive))
    dev = None
    if pat.shape[0] > INLINE_WORDS:
        _host, copy, done = _device_copy(chunks, bool(case_insensitive),
                                         offsets.device)
        # the launch's stream waits for the copy on the device (a no-op on
        # the copy's own stream)
        torch.cuda.current_stream(offsets.device).wait_event(done)
        dev = copy.data_ptr()
    n = out.shape[0]
    group = group_width(n, values.shape[0]) if search else 1
    _build.check(entry(offsets.data_ptr(), values.data_ptr(), n,
                       pat.ctypes.data, pat.shape[0], dev, group,
                       out.data_ptr(), _build.stream_of(values)), name)


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
    _launch(_build.library().exon_like_find, "like_find", offsets, values,
            (tuple(chunk),), case_insensitive, True, out)
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
    chunks = tuple(tuple(c) for c in chunks)
    _launch(_build.library().exon_like_match, "like_match", offsets, values,
            chunks, case_insensitive, _searches(chunks), out)
    launches += 1
    return out
