"""window_frame: each row's window-function result, in input order.

Replaces the per-function part of exon_tpu/plan/window_exec.py: the rank
family of ``_window_column`` (:151-186), the value picks (:220-234),
``_window_shift`` (:438-453), ``_window_aggregate`` (:263-425) with
``_bsearch`` (:243) and ``_ident`` (:428), and the scatter back to input
order (:238-240). Kernel source: ``csrc/window_frame.cu``.

``window_frame(fn, bounds, perm, ...)`` takes the four bounds of
``window_bounds`` and ``perm`` (sorted row -> input row), and as the
function needs: ``values``/``valid`` in input order (fixed-width), a
``Frame`` (None: the default frame, the partition's start to the row's
last peer, which is the whole partition without ORDER BY), ``offset`` (the
lag/lead shift, ntile's bucket count, nth_value's n) and ``default``
(lag/lead). It returns ``(values [n], validity [n])`` in input order:
int64 for the rank family but percent_rank and cume_dist (float64) and for
count; float64 for avg; the sum in int64 or float64; the value widened to
int64 or float64 otherwise; 0 where the result is NULL. The caller casts to
the result's field type.

On the card each call is one launch. The kernel reads the column in its
own width through ``perm`` (a block stages it over its tile of sorted rows
and a halo of ``LOOP_ROWS`` on each side in shared memory), counts a
COUNT(*) frame as hi - lo + 1, finds RANGE bounds by a galloping search
from the row, and loops over min/max frames of at most ``LOOP_ROWS`` rows,
so Query L's four calls (COUNT(*) over a RANGE frame, lag, MAX over ROWS
5/5, rank) run no torch op. torch builds the rest (Lib): the inclusive
prefix arrays where the function needs one (COUNT of a column: the valid
count; sum and avg: it and the sum; dense_rank: the peer starts) and, for
min/max over frames wider than ``LOOP_ROWS``, the sparse table of
``_window_aggregate`` (:342-364). The twin builds every array the JAX
arithmetic reads (the sorted widened values, the prefixes, the table), and
the kernel equals it bit for bit, float sums included. The bound on the
H100 counts what the function must move: perm, the bounds it reads, the
column in its own width and its validity, a RANGE key and its validity,
the prefixes above, and the result and its validity (chip_smoke.py's
``_frame_bytes``).

The JAX package sums a float32 column in float32 prefixes; here every
float sum is a float64 prefix (ROADMAP Queue 3, F22, as F13 for the
grouped aggregate).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional

import torch

from . import _build

launches = 0

RANK_FNS = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist",
            "ntile")
PICK_FNS = ("first_value", "last_value", "nth_value")
AGG_FNS = ("count", "sum", "avg", "min", "max")
SHIFT_FNS = ("lag", "lead")
# a min/max frame of at most this many rows is scanned, not looked up
LOOP_ROWS = 64
# modes, functions and frame kinds of csrc/window_frame.cu
_RANK, _SHIFT, _PICK, _AGGREGATE = range(4)
_MODE = {**{f: _RANK for f in RANK_FNS}, **{f: _SHIFT for f in SHIFT_FNS},
         **{f: _PICK for f in PICK_FNS}, **{f: _AGGREGATE for f in AGG_FNS}}
_FLOAT_FNS = ("percent_rank", "cume_dist", "avg")
_FN = {**{f: i for i, f in enumerate(RANK_FNS)},
       **{f: i for i, f in enumerate(PICK_FNS)},
       **{f: i for i, f in enumerate(AGG_FNS)}, "lag": 0, "lead": 0}
DEFAULT, ROWS, RANGE = 0, 1, 2
_KEY_KIND = {torch.int64: 0, torch.float64: 1, torch.float32: 2}


@dataclasses.dataclass
class Frame:
    """An explicit frame. ROWS: ``lo``/``hi`` row offsets (None =
    unbounded). RANGE: value offsets on ``key``, the sorted ORDER BY key
    (int64, float64 or float32, negated for DESC), with ``key_valid``."""

    kind: int
    lo: Optional[int]
    hi: Optional[int]
    key: Optional[torch.Tensor] = None
    key_valid: Optional[torch.Tensor] = None


# the kernel's arguments, field for field as csrc/window_frame.cu's
# WindowFrameArgs declares them: seg_start, seg_end, peer_first, peer_last,
# perm, values, valid, cnt, sum, dense, table, key, key_valid, out,
# out_valid; n, offset, lo_off, hi_off, default_word; mode, fn, frame,
# lo_unbounded, hi_unbounded, column, is_float, key_kind, levels, loop,
# has_default, stage
_ARGS = struct.Struct("<15Q5q12i")
_BOUND_NAMES = ("seg_start", "seg_end", "peer_first", "peer_last")
# the column types the kernel reads in their own width (others are widened
# by torch first)
_COLUMN_KIND = {torch.int64: 0, torch.float64: 1, torch.float32: 2,
                torch.int32: 3, torch.int16: 4, torch.int8: 5,
                torch.uint8: 6, torch.bool: 6}
# what a block stages in shared memory
_STAGE_VALUES, _STAGE_KEYS = 1, 2


@dataclasses.dataclass
class _Inputs:
    """What the kernel and the twin read, built by torch."""

    fn: str
    bounds: tuple
    perm: torch.Tensor
    values: Optional[torch.Tensor]   # sorted, int64 or float64
    valid: Optional[torch.Tensor]    # sorted
    frame: Optional[Frame]
    offset: int
    default: Optional[torch.Tensor]  # a 0-d tensor of the values' type
    cnt: Optional[torch.Tensor] = None
    sum: Optional[torch.Tensor] = None
    dense: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None


def _ident(fn: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if fn == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if fn == "min" else info.min


def _sparse_table(x: torch.Tensor, fn: str, levels: int) -> torch.Tensor:
    """[levels, n]: level k holds min or max over x[i : i + 2^k]
    (exon_tpu/plan/window_exec.py:345-355)."""
    op = torch.minimum if fn == "min" else torch.maximum
    rows, step = [x], 1
    while len(rows) < levels:
        prev = rows[-1]
        pad = torch.full((min(step, x.shape[0]),), _ident(fn, x.dtype),
                         dtype=x.dtype, device=x.device)
        rows.append(op(prev, torch.cat([prev[step:], pad])[: x.shape[0]]))
        step *= 2
    return torch.stack(rows)


def _widen(values: torch.Tensor) -> torch.Tensor:
    return values.to(torch.float64 if values.dtype.is_floating_point
                     else torch.int64)


def _check(fn: str, bounds: tuple, perm: torch.Tensor, values, valid,
           frame: Optional[Frame], offset: int) -> int:
    """Raise on arguments neither path takes; returns the row shift
    (lead's negated), ntile's bucket count (at least 1) or nth_value's n."""
    if fn not in _MODE:
        raise ValueError(f"window_frame: no mode for {fn!r}")
    if perm.dtype != torch.int64 or perm.dim() != 1:
        raise TypeError("window_frame: perm must be 1-d int64")
    shape = perm.shape
    for name, t in zip(_BOUND_NAMES, bounds):
        if t.dtype != torch.int32 or t.shape != shape:
            raise TypeError(f"window_frame: {name} must be int32 {shape}")
    if values is not None:
        if values.shape != shape or valid is None or valid.shape != shape:
            raise TypeError(f"window_frame: values and validity of "
                            f"{shape[0]} rows")
    elif fn != "count" and _MODE[fn] != _RANK:
        raise TypeError(f"window_frame: {fn} needs values")
    if frame is not None and frame.kind == RANGE:
        if frame.key is None or frame.key.dtype not in _KEY_KIND or \
                frame.key.shape != shape or frame.key_valid is None:
            raise TypeError("window_frame: a RANGE frame needs its sorted "
                            "int64, float64 or float32 key and validity")
    if fn == "ntile":
        return max(int(offset), 1)
    return -int(offset) if fn == "lead" else int(offset)


def _default_word(default, dtype: torch.dtype):
    """lag/lead's default in the values' own type first, then widened: a
    0-d int64 or float64 tensor."""
    return _widen(torch.tensor(default, dtype=dtype))


def _dense(bounds: tuple) -> torch.Tensor:
    """dense_rank's inclusive prefix count of peer-group starts."""
    n = bounds[2].shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=bounds[2].device)
    return torch.cumsum((bounds[2] == idx).to(torch.int64), 0)


def _table_levels(frame: Optional[Frame], n: int) -> tuple:
    """(width, levels): a ROWS frame's rows (None when unbounded or not
    ROWS) and the sparse-table levels that cover it."""
    width = None
    if frame is not None and frame.kind == ROWS and \
            frame.lo is not None and frame.hi is not None:
        width = max(frame.hi - frame.lo + 1, 1)
    levels = max(n, 1).bit_length() if width is None else \
        min(width, max(n, 1)).bit_length()
    return width, levels


def _prepare(fn: str, bounds: tuple, perm: torch.Tensor,
             values: Optional[torch.Tensor], valid: Optional[torch.Tensor],
             frame: Optional[Frame], offset: int, default) -> _Inputs:
    offset = _check(fn, bounds, perm, values, valid, frame, offset)
    n = perm.shape[0]
    inp = _Inputs(fn, bounds, perm, None, None, frame, offset, None)
    if values is not None:
        if default is not None:
            inp.default = _default_word(default, values.dtype)
        inp.values = _widen(values)[perm]
        inp.valid = valid[perm]
    dev = perm.device
    if fn == "dense_rank":
        inp.dense = _dense(bounds)
    if fn in AGG_FNS:
        vv = inp.valid if inp.valid is not None else \
            torch.ones(n, dtype=torch.bool, device=dev)
        inp.valid = vv
        inp.cnt = torch.cumsum(vv.to(torch.int64), 0)
        if fn in ("sum", "avg"):
            inp.sum = torch.cumsum(torch.where(vv, inp.values, 0), 0)
        if fn in ("min", "max"):
            x = torch.where(vv, inp.values, _ident(fn, inp.values.dtype))
            inp.values = x
            inp.table = _sparse_table(x, fn, _table_levels(frame, n)[1])
    return inp


def _frame_rows(inp: _Inputs, idx, s, e, pl):
    """Each row's frame [lo, hi] before clipping (the JAX arithmetic)."""
    fr = inp.frame
    if fr is None:
        return s, pl
    if fr.kind == ROWS:
        lo = s if fr.lo is None else idx + fr.lo
        hi = e if fr.hi is None else idx + fr.hi
        return lo, hi
    key, kv = fr.key, fr.key_valid
    pf_e = inp.bounds[2].long()[e]
    pl_s = inp.bounds[3].long()[s]
    nns = torch.where(kv[s], s, pl_s + 1)
    nne = torch.where(kv[e], e, pf_e - 1)
    before = idx < nns
    null_lo = torch.where(before, s, nne + 1)
    null_hi = torch.where(before, torch.minimum(nns - 1, e), e)

    def search(off, strict):
        target = key + off
        lo_, hi_ = nns.clone(), nne + 1
        n = key.shape[0]
        for _ in range(max(n, 2).bit_length() + 1):
            active = lo_ < hi_
            mid = (lo_ + hi_) // 2
            vm = key[mid.clamp(0, n - 1)]
            right = vm <= target if strict else vm < target
            lo_ = torch.where(active & right, mid + 1, lo_)
            hi_ = torch.where(active & ~right, mid, hi_)
        return lo_

    lo = s if fr.lo is None else torch.where(kv, search(fr.lo, False),
                                             null_lo)
    hi = e if fr.hi is None else torch.where(kv, search(fr.hi, True) - 1,
                                             null_hi)
    return lo, hi


def _plain(inp: _Inputs) -> tuple[torch.Tensor, torch.Tensor]:
    fn, perm = inp.fn, inp.perm
    n = perm.shape[0]
    dev = perm.device
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    s, e, pf, pl = (b.long() for b in inp.bounds)
    n_part = e - s + 1
    ok = torch.ones(n, dtype=torch.bool, device=dev)
    f64 = torch.float64
    if fn == "row_number":
        res = idx - s + 1
    elif fn == "rank":
        res = pf - s + 1
    elif fn == "dense_rank":
        res = inp.dense - inp.dense[s] + 1
    elif fn == "percent_rank":
        res = torch.where(n_part > 1, (pf - s).to(f64)
                          / (n_part - 1).clamp(min=1).to(f64),
                          torch.zeros((), dtype=f64, device=dev))
    elif fn == "cume_dist":
        res = (pl - s + 1).to(f64) / n_part.clamp(min=1).to(f64)
    elif fn == "ntile":
        k = inp.offset
        r = idx - s
        kk = n_part.clamp(max=k)
        base = n_part // kk
        rem = n_part % kk
        cut = rem * (base + 1)
        res = torch.where(r < cut, r // (base + 1).clamp(min=1),
                          rem + (r - cut) // base.clamp(min=1)) + 1
    elif fn in SHIFT_FNS:
        src = idx - inp.offset
        in_seg = (src >= s) & (src <= e)
        safe = src.clamp(0, n - 1)
        zero = torch.zeros((), dtype=inp.values.dtype, device=dev)
        res = torch.where(in_seg, inp.values[safe], zero)
        ok = torch.where(in_seg, inp.valid[safe], False)
        if inp.default is not None:
            res = torch.where(in_seg, res, inp.default.to(dev))
            ok = torch.where(in_seg, ok, True)
    else:
        lo, hi = _frame_rows(inp, idx, s, e, pl)
        lo, hi = torch.maximum(lo, s), torch.minimum(hi, e)
        empty = hi < lo
        loc, hic = lo.clamp(0, n - 1), hi.clamp(0, n - 1)
        if fn in PICK_FNS:
            if fn == "nth_value":
                raw = loc + inp.offset - 1
                pos, short = raw.clamp(0, n - 1), raw > hic
            else:
                pos = loc if fn == "first_value" else hic
                short = torch.zeros(n, dtype=torch.bool, device=dev)
            res = inp.values[pos]
            ok = ~(empty | short) & inp.valid[pos]
        else:
            def ranged(c):
                before = torch.where(lo > 0, c[(lo - 1).clamp(0, n - 1)],
                                     torch.zeros((), dtype=c.dtype,
                                                 device=dev))
                return torch.where(empty, torch.zeros((), dtype=c.dtype,
                                                      device=dev),
                                   c[hic] - before)

            run_cnt = ranged(inp.cnt)
            if fn == "count":
                res = run_cnt
            elif fn in ("sum", "avg"):
                res = ranged(inp.sum)
                if fn == "avg":
                    res = res.to(f64) / run_cnt.clamp(min=1).to(f64)
                ok = run_cnt > 0
            else:
                op = torch.minimum if fn == "min" else torch.maximum
                levels = inp.table.shape[0]
                length = (hic - loc + 1).clamp(min=1)
                k = (63 - _clz64(length)).clamp(0, levels - 1)
                a = inp.table[k, loc]
                b = inp.table[k, (hic - (1 << k) + 1).clamp(0, n - 1)]
                res = op(a, b)
                ok = ~empty & (run_cnt > 0)
    out = torch.zeros(n, dtype=res.dtype, device=dev)
    out[perm] = torch.where(ok, res, torch.zeros((), dtype=res.dtype,
                                                  device=dev))
    out_ok = torch.zeros(n, dtype=torch.bool, device=dev)
    out_ok[perm] = ok
    return out, out_ok


def _clz64(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of positive int64 values (``jax.lax.clz``)."""
    bits = torch.zeros_like(x)
    v = x.clone()
    for shift in (32, 16, 8, 4, 2, 1):
        big = v >= (1 << shift)
        bits = bits + torch.where(big, shift, 0)
        v = torch.where(big, v >> shift, v)
    return 63 - bits


def window_frame_plain(fn: str, bounds: tuple, perm: torch.Tensor,
                       values=None, valid=None, frame=None, offset: int = 1,
                       default=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin: the JAX arithmetic on the same prefix
    arrays the kernel reads."""
    return _plain(_prepare(fn, bounds, perm, values, valid, frame, offset,
                           default))


def _staged_rows(frame: Optional[Frame]) -> bool:
    """Whether every row a ROWS frame reads lies within LOOP_ROWS of the
    row, inside the halo a block stages."""
    return frame is not None and frame.kind == ROWS and \
        frame.lo is not None and frame.hi is not None and \
        abs(frame.lo) <= LOOP_ROWS and abs(frame.hi) <= LOOP_ROWS


def window_frame(fn: str, bounds: tuple, perm: torch.Tensor, values=None,
                 valid=None, frame=None, offset: int = 1, default=None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of the kernel, which reads the column in input order
    through perm; COUNT of a column, sum, avg, dense_rank and min/max past
    LOOP_ROWS first build their prefix arrays or sparse table with torch."""
    global launches
    if not _build.on_cuda(perm, "window_frame"):
        return window_frame_plain(fn, bounds, perm, values, valid, frame,
                                  offset, default)
    offset = _check(fn, bounds, perm, values, valid, frame, offset)
    n, mode = perm.shape[0], _MODE[fn]
    ranged = frame is not None and frame.kind == RANGE
    # the pointers' order of _ARGS: bounds, perm, values, valid, cnt, sum,
    # dense, table, key, key_valid
    tensors = [*bounds, perm, values, valid, None, None, None, None,
               frame.key if ranged else None,
               frame.key_valid if ranged else None]
    dev = perm.get_device()
    for t in tensors:
        if t is not None and t.get_device() != dev:
            raise ValueError("window_frame: tensors on different devices")
    column = is_float = default_word = stage = loop = levels = 0
    if values is not None:
        is_float = values.dtype.is_floating_point
        if default is not None:
            d = _default_word(default, values.dtype)
            default_word = int(d.view(torch.int64) if is_float else d)
        column = _COLUMN_KIND.get(values.dtype)
        if column is None:
            tensors[5] = _widen(values)
            column = _COLUMN_KIND[tensors[5].dtype]
    if fn == "dense_rank":
        tensors[9] = _dense(bounds)
    elif mode == _AGGREGATE and values is not None:
        if fn in ("min", "max"):
            width, levels = _table_levels(frame, n)
            loop = width is not None and width <= LOOP_ROWS
        if not loop:
            # COUNT of a column, sum, avg and the wider min/max read the
            # valid count; COUNT(*) and a looped min/max count in the kernel
            vv = valid[perm]
            tensors[7] = torch.cumsum(vv.to(torch.int64), 0)
            if fn != "count":
                x = _widen(values)[perm]
            if fn in ("sum", "avg"):
                tensors[8] = torch.cumsum(torch.where(vv, x, 0), 0)
            elif fn != "count":
                tensors[10] = _sparse_table(torch.where(
                    vv, x, _ident(fn, x.dtype)), fn, levels)
    if (mode == _SHIFT and abs(offset) <= LOOP_ROWS) or \
            ((mode == _PICK or loop) and _staged_rows(frame)):
        stage |= _STAGE_VALUES
    if ranged and (frame.lo is not None or frame.hi is not None):
        stage |= _STAGE_KEYS
    out = torch.empty(n, dtype=torch.int64, device=perm.device)
    out_ok = torch.empty(n, dtype=torch.bool, device=perm.device)
    out_dtype = torch.float64 if fn in _FLOAT_FNS or (
        is_float and mode != _RANK and fn != "count") else torch.int64
    if n == 0:
        return out.view(out_dtype), out_ok
    ptrs = []
    for k, t in enumerate(tensors):
        if t is not None and not t.is_contiguous():
            t = tensors[k] = t.contiguous()  # kept until the launch
        ptrs.append(0 if t is None else t.data_ptr())
    fr = frame
    args = _ARGS.pack(
        *ptrs, out.data_ptr(), out_ok.data_ptr(), n, offset,
        0 if fr is None or fr.lo is None else fr.lo,
        0 if fr is None or fr.hi is None else fr.hi, default_word,
        mode, _FN[fn], DEFAULT if fr is None else fr.kind,
        int(fr is not None and fr.lo is None),
        int(fr is not None and fr.hi is None), column, int(is_float),
        _KEY_KIND[fr.key.dtype] if ranged else 0,
        0 if tensors[10] is None else tensors[10].shape[0], int(loop),
        int(default is not None and values is not None), stage)
    _build.check(_build.library().exon_window_frame(
        args, _build.stream_of(perm)), "window_frame")
    launches += 1
    return out.view(out_dtype), out_ok
