"""The SQL scalar function library: strings, math and conditionals.

Counterpart of exon_tpu/ops/sqlfuncs.py (the functions DataFusion 44 gives
the reference engine), function for function, registered name for name as
``_register_all`` (:1010-1104) does, each with its return type
(``_utf8``/``_i64``/``_f64``/``_bool``/``_same_as_first``/``_power_type``,
:990-1008, 1096-1098, callables of the non-literal arguments' Fields).

Where the JAX functions run device programs over the flat byte buffer, the
port runs kernels:
  * ``_slice_var`` (:96): the per-row span gather is gather_spans with no
    byte dropped, offsets by ``torch.cumsum``; the mirrored form
    (``reverse``) is map_bytes mirrored through the identity table;
  * ``_trim_counts`` (:178): polya_tail's leading and trailing class runs;
  * ``fn_strpos`` (:231): like_match's position mode (``_find_from``);
  * ``starts_with``/``ends_with``/``contains`` (:244-266): like_match;
  * ``_concat_cols`` (:268) for ``concat``, ``||`` and ``concat_ws``,
    ``fn_repeat`` (:366), ``_pad`` (:387) and the string ``fn_coalesce``
    (:779): span_concat;
  * ``upper``/``lower`` (:123), ``fn_translate`` (:430) and ``fn_initcap``
    (:487): map_bytes (initcap in its word-start mode); translate's
    deletions count on count_bytes and compact on compact_mask and one
    index gather.
The numeric functions, ``octet_length``/``bit_length``/``chr``/``ascii``
and the numeric conditionals are elementwise torch (Lib). The functions the
JAX package runs on the host (``replace``, ``split_part``,
``regexp_replace``, ``regexp_like``, the hashes, ``to_hex``, ``factorial``,
``uuid``, ``levenshtein``, ``find_in_set``, ``overlay``, :511-767) are
copied as host code over numpy copies of the columns. ``random`` draws from
an explicit ``torch.Generator`` on the batch's device, where the JAX
function draws from numpy's global state.

Values follow the JAX functions, NULL rows included: a function computes
the bytes of a NULL row as the JAX function does (``||`` concatenates
them, ``concat`` skips them), so a function of its result agrees too.
"""

from __future__ import annotations

import functools
import hashlib
import math
import re
import uuid as _uuid

import numpy as np
import torch

from .. import datatypes as dt
from ..batch import Batch, DictColumn, FixedColumn, VarColumn
from ..errors import PlanError
from ..kernels.compact_mask import compact_mask
from ..kernels.count_bytes import count_bytes
from ..kernels.gather_spans import gather_spans
from ..kernels.map_bytes import map_bytes
from ..kernels.polya_tail import polya_tail
from ..kernels.span_concat import Piece, span_concat
from ..plan.expressions import _eval_string_cmp, _full, register_function
from . import strings as str_ops
from .device_text import lengths_to_offsets
from .layout import dict_to_var

# ---------------------------------------------------------------------------
# argument normalization (sqlfuncs.py:34-88)
# ---------------------------------------------------------------------------


def _device(batch: Batch) -> torch.device:
    dev = batch.device if batch is not None else None
    return dev if dev is not None else torch.device("cpu")


def _cap_of(batch: Batch) -> int:
    """The batch's rows (a batch of no columns, as a scan projected to none
    yields, keeps its length)."""
    return batch.length if batch is not None else 1


def _as_var(v, fn: str, batch: Batch) -> VarColumn:
    """A string argument as a VarColumn; a literal repeats on every row of
    the batch (F16: the JAX function gives one row, which a batch of
    several cannot hold)."""
    if isinstance(v, VarColumn):
        return v
    if isinstance(v, DictColumn):
        return dict_to_var(v)
    if isinstance(v, (str, bytes)):
        b = v.encode() if isinstance(v, str) else v
        cap, dev = _cap_of(batch), _device(batch)
        values = np.tile(np.frombuffer(b, np.uint8), cap)
        return VarColumn(torch.from_numpy(values).to(dev),
                         torch.arange(cap + 1, dtype=torch.int32,
                                      device=dev) * len(b),
                         torch.ones(cap, dtype=torch.bool, device=dev))
    raise PlanError(f"{fn} expects a string argument")


def _literal_bytes(v, what: str) -> bytes:
    if not isinstance(v, (str, bytes)):
        raise PlanError(f"{what} must be a string literal")
    return v.encode() if isinstance(v, str) else v


def _vals_valid(v, batch: Batch):
    """(values, validity or None) of a fixed-width argument; a Python
    scalar literal stays a scalar."""
    if isinstance(v, FixedColumn):
        return v.values, v.validity
    return v, None


def _is_scalar(v) -> bool:
    return not isinstance(v, torch.Tensor)


def _column_of(v, batch: Batch) -> torch.Tensor:
    """A scalar literal as a column of the batch's rows, as jnp.full types
    it (bool, int64, float64); a tensor as it is."""
    return _full(_cap_of(batch), v, _device(batch)) if _is_scalar(v) else v


def _scalar_tensor(v, batch: Batch) -> torch.Tensor:
    """A scalar literal as a 0-d tensor (jnp.asarray under x64)."""
    if not _is_scalar(v):
        return v
    return _full(1, v, _device(batch))[0]


def _ret_fixed(out: torch.Tensor, valid, batch: Batch):
    """A 0-d result broadcast to the batch; a FixedColumn when there is a
    validity (sqlfuncs.py:61)."""
    if out.dim() == 0:
        out = out.expand(_cap_of(batch)).clone()
    return FixedColumn(out, valid) if valid is not None else out


def _row_int(v, batch: Batch, cap: int) -> torch.Tensor:
    """Per-row int32 from a literal or fixed column."""
    if isinstance(v, FixedColumn):
        return v.values.to(torch.int32)
    if isinstance(v, torch.Tensor):
        return v.to(torch.int32)
    return torch.full((cap,), int(v), dtype=torch.int32,
                      device=_device(batch))


def _lens(col: VarColumn) -> torch.Tensor:
    return col.offsets[1:] - col.offsets[:-1]


def _span(col: VarColumn, cap: int):
    """(starts, lengths, validity) of a column's rows as ``cap`` rows: a
    one-row literal repeats (``_broadcast_valid`` :79)."""
    starts, lens, valid = col.offsets[:-1], _lens(col), col.validity
    if col.capacity != cap:
        starts, lens, valid = (t.expand(cap).contiguous()
                               for t in (starts, lens, valid))
    return starts, lens, valid


# ---------------------------------------------------------------------------
# var-width relayout core (sqlfuncs.py:96)
# ---------------------------------------------------------------------------


def _slice_var(col: VarColumn, rel_start: torch.Tensor,
               out_lens: torch.Tensor, validity=None) -> VarColumn:
    """out_lens[r] bytes of row r from rel_start[r] (row-relative): the
    offsets by torch.cumsum, the bytes by gather_spans."""
    lens = out_lens.clamp(min=0).to(torch.int32)
    offsets = lengths_to_offsets(lens)
    starts = (col.offsets[:-1] + rel_start).to(torch.int32)
    values = gather_spans(col.values, starts, starts + lens, offsets[:-1],
                          int(offsets[-1]), drop=())
    return VarColumn(values, offsets,
                     col.validity if validity is None else validity)


@functools.lru_cache(maxsize=None)
def _identity(device: torch.device) -> torch.Tensor:
    return torch.arange(256, dtype=torch.uint8, device=device)


# ---------------------------------------------------------------------------
# string functions (sqlfuncs.py:123-506)
# ---------------------------------------------------------------------------


def fn_upper(batch: Batch, v) -> VarColumn:
    return str_ops.upper(_as_var(v, "upper", batch))


def fn_lower(batch: Batch, v) -> VarColumn:
    return str_ops.lower(_as_var(v, "lower", batch))


def fn_octet_length(batch: Batch, v) -> FixedColumn:
    col = _as_var(v, "octet_length", batch)
    return FixedColumn(_lens(col).to(torch.int64), col.validity)


def fn_bit_length(batch: Batch, v) -> FixedColumn:
    col = _as_var(v, "bit_length", batch)
    return FixedColumn(_lens(col).to(torch.int64) * 8, col.validity)


def fn_substr(batch: Batch, v, start, length=None) -> VarColumn:
    """SQL substr: 1-based; the window [start, start + length) intersected
    with the string, so a start <= 0 shortens it (sqlfuncs.py:137)."""
    col = _as_var(v, "substr", batch)
    cap = col.capacity
    n = _lens(col)
    s = _row_int(start, batch, cap)
    lo = s.clamp(min=1)
    if length is None:
        hi = n + 1
    else:
        ln = _row_int(length, batch, cap)
        hi = torch.minimum(s + ln.clamp(min=0), n + 1)
    return _slice_var(col, lo - 1, (hi - lo).clamp(min=0))


def _left_lens(col: VarColumn, k, batch: Batch) -> torch.Tensor:
    n = _lens(col)
    kk = _row_int(k, batch, col.capacity)
    return torch.where(kk >= 0, torch.minimum(kk, n), (n + kk).clamp(min=0))


def fn_left(batch: Batch, v, k) -> VarColumn:
    col = _as_var(v, "left", batch)
    lens = _left_lens(col, k, batch)
    return _slice_var(col, torch.zeros_like(lens), lens)


def fn_right(batch: Batch, v, k) -> VarColumn:
    col = _as_var(v, "right", batch)
    lens = _left_lens(col, k, batch)
    return _slice_var(col, _lens(col) - lens, lens)


def fn_reverse(batch: Batch, v) -> VarColumn:
    """Each row mirrored: map_bytes through the identity table."""
    col = _as_var(v, "reverse", batch)
    return VarColumn(map_bytes(col.offsets, col.values,
                               _identity(col.values.device), "mirror"),
                     col.offsets, col.validity)


def _trim(v, chars, mode: str, fname: str, batch: Batch) -> VarColumn:
    """(sqlfuncs.py:203) the leading and trailing trim-set runs from the
    polya_tail kernel (``_trim_counts`` :178; both ends in one launch),
    then the kept span."""
    col = _as_var(v, fname, batch)
    cb = b" " if chars is None else _literal_bytes(
        chars, f"{fname} characters")
    if mode == "r":
        keep = polya_tail(col.offsets, col.values, cb)
        return _slice_var(col, torch.zeros_like(keep), keep)
    if mode == "l":
        lead = polya_tail(col.offsets, col.values, cb, "start")
        return _slice_var(col, lead, _lens(col) - lead)
    lead, keep = polya_tail(col.offsets, col.values, cb, "both")
    return _slice_var(col, lead, (keep - lead).clamp(min=0))


def fn_trim(batch: Batch, v, chars=None) -> VarColumn:
    return _trim(v, chars, "b", "trim", batch)


def fn_ltrim(batch: Batch, v, chars=None) -> VarColumn:
    return _trim(v, chars, "l", "ltrim", batch)


def fn_rtrim(batch: Batch, v, chars=None) -> VarColumn:
    return _trim(v, chars, "r", "rtrim", batch)


def fn_strpos(batch: Batch, v, needle) -> FixedColumn:
    col = _as_var(v, "strpos", batch)
    if not isinstance(needle, (str, bytes)):
        raise PlanError("strpos needle must be a string literal")
    nb = needle.encode() if isinstance(needle, str) else needle
    if not nb:
        return FixedColumn(torch.ones(col.capacity, dtype=torch.int64,
                                      device=col.offsets.device),
                           col.validity)
    pos = str_ops.find_first(col, nb)
    return FixedColumn((pos + 1).to(torch.int64), col.validity)


def fn_starts_with(batch: Batch, v, prefix) -> torch.Tensor:
    col = _as_var(v, "starts_with", batch)
    return str_ops.starts_with(col, _literal_bytes(
        prefix, "starts_with prefix"))


def fn_ends_with(batch: Batch, v, suffix) -> torch.Tensor:
    col = _as_var(v, "ends_with", batch)
    return str_ops.ends_with(col, _literal_bytes(suffix, "ends_with suffix"))


def fn_contains(batch: Batch, v, needle) -> torch.Tensor:
    col = _as_var(v, "contains", batch)
    return str_ops.contains(col, _literal_bytes(needle, "contains needle"))


def _col_piece(i: int, c, cap: int, gate: str) -> Piece:
    """span_concat's piece of source i, a column's rows (its offsets; a
    one-row column repeats, ``_broadcast_valid`` :79) or a literal's bytes
    on every row, opened by ``gate`` on the column's validity."""
    if isinstance(c, bytes):
        return Piece(i, gate=gate)
    if c.capacity == cap:
        return Piece(i, c.offsets, valid=c.validity, gate=gate)
    starts, lens, valid = _span(c, cap)
    return Piece(i, starts, length=lens, valid=valid, gate=gate)


def _sources(cols: list) -> list:
    return [c if isinstance(c, bytes) else c.values for c in cols]


def _concat_cols(cols: list, cap: int, skip_null: bool, batch: Batch
                 ) -> VarColumn:
    """(sqlfuncs.py:268) skip_null: a NULL argument contributes nothing
    and the row is valid (DataFusion concat); else NULL propagates (||).
    A column is a VarColumn or a literal's bytes."""
    dev = _cols_device(cols, batch)
    valid = None
    if not skip_null:
        for c in cols:
            if not isinstance(c, bytes):
                _s, _n, v = _span(c, cap)
                valid = v if valid is None else valid & v
    if valid is None:  # every row valid (batches are exact: no padding rows)
        valid = torch.ones(cap, dtype=torch.bool, device=dev)
    gate = "valid" if skip_null else "always"
    offsets, values = span_concat(
        _sources(cols), [_col_piece(i, c, cap, gate)
                         for i, c in enumerate(cols)], n=cap, device=dev)
    return VarColumn(values, offsets, valid)


def _cols_device(cols: list, batch: Batch) -> torch.device:
    return next((c.values.device for c in cols if not isinstance(c, bytes)),
                _device(batch))


def _norm_concat_args(batch: Batch, args, fname: str):
    """The arguments as VarColumns, literals as their bytes, and the rows:
    the columns' (a literal repeats on every row of the batch, F16)."""
    cols = [a.encode() if isinstance(a, str) else
            a if isinstance(a, bytes) else _as_var(a, fname, batch)
            for a in args]
    caps = [c.capacity for c in cols if not isinstance(c, bytes)]
    if len(caps) < len(cols):
        caps.append(_cap_of(batch))
    return cols, max(caps)


def _empty_var(cap: int, valid: bool, batch: Batch) -> VarColumn:
    dev = _device(batch)
    return VarColumn(torch.zeros(0, dtype=torch.uint8, device=dev),
                     torch.zeros(cap + 1, dtype=torch.int32, device=dev),
                     torch.full((cap,), valid, dtype=torch.bool, device=dev))


def fn_concat(batch: Batch, *args) -> VarColumn:
    args = [a for a in args if a is not None]  # concat skips NULL literals
    if not args:
        return _empty_var(_cap_of(batch), True, batch)
    cols, cap = _norm_concat_args(batch, args, "concat")
    return _concat_cols(cols, cap, skip_null=True, batch=batch)


def fn_concat_op(batch: Batch, *args) -> VarColumn:
    """``||``: NULL-propagating concat."""
    if any(a is None for a in args):  # a NULL literal: every row NULL
        return _empty_var(_cap_of(batch), False, batch)
    cols, cap = _norm_concat_args(batch, args, "||")
    return _concat_cols(cols, cap, skip_null=False, batch=batch)


def concat_ws_pieces(sep: bytes, cols: list, cap: int):
    """span_concat's (sources, pieces) of concat_ws over non-literal-NULL
    arguments (VarColumns or a literal's bytes): each argument a piece of
    its row, empty where NULL, the separator a piece before argument i
    where it and an earlier one are non-NULL (sqlfuncs.py:349-362), by the
    gates of the validity of argument i."""
    sources, pieces = [bytes(sep)] + _sources(cols), []
    for i, c in enumerate(cols):
        arg = _col_piece(i + 1, c, cap, "valid")
        if i:
            pieces.append(Piece(0, gate="join", valid=arg.valid))
        pieces.append(arg)
    return sources, pieces


def fn_concat_ws(batch: Batch, sep, *args) -> VarColumn:
    """The separator goes between non-NULL arguments only; every row is
    valid."""
    sb = _literal_bytes(sep, "concat_ws separator")
    args = [a for a in args if a is not None]
    if not args:
        return _empty_var(_cap_of(batch), True, batch)
    cols, cap = _norm_concat_args(batch, args, "concat_ws")
    dev = _cols_device(cols, batch)
    offsets, values = span_concat(*concat_ws_pieces(sb, cols, cap), n=cap,
                                  device=dev)
    return VarColumn(values, offsets,
                     torch.ones(cap, dtype=torch.bool, device=dev))


def fn_repeat(batch: Batch, v, k) -> VarColumn:
    """Each row cycled to k times its length (a total of 2^31 bytes or more
    raises ExecutionError in span_concat)."""
    col = _as_var(v, "repeat", batch)
    if not isinstance(k, (int, float)):
        raise PlanError("repeat count must be a literal")
    offsets, values = span_concat([col.values], [
        Piece(0, col.offsets, times=max(int(k), 0))])
    return VarColumn(values, offsets, col.validity)


def pad_pieces(col: VarColumn, width: int, pad: bytes, left: bool):
    """span_concat's (sources, pieces) of lpad/rpad (sqlfuncs.py:387): the
    row cut to the width, the pad pattern cycled from its first byte to
    fill it."""
    w = max(int(width), 0)
    row, fill = Piece(0, col.offsets, cap=w), Piece(1, fill=w)
    return [col.values, bytes(pad)], [fill, row] if left else [row, fill]


def _pad(batch: Batch, v, width, pad, left: bool, fname: str) -> VarColumn:
    col = _as_var(v, fname, batch)
    pb = b" " if pad is None else _literal_bytes(pad, f"{fname} pad")
    if not isinstance(width, (int, float)):
        raise PlanError(f"{fname} width must be a literal")
    offsets, values = span_concat(*pad_pieces(col, int(width), pb or b" ",
                                              left))
    return VarColumn(values, offsets, col.validity)


def fn_lpad(batch: Batch, v, width, pad=None) -> VarColumn:
    return _pad(batch, v, width, pad, True, "lpad")


def fn_rpad(batch: Batch, v, width, pad=None) -> VarColumn:
    return _pad(batch, v, width, pad, False, "rpad")


def fn_translate(batch: Batch, v, frm, to) -> VarColumn:
    """Each byte of ``frm`` maps to the byte of ``to`` at its index; those
    past the end of ``to`` are deleted (sqlfuncs.py:430). The map is
    map_bytes; deletions count on count_bytes and compact on compact_mask
    and one index gather."""
    col = _as_var(v, "translate", batch)
    if not isinstance(frm, (str, bytes)) or not isinstance(to, (str, bytes)):
        raise PlanError("translate from/to must be string literals")
    f = frm.encode() if isinstance(frm, str) else frm
    t = to.encode() if isinstance(to, str) else to
    table = np.arange(256, dtype=np.uint8)
    delete = np.zeros(256, dtype=bool)
    for i, ch in enumerate(f):
        if i < len(t):
            table[ch] = t[i]
        else:
            delete[ch] = True
    dev = col.values.device
    mapped = map_bytes(col.offsets, col.values,
                       torch.from_numpy(table).to(dev), "table")
    if not delete.any():
        return VarColumn(mapped, col.offsets, col.validity)
    gone = np.flatnonzero(delete).tolist()
    new_lens = _lens(col) - count_bytes(col.offsets, col.values, gone)
    offsets = lengths_to_offsets(new_lens)
    pos = torch.arange(col.values.shape[0], device=dev)
    first, last = col.offsets[0], col.offsets[-1]
    keep = (pos >= first) & (pos < last) & \
        ~torch.from_numpy(delete).to(dev)[col.values.long()]
    idx, count = compact_mask(keep)
    return VarColumn(mapped[idx[: int(count)].long()], offsets,
                     col.validity)


def fn_chr(batch: Batch, v) -> VarColumn:
    cap = _cap_of(batch)
    vals, valid = _vals_valid(v, batch)
    if _is_scalar(vals):
        vals = torch.full((cap,), int(vals), dtype=torch.int32,
                          device=_device(batch))
    codes = vals.to(torch.int32).clamp(0, 255).to(torch.uint8)
    n = codes.shape[0]
    offs = torch.arange(n + 1, dtype=torch.int32, device=codes.device)
    return VarColumn(codes, offs, valid if valid is not None else
                     torch.ones(n, dtype=torch.bool, device=codes.device))


def fn_ascii(batch: Batch, v) -> FixedColumn:
    col = _as_var(v, "ascii", batch)
    n = _lens(col)
    if col.values.shape[0] == 0:
        first = torch.zeros_like(n, dtype=torch.int64)
    else:
        at = col.offsets[:-1].long().clamp(0, col.values.shape[0] - 1)
        first = col.values[at].to(torch.int64)
    return FixedColumn(torch.where(n > 0, first, 0), col.validity)


# initcap's table: lower case elsewhere, upper case at a word start
_INITCAP = str_ops.LOWER.tobytes() + str_ops.UPPER.tobytes()


def fn_initcap(batch: Batch, v) -> VarColumn:
    """Upper case at a word start (the row's first byte, or one after a
    byte that is not ASCII alphanumeric), lower case elsewhere: map_bytes
    in its word-start mode."""
    col = _as_var(v, "initcap", batch)
    dev = col.values.device
    out = map_bytes(col.offsets, col.values,
                    str_ops.byte_table(_INITCAP, dev), "word_start")
    return VarColumn(out, col.offsets, col.validity)


# -- host (irregular) string functions (sqlfuncs.py:511-767) ----------------


def _host_strings(col: VarColumn) -> tuple[list, np.ndarray]:
    vals = col.values.cpu().numpy().tobytes()
    offs = col.offsets.cpu().numpy().tolist()
    valid = col.validity.cpu().numpy()
    out = [vals[offs[i]:offs[i + 1]] if valid[i] else None
           for i in range(col.capacity)]
    return out, valid


def _host_var_from(strs: list, valid: np.ndarray, device) -> VarColumn:
    lens = np.asarray([len(s) if s is not None else 0 for s in strs],
                      np.int64)
    offs = np.zeros(len(strs) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    flat = b"".join(s for s in strs if s is not None)
    values = np.frombuffer(flat, np.uint8).copy() if flat else \
        np.zeros(0, np.uint8)
    return VarColumn(torch.from_numpy(values).to(device),
                     torch.from_numpy(offs.astype(np.int32)).to(device),
                     torch.from_numpy(np.asarray(valid, np.bool_)).to(device))


def _host_values(v, batch: Batch) -> tuple[np.ndarray, np.ndarray]:
    """A numeric argument's values on the host, one per row (a literal
    repeated), and its validity (None for a literal)."""
    vals, valid = _vals_valid(v, batch)
    cap = _cap_of(batch)
    arr = np.asarray(vals.cpu().numpy() if isinstance(vals, torch.Tensor)
                     else vals).reshape(-1)
    if arr.shape[0] == 1 and cap > 1:
        arr = np.repeat(arr, cap)
    return arr, (None if valid is None else valid.cpu().numpy())


def fn_replace(batch: Batch, v, frm, to) -> VarColumn:
    """replace(str, from, to) on the host (greedy non-overlapping)."""
    col = _as_var(v, "replace", batch)
    if not isinstance(frm, (str, bytes)) or not isinstance(to, (str, bytes)):
        raise PlanError("replace from/to must be string literals")
    f = frm.encode() if isinstance(frm, str) else frm
    t = to.encode() if isinstance(to, str) else to
    strs, valid = _host_strings(col)
    out = [s.replace(f, t) if (s is not None and f) else s for s in strs]
    return _host_var_from(out, valid, col.values.device)


def fn_split_part(batch: Batch, v, delim, idx) -> VarColumn:
    col = _as_var(v, "split_part", batch)
    if not isinstance(delim, (str, bytes)):
        raise PlanError("split_part delimiter must be a string literal")
    d = delim.encode() if isinstance(delim, str) else delim
    k = int(idx)
    strs, valid = _host_strings(col)
    out = []
    for s in strs:
        if s is None or not d:
            out.append(s)
            continue
        parts = s.split(d)
        if k > 0:
            out.append(parts[k - 1] if k <= len(parts) else b"")
        elif k < 0:
            out.append(parts[k] if -k <= len(parts) else b"")
        else:
            out.append(b"")
    return _host_var_from(out, valid, col.values.device)


def fn_regexp_replace(batch: Batch, v, pattern, replacement, flags=None
                      ) -> VarColumn:
    col = _as_var(v, "regexp_replace", batch)
    if not isinstance(pattern, (str, bytes)):
        raise PlanError("regexp_replace pattern must be a string literal")
    pat = pattern if isinstance(pattern, str) else pattern.decode()
    rep = replacement if isinstance(replacement, str) \
        else replacement.decode()
    rep = re.sub(r"\\(\d)", r"\\g<\1>", rep)
    fl = 0
    count = 1
    if flags:
        ff = flags if isinstance(flags, str) else flags.decode()
        if "i" in ff:
            fl |= re.IGNORECASE
        if "g" in ff:
            count = 0
    rx = re.compile(pat.encode(), fl)
    strs, valid = _host_strings(col)
    out = [rx.sub(rep.encode(), s, count=count) if s is not None else None
           for s in strs]
    return _host_var_from(out, valid, col.values.device)


def _fn_hash(algo: str):
    def fn(batch: Batch, v):
        col = _as_var(v, algo, batch)
        strs, valid = _host_strings(col)
        out = [getattr(hashlib, algo)(s).hexdigest().encode()
               if s is not None else None for s in strs]
        return _host_var_from(out, valid, col.values.device)
    return fn


def fn_to_hex(batch: Batch, v):
    arr, valid = _host_values(v, batch)
    out = [format(int(x), "x").encode() for x in arr.astype(np.int64)]
    return _host_var_from(out, valid if valid is not None
                          else np.ones(len(out), bool), _device(batch))


def fn_factorial(batch: Batch, v):
    arr, valid = _host_values(v, batch)
    arr = arr.astype(np.int64)
    if (arr > 20).any() or (arr < 0).any():
        raise PlanError("factorial argument must be in [0, 20] "
                        "(int64 range)")
    out = np.array([math.factorial(int(x)) for x in arr], np.int64)
    dev = _device(batch)
    return FixedColumn(torch.from_numpy(out).to(dev),
                       torch.from_numpy(valid if valid is not None else
                                        np.ones(len(out), bool)).to(dev))


def _gcd_lcm(op):
    def fn(batch: Batch, a, b):
        av, avd = _vals_valid(a, batch)
        bv, bvd = _vals_valid(b, batch)
        out = op(_scalar_tensor(av, batch).to(torch.int64),
                 _scalar_tensor(bv, batch).to(torch.int64))
        valid = torch.ones(out.shape, dtype=torch.bool, device=out.device) \
            if out.dim() else None
        for v in (avd, bvd):
            if v is not None:
                valid = v if valid is None else valid & v
        return _ret_fixed(out, valid, batch)
    return fn


_GENERATORS: dict = {}


def fn_random(batch: Batch):
    """Uniform float64 in [0, 1), from one torch.Generator per device
    (seeded from the OS at its first use)."""
    dev = _device(batch)
    gen = _GENERATORS.get(dev)
    if gen is None:
        gen = _GENERATORS[dev] = torch.Generator(device=dev)
        gen.seed()
    return torch.rand(_cap_of(batch), generator=gen, dtype=torch.float64,
                      device=dev)


def fn_uuid(batch: Batch):
    out = [str(_uuid.uuid4()).encode() for _ in range(_cap_of(batch))]
    return _host_var_from(out, np.ones(len(out), bool), _device(batch))


def _host_str_arg(x, batch: Batch, cap: int):
    """Per-row Python byte strings for a string column or literal."""
    if isinstance(x, (str, bytes)):
        b = x.encode() if isinstance(x, str) else bytes(x)
        return [b] * cap, np.ones(cap, bool)
    return _host_strings(_as_var(x, "string argument", batch))


def _levenshtein(x: bytes, y: bytes) -> int:
    if len(x) < len(y):
        x, y = y, x
    prev = list(range(len(y) + 1))
    for i, cx in enumerate(x):
        cur = [i + 1]
        for j, cy in enumerate(y):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (cx != cy)))
        prev = cur
    return prev[-1]


def _host_pairs(batch: Batch, a, b, f) -> FixedColumn:
    cap = _cap_of(batch)
    sa, va = _host_str_arg(a, batch, cap)
    sb, vb = _host_str_arg(b, batch, cap)
    out = np.zeros(cap, np.int64)
    valid = np.asarray(va) & np.asarray(vb)
    for i in range(cap):
        if valid[i] and sa[i] is not None and sb[i] is not None:
            out[i] = f(sa[i], sb[i])
        else:
            valid[i] = False
    dev = _device(batch)
    return FixedColumn(torch.from_numpy(out).to(dev),
                       torch.from_numpy(valid).to(dev))


def fn_levenshtein(batch: Batch, a, b) -> FixedColumn:
    return _host_pairs(batch, a, b, _levenshtein)


def _find_in_set(s: bytes, lst: bytes) -> int:
    parts = lst.split(b",")
    return parts.index(s) + 1 if s in parts else 0


def fn_find_in_set(batch: Batch, v, lst) -> FixedColumn:
    return _host_pairs(batch, v, lst, _find_in_set)


def fn_overlay(batch: Batch, s, rep, start, length=None) -> VarColumn:
    """overlay(s PLACING rep FROM start [FOR length])."""
    col = _as_var(s, "overlay", batch)
    strs, valid = _host_strings(col)
    rb = _literal_bytes(rep, "overlay replacement")
    p = int(start)
    n = len(rb) if length is None else int(length)
    out = [x[:p - 1] + rb + x[p - 1 + n:] if x is not None else None
           for x in strs]
    return _host_var_from(out, valid, col.values.device)


def fn_regexp_like(batch: Batch, v, pattern, flags=None) -> torch.Tensor:
    """True where the regex matches anywhere in the string."""
    col = _as_var(v, "regexp_like", batch)
    if not isinstance(pattern, (str, bytes)):
        raise PlanError("regexp_like pattern must be a string literal")
    pat = pattern if isinstance(pattern, str) else pattern.decode()
    fl = 0
    if flags:
        ff = flags if isinstance(flags, str) else flags.decode()
        if "i" in ff:
            fl |= re.IGNORECASE
        if "s" in ff:
            fl |= re.DOTALL
        if "m" in ff:
            fl |= re.MULTILINE
    rx = re.compile(pat.encode(), fl)
    strs, _valid = _host_strings(col)
    mask = np.array([s is not None and rx.search(s) is not None
                     for s in strs], bool)
    return torch.from_numpy(mask).to(col.values.device)


# ---------------------------------------------------------------------------
# conditional functions (sqlfuncs.py:775-860)
# ---------------------------------------------------------------------------


def _is_stringish(v) -> bool:
    return isinstance(v, (VarColumn, DictColumn, str, bytes))


def fn_coalesce(batch: Batch, *args):
    args = [a for a in args if a is not None]  # NULL literals drop out
    if not args:
        raise PlanError("coalesce needs at least one non-NULL argument")
    if any(_is_stringish(a) for a in args):
        # per row the bytes of the first valid argument: span_concat with
        # one piece an argument, of length 0 where it is not the chosen one
        cols, cap = _norm_concat_args(batch, args, "coalesce")
        dev = _cols_device(cols, batch)
        pieces = [_col_piece(i, c, cap, "first") for i, c in enumerate(cols)]
        valid = None
        for p in pieces:
            if p.valid is None:  # a literal: every row has a value
                valid = torch.ones(cap, dtype=torch.bool, device=dev)
                break
            valid = p.valid if valid is None else valid | p.valid
        offsets, values = span_concat(_sources(cols), pieces, n=cap,
                                      device=dev)
        return VarColumn(values, offsets, valid)
    cap = _cap_of(batch)
    vals = valid = None
    for a in args:
        av, avalid = _vals_valid(a, batch)
        av = _column_of(av, batch)
        if avalid is None:
            avalid = torch.ones(av.shape[0], dtype=torch.bool,
                                device=av.device)
        if vals is None:
            vals, valid = av, avalid
        else:
            take = ~valid & avalid
            vals = torch.where(take, av.to(vals.dtype), vals)
            valid = valid | avalid
    return FixedColumn(vals, valid)


def _fn_extremum(name: str, pick):
    def fn(batch: Batch, *args):
        args = [a for a in args if a is not None]
        if not args:
            raise PlanError(f"{name} needs at least one argument")
        vals = valid = None
        for a in args:
            av, avalid = _vals_valid(a, batch)
            av = _column_of(av, batch)
            if avalid is None:
                avalid = torch.ones(av.shape[0], dtype=torch.bool,
                                    device=av.device)
            if vals is None:
                vals, valid = av, avalid
            else:
                common = torch.promote_types(vals.dtype, av.dtype)
                av, vals = av.to(common), vals.to(common)
                # SQL GREATEST/LEAST ignore NULL arguments
                both = valid & avalid
                vals = torch.where(both, pick(vals, av),
                                   torch.where(avalid, av, vals))
                valid = valid | avalid
        return FixedColumn(vals, valid)

    return fn


def fn_nullif(batch: Batch, a, b):
    if _is_stringish(a) or _is_stringish(b):
        eq = _eval_string_cmp("=", a, b)
        col = _as_var(a, "nullif", batch)
        return VarColumn(col.values, col.offsets, col.validity & ~eq)
    av, avalid = _vals_valid(a, batch)
    bv, _ = _vals_valid(b, batch)
    av = _column_of(av, batch)
    if avalid is None:
        avalid = torch.ones(av.shape[0], dtype=torch.bool, device=av.device)
    return FixedColumn(av, avalid & ~(av == bv))


# ---------------------------------------------------------------------------
# math functions (sqlfuncs.py:868-981)
# ---------------------------------------------------------------------------


def _unary_math(name: str, f, integer_ok: bool = False):
    def fn(batch: Batch, v):
        vals, valid = _vals_valid(v, batch)
        vals = _column_of(vals, batch)
        if not integer_ok and not vals.dtype.is_floating_point:
            vals = vals.to(torch.float64)
        return _ret_fixed(f(vals), valid, batch)

    fn.__name__ = f"fn_{name}"
    return fn


def _sign(x: torch.Tensor) -> torch.Tensor:
    """jnp.sign: NaN stays NaN and -0.0 stays -0.0."""
    return torch.where((x == 0) | (x != x), x, torch.sign(x))


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return _sign(x) * x.abs().pow(1.0 / 3.0)


def fn_abs(batch: Batch, v):
    vals, valid = _vals_valid(v, batch)
    return _ret_fixed(_scalar_tensor(vals, batch).abs(), valid, batch)


def _round_half_away(x: torch.Tensor, d: int) -> torch.Tensor:
    """Half away from zero at d decimals. The division by 10^d is a
    multiplication by its reciprocal, as XLA compiles a division by a
    constant in the JAX function, so the results agree bit for bit."""
    p = 10.0 ** d
    scaled = x.to(torch.float64) * p
    return _sign(scaled) * torch.floor(scaled.abs() + 0.5) * (1.0 / p)


def _decimals(d) -> int:
    return int(d) if isinstance(d, (int, float)) else 0


def fn_round(batch: Batch, v, d=0):
    vals, valid = _vals_valid(v, batch)
    if _is_scalar(vals):
        vals = torch.full((_cap_of(batch),), vals, dtype=torch.float64,
                          device=_device(batch))
    out = _round_half_away(vals, _decimals(d))
    if not vals.dtype.is_floating_point:
        out = out.to(vals.dtype)
    return _ret_fixed(out, valid, batch)


def fn_trunc(batch: Batch, v, d=0):
    vals, valid = _vals_valid(v, batch)
    if _is_scalar(vals):
        vals = torch.full((_cap_of(batch),), vals, dtype=torch.float64,
                          device=_device(batch))
    p = 10.0 ** _decimals(d)
    out = torch.trunc(vals.to(torch.float64) * p) * (1.0 / p)
    if not vals.dtype.is_floating_point:
        out = out.to(vals.dtype)
    return _ret_fixed(out, valid, batch)


def _is_floating(v) -> bool:
    if isinstance(v, float):
        return True
    if isinstance(v, (int, bool)):
        return False
    return v.dtype.is_floating_point


def _both_valid(avalid, bvalid):
    if avalid is None:
        return bvalid
    return avalid if bvalid is None else avalid & bvalid


def _f64(v, batch: Batch) -> torch.Tensor:
    return _scalar_tensor(v, batch).to(torch.float64)


def fn_power(batch: Batch, a, b):
    av, avalid = _vals_valid(a, batch)
    bv, bvalid = _vals_valid(b, batch)
    out = torch.pow(_f64(av, batch), _f64(bv, batch))
    if not _is_floating(av) and not _is_floating(bv):
        out = torch.round(out).to(torch.int64)  # power(int, int) → Int64
    return _ret_fixed(out, _both_valid(avalid, bvalid), batch)


def fn_atan2(batch: Batch, a, b):
    av, avalid = _vals_valid(a, batch)
    bv, bvalid = _vals_valid(b, batch)
    out = torch.atan2(_f64(av, batch), _f64(bv, batch))
    return _ret_fixed(out, _both_valid(avalid, bvalid), batch)


def fn_mod(batch: Batch, a, b):
    av, avalid = _vals_valid(a, batch)
    bv, bvalid = _vals_valid(b, batch)
    b_arr = _scalar_tensor(bv, batch)
    safe = torch.where(b_arr == 0, torch.ones((), dtype=b_arr.dtype,
                                              device=b_arr.device), b_arr)
    out = torch.remainder(_scalar_tensor(av, batch), safe)
    valid = _both_valid(avalid, bvalid)
    if b_arr.dim():
        zmask = b_arr != 0
        valid = zmask if valid is None else valid & zmask
    return _ret_fixed(out, valid, batch)


def fn_log(batch: Batch, a, b=None):
    """log(x) = log10(x); log(base, x) with two arguments."""
    if b is None:
        vals, valid = _vals_valid(a, batch)
        return _ret_fixed(torch.log10(_f64(vals, batch)), valid, batch)
    bval, bvalid = _vals_valid(a, batch)
    xval, xvalid = _vals_valid(b, batch)
    out = torch.log(_f64(xval, batch)) / torch.log(_f64(bval, batch))
    return _ret_fixed(out, _both_valid(bvalid, xvalid), batch)


def fn_pi(batch: Batch):
    return float(np.pi)


# ---------------------------------------------------------------------------
# registration (sqlfuncs.py:990-1104)
# ---------------------------------------------------------------------------


def _utf8(args):
    return dt.utf8


def _i64(args):
    return dt.int64


def _f64_type(args):
    return dt.float64


def _bool(args):
    return dt.bool_


def _same_as_first(args):
    return args[0].dtype if args else dt.float64


def _power_type(args):
    flo = any("float" in str(a.dtype) for a in args[:2])
    return dt.float64 if flo else dt.int64


_UNARY = [("sqrt", torch.sqrt), ("exp", torch.exp), ("ln", torch.log),
          ("log2", torch.log2), ("log10", torch.log10), ("sin", torch.sin),
          ("cos", torch.cos), ("tan", torch.tan), ("asin", torch.asin),
          ("acos", torch.acos), ("atan", torch.atan), ("sinh", torch.sinh),
          ("cosh", torch.cosh), ("tanh", torch.tanh),
          ("degrees", lambda x: x * (180.0 / math.pi)),
          ("radians", lambda x: x * (math.pi / 180.0)),
          ("cbrt", _cbrt), ("isnan", torch.isnan), ("asinh", torch.asinh),
          ("acosh", torch.acosh), ("atanh", torch.atanh)]


def _register_all() -> None:
    reg = register_function
    for name, fn, typ in [
            ("upper", fn_upper, _utf8), ("lower", fn_lower, _utf8),
            ("octet_length", fn_octet_length, _i64),
            ("bit_length", fn_bit_length, _i64),
            ("md5", _fn_hash("md5"), _utf8),
            ("sha256", _fn_hash("sha256"), _utf8),
            ("sha512", _fn_hash("sha512"), _utf8),
            ("to_hex", fn_to_hex, _utf8), ("factorial", fn_factorial, _i64),
            ("gcd", _gcd_lcm(torch.gcd), _i64),
            ("lcm", _gcd_lcm(torch.lcm), _i64),
            ("random", fn_random, _f64_type), ("uuid", fn_uuid, _utf8),
            ("levenshtein", fn_levenshtein, _i64),
            ("find_in_set", fn_find_in_set, _i64),
            ("overlay", fn_overlay, _utf8),
            ("substr", fn_substr, _utf8), ("substring", fn_substr, _utf8),
            ("left", fn_left, _utf8), ("right", fn_right, _utf8),
            ("reverse", fn_reverse, _utf8),
            ("trim", fn_trim, _utf8), ("btrim", fn_trim, _utf8),
            ("ltrim", fn_ltrim, _utf8), ("rtrim", fn_rtrim, _utf8),
            ("strpos", fn_strpos, _i64), ("instr", fn_strpos, _i64),
            ("position", fn_strpos, _i64),
            ("starts_with", fn_starts_with, _bool),
            ("ends_with", fn_ends_with, _bool),
            ("contains", fn_contains, _bool),
            ("concat", fn_concat, _utf8), ("concat_op", fn_concat_op, _utf8),
            ("concat_ws", fn_concat_ws, _utf8),
            ("repeat", fn_repeat, _utf8),
            ("lpad", fn_lpad, _utf8), ("rpad", fn_rpad, _utf8),
            ("translate", fn_translate, _utf8),
            ("chr", fn_chr, _utf8), ("ascii", fn_ascii, _i64),
            ("initcap", fn_initcap, _utf8),
            ("replace", fn_replace, _utf8),
            ("split_part", fn_split_part, _utf8),
            ("regexp_like", fn_regexp_like, _bool),
            ("regexp_replace", fn_regexp_replace, _utf8),
            # conditionals
            ("coalesce", fn_coalesce, _same_as_first),
            ("nullif", fn_nullif, _same_as_first),
            ("ifnull", fn_coalesce, _same_as_first),
            ("nvl", fn_coalesce, _same_as_first),
            ("greatest", _fn_extremum("greatest", torch.maximum),
             _same_as_first),
            ("least", _fn_extremum("least", torch.minimum), _same_as_first),
            # math
            ("abs", fn_abs, _same_as_first),
            ("round", fn_round, _same_as_first),
            ("trunc", fn_trunc, _same_as_first)]:
        reg(name, fn, typ)
    for nm, f in [("ceil", torch.ceil), ("ceiling", torch.ceil),
                  ("floor", torch.floor)]:
        reg(nm, _unary_math(nm, f), _f64_type)
    for nm, f in _UNARY:
        reg(nm, _unary_math(nm, f), _bool if nm == "isnan" else _f64_type)
    reg("signum", _unary_math("signum", _sign, integer_ok=True),
        _same_as_first)
    reg("sign", _unary_math("sign", _sign, integer_ok=True), _same_as_first)
    reg("power", fn_power, _power_type)
    reg("pow", fn_power, _power_type)
    reg("atan2", fn_atan2, _f64_type)
    reg("mod", fn_mod, _same_as_first)
    reg("log", fn_log, _f64_type)
    reg("pi", fn_pi, _f64_type)


_register_all()
