"""parse_number: CAST of utf8 rows to int64 or float64 (invalid → NULL).

Replaces exon_tpu/plan/expressions.py ``_cast_utf8_to_number`` (:951) and
``_cast_utf8_to_float`` (:876, with ``_window`` :862). Kernel source:
``csrc/parse_number.cu``.

``parse_number(offsets, values, validity, floating)`` takes an ``(offsets
int32, values uint8, validity bool)`` column and returns ``(values, ok)``:
int64 values (``floating=False``) or float64 values (``floating=True``),
0 where ``ok`` is False. Float mode is the JAX arithmetic bit for bit:
the int64 mantissa of the first 18 significant digits scaled by ``POW10F``,
the JAX package's table of ``10.0 ** k`` built the same way on the host.
Int mode follows the JAX rules (an optional '-', at most 20 bytes, digits
only) except that a value outside int64 is NULL where the JAX sum clips its
power of ten or wraps (ROADMAP Queue 3, F10).

On the card a thread takes one row of a block's tile. A row that fits the
window (20 bytes for int, 64 for float) has its aligned 16-byte words
copied into shared memory and is parsed there in one pass; a longer row is
NULL and never read (the header of ``csrc/parse_number.cu``). Bound:
the bytes it must move (offsets, validity and the text in; value and ok
out), 0.0009 ms for a 131,072-row batch of SQL_gff's numerals and 0.0229
ms for all 3.4 M at 3.35 TB/s.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

launches = 0

# exon_tpu/plan/expressions.py:846,855: the same Python expressions, so the
# same doubles (10.0 ** 23 is not the double nearest 1e23 with every libm)
POW10 = np.asarray([10 ** p for p in range(19)], np.int64)
POW10F = np.asarray([10.0 ** k for k in range(309)], np.float64)
INT_WINDOW = 20
FLOAT_WINDOW = 64
_CHUNK_ROWS = 1 << 17  # rows per twin step: bounds its [rows, 64] temporaries
_INT64_MIN = -(1 << 63)

_tables: dict = {}


def _table(name: str, device) -> torch.Tensor:
    key = (name, device)
    if key not in _tables:
        arr = POW10 if name == "int" else POW10F
        _tables[key] = torch.from_numpy(arr).to(device)
    return _tables[key]


def _check(offsets, values, validity) -> None:
    dev = offsets.get_device()
    for part, t, dt in (("offsets", offsets, torch.int32),
                        ("values", values, torch.uint8),
                        ("validity", validity, torch.bool)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"parse_number: {part} must be 1-d {dt}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.get_device() != dev:
            raise ValueError("parse_number: tensors on different devices")


def _window(offsets, values, w: int):
    """[n, w] int64 bytes of each row (0 past its end), lengths, positions
    and the in-row mask (exon_tpu/plan/expressions.py ``_window`` :862)."""
    dev = offsets.device
    off = offsets.to(torch.int64)
    lens = off[1:] - off[:-1]
    pos = torch.arange(w, device=dev)[None, :]
    in_row = pos < lens[:, None]
    if values.shape[0]:
        idx = (off[:-1, None] + pos).clamp(0, values.shape[0] - 1)
        ch = torch.where(in_row, values[idx].to(torch.int64), 0)
    else:
        ch = torch.zeros(in_row.shape, dtype=torch.int64, device=dev)
    return ch, lens, pos, in_row


def _int_plain(offsets, values, validity):
    """``_cast_utf8_to_number``'s sum of digit * 10^clip(len-1-p, 0, 18),
    then NULL for a value outside int64 (F10)."""
    w = INT_WINDOW
    ch, lens, pos, in_row = _window(offsets, values, w)
    neg = (lens > 0) & (ch[:, 0] == ord("-"))
    skip = neg.to(torch.int64)
    digit = ch - ord("0")
    is_digit = (digit >= 0) & (digit <= 9)
    eff = in_row & (pos >= skip[:, None])
    power = (lens[:, None] - 1 - pos).clamp(0, 18)
    pow10 = _table("int", offsets.device)
    total = torch.where(eff & is_digit, digit * pow10[power], 0).sum(dim=1)
    out = torch.where(neg, -total, total)
    ok = validity & (lens - skip > 0) & (lens <= w) & \
        (~eff | is_digit).all(dim=1)
    # significant digits: past 19 the value is above INT64_MAX; at 19 the
    # exact sum exceeds INT64_MAX exactly when it wraps negative, and
    # -2^63 alone fits
    first_nz = torch.where(eff & is_digit & (digit > 0), pos, w).amin(dim=1)
    n_sig = torch.where(first_nz < w, lens - first_nz, 0)
    fits = (n_sig < 20) & ((total >= 0) | (neg & (total == _INT64_MIN)))
    ok = ok & fits
    return torch.where(ok, out, 0), ok


def _float_plain(offsets, values, validity):
    """``_cast_utf8_to_float`` (exon_tpu/plan/expressions.py:876-948) in
    torch, line for line."""
    w = FLOAT_WINDOW
    dev = offsets.device
    ch, lens, pos, in_row = _window(offsets, values, w)
    neg = (lens > 0) & (ch[:, 0] == ord("-"))
    plus = (lens > 0) & (ch[:, 0] == ord("+"))
    skip = (neg | plus).to(torch.int64)
    digit = ch - ord("0")
    is_digit = (digit >= 0) & (digit <= 9) & in_row
    is_dot = (ch == ord(".")) & in_row
    is_e = ((ch == ord("e")) | (ch == ord("E"))) & in_row
    e_pos = torch.where(is_e, pos, w).amin(dim=1)
    dot_pos = torch.where(is_dot, pos, w).amin(dim=1)
    mant_end = torch.minimum(e_pos, lens)
    mant_digit = is_digit & (pos >= skip[:, None]) & (pos < mant_end[:, None])
    n_mant = mant_digit.sum(dim=1)
    int_digits = (mant_digit & (pos < dot_pos[:, None])).sum(dim=1)
    frac_digits = n_mant - int_digits
    md = mant_digit.to(torch.int64)
    rank = torch.cumsum(md, dim=1) - md
    sig_start = torch.where(mant_digit & (digit > 0), rank, w).amin(dim=1)
    n_sig = (n_mant - sig_start).clamp(min=0)
    n_used = n_sig.clamp(max=18)
    srank = rank - sig_start[:, None]
    use = mant_digit & (srank >= 0) & (srank < 18)
    mpow = (n_used[:, None] - 1 - srank).clamp(0, 18)
    pow10 = _table("int", dev)
    mant_i = torch.where(use, digit * pow10[mpow], 0).sum(dim=1)
    has_e = e_pos < lens
    es_pos = e_pos + 1
    esign = torch.gather(ch, 1, es_pos.clamp(0, w - 1)[:, None])[:, 0]
    eneg = has_e & (esign == ord("-"))
    eplus = has_e & (esign == ord("+"))
    e_start = es_pos + (eneg | eplus).to(torch.int64)
    exp_digit = is_digit & (pos >= e_start[:, None])
    n_exp = exp_digit.sum(dim=1)
    epow = (lens[:, None] - 1 - pos).clamp(0, 18)
    expval = torch.where(exp_digit, digit * pow10[epow], 0).sum(dim=1)
    expval = torch.where(eneg, -expval, expval)
    dec_exp = expval - frac_digits + (n_sig - n_used)
    mag = dec_exp.abs().clamp(0, 308)
    scale = _table("float", dev)[mag]
    mant_f = mant_i.to(torch.float64)
    out = torch.where(dec_exp >= 0, mant_f * scale, mant_f / scale)
    out = torch.where(dec_exp > 308,
                      torch.where(mant_f != 0, float("inf"), 0.0), out)
    out = torch.where(neg, -out, out)
    legal = ((pos < skip[:, None]) | mant_digit
             | (is_dot & (pos == dot_pos[:, None])
                & (dot_pos[:, None] < mant_end[:, None]))
             | (is_e & (pos == e_pos[:, None]))
             | ((pos == es_pos[:, None]) & (eneg | eplus)[:, None])
             | exp_digit)
    ok = validity & (lens - skip > 0) & (lens <= w) & (n_mant >= 1)
    ok = ok & torch.where(has_e, n_exp >= 1, True)
    ok = ok & (~in_row | legal).all(dim=1)
    return torch.where(ok, out, 0.0), ok


def parse_number_plain(offsets: torch.Tensor, values: torch.Tensor,
                       validity: torch.Tensor, floating: bool
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin, in steps of ``_CHUNK_ROWS`` rows."""
    fn = _float_plain if floating else _int_plain
    n = validity.shape[0]
    outs, oks = [], []
    for lo in range(0, max(n, 1), _CHUNK_ROWS):
        hi = min(lo + _CHUNK_ROWS, n)
        o, k = fn(offsets[lo:hi + 1], values, validity[lo:hi])
        outs.append(o)
        oks.append(k)
    return torch.cat(outs), torch.cat(oks)


def parse_number(offsets: torch.Tensor, values: torch.Tensor,
                 validity: torch.Tensor, floating: bool
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check(offsets, values, validity)
    if not _build.on_cuda(offsets, "parse_number"):
        return parse_number_plain(offsets, values, validity, floating)
    if not offsets.is_contiguous():
        offsets = offsets.contiguous()
    if not values.is_contiguous():
        values = values.contiguous()
    if not validity.is_contiguous():
        validity = validity.contiguous()
    n = validity.shape[0]
    dev = offsets.device
    out = torch.empty(n, dtype=torch.float64 if floating else torch.int64,
                      device=dev)
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out, ok
    _build.check(_build.library().exon_parse_number(
        offsets.data_ptr(), values.data_ptr(), values.shape[0],
        validity.data_ptr(), n, int(floating),
        _table("float", dev).data_ptr(), out.data_ptr(), ok.data_ptr(),
        _build.stream_of(offsets)), "parse_number")
    launches += 1
    return out, ok
