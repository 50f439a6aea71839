"""format_int: CAST of int64 rows to utf8 decimal text.

Replaces exon_tpu/plan/expressions.py ``_cast_int_to_utf8`` (:989). Kernel
source: ``csrc/format_int.cu``.

``format_int(vals, validity)`` takes int64 values and their validity and
returns ``(offsets int32[n+1], values uint8)``: each valid row's sign and
digits, a NULL row empty. A length pass, ``torch.cumsum`` into the offsets
(one host read of the byte total) and a write pass fill a buffer of exactly
that total, where the JAX function fills ``20 * n`` bytes. INT64_MIN
becomes "-9223372036854775808"; the JAX function's ``abs`` overflows on it
(ROADMAP Queue 3, F10).
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

_POW10 = [10 ** p for p in range(19)]


def _check(vals, validity) -> None:
    for part, t, dt in (("values", vals, torch.int64),
                        ("validity", validity, torch.bool)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"format_int: {part} must be 1-d {dt}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if vals.device != validity.device or vals.shape != validity.shape:
        raise ValueError("format_int: values and validity differ in device "
                         "or length")


def _offsets(lens: torch.Tensor) -> tuple[torch.Tensor, int]:
    offs = torch.zeros(lens.shape[0] + 1, dtype=torch.int32,
                       device=lens.device)
    torch.cumsum(lens, 0, dtype=torch.int32, out=offs[1:])
    return offs, int(offs[-1])


def format_int_plain(vals: torch.Tensor, validity: torch.Tensor
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin: the JAX formula (digit count against the
    power table, then each output byte finds its row by searchsorted and
    divides out its digit), with truncated division on the signed value
    so that INT64_MIN needs no absolute value."""
    dev = vals.device
    pow10 = torch.tensor(_POW10, dtype=torch.int64, device=dev)
    ndig = ((vals[:, None] >= pow10[None, :])
            | (vals[:, None] <= -pow10[None, :])).sum(dim=1).clamp(min=1)
    neg = (vals < 0).to(torch.int64)
    lens = torch.where(validity, ndig + neg, 0).to(torch.int32)
    offs, total = _offsets(lens)
    k = torch.arange(total, dtype=torch.int32, device=dev)
    row = torch.searchsorted(offs[1:], k, right=True)
    pos = (k - offs[row]).to(torch.int64)
    is_sign = (pos == 0) & (neg[row] == 1)
    p = (ndig[row] - 1 - (pos - neg[row])).clamp(0, 18)
    q = torch.div(vals[row], pow10[p], rounding_mode="trunc")
    digit = torch.fmod(q, 10).abs()
    byte = torch.where(is_sign, ord("-"), ord("0") + digit)
    return offs, byte.to(torch.uint8)


def format_int(vals: torch.Tensor, validity: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    _check(vals, validity)
    if not _build.on_cuda(vals, "format_int"):
        return format_int_plain(vals, validity)
    vals, validity = vals.contiguous(), validity.contiguous()
    n = vals.shape[0]
    dev = vals.device
    if n == 0:
        return (torch.zeros(1, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.uint8, device=dev))
    lib, stream = _build.library(), _build.stream_of(vals)
    lens = torch.empty(n, dtype=torch.int32, device=dev)
    _build.check(lib.exon_format_int_lengths(vals.data_ptr(),
                                             validity.data_ptr(), n,
                                             lens.data_ptr(), stream),
                 "format_int")
    offs, total = _offsets(lens)
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    _build.check(lib.exon_format_int_write(vals.data_ptr(), validity.data_ptr(),
                                           offs.data_ptr(), n, out.data_ptr(),
                                           stream), "format_int")
    launches += 1
    return offs, out
