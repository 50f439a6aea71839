"""format_int: CAST of int64 rows to utf8 decimal text.

Replaces exon_tpu/plan/expressions.py ``_cast_int_to_utf8`` (:989). Kernel
source: ``csrc/format_int.cu``.

``format_int(vals, validity)`` takes int64 values and their validity and
returns ``(offsets int32[n+1], values uint8)``: each valid row's sign and
digits, a NULL row empty. The values hold exactly ``offsets[n]`` bytes,
where the JAX function fills ``20 * n``: ``plan/physical.py``
``_cat_columns`` rebases offsets by each part's last offset but concatenates
whole value buffers, so a longer buffer would shift the rows after it.
INT64_MIN becomes "-9223372036854775808"; the JAX function's ``abs``
overflows on it (ROADMAP Queue 3, F10).

On the card a call is two launches around one host read: a single pass
writes the offsets (each row's length by compares with the powers of ten,
scanned with a look-back in the status words of ``_lookback``), the total
``offsets[n]`` is read, and a write pass fills a buffer of exactly that
size.
"""

from __future__ import annotations

import torch

from . import _build, _lookback

launches = 0

_POW10 = [10 ** p for p in range(19)]
_TILE = 256 * 4  # kTile in csrc/format_int.cu
# the longest text is 20 bytes ("-9223372036854775808"): at most this many
# rows keep every offset inside int32
MAX_ROWS = ((1 << 31) - 1) // 20


def _check(vals, validity) -> None:
    for part, t, dt in (("values", vals, torch.int64),
                        ("validity", validity, torch.bool)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"format_int: {part} must be 1-d {dt}, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if vals.device != validity.device or vals.shape != validity.shape:
        raise ValueError("format_int: values and validity differ in device "
                         "or length")
    if vals.shape[0] > MAX_ROWS:
        raise ValueError(f"format_int: {vals.shape[0]} rows may exceed int32 "
                         "offsets")


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
    offs = torch.zeros(lens.shape[0] + 1, dtype=torch.int32, device=dev)
    torch.cumsum(lens, 0, dtype=torch.int32, out=offs[1:])
    total = int(offs[-1])
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
    offs = torch.empty(n + 1, dtype=torch.int32, device=dev)
    tiles = (n + _TILE - 1) // _TILE

    def offsets_pass(status, ticket, base, epoch):
        _build.check(lib.exon_format_int_offsets(
            vals.data_ptr(), validity.data_ptr(), n, status, ticket, base,
            epoch, offs.data_ptr(), stream), "format_int")

    _lookback.scan(dev, stream, tiles, tiles, offsets_pass)
    launches += 1
    total = int(offs[-1])  # the one host read: the text's exact size
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        _build.check(lib.exon_format_int_write(
            vals.data_ptr(), offs.data_ptr(), n, out.data_ptr(), stream),
            "format_int")
    return offs, out
