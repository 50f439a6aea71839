"""string_cmp: ordered compare of a var-width column with a literal.

Replaces exon_tpu/plan/expressions.py ``_var_cmp_literal`` (:780) over
``gather_prefix`` (exon_tpu/ops/layout.py:60). Kernel source:
``csrc/string_cmp.cu``.

``string_cmp(offsets, values, validity, literal, op)`` takes an ``(offsets
int32, values uint8, validity bool)`` column, the literal's bytes and one
of ``<``, ``<=``, ``>``, ``>=``, and returns bool ``[n]``: the row's bytes
compared with the literal as unsigned bytes, shorter prefix first, and
False for a NULL row. The JAX function passes a NULL row as the empty
string (ROADMAP Queue 3, F8); this is the one place the two differ.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

OPS = {"<": 0, "<=": 1, ">": 2, ">=": 3}
INLINE_BYTES = 64  # kInline in csrc/string_cmp.cu


def _check(offsets, values, validity, op) -> None:
    for part, t, dt in (("offsets", offsets, torch.int32),
                        ("values", values, torch.uint8),
                        ("validity", validity, torch.bool)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"string_cmp: {part} must be 1-d {dt}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != offsets.device:
            raise ValueError("string_cmp: tensors on different devices")
    if op not in OPS:
        raise ValueError(f"string_cmp: unknown operator {op!r}")


def string_cmp_plain(offsets: torch.Tensor, values: torch.Tensor,
                     validity: torch.Tensor, literal: bytes, op: str
                     ) -> torch.Tensor:
    """The plain PyTorch twin: the JAX formula (a [n, k] window of each
    row's first bytes, the first nonzero difference from the zero-padded
    literal, ties broken on the lengths), then the row's validity."""
    dev = offsets.device
    k = max(len(literal), 1)
    off = offsets.to(torch.int64)
    starts, lens = off[:-1], off[1:] - off[:-1]
    pos = torch.arange(k, device=dev)
    in_row = pos[None, :] < lens[:, None]
    if values.shape[0]:
        idx = (starts[:, None] + pos[None, :]).clamp(0, values.shape[0] - 1)
        pre = torch.where(in_row, values[idx].to(torch.int32), 0)
    else:
        pre = torch.zeros(in_row.shape, dtype=torch.int32, device=dev)
    pat = torch.tensor(list(literal.ljust(k, b"\0")), dtype=torch.int32,
                       device=dev)
    diff = pre - pat[None, :]
    nz = diff != 0
    first = torch.argmax(nz.to(torch.int8), dim=1)
    d = torch.gather(diff, 1, first[:, None])[:, 0]
    tie = torch.where(lens > len(literal), 1,
                      torch.where(lens < len(literal), -1, 0))
    cmp = torch.where(nz.any(dim=1), d, tie)
    pass_ = {"<": cmp < 0, "<=": cmp <= 0, ">": cmp > 0, ">=": cmp >= 0}[op]
    return pass_ & validity


def string_cmp(offsets: torch.Tensor, values: torch.Tensor,
               validity: torch.Tensor, literal: bytes, op: str
               ) -> torch.Tensor:
    global launches
    _check(offsets, values, validity, op)
    if not _build.on_cuda(offsets, "string_cmp"):
        return string_cmp_plain(offsets, values, validity, literal, op)
    offsets, values = offsets.contiguous(), values.contiguous()
    validity = validity.contiguous()
    n = validity.shape[0]
    out = torch.empty(n, dtype=torch.bool, device=offsets.device)
    if n == 0:
        return out
    # a short literal goes by value in the launch; a longer one needs a
    # device buffer, held here until the launch is queued
    buf = None if len(literal) <= INLINE_BYTES else torch.tensor(
        list(literal), dtype=torch.uint8).to(offsets.device)
    _build.check(_build.library().exon_string_cmp(
        offsets.data_ptr(), values.data_ptr(), validity.data_ptr(), n,
        literal if buf is None else buf.data_ptr(), len(literal), OPS[op],
        out.data_ptr(),
        _build.stream_of(offsets)), "string_cmp")
    launches += 1
    return out
