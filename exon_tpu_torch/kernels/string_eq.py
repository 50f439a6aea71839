"""string_eq: full byte equality of row pairs of two var-width columns.

Replaces exon_tpu/plan/expressions.py ``_string_col_eq`` (:763) together
with the two ``take_var`` calls that feed it in exon_tpu/plan/join_exec.py
``_jit_emit`` (:264-277). Kernel source: ``csrc/string_eq.cu``.

``string_eq(a, ia, b, ib)`` takes two ``(offsets int32, values uint8,
validity bool)`` columns and int32 row indices ``ia``/``ib`` of equal
length m, and returns bool ``[m]``: pair p is True when rows ``a[ia[p]]``
and ``b[ib[p]]`` are both valid, equally long and equal in every byte. Unlike
the JAX function it compares whole rows, not a 32-byte prefix and the
length, and it reads both columns in place instead of gathering them first.

On the card a thread takes a pair: it reads the two rows' offsets and
validity, and only for a pair of equal length and no NULL the text, both
rows as 16-byte words (the header of ``csrc/string_eq.cu``), 64 bytes a row
a step, every load of a step issued before any compare. Bound: the bytes it
must move (indices, offset pairs and validity, the bytes compared, a bool
out), 0.0037 ms for Query D's 131,072 name pairs at 3.35 TB/s.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0


def _check(name: str, offsets, values, validity, idx, device: int) -> None:
    for part, t, dt in (("offsets", offsets, torch.int32),
                        ("values", values, torch.uint8),
                        ("validity", validity, torch.bool),
                        ("indices", idx, torch.int32)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"string_eq: {name} {part} must be 1-d {dt}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.get_device() != device:
            raise ValueError("string_eq: tensors on different devices")


def string_eq_plain(a: tuple, ia: torch.Tensor, b: tuple, ib: torch.Tensor
                    ) -> torch.Tensor:
    """The plain PyTorch twin."""
    (ao, av, avalid), (bo, bv, bvalid) = a, b
    ia, ib = ia.long(), ib.long()
    sa, sb = ao[:-1].long()[ia], bo[:-1].long()[ib]
    la, lb = ao[1:].long()[ia] - sa, bo[1:].long()[ib] - sb
    same = (la == lb) & avalid[ia] & bvalid[ib]
    lens = torch.where(same, la, 0)
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if lens.numel() else 0
    pair = torch.repeat_interleave(torch.arange(lens.shape[0],
                                                device=ia.device),
                                   lens, output_size=total)
    pos = torch.arange(total, device=ia.device) - (ends - lens)[pair]
    differ = av[sa[pair] + pos] != bv[sb[pair] + pos]
    bad = torch.zeros(lens.shape[0], dtype=torch.bool, device=ia.device)
    bad.index_put_((pair[differ],), torch.ones((), dtype=torch.bool,
                                               device=ia.device))
    return same & ~bad


def string_eq(a: tuple, ia: torch.Tensor, b: tuple, ib: torch.Tensor
              ) -> torch.Tensor:
    global launches
    dev = ia.get_device()
    _check("a", *a, ia, dev)
    _check("b", *b, ib, dev)
    m = ia.shape[0]
    if m != ib.shape[0]:
        raise ValueError("string_eq: index arrays differ in length")
    if not _build.on_cuda(ia, "string_eq"):
        return string_eq_plain(a, ia, b, ib)
    # a copy only of a tensor that is not contiguous, kept until the launch
    ao, av, avalid, bo, bv, bvalid, ia, ib = [
        t if t.is_contiguous() else t.contiguous() for t in (*a, *b, ia, ib)]
    out = torch.empty(m, dtype=torch.bool, device=ia.device)
    if m == 0:
        return out
    _build.check(_build.library().exon_string_eq(
        ao.data_ptr(), av.data_ptr(), av.shape[0], avalid.data_ptr(),
        ia.data_ptr(), bo.data_ptr(), bv.data_ptr(), bv.shape[0],
        bvalid.data_ptr(), ib.data_ptr(), m, out.data_ptr(),
        _build.stream_of(ia)), "string_eq")
    launches += 1
    return out
