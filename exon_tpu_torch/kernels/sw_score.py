"""sw_score: best Smith-Waterman local-alignment score per row.

Replaces exon_tpu/ops/alignment.py ``sw_scores_vs_query`` (:43) and
``sw_scores_pairwise`` (:79). Kernel source: ``csrc/sw_score.cu``.

``sw_score(offsets, values, query)`` scores each row of a var-width column
(int32 offsets, uint8 values) against ``query``, a uint8 tensor on the same
device; ``sw_score_pairwise(a_offsets, a_values, b_offsets, b_values)``
scores row i against row i of a second column. Both return int32 ``[n]``:
match +1, mismatch -1, a gap of length L costs -(1 + L), scores clamp at 0.
Validity is not read: a NULL row scores its bytes, which are none, as in
the JAX functions. Whole rows are aligned, whatever their length (F11,
ROADMAP Queue 3: the JAX wrappers cut every row at 2048 bytes).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _build

launches = 0

NEG = -(1 << 20)  # exon_tpu/ops/alignment.py:29
# query bytes per pass of the kernel's widest width (W in sw_score.cu); the
# kernel takes 8, 16 or 32, the least that holds the longest query
PASS_BYTES = 32
TWIN_CELLS = 1 << 22  # rows x padded width of one block of the twin


def _padded(offsets: torch.Tensor, values: torch.Tensor, lo: int, hi: int,
            width: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows [lo, hi) as a [rows, width] int32 byte matrix (0 past each
    row's end) and its valid mask, as ``to_padded_matrix`` (:32) builds
    them."""
    starts = offsets[lo:hi].long()
    lens = offsets[lo + 1:hi + 1].long() - starts
    pos = torch.arange(width, device=values.device)
    valid = pos[None, :] < lens[:, None]
    if values.shape[0] == 0:
        return torch.zeros(valid.shape, dtype=torch.int32,
                           device=values.device), valid
    idx = (starts[:, None] + pos[None, :]).clamp(max=values.shape[0] - 1)
    mat = torch.where(valid, values[idx].to(torch.int32), 0)
    return mat, valid


def _scan(mat: torch.Tensor, valid: torch.Tensor, q_cols) -> torch.Tensor:
    """The JAX scan body (:49-72, :87-103) over query columns: each is
    (query byte per row, whether the row's query still has a byte)."""
    n, width = mat.shape
    dev = mat.device
    jpos = torch.arange(width, dtype=torch.int32, device=dev)
    h = torch.zeros((n, width), dtype=torch.int32, device=dev)
    colmax = torch.full((n, width), NEG, dtype=torch.int32, device=dev)
    best = torch.zeros(n, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    neg_col = torch.full((n, 1), NEG, dtype=torch.int32, device=dev)
    for q_char, q_ok in q_cols:
        ok = valid & q_ok[:, None]
        s = torch.where(mat == q_char[:, None], 1, -1).to(torch.int32)
        s = torch.where(ok, s, NEG)
        diag = torch.cat([zero_col, h[:, :-1]], dim=1) + s
        h0 = torch.clamp(torch.maximum(diag, colmax - 2), min=0)
        run = torch.cummax(h0 + jpos, dim=1).values
        f = torch.cat([neg_col, run[:, :-1] - jpos[1:] - 1], dim=1)
        h = torch.maximum(h0, f.clamp(min=0))
        h = torch.where(ok, h, 0)
        colmax = torch.maximum(colmax - 1, h)
        best = torch.maximum(best, h.max(dim=1).values)
    return best


def _blocks(offsets: torch.Tensor):
    """Row blocks [lo, hi) whose rows x widest row stays near TWIN_CELLS,
    and that width."""
    lens = (offsets[1:] - offsets[:-1]).cpu().numpy().astype(np.int64)
    n = len(lens)
    step = max(1, TWIN_CELLS // max(int(lens.max()) if n else 1, 1))
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        yield lo, hi, max(int(lens[lo:hi].max()), 1)


def sw_score_plain(offsets: torch.Tensor, values: torch.Tensor,
                   query: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin of the query form: the JAX recurrence, one
    step per query byte (``torch.cummax`` for the row gap), on blocks of
    rows padded to their widest row."""
    n = offsets.shape[0] - 1
    out = torch.zeros(n, dtype=torch.int32, device=offsets.device)
    q = query.to(torch.int32)
    for lo, hi, width in _blocks(offsets):
        mat, valid = _padded(offsets, values, lo, hi, width)
        ones = torch.ones(hi - lo, dtype=torch.bool, device=offsets.device)
        out[lo:hi] = _scan(mat, valid, ((c.expand(hi - lo), ones)
                                        for c in q))
    return out


def sw_score_pairwise_plain(a_offsets: torch.Tensor, a_values: torch.Tensor,
                            b_offsets: torch.Tensor, b_values: torch.Tensor
                            ) -> torch.Tensor:
    """The plain PyTorch twin of the two-column form: row i of b is the
    query of row i of a, one step per byte of the longest b row in the
    block."""
    n = a_offsets.shape[0] - 1
    out = torch.zeros(n, dtype=torch.int32, device=a_offsets.device)
    for lo, hi, width in _blocks(a_offsets):
        mat, valid = _padded(a_offsets, a_values, lo, hi, width)
        b_lens = b_offsets[lo + 1:hi + 1] - b_offsets[lo:hi]
        b_width = int(b_lens.max()) if hi > lo else 0
        if b_width == 0:
            continue
        q_mat, q_valid = _padded(b_offsets, b_values, lo, hi, b_width)
        out[lo:hi] = _scan(mat, valid, ((q_mat[:, k], q_valid[:, k])
                                        for k in range(b_width)))
    return out


def _check(name: str, offsets: torch.Tensor, values: torch.Tensor) -> None:
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or \
            values.dtype != torch.uint8 or values.dim() != 1:
        raise TypeError(f"sw_score: {name} needs 1-d int32 offsets and uint8 "
                        f"values, got {offsets.dtype} and {values.dtype}")


def _launch(a_offsets, a_values, b_offsets, b_values, qlen: int,
            max_b: int) -> torch.Tensor:
    global launches
    a_offsets, a_values = a_offsets.contiguous(), a_values.contiguous()
    n = a_offsets.shape[0] - 1
    dev = a_offsets.device
    out = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    # the edge buffer (H and E per byte of a) is read only by a second pass
    edge = torch.empty(2 * a_values.shape[0] if max_b > PASS_BYTES else 0,
                       dtype=torch.int32, device=dev)
    b_ptr = 0 if b_offsets is None else b_offsets.contiguous().data_ptr()
    b_values = b_values.contiguous()
    _build.check(_build.library().exon_sw_score(
        a_values.data_ptr(), a_offsets.data_ptr(), n, b_values.data_ptr(),
        b_ptr, qlen, max_b, edge.data_ptr(), out.data_ptr(),
        _build.stream_of(a_values)), "sw_score")
    launches += 1
    return out


def sw_score(offsets: torch.Tensor, values: torch.Tensor,
             query: torch.Tensor) -> torch.Tensor:
    _check("the column", offsets, values)
    if query.dtype != torch.uint8 or query.dim() != 1:
        raise TypeError(f"sw_score: the query must be 1-d uint8, got "
                        f"{query.dtype}")
    if not (offsets.device == values.device == query.device):
        raise ValueError("sw_score: tensors on different devices")
    if not _build.on_cuda(offsets, "sw_score"):
        return sw_score_plain(offsets, values, query)
    m = query.shape[0]
    return _launch(offsets, values, None, query, m, m)


def sw_score_pairwise(a_offsets: torch.Tensor, a_values: torch.Tensor,
                      b_offsets: torch.Tensor, b_values: torch.Tensor
                      ) -> torch.Tensor:
    _check("column a", a_offsets, a_values)
    _check("column b", b_offsets, b_values)
    if a_offsets.shape != b_offsets.shape:
        raise ValueError("sw_score: the two columns differ in row count")
    if not (a_offsets.device == a_values.device == b_offsets.device
            == b_values.device):
        raise ValueError("sw_score: tensors on different devices")
    if not _build.on_cuda(a_offsets, "sw_score"):
        return sw_score_pairwise_plain(a_offsets, a_values, b_offsets,
                                       b_values)
    n = a_offsets.shape[0] - 1
    max_b = int((b_offsets[1:] - b_offsets[:-1]).max()) if n else 0
    return _launch(a_offsets, a_values, b_offsets, b_values, 0, max_b)
