"""gather_var: gather var-width rows (uint8 values + int32 offsets).

Replaces exon_tpu/ops/layout.py ``take_offsets`` (:111), ``relayout_values``
(:127) and ``byte_row_ids`` (:27). Kernel source: ``csrc/gather_var.cu``.
``gather_var(offsets, values, indices)`` returns the new int32 offsets
``[m+1]`` and the new uint8 values of rows ``indices`` (int32 ``[m]``, in
any order, repeats allowed), and raises ``ValueError`` when the output
would reach 2^31 bytes, before it is allocated.

On the card a call is two launches and one host read: the offsets pass (a
single pass with a look-back in the status words of ``_lookback``) writes
the new offsets, each taken row's source start, the row where each copy
block starts and the int64 total; the total is read to size the output;
the copy pass fills it in 16-byte words.
``m == 0`` launches nothing, a total of 0 no copy.
"""

from __future__ import annotations

import torch

from . import _build, _lookback

launches = 0

TILE = 1024  # kTile in csrc/gather_var.cu: taken rows a tile of the offsets
_INT32_LIMIT = 1 << 31


def _new_offsets(offsets: torch.Tensor, indices: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(new offsets int64 [m+1], source starts int64 [m], total bytes)."""
    off = offsets.to(torch.int64)
    idx = indices.to(torch.int64)
    starts = off[:-1].index_select(0, idx)
    lens = off[1:].index_select(0, idx) - starts
    new_off = torch.zeros(idx.shape[0] + 1, dtype=torch.int64,
                          device=offsets.device)
    torch.cumsum(lens, 0, out=new_off[1:])
    total = int(new_off[-1])
    if total >= _INT32_LIMIT:
        raise ValueError(f"gather_var: {total} output bytes exceed int32 "
                         "offsets")
    return new_off, starts, total


def gather_var_plain(offsets: torch.Tensor, values: torch.Tensor,
                     indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin."""
    new_off, starts, total = _new_offsets(offsets, indices)
    m = indices.shape[0]
    row = torch.repeat_interleave(
        torch.arange(m, device=offsets.device), new_off[1:] - new_off[:-1])
    src = torch.arange(total, device=offsets.device) - new_off[:-1][row] \
        + starts[row]
    return new_off.to(torch.int32), values[src]


def gather_var(offsets: torch.Tensor, values: torch.Tensor,
               indices: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    for name, t, dt in (("offsets", offsets, torch.int32),
                        ("values", values, torch.uint8),
                        ("indices", indices, torch.int32)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError(f"gather_var: {name} must be 1-d {dt}, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != offsets.device:
            raise ValueError("gather_var: tensors on different devices")
    if not _build.on_cuda(offsets, "gather_var"):
        return gather_var_plain(offsets, values, indices)
    offsets, values, indices = (offsets.contiguous(), values.contiguous(),
                                indices.contiguous())
    dev, m = values.device, indices.shape[0]
    if m == 0:
        return (torch.zeros(1, dtype=torch.int32, device=dev),
                torch.empty(0, dtype=torch.uint8, device=dev))
    new_off = torch.empty(m + 1, dtype=torch.int32, device=dev)
    # int64 words: the total, then (as int32, 16 bytes in) each taken row's
    # source start and the row holding each of the first m + 1 copy blocks'
    # first byte
    at = 4 + -(-m // 4) * 4
    scratch = torch.empty((at + m + 2) // 2, dtype=torch.int64, device=dev)
    base = scratch.data_ptr()
    lib = _build.library()
    stream = _build.stream_of(values)
    tiles = -(-m // TILE)

    def offsets_pass(status, ticket, ticket_base, epoch):
        _build.check(lib.exon_gather_var_offsets(
            offsets.data_ptr(), indices.data_ptr(), m, status, ticket,
            ticket_base, epoch, new_off.data_ptr(), base + 16, base + 4 * at,
            m + 1, base, stream), "gather_var")

    _lookback.scan(dev, stream, tiles, tiles, offsets_pass)
    launches += 1
    total = int(scratch[0])  # the one host read
    if total >= _INT32_LIMIT:
        raise ValueError(f"gather_var: {total} output bytes exceed int32 "
                         "offsets")
    out = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        _build.check(lib.exon_gather_var_copy(
            values.data_ptr(), values.shape[0], new_off.data_ptr(),
            base + 16, base + 4 * at,
            m + 1, m, total, out.data_ptr(), stream), "gather_var")
    return new_off, out
