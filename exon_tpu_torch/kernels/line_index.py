"""line_index: the int32 position of every '\\n' in a chunk of text.

Replaces the line structure of exon_tpu/ops/device_text.py
(``line_starts_mask`` :37 and the per-byte line ids of ``record_structure``
:92). Kernel source: ``csrc/line_index.cu``. ``line_index(chunk)`` takes a
1-d uint8 tensor of fewer than 2^31 bytes and returns the ascending int32
positions of its newlines.

A call is one launch, a single pass with a look-back in the status words of
``_lookback``, into one allocation of ``n // 16 + 1`` positions and the
count after them; the line count and the output size come from one host
read of that count. A chunk with more newlines than that (lines under 16
bytes on average) takes one more launch of the same kernel into an exact
buffer.
"""

from __future__ import annotations

import torch

from . import _build, _lookback

launches = 0

NL = 10
_TILE = 256 * 4 * 16  # kTile in csrc/line_index.cu
_INT32_LIMIT = 1 << 31


def line_index_plain(chunk: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin."""
    return torch.nonzero(chunk == NL).flatten().to(torch.int32)


def _launch(chunk: torch.Tensor, cap: int) -> torch.Tensor:
    """One launch into cap positions and the count after them."""
    global launches
    n = chunk.shape[0]
    both = torch.empty(cap + 1, dtype=torch.int32, device=chunk.device)
    stream = _build.stream_of(chunk)
    tiles = (n + _TILE - 1) // _TILE

    def one_pass(status, ticket, base, epoch):
        _build.check(_build.library().exon_line_index(
            chunk.data_ptr(), n, status, ticket, base, epoch, both.data_ptr(),
            cap, both.data_ptr() + 4 * cap, stream), "line_index")

    _lookback.scan(chunk.device, stream, tiles, tiles, one_pass)
    launches += 1
    return both


def line_index(chunk: torch.Tensor) -> torch.Tensor:
    if chunk.dtype != torch.uint8 or chunk.dim() != 1:
        raise TypeError(f"line_index needs a 1-d uint8 tensor, got "
                        f"{chunk.dtype} {tuple(chunk.shape)}")
    n = chunk.shape[0]
    if n >= _INT32_LIMIT:
        raise ValueError(f"line_index: {n} bytes exceed int32 positions")
    if not _build.on_cuda(chunk, "line_index"):
        return line_index_plain(chunk)
    chunk = chunk.contiguous()
    if chunk.data_ptr() % 16:
        chunk = chunk.clone()  # the kernel reads 16-byte words
    if n == 0:
        return torch.empty(0, dtype=torch.int32, device=chunk.device)
    cap = n // 16 + 1
    both = _launch(chunk, cap)
    count = int(both[cap])  # the one host read: callers size by it
    if count > cap:
        both = _launch(chunk, count)
    return both[:count]
