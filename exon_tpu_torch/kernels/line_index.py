"""line_index: the int32 position of every '\\n' in a chunk of text.

Replaces the line structure of exon_tpu/ops/device_text.py
(``line_starts_mask`` :37 and the per-byte line ids of ``record_structure``
:92). Kernel source: ``csrc/line_index.cu``. ``line_index(chunk)`` takes a
1-d uint8 tensor of fewer than 2^31 bytes and returns the ascending int32
positions of its newlines; the line count and the output size come from one
host read of the total.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

NL = 10
_BLOCK_BYTES = 256 * 16  # kThreads * kBytesPerThread in csrc/line_index.cu
_INT32_LIMIT = 1 << 31


def line_index_plain(chunk: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch twin."""
    return torch.nonzero(chunk == NL).flatten().to(torch.int32)


def line_index(chunk: torch.Tensor) -> torch.Tensor:
    global launches
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
    lib = _build.library()
    stream = _build.stream_of(chunk)
    nblocks = (n + _BLOCK_BYTES - 1) // _BLOCK_BYTES
    block_counts = torch.empty(nblocks, dtype=torch.int32, device=chunk.device)
    _build.check(lib.exon_line_count(chunk.data_ptr(), n,
                                     block_counts.data_ptr(), stream),
                 "line_index")
    block_offsets = torch.zeros(nblocks + 1, dtype=torch.int32,
                                device=chunk.device)
    torch.cumsum(block_counts, 0, dtype=torch.int32, out=block_offsets[1:])
    out = torch.empty(int(block_offsets[nblocks]), dtype=torch.int32,
                      device=chunk.device)
    _build.check(lib.exon_line_scatter(chunk.data_ptr(), n,
                                       block_offsets.data_ptr(),
                                       out.data_ptr(), stream),
                 "line_index")
    launches += 1
    return out
