"""count_bytes: per row, the number of bytes in a class of byte values.

Replaces the per-row count of exon_tpu/udfs.py ``gc_content`` (:69, its
``_per_row_count`` :59 over ``byte_row_ids``, ops/layout.py:27). Kernel
source: ``csrc/count_bytes.cu``.

``count_bytes(offsets, values, members)`` takes int32 offsets ``[n+1]``,
uint8 values and the class as a collection of byte values, and returns
int32 ``[n]``. Validity is not read.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0


def class_words(members) -> list[int]:
    """A byte class as the kernel's 256-bit mask: four 64-bit words, bit
    b % 64 of word b // 64 set for a member b."""
    words = [0, 0, 0, 0]
    for b in set(members):
        words[b >> 6] |= 1 << (b & 63)
    return words


def count_bytes_plain(offsets: torch.Tensor, values: torch.Tensor,
                      members) -> torch.Tensor:
    """The plain PyTorch twin: a per-byte class flag and a per-byte row id,
    summed into the rows."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    off = offsets.long()
    lens = off[1:] - off[:-1]
    rid = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    rank = torch.arange(rid.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    byte = values[off[:-1][rid] + rank]
    table = torch.zeros(256, dtype=torch.int32, device=dev)
    table[list(set(members))] = 1
    flag = table[byte.long()]
    out = torch.zeros(n, dtype=torch.int32, device=dev)
    return out.index_add_(0, rid, flag)


def count_bytes(offsets: torch.Tensor, values: torch.Tensor,
                members) -> torch.Tensor:
    global launches
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError("count_bytes needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    if offsets.device != values.device:
        raise ValueError("count_bytes: tensors on different devices")
    if not _build.on_cuda(offsets, "count_bytes"):
        return count_bytes_plain(offsets, values, members)
    offsets, values = offsets.contiguous(), values.contiguous()
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.int32, device=offsets.device)
    if n == 0:
        return out
    _build.check(_build.library().exon_count_bytes(
        values.data_ptr(), offsets.data_ptr(), n, *class_words(members),
        out.data_ptr(), _build.stream_of(values)), "count_bytes")
    launches += 1
    return out
