"""count_bytes: per row, the number of bytes in a class of byte values.

Replaces the per-row count of exon_tpu/udfs.py ``gc_content`` (:69, its
``_per_row_count`` :59 over ``byte_row_ids``, ops/layout.py:27) and, in
share mode, its float32 divide (:75). Kernel source:
``csrc/count_bytes.cu`` (the class test in ``csrc/byteclass.cuh``).

``count_bytes(offsets, values, members, share=False)`` takes int32 offsets
``[n+1]``, uint8 values and the class as bytes or a collection of byte
values, and returns int32 ``[n]``; with ``share`` float32 ``[n]``, each
count divided by its row's length in IEEE float32 and 0 for an empty row.
Validity is not read.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _build

launches = 0

SWAR_MAX = 8   # cubes the kernel tests by SWAR; other classes by mask


def class_key(members) -> bytes:
    """The class as bytes, the key of the per-class caches below."""
    return members if isinstance(members, bytes) else bytes(members)


def cubes(members) -> list[tuple[int, int]]:
    """The class as (m, v) cubes, a byte b in it when b & m == v for one of
    them: the members (m = 0xff), two cubes merged into one while they
    differ in a single bit of the same m. Exact, not always the fewest."""
    out = {(0xff, b) for b in members}
    merged = True
    while merged:
        merged = False
        for m, v in sorted(out):
            bits = [1 << i for i in range(8) if m >> i & 1 and not v >> i & 1]
            bit = next((x for x in bits if (m, v | x) in out), 0)
            if bit:
                out -= {(m, v), (m, v | bit)}
                out.add((m & ~bit, v))
                merged = True
                break
    return sorted(out)


@functools.lru_cache(maxsize=256)
def class_params(key: bytes) -> tuple[np.ndarray, int]:
    """The class ``key`` (its bytes, repeats allowed) as the kernel's
    parameters: byteclass.cuh's Class (8 words v * 0x01010101 and 8 words
    m * 0x01010101 for its cubes, the first repeated to fill them; then the
    256-bit mask as 8 uint32 words) and K, the cubes the SWAR test takes
    (1, 2, 4 or 8), or 0 for the mask test (no member, or more than
    SWAR_MAX cubes)."""
    members = sorted(set(key))
    words = np.zeros(24, np.uint32)
    for b in members:
        words[16 + (b >> 5)] |= np.uint32(1 << (b & 31))
    cover = cubes(members)
    k = 0 if not members or len(cover) > SWAR_MAX else \
        next(w for w in (1, 2, 4, 8) if w >= len(cover))
    if k:
        cover += [cover[0]] * (8 - len(cover))
        rep = np.uint32(0x01010101)
        words[:8] = np.array([v for _m, v in cover], np.uint32) * rep
        words[8:16] = np.array([m for m, _v in cover], np.uint32) * rep
    return words, k


@functools.lru_cache(maxsize=256)
def class_table(key: bytes, device: torch.device) -> torch.Tensor:
    """The class as a [256] int32 0/1 table on ``device`` (the twin's)."""
    table = np.zeros(256, np.int32)
    table[list(key)] = 1
    return torch.from_numpy(table).to(device)


def count_bytes_plain(offsets: torch.Tensor, values: torch.Tensor,
                      members, share: bool = False) -> torch.Tensor:
    """The plain PyTorch twin: a per-byte class flag and a per-byte row id,
    summed into the rows; with ``share`` divided by the row lengths."""
    dev = offsets.device
    n = offsets.shape[0] - 1
    off = offsets.long()
    lens = off[1:] - off[:-1]
    rid = torch.repeat_interleave(torch.arange(n, device=dev), lens)
    rank = torch.arange(rid.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens)
    byte = values[off[:-1][rid] + rank]
    flag = class_table(class_key(members), dev)[byte.long()]
    out = torch.zeros(n, dtype=torch.int32, device=dev).index_add_(0, rid,
                                                                   flag)
    if not share:
        return out
    return torch.where(lens > 0, out.to(torch.float32) / lens.to(torch.float32),
                       0.0)


def count_bytes(offsets: torch.Tensor, values: torch.Tensor, members,
                share: bool = False) -> torch.Tensor:
    global launches
    if offsets.dtype != torch.int32 or values.dtype != torch.uint8:
        raise TypeError("count_bytes needs int32 offsets and uint8 values, got "
                        f"{offsets.dtype} and {values.dtype}")
    if offsets.device != values.device:
        raise ValueError("count_bytes: tensors on different devices")
    if not _build.on_cuda(offsets, "count_bytes"):
        return count_bytes_plain(offsets, values, members, share)
    offsets, values = (t if t.is_contiguous() else t.contiguous()
                       for t in (offsets, values))
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.float32 if share else torch.int32,
                      device=offsets.device)
    if n == 0:
        return out
    words, k = class_params(class_key(members))
    _build.check(_build.library().exon_count_bytes(
        values.data_ptr(), values.shape[0], offsets.data_ptr(), n,
        words.ctypes.data, k, int(share), out.data_ptr(),
        _build.stream_of(values)), "count_bytes")
    launches += 1
    return out
