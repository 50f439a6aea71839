"""expand_segments: repeat probe row i ``out_counts[i]`` times into join
index pairs.

Replaces exon_tpu/ops/layout.py ``expand_segments`` (:308) together with the
index arithmetic of exon_tpu/plan/join_exec.py ``_jit_emit`` (:246-251).
Kernel source: ``csrc/expand_segments.cu``.

``expand_segments(lo, counts_out, starts_out, total, n_build)`` takes int32
``lo [n]`` (each probe row's first match in the sorted build side), int32
``counts_out [n]`` (its output slots), their exclusive prefix sum int64
``starts_out [n]`` and the slot total (a host int). It returns int32
``probe_idx [total]`` and ``build_idx [total]``: slot ``starts_out[i] + j``
holds ``probe_idx = i`` and ``build_idx = min(lo[i] + j, n_build - 1)``
(0 when the build side is empty).
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

_INT32_LIMIT = 1 << 31


def expand_segments_plain(lo: torch.Tensor, counts_out: torch.Tensor,
                          starts_out: torch.Tensor, total: int, n_build: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch twin."""
    dev = lo.device
    rid = torch.repeat_interleave(
        torch.arange(lo.shape[0], device=dev), counts_out.to(torch.int64),
        output_size=total)
    intra = torch.arange(total, device=dev) - starts_out[rid]
    build = (lo.to(torch.int64)[rid] + intra).clamp(max=max(n_build - 1, 0))
    return rid.to(torch.int32), build.to(torch.int32)


def expand_segments(lo: torch.Tensor, counts_out: torch.Tensor,
                    starts_out: torch.Tensor, total: int, n_build: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    global launches
    for name, t, dt in (("lo", lo, torch.int32),
                        ("counts_out", counts_out, torch.int32),
                        ("starts_out", starts_out, torch.int64)):
        if t.dtype != dt or t.dim() != 1 or t.shape[0] != lo.shape[0]:
            raise TypeError(f"expand_segments: {name} must be 1-d {dt} of "
                            f"{lo.shape[0]} rows, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != lo.device:
            raise ValueError("expand_segments: tensors on different devices")
    if total >= _INT32_LIMIT:
        raise ValueError(f"expand_segments: {total} slots exceed int32 "
                         "indices")
    if not _build.on_cuda(lo, "expand_segments"):
        return expand_segments_plain(lo, counts_out, starts_out, total,
                                     n_build)
    lo, counts_out, starts_out = (lo.contiguous(), counts_out.contiguous(),
                                  starts_out.contiguous())
    probe = torch.empty(total, dtype=torch.int32, device=lo.device)
    build = torch.empty(total, dtype=torch.int32, device=lo.device)
    if total == 0:
        return probe, build
    _build.check(_build.library().exon_expand_segments(
        lo.data_ptr(), counts_out.data_ptr(), starts_out.data_ptr(),
        lo.shape[0], max(n_build - 1, 0), probe.data_ptr(), build.data_ptr(),
        _build.stream_of(lo)), "expand_segments")
    launches += 1
    return probe, build
