"""list_bins: per-row reductions over List<Float64> columns (K11b).

Replaces exon_tpu/udfs.py ``contains_peak`` (:376) and ``bin_vectors``
(:389). Kernel source: ``csrc/list_bins.cu``.

- ``list_bins_peak(offsets, values, validity, peak, tol)`` takes int32
  offsets ``[n+1]``, float64 values and bool validity ``[n]``, and returns
  bool ``[n]``: whether any element of the row lies within ``tol`` of
  ``peak`` (``|x - peak| <= tol``), ANDed with the row's validity.
- ``list_bins_bins(offsets, mz, intensity, min_mz, bin_width, num_bins)``
  returns float64 ``[n * num_bins]``: row r's bin k holds the sum, in
  element order, of the intensities whose mz has
  ``floor((mz - min_mz) / bin_width) == k``; an mz outside
  ``[0, num_bins)`` (a NaN too) adds nothing. Intensity is read at mz's
  flat positions, so both lists must hold the same number of elements.
  The kernel keeps a row's bins in shared memory up to ``SHARED_BINS_MAX``
  bins and adds into the output row past that (``bins_variant``).

Element validity is not read, as in the JAX functions.
"""

from __future__ import annotations

import torch

from . import _build

launches = 0

# The most float64 bins a block's opt-in shared memory holds on the H100
# (232,448 B); past it the kernel adds into the output row in device memory.
SHARED_BINS_MAX = 232_448 // 8


def bins_variant(num_bins: int) -> str:
    """The bins-mode kernel variant for ``num_bins``: "shared" or
    "global" (csrc/list_bins.cu)."""
    return "shared" if num_bins <= SHARED_BINS_MAX else "global"


def _row_ids(offsets: torch.Tensor) -> torch.Tensor:
    """Each element's row (int64 [offsets[-1]])."""
    off = offsets.long()
    n = off.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=offsets.device),
                                   off[1:] - off[:-1])


def _check(offsets: torch.Tensor, *lists: torch.Tensor) -> None:
    if offsets.dtype != torch.int32 or offsets.dim() != 1:
        raise TypeError(f"list_bins needs 1-d int32 offsets, got "
                        f"{offsets.dtype} {tuple(offsets.shape)}")
    for t in lists:
        if t.dtype != torch.float64 or t.dim() != 1:
            raise TypeError(f"list_bins needs 1-d float64 lists, got "
                            f"{t.dtype} {tuple(t.shape)}")
        if t.device != offsets.device:
            raise ValueError("list_bins: tensors on different devices")


def list_bins_peak_plain(offsets: torch.Tensor, values: torch.Tensor,
                         validity: torch.Tensor, peak: float,
                         tol: float) -> torch.Tensor:
    """The plain PyTorch twin: a hit flag per element, summed into its row
    (the JAX function's segment sum)."""
    n = offsets.shape[0] - 1
    total = int(offsets[-1]) if n else 0
    hit = ((values[:total] - peak).abs() <= tol).to(torch.int32)
    per_row = torch.zeros(n, dtype=torch.int32, device=offsets.device)
    per_row.index_add_(0, _row_ids(offsets), hit)
    return (per_row > 0) & validity


def list_bins_peak(offsets: torch.Tensor, values: torch.Tensor,
                   validity: torch.Tensor, peak: float,
                   tol: float) -> torch.Tensor:
    global launches
    _check(offsets, values)
    if validity.dtype != torch.bool or validity.shape[0] != \
            offsets.shape[0] - 1:
        raise TypeError("list_bins_peak: validity must be bool [n]")
    if not _build.on_cuda(offsets, "list_bins_peak"):
        return list_bins_peak_plain(offsets, values, validity, peak, tol)
    offsets, values, validity = (offsets.contiguous(), values.contiguous(),
                                 validity.contiguous())
    n = offsets.shape[0] - 1
    out = torch.empty(n, dtype=torch.bool, device=offsets.device)
    if n == 0:
        return out
    _build.check(_build.library().exon_list_bins_peak(
        values.data_ptr(), offsets.data_ptr(), validity.data_ptr(), n,
        float(peak), float(tol), out.data_ptr(), _build.stream_of(values)),
        "list_bins_peak")
    launches += 1
    return out


def _flat_bins(offsets: torch.Tensor, mz: torch.Tensor, min_mz: float,
               bin_width: float, num_bins: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(the flat output slot of each element, whether it is in range): the
    bin decided in float64 before any cast."""
    total = int(offsets[-1]) if offsets.shape[0] > 1 else 0
    b = torch.floor((mz[:total] - min_mz) / bin_width)
    ok = (b >= 0) & (b < num_bins)
    slot = _row_ids(offsets) * num_bins + \
        torch.where(ok, b, 0.0).to(torch.int64)
    return slot, ok


def list_bins_bins_plain(offsets: torch.Tensor, mz: torch.Tensor,
                         intensity: torch.Tensor, min_mz: float,
                         bin_width: float, num_bins: int) -> torch.Tensor:
    """The plain PyTorch twin: each in-range element's slot, then one
    index_add_ in element order."""
    n = offsets.shape[0] - 1
    slot, ok = _flat_bins(offsets, mz, min_mz, bin_width, num_bins)
    out = torch.zeros(n * num_bins, dtype=torch.float64, device=mz.device)
    return out.index_add_(0, slot[ok], intensity[:slot.shape[0]][ok])


def list_bins_bins(offsets: torch.Tensor, mz: torch.Tensor,
                   intensity: torch.Tensor, min_mz: float, bin_width: float,
                   num_bins: int) -> torch.Tensor:
    global launches
    _check(offsets, mz, intensity)
    if num_bins < 0 or num_bins >= 1 << 31:
        raise ValueError(f"list_bins_bins: num_bins {num_bins} out of range")
    if mz.shape[0] != intensity.shape[0]:
        raise ValueError(
            f"list_bins_bins: {mz.shape[0]} m/z values but "
            f"{intensity.shape[0]} intensities; intensity is read at the "
            "m/z positions")
    if not _build.on_cuda(offsets, "list_bins_bins"):
        return list_bins_bins_plain(offsets, mz, intensity, min_mz,
                                    bin_width, num_bins)
    offsets, mz, intensity = (offsets.contiguous(), mz.contiguous(),
                              intensity.contiguous())
    n = offsets.shape[0] - 1
    shared = bins_variant(num_bins) == "shared"
    # the shared variant writes every bin; the global one adds into zeros
    out = (torch.empty if shared else torch.zeros)(
        n * num_bins, dtype=torch.float64, device=mz.device)
    if n == 0 or num_bins == 0:
        return out
    _build.check(_build.library().exon_list_bins_bins(
        mz.data_ptr(), intensity.data_ptr(), offsets.data_ptr(), n,
        float(min_mz), float(bin_width), int(num_bins), int(shared),
        out.data_ptr(), _build.stream_of(mz)), "list_bins_bins")
    launches += 1
    return out
