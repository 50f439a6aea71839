"""FASTQ decoder: numpy host path and device path.

Copy of exon_tpu/formats/fastq.py (``FastqOptions`` :27, ``fastq_schema``
:33, the numpy ``decode_host`` :42) on the port's ``textutil``, and the
device path, the counterpart of ``_device_decode``/``decode_device``
(:101, :151) on the kernels of ``ops/device_text.py``. Schema ``name,
description, sequence, quality_scores`` (all Utf8); 4-line records (@name
[desc] / seq / + / qual); line roles by line id mod 4.

The device path cuts the buffer into chunks of at most 128 MiB at 4-line
boundaries, as the JAX version's comment (:160-162) intends but does not
do: each window's newlines are found on the device and the chunk ends after
its last whole record, so every chunk holds fewer than 2^31 bytes. Its
semantics are the JAX device path's: every '\\r' is dropped from every
column, and a header line must start with '@' (so a trailing blank line
raises). Unlike it, a trailing partial record raises
``InvalidSequenceError`` (ROADMAP Queue 3, F7), as the host path does; the
host path here raises for it even in a buffer of fewer than four lines.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch

from .. import datatypes as dt
from ..batch import Batch, Schema, VarColumn
from ..errors import InvalidSequenceError
from ..kernels.line_index import line_index
from ..ops.device_text import (NL, chunk_to_device, host_ints,
                               lengths_to_offsets, line_table, span_column)
from .textutil import LineIndex, gather_slices, to_u8

DEFAULT_CHUNK = 128 << 20  # 128 MiB raw bytes per device chunk


@dataclass
class FastqOptions:
    file_extension: str = ".fastq"
    batch_size: int = 8192
    projection: Optional[list[str]] = None


def fastq_schema(options: FastqOptions = None) -> Schema:
    return Schema.of(
        dt.Field("name", dt.utf8, nullable=False),
        dt.Field("description", dt.utf8, nullable=True),
        dt.Field("sequence", dt.utf8, nullable=False),
        dt.Field("quality_scores", dt.utf8, nullable=False),
    )


def decode_host(data, options: FastqOptions,
                projection: Optional[list[str]] = None) -> Iterator[Batch]:
    arr = to_u8(data)
    schema = fastq_schema(options)
    proj = projection if projection is not None else schema.names
    schema = schema.project(proj)
    if len(arr) == 0:
        return
    li = LineIndex(arr)
    n_lines = len(li)
    n = n_lines // 4
    if n_lines % 4 not in (0,):
        # trailing partial record → reference errors; tolerate trailing blank
        tail_ok = all(li.ends[k] == li.starts[k] for k in range(n * 4, n_lines))
        if not tail_ok:
            raise InvalidSequenceError("FASTQ record count not divisible by 4")
    if n == 0:
        return
    hstart, hend = li.starts[0::4][:n], li.ends[0::4][:n]
    if (arr[hstart] != ord("@")).any():
        raise InvalidSequenceError("FASTQ header must start with '@'")
    sstart, send = li.starts[1::4][:n], li.ends[1::4][:n]
    qstart, qend = li.starts[3::4][:n], li.ends[3::4][:n]

    sp = np.flatnonzero(arr == 32)
    if len(sp):
        i = np.searchsorted(sp, hstart)
        first_sp = np.where(i < len(sp), sp[np.clip(i, 0, len(sp) - 1)], hend)
        first_sp = np.minimum(first_sp, hend)
    else:
        first_sp = hend
    has_desc = first_sp < hend

    bs = options.batch_size
    for lo in range(0, n, bs):
        hi = min(lo + bs, n)
        cols = []
        for name in proj:
            if name == "name":
                v, o = gather_slices(arr, hstart[lo:hi] + 1, first_sp[lo:hi])
                cols.append(VarColumn(v, o.astype(np.int32), np.ones(hi - lo, bool)))
            elif name == "description":
                v, o = gather_slices(arr, np.minimum(first_sp[lo:hi] + 1, hend[lo:hi]),
                                     hend[lo:hi])
                cols.append(VarColumn(v, o.astype(np.int32), has_desc[lo:hi].copy()))
            elif name == "sequence":
                v, o = gather_slices(arr, sstart[lo:hi], send[lo:hi])
                cols.append(VarColumn(v, o.astype(np.int32), np.ones(hi - lo, bool)))
            elif name == "quality_scores":
                v, o = gather_slices(arr, qstart[lo:hi], qend[lo:hi])
                cols.append(VarColumn(v, o.astype(np.int32), np.ones(hi - lo, bool)))
        yield Batch(schema, cols, hi - lo)


# ---------------------------------------------------------------------------
# Device path
# ---------------------------------------------------------------------------


def _after_fourth_newline(arr: np.ndarray, start: int) -> int:
    """End of the record that starts at ``start`` (host search; only for a
    record longer than a whole chunk)."""
    nl = np.flatnonzero(arr[start:] == NL)
    return len(arr) if len(nl) < 4 else start + int(nl[3]) + 1


def _chunks(arr: np.ndarray, device, max_chunk: int
            ) -> Iterator[tuple[torch.Tensor, torch.Tensor, bool]]:
    """(chunk on the device, its newline positions, ends in '\\n') for
    consecutive chunks of whole 4-line records, each at most ``max_chunk``
    bytes unless one record is longer."""
    n, lo = len(arr), 0
    while lo < n:
        hi = min(lo + max_chunk, n)
        chunk = chunk_to_device(arr, lo, hi, device)
        nl = line_index(chunk)
        if hi < n:
            whole = nl.shape[0] // 4 * 4
            if whole:
                cut = int(nl[whole - 1]) + 1
                chunk, nl = chunk[:cut], nl[:whole]
            else:
                cut = _after_fourth_newline(arr, lo) - lo
                chunk = chunk_to_device(arr, lo, lo + cut, device)
                nl = line_index(chunk)
            hi = lo + cut
        yield chunk, nl, bool(arr[hi - 1] == NL)
        lo = hi


def decode_chunk(chunk: torch.Tensor, nl: torch.Tensor, ends_in_newline: bool,
                 projection: list[str], schema: Schema) -> Batch:
    """One chunk of whole records (a uint8 tensor and its newlines) → one
    batch."""
    want_hdr = "name" in projection or "description" in projection
    lines = line_table(chunk, ends_in_newline, True, want_hdr, nl)
    n_lines = lines.start.shape[0]
    if n_lines % 4:
        raise InvalidSequenceError("FASTQ record count not divisible by 4")
    valid = torch.ones(n_lines // 4, dtype=torch.bool, device=chunk.device)
    # per column: (span starts, span stops, kept lengths, validity), one
    # span per record from the line of its role (line id mod 4)
    spans = {}
    for name, role in (("sequence", 1), ("quality_scores", 3)):
        spans[name] = (lines.start[role::4], lines.end[role::4],
                       lines.body[role::4], valid)
    if want_hdr:
        start, end = lines.start[0::4], lines.end[0::4]
        split = lines.split[0::4]
        spans["name"] = (start + 1, split, lines.name_len[0::4], valid)
        spans["description"] = (torch.minimum(split + 1, end), end,
                                lines.desc_len[0::4], split < end)
    offsets = {name: lengths_to_offsets(spans[name][2]) for name in projection}
    bad, *totals = host_ints(lines.bad, *(o[-1] for o in offsets.values()))
    if bad:
        raise InvalidSequenceError("FASTQ header must start with '@'")
    cols = [span_column(chunk, spans[name][0], spans[name][1], offsets[name],
                        total, spans[name][3])
            for name, total in zip(projection, totals)]
    return Batch(schema, cols, n_lines // 4)


def decode_device(data, options: FastqOptions,
                  projection: Optional[list[str]] = None, device="cpu",
                  max_chunk: int = DEFAULT_CHUNK) -> Iterator[Batch]:
    """Decode raw FASTQ bytes into batches on ``device``."""
    schema = fastq_schema(options)
    proj = list(projection) if projection is not None else schema.names
    schema = schema.project(proj)
    for chunk, nl, ends_in_newline in _chunks(to_u8(data), device, max_chunk):
        yield decode_chunk(chunk, nl, ends_in_newline, proj, schema)
