"""Tabix (.tbi) index parsing and region queries.

Copy of exon_tpu/io/indexes.py: ``reg2bins`` (:111), ``Chunk`` (:124),
``BinIndex`` (:130), ``TabixIndex`` (:160, ``query`` :175),
``parse_tabix`` (:182) and ``_parse_binindex`` (:202). A region query
consults the index on the host and yields virtual-position chunks; the VCF
scan then reads and inflates only those compressed byte ranges.
``Region`` lives in region.py. FAI, BAI and CSI readers are not ported yet
(ROADMAP Queue 1, item 2c).
"""

from __future__ import annotations

import functools
import struct
from dataclasses import dataclass
from typing import Optional

from .io import bgzf_decompress
from .region import Region


def reg2bins(beg: int, end: int) -> list[int]:
    """5-level binning scheme bins overlapping [beg, end) (0-based).
    Coordinates clamp to the scheme's 2^29 limit."""
    beg = min(beg, (1 << 29) - 1)
    end = min(end, 1 << 29)
    end -= 1
    bins = [0]
    for shift, offset in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(offset + (beg >> shift), offset + (end >> shift) + 1))
    return bins


@dataclass
class Chunk:
    vstart: int
    vend: int


@dataclass
class BinIndex:
    """Per-reference binning + linear index."""

    bins: dict[int, list[Chunk]]
    intervals: list[int]  # 16kb linear index of virtual offsets

    def query(self, beg: int, end: int) -> list[Chunk]:
        """Chunks possibly overlapping 0-based [beg, end)."""
        min_off = 0
        iv = beg >> 14
        if self.intervals:
            iv = min(iv, len(self.intervals) - 1)
            min_off = self.intervals[iv]
        out = []
        for b in reg2bins(beg, end):
            for c in self.bins.get(b, ()):
                if c.vend > min_off:
                    out.append(c)
        out.sort(key=lambda c: c.vstart)
        # merge adjacent/overlapping chunks
        merged: list[Chunk] = []
        for c in out:
            if merged and c.vstart <= merged[-1].vend:
                merged[-1] = Chunk(merged[-1].vstart, max(merged[-1].vend, c.vend))
            else:
                merged.append(Chunk(c.vstart, c.vend))
        return merged


@dataclass
class TabixIndex:
    names: list[str]
    refs: list[BinIndex]
    col_seq: int
    col_beg: int
    col_end: int
    meta_char: str
    skip: int

    def ref_id(self, name: str) -> Optional[int]:
        try:
            return self.names.index(name)
        except ValueError:
            return None

    def query(self, region: Region) -> list[Chunk]:
        rid = self.ref_id(region.name)
        if rid is None:
            return []
        return self.refs[rid].query(region.zero_start, region.excl_end)


def parse_tabix(data: bytes) -> TabixIndex:
    """Parse a .tbi file (bgzf-compressed binary). Cached by content —
    repeated region queries against the same table skip the re-parse."""
    return _parse_tabix_cached(bytes(data))


@functools.lru_cache(maxsize=32)
def _parse_tabix_cached(data: bytes) -> "TabixIndex":
    raw = bgzf_decompress(data)
    if raw[:4] != b"TBI\x01":
        raise ValueError("not a tabix index")
    (n_ref, fmt, col_seq, col_beg, col_end, meta, skip, l_nm) = \
        struct.unpack_from("<8i", raw, 4)
    off = 36
    names_blob = raw[off:off + l_nm]
    names = [n.decode() for n in names_blob.split(b"\x00") if n]
    off += l_nm
    refs = []
    for _ in range(n_ref):
        idx, off = _parse_binindex(raw, off)
        refs.append(idx)
    return TabixIndex(names, refs, col_seq, col_beg, col_end,
                      chr(meta & 0xFF), skip)


def _parse_binindex(raw: bytes, off: int, pseudo_bin: Optional[int] = 37450
                    ) -> tuple[BinIndex, int]:
    (n_bin,) = struct.unpack_from("<i", raw, off)
    off += 4
    bins: dict[int, list[Chunk]] = {}
    for _ in range(n_bin):
        b, n_chunk = struct.unpack_from("<Ii", raw, off)
        off += 8
        chunks = []
        for _ in range(n_chunk):
            vs, ve = struct.unpack_from("<QQ", raw, off)
            off += 16
            chunks.append(Chunk(vs, ve))
        if pseudo_bin is None or b != pseudo_bin:
            bins[b] = chunks
    (n_intv,) = struct.unpack_from("<i", raw, off)
    off += 4
    intervals = list(struct.unpack_from(f"<{n_intv}Q", raw, off))
    off += 8 * n_intv
    return BinIndex(bins, intervals), off
