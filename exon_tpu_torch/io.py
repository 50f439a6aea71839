"""Local file access for table scans: plain, gzip or BGZF files (stdlib
only).

A small counterpart of exon_tpu/io (``resolve_table_files``,
object_store.py:187, ``infer_compression``, compression.py:38, and BGZF's
``decompress_all``, bgzf.py:157) for the local paths the port reads, with
the BGZF virtual-position helpers and range inflate of exon_tpu/io/bgzf.py
(``coffset``/``uoffset``/``make_vpos`` :21-29, ``read_block`` :39 as
``_block_at``, ``decompress_range`` :80, without its native path) and the
tabix chunk reads of exon_tpu/providers.py (``read_bgzf_chunk`` :31,
``_coalesce_chunks`` :377). Object stores and zstd are not ported yet
(ROADMAP Queue 1, item 2c).
"""

from __future__ import annotations

import gzip
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

_COMPRESSED = (".gz", ".bgz")


def resolve_table_files(url: str, extension: str | None = None) -> list[str]:
    """The files behind a table path: the file itself, or a directory's
    files with ``extension`` (optionally gzip-suffixed), sorted by name."""
    if "://" in url and not url.startswith("file://"):
        raise NotImplementedError(
            f"object-store URL {url!r}: only local paths are ported yet "
            "(ROADMAP Queue 1, other decoders)")
    path = url[len("file://"):] if url.startswith("file://") else url
    if os.path.isdir(path):
        names = sorted(os.listdir(path))
        if extension:
            exts = [extension] + [extension + c for c in _COMPRESSED]
            names = [n for n in names if any(n.endswith(e) for e in exts)]
        files = [os.path.join(path, n) for n in names]
    else:
        files = [path] if os.path.exists(path) else []
    if not files:
        raise FileNotFoundError(f"no files for table at {url}")
    return files


def _block_at(data, pos: int) -> tuple[int, int, int] | None:
    """(deflate start, deflate end, block size) of the BGZF block at
    ``pos``, read from its header's BC subfield; None when no BGZF block
    header is there."""
    if data[pos:pos + 4] != b"\x1f\x8b\x08\x04" or pos + 18 > len(data):
        return None
    xlen = struct.unpack_from("<H", data, pos + 10)[0]
    i, end = pos + 12, pos + 12 + xlen
    while i + 4 <= end:
        slen = struct.unpack_from("<H", data, i + 2)[0]
        if data[i:i + 2] == b"BC":
            bsize = struct.unpack_from("<H", data, i + 4)[0] + 1
            return end, pos + bsize - 8, bsize
        i += 4 + slen
    return None


def _bgzf_blocks(data) -> list[tuple[int, int]] | None:
    """(deflate start, end) of every BGZF block; None when the stream is
    not BGZF-framed."""
    blocks, pos = [], 0
    while pos < len(data):
        block = _block_at(data, pos)
        if block is None:
            return None
        blocks.append(block[:2])
        pos += block[2]
    return blocks


def bgzf_decompress(data: bytes) -> bytes:
    """Decompress a whole BGZF (or any multi-member gzip) stream.

    Counterpart of exon_tpu/io/bgzf.py ``decompress_all`` (:157) without
    its native libdeflate path: BGZF blocks are inflated independently, by
    a pool of threads (zlib releases the GIL), and joined in order; a
    stream without BGZF block headers goes through ``gzip.decompress``."""
    blocks = _bgzf_blocks(data)
    if blocks is None:
        return gzip.decompress(data)
    view = memoryview(data)

    def inflate(span: tuple[int, int]) -> bytes:
        return zlib.decompress(view[span[0]:span[1]], -15)

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        return b"".join(pool.map(inflate, blocks, chunksize=64))


def read_file(path: str) -> bytes:
    """The file's bytes, inflated when its name ends in .gz/.bgz (BGZF
    blocks by the thread pool of ``bgzf_decompress``)."""
    if path.lower().endswith(_COMPRESSED):
        with open(path, "rb") as f:
            return bgzf_decompress(f.read())
    if path.lower().endswith((".zst", ".zstd")):
        raise NotImplementedError(
            f"zstd file {path!r}: only plain and gzip files are ported yet "
            "(ROADMAP Queue 1, other decoders)")
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# BGZF virtual positions and range reads (exon_tpu/io/bgzf.py)
# ---------------------------------------------------------------------------


def coffset(vpos: int) -> int:
    return vpos >> 16


def uoffset(vpos: int) -> int:
    return vpos & 0xFFFF


def make_vpos(comp: int, unc: int) -> int:
    return (comp << 16) | unc


def decompress_range(buf, vstart: int, vend: int) -> bytes:
    """Inflate the uncompressed byte range [vstart, vend) of a buffer that
    starts at a BGZF block (virtual positions relative to ``buf``)."""
    out = []
    pos = coffset(vstart)
    first = True
    while pos < len(buf):
        block = _block_at(buf, pos)
        if block is None:
            raise ValueError(f"not a BGZF block at {pos}")
        start, end, size = block
        data = zlib.decompress(buf[start:end], -15)
        lo = uoffset(vstart) if first else 0
        if pos == coffset(vend):
            out.append(data[lo: uoffset(vend)])
            break
        if pos > coffset(vend):
            break
        out.append(data[lo:])
        pos += size
        first = False
    return b"".join(out)


def read_bgzf_chunk(path: str, chunk, file_size: int) -> bytes:
    """Range-read and inflate one tabix chunk (virtual positions)."""
    lo = coffset(chunk.vstart)
    hi = min(coffset(chunk.vend) + (1 << 17), file_size)
    with open(path, "rb") as f:
        f.seek(lo)
        buf = f.read(hi - lo)
    vstart = make_vpos(0, uoffset(chunk.vstart))
    vend = make_vpos(coffset(chunk.vend) - lo, uoffset(chunk.vend))
    return decompress_range(buf, vstart, vend)


def coalesce_chunks(chunks, max_gap: int = 1 << 20):
    """Merge index chunks whose compressed ranges are within ``max_gap``
    bytes — one range read and one decode per run instead of one per bin
    chunk. Safe only when the caller row-filters exactly afterwards
    (records in the gaps are dropped by the region mask)."""
    from .indexes import Chunk

    out: list = []
    for c in sorted(chunks, key=lambda c: c.vstart):
        if out and (c.vstart >> 16) - (out[-1].vend >> 16) <= max_gap:
            if c.vend > out[-1].vend:
                out[-1] = Chunk(out[-1].vstart, c.vend)
        else:
            out.append(Chunk(c.vstart, c.vend))
    return out
