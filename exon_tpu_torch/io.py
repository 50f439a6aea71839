"""Local file access for table scans: plain, gzip or BGZF files (stdlib
only).

A small counterpart of exon_tpu/io (``resolve_table_files``,
object_store.py:187, ``infer_compression``, compression.py:38, and BGZF's
``decompress_all``, bgzf.py:157) for the local paths the port reads. Object
stores, zstd and BGZF-indexed reads are not ported yet (ROADMAP Queue 1,
other decoders).
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


def _bgzf_blocks(data) -> list[tuple[int, int]] | None:
    """(deflate start, end) of every BGZF block, read from the block
    headers' BC subfields; None when the stream is not BGZF-framed."""
    blocks, pos, n = [], 0, len(data)
    while pos < n:
        if data[pos:pos + 4] != b"\x1f\x8b\x08\x04" or pos + 18 > n:
            return None
        xlen = struct.unpack_from("<H", data, pos + 10)[0]
        i, end, bsize = pos + 12, pos + 12 + xlen, None
        while i + 4 <= end:
            slen = struct.unpack_from("<H", data, i + 2)[0]
            if data[i:i + 2] == b"BC":
                bsize = struct.unpack_from("<H", data, i + 4)[0] + 1
                break
            i += 4 + slen
        if bsize is None:
            return None
        blocks.append((pos + 12 + xlen, pos + bsize - 8))
        pos += bsize
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
    """The file's bytes, gunzipped when its name ends in .gz/.bgz."""
    if path.lower().endswith(_COMPRESSED):
        with gzip.open(path, "rb") as f:
            return f.read()
    if path.lower().endswith((".zst", ".zstd")):
        raise NotImplementedError(
            f"zstd file {path!r}: only plain and gzip files are ported yet "
            "(ROADMAP Queue 1, other decoders)")
    with open(path, "rb") as f:
        return f.read()
