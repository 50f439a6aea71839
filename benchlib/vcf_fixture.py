"""Synthetic whole-genome VCF fixture: BGZF text and its tabix index (numpy
and zlib only).

The record layout and field distributions of ``fixtures.make_vcf_bgzf``
(fixtures.py:121-170: the same ``##INFO`` header lines, QUAL 10-3999,
FILTER PASS, an INFO field with DP/AF/RS/AN/AC/MQ and two rank sums), spread
over a whole-genome call set rather than chr1 alone:

  * ``VCF_RECORDS`` = 25,000,000 records (~4 GB of text, fixtures.py:28)
    over ``gff_fixture.SEQNAMES`` by ``SEQ_WEIGHTS``, one ``##contig`` line
    each, coordinate-sorted, positions uniform in [1, 248,000,000);
  * 10 % indels, whose REF is 2-12 random bases and ALT its first base; the
    rest SNVs with a 1-base REF and ALT;
  * about 1 % of the records with QUAL ``.``.

``make_vcf`` writes the BGZF file (blocks compressed by a thread pool) and
its ``.tbi`` once under ``.bench_cache/``; the index's bins, chunks and
16 kb linear index are computed with numpy from each record's virtual
offsets, as ``exon_tpu.io.index_build.TabixBuilder`` would build them
record by record. ``vcf_records`` returns the fields a check needs, so
queries can be verified without decoding the file.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .bam_fixture import _reg2bin
from .gff_fixture import SEQ_WEIGHTS, SEQNAMES

VCF_RECORDS = 25_000_000
SEED = 7
MAX_POS = 248_000_000
INDEL_FRACTION = 0.10
NULL_QUAL_FRACTION = 0.01
_BLOCK = 0xFF00
_CHUNK = 500_000  # records formatted per task
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BASES = np.frombuffer(b"ACGT", np.uint8)


def _header() -> bytes:
    return (b"##fileformat=VCFv4.2\n"
            + b"".join(b"##contig=<ID=%s,length=%d>\n" % (s.encode(), MAX_POS)
                       for s in SEQNAMES)
            + b'##INFO=<ID=DP,Number=1,Type=Integer,Description="depth">\n'
            b'##INFO=<ID=AF,Number=1,Type=Float,Description="freq">\n'
            b'##INFO=<ID=RS,Number=1,Type=Integer,Description="rsid">\n'
            b"#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n")


def vcf_records(n_records: int = VCF_RECORDS, seed: int = SEED) -> dict:
    """The records in file order: ``chrom`` (codes into SEQNAMES), ``pos``
    (1-based), ``ref_offsets``/``ref_values`` (REF bytes), ``qual``
    (float32) and ``qual_valid`` (False for ``.``)."""
    rng = np.random.default_rng(seed)
    counts = rng.multinomial(n_records, SEQ_WEIGHTS / SEQ_WEIGHTS.sum())
    chrom = np.repeat(np.arange(len(SEQNAMES), dtype=np.int64), counts)
    key = np.sort((chrom << 32) | rng.integers(1, MAX_POS, n_records))
    ref_len = np.where(rng.random(n_records) < INDEL_FRACTION,
                       rng.integers(2, 13, n_records), 1)
    ref_offsets = np.zeros(n_records + 1, np.int64)
    np.cumsum(ref_len, out=ref_offsets[1:])
    return {"chrom": chrom.astype(np.int8), "pos": key & 0xFFFFFFFF,
            "ref_offsets": ref_offsets,
            "ref_values": _BASES[rng.integers(0, 4, int(ref_offsets[-1]))],
            "qual": rng.integers(10, 4000, n_records).astype(np.float32),
            "qual_valid": rng.random(n_records) >= NULL_QUAL_FRACTION}


# ---------------------------------------------------------------------------
# Text
# ---------------------------------------------------------------------------


def _ndigits(v: np.ndarray) -> np.ndarray:
    d = np.ones(len(v), np.int64)
    p = 10
    top = int(v.max()) if len(v) else 0
    while p <= top:
        d += v >= p
        p *= 10
    return d


_PAD = 0xFF  # never in the text


def _rows(fields: list, m: int) -> tuple[np.ndarray, np.ndarray]:
    """m rows of text assembled field by field, and their offsets. Each
    field takes the columns of its widest value in a [width, m] byte
    matrix (one contiguous row of it per column of text), the unused ones
    holding ``_PAD``; transposed, the matrix less its pad bytes is the
    text. A field is a constant, ("int", digits, values) or ("bytes",
    lengths, flat, starts)."""
    widths = [len(f) if isinstance(f, bytes) else int(f[1].max())
              for f in fields]
    cols = np.empty((sum(widths), m), np.uint8)
    lens = np.zeros(m, np.int64)
    c = 0
    for f, w in zip(fields, widths):
        if isinstance(f, bytes):
            cols[c:c + w] = np.frombuffer(f, np.uint8)[:, None]
            lens += w
        elif f[0] == "int":     # n decimal digits, right-aligned
            _kind, n, q = f
            for k in range(w):
                q, d = np.divmod(q, 10)
                cols[c + w - 1 - k] = np.where(n > k, d + 48, _PAD)
            lens += n
        else:                   # n bytes of flat from each start
            _kind, n, flat, starts = f
            last = max(len(flat) - 1, 0)
            for k in range(w):
                cols[c + k] = np.where(
                    n > k, flat[np.minimum(starts + k, last)], _PAD)
            lens += n
        c += w
    mat = np.ascontiguousarray(cols.T)
    offs = np.zeros(m + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    return mat[mat != _PAD], offs


def _int(v: np.ndarray, width: int = 0) -> tuple:
    n = _ndigits(v) if not width else np.full(len(v), width, np.int64)
    return ("int", n, v)


def _text(r: dict, lo: int, hi: int, seed: int) -> tuple[bytes, np.ndarray]:
    """Records lo..hi as VCF text and their start offsets in it."""
    m = hi - lo
    rng = np.random.default_rng([seed, lo])
    names = [s.encode() for s in SEQNAMES]
    name_flat = np.frombuffer(b"".join(names), np.uint8)
    name_starts = np.cumsum([0] + [len(s) for s in names])[:-1]
    code = r["chrom"][lo:hi].astype(np.int64)
    ro = r["ref_offsets"][lo:hi + 1]
    ref_len = np.diff(ro)
    ref_starts = ro[:-1] - ro[0]
    ref_flat = r["ref_values"][ro[0]:ro[-1]]
    snv_alt = _BASES[rng.integers(0, 4, m)]
    # an indel's ALT is its REF's first base
    alt = np.where(ref_len > 1, ref_flat[ref_starts], snv_alt)
    qual = r["qual"][lo:hi].astype(np.int64)
    qual_ok = r["qual_valid"][lo:hi]
    rs = rng.integers(10**7, 10**9, m)
    an = rng.integers(2, 5008, m)
    bq = rng.integers(-3000, 3000, (2, m))
    qual_field = ("int", np.where(qual_ok, _ndigits(qual), 0), qual)
    dot = ("bytes", (~qual_ok).astype(np.int64), np.frombuffer(b".", np.uint8),
           np.zeros(m, np.int64))
    fields = [("bytes", np.asarray([len(s) for s in names])[code], name_flat,
               name_starts[code]),
              b"\t", _int(r["pos"][lo:hi]), b"\trs", _int(rs), b"\t",
              ("bytes", ref_len, ref_flat, ref_starts), b"\t",
              ("bytes", np.ones(m, np.int64), alt, np.arange(m)), b"\t",
              qual_field, dot, b"\tPASS\tDP=", _int(rng.integers(1, 9000, m)),
              b";AF=0.", _int(rng.integers(0, 10_000_000, m), 7), b";RS=",
              _int(rs), b";AN=", _int(an), b";AC=", _int(an // 2), b";MQ=",
              _int(rng.integers(20, 60, m))]
    for label, v in ((b";BaseQRankSum=", bq[0]), (b";MQRankSum=", bq[1])):
        a = np.abs(v)
        fields += [label, ("bytes", (v < 0).astype(np.int64),
                           np.frombuffer(b"-", np.uint8), np.zeros(m, np.int64)),
                   _int(a // 1000), b".", _int(a % 1000, 3)]
    fields.append(b"\n")
    buf, offs = _rows(fields, m)
    return buf.tobytes(), offs[:-1]


# ---------------------------------------------------------------------------
# BGZF and the tabix index
# ---------------------------------------------------------------------------


def _bgzf_block(chunk: bytes) -> bytes:
    co = zlib.compressobj(4, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + struct.pack("<H", 6)
              + b"BC" + struct.pack("<H", 2)
              + struct.pack("<H", len(cdata) + 25))
    return header + cdata + struct.pack("<II", zlib.crc32(chunk), len(chunk))


def tabix_index(names: list, ref: np.ndarray, beg: np.ndarray,
                end: np.ndarray, vstart: np.ndarray, vend: np.ndarray
                ) -> bytes:
    """A .tbi (VCF preset) for coordinate-sorted records, given each
    record's reference id, 0-based [beg, end) and virtual offsets, with the
    bins, chunks and linear index ``TabixBuilder`` builds record by record:
    a chunk is a run of consecutive records of one bin; interval i of the
    linear index holds the least offset of the records that overlap 16 kb
    window i, and an empty window takes the one before it."""
    raw = [b"TBI\x01"]
    blob = b"".join(n.encode() + b"\x00" for n in names)
    raw.append(struct.pack("<8i", len(names), 2, 1, 2, 0, ord("#"), 0,
                           len(blob)))
    raw.append(blob)
    bins = _reg2bin(beg, end)
    bounds = np.searchsorted(ref, np.arange(len(names) + 1))
    for rid in range(len(names)):
        lo, hi = bounds[rid], bounds[rid + 1]
        raw.append(_ref_index(bins[lo:hi], beg[lo:hi], end[lo:hi],
                              vstart[lo:hi], vend[lo:hi]))
    return b"".join(raw)


def _ref_index(bins, beg, end, vstart, vend) -> bytes:
    n = len(bins)
    if n == 0:
        return struct.pack("<ii", 0, 0)
    run = np.flatnonzero(np.diff(bins)) + 1
    first = np.concatenate([[0], run])
    last = np.concatenate([run, [n]]) - 1
    order = np.lexsort((first, bins[first]))   # by bin, then file order
    cbin, cvs, cve = bins[first][order], vstart[first][order], vend[last][order]
    ubin, start, count = np.unique(cbin, return_index=True, return_counts=True)
    head = np.zeros(len(ubin), np.dtype([("bin", "<u4"), ("n", "<i4")]))
    head["bin"], head["n"] = ubin, count
    pairs = np.stack([cvs, cve], axis=1).astype("<u8")
    sizes = 8 + 16 * count
    at = np.zeros(len(ubin) + 1, np.int64)
    np.cumsum(sizes, out=at[1:])
    out = np.empty(int(at[-1]), np.uint8)
    out[at[:-1, None] + np.arange(8)] = head.view(np.uint8).reshape(-1, 8)
    rank = np.arange(len(cbin)) - np.repeat(start, count)
    chunk_at = np.repeat(at[:-1] + 8, count) + 16 * rank
    out[chunk_at[:, None] + np.arange(16)] = pairs.view(np.uint8).reshape(-1, 16)
    w_lo, w_hi = beg >> 14, np.maximum(end - 1, beg) >> 14
    sentinel = np.iinfo(np.uint64).max
    iv = np.full(int(w_hi.max()) + 1, sentinel, np.uint64)
    np.minimum.at(iv, w_lo, vstart.astype(np.uint64))
    np.minimum.at(iv, w_hi, vstart.astype(np.uint64))
    have = iv != sentinel
    # an empty window takes the offset of the window before it (0 at first)
    idx = np.maximum.accumulate(np.where(have, np.arange(len(iv)), -1))
    iv = np.where(idx >= 0, iv[np.maximum(idx, 0)], 0).astype("<u8")
    return (struct.pack("<i", len(ubin)) + out.tobytes()
            + struct.pack("<i", len(iv)) + iv.tobytes())


def make_vcf(n_records: int = VCF_RECORDS, seed: int = SEED,
             path: str | None = None) -> str:
    """Write the fixture and its ``.tbi`` (once) and return the VCF's
    path."""
    if path is None:
        cache = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".bench_cache")
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"genome_{n_records}_{seed}.vcf.gz")
    tbi = path + ".tbi"
    if all(os.path.exists(p) and os.path.getsize(p) > 0 for p in (path, tbi)):
        return path
    r = vcf_records(n_records, seed)
    header = _header()
    starts = np.empty(n_records, np.int64)
    csizes: list = []
    pending, done = header, len(header)
    with open(path + ".tmp", "wb") as out, \
            ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:

        def flush(data: bytes) -> None:
            blocks = list(pool.map(_bgzf_block, [
                data[i:i + _BLOCK] for i in range(0, len(data), _BLOCK)]))
            csizes.extend(len(b) for b in blocks)
            out.write(b"".join(blocks))

        los = list(range(0, n_records, _CHUNK))
        for wave in range(0, len(los), 8):
            texts = pool.map(lambda lo: _text(r, lo, min(lo + _CHUNK,
                                                         n_records), seed),
                             los[wave:wave + 8])
            for lo, (text, offs) in zip(los[wave:wave + 8], texts):
                starts[lo:lo + len(offs)] = done + offs
                done += len(text)
                pending += text
                cut = len(pending) // _BLOCK * _BLOCK
                flush(pending[:cut])
                pending = pending[cut:]
        flush(pending)
        out.write(_BGZF_EOF)
    coff = np.zeros(len(csizes) + 1, np.int64)
    np.cumsum(csizes, out=coff[1:])

    def vpos(u: np.ndarray) -> np.ndarray:
        # a record that ends its block's data ends at the next block's
        # start, the last block's included
        return np.where(u == done, coff[-1] << 16,
                        (coff[u // _BLOCK] << 16) | (u % _BLOCK))

    ends = np.append(starts[1:], done)
    beg = r["pos"] - 1
    index = tabix_index(
        [s for s, c in zip(SEQNAMES, np.bincount(r["chrom"], minlength=len(
            SEQNAMES))) if c],
        np.unique(r["chrom"], return_inverse=True)[1], beg,
        beg + np.diff(r["ref_offsets"]), vpos(starts), vpos(ends))
    with open(tbi + ".tmp", "wb") as f:
        f.write(b"".join(_bgzf_block(index[i:i + _BLOCK])
                         for i in range(0, len(index), _BLOCK)) + _BGZF_EOF)
    os.replace(path + ".tmp", path)
    os.replace(tbi + ".tmp", tbi)
    return path
