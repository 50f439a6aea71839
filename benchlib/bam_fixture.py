"""Synthetic paired-end BAM fixture (numpy + zlib only).

The shape of a whole-genome paired-end Illumina run after a per-read MAPQ
filter, coordinate-sorted, at the record count of
``benchlib.fixtures.BAM_RECORDS`` (a ~300 MB BAM):

  * 1,425,000 templates; 1 % are orphans whose R2 is absent, which leaves
    2,835,750 records;
  * ``@SQ`` lines for ``gff_fixture.SEQNAMES`` in that order, each
    ``LN:250000000``; templates are placed on them by
    ``gff_fixture.SEQ_WEIGHTS``, R1 starts uniform in [1, 247,999,000) (the
    GFF fixture's coordinate range), R2 200-600 bp after R1;
  * 100 bp reads, CIGAR ``100M``, MAPQ 60, flags 99 / 147 (73 for an
    orphan R1), random bases and qualities;
  * Illumina-style names ``A00123:8:H2KJ3DSXX:<lane>:<tile>:<x>:<template>``
    of about 38 bytes, unique per template.

``bam_reads`` returns the records' fields as arrays in file order, so checks
need no decode; ``make_bam`` writes the BGZF file once under
``.bench_cache/``.
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .fixtures import _bam_header
from .gff_fixture import SEQ_WEIGHTS, SEQNAMES

N_TEMPLATES = 1_425_000
ORPHAN_FRACTION = 0.01
READ_LEN = 100
REF_LEN = 250_000_000
MAX_START = 247_999_000
MAPQ = 60
FLAG_R1, FLAG_R2, FLAG_ORPHAN = 99, 147, 73
_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
_BLOCK = 0xFF00
_HEADER = np.dtype([("block_size", "<i4"), ("ref_id", "<i4"), ("pos", "<i4"),
                    ("l_read_name", "u1"), ("mapq", "u1"), ("bin", "<u2"),
                    ("n_cigar", "<u2"), ("flag", "<u2"), ("l_seq", "<i4"),
                    ("next_ref_id", "<i4"), ("next_pos", "<i4"),
                    ("tlen", "<i4")])


def template_names(n_templates: int = N_TEMPLATES, seed: int = 13
                   ) -> np.ndarray:
    """The read name of every template, as a numpy bytes array."""
    rng = np.random.default_rng([seed, 1])
    lane = rng.integers(1, 5, n_templates).tolist()
    tile = rng.integers(1101, 2679, n_templates).tolist()
    x = rng.integers(1000, 32001, n_templates).tolist()
    return np.asarray([b"A00123:8:H2KJ3DSXX:%d:%d:%d:%d" % t for t in
                       zip(lane, tile, x, range(1, n_templates + 1))])


def bam_reads(n_templates: int = N_TEMPLATES, seed: int = 13) -> dict:
    """The records in file order: ``reference`` (codes into SEQNAMES),
    ``start``/``end`` (1-based inclusive), ``flag``, ``template`` (row of
    ``template_names``), ``mate_start`` (-1 for an orphan R1) and
    ``names`` (per template)."""
    rng = np.random.default_rng(seed)
    ref = rng.choice(len(SEQNAMES), size=n_templates,
                     p=SEQ_WEIGHTS / SEQ_WEIGHTS.sum())
    r1 = rng.integers(1, MAX_START, size=n_templates)
    r2 = r1 + rng.integers(200, 601, size=n_templates)
    orphan = np.zeros(n_templates, bool)
    orphan[rng.choice(n_templates, int(n_templates * ORPHAN_FRACTION),
                      replace=False)] = True
    paired = np.flatnonzero(~orphan)
    template = np.concatenate([np.arange(n_templates), paired])
    is_r2 = np.concatenate([np.zeros(n_templates, bool),
                            np.ones(len(paired), bool)])
    start = np.where(is_r2, r2[template], r1[template])
    mate = np.where(is_r2, r1[template], np.where(orphan[template], -1,
                                                  r2[template]))
    flag = np.where(is_r2, FLAG_R2,
                    np.where(orphan[template], FLAG_ORPHAN, FLAG_R1))
    order = np.lexsort((is_r2, template, start, ref[template]))
    template, start = template[order], start[order]
    return {"reference": ref[template], "start": start.astype(np.int64),
            "end": (start + READ_LEN - 1).astype(np.int64),
            "flag": flag[order].astype(np.int32), "template": template,
            "mate_start": mate[order].astype(np.int64),
            "names": template_names(n_templates, seed)}


def _reg2bin(beg: np.ndarray, end: np.ndarray) -> np.ndarray:
    """SAM spec reg2bin for 0-based [beg, end)."""
    end = end - 1
    out = np.zeros(len(beg), np.int64)
    done = np.zeros(len(beg), bool)
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        m = ~done & ((beg >> shift) == (end >> shift))
        out[m] = base + (beg[m] >> shift)
        done |= m
    return out


def _records(r: dict, lo: int, hi: int, rng) -> bytes:
    """Records lo..hi of ``bam_reads`` as BAM bytes."""
    m = hi - lo
    tmpl = r["template"][lo:hi]
    names = r["names"][tmpl]
    name_len = np.char.str_len(names).astype(np.int64) + 1  # with the NUL
    tail = 4 + (READ_LEN + 1) // 2 + READ_LEN  # cigar, seq, qual
    size = _HEADER.itemsize + name_len + tail
    offs = np.zeros(m + 1, np.int64)
    np.cumsum(size, out=offs[1:])
    buf = np.zeros(int(offs[-1]), np.uint8)

    pos0 = r["start"][lo:hi] - 1
    mate = r["mate_start"][lo:hi]
    flag = r["flag"][lo:hi]
    orphan = mate < 0
    hdr = np.zeros(m, _HEADER)
    hdr["block_size"] = size - 4
    hdr["ref_id"] = r["reference"][lo:hi]
    hdr["pos"] = pos0
    hdr["l_read_name"] = name_len
    hdr["mapq"] = MAPQ
    hdr["bin"] = _reg2bin(pos0, pos0 + READ_LEN)
    hdr["n_cigar"] = 1
    hdr["flag"] = flag
    hdr["l_seq"] = READ_LEN
    hdr["next_ref_id"] = r["reference"][lo:hi]
    hdr["next_pos"] = np.where(orphan, pos0, mate - 1)
    span = np.abs(mate - r["start"][lo:hi]) + READ_LEN
    hdr["tlen"] = np.where(orphan, 0, np.where(flag == FLAG_R2, -span, span))
    h = np.arange(_HEADER.itemsize)
    buf[offs[:-1, None] + h] = hdr.view(np.uint8).reshape(m, -1)

    flat = np.frombuffer(b"\0".join(names.tolist()) + b"\0", np.uint8)
    name_at = np.repeat(offs[:-1] + _HEADER.itemsize, name_len) + \
        np.arange(len(flat)) - np.repeat(np.cumsum(name_len) - name_len,
                                         name_len)
    buf[name_at] = flat

    cigar = np.frombuffer(struct.pack("<I", READ_LEN << 4), np.uint8)
    bases = np.asarray([1, 2, 4, 8], np.uint8)[
        rng.integers(0, 4, (m, 2 * ((READ_LEN + 1) // 2)))]
    seq = (bases[:, 0::2] << 4) | bases[:, 1::2]
    qual = rng.integers(2, 42, (m, READ_LEN), dtype=np.uint8)
    body = np.concatenate([np.broadcast_to(cigar, (m, 4)), seq, qual], axis=1)
    tail_at = (offs[:-1] + _HEADER.itemsize + name_len)[:, None] + \
        np.arange(tail)
    buf[tail_at] = body
    return buf.tobytes()


def _bgzf_block(chunk: bytes) -> bytes:
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    cdata = co.compress(chunk) + co.flush()
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 + struct.pack("<H", 6)
              + b"BC" + struct.pack("<H", 2)
              + struct.pack("<H", len(cdata) + 25))
    return header + cdata + struct.pack("<II", zlib.crc32(chunk), len(chunk))


def make_bam(n_templates: int = N_TEMPLATES, seed: int = 13,
             path: str | None = None) -> str:
    """Write the fixture (once) as BGZF and return its path."""
    if path is None:
        cache = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".bench_cache")
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"paired_{n_templates}_{seed}.bam")
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    r = bam_reads(n_templates, seed)
    rng = np.random.default_rng([seed, 2])
    pending = _bam_header(list(SEQNAMES), [REF_LEN] * len(SEQNAMES))
    n = len(r["start"])
    with open(path + ".tmp", "wb") as out, \
            ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:

        def flush(data: bytes) -> None:
            chunks = [data[i:i + _BLOCK] for i in range(0, len(data), _BLOCK)]
            out.write(b"".join(pool.map(_bgzf_block, chunks)))

        for lo in range(0, n, 200_000):
            pending += _records(r, lo, min(lo + 200_000, n), rng)
            cut = len(pending) // _BLOCK * _BLOCK
            flush(pending[:cut])
            pending = pending[cut:]
        flush(pending)
        out.write(_BGZF_EOF)
    os.replace(path + ".tmp", path)
    return path
