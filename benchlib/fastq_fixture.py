"""Synthetic Illumina FASTQ fixture (numpy only).

The shape of one lane's worth of a 150 bp Illumina run, read by an adapter
screen:

  * 4,000,000 reads of 150 bp (about 1.4 GB of text), Phred+33 qualities
    ('!'..'J', 0..41), random bases;
  * headers ``@A00123:8:H2KJ3DSXX:<lane>:<tile>:<x>:<read> 1:N:0:<barcode>``;
    10 % of them carry no description (the name alone, as after a
    ``cut -d' ' -f1`` clean-up);
  * 5 % of the reads hold the TruSeq adapter prefix ``AGATCGGAAGAGC`` at a
    random position (a read-through into the adapter).

``fastq_reads`` returns the reads' fields as arrays, so checks need no
decode; ``make_fastq`` writes the file once under ``.bench_cache/``.
"""

from __future__ import annotations

import os

import numpy as np

N_READS = 4_000_000
READ_LEN = 150
ADAPTER = b"AGATCGGAAGAGC"
ADAPTER_FRACTION = 0.05
NO_DESC_FRACTION = 0.10
BARCODES = (b"ATCACG", b"CGATGT", b"TTAGGC", b"TGACCA")
_TAIL = 1 + READ_LEN + 3 + READ_LEN + 1  # "\n" seq "\n+\n" qual "\n"


def fastq_reads(n_reads: int = N_READS, seed: int = 17) -> dict:
    """The reads in file order: ``names`` and ``descriptions`` (numpy bytes
    arrays), ``has_desc`` (bool), ``sequences`` and ``qualities`` (uint8
    ``[n, 150]``) and ``adapter_at`` (the planted adapter's offset, or -1)."""
    rng = np.random.default_rng(seed)
    lane = rng.integers(1, 5, n_reads).tolist()
    tile = rng.integers(1101, 2679, n_reads).tolist()
    x = rng.integers(1000, 32001, n_reads).tolist()
    names = np.asarray([b"A00123:8:H2KJ3DSXX:%d:%d:%d:%d" % t for t in
                        zip(lane, tile, x, range(1, n_reads + 1))])
    descs = np.asarray([b"1:N:0:" + b for b in BARCODES])[
        rng.integers(0, len(BARCODES), n_reads)]
    has_desc = rng.random(n_reads) >= NO_DESC_FRACTION
    seq = np.frombuffer(b"ACGT", np.uint8)[
        rng.integers(0, 4, (n_reads, READ_LEN), dtype=np.uint8)]
    at = np.where(rng.random(n_reads) < ADAPTER_FRACTION,
                  rng.integers(0, READ_LEN - len(ADAPTER) + 1, n_reads), -1)
    rows = np.flatnonzero(at >= 0)
    seq[rows[:, None], at[rows, None] + np.arange(len(ADAPTER))] = \
        np.frombuffer(ADAPTER, np.uint8)
    qual = rng.integers(33, 75, (n_reads, READ_LEN), dtype=np.uint8)
    return {"names": names, "descriptions": descs, "has_desc": has_desc,
            "sequences": seq, "qualities": qual, "adapter_at": at}


def headers(r: dict, lo: int, hi: int) -> list[bytes]:
    """The header lines of reads lo..hi, without '@' and the newline."""
    return [n + b" " + d if h else n for n, d, h in
            zip(r["names"][lo:hi].tolist(), r["descriptions"][lo:hi].tolist(),
                r["has_desc"][lo:hi].tolist())]


def _records(r: dict, lo: int, hi: int) -> bytes:
    """Reads lo..hi of ``fastq_reads`` as FASTQ text."""
    m = hi - lo
    hdr = [b"@" + h for h in headers(r, lo, hi)]
    hlen = np.fromiter(map(len, hdr), np.int64, m)
    offs = np.zeros(m + 1, np.int64)
    np.cumsum(hlen + _TAIL, out=offs[1:])
    buf = np.empty(int(offs[-1]), np.uint8)
    flat = np.frombuffer(b"".join(hdr), np.uint8)
    buf[np.repeat(offs[:-1] - (np.cumsum(hlen) - hlen), hlen)
        + np.arange(len(flat))] = flat
    tail = np.empty((m, _TAIL), np.uint8)
    tail[:, 0] = ord("\n")
    tail[:, 1:1 + READ_LEN] = r["sequences"][lo:hi]
    tail[:, 1 + READ_LEN:4 + READ_LEN] = np.frombuffer(b"\n+\n", np.uint8)
    tail[:, 4 + READ_LEN:4 + 2 * READ_LEN] = r["qualities"][lo:hi]
    tail[:, -1] = ord("\n")
    buf[(offs[:-1] + hlen)[:, None] + np.arange(_TAIL)] = tail
    return buf.tobytes()


def make_fastq(n_reads: int = N_READS, seed: int = 17,
               path: str | None = None) -> str:
    """Write the fixture (once) and return its path."""
    if path is None:
        cache = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".bench_cache")
        os.makedirs(cache, exist_ok=True)
        path = os.path.join(cache, f"reads_{n_reads}_{seed}.fastq")
    if os.path.exists(path) and os.path.getsize(path) > 0:
        return path
    r = fastq_reads(n_reads, seed)
    with open(path + ".tmp", "wb") as out:
        for lo in range(0, n_reads, 200_000):
            out.write(_records(r, lo, min(lo + 200_000, n_reads)))
    os.replace(path + ".tmp", path)
    return path


def adapter_rows(r: dict) -> np.ndarray:
    """Rows whose sequence contains ``ADAPTER`` anywhere (planted or by
    chance), found by a byte search over the sequences."""
    n = len(r["sequences"])
    lines = np.empty((n, READ_LEN + 1), np.uint8)
    lines[:, :READ_LEN] = r["sequences"]
    lines[:, READ_LEN] = ord("\n")  # no match spans two reads
    blob = lines.tobytes()
    rows, pos = [], blob.find(ADAPTER)
    while pos != -1:
        row = pos // (READ_LEN + 1)
        rows.append(row)
        pos = blob.find(ADAPTER, (row + 1) * (READ_LEN + 1))
    return np.asarray(rows, np.int64)
