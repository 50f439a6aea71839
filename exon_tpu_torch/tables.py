"""Table providers over the port's decoders.

Counterpart of ``FileTable.scan`` (exon_tpu/tables.py:181-288) for FASTA,
FASTQ, GFF, mzML and BAM (without the .bai region pruning of
exon_tpu/providers.py ``BamTable``), and of ``VcfTable``
(exon_tpu/providers.py:43-131), the VCF table with tabix region pushdown.
As in the JAX package (tables.py:212-217), a format with a device decoder
(FASTA, FASTQ) is decoded on the session's device unless
``EXON_TPU_HOST_DECODE`` is set, and its batches pass through the
``ScanExec`` as they come; the other formats decode on the host and the
``ScanExec`` moves their batches to the device. A ``FileTable`` takes no
filter (prefix-LIKE pushdown, tables.py:163-169, is not ported), so every
predicate on it runs as a device operator; a ``VcfTable`` takes the
region-filter markers. A ``MemTable`` holds host batches: the tables of
SQL ``CREATE TABLE``, ``INSERT`` and ``VALUES`` and Arrow tables given to
``ExonSession.register_table`` (exon_tpu/sql/frontend.py ``MemTable``,
:150-180, which holds a pyarrow Table).
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from .batch import Batch, Schema, concat_host, take_host
from .errors import InvalidRegionError
from .formats import bam, fasta, fasta_device, fastq, gff, mzml, vcf
from .indexes import parse_tabix
from .io import (coalesce_chunks, read_bgzf_chunk, read_file,
                 resolve_table_files)
from .parallel.mesh import iter_scan_files
from .plan import regions as R
from .plan.expressions import BinaryOp, Expr, col
from .plan.physical import FilterExec, PhysicalPlan, ProjectExec, ScanExec


@dataclasses.dataclass
class FormatSpec:
    name: str
    schema: Callable          # (options) -> Schema
    decode: Callable          # (bytes, options, projection) -> Iterator[Batch]
    default_options: Callable  # () -> options
    # (bytes, options, projection, device) -> Iterator[Batch] on the device
    device_decode: Optional[Callable] = None


FORMATS = {
    # exon_tpu/tables.py:516-536
    "FASTA": FormatSpec("FASTA", fasta.fasta_schema, fasta.decode_host,
                        fasta.FastaOptions, fasta_device.decode_fasta_device),
    "FASTQ": FormatSpec("FASTQ", fastq.fastq_schema, fastq.decode_host,
                        fastq.FastqOptions, fastq.decode_device),
    "GFF": FormatSpec("GFF", gff.gff_schema, gff.decode_host, gff.GffOptions),
    # exon_tpu/tables.py:642-656
    "BAM": FormatSpec("BAM", bam.bam_schema, bam.decode_host, bam.BamOptions),
    # exon_tpu/tables.py:567-575; scanned by VcfTable
    "VCF": FormatSpec("VCF", vcf.vcf_schema, vcf.decode_host, vcf.VcfOptions),
    # exon_tpu/tables.py:618-625
    "MZML": FormatSpec("MZML", mzml.mzml_schema, mzml.decode_host,
                       mzml.MzmlOptions),
}


# STORED AS aliases → (format, default file extension)
# (exon_tpu/tables.py:486)
FORMAT_ALIASES = {"FA": ("FASTA", ".fa"), "FAA": ("FASTA", ".faa"),
                  "FNA": ("FASTA", ".fna"), "FQ": ("FASTQ", ".fq")}


def alias_extension(name: str):
    """Default file extension for a STORED AS alias, or None."""
    entry = FORMAT_ALIASES.get(name.upper())
    return entry[1] if entry else None


def get_format(name: str) -> FormatSpec:
    key = name.upper()
    spec = FORMATS.get(FORMAT_ALIASES.get(key, (key,))[0])
    if spec is None:
        raise NotImplementedError(
            f"format {name!r} is not ported yet (ROADMAP Queue 1, item 2: "
            f"other decoders); ported: {sorted(FORMATS)}")
    return spec


@dataclasses.dataclass
class FileTable:
    """Listing table over local files decoded by one format module."""

    url: str
    fmt: FormatSpec
    options: object
    # the scan decodes iter_scan_files(files): a process's own files in a
    # multi-process run (exon_tpu/providers.py:47)
    shards_files = True

    def schema(self) -> Schema:
        return self.fmt.schema(self.options)

    def supports_filter_pushdown(self, expr: Expr) -> str:
        return "none"

    def scan(self, projection: Optional[list[str]] = None,
             filters: Sequence[Expr] = (), device="cpu") -> ScanExec:
        if filters:
            raise NotImplementedError("scan filter pushdown is not ported")
        schema = self.schema()
        if projection is not None:
            schema = schema.project(projection)
        files = resolve_table_files(self.url,
                                    getattr(self.options, "file_extension",
                                            None))
        fmt, options = self.fmt, self.options
        use_device = (fmt.device_decode is not None
                      and not os.environ.get("EXON_TPU_HOST_DECODE"))

        def source() -> Iterator[Batch]:
            for path in iter_scan_files(files):
                if use_device:
                    yield from fmt.device_decode(read_file(path), options,
                                                 projection, device)
                else:
                    yield from fmt.decode(read_file(path), options,
                                          projection)

        return ScanExec(schema, source, device, to_device=not use_device)


@dataclasses.dataclass
class BamTable(FileTable):
    """A BAM FileTable whose parse_tags schema holds the first record's
    tags (exon_tpu/providers.py ``BamTable.schema``, :159-172); the .bai
    region pruning is not ported (ROADMAP Queue 1, item 2c)."""

    def schema(self) -> Schema:
        if not getattr(self.options, "parse_tags", False):
            return bam.bam_schema(self.options)
        files = resolve_table_files(self.url, self.options.file_extension)
        data = bam.inflate(read_file(files[0]))
        header = bam.parse_bam_header(data)
        return bam.bam_schema(self.options,
                              bam.tag_fields_of(data, header, self.options))


def make_provider(url: str, spec: FormatSpec, options):
    """The table provider of a format: VCF has its own, with region
    pushdown (exon_tpu/providers.py:341-348), and BAM a schema that reads
    the file in parse_tags mode; the others are FileTables."""
    if spec.name == "VCF":
        return VcfTable(url, options)
    if spec.name == "BAM":
        return BamTable(url, spec, options)
    return FileTable(url, spec, options)


@dataclasses.dataclass
class VcfTable:
    """VCF listing table with tabix region pruning
    (exon_tpu/providers.py ``VcfTable``, :43-131;
    exon-core/src/datasources/vcf/table_provider.rs).

    Region markers are Exact filters. With a ``.tbi`` beside a gzip or
    BGZF file, each region seeks through the index, inflates only its
    chunks and keeps the rows of the region (the exact host row filter).
    A row that lies in several of the scan's regions is read once, under
    the first of them, and every chunk is decoded with the file's header;
    the JAX package reads such a row once per region and decodes a chunk
    without the header (ROADMAP Queue 3, F15). Without a ``.tbi`` the
    whole file is decoded and a residual ``FilterExec`` keeps the rows of
    any region, with ``chrom`` and ``pos`` added to the scan's projection
    and projected away after.
    """

    url: str
    options: object
    shards_files = True  # exon_tpu/providers.py:113

    def schema(self) -> Schema:
        if getattr(self.options, "parse_info", False) or \
                getattr(self.options, "parse_formats", False):
            header = vcf.parse_header_only(_header_prefix(self.files()[0]))
            return vcf.vcf_schema(self.options, header)
        return vcf.vcf_schema(self.options)

    def supports_filter_pushdown(self, expr: Expr) -> str:
        return "exact" if R.is_region_filter(expr) else "none"

    def files(self) -> list[str]:
        return resolve_table_files(
            self.url, getattr(self.options, "file_extension", ".vcf"))

    def scan(self, projection: Optional[list[str]] = None,
             filters: Sequence[Expr] = (), device="cpu") -> PhysicalPlan:
        regions = R.infer_regions_from_filters(filters)
        options = self.options
        if getattr(options, "regions", None):
            regions = list(options.regions) + regions
        if getattr(options, "indexed", False) and not regions:
            raise InvalidRegionError(
                "An indexed VCF table type requires a region filter. "
                "See the 'vcf_region_filter' function.")
        schema = self.schema()
        proj = list(projection) if projection is not None else schema.names
        files = self.files()
        indexed = {path: path.lower().endswith((".gz", ".bgz"))
                   and os.path.exists(path + ".tbi") for path in files}
        # indexed chunks are row-filtered exactly on the host; only the
        # unindexed fallback needs chrom/pos in the scan for a residual
        # FilterExec
        all_indexed = bool(regions) and all(indexed.values())
        scan_proj = list(proj)
        if regions and not all_indexed:
            scan_proj += [c for c in ("chrom", "pos") if c not in scan_proj]

        def source() -> Iterator[Batch]:
            for path in iter_scan_files(files):
                if regions and indexed[path]:
                    yield from _indexed_batches(path, regions, options,
                                                scan_proj)
                else:
                    yield from vcf.decode_host(read_file(path), options,
                                               scan_proj)

        plan: PhysicalPlan = ScanExec(schema.project(scan_proj), source,
                                      device)
        if regions and not all_indexed:
            pred = R.region_to_point_expr(regions[0], "chrom", "pos")
            for r in regions[1:]:
                pred = BinaryOp("or", pred,
                                R.region_to_point_expr(r, "chrom", "pos"))
            plan = FilterExec(pred, plan)
            if scan_proj != proj and proj:
                plan = ProjectExec([col(n) for n in proj],
                                   schema.project(proj), plan)
        return plan


def _indexed_batches(path: str, regions: list, options,
                     projection: list[str]) -> Iterator[Batch]:
    """The rows of each region through the tabix index: its chunks
    coalesced, range-read and inflated, then the exact row filter, which
    also drops a row inside an earlier region of the list. Each chunk is
    decoded with the file's header, as the whole file would be."""
    with open(path + ".tbi", "rb") as f:
        tbi = parse_tabix(f.read())
    size = os.path.getsize(path)
    header = vcf.parse_header_only(_header_prefix(path))
    for i, region in enumerate(regions):
        earlier = [r for r in regions[:i] if r.name == region.name]
        for chunk in coalesce_chunks(tbi.query(region)):
            yield from vcf.decode_host(read_bgzf_chunk(path, chunk, size),
                                       options, projection,
                                       with_header=header, region=region,
                                       exclude=earlier)


def _header_prefix(path: str) -> bytes:
    """The file's leading '#' lines, inflating only as much of a gzip or
    BGZF file as they need (exon_tpu/providers.py:351-374): the schema
    pass must not inflate a multi-GB file."""
    d = zlib.decompressobj(31) if path.lower().endswith((".gz", ".bgz")) \
        else None
    buf = bytearray()
    with open(path, "rb") as f:
        while not _past_header(buf) and len(buf) <= (256 << 20):
            raw = f.read(1 << 20)
            if not raw:
                break
            if d is None:
                buf += raw
                continue
            while raw:  # one gzip member after another
                buf += d.decompress(raw)
                if not d.eof:
                    break
                raw = d.unused_data
                d = zlib.decompressobj(31)
    return bytes(buf)


def _past_header(buf: bytearray) -> bool:
    """Whether ``buf`` holds a whole line that does not start with '#'."""
    start = 0
    while True:
        nl = buf.find(b"\n", start)
        if nl < 0:
            return False
        if buf[start:start + 1] != b"#":
            return True
        start = nl + 1


MEM_BATCH_ROWS = 8192  # a MemTable scan's batch (frontend.py:172)


@dataclasses.dataclass
class MemTable:
    """An in-memory table of host batches. Its scan moves them to the
    device in batches of at most ``MEM_BATCH_ROWS`` rows. It does not split
    its rows per process (no ``shards_files``), so in a multi-process run
    every operator over it runs on each process's single device, as in the
    JAX package."""

    out_schema: Schema
    parts: list  # host Batches of out_schema

    @staticmethod
    def from_arrow(table) -> "MemTable":
        """A pyarrow Table's rows; dictionary columns decoded to strings."""
        import pyarrow as pa

        from .batch import schema_from_arrow

        for i, f in enumerate(table.schema):
            if pa.types.is_dictionary(f.type):
                table = table.set_column(i, f.name, table.column(i).cast(
                    f.type.value_type))
        schema = schema_from_arrow(table.schema)
        return MemTable(schema, [Batch.from_arrow(rb, schema)
                                 for rb in table.to_batches()
                                 if rb.num_rows])

    def schema(self) -> Schema:
        return self.out_schema

    def supports_filter_pushdown(self, expr: Expr) -> str:
        return "none"

    def insert(self, batch: Batch) -> None:
        """Append a host batch of the table's schema."""
        if batch.length:
            self.parts.append(Batch(self.out_schema, batch.columns,
                                    batch.length))

    def scan(self, projection: Optional[list[str]] = None,
             filters: Sequence[Expr] = (), device="cpu") -> ScanExec:
        if filters:
            raise NotImplementedError("scan filter pushdown is not ported")
        names = self.out_schema.names if projection is None else projection
        schema = self.out_schema.project(list(names))
        parts = list(self.parts)

        def source() -> Iterator[Batch]:
            if not parts:
                return
            whole = concat_host(self.out_schema, parts).project(list(names))
            for lo in range(0, whole.length, MEM_BATCH_ROWS):
                yield take_host(whole, np.arange(
                    lo, min(lo + MEM_BATCH_ROWS, whole.length)))

        return ScanExec(schema, source, device)
