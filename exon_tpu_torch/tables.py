"""Table providers over the port's decoders.

Counterpart of ``FileTable.scan`` (exon_tpu/tables.py:181-288) for FASTA,
FASTQ, GFF and BAM (without the .bai region pruning of
exon_tpu/providers.py ``BamTable``: no filter is pushed into a scan). As in
the JAX package (tables.py:212-217), a format with a device decoder (FASTA,
FASTQ) is decoded on the session's device unless ``EXON_TPU_HOST_DECODE``
is set, and its batches pass through the ``ScanExec`` as they come; the
other formats decode on the host and the ``ScanExec`` moves their batches
to the device. No filter is pushed into the scan (prefix-LIKE pushdown,
tables.py:163-169, is not ported), so every predicate runs as a device
operator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional, Sequence

from .batch import Batch, Schema
from .formats import bam, fasta, fasta_device, fastq, gff
from .io import read_file, resolve_table_files
from .plan.expressions import Expr
from .plan.physical import ScanExec


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
            for path in files:
                if use_device:
                    yield from fmt.device_decode(read_file(path), options,
                                                 projection, device)
                else:
                    yield from fmt.decode(read_file(path), options,
                                          projection)

        return ScanExec(schema, source, device, to_device=not use_device)
