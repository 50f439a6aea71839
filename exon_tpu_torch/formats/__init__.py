"""Decoders of the formats the port scans: numpy host decoders (FASTA,
FASTQ, GFF, BAM) and device decoders (FASTA, FASTQ)."""
