"""Smoke run of exon_tpu_torch on one CUDA card: build, kernels, main path.

Run from the repository root with no arguments:

    python3 chip_smoke.py

``--kernels hash_aggregate,list_bins,q_aggregate`` (any of them) runs
phases 1-2 and those cases alone; ``--tree DIR`` imports exon_tpu_torch and
benchlib from another checkout (an earlier commit, unpacked), so that two
versions are timed in one run on one card.

Phases, each printed on its own lines; any failure exits non-zero:

1. Device: the card's name and power limit (nvidia-smi), and whether jax
   and pyarrow are installed (informational: the port needs neither).
2. Build: compile the CUDA kernels from exon_tpu_torch/kernels/csrc.
3. Kernels vs twins: each kernel runs at the main path's shapes on inputs
   made from a numpy seed (the device-decode kernels on the first 128 MiB
   chunk of Query A's FASTA file) and is compared with its plain PyTorch
   twin run on the same card; median times of 20 CUDA-event-timed runs of
   each, of one PyTorch call that computes the same function where there is
   one, and the least time the card could take (bytes moved / 3.35 TB/s).
   The SQL kernels run at their queries' shapes: string_cmp over the ids of
   that first chunk, parse_number (int and float mode) and format_int over
   one 131,072-row batch of the GFF starts and ends as decimal text, and
   once more over all 3.4 M of them (printed apart). K7 and K14, left to
   PyTorch, are timed beside their bounds. The sequence UDF kernels run on
   the operands of the first batch of Queries F, G and H: sw_score against
   the adapter on the first FASTQ chunk the scan decodes (about 377,000
   reads of 150 bp; F's WHERE), on that chunk's reads that score >= 11
   (F's SELECT, printed apart) and read i against read i + 1, bounded by
   its int32 operations (8 per DP cell, the fewest with Hopper's DPX
   instructions, over the card's INT32 rate); count_bytes on one
   131,072-read BAM batch (G) and on the FASTQ chunk (H's filter);
   polya_tail on the chunk's GC-rich reads and map_bytes on their trimmed
   forms (H's projection), both also on the whole chunk, printed apart.
   hash_aggregate runs on Query I's first batch (the scan's batch after the
   tabix seek, keyed by chrom and ref, masked by qual >= 30) with the sum
   of squares and each row's slot, beside one index_add_ of x^2 at those
   slots, the library call for the sum-of-squares partial; then on the
   same batch with its live rows' keys dealt into equal groups (the
   control without hot slots) and on 25 int64 keys (printed apart), each
   with the kernel's own device time (torch.profiler) and the wrapper's
   host work beside the CUDA-event time. The SQL function kernels (K12) run at the
   shapes of queries J and K: span_concat on J's concat_ws (the kernels
   line) and lpad over the first decoded chunk of A (295,660 records);
   map_bytes on J's upper (beside table[values], the library call) and in
   its word-start mode on J's trimmed descriptions (initcap); polya_tail's
   leading space run on J's descriptions (trim) and trailing 'N' run on
   K's cut reads of the first FASTQ chunk (rtrim); like_match's position
   mode on K's strpos over that chunk; translate (on no query's path) at
   J's shape, beside table[values]. Batch.to_device is timed beside its
   bound over the host link. The window kernels (K10) run at Query L's
   shape, the panel's 1,008,303 rows concatenated on the card:
   window_bounds on the sorted key matrices of (chrom, pos) and (chrom,
   qual DESC), window_frame in every mode (L's four calls, the rest of the
   rank family, lead with a default, sum, avg and the value picks over L's
   ROWS frame, min over its RANGE frame through the sparse table).
   The list kernels (K11b) and the map lookup run at the shapes of queries
   N, O and P: map_bytes' widen mode (to int8 DNA codes and to int64 Phred
   scores) and narrow mode (the scores back to text) on the first FASTQ
   chunk of O's scan, beside table[values]; map_lookup on the attribute
   maps of N's first 131,072-row batch; list_bins' peak mode on P's 30,000
   spectra and its bins mode on the spectra that pass P's filter, beside
   one index_add_ (bins at relative 1e-12, the twin adding in atomic
   order), at 1,900 bins and, printed apart, at 30,000 (past a block's
   shared memory: the kernel's device-memory variant). bucket_pack (K13) runs at Query Q's shape once Q has run: the
   groups of Q's 8 shard tables after its scan, all their columns, in the
   exchange's one call for the card, to 8 destinations (every output equal
   to the twin's), beside a stable
   torch.sort of the destinations and index_select of the columns; and,
   printed apart, at D_part's pair exchange once D_part has run: the left
   side's (folded key, row id) pairs, int64 and int32, to 8 destinations in
   the exchange's two calls (count, then pack at the largest count), and
   the whole route with the exchange.
4. Main path, through ExonSession(device="cuda") on generated data at full
   scale: Query A (FASTA filter/project) and its count, both on the device
   decode, Query B (GFF filter → group-by), Query C (BAM reads ⋈ GFF genes
   on chromosome and 100 kb bin, overlap filter, coordinate sort), Query D (mate pairing: R1 ⟕ R2 on the read name,
   coordinate sort), and Query E (a FASTQ adapter screen, 4 M reads of
   150 bp) and its count, and three SQL queries through ExonSession.sql:
   SQL_count (Query count's filter as SQL), SQL_range (an accession-range
   pull of 100,000 FASTA records by ordered string compares) and SQL_gff
   (CREATE EXTERNAL TABLE, then exon counts and CAST round-trip sums of
   start and end per chromosome and CASE-mapped strand), and three queries
   through the sequence UDFs: F (SQL: the FASTQ reads whose
   alignment_score against the adapter is >= 11), G (SQL: per reference,
   the count and mean gc_content of R1 reads with a mapped mate, over the
   BAM) and H (DataFrame: the reverse complement of trim_polya of each
   GC-rich read), and BASELINE config 3 through ExonSession.sql on a
   25 M-record whole-genome BGZF VCF with its .tbi: Query I (region
   chr1:10,000-10,000,000 → qual >= 30 → per chrom and ref COUNT, AVG,
   STDDEV and VAR_POP) and I_panel (the same over a region file of 25
   windows, 1-10,000,000 on every contig), and three queries through the
   SQL functions and the holistic aggregates: J (a UniProt accession
   report over A's FASTA: substr, strpos, right, upper, trim, initcap,
   CAST, lpad and concat_ws), J_agg (A's records in 56 accession buckets
   with MIN(id), MAX(description) and MEDIAN(length(sequence))) and K (the
   3' TruSeq adapter trim of E's lane, strpos, nullif, coalesce, left and
   rtrim, as a trimmed-length histogram), and two over I_panel's scan: L
   (windows: the gap to the previous call, a RANGE count of calls within
   35 bp, a ROWS max of qual over 11 calls and a per-contig rank by qual
   DESC) and, over I's one-region scan (cut from the panel for the smoke's
   time), M (a ROLLUP of per-(chrom, ref) counts with qual >= 30: three
   aggregate branches joined by a union), and three over list, struct and
   map columns: N (the GENCODE biotype census: genes at levels 1-2 counted
   by attributes['gene_type'][1] over a GENCODE-v44-shaped GFF3 of chr1,
   340,000 features, the ten largest kept by ORDER BY ... LIMIT, which the
   planner makes a TopK sort; the plan is checked for it), O (E's lane as model input: integer_encode_dna,
   quality_scores_to_list and its round trip to text, kept on the card and
   compared there) and P (a TMT reporter screen: the 30,000 mzML spectra of
   benchlib.fixtures.make_mzml holding a peak within 0.5 of 126.127726,
   binned by bin_vectors into 1,900 bins), and three on 8 shards of the
   card (a session with new_exon_config(distributed=True, n_shards=8)):
   Q (BASELINE config 5's shape on one card: exon density per 100 kb
   window over B's GFF, count, min, max, sum and mean of the exon lengths
   per seqname and start / 100000; its plan must hold a
   DistributedAggregateExec over 8 shards, with no fallback and group rows
   exchanged), Q_top (A's 100 longest proteins through DistributedTopKExec)
   and Q_count (A's proteins past 300 residues, counted and summed through
   the ungrouped distributed path), and on the same shards C_dist (Query C:
   its plan must hold a DistributedJoinExec, the build side broadcast),
   D_part (Query D under SET exon.partitioned_join = true, set back to
   false after: a DistributedPartitionedJoinExec, with the (key, row)
   pairs it exchanged) and L_dist (Query L: a DistributedWindowExec, with
   the rows it routed), each equal to C, D and L row for row. Each is
   checked against numpy
   computations from the generators' own arrays. The launch counts are set to 0 before each
   query and read after it; each query must have launched every kernel of
   its path. Then the device-decoded FASTA and FASTQ files are held to the
   numpy host decode byte for byte, and each query's scans are timed alone:
   the device decode (read, copy, kernels, synced) and the host decode
   (for I and I_panel the seek and decode of the region chunks, with the
   rows the scan yields, which must equal numpy's count of the fixture's
   rows in the regions, and the records the chunks held before the exact
   row filter; M's three scans are not timed again). SQL_count,
   SQL_range and I then run beside their DataFrame twins (twin, SQL, SQL,
   twin; the same result), with the time SQL takes to parse, bind and
   plan alone.
5. Where the time goes in queries C and D: the join and the sort alone on
   device batches already in memory, with the kernels (median of 5
   host-clock runs ending in a sync), beside the bound of their input and
   output bytes; C's and D's joins alone on those batches in memory, on 8
   shards (C_dist's broadcast join, D_part's partitioned join) beside
   JoinExec on one device (median of 5); Q's aggregate alone on its device
   batches in memory on one device (AggregateExec), 2 shards and 8 shards
   (median of 5, and one profiled run: its device time and
   hash_aggregate_kernel's); L's windows alone on their input batches in memory, on
   8 shards (L_dist's DistributedWindowExec) beside WindowExec on one
   device (median of 5); then one run of A, E, J, J_agg, K, L, N and O under
   torch.profiler, with the device time of its CUDA kernels and copies and
   the largest of them (the profiled runs of I, I_panel, P and Q are cut
   for the smoke's time).

The smoke prints its total time and the card's name and power limit once
more (nvidia-smi); the line before the last is a JSON object
with each kernel's numbers; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ROWS = 131_072               # session device_batch_size (1 << 17)
MEAN_LEN = 400                 # Swiss-Prot-like sequence length
FASTA_RECORDS = 560_000        # Swiss-Prot scale (BASELINE config 1)
GFF_FEATURES = 3_400_000       # GENCODE human scale (BASELINE config 2)
GFF_SEED = 7
N_TEMPLATES = 1_425_000        # 2,835,750 BAM records (BASELINE config 4)
BAM_SEED = 13
W = 100_000                    # Query C's bin width
FASTQ_READS = 4_000_000        # 150 bp reads, ~1.4 GB of text (Query E)
FASTQ_SEED = 17
VCF_RECORDS = 25_000_000       # whole-genome calls, ~4 GB of text (Query I)
VCF_SEED = 7
VCF_REGION = "chr1:10000-10000000"  # BASELINE config 3's region (bench.py)
PANEL_END = 10_000_000         # I_panel: <seqname>:1-10000000 for each contig
FLOAT_RTOL = 1e-12             # float64 sums: atomic order changes rounding
VAR_RTOL = 1e-9                # var/stddev: Σx² − (Σx)²/n against two passes
AVG_RTOL = 1e-5                # AVG of the float32 qual column
BINS_RTOL = 1e-12              # bin_vectors' float64 sums: the twin's
                               # index_add_ adds in atomic order on the card
GENCODE_FEATURES = 340_000     # chr1's ~10 % of GENCODE v44's 3.4 M (N)
GENCODE_SEED = 44
MZML_SPECTRA = 30_000          # Query P: ~8.6 M peaks, ~185 MB of mzML
TMT_126 = 126.127726           # the TMT-126 reporter ion's m/z (Query P)
PEAK_TOL = 0.5                 # a low-resolution (ion trap) window
N_BINS, BIN_MIN, BIN_WIDTH = 1900, 100.0, 1.0  # 1 m/z bins over 100-2000
# past the 29,056 float64 bins a block's shared memory holds on the H100:
# list_bins' other bins variant, over the same m/z range
N_BINS_PAST_SHARED = 30_000
REPS = 20
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM integer rate: 132 SMs x 64 INT32 units x 1.98 GHz boost (NVIDIA
# H100 whitepaper; the clock that gives its 67 TFLOP/s float32)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# The fewest int32 instructions a Smith-Waterman DP cell needs on sm_90a:
# per gap term a subtract and a DPX add-max (__viaddmax_s32), the match
# score from a query profile and its diagonal add, one DPX clamped 3-way
# max (__vimax3_s32_relu) and one max for the running best. sw_score.cu
# issues 13 (no DPX, a compare and select per match). The data sheet gives
# no separate DPX rate, so these count at the INT32 rate.
SW_OPS_PER_CELL = 8

KERNELS = {
    "compact_mask": ("exon_tpu/ops/layout.py:75", "compact_mask.cu"),
    "gather_var": ("exon_tpu/ops/layout.py:149", "gather_var.cu"),
    "like_match": ("exon_tpu/ops/strings.py:177", "like_match.cu"),
    "hash_aggregate": ("exon_tpu/ops/aggregate.py:80", "hash_aggregate.cu"),
    "expand_segments": ("exon_tpu/ops/layout.py:308", "expand_segments.cu"),
    "row_hash": ("exon_tpu/plan/physical.py:831", "row_hash.cu"),
    "string_eq": ("exon_tpu/plan/expressions.py:763", "string_eq.cu"),
    "sort_keys": ("exon_tpu/plan/physical.py:1372", "sort_keys.cu"),
    "line_index": ("exon_tpu/ops/device_text.py:37", "line_index.cu"),
    "text_records": ("exon_tpu/ops/device_text.py:92", "text_records.cu"),
    "gather_spans": ("exon_tpu/ops/device_text.py:57", "gather_spans.cu"),
    "string_cmp": ("exon_tpu/plan/expressions.py:780", "string_cmp.cu"),
    "parse_number": ("exon_tpu/plan/expressions.py:951", "parse_number.cu"),
    "format_int": ("exon_tpu/plan/expressions.py:989", "format_int.cu"),
    "sw_score": ("exon_tpu/ops/alignment.py:43", "sw_score.cu"),
    "count_bytes": ("exon_tpu/udfs.py:69", "count_bytes.cu"),
    "map_bytes": ("exon_tpu/udfs.py:87", "map_bytes.cu"),
    "polya_tail": ("exon_tpu/udfs.py:131", "polya_tail.cu"),
    "span_concat": ("exon_tpu/ops/sqlfuncs.py:268", "span_concat.cu"),
    "window_bounds": ("exon_tpu/plan/window_exec.py:123",
                      "window_bounds.cu"),
    "window_frame": ("exon_tpu/plan/window_exec.py:263", "window_frame.cu"),
    "map_lookup": ("exon_tpu/plan/expressions.py:716", "map_lookup.cu"),
    "list_bins": ("exon_tpu/udfs.py:389", "list_bins.cu"),
    "bucket_pack": ("exon_tpu/parallel/shuffle.py:53", "bucket_pack.cu"),
}
DECODE = ("line_index", "text_records", "gather_spans")
# the kernels each main-path query runs
PATH_KERNELS = {
    "A": DECODE + ("compact_mask", "gather_var", "like_match"),
    "count": DECODE + ("compact_mask", "like_match"),
    "B": ("hash_aggregate",),
    "C": ("compact_mask", "gather_var", "expand_segments", "sort_keys"),
    "D": ("compact_mask", "gather_var", "expand_segments", "row_hash",
          "string_eq", "sort_keys"),
    "E": DECODE + ("like_match", "compact_mask", "gather_var"),
    "E_count": DECODE + ("like_match",),
    "SQL_count": DECODE + ("compact_mask", "like_match"),
    "SQL_range": DECODE + ("string_cmp", "compact_mask", "gather_var"),
    "SQL_gff": ("format_int", "parse_number", "hash_aggregate"),
    "F": DECODE + ("sw_score", "compact_mask", "gather_var"),
    "G": ("count_bytes", "hash_aggregate"),
    "H": DECODE + ("count_bytes", "compact_mask", "gather_var", "polya_tail",
                   "gather_spans", "map_bytes"),
    # the var-width key: row_hash, its verification (string_eq over the
    # representatives gather_var keeps), the table's slots (compact_mask)
    "I": ("hash_aggregate", "row_hash", "string_eq", "gather_var",
          "compact_mask"),
    "I_panel": ("hash_aggregate", "row_hash", "string_eq", "gather_var",
                "compact_mask"),
    # strpos on like_match's position mode, the slices on gather_spans,
    # trim on polya_tail, upper and initcap on map_bytes, the CAST on
    # format_int, concat_ws and lpad on span_concat
    "J": DECODE + ("like_match", "compact_mask", "gather_var", "polya_tail",
                   "map_bytes", "format_int", "span_concat"),
    # the group key's substr on gather_spans; the groups on the host
    "J_agg": DECODE,
    "K": DECODE + ("like_match", "polya_tail", "hash_aggregate",
                   "sort_keys"),
    # the windows: the key matrix, the bounds and every call's frame
    "L": ("sort_keys", "window_bounds", "window_frame"),
    # ROLLUP: three aggregate branches over the panel, joined by a union
    "M": ("hash_aggregate", "row_hash", "string_eq", "gather_var",
          "compact_mask"),
    # the map lookups (map_lookup, then the list take: expand_segments and
    # gather_var), the filter, the string group key and the sort
    "N": ("map_lookup", "expand_segments", "gather_var", "compact_mask",
          "hash_aggregate", "row_hash", "string_eq", "sort_keys"),
    # the encodings and scores on map_bytes' widen and narrow modes
    "O": DECODE + ("map_bytes",),
    # contains_peak and bin_vectors on list_bins; the filter's take of the
    # list columns on expand_segments
    "P": ("list_bins", "compact_mask", "expand_segments"),
    # the shards' tables (hash_aggregate, their slots on compact_mask) and
    # the exchange of their groups (bucket_pack), then the owners' merge
    "Q": ("hash_aggregate", "compact_mask", "bucket_pack"),
    # each shard's top 100 and the final sort (sort_keys, the ids taken on
    # gather_var), on the device decode
    "Q_top": DECODE + ("sort_keys", "gather_var"),
    "Q_count": DECODE,
    # on the 8 shards: C's broadcast join (each shard probes the one build
    # side of the card), D's partitioned join (the string key's hash, the
    # pair exchange, the match, the verification, the takes) and L's
    # windows (the rows routed to their partition's shard)
    "C_dist": ("compact_mask", "gather_var", "expand_segments", "sort_keys"),
    "D_part": ("row_hash", "bucket_pack", "expand_segments", "string_eq",
               "compact_mask", "gather_var", "sort_keys"),
    "L_dist": ("bucket_pack", "sort_keys", "window_bounds", "window_frame"),
}
ADAPTER = "%AGATCGGAAGAGC%"    # TruSeq adapter prefix, anywhere in a read
SQL_COUNT = ("SELECT COUNT(*) FROM fasta_scan('{fa}') WHERE length(sequence) "
             "> 300 AND sequence LIKE '%KK%'")
RANGE = (b"sp|P100000", b"sp|P200000")   # ids of records 100,000-199,999
SQL_RANGE = ("SELECT id, sequence FROM fasta_scan('{fa}') WHERE id >= "
             f"'{RANGE[0].decode()}' AND id < '{RANGE[1].decode()}'")
SQL_CREATE = "CREATE EXTERNAL TABLE genes STORED AS GFF LOCATION '{gf}'"
SQL_GFF = ("SELECT seqname, CASE WHEN strand = '+' THEN 'fwd' ELSE 'rev' END "
           "AS dir, COUNT(*) AS n, SUM(CAST(CAST(start AS VARCHAR) AS BIGINT)) "
           "AS s, SUM(CAST(CAST(\"end\" AS VARCHAR) AS DOUBLE)) AS e FROM genes "
           "WHERE type = 'exon' GROUP BY seqname, dir")
SW_QUERY = b"AGATCGGAAGAGC"  # the TruSeq adapter prefix (Query F)
SQL_F = ("SELECT name, alignment_score(sequence, '{q}') AS score FROM "
         "fastq_scan('{fq}') WHERE alignment_score(sequence, '{q}') >= 11")
SQL_G = ("SELECT reference, COUNT(*) AS n, AVG(gc_content(sequence)) AS gc "
         "FROM bam_scan('{bam}') WHERE is_first_segment(flag) AND NOT "
         "is_mate_unmapped(flag) GROUP BY reference")
GC_MIN = 0.55                  # Query H's GC-rich reads
SQL_I = ("SELECT chrom, ref, COUNT(*) AS n, AVG(qual) AS mean_qual, "
         "STDDEV(qual) AS sd_qual, VAR_POP(qual) AS var_qual FROM "
         "vcf_indexed_scan('{vcf}', '{region}') WHERE qual >= 30 "
         "GROUP BY chrom, ref")
# J: a UniProt accession report over Query A's FASTA; J_agg: its 56
# accession buckets with string extremes and a median; K: the 3' adapter
# trim of Query E's lane and its trimmed-length histogram
SQL_J = ("SELECT substr(id, 4, strpos(substr(id, 4), '|') - 1) AS accession, "
         "concat_ws('|', upper(right(id, length(id) - strpos(substr(id, 4), "
         "'|') - 3)), initcap(trim(description)), lpad(CAST(length(sequence) "
         "AS VARCHAR), 5, '0')) AS label FROM fasta_scan('{fa}') WHERE "
         "strpos(sequence, 'KK') > 0")
SQL_J_AGG = ("SELECT substr(id, 5, 2) AS bucket, COUNT(*) AS n, MIN(id) AS "
             "first_id, MAX(description) AS last_desc, MEDIAN(length("
             "sequence)) AS median_len FROM fasta_scan('{fa}') GROUP BY "
             "substr(id, 5, 2)")
SQL_K = ("SELECT length(t) AS len, COUNT(*) AS n, SUM(length(sequence) - "
         "length(t)) AS removed FROM (SELECT sequence, rtrim(left(sequence, "
         "coalesce(nullif(strpos(sequence, 'AGATCGGAAGAGC'), 0) - 1, "
         "length(sequence))), 'N') AS t FROM fastq_scan('{fq}')) GROUP BY "
         "length(t) ORDER BY len")
# L: neighbour gaps, a SNP-cluster count (GATK VariantFiltration
# --cluster-window-size 35), a local quality envelope and a per-contig
# quality rank over I_panel's scan; M: per-contig and total call counts by
# REF (bcftools stats) as a ROLLUP over I's one-region scan
SQL_L = ("SELECT chrom, pos, qual, pos - lag(pos) OVER (PARTITION BY chrom "
         "ORDER BY pos) AS gap, COUNT(*) OVER (PARTITION BY chrom ORDER BY "
         "pos RANGE BETWEEN 35 PRECEDING AND 35 FOLLOWING) AS cluster_n, "
         "MAX(qual) OVER (PARTITION BY chrom ORDER BY pos ROWS BETWEEN 5 "
         "PRECEDING AND 5 FOLLOWING) AS local_max_qual, rank() OVER ("
         "PARTITION BY chrom ORDER BY qual DESC) AS qual_rank FROM "
         "vcf_indexed_scan('{vcf}', '{panel}')")
SQL_M = ("SELECT chrom, ref, COUNT(*) AS n FROM vcf_indexed_scan('{vcf}', "
         "'{region}') WHERE qual >= 30 GROUP BY ROLLUP(chrom, ref)")
# N: the GENCODE biotype census (the N_TOP largest gene counts by gene_type
# at levels 1-2, through the planner's TopK sort);
# O: reads as model input (Exon's integer encodings of E's lane); P: a TMT
# reporter screen over mzML spectra, binned as model input
N_TOP = 10
SQL_N = ("SELECT attributes['gene_type'][1] AS gene_type, COUNT(*) AS n "
         "FROM gff_scan('{gf}') WHERE type = 'gene' AND "
         "attributes['level'][1] IN ('1', '2') GROUP BY "
         "attributes['gene_type'][1] ORDER BY n DESC, gene_type LIMIT "
         f"{N_TOP}")
SQL_O = ("SELECT name, integer_encode_dna(sequence) AS codes, "
         "quality_scores_to_list(quality_scores) AS scores, "
         "quality_scores_to_string(quality_scores_to_list(quality_scores)) "
         "AS round_trip FROM fastq_scan('{fq}')")
SQL_P = ("SELECT id, bin_vectors(mz.mz, intensity.intensity, "
         f"{BIN_MIN}, {N_BINS}, {BIN_WIDTH}) AS bins FROM mzml_scan('{{mz}}') "
         f"WHERE contains_peak(mz.mz, {TMT_126}, {PEAK_TOL})")
# Q: BASELINE config 5's shape on one card, exon density per 100 kb window
# (bedtools makewindows -w 100000 + intersect -c, per chromosome) over B's
# GFF, on Q_SHARDS shards of the card; Q_top and Q_count: A's 100 longest
# proteins, and the count and total length of its proteins past 300
# residues, on the same shards
Q_SHARDS = 8
Q_WIN = 100_000
Q_TOP = 100
SQL_Q = ("SELECT seqname, start / 100000 AS win, COUNT(*) AS n, MIN(start) "
         "AS lo, MAX(\"end\") AS hi, SUM(\"end\" - start + 1) AS bp, "
         "AVG(\"end\" - start + 1) AS mean_bp FROM gff_scan('{gf}') WHERE "
         "type = 'exon' GROUP BY seqname, start / 100000")
SQL_Q_TOP = ("SELECT id, length(sequence) AS n FROM fasta_scan('{fa}') "
             f"ORDER BY n DESC, id LIMIT {Q_TOP}")
SQL_Q_COUNT = ("SELECT COUNT(*) AS n, SUM(length(sequence)) AS total FROM "
               "fasta_scan('{fa}') WHERE length(sequence) > 300")
# PCIe Gen5 x16 between the H100 SXM and its host, each way (NVIDIA data
# sheet: 128 GB/s both ways together)
HOST_LINK_BYTES_PER_S = 64e9


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def bound_ms(nbytes: float) -> float:
    """The least time the card could take to move ``nbytes`` (each input
    read once, each output written once) at its memory rate. Every kernel
    here does a few integer operations per byte, which the card's integer
    rate finishes well inside this time, so bytes bound them all."""
    return 1e3 * nbytes / HBM_BYTES_PER_S


def ops_ms(ops: float) -> float:
    """The least time the card could take for ``ops`` int32 operations."""
    return 1e3 * ops / INT32_OPS_PER_S


def median_ms(fn, torch, reps: int = REPS) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# Phase 1 and 2
# ---------------------------------------------------------------------------


def phase_device(torch) -> tuple[str, str]:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a card")
    name = torch.cuda.get_device_name(0)
    print(f"device: {name} (torch {torch.__version__}, cuda "
          f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    for mod in ("jax", "pyarrow"):
        found = importlib.util.find_spec(mod) is not None
        print(f"{mod} installed: {found} (not needed by exon_tpu_torch)")
    return name, card


def phase_build() -> None:
    from exon_tpu_torch.kernels import _build

    _build.build()
    log = _build.build_log
    print(f"build: {log['seconds']:.2f} s ({'cached' if log['cached'] else 'nvcc'}"
          f") -> {log['path']}")
    for line in log.get("output", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    _build.library()


# ---------------------------------------------------------------------------
# Phase 3: kernels vs twins
# ---------------------------------------------------------------------------


def _var_column(rng, n: int, torch):
    lens = rng.integers(120, 2 * MEAN_LEN - 120, size=n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    alphabet = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)
    vals = alphabet[rng.integers(0, 20, size=int(offs[-1]))]
    vals[offs[:-1][rng.random(n) < 0.23]] = ord("M")
    return (torch.from_numpy(offs.astype(np.int32)).cuda(),
            torch.from_numpy(vals).cuda())


def _exact(name: str, a, b) -> float:
    if a.shape != b.shape or not bool((a == b).all()):
        fail(f"{name}: kernel and twin disagree")
    return 0.0


def check_compact(rng, torch) -> dict:
    from exon_tpu_torch.kernels import compact_mask as k

    mask = torch.from_numpy(rng.random(N_ROWS) < 0.5).cuda()
    got, n_got = k.compact_mask(mask)
    want, n_want = k.compact_mask_plain(mask)
    torch.cuda.synchronize()
    err = _exact("compact_mask", got, want) + _exact("compact_mask count",
                                                       n_got, n_want)
    return {"max_abs_err": err,
            "ms": median_ms(lambda: k.compact_mask(mask), torch),
            "plain_ms": median_ms(lambda: k.compact_mask_plain(mask), torch),
            "library_ms": median_ms(lambda: torch.nonzero(mask), torch),
            "bytes": N_ROWS + 4 * N_ROWS + 4,  # mask in; every slot, count out
            "shape": f"{N_ROWS} rows"}


def check_gather(rng, torch, offs, vals) -> dict:
    from exon_tpu_torch.kernels import gather_var as k

    idx = torch.from_numpy(np.flatnonzero(rng.random(N_ROWS) < 0.5)
                           .astype(np.int32)).cuda()
    o1, v1 = k.gather_var(offs, vals, idx)
    o2, v2 = k.gather_var_plain(offs, vals, idx)
    torch.cuda.synchronize()
    err = _exact("gather_var offsets", o1, o2) + _exact("gather_var values",
                                                        v1, v2)
    m, taken = idx.shape[0], v1.shape[0]
    return {"max_abs_err": err, "library_ms": None,
            # indices, the taken rows' offset pairs and bytes in; offsets
            # and bytes out
            "bytes": 4 * m + 8 * m + taken + 4 * (m + 1) + taken,
            "ms": median_ms(lambda: k.gather_var(offs, vals, idx), torch),
            "plain_ms": median_ms(lambda: k.gather_var_plain(offs, vals, idx),
                                  torch),
            "shape": f"{N_ROWS} rows, {vals.shape[0]} bytes, "
                     f"{idx.shape[0]} taken"}


def check_like(torch, offs, vals) -> dict:
    from exon_tpu_torch.kernels import like_match as k
    from exon_tpu_torch.ops.strings import tokenize_like

    times = {}
    for pattern, ci in (("%KK%", False), ("M%", False), ("%A_C%", False),
                        ("exact", False), ("m%kk%w", True)):
        chunks = tokenize_like(pattern)
        got = k.like_match(offs, vals, chunks, ci)
        want = k.like_match_plain(offs, vals, chunks, ci)
        torch.cuda.synchronize()
        _exact(f"like_match {pattern!r}", got, want)
        times[pattern] = (
            median_ms(lambda: k.like_match(offs, vals, chunks, ci), torch),
            median_ms(lambda: k.like_match_plain(offs, vals, chunks, ci),
                      torch), int(got.sum()))
        print(f"  like {pattern!r} ci={ci}: {times[pattern][2]} rows match, "
              f"kernel {times[pattern][0]:.4f} ms, twin "
              f"{times[pattern][1]:.4f} ms")
    return {"max_abs_err": 0.0, "ms": times["%KK%"][0],
            "plain_ms": times["%KK%"][1], "library_ms": None,
            # offsets in, each row's bytes up to its first KK, a bool out
            "bytes": 4 * (N_ROWS + 1) + _bytes_to_first_kk(offs, vals)
            + N_ROWS,
            "shape": f"{N_ROWS} rows, {vals.shape[0]} bytes, '%KK%'"}


def _bytes_to_first_kk(offs, vals) -> int:
    """Bytes a '%KK%' match must read: each row up to the end of its first
    'KK', or all of it."""
    o = offs.cpu().numpy().astype(np.int64)
    v = vals.cpu().numpy()
    kk = np.flatnonzero((v[:-1] == ord("K")) & (v[1:] == ord("K")))
    row = np.searchsorted(o, kk, side="right") - 1
    inside = kk + 2 <= o[row + 1]
    need = np.diff(o)
    first = np.full(len(need), np.iinfo(np.int64).max)
    np.minimum.at(first, row[inside], kk[inside] + 2)
    hit = first < np.iinfo(np.int64).max
    need[hit] = first[hit] - o[:-1][hit]
    return int(need.sum())


def check_hash(rng, torch, first_i) -> dict:
    """hash_aggregate against its twin: Query I's first batch (the kernels
    line), with the sum of squares and the slot output; the same batch with
    its live rows' keys dealt out anew into groups of equal size (the
    control without hot slots); then 25 int64 keys with count/min/max/sum
    (printed lines). Each beside the kernel's own device time."""
    from exon_tpu_torch.kernels import hash_aggregate as hk
    from exon_tpu_torch.ops.aggregate import GroupedHashAggregate

    res = _check_hash_query_i(torch, hk, GroupedHashAggregate, first_i,
                              "query I first batch")
    _check_hash_query_i(torch, hk, GroupedHashAggregate,
                        _equal_groups(first_i), "query I, equal groups")
    specs = [(hk.COUNT, False), (hk.MIN, False), (hk.MAX, False),
             (hk.SUM, False), (hk.SUM, True), (hk.MIN, True), (hk.MAX, True)]
    for label, n, n_keys in (("25 keys", N_ROWS, 25),):
        keys = rng.integers(0, n_keys, n)
        parts = torch.from_numpy(keys.astype(np.int64)[None, :]).cuda()
        pvalid = torch.ones_like(parts, dtype=torch.uint8)
        mask = torch.from_numpy(rng.random(n) < 0.9).cuda()
        ints = torch.from_numpy(rng.integers(-10**9, 10**9, n)).cuda()
        floats = torch.from_numpy(rng.standard_normal(n) * 1e3).cuda()
        valid = torch.from_numpy(rng.random(n) < 0.95).cuda()
        args = (parts, pvalid, mask, None, 0,
                [None, ints, ints, ints, floats, floats, floats],
                [valid] * len(specs))
        got, want, err = _hash_vs_twin(torch, hk, GroupedHashAggregate,
                                       specs, args, label)
        ms, host = _hash_ms(torch, hk.insert, GroupedHashAggregate, specs,
                            args)
        dev = _hash_device_ms(torch, hk, GroupedHashAggregate, specs, args)
        plain, _host = _hash_ms(torch, hk.insert_plain, GroupedHashAggregate,
                                specs, args)
        # key part, its validity, mask, the int and float values and their
        # validity in; per group the key and 7 (value, count) pairs out
        nbytes = 27 * n + got.num_groups * (8 + 7 * 16)
        print(f"  hash_aggregate {label}: {got.num_groups} groups, "
              f"{n} rows, kernel {ms:.4f} ms (the kernel alone {dev:.4f} ms "
              f"on the device, the wrapper's host work {host:.4f} ms), twin "
              f"{plain:.4f} ms, bound {bound_ms(nbytes):.4f} ms, "
              f"max float-sum diff {err:.3e}")
    return res


def _equal_groups(first: dict, seed: int = 5) -> dict:
    """Query I's first batch with the keys of its live rows dealt out anew:
    the same groups, each over an equal share of the rows (to one), in a
    random order, so no slot is hot. The mask and the values stay."""
    import torch

    parts, pvalid, mask = first["parts"], first["pvalid"], first["mask"]
    k = parts.shape[0]
    rows = torch.nonzero(mask).flatten()
    uniq = torch.unique(torch.cat([parts[:, rows], pvalid[:, rows].long()]),
                        dim=1)
    pick = torch.from_numpy(np.random.default_rng(seed).permutation(
        rows.shape[0])).to(parts.device) % uniq.shape[1]
    parts, pvalid = parts.clone(), pvalid.clone()
    parts[:, rows] = uniq[:k, pick]
    pvalid[:, rows] = uniq[k:, pick].to(torch.uint8)
    return {**first, "parts": parts, "pvalid": pvalid}


def _hash_vs_twin(torch, hk, agg_cls, specs, args, label: str):
    """Both tables after one insert of ``args``: groups, counts, integer
    partials and the rows' slots exact, float sums within FLOAT_RTOL."""
    parts, pvalid, mask = args[:3]
    out = []
    for insert in (hk.insert, hk.insert_plain):
        agg = agg_cls(parts.shape[0], specs, parts.device)
        agg.reserve(parts.shape[1])
        slots = insert(agg.table, *args, slots=True)
        rows = torch.nonzero(mask).flatten()
        if not (bool((slots[~mask] == -1).all())
                and torch.equal(agg.table.keys[:, slots[rows]],
                                parts[:, rows])
                and torch.equal(agg.table.key_valid[:, slots[rows]],
                                pvalid[:, rows])):
            fail(f"hash_aggregate {label}: a row's slot does not hold its "
                 "key")
        out.append(agg.finalize())
    got, want = out
    torch.cuda.synchronize()
    _exact(f"hash_aggregate {label} keys", got.keys, want.keys)
    err = 0.0
    for a, (op, is_float) in enumerate(specs):
        _exact(f"hash_aggregate {label} count {a}", got.cnt[a], want.cnt[a])
        if op == hk.COUNT:
            continue
        if is_float and op in (hk.SUM, hk.SUMSQ):
            diff = (got.acc[a] - want.acc[a]).abs()
            scale = want.acc[a].abs().clamp(min=1.0)
            if bool((diff > FLOAT_RTOL * scale).any()):
                fail(f"hash_aggregate {label}: float sums differ beyond "
                     f"rtol {FLOAT_RTOL}")
            err = max(err, float(diff.max()) if diff.numel() else 0.0)
        else:
            _exact(f"hash_aggregate {label} acc {a}", got.acc[a], want.acc[a])
    return got, want, err


def _hash_ms(torch, insert, agg_cls, specs, args,
             slots=False) -> tuple[float, float]:
    """Median time of one insert into a fresh table made outside the
    timing, between CUDA events, and the median host time of the call (its
    work before it returns, no sync)."""
    parts = args[0]
    times, host = [], []
    for _ in range(REPS + 1):
        agg = agg_cls(parts.shape[0], specs, parts.device)
        agg.reserve(parts.shape[1])
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t = time.perf_counter()
        insert(agg.table, *args, slots=slots)
        host.append(1e3 * (time.perf_counter() - t))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times[1:])), float(np.median(host[1:]))


def _cuda_rows(torch, run, reps: int = 1) -> list:
    """torch.profiler's rows of CUDA kernels and copies over ``reps`` runs
    of ``run``, after one run outside the profile."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _hash_device_ms(torch, hk, agg_cls, specs, args, slots=False) -> float:
    """The mean device time of hash_aggregate_kernel alone over REPS
    inserts into fresh tables, from torch.profiler's self_device_time_total
    (the tables' fills are other kernels)."""
    parts = args[0]

    def run():
        agg = agg_cls(parts.shape[0], specs, parts.device)
        agg.reserve(parts.shape[1])
        hk.insert(agg.table, *args, slots=slots)

    rows = [e for e in _cuda_rows(torch, run, REPS)
            if "hash_aggregate_kernel" in e.key]
    launched = sum(e.count for e in rows)
    if launched != REPS:
        fail(f"hash_aggregate: the profile shows {launched} kernel runs, "
             f"not {REPS}")
    return sum(e.self_device_time_total for e in rows) / 1e3 / launched


def _query_i_first_batch(torch):
    """Query I's first batch as its AggregateExec sees it: the scan's
    device batch after the tabix seek, the key parts of (chrom, ref), the
    mask of ``qual >= 30`` and the qual values."""
    import exon_tpu_torch as T
    from benchlib.vcf_fixture import make_vcf
    from exon_tpu_torch.plan import physical as P

    t = time.perf_counter()
    vcf = make_vcf(VCF_RECORDS, VCF_SEED)
    print(f"  VCF fixture: {VCF_RECORDS} records, {os.path.getsize(vcf)} "
          f"bytes BGZF, {time.perf_counter() - t:.1f} s to build (0 if it "
          "was cached)")
    session = T.ExonSession(device="cuda")
    df = session.sql(SQL_I.format(vcf=vcf, region=VCF_REGION))
    agg = df._execute(df.logical_plan())
    if not isinstance(agg, P.AggregateExec):
        fail(f"query I plans to {type(agg).__name__}, not AggregateExec")
    b = next(iter(agg.input.batches()))
    parts, pvalid, kinds, _cols = agg._key_parts(b, {})
    mask = agg._mask(b)
    vals, valid = agg._values_for_call(agg.agg_calls[1], b, mask)
    return {"parts": parts, "pvalid": pvalid, "mask": mask, "qual": vals,
            "valid": valid, "kinds": kinds}


def _check_hash_query_i(torch, hk, agg_cls, first, label: str) -> dict:
    # COUNT(*), AVG(qual), STDDEV(qual), VAR_POP(qual): count, a sum, and
    # two (sum, sum of squares) pairs over the same float64 values
    specs = [(hk.COUNT, False), (hk.SUM, True), (hk.SUM, True),
             (hk.SUMSQ, True), (hk.SUM, True), (hk.SUMSQ, True)]
    parts, pvalid, mask = first["parts"], first["pvalid"], first["mask"]
    x, valid = first["qual"], first["valid"]
    n = parts.shape[1]
    args = (parts, pvalid, mask, None, 0,
            [None] + [x] * 5, [mask] + [valid] * 5)
    got, _want, err = _hash_vs_twin(torch, hk, agg_cls, specs, args, label)
    ms, host = _hash_ms(torch, hk.insert, agg_cls, specs, args, slots=True)
    dev = _hash_device_ms(torch, hk, agg_cls, specs, args, slots=True)
    plain, _host = _hash_ms(torch, hk.insert_plain, agg_cls, specs, args,
                            slots=True)
    # the library yardstick for the Σx² partial: one index_add_ of x² at the
    # kernel's slots, over the rows that feed it
    agg = agg_cls(parts.shape[0], specs, parts.device)
    agg.reserve(n)
    slots = hk.insert(agg.table, *args, slots=True)
    live = torch.nonzero(valid).flatten()
    at, x2 = slots[live], x[live] * x[live]
    acc = torch.zeros(agg.table.capacity, dtype=torch.float64,
                      device=x.device)
    lib = median_ms(lambda: acc.index_add_(0, at, x2), torch)
    g = got.num_groups
    sizes = torch.bincount(slots[slots >= 0])
    # parts, their validity, the mask, the qual values and their validity
    # in, each row's slot out; per group its keys, key validity, first row
    # and 6 (accumulator, count) pairs
    nbytes = n * (parts.shape[0] * 9 + 1 + 8 + 1) + 8 * n + \
        g * (parts.shape[0] * 9 + 8 + 6 * 16)
    print(f"  hash_aggregate {label}: {n} rows, {g} groups (keys "
          f"{first['kinds']}, the largest {int(sizes.max())} live rows), "
          f"kernel {ms:.4f} ms with slots (the kernel alone {dev:.4f} ms on "
          f"the device, the wrapper's host work {host:.4f} ms), twin "
          f"{plain:.4f} ms, index_add_ of x^2 {lib:.4f} ms, bound "
          f"{bound_ms(nbytes):.4f} ms, max float-sum diff {err:.3e}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain,
            "library_ms": lib, "bytes": nbytes,
            "shape": f"query I's first batch: {n} rows, {g} (chrom, ref) "
                     "groups, count + sum + 2 x (sum, sum of squares), "
                     "slots out"}


def _names_column(names: np.ndarray, torch):
    """Device (offsets, values) of a numpy bytes array of read names."""
    lens = np.char.str_len(names).astype(np.int64)
    offs = np.zeros(len(names) + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    vals = np.frombuffer(b"".join(names.tolist()), np.uint8).copy()
    return (torch.from_numpy(offs.astype(np.int32)).cuda(),
            torch.from_numpy(vals).cuda())


def check_expand(rng, torch) -> dict:
    from exon_tpu_torch.kernels import expand_segments as k

    # Query C: 131,072 reads per probe batch, ~1.27 gene slots per read
    n_build = 60_991
    counts = rng.poisson(1.27, N_ROWS).astype(np.int32)
    ends = np.cumsum(counts)
    lo = torch.from_numpy(rng.integers(0, n_build, N_ROWS).astype(np.int32))
    args = (lo.cuda(), torch.from_numpy(counts).cuda(),
            torch.from_numpy(ends - counts).cuda(), int(ends[-1]), n_build)
    got, want = k.expand_segments(*args), k.expand_segments_plain(*args)
    torch.cuda.synchronize()
    _exact("expand_segments probe", got[0], want[0])
    _exact("expand_segments build", got[1], want[1])
    rows = torch.arange(N_ROWS, device="cuda")
    return {"max_abs_err": 0.0,
            "ms": median_ms(lambda: k.expand_segments(*args), torch),
            "plain_ms": median_ms(lambda: k.expand_segments_plain(*args),
                                  torch),
            "library_ms": median_ms(
                lambda: torch.repeat_interleave(rows, args[1]), torch),
            # lo, counts, starts in; a probe and a build index per slot out
            "bytes": 12 * N_ROWS + 8 * int(ends[-1]),
            "shape": f"{N_ROWS} probe rows, {int(ends[-1])} slots"}


def check_row_hash(torch, names) -> dict:
    from exon_tpu_torch.kernels import row_hash as k

    out = {}
    for label, rows in (("probe", names[:N_ROWS]), ("build", names)):
        offs, vals = _names_column(rows, torch)
        _exact(f"row_hash {label}", k.row_hash(offs, vals),
               k.row_hash_plain(offs, vals))
        out[label] = {
            "max_abs_err": 0.0,
            "ms": median_ms(lambda: k.row_hash(offs, vals), torch),
            "plain_ms": median_ms(lambda: k.row_hash_plain(offs, vals),
                                  torch),
            "library_ms": None,
            "bytes": 4 * (len(rows) + 1) + vals.shape[0] + 8 * len(rows),
            "shape": f"{len(rows)} names, {vals.shape[0]} bytes"}
    print(f"  row_hash build side: {out['build']['shape']}, kernel "
          f"{out['build']['ms']:.4f} ms, twin {out['build']['plain_ms']:.4f} ms"
          f", bound {bound_ms(out['build']['bytes']):.4f} ms")
    return out["probe"]


def check_string_eq(rng, torch, names) -> dict:
    from exon_tpu_torch.kernels import string_eq as k

    # Query D: each R1 name against the R2 row its hash found, most equal
    a = _names_column(names[:N_ROWS], torch) + (
        torch.ones(N_ROWS, dtype=torch.bool, device="cuda"),)
    b = _names_column(names, torch) + (
        torch.ones(len(names), dtype=torch.bool, device="cuda"),)
    ia = np.arange(N_ROWS, dtype=np.int32)
    ib = np.where(rng.random(N_ROWS) < 0.9, ia,
                  rng.integers(0, len(names), N_ROWS)).astype(np.int32)
    ia, ib = torch.from_numpy(ia).cuda(), torch.from_numpy(ib).cuda()
    got = k.string_eq(a, ia, b, ib)
    _exact("string_eq", got, k.string_eq_plain(a, ia, b, ib))
    compared = _compared_bytes(names[:N_ROWS][ia.cpu().numpy()],
                               names[ib.cpu().numpy()])
    return {"max_abs_err": 0.0, "library_ms": None,
            # both indices, both rows' offset pairs and validity, the bytes
            # a comparison must read; a bool out
            "bytes": 8 * N_ROWS + 16 * N_ROWS + 2 * N_ROWS + compared
            + N_ROWS,
            "ms": median_ms(lambda: k.string_eq(a, ia, b, ib), torch),
            "plain_ms": median_ms(lambda: k.string_eq_plain(a, ia, b, ib),
                                  torch),
            "shape": f"{N_ROWS} pairs, {int(got.sum())} equal"}


def _compared_bytes(a: np.ndarray, b: np.ndarray) -> int:
    """Bytes a row-pair equality must read: nothing when the lengths
    differ, else both rows up to their first differing byte, or whole."""
    la, lb = np.char.str_len(a), np.char.str_len(b)
    width = max(a.dtype.itemsize, b.dtype.itemsize)
    ma = np.frombuffer(a.astype(f"S{width}").tobytes(), np.uint8).reshape(
        len(a), width)
    mb = np.frombuffer(b.astype(f"S{width}").tobytes(), np.uint8).reshape(
        len(b), width)
    differ = ma != mb
    first = np.where(differ.any(axis=1), differ.argmax(axis=1) + 1, la)
    return int(2 * np.where(la == lb, np.minimum(first, la), 0).sum())


def check_sort_keys(rng, torch, names) -> dict:
    from benchlib.gff_fixture import SEQNAMES
    from exon_tpu_torch.kernels import sort_keys as k

    out = {}
    # Query C: ~1.5 M rows; reference, start, name, gene_start → 13 rows;
    # Query D: ~1.43 M rows; reference, start, name → 11 rows
    for label, n, gene in (("C", 1_500_000, True), ("D", 1_425_000, False)):
        ref = _names_column(np.asarray([s.encode() for s in SEQNAMES])[
            rng.integers(0, len(SEQNAMES), n)], torch)
        name = _names_column(names[rng.integers(0, len(names), n)], torch)
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        start = torch.from_numpy(rng.integers(1, 248_000_000, n)).cuda()
        specs = [k.VarKey(*ref, valid, 1), k.FixedKey(start, valid),
                 k.VarKey(*name, valid, 5)]
        if gene:
            specs.append(k.FixedKey(start - 1000, valid))
        got = k.sort_keys(specs, n, "cuda")
        _exact(f"sort_keys {label}", got, k.sort_keys_plain(specs, n, "cuda"))
        # per key its validity; fixed keys 8 bytes a row, string keys their
        # offset pair and up to 8 bytes per key row; the key matrix out
        key_in = sum(9 * n if isinstance(sp, k.FixedKey) else
                     9 * n + int(torch.clamp(sp.offsets[1:] - sp.offsets[:-1],
                                             max=8 * sp.nchunks).sum())
                     for sp in specs)
        out[label] = {
            "max_abs_err": 0.0, "library_ms": None,
            "bytes": key_in + 8 * got.numel(),
            "ms": median_ms(lambda: k.sort_keys(specs, n, "cuda"), torch),
            "plain_ms": median_ms(
                lambda: k.sort_keys_plain(specs, n, "cuda"), torch),
            "shape": f"{n} rows x {got.shape[0]} key rows"}
    print(f"  sort_keys Query D shape: {out['D']['shape']}, kernel "
          f"{out['D']['ms']:.4f} ms, twin {out['D']['plain_ms']:.4f} ms, "
          f"bound {bound_ms(out['D']['bytes']):.4f} ms")
    return out["C"]


def _fasta_chunk(torch):
    """Query A's first device chunk (the first span that split_chunks cuts
    from its file, up to 128 MiB) on the card, and whether it ends in a
    newline."""
    from benchlib.fixtures import make_fasta
    from exon_tpu_torch.formats.fasta_device import split_chunks
    from exon_tpu_torch.io import read_file

    data = read_file(make_fasta(FASTA_RECORDS, mean_len=MEAN_LEN, seed=42))
    lo, hi = split_chunks(data)[0]
    chunk = np.frombuffer(data, np.uint8, count=hi - lo, offset=lo).copy()
    return torch.from_numpy(chunk).cuda(), data[hi - 1] == ord("\n")


def check_line_index(torch, chunk) -> tuple[dict, object]:
    from exon_tpu_torch.kernels import line_index as k

    got = k.line_index(chunk)
    _exact("line_index", got, k.line_index_plain(chunk))
    n, lines = chunk.shape[0], got.shape[0]
    return {"max_abs_err": 0.0,
            "ms": median_ms(lambda: k.line_index(chunk), torch),
            "plain_ms": median_ms(lambda: k.line_index_plain(chunk), torch),
            "library_ms": median_ms(lambda: torch.nonzero(chunk == 10),
                                    torch),
            "bytes": n + 4 * lines,  # the chunk in, a position per newline
            "shape": f"{n} bytes, {lines} newlines"}, got


def check_text_records(torch, chunk, nl, ends_in_newline) -> tuple[dict,
                                                                    object]:
    from exon_tpu_torch.kernels import text_records as k

    n_lines = nl.shape[0] + (0 if ends_in_newline else 1)
    args = (chunk, nl, n_lines, False, True)
    got, want = k.text_records(*args), k.text_records_plain(*args)
    for field in ("start", "end", "is_hdr", "body", "split", "name_len",
                  "desc_len", "bad"):
        _exact(f"text_records {field}", getattr(got, field),
               getattr(want, field))
    return {"max_abs_err": 0.0,
            "ms": median_ms(lambda: k.text_records(*args), torch),
            "plain_ms": median_ms(lambda: k.text_records_plain(*args), torch),
            "library_ms": None,
            # the chunk and the newlines in; per line start, end, header
            # flag, body, split, name and description lengths out
            "bytes": chunk.shape[0] + 4 * nl.shape[0] + 25 * n_lines + 4,
            "shape": f"{chunk.shape[0]} bytes, {n_lines} lines, "
                     f"{int(got.is_hdr.sum())} headers"}, got


def check_gather_spans(torch, chunk, lines) -> dict:
    from exon_tpu_torch.kernels import gather_spans as k
    from exon_tpu_torch.ops.device_text import lengths_to_offsets

    # Query A's sequence column: one span per line, a header's empty
    dst = lengths_to_offsets(lines.body)
    stops = torch.where(lines.is_hdr, lines.start, lines.end)
    total = int(dst[-1])
    args = (chunk, lines.start, stops, dst[:-1], total, (13,))
    _exact("gather_spans", k.gather_spans(*args), k.gather_spans_plain(*args))
    m = lines.start.shape[0]
    span_bytes = int((stops - lines.start).sum())
    return {"max_abs_err": 0.0,
            "ms": median_ms(lambda: k.gather_spans(*args), torch),
            "plain_ms": median_ms(lambda: k.gather_spans_plain(*args), torch),
            "library_ms": None,
            # starts, stops, offsets and the spans' bytes in; kept bytes out
            "bytes": 12 * m + span_bytes + total,
            "shape": f"{m} spans, {span_bytes} bytes in, {total} out"}


def _fasta_ids(n: int) -> np.ndarray:
    """The first n ids of Query A's FASTA file, as make_fasta writes them."""
    return np.asarray([b"sp|P%06d|PROT%d" % (i, i) for i in range(n)])


def _cmp_bytes(rows: np.ndarray, literal: bytes) -> int:
    """Bytes an ordered compare with ``literal`` must read: each row up to
    its first byte that differs from the literal, or min(length, len(lit))."""
    k = len(literal)
    mat = np.frombuffer(rows.astype(f"S{k}").tobytes(), np.uint8).reshape(
        len(rows), k)
    lens = np.minimum(np.char.str_len(rows), k)
    differ = (mat != np.frombuffer(literal, np.uint8)) & \
        (np.arange(k) < lens[:, None])
    return int(np.where(differ.any(axis=1), differ.argmax(axis=1) + 1,
                        lens).sum())


def check_string_cmp(torch, n: int) -> dict:
    from exon_tpu_torch.kernels import string_cmp as k

    # SQL_range: the n ids of Query A's first chunk, the batch the decode
    # hands the filter, against both ends of the range
    ids = _fasta_ids(n)
    offs, vals = _names_column(ids, torch)
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    out = {}
    for literal, op in ((RANGE[0], ">="), (RANGE[1], "<")):
        got = k.string_cmp(offs, vals, valid, literal, op)
        _exact(f"string_cmp {op} {literal!r}", got,
               k.string_cmp_plain(offs, vals, valid, literal, op))
        out[op] = {
            "max_abs_err": 0.0, "library_ms": None, "hits": got,
            # offset pairs and validity in, the bytes up to each row's first
            # difference, a bool out
            "bytes": 4 * (n + 1) + n + _cmp_bytes(ids, literal) + n,
            "ms": median_ms(lambda: k.string_cmp(offs, vals, valid, literal,
                                                 op), torch),
            "plain_ms": median_ms(lambda: k.string_cmp_plain(
                offs, vals, valid, literal, op), torch),
            "shape": f"{n} ids, {vals.shape[0]} bytes, {op} {literal.decode()}"}
    both = int((out[">="].pop("hits") & out["<"].pop("hits")).sum())
    if both != 100_000:
        fail(f"string_cmp: {both} ids in the range, expected 100000")
    lt = out["<"]
    print(f"  string_cmp < {RANGE[1].decode()}: kernel {lt['ms']:.4f} ms, "
          f"twin {lt['plain_ms']:.4f} ms, bound {bound_ms(lt['bytes']):.4f} "
          f"ms; {both} ids in the range")
    return out[">="]


def _decimal_column(values: np.ndarray, torch):
    """Device (offsets, values, validity) of int64 values as decimal text,
    made on the host by numpy."""
    text = values.astype("S20")
    offs, vals = _names_column(text, torch)
    return offs, vals, torch.ones(len(values), dtype=torch.bool,
                                  device="cuda")


def _parse_number_case(torch, want: np.ndarray, floating: bool,
                       label: str) -> dict:
    from exon_tpu_torch.kernels import parse_number as k

    col = _decimal_column(want, torch)
    got, ok = k.parse_number(*col, floating)
    plain, plain_ok = k.parse_number_plain(*col, floating)
    _exact(f"parse_number {label} validity", ok, plain_ok)
    _exact(f"parse_number {label}", got.view(torch.int64),
           plain.view(torch.int64))
    if not bool(ok.all()) or not np.array_equal(
            got.cpu().numpy(), want.astype(got.cpu().numpy().dtype)):
        fail(f"parse_number {label}: values differ from the generator's")
    n, text = len(want), int(col[1].shape[0])
    return {"max_abs_err": 0.0, "library_ms": None,
            # offset pairs, validity and the text in; value and ok out
            "bytes": 4 * (n + 1) + n + text + 8 * n + n,
            "ms": median_ms(lambda: k.parse_number(*col, floating), torch),
            "plain_ms": median_ms(lambda: k.parse_number_plain(*col, floating),
                                  torch),
            "shape": f"{n} numerals, {text} bytes, {label}"}


def _format_int_case(torch, ints: np.ndarray) -> dict:
    from exon_tpu_torch.kernels import format_int as k

    vals = torch.from_numpy(ints).cuda()
    valid = torch.ones(len(ints), dtype=torch.bool, device="cuda")
    got, want = k.format_int(vals, valid), k.format_int_plain(vals, valid)
    _exact("format_int offsets", got[0], want[0])
    _exact("format_int text", got[1], want[1])
    if got[1].cpu().numpy().tobytes() != b"".join(ints.astype("S20").tolist()):
        fail("format_int: text differs from numpy's")
    n, total = len(ints), int(got[1].shape[0])
    return {"max_abs_err": 0.0, "library_ms": None,
            # values and validity in; offsets and text out
            "bytes": 8 * n + n + 4 * (n + 1) + total,
            "ms": median_ms(lambda: k.format_int(vals, valid), torch),
            "plain_ms": median_ms(lambda: k.format_int_plain(vals, valid),
                                  torch),
            "shape": f"{n} int64, {total} bytes of text"}


def _bound(r: dict) -> tuple[float, str]:
    """A case's bound in ms and what sets it, bytes or operations."""
    by_bytes, by_ops = bound_ms(r["bytes"]), ops_ms(r.get("ops", 0))
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


def _print_case(name: str, r: dict) -> None:
    ms, by = _bound(r)
    print(f"  {name} ({r['shape']}): kernel {r['ms']:.4f} ms, twin "
          f"{r['plain_ms']:.4f} ms, bound {ms:.4f} ms by {by}")


def check_parse_number(torch, feats) -> dict:
    # SQL_gff: CAST(start AS BIGINT) and CAST("end" AS DOUBLE) of their
    # text, on each 131,072-row batch of the scan (the filter only masks
    # rows there); then once over all 3.4 M numerals
    out = {}
    for mode, key, floating in (("int", "start", False),
                                ("float", "end", True)):
        out[mode] = _parse_number_case(torch, feats[key][:N_ROWS], floating,
                                       f"{key}, {mode} mode")
        _print_case("parse_number whole file", _parse_number_case(
            torch, feats[key], floating, f"{key}, {mode} mode"))
    _print_case("parse_number batch", out["float"])
    return out["int"]


def check_format_int(torch, feats) -> dict:
    # SQL_gff: CAST(start AS VARCHAR) on a 131,072-row batch; then once over
    # all 3.4 M starts
    _print_case("format_int whole file", _format_int_case(torch,
                                                          feats["start"]))
    return _format_int_case(torch, feats["start"][:N_ROWS])


def _first_column(read, name: str):
    """Device (offsets, values) of column ``name`` in the first batch that
    the main path's scan ``read(session)`` yields."""
    import exon_tpu_torch as T

    df = read(T.ExonSession(device="cuda")).select(name)
    col = next(iter(df._execute(df.logical_plan()).batches())).column(name)
    return col.offsets, col.values


def _sw_case(torch, offs, vals) -> dict:
    from exon_tpu_torch.kernels import sw_score as k

    q = torch.tensor(list(SW_QUERY), dtype=torch.uint8, device="cuda")
    n, total = offs.shape[0] - 1, int(offs[-1] - offs[0])
    _exact("sw_score", k.sw_score(offs, vals, q), k.sw_score_plain(offs, vals,
                                                                   q))
    cells = total * len(SW_QUERY)
    return {"max_abs_err": 0.0, "library_ms": None,
            "ms": median_ms(lambda: k.sw_score(offs, vals, q), torch),
            "plain_ms": median_ms(lambda: k.sw_score_plain(offs, vals, q),
                                  torch),
            # offsets, the reads and the query in, an int32 score out
            "bytes": 4 * (n + 1) + total + len(SW_QUERY) + 4 * n,
            "ops": SW_OPS_PER_CELL * cells,
            "shape": f"{n} reads, {total} bytes, a {len(SW_QUERY)}-byte query, "
                     f"{cells} cells"}


def check_sw(torch, chunk, kept) -> dict:
    from exon_tpu_torch.kernels import sw_score as k

    # Query F's WHERE: each read of the first FASTQ chunk against the
    # adapter; its SELECT: the reads of that chunk that scored >= 11; then
    # the pairwise form, read i of the chunk against read i + 1
    _print_case("sw_score SELECT", _sw_case(torch, *kept))
    offs, vals = chunk
    n = offs.shape[0] - 1
    a_offs, b_offs = offs[:-1].contiguous(), (offs[1:] - offs[1]).contiguous()
    b_vals = vals[int(offs[1]):]
    pair = (a_offs, vals, b_offs, b_vals)
    _exact("sw_score pairwise", k.sw_score_pairwise(*pair),
           k.sw_score_pairwise_plain(*pair))
    lens = (offs[1:] - offs[:-1]).long()
    pair_cells = int((lens[:-1] * lens[1:]).sum())
    pair_ms = median_ms(lambda: k.sw_score_pairwise(*pair), torch)
    pair_plain = median_ms(lambda: k.sw_score_pairwise_plain(*pair), torch, 3)
    print(f"  sw_score pairwise ({n - 1} read pairs, {pair_cells} cells): "
          f"kernel {pair_ms:.4f} ms, twin {pair_plain:.4f} ms (median of 3), "
          f"bound {ops_ms(SW_OPS_PER_CELL * pair_cells):.4f} ms by operations")
    return _sw_case(torch, offs, vals)


def check_count_bytes(torch, bam_col, fq_col) -> dict:
    from exon_tpu_torch.kernels import count_bytes as k

    # Query G's gc_content on one BAM batch; Query H's on the FASTQ chunk
    out = {}
    for label, (offs, vals) in (("BAM batch", bam_col),
                                ("FASTQ chunk", fq_col)):
        n, total = offs.shape[0] - 1, int(offs[-1] - offs[0])
        _exact(f"count_bytes {label}", k.count_bytes(offs, vals, b"GCgc"),
               k.count_bytes_plain(offs, vals, b"GCgc"))
        out[label] = {
            "max_abs_err": 0.0, "library_ms": None,
            "ms": median_ms(lambda: k.count_bytes(offs, vals, b"GCgc"), torch),
            "plain_ms": median_ms(
                lambda: k.count_bytes_plain(offs, vals, b"GCgc"), torch),
            # offsets and bytes in, a count out (the class travels in the
            # launch's parameters)
            "bytes": 4 * (n + 1) + total + 4 * n,
            "shape": f"{n} reads, {total} bytes ({label})"}
    _print_case("count_bytes FASTQ chunk", out["FASTQ chunk"])
    return out["BAM batch"]


def check_map_bytes(torch, offs, vals) -> dict:
    from exon_tpu_torch.kernels import map_bytes as k

    # Query H's reverse complement of the trimmed reads
    table = np.arange(256, dtype=np.uint8)
    table[list(b"ACGTacgtNnUu")] = list(b"TGCAtgcaNnAa")
    table = torch.from_numpy(table).cuda()
    n, total = offs.shape[0] - 1, int(offs[-1] - offs[0])
    _exact("map_bytes", k.map_bytes(offs, vals, table, "mirror"),
           k.map_bytes_plain(offs, vals, table, "mirror"))
    return {"max_abs_err": 0.0, "library_ms": None,
            "ms": median_ms(lambda: k.map_bytes(offs, vals, table, "mirror"),
                            torch),
            "plain_ms": median_ms(
                lambda: k.map_bytes_plain(offs, vals, table, "mirror"),
                torch),
            # offsets, the bytes and the table in, the bytes out
            "bytes": 4 * (n + 1) + 2 * total + 256,
            "shape": f"{n} reads, {total} bytes, mirrored"}


def check_polya_tail(torch, offs, vals) -> dict:
    from exon_tpu_torch.kernels import polya_tail as k

    # Query H's trim_polya lengths of the GC-rich reads
    got = k.polya_tail(offs, vals)
    _exact("polya_tail", got, k.polya_tail_plain(offs, vals))
    n, lens = offs.shape[0] - 1, (offs[1:] - offs[:-1]).long()
    # each row read from its end back to its last non-A byte
    tail = int(torch.where(got > 0, lens - got.long() + 1, lens).sum())
    return {"max_abs_err": 0.0, "library_ms": None,
            "ms": median_ms(lambda: k.polya_tail(offs, vals), torch),
            "plain_ms": median_ms(lambda: k.polya_tail_plain(offs, vals),
                                  torch),
            "bytes": 4 * (n + 1) + tail + 4 * n,
            "shape": f"{n} reads, {tail} tail bytes read, "
                     f"{int((got < lens).sum())} trimmed"}


def check_library_programs(rng, torch, offs, vals) -> None:
    """K7 and K14, which the port leaves to PyTorch (no hand kernel): the
    ungrouped reductions of an aggregate without GROUP BY, the dictionary
    decode to a var-width column and the row concatenation of batches, at
    the main path's batch shape, each beside its bound."""
    from benchlib.gff_fixture import SEQNAMES
    from exon_tpu_torch import datatypes as dt
    from exon_tpu_torch.batch import Batch, DictColumn, FixedColumn, VarColumn
    from exon_tpu_torch.ops.aggregate import ungrouped_reduce
    from exon_tpu_torch.ops.layout import dict_to_var
    from exon_tpu_torch.plan.physical import concat_batches

    n = N_ROWS
    ints = torch.from_numpy(rng.integers(-10**9, 10**9, n)).cuda()
    mask = torch.from_numpy(rng.random(n) < 0.5).cuda()
    valid = torch.ones(n, dtype=torch.bool, device="cuda")
    for fn in ("count", "sum", "min", "max"):
        ms = median_ms(lambda: ungrouped_reduce(ints, mask, fn), torch)
        # the mask (and the values) in, one int64 out
        nbytes = n + (0 if fn == "count" else 8 * n) + 8
        print(f"K7 ungrouped_reduce {fn} ({n} rows): {ms:.4f} ms, bound "
              f"{bound_ms(nbytes):.6f} ms ({nbytes} bytes)")
    codes = torch.from_numpy(rng.integers(0, len(SEQNAMES), n)
                             .astype(np.int32)).cuda()
    col = DictColumn(codes, valid, tuple(SEQNAMES))
    out = dict_to_var(col)
    ms = median_ms(lambda: dict_to_var(col), torch)
    # codes and validity in; offsets and text out
    nbytes = 5 * n + 4 * (n + 1) + int(out.values.shape[0])
    print(f"K14 dict_to_var ({n} rows, {len(SEQNAMES)} strings): {ms:.4f} ms, "
          f"bound {bound_ms(nbytes):.6f} ms ({nbytes} bytes)")
    schema = dt.Schema.of(dt.Field("sequence", dt.utf8),
                          dt.Field("start", dt.int64))
    batch = Batch(schema, [VarColumn(vals, offs, valid),
                           FixedColumn(ints, valid)], n)
    parts = [batch] * 12
    ms = median_ms(lambda: concat_batches(schema, parts, "cuda"), torch)
    one = vals.shape[0] + 4 * (n + 1) + 8 * n + 2 * n
    nbytes = 2 * 12 * one  # every part read once, the result written once
    print(f"K14 concat_batches (12 x {n} rows, {vals.shape[0]} bytes of text "
          f"each): {ms:.4f} ms, bound {bound_ms(nbytes):.4f} ms ({nbytes} "
          "bytes)")
    host = batch.to_host()
    ms = median_ms(lambda: host.to_device("cuda"), torch)
    # every column copied once from pageable host memory over the link
    nbytes = one
    print(f"K14 Batch.to_device ({n} rows, {vals.shape[0]} bytes of text): "
          f"{ms:.4f} ms, bound {1e3 * nbytes / HOST_LINK_BYTES_PER_S:.4f} ms "
          f"by the host link at {HOST_LINK_BYTES_PER_S / 1e9:.0f} GB/s "
          f"({nbytes} bytes)")


def _first_batch(read):
    """The first device batch that the main path's scan ``read(session)``
    yields."""
    import exon_tpu_torch as T

    df = read(T.ExonSession(device="cuda"))
    return next(iter(df._execute(df.logical_plan()).batches()))


def _case(torch, name: str, kernel, plain, nbytes: int, shape: str,
          library=None) -> dict:
    """A kernel against its twin on the same inputs, exact; the medians of
    both, of the library call where there is one, and the bound."""
    got, want = kernel(), plain()
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _exact(name, a, b)
    r = {"max_abs_err": 0.0, "ms": median_ms(kernel, torch),
         "plain_ms": median_ms(plain, torch),
         "library_ms": None if library is None else median_ms(library, torch),
         "bytes": nbytes, "shape": shape}
    lib = "" if library is None else f", library {r['library_ms']:.4f} ms"
    print(f"  {name} ({shape}): kernel {r['ms']:.4f} ms, twin "
          f"{r['plain_ms']:.4f} ms{lib}, bound {bound_ms(nbytes):.4f} ms by "
          "bytes")
    return r


def _lens(col):
    return (col.offsets[1:] - col.offsets[:-1]).long()


def check_sql_kernels(torch, fa_batch, fq_batch) -> dict:
    """The K12 kernels at queries J's and K's shapes, each against its
    twin, bit for bit: span_concat on J's concat_ws (the kernels line) and
    lpad over the first decoded chunk of A; map_bytes on J's upper (beside
    table[values], the library call) and in its word-start mode on J's
    trimmed descriptions (initcap); polya_tail's leading run on J's
    descriptions (trim) and trailing N run on K's left(...) over the first
    FASTQ chunk (rtrim), and, since neither class occurs in those rows,
    both runs at the same shapes on classes that do: 'sp|' leading J's
    ids, {A, C} at either end of K's reads, and ACGT, of which every read
    is made, at both; like_match's position mode on K's strpos over that
    chunk. Each bound counts what the function must move: its inputs'
    offsets, validity and the bytes it reads, its output's bytes and
    offsets."""
    from exon_tpu_torch import datatypes as dt
    from exon_tpu_torch.batch import FixedColumn
    from exon_tpu_torch.kernels import like_match as kl
    from exon_tpu_torch.kernels import map_bytes as km
    from exon_tpu_torch.kernels import polya_tail as kp
    from exon_tpu_torch.kernels import span_concat as ks
    from exon_tpu_torch.ops import sqlfuncs as S
    from exon_tpu_torch.ops.strings import LOWER, UPPER
    from exon_tpu_torch.plan.expressions import _eval_cast

    b = fa_batch
    idc, desc, seq = (b.column(c) for c in ("id", "description", "sequence"))
    n = b.length
    k = _lens(idc) - S.fn_strpos(b, S.fn_substr(b, idc, 4), "|").values - 3
    right = S.fn_right(b, idc, FixedColumn(k, idc.validity))
    upper = torch.from_numpy(UPPER).cuda()
    lower = torch.from_numpy(LOWER).cuda()
    o, v = right.offsets, right.values
    total = int(o[-1])
    _case(torch, "map_bytes J upper",
          lambda: km.map_bytes(o, v, upper, "table"),
          lambda: km.map_bytes_plain(o, v, upper, "table"),
          4 * (n + 1) + 2 * total + 256, f"{n} ids' accession parts, "
          f"{total} bytes", library=lambda: upper[v.long()])
    _class_runs(torch, "J trim", desc, b" ", True, n, "descriptions")
    lead = _class_runs(torch, "J ids 'sp|'", idc, b"sp|", True, n, "ids")
    if not bool((lead > 0).all()):
        fail("polya_tail: 'sp|' should lead every id")
    trimmed = S.fn_trim(b, desc)
    o, v = trimmed.offsets, trimmed.values
    total = int(o[-1])
    initcap = torch.cat([lower, upper])
    _case(torch, "map_bytes J initcap (word-start mode)",
          lambda: km.map_bytes(o, v, initcap, "word_start"),
          lambda: km.map_bytes_plain(o, v, initcap, "word_start"),
          4 * (n + 1) + 2 * total + 512, f"{n} descriptions, {total} bytes")
    # translate, on no query's path, at J's shape: the descriptions with
    # 'a' mapped to 'A' and 'e' and ' ' deleted; the twin runs each kernel's
    # twin (map_bytes, count_bytes, compact_mask), the library call is the
    # map alone
    swaps = [("exon_tpu_torch.ops.sqlfuncs", k)
             for k in ("map_bytes", "count_bytes", "compact_mask")]

    def translate():
        t = S.fn_translate(b, desc, "ae ", "A")
        return t.offsets, t.values

    def translate_twin():
        with _swapped(swaps):
            return translate()

    table = torch.arange(256, dtype=torch.uint8, device="cuda")
    table[ord("a")] = ord("A")
    total, kept = int(_lens(desc).sum()), int(translate()[0][-1])
    _case(torch, "fn_translate J descriptions ('ae ' -> 'A')", translate,
          translate_twin, 4 * (n + 1) + n + total + kept + 4 * (n + 1),
          f"{n} descriptions, {total} bytes in, {kept} out",
          library=lambda: table[desc.values.long()])
    text = _eval_cast(_lens(seq), dt.utf8, b)
    width = torch.full((n,), 5, dtype=torch.int32, device="cuda")
    pad = S.pad_pieces(text, width, b"0", True)
    o1, _v1 = ks.span_concat(*pad)
    kept = int(torch.clamp(_lens(text), max=5).sum())
    _case(torch, "span_concat J lpad", lambda: ks.span_concat(*pad),
          lambda: ks.span_concat_plain(*pad),
          # the text's offsets and validity and the bytes kept, and the pad
          # byte, in; the padded text and its offsets out (the validity
          # passes through)
          4 * (n + 1) + n + kept + 1 + int(o1[-1]) + 4 * (n + 1),
          f"{n} lengths, width 5")
    args = [S.fn_upper(b, right), S.fn_initcap(b, trimmed),
            S.fn_lpad(b, text, 5, "0")]
    ws = S.concat_ws_pieces(b"|", args, n)
    o2, _v2 = ks.span_concat(*ws)
    # each argument's offsets, validity and bytes, and the separator, in;
    # the joined text and its offsets out (every row is valid)
    read = sum(4 * (n + 1) + n + int(a.offsets[-1]) for a in args) + 1
    res = _case(torch, "span_concat J concat_ws", lambda: ks.span_concat(*ws),
                lambda: ks.span_concat_plain(*ws),
                read + int(o2[-1]) + 4 * (n + 1),
                f"{n} rows, 3 columns and 2 separators, {int(o2[-1])} bytes "
                "out")
    # K over the first FASTQ chunk
    fq = fq_batch.column("sequence")
    m = fq_batch.length
    adapter = tuple(ADAPTER.strip("%").encode())
    pos = kl.like_find(fq.offsets, fq.values, adapter)
    lens = _lens(fq)
    need = int(torch.where(pos >= 0, pos.long() + len(adapter), lens).sum())
    _case(torch, "like_match K strpos (position mode)",
          lambda: kl.like_find(fq.offsets, fq.values, adapter),
          lambda: kl.like_find_plain(fq.offsets, fq.values, adapter, False),
          4 * (m + 1) + need + 4 * m, f"{m} reads, {need} bytes read")
    cut = S.fn_left(fq_batch, fq, FixedColumn(
        torch.where(pos >= 0, pos.long(), lens), fq.validity))
    _class_runs(torch, "K rtrim 'N'", cut, b"N", False, m, "cut reads")
    # the K12 numbers (Lib: elementwise torch) at K's shape: coalesce(
    # nullif(strpos, 0) - 1, length) over the chunk's reads
    strpos = FixedColumn(pos.long() + 1, fq.validity)
    length = FixedColumn(lens, fq.validity)

    def numbers():
        hit = S.fn_nullif(fq_batch, strpos, 0)
        return S.fn_coalesce(fq_batch, FixedColumn(hit.values - 1,
                                                   hit.validity), length)

    ms = median_ms(numbers, torch)
    # two int64 columns and their validity in, one out
    nbytes = 3 * 9 * m
    print(f"K12 numbers K coalesce(nullif(strpos, 0) - 1, length) ({m} "
          f"reads): {ms:.4f} ms, bound {bound_ms(nbytes):.4f} ms ({nbytes} "
          "bytes)")
    total = int(_lens(fq).sum())
    lead = _class_runs(torch, "K reads {A, C}", fq, b"AC", True, m, "reads")
    keep = _class_runs(torch, "K reads {A, C}", fq, b"AC", False, m, "reads")
    if not (0 < int(lead.sum()) < total and 0 < int(keep.sum()) < total):
        fail("polya_tail: {A, C} should begin and end some reads, not all")
    both = (lambda: (kp.polya_tail(fq.offsets, fq.values, b"ACGT", True),
                     kp.polya_tail(fq.offsets, fq.values, b"ACGT")))
    lead, keep = both()
    if not (torch.equal(lead.long(), _lens(fq)) and not bool(keep.any())):
        fail("polya_tail: every read should be all ACGT")
    _case(torch, "polya_tail K reads ACGT, both runs of all-class rows", both,
          lambda: (kp.polya_tail_plain(fq.offsets, fq.values, b"ACGT", True),
                   kp.polya_tail_plain(fq.offsets, fq.values, b"ACGT")),
          # each read's bytes once answer both ends
          4 * (m + 1) + total + 8 * m, f"{m} reads, {total} bytes")
    return res


def _class_runs(torch, label: str, col, members: bytes, from_start: bool,
                n: int, rows: str):
    """polya_tail's leading (from_start) or trailing run of the class
    ``members`` over ``col``, kernel against twin; its result."""
    from exon_tpu_torch.kernels import polya_tail as kp

    run = kp.polya_tail(col.offsets, col.values, members, from_start)
    lens = _lens(col)
    if from_start:  # the run, and the byte that ends it
        scanned = int(torch.where(run < lens, run + 1, run).sum())
    else:  # run is the bytes kept: the tail and the byte before it
        scanned = int(torch.where(run > 0, lens - run.long() + 1, lens).sum())
    _case(torch, f"polya_tail {label}, "
          f"{'leading' if from_start else 'trailing'} run",
          lambda: kp.polya_tail(col.offsets, col.values, members, from_start),
          lambda: kp.polya_tail_plain(col.offsets, col.values, members,
                                      from_start),
          4 * (n + 1) + scanned + 4 * n, f"{n} {rows}, {scanned} bytes scanned")
    return run


def _panel_batch(vcf: str):
    """Query L's window input: I_panel's scan (chrom, pos, qual)
    concatenated on the card, as WindowExec concatenates it."""
    import exon_tpu_torch as T
    from exon_tpu_torch.plan.physical import concat_batches

    df = T.ExonSession(device="cuda").sql(
        "SELECT chrom, pos, qual FROM vcf_indexed_scan("
        f"'{vcf}', '{_panel_file(vcf)}')")
    plan = df._execute(df.logical_plan())
    return concat_batches(plan.schema(), list(plan.batches()), "cuda")


def _frame_bytes(fn: str, n: int, values, frame, loop: bool) -> int:
    """What window_frame must move for ``fn`` over n rows: perm and the
    four bounds, the values (as the kernel reads them, 8 bytes) and their
    validity, the prefix arrays the function reads and a RANGE key with
    its validity, each once; the result and its validity written once. A
    sparse-table lookup reads two words a row."""
    nbytes = 8 * n + 16 * n + 9 * n
    if values is not None:
        nbytes += 9 * n
    if fn in ("count", "sum", "avg", "min", "max"):
        nbytes += 8 * n                      # the valid count
    if fn in ("sum", "avg", "dense_rank"):
        nbytes += 8 * n                      # the sum, or the peer starts
    if fn in ("min", "max") and not loop:
        nbytes += 16 * n
    if frame is not None and frame.key is not None:
        nbytes += (frame.key.element_size() + 1) * n
    return nbytes


def check_window_kernels(torch, batch) -> dict:
    """K10 at Query L's shape, the panel's 1,008,303 rows concatenated:
    window_bounds on the sorted key matrix of (chrom, pos) (the kernels
    line) and of (chrom, qual DESC); window_frame in every mode, each
    against its twin bit for bit: L's four calls (lag of pos, the RANGE
    count, the ROWS max, rank under qual DESC), the rest of the rank family
    on the qual sort, lead with a default, sum and avg over L's ROWS frame,
    the value picks over it, and min over the RANGE frame (the sparse-table
    path). No single PyTorch call computes either function."""
    from exon_tpu_torch.kernels import window_bounds as kb
    from exon_tpu_torch.kernels import window_frame as kf
    from exon_tpu_torch.plan import window_exec as W
    from exon_tpu_torch.plan.expressions import ColumnRef, WindowCall

    n, c = batch.length, ColumnRef
    sorts, res = {}, {}
    for label, order in (("chrom, pos", (c("pos"), True)),
                         ("chrom, qual DESC", (c("qual"), False))):
        call = WindowCall("rank", None, [c("chrom")], [order])
        perm, keys, n_part = W.sort_rows(call, batch)
        r = _case(torch, f"window_bounds L ({label})",
                  lambda: kb.window_bounds(keys, n_part),
                  lambda: kb.window_bounds_plain(keys, n_part),
                  8 * keys.numel() + 16 * n,
                  f"{n} rows, {keys.shape[0]} key rows")
        res.setdefault("window_bounds", r)
        sorts[label] = (perm, kb.window_bounds(keys, n_part))
    pos, qual = batch.column("pos"), batch.column("qual")
    perm, bounds = sorts["chrom, pos"]
    range35 = W._frame(WindowCall("count", None, [c("chrom")],
                                  [(c("pos"), True)],
                                  frame=("range", -35, 35)), batch, perm)
    rows5 = kf.Frame(kf.ROWS, -5, 5)
    q = (qual.values, qual.validity)
    p = (pos.values, pos.validity)
    qrank = sorts["chrom, qual DESC"]
    cases = [  # label, fn, sort, values, frame, offset, default
        ("count RANGE 35 (L's cluster_n)", "count", sorts["chrom, pos"],
         (None, None), range35, 1, None),
        ("lag(pos) (L's gap)", "lag", sorts["chrom, pos"], p, None, 1, None),
        ("max(qual) ROWS 5 (L's local_max_qual)", "max",
         sorts["chrom, pos"], q, rows5, 1, None),
        ("rank, qual DESC (L's qual_rank)", "rank", qrank, (None, None),
         None, 1, None),
        ("lead(pos, 2, -1)", "lead", sorts["chrom, pos"], p, None, 2, -1),
        ("sum(qual) ROWS 5", "sum", sorts["chrom, pos"], q, rows5, 1, None),
        ("avg(qual) ROWS 5", "avg", sorts["chrom, pos"], q, rows5, 1, None),
        ("min(qual) RANGE 35 (sparse table)", "min", sorts["chrom, pos"], q,
         range35, 1, None),
        ("first_value(qual) ROWS 5", "first_value", sorts["chrom, pos"], q,
         rows5, 1, None),
        ("last_value(qual) ROWS 5", "last_value", sorts["chrom, pos"], q,
         rows5, 1, None),
        ("nth_value(qual, 3) ROWS 5", "nth_value", sorts["chrom, pos"], q,
         rows5, 3, None),
    ] + [(f"{fn}, qual DESC", fn, qrank, (None, None), None,
          4 if fn == "ntile" else 1, None)
         for fn in ("row_number", "dense_rank", "percent_rank", "cume_dist",
                    "ntile")]
    for label, fn, (perm, bounds), (vals, ok), fr, off, d in cases:
        loop = fn in ("min", "max") and fr is rows5
        r = _case(torch, f"window_frame L {label}",
                  lambda: kf.window_frame(fn, bounds, perm, vals, ok, fr,
                                          off, d),
                  lambda: kf.window_frame_plain(fn, bounds, perm, vals, ok,
                                                fr, off, d),
                  _frame_bytes(fn, n, vals, fr, loop), f"{n} rows, {label}")
        res.setdefault("window_frame", r)
    return res


def _mzml_spectra(n: int) -> tuple:
    """The spectra of benchlib.fixtures.make_mzml(n), replayed from its
    generator: (m/z, intensity) float64 arrays per spectrum."""
    rng = np.random.default_rng(7)
    mz, inten = [], []
    for _ in range(n):
        n_peaks = int(rng.integers(64, 512))
        mz.append(np.sort(rng.uniform(100, 2000, n_peaks)))
        inten.append(rng.uniform(0, 1e6, n_peaks))
    return mz, inten


def _rel_err(a, b) -> float:
    """max |a - b| / |b| over the elements where b is not 0."""
    d = (a - b).abs()
    scale = b.abs()
    nz = scale > 0
    return float((d[nz] / scale[nz]).max()) if bool(nz.any()) else \
        float(d.max()) if d.numel() else 0.0


def check_list_kernels(torch, fq_path: str) -> dict:
    """K11b and the map lookup at the shapes of queries N, O and P:
    map_bytes' widen mode (the DNA codes and the Phred scores) and narrow
    mode (the scores back to text) on the first FASTQ chunk of O's scan,
    beside table[values]; map_lookup on the attribute maps of N's first
    131,072-row batch ('gene_type'); list_bins at P's (check_list_bins).
    Exact, but the bins at relative BINS_RTOL."""
    from benchlib.gencode_gff_fixture import make_gencode_gff
    from exon_tpu_torch.formats.fasta import DNA_CODE
    from exon_tpu_torch.kernels import map_bytes as mb
    from exon_tpu_torch.kernels import map_lookup as ml

    seq = _first_column(lambda s: s.read_fastq(fq_path), "sequence")
    qual = _first_column(lambda s: s.read_fastq(fq_path), "quality_scores")
    n_reads, total = seq[0].shape[0] - 1, seq[1].shape[0]
    dev = seq[1].device
    dna = torch.from_numpy(DNA_CODE.astype(np.int64)).to(dev)
    phred = torch.arange(256, dtype=torch.int64, device=dev) - 33
    shape = f"{n_reads} reads, {total} bases"
    for label, vals, table, out, width in (
            ("integer_encode_dna", seq[1], dna, torch.int8, 1),
            ("quality_scores_to_list", qual[1], phred, torch.int64, 8)):
        _case(torch, f"map_bytes widen ({label})",
              lambda v=vals, t=table, o=out: mb.map_bytes_widen(v, t, o),
              lambda v=vals, t=table, o=out: mb.map_bytes_widen_plain(v, t, o),
              total * (1 + width) + 256 * 8, shape,
              library=lambda v=vals, t=table, o=out: t[v.int()].to(o))
    scores = mb.map_bytes_widen(qual[1], phred, torch.int64)
    _case(torch, "map_bytes narrow (quality_scores_to_string)",
          lambda: mb.map_bytes_narrow(scores),
          lambda: mb.map_bytes_narrow_plain(scores), total * 9, shape)
    del seq, qual, scores

    gf = make_gencode_gff(GENCODE_FEATURES, GENCODE_SEED)
    attrs = _first_batch(lambda s: s.read_gff(gf).select(
        "attributes")).column("attributes")
    keys = attrs.child.children["keys"]
    lit = b"gene_type"
    klen = keys.offsets[1:] - keys.offsets[:-1]
    n_maps, n_ent = attrs.capacity, keys.capacity
    args = (attrs.offsets, keys.offsets, keys.values, keys.validity, lit)
    r_lookup = _case(
        torch, "map_lookup", lambda: ml.map_lookup(*args),
        lambda: ml.map_lookup_plain(*args),
        # the map offsets, every key's offsets and validity, the bytes of
        # the keys as long as the literal, an int32 out per map
        4 * (n_maps + 1) + 5 * n_ent + 4 + len(lit) * int(
            (klen == len(lit)).sum()) + 4 * n_maps,
        f"{n_maps} attribute maps, {n_ent} entries, key 'gene_type'")
    del attrs, keys, args
    return {"map_lookup": r_lookup, "list_bins": check_list_bins(torch)}


def check_list_bins(torch) -> dict:
    """list_bins' peak mode on the m/z lists of P's spectra and its bins
    mode on the spectra that pass P's filter, beside one index_add_ of the
    in-range intensities, at N_BINS (a row's bins in shared memory) and at
    N_BINS_PAST_SHARED (each addition into the output row; printed apart).
    Exact, but the bins at relative BINS_RTOL."""
    from benchlib.fixtures import make_mzml
    from exon_tpu_torch.kernels import list_bins as lb
    from exon_tpu_torch.ops import layout

    mzml = make_mzml(MZML_SPECTRA)
    spectra = _first_batch(lambda s: s.read_mzml(mzml).select(
        "mz", "intensity"))
    mz = spectra.column("mz").children["mz"]
    inten = spectra.column("intensity").children["intensity"]
    offs, vals = mz.offsets, mz.child.values
    n_spec, n_peaks = mz.capacity, vals.shape[0]
    hit = ((vals - TMT_126).abs() <= PEAK_TOL)
    # the elements the peak mode must read: each row's up to its first hit
    dev = vals.device
    row = torch.repeat_interleave(torch.arange(n_spec, device=dev),
                                  (offs[1:] - offs[:-1]).long())
    first = torch.full((n_spec,), n_peaks, dtype=torch.int64, device=dev)
    first.scatter_reduce_(0, row, torch.where(
        hit, torch.arange(n_peaks, device=dev), n_peaks), "amin")
    read = torch.where(first < n_peaks, first + 1 - offs[:-1].long(),
                       (offs[1:] - offs[:-1]).long())
    _case(torch, "list_bins peak (contains_peak)",
          lambda: lb.list_bins_peak(offs, vals, mz.validity, TMT_126,
                                    PEAK_TOL),
          lambda: lb.list_bins_peak_plain(offs, vals, mz.validity, TMT_126,
                                          PEAK_TOL),
          4 * (n_spec + 1) + 8 * int(read.sum()) + 2 * n_spec,
          f"{n_spec} spectra, {n_peaks} peaks, {TMT_126} +- {PEAK_TOL}")
    keep = lb.list_bins_peak(offs, vals, mz.validity, TMT_126, PEAK_TOL)
    kept = layout.filter_batch(spectra, keep)
    kmz = kept.column("mz").children["mz"]
    kin = kept.column("intensity").children["intensity"]
    bargs = (kmz.offsets, kmz.child.values, kin.child.values, BIN_MIN,
             BIN_WIDTH, N_BINS)
    got = lb.list_bins_bins(*bargs)
    want = lb.list_bins_bins_plain(*bargs)
    # atol=0: an empty bin of the twin must be 0 in the kernel's too
    try:
        torch.testing.assert_close(got, want, rtol=BINS_RTOL, atol=0)
    except AssertionError as e:
        fail(f"list_bins bins: kernel and twin differ: {e}")
    err = _rel_err(got, want)
    slot, ok = lb._flat_bins(kmz.offsets, kmz.child.values, BIN_MIN,
                             BIN_WIDTH, N_BINS)
    slot, w = slot[ok], kin.child.values[ok]
    n_kept, k_peaks = kmz.capacity, kmz.child.capacity
    r_bins = {"max_abs_err": float((got - want).abs().max()),
              "ms": median_ms(lambda: lb.list_bins_bins(*bargs), torch),
              "plain_ms": median_ms(lambda: lb.list_bins_bins_plain(*bargs),
                                    torch),
              "library_ms": median_ms(lambda: torch.zeros(
                  n_kept * N_BINS, dtype=torch.float64,
                  device=dev).index_add_(0, slot, w), torch),
              # both lists, the offsets, the bins out
              "bytes": 16 * k_peaks + 4 * (n_kept + 1) + 8 * n_kept * N_BINS,
              "shape": f"{n_kept} spectra with the reporter, {k_peaks} "
                       f"peaks -> {N_BINS} bins each (relative error {err})"}
    print(f"  list_bins bins (bin_vectors, {r_bins['shape']}): kernel "
          f"{r_bins['ms']:.4f} ms, twin {r_bins['plain_ms']:.4f} ms, library "
          f"{r_bins['library_ms']:.4f} ms, bound "
          f"{bound_ms(r_bins['bytes']):.4f} ms by bytes")
    # the kernel's other variant: more bins than a block's shared memory
    # holds, over the same m/z range, each addition into the output row
    big = bargs[:4] + ((2000.0 - BIN_MIN) / N_BINS_PAST_SHARED,
                       N_BINS_PAST_SHARED)
    got = lb.list_bins_bins(*big)
    want = lb.list_bins_bins_plain(*big)
    try:
        torch.testing.assert_close(got, want, rtol=BINS_RTOL, atol=0)
    except AssertionError as e:
        fail(f"list_bins bins past shared memory: kernel and twin differ: "
             f"{e}")
    err = _rel_err(got, want)
    del got, want
    nbytes = 16 * k_peaks + 4 * (n_kept + 1) + 8 * n_kept * N_BINS_PAST_SHARED
    ms = median_ms(lambda: lb.list_bins_bins(*big), torch)
    plain = median_ms(lambda: lb.list_bins_bins_plain(*big), torch)
    print(f"  list_bins bins past shared memory ({n_kept} spectra, {k_peaks} "
          f"peaks -> {N_BINS_PAST_SHARED} bins each, relative error {err}): "
          f"kernel {ms:.4f} ms, twin {plain:.4f} ms, bound "
          f"{bound_ms(nbytes):.4f} ms by bytes")
    return r_bins


def phase_kernels(torch) -> dict:
    import exon_tpu_torch as T
    from benchlib.bam_fixture import make_bam, template_names
    from benchlib.fastq_fixture import make_fastq
    from benchlib.fixtures import make_fasta
    from benchlib.gff_fixture import gff_features

    chunk, ends_in_newline = _fasta_chunk(torch)
    decode = {}
    decode["line_index"], nl = check_line_index(torch, chunk)
    decode["text_records"], lines = check_text_records(torch, chunk, nl,
                                                       ends_in_newline)
    decode["gather_spans"] = check_gather_spans(torch, chunk, lines)
    n_ids = int(lines.is_hdr.sum())  # records in the chunk
    del chunk, nl, lines
    rng = np.random.default_rng(1234)
    offs, vals = _var_column(rng, N_ROWS, torch)
    names = template_names(N_TEMPLATES, BAM_SEED)[: N_TEMPLATES - 14_250]
    results = {
        "compact_mask": check_compact(rng, torch),
        "gather_var": check_gather(rng, torch, offs, vals),
        "like_match": check_like(torch, offs, vals),
        "hash_aggregate": check_hash(rng, torch, _query_i_first_batch(torch)),
        "expand_segments": check_expand(rng, torch),
        "row_hash": check_row_hash(torch, names),
        "string_eq": check_string_eq(rng, torch, names),
        "sort_keys": check_sort_keys(rng, torch, names),
        **decode,
    }
    feats = gff_features(GFF_FEATURES, GFF_SEED)
    results["string_cmp"] = check_string_cmp(torch, n_ids)
    results["parse_number"] = check_parse_number(torch, feats)
    results["format_int"] = check_format_int(torch, feats)
    check_library_programs(rng, torch, offs, vals)
    del offs, vals, feats
    # the sequence UDF kernels' operands, from the first batch of each
    # query's own scan and filter: F's WHERE and H's gc_content see the
    # whole chunk, F's SELECT the reads scoring >= 11, H's trim_polya the
    # GC-rich reads and its reverse_complement their trimmed forms
    fq_path = make_fastq(FASTQ_READS, FASTQ_SEED)
    fn, c = T.FunctionCall, T.col
    score = fn("alignment_score", [c("sequence"), T.lit(SW_QUERY.decode())])

    def gc_rich(s):
        return s.read_fastq(fq_path).filter(
            fn("gc_content", [c("sequence")]) >= GC_MIN)

    fq = _first_column(lambda s: s.read_fastq(fq_path), "sequence")
    f_kept = _first_column(lambda s: s.read_fastq(fq_path).filter(score >= 11),
                           "sequence")
    h_kept = _first_column(gc_rich, "sequence")
    h_trim = _first_column(lambda s: gc_rich(s).select(
        fn("trim_polya", [c("sequence")]).alias("t")), "t")
    bam = _first_column(lambda s: s.read_bam(make_bam(N_TEMPLATES, BAM_SEED)),
                        "sequence")
    results["sw_score"] = check_sw(torch, fq, f_kept)
    results["count_bytes"] = check_count_bytes(torch, bam, fq)
    _print_case("map_bytes whole chunk", check_map_bytes(torch, *fq))
    _print_case("polya_tail whole chunk", check_polya_tail(torch, *fq))
    results["map_bytes"] = check_map_bytes(torch, *h_trim)
    results["polya_tail"] = check_polya_tail(torch, *h_kept)
    fa_path = make_fasta(FASTA_RECORDS, mean_len=MEAN_LEN, seed=42)
    results["span_concat"] = check_sql_kernels(
        torch, _first_batch(lambda s: s.read_fasta(fa_path)),
        _first_batch(lambda s: s.read_fastq(fq_path).select("sequence")))
    from benchlib.vcf_fixture import make_vcf

    results.update(check_window_kernels(
        torch, _panel_batch(make_vcf(VCF_RECORDS, VCF_SEED))))
    results.update(check_list_kernels(torch, fq_path))
    for name, r in results.items():
        r["bound_ms"], r["bound_by"] = _bound(r)
        lib = "" if r["library_ms"] is None else \
            f", library call {r['library_ms']:.4f} ms"
        ops = f", {r['ops']} int32 operations" if "ops" in r else ""
        print(f"kernel {name}: matches twin ({r['shape']}); median of {REPS}: "
              f"kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms{lib}; "
              f"bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['bytes']} bytes{ops})")
    return results


# ---------------------------------------------------------------------------
# Phase 4: main path
# ---------------------------------------------------------------------------


def _expected_a(flat: np.ndarray, offs: np.ndarray):
    lens = np.diff(offs)
    kk = np.flatnonzero((flat[:-1] == ord("K")) & (flat[1:] == ord("K")))
    rec = np.searchsorted(offs, kk, side="right") - 1
    inside = kk + 2 <= offs[rec + 1]
    has_kk = np.zeros(len(lens), bool)
    has_kk[rec[inside]] = True
    return np.flatnonzero((lens > 300) & has_kk)


def _check_a(host, flat, offs, sel, label: str = "A") -> None:
    from exon_tpu_torch.formats.textutil import gather_slices

    if host.length != len(sel):
        fail(f"query {label}: {host.length} rows, expected {len(sel)}")
    ids = b"".join(b"sp|P%06d|PROT%d" % (i, i) for i in sel.tolist())
    idc, seqc = host.column("id"), host.column("sequence")
    if idc.values.tobytes() != ids:
        fail(f"query {label}: ids differ from the generated records")
    vals, want_offs = gather_slices(flat, offs[:-1][sel], offs[1:][sel])
    if not (np.array_equal(seqc.offsets.astype(np.int64), want_offs)
            and np.array_equal(seqc.values, vals)):
        fail(f"query {label}: sequences differ from the generated records")


def _check_b(host, feats) -> None:
    from benchlib.gff_fixture import FEATURE_TYPES, SEQNAMES

    m = feats["type"] == FEATURE_TYPES.index("exon")
    seq, start, end = feats["seqname"][m], feats["start"][m], feats["end"][m]
    _u, first = np.unique(seq, return_index=True)
    order = seq[np.sort(first)]
    n = np.bincount(seq, minlength=len(SEQNAMES))
    span = end - start
    sums = np.zeros(len(SEQNAMES), np.int64)
    np.add.at(sums, seq, span)
    mins = np.full(len(SEQNAMES), np.iinfo(np.int64).max)
    np.minimum.at(mins, seq, start)
    maxs = np.full(len(SEQNAMES), np.iinfo(np.int64).min)
    np.maximum.at(maxs, seq, end)
    if host.length != len(order):
        fail(f"query B: {host.length} groups, expected {len(order)}")
    keyc = host.columns[0]
    names = [keyc.vocab[c] for c in keyc.codes.tolist()]
    if names != [SEQNAMES[s] for s in order]:
        fail("query B: group keys or their first-seen order differ")
    want = [n[order], mins[order], maxs[order], sums[order],
            sums[order] / n[order]]
    for col, w, name in zip(host.columns[1:], want,
                            ("n", "min", "max", "sum", "avg")):
        if not col.validity.all() or not np.array_equal(col.values, w):
            fail(f"query B: column {name} differs")


def _check_sql_gff(host, feats) -> None:
    """SQL_gff against numpy: per (seqname, strand) over the exons, the
    count and the exact sums of start and end (integers below 2^53, so the
    float64 sum is exact in any order), groups in first-seen order."""
    from benchlib.gff_fixture import FEATURE_TYPES, SEQNAMES

    m = np.flatnonzero(feats["type"] == FEATURE_TYPES.index("exon"))
    key = feats["seqname"][m] * 2 + feats["strand"][m]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)
    want = {
        "seqname": [SEQNAMES[k // 2] for k in uniq[order]],
        "dir": [("fwd", "rev")[k % 2] for k in uniq[order]],
        "n": np.bincount(inv)[order],
        "s": np.bincount(inv, weights=feats["start"][m].astype(np.float64)
                         )[order].astype(np.int64),
        "e": np.bincount(inv, weights=feats["end"][m].astype(np.float64)
                         )[order]}
    if host.length != len(uniq):
        fail(f"query SQL_gff: {host.length} groups, expected {len(uniq)}")
    for name, w in want.items():
        col = host.column(name)
        got = [col.vocab[c] for c in col.codes.tolist()] \
            if name in ("seqname", "dir") else col.values
        if not col.validity.all() or not np.array_equal(got, w):
            fail(f"query SQL_gff: column {name} differs from numpy")
    print(f"query SQL_gff: {host.length} (seqname, dir) groups; counts and "
          "the sums of start and end match numpy exactly")


def _same_batch(a, b) -> bool:
    """Two host batches hold the same values, validity and order."""
    if a.length != b.length or a.schema.names != b.schema.names:
        return False
    return all(np.array_equal(_values_of(x), _values_of(y))
               and np.array_equal(x.validity, y.validity)
               for x, y in zip(a.columns, b.columns))


def _sql_vs_dataframe(session, T, fa, vcf, torch) -> None:
    """Each SQL query beside its DataFrame twin: host-clock walls run as
    twin, SQL, SQL, twin, the results equal, and SQL's own parse, bind and
    plan time (session.sql, optimize and the physical plan, nothing run).
    SQL_gff is not run here (its four runs took ~90 s): its main-path run
    is checked against numpy."""
    c = T.col
    pairs = {
        "SQL_count": (
            SQL_COUNT.format(fa=fa),
            lambda: session.read_fasta(fa).filter(
                (T.FunctionCall("length", [c("sequence")]) > 300)
                & c("sequence").like("%KK%")).aggregate(
                [], [T.count().alias("count(*)")])),
        "SQL_range": (
            SQL_RANGE.format(fa=fa),
            lambda: session.read_fasta(fa).filter(
                (c("id") >= RANGE[0].decode()) & (c("id") < RANGE[1].decode())
            ).select("id", "sequence")),
        "I": (
            SQL_I.format(vcf=vcf, region=VCF_REGION),
            lambda: session.read_vcf(vcf).filter(T.FunctionCall(
                "vcf_region_filter", [T.lit(VCF_REGION), c("chrom"),
                                      c("pos")])
            ).filter(c("qual") >= 30).aggregate(
                ["chrom", "ref"],
                [T.count().alias("n"), T.avg(c("qual")).alias("mean_qual"),
                 T.AggregateCall("stddev", c("qual")).alias("sd_qual"),
                 T.AggregateCall("var_pop", c("qual")).alias("var_qual")])),
    }
    for label, (sql, twin) in pairs.items():
        walls, outs = {"twin": [], "sql": []}, {}
        for kind in ("twin", "sql", "sql", "twin"):
            t = time.perf_counter()
            outs[kind] = (twin() if kind == "twin" else session.sql(sql)
                          ).collect_host()
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t)
        if not _same_batch(outs["sql"], outs["twin"]):
            fail(f"query {label}: SQL and its DataFrame twin differ")
        plan_s = []
        for _ in range(5):
            t = time.perf_counter()
            df = session.sql(sql)
            df._execute(df.logical_plan())
            plan_s.append(time.perf_counter() - t)
        print(f"query {label} vs its DataFrame twin (same result): SQL walls "
              f"{', '.join(f'{w:.3f}' for w in walls['sql'])} s, twin walls "
              f"{', '.join(f'{w:.3f}' for w in walls['twin'])} s; SQL parse, "
              f"bind and plan alone {1e3 * float(np.median(plan_s)):.3f} ms "
              "(median of 5)")


def _names_of(col) -> np.ndarray:
    """A host VarColumn of names as a numpy bytes array."""
    offs = col.offsets.astype(np.int64)
    lens = np.diff(offs)
    width = int(lens.max()) if len(lens) else 1
    idx = offs[:-1, None] + np.arange(width)
    mat = np.where(np.arange(width) < lens[:, None],
                   col.values[np.minimum(idx, max(len(col.values) - 1, 0))], 0)
    return np.ascontiguousarray(mat.astype(np.uint8)).view(f"S{width}").ravel()


def _codes_of(col, names) -> np.ndarray:
    """A host DictColumn as codes into ``names`` (-1 for NULL)."""
    table = np.asarray([names.index(v) for v in col.vocab] or [0])
    return np.where(col.validity, table[col.codes], -1)


def _values_of(col) -> np.ndarray:
    """A host column's values as numpy (strings as bytes or str)."""
    from exon_tpu_torch.batch import DictColumn, VarColumn

    if isinstance(col, VarColumn):
        return _names_of(col)
    if isinstance(col, DictColumn):
        return np.asarray(list(col.vocab) or [""])[col.codes]
    return col.values


def _rank(names) -> np.ndarray:
    """Byte order of each name: the order a string sort key gives them."""
    return np.argsort(np.argsort(np.asarray(names)))


def _expected_c(reads, feats):
    """Query C from the generators' arrays: (read rows, gene rows, pairs
    emitted by the equi-join before the overlap filter)."""
    from benchlib.gff_fixture import FEATURE_TYPES

    genes = np.flatnonzero(feats["type"] == FEATURE_TYPES.index("gene"))
    gkey = feats["seqname"][genes] * 4096 + feats["start"][genes] // W
    order = np.argsort(gkey, kind="stable")
    rkey = reads["reference"] * 4096 + reads["start"] // W
    lo = np.searchsorted(gkey[order], rkey, "left")
    cnt = np.searchsorted(gkey[order], rkey, "right") - lo
    ridx = np.repeat(np.arange(len(rkey)), cnt)
    first = np.repeat(np.cumsum(cnt) - cnt, cnt)
    gidx = genes[order[np.repeat(lo, cnt) + np.arange(len(ridx)) - first]]
    start = reads["start"][ridx]
    keep = (start >= feats["start"][gidx]) & (start <= feats["end"][gidx])
    return ridx[keep], gidx[keep], len(ridx)


def _check_c(host, reads, feats, label: str) -> int:
    from benchlib.gff_fixture import SEQNAMES

    ridx, gidx, pairs = _expected_c(reads, feats)
    if host.length != len(ridx):
        fail(f"query {label}: {host.length} rows, expected {len(ridx)}")
    got = {
        "reference": _codes_of(host.column("reference"), SEQNAMES),
        "start": host.column("start").values,
        "name": _names_of(host.column("name")),
        "gene_start": host.column("gene_start").values,
        "end": host.column("end").values,
        "seqname": _codes_of(host.column("seqname"), SEQNAMES),
        "gene_end": host.column("gene_end").values,
        "strand": _codes_of(host.column("strand"), ["+", "-"]),
    }
    want = {
        "reference": reads["reference"][ridx], "start": reads["start"][ridx],
        "name": reads["names"][reads["template"][ridx]],
        "gene_start": feats["start"][gidx], "end": reads["end"][ridx],
        "seqname": feats["seqname"][gidx], "gene_end": feats["end"][gidx],
        "strand": feats["strand"][gidx],
    }
    rank = _rank(SEQNAMES)
    order_keys = ("gene_start", "name", "start")
    got_order = np.lexsort(tuple(got[k] for k in order_keys)
                           + (rank[got["reference"]],))
    if not np.array_equal(got_order, np.arange(host.length)):
        fail(f"query {label}: rows are not in (reference, start, name, "
             "gene_start) order")
    # rows that tie on every sort key compare as a set: order both sides
    # by every column before comparing
    def full(d):
        return np.lexsort(tuple(d[k] for k in reversed(list(want))))

    g, w = full(got), full(want)
    for k in want:
        if not np.array_equal(got[k][g], want[k][w]):
            fail(f"query {label}: column {k} differs")
    print(f"query {label}: {pairs} join pairs, {host.length} rows after the "
          "overlap filter, every column and the order match numpy")
    return pairs


def _check_d(host, reads) -> int:
    from benchlib.bam_fixture import FLAG_R2
    from benchlib.gff_fixture import SEQNAMES

    r1 = np.flatnonzero(reads["flag"] != FLAG_R2)
    names = reads["names"][reads["template"][r1]]
    order = np.lexsort((names, reads["start"][r1],
                        _rank(SEQNAMES)[reads["reference"][r1]]))
    r1, names = r1[order], names[order]
    mate = reads["mate_start"][r1]
    paired = mate > 0
    if host.length != len(r1):
        fail(f"query D: {host.length} rows, expected {len(r1)}")
    checks = {
        "name": (_names_of(host.column("name")), names),
        "reference": (_codes_of(host.column("reference"), SEQNAMES),
                      reads["reference"][r1]),
        "start": (host.column("start").values, reads["start"][r1]),
        "flag": (host.column("flag").values, reads["flag"][r1]),
        "mate_start": (host.column("mate_start").values[paired],
                       mate[paired]),
        "mate_flag": (host.column("mate_flag").values[paired],
                      np.full(paired.sum(), FLAG_R2)),
        "mate_name": (_names_of(host.column("mate_name"))[paired],
                      names[paired]),
    }
    for k, (g, w) in checks.items():
        if not np.array_equal(g, w):
            fail(f"query D: column {k} differs")
    for k in ("mate_name", "mate_start", "mate_flag"):
        if not np.array_equal(host.column(k).validity, paired):
            fail(f"query D: NULL mates of {k} differ")
    n_null = int((~paired).sum())
    print(f"query D: {host.length} rows, {n_null} with NULL mates; every "
          "column and the order match numpy")
    return n_null


def _check_e(host, r: dict, rows: np.ndarray) -> None:
    from benchlib.fastq_fixture import READ_LEN

    if host.length != len(rows):
        fail(f"query E: {host.length} rows, expected {len(rows)}")
    if not np.array_equal(_names_of(host.column("name")), r["names"][rows]):
        fail("query E: names differ from the generated reads")
    for name, key in (("sequence", "sequences"),
                      ("quality_scores", "qualities")):
        c = host.column(name)
        if not (np.array_equal(c.offsets, READ_LEN * np.arange(len(rows) + 1))
                and c.values.tobytes() == r[key][rows].tobytes()):
            fail(f"query E: {name} differs from the generated reads")
    planted = int((r["adapter_at"] >= 0).sum())
    print(f"query E: {host.length} reads hold the adapter ({planted} "
          "planted); names, sequences and qualities match the generator")


def _sw_numpy(seqs: np.ndarray, query: bytes) -> np.ndarray:
    """Plain Smith-Waterman (Gotoh) in numpy over reads of one length, the
    reads in parallel: match +1, mismatch -1, a gap of length L costs
    -(1 + L), scores clamp at 0; each read's best cell."""
    m, width = seqs.shape
    neg = -(1 << 20)
    best = np.zeros(m, np.int64)
    h_prev = np.zeros((m, width + 1), np.int64)
    e = np.full((m, width + 1), neg, np.int64)
    zero = np.zeros(m, np.int64)
    for qc in query:
        h = np.zeros((m, width + 1), np.int64)
        f = np.full(m, neg, np.int64)
        for j in range(1, width + 1):
            e[:, j] = np.maximum(h_prev[:, j] - 2, e[:, j] - 1)
            f = np.maximum(h[:, j - 1] - 2, f - 1)
            s = np.where(seqs[:, j - 1] == qc, 1, -1)
            h[:, j] = np.maximum(np.maximum(zero, h_prev[:, j - 1] + s),
                                 np.maximum(e[:, j], f))
            best = np.maximum(best, h[:, j])
        h_prev = h
    return best


def _check_f(host, twin, r: dict, rows_e: np.ndarray) -> None:
    """Query F: the reads scoring 13 are exactly the adapter's copies, the
    result equals the run with sw_score's twin, and a plain numpy DP gives
    the same scores on a seeded sample of 2,000 reads."""
    names, score = _names_of(host.column("name")), host.column("score").values
    if not np.array_equal(names[score == 13], r["names"][rows_e]):
        fail("query F: the reads scoring 13 are not the adapter's copies")
    if not _same_batch(host, twin):
        fail("query F: the result differs from the run on sw_score's twin")
    sample = np.sort(np.random.default_rng(FASTQ_SEED).choice(
        len(r["names"]), 2000, replace=False))
    want = _sw_numpy(r["sequences"][sample], SW_QUERY)
    got_of = dict(zip(names.tolist(), score.tolist()))
    got = np.asarray([got_of.get(nm, -1) for nm in r["names"][sample]])
    if not np.array_equal(got, np.where(want >= 11, want, -1)):
        fail("query F: scores differ from a plain DP on the sampled reads")
    print(f"query F: {host.length} reads score >= 11, {int((score == 13).sum())}"
          " score 13 (the adapter's copies); equal to the run on the twin; a "
          f"numpy DP agrees on 2,000 sampled reads ({int((want >= 11).sum())} "
          "of them kept)")


def _check_g(host, bam_host) -> None:
    """Query G against numpy over the host decode's sequence and flag: per
    reference (NULL its own group) in first-seen order, the count and the
    mean of the float32 G/C share."""
    ref, seq = bam_host.column("reference"), bam_host.column("sequence")
    flag = bam_host.column("flag").values
    offs = seq.offsets.astype(np.int64)
    is_gc = np.isin(seq.values, np.frombuffer(b"GCgc", np.uint8))
    csum = np.concatenate([[0], np.cumsum(is_gc)])
    lens = np.diff(offs)
    gc = np.where(lens > 0, (csum[offs[1:]] - csum[offs[:-1]]).astype(
        np.float32) / np.maximum(lens, 1).astype(np.float32), np.float32(0))
    keep = np.flatnonzero(((flag & 0x40) != 0) & ((flag & 0x8) == 0))
    key = np.where(ref.validity, ref.codes, -1)[keep]
    uniq, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)
    n = np.bincount(inv)[order]
    mean = (np.bincount(inv, weights=gc[keep].astype(np.float64))[order] / n)
    names = [None if k < 0 else ref.vocab[k] for k in uniq[order]]
    kc = host.column("reference")
    got = [kc.vocab[c] if ok else None
           for c, ok in zip(kc.codes.tolist(), kc.validity.tolist())]
    if got != names:
        fail("query G: group keys or their first-seen order differ")
    if not np.array_equal(host.column("n").values, n):
        fail("query G: counts differ from numpy")
    diff = np.abs(host.column("gc").values - mean)
    if not (diff <= FLOAT_RTOL * mean).all():
        fail(f"query G: mean GC differs from numpy beyond rtol {FLOAT_RTOL}")
    print(f"query G: {host.length} references, {len(keep)} R1 reads with a "
          f"mapped mate; counts exact, mean GC within {diff.max():.3e} of "
          "numpy")


def _check_h(host, r: dict) -> None:
    """Query H against numpy: the reads with a G/C share >= 0.55 (float32),
    each less its trailing A/a run, reverse-complemented."""
    from benchlib.fastq_fixture import READ_LEN

    seqs = r["sequences"]
    gc = np.isin(seqs, np.frombuffer(b"GCgc", np.uint8)).sum(1).astype(
        np.float32) / np.float32(READ_LEN)
    rows = np.flatnonzero(gc >= np.float32(GC_MIN))
    kept = seqs[rows]
    not_a = ~np.isin(kept, np.frombuffer(b"Aa", np.uint8))
    tlen = np.where(not_a.any(1), READ_LEN - np.argmax(not_a[:, ::-1], 1), 0)
    comp = np.arange(256, dtype=np.uint8)
    comp[list(b"ACGTacgtNnUu")] = list(b"TGCAtgcaNnAa")
    mirrored = kept[:, ::-1]
    vals = comp[mirrored[np.arange(READ_LEN) >= (READ_LEN - tlen)[:, None]]]
    offs = np.concatenate([[0], np.cumsum(tlen)])
    rc = host.column("rc")
    if host.length != len(rows) or not np.array_equal(
            _names_of(host.column("name")), r["names"][rows]):
        fail(f"query H: {host.length} rows, expected {len(rows)}, or names "
             "differ")
    if not (np.array_equal(rc.offsets, offs)
            and rc.values.tobytes() == vals.tobytes()):
        fail("query H: trimmed reverse complements differ from numpy")
    print(f"query H: {host.length} GC-rich reads, {int((tlen < READ_LEN).sum())}"
          " trimmed; names and reverse complements match numpy")


def _kk_rows(flat: np.ndarray, offs: np.ndarray) -> np.ndarray:
    """The records whose sequence holds 'KK'."""
    kk = np.flatnonzero((flat[:-1] == ord("K")) & (flat[1:] == ord("K")))
    rec = np.searchsorted(offs, kk, side="right") - 1
    has = np.zeros(len(offs) - 1, bool)
    has[rec[kk + 2 <= offs[rec + 1]]] = True
    return np.flatnonzero(has)


def _var_rows(col) -> list:
    o = col.offsets.tolist()
    raw = col.values.tobytes()
    return [raw[o[i]:o[i + 1]] for i in range(len(o) - 1)]


def _check_j(host, flat, offs) -> None:
    """Query J against the generated records: for each record with 'KK',
    its accession and 'PROT<i>|Synthetic Protein <i>|<length, 5 digits>'."""
    rows = _kk_rows(flat, offs)
    lens = np.diff(offs)
    acc = [b"P%06d" % i for i in rows.tolist()]
    lab = [b"PROT%d|Synthetic Protein %d|%05d" % (i, i, n)
           for i, n in zip(rows.tolist(), lens[rows].tolist())]
    if host.length != len(rows) or _var_rows(host.column("accession")) != acc \
            or _var_rows(host.column("label")) != lab:
        fail(f"query J: {host.length} rows (expected {len(rows)}), or the "
             "accessions or labels differ from the generated records")
    print(f"query J: {host.length} records with 'KK'; accessions and labels "
          "match the generated records byte for byte")


def _check_j_agg(host, offs) -> None:
    """Query J_agg against the generated records: per bucket of 10,000
    record numbers (the first two digits of the six), the count, the first
    id, the lexicographic maximum of the descriptions and the median length
    (np.median, rounded half to even as the JAX package rounds it)."""
    from exon_tpu_torch.batch import host_pylists

    n = len(offs) - 1
    lens = np.diff(offs)
    want = []
    for b in range((n + 9_999) // 10_000):
        ids = range(b * 10_000, min(n, (b + 1) * 10_000))
        want.append([b"%02d" % b, len(ids), b"sp|P%06d|PROT%d" % (ids[0],
                                                               ids[0]),
                     max(b"synthetic protein %d" % i for i in ids),
                     int(np.rint(np.median(lens[ids[0]:ids[-1] + 1]
                                           .astype(np.float64))))])
    cols = host_pylists(host)
    got = [[c[r].encode() if isinstance(c[r], str) else c[r] for c in cols]
           for r in range(host.length)]
    if got != want:
        fail(f"query J_agg: {host.length} groups, expected {len(want)}, or "
             "their values differ from the generated records")
    print(f"query J_agg: {host.length} buckets in first-seen order; counts, "
          "MIN(id), MAX(description) and medians match numpy")


def _first_adapter(r: dict) -> np.ndarray:
    """Each read's leftmost adapter start, or -1 (a byte search over the
    reads, one line each, as adapter_rows does)."""
    from benchlib.fastq_fixture import ADAPTER as AD, READ_LEN

    n = len(r["sequences"])
    lines = np.empty((n, READ_LEN + 1), np.uint8)
    lines[:, :READ_LEN] = r["sequences"]
    lines[:, READ_LEN] = ord("\n")
    blob = lines.tobytes()
    at = np.full(n, -1, np.int64)
    pos = blob.find(AD)
    while pos != -1:
        row = pos // (READ_LEN + 1)
        at[row] = pos - row * (READ_LEN + 1)
        pos = blob.find(AD, (row + 1) * (READ_LEN + 1))
    return at


def _check_k(host, r: dict, first: np.ndarray) -> None:
    """Query K against numpy: each read cut before its first adapter (no
    'N' to strip: the reads are ACGT), its length histogram and the bytes
    removed per length, ordered by length."""
    from benchlib.fastq_fixture import READ_LEN

    if (r["sequences"] == ord("N")).any():
        fail("query K: the fixture's reads hold an 'N'; this check assumes "
             "none")
    t = np.where(first >= 0, first, READ_LEN)
    lens, counts = np.unique(t, return_counts=True)
    got = [host.column(c).values for c in ("len", "n", "removed")]
    if not (np.array_equal(got[0], lens) and np.array_equal(got[1], counts)
            and np.array_equal(got[2], counts * (READ_LEN - lens))):
        fail("query K: the trimmed-length histogram differs from numpy")
    print(f"query K: {host.length} trimmed lengths, {int((first >= 0).sum())}"
          " reads cut; counts and bytes removed match numpy")


def _region(text: str) -> tuple[int, int, int]:
    """(contig code, first, last position) of a region string."""
    from benchlib.gff_fixture import SEQNAMES

    name, span = text.split(":")
    lo, hi = span.split("-")
    return SEQNAMES.index(name), int(lo), int(hi)


def _panel_regions() -> list:
    """I_panel's windows: 1-10,000,000 on every contig, in file order."""
    from benchlib.gff_fixture import SEQNAMES

    return [(i, 1, PANEL_END) for i in range(len(SEQNAMES))]


def _panel_file(vcf: str) -> str:
    """I_panel's region file beside the VCF, one region a line."""
    from benchlib.gff_fixture import SEQNAMES

    path = os.path.splitext(vcf)[0] + ".panel.txt"
    with open(path, "w") as f:
        f.write("".join(f"{c}:{lo}-{hi}\n" for (code, lo, hi), c in zip(
            _panel_regions(), SEQNAMES)))
    return path


def _in_regions(calls: dict, regions: list) -> np.ndarray:
    keep = np.zeros(len(calls["pos"]), bool)
    for code, lo, hi in regions:
        keep |= (calls["chrom"] == code) & (calls["pos"] >= lo) & \
            (calls["pos"] <= hi)
    return keep


def _region_rows(calls: dict, regions: list) -> int:
    """Records the tabix seek and the exact row filter should keep."""
    return int(_in_regions(calls, regions).sum())


def _chunk_records(vcf: str, regions: list) -> int:
    """Records the tabix seek inflates for ``regions``: the lines of every
    coalesced chunk, before the exact row filter, read as the scan reads
    them (parse_tabix, coalesce_chunks, read_bgzf_chunk)."""
    from benchlib.gff_fixture import SEQNAMES
    from exon_tpu_torch.indexes import parse_tabix
    from exon_tpu_torch.io import coalesce_chunks, read_bgzf_chunk
    from exon_tpu_torch.region import Region

    with open(vcf + ".tbi", "rb") as f:
        tbi = parse_tabix(f.read())
    size = os.path.getsize(vcf)
    n = 0
    for code, lo, hi in regions:
        for chunk in coalesce_chunks(tbi.query(Region(SEQNAMES[code], lo,
                                                      hi))):
            n += read_bgzf_chunk(vcf, chunk, size).count(b"\n")
    return n


def _qual30_rows(calls: dict, regions: list) -> np.ndarray:
    """The fixture's rows in the regions with qual >= 30, in file order."""
    keep = _in_regions(calls, regions) & calls["qual_valid"] & \
        (calls["qual"] >= np.float32(30))
    return np.flatnonzero(keep)


def _chrom_ref_groups(calls: dict, rows: np.ndarray) -> tuple:
    """The (chrom, REF) groups of ``rows``: each group's first row (an
    index into ``rows``), the groups in first-seen order, and each row's
    group in that order."""
    ro = calls["ref_offsets"]
    lens = ro[rows + 1] - ro[rows]
    # each REF (1-12 of ACGT) packed 2 bits a base beside its length and
    # contig: one int64 key per row
    flat_rows = np.repeat(rows, lens)
    within = np.arange(int(lens.sum())) - np.repeat(np.cumsum(lens) - lens,
                                                    lens)
    code = np.searchsorted(np.frombuffer(b"ACGT", np.uint8),
                           calls["ref_values"][ro[flat_rows] + within])
    packed = np.zeros(len(rows), np.int64)
    np.add.at(packed, np.repeat(np.arange(len(rows)), lens),
              code.astype(np.int64) << (2 * within))
    key = (calls["chrom"][rows].astype(np.int64) << 32) | (lens << 24) | \
        packed
    _u, first, inv = np.unique(key, return_index=True, return_inverse=True)
    order = np.argsort(first)           # groups in first-seen order
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    return first, order, rank[inv]


def _check_i(host, calls: dict, regions: list, label: str) -> None:
    """Query I against numpy over the fixture's arrays: per (chrom, ref) in
    first-seen order, the count exact, the mean of the float32 qual at
    relative 1e-5, the sample stddev and the population variance at
    relative 1e-9 against a two-pass float64 computation; NULL stddev for
    a group of one row."""
    from benchlib.gff_fixture import SEQNAMES

    rows = _qual30_rows(calls, regions)
    first, order, g = _chrom_ref_groups(calls, rows)
    x = calls["qual"][rows].astype(np.float64)
    n = np.bincount(g)
    mean = np.bincount(g, x) / n
    m2 = np.bincount(g, (x - mean[g]) ** 2)
    if host.length != len(n):
        fail(f"query {label}: {host.length} groups, expected {len(n)}")
    chrom, ref = host.column("chrom"), host.column("ref")
    names = [chrom.vocab[c] for c in chrom.codes.tolist()]
    want_names = [SEQNAMES[c] for c in calls["chrom"][rows[first[order]]]]
    got_refs = [bytes(ref.values[ref.offsets[i]:ref.offsets[i + 1]])
                for i in range(host.length)]
    fr = rows[first[order]]
    ro = calls["ref_offsets"]
    want_refs = [bytes(calls["ref_values"][ro[r]:ro[r + 1]]) for r in fr]
    if names != want_names or got_refs != want_refs:
        fail(f"query {label}: group keys or their first-seen order differ")
    if not np.array_equal(host.column("n").values, n):
        fail(f"query {label}: counts differ")
    multi = n >= 2
    sd = host.column("sd_qual")
    checks = (
        ("mean_qual", host.column("mean_qual").values, mean, AVG_RTOL,
         np.ones(len(n), bool)),
        ("var_qual", host.column("var_qual").values, m2 / n, VAR_RTOL,
         np.ones(len(n), bool)),
        ("sd_qual", sd.values[multi], np.sqrt(m2[multi] / (n[multi] - 1)),
         VAR_RTOL, multi))
    for name, got, want, rtol, valid in checks:
        if not np.array_equal(host.column(name).validity, valid):
            fail(f"query {label}: {name} NULLs differ")
        if not np.allclose(got, want, rtol=rtol, atol=0):
            fail(f"query {label}: {name} differs beyond rtol {rtol}")
    print(f"query {label}: {host.length} (chrom, ref) groups over "
          f"{len(rows)} rows with qual >= 30 match numpy (counts exact, "
          f"var/stddev within {VAR_RTOL}, mean within {AVG_RTOL}; "
          f"{int((~multi).sum())} one-row groups with NULL stddev)")


def _check_l(host, calls: dict) -> None:
    """Query L against numpy over the fixture's panel rows (file order,
    which is (contig, pos) order): gap by np.diff within each contig, the
    RANGE count by np.searchsorted, the ROWS max as a sliding max that
    skips NULL quals, the rank as the min-method rank of -qual with NULLs
    first; all exact."""
    from benchlib.gff_fixture import SEQNAMES

    rows = np.flatnonzero(_in_regions(calls, _panel_regions()))
    if host.length != len(rows):
        fail(f"query L: {host.length} rows, expected {len(rows)}")
    chrom, pos = calls["chrom"][rows], calls["pos"][rows].astype(np.int64)
    q, qv = calls["qual"][rows], calls["qual_valid"][rows]
    col = host.column("chrom")
    codes = np.asarray([SEQNAMES.index(v) for v in col.vocab])[col.codes]
    if not (np.array_equal(codes, chrom)
            and np.array_equal(host.column("pos").values, pos)
            and np.array_equal(host.column("qual").validity, qv)):
        fail("query L: chrom, pos or qual's NULLs differ from the fixture")
    new = np.r_[True, chrom[1:] != chrom[:-1]]
    gap = host.column("gap")
    if not (np.array_equal(gap.validity, ~new) and np.array_equal(
            gap.values[~new], np.diff(pos)[~new[1:]])):
        fail("query L: gap differs from np.diff within each contig")
    want_n = np.zeros(len(rows), np.int64)
    want_max = np.zeros(len(rows), np.float32)
    want_ok = np.zeros(len(rows), bool)
    want_rank = np.zeros(len(rows), np.int64)
    for c in np.unique(chrom):
        at = np.flatnonzero(chrom == c)
        p = pos[at]
        want_n[at] = np.searchsorted(p, p + 35, "right") - \
            np.searchsorted(p, p - 35, "left")
        x = np.pad(np.where(qv[at], q[at], -np.inf), 5,
                   constant_values=-np.inf)
        win = np.lib.stride_tricks.sliding_window_view(x, 11).max(axis=1)
        want_max[at], want_ok[at] = np.where(win > -np.inf, win, 0), \
            win > -np.inf
        nulls = int((~qv[at]).sum())
        neg = np.sort(-q[at][qv[at]])
        want_rank[at] = np.where(qv[at], nulls + 1 + np.searchsorted(
            neg, -q[at], "left"), 1)
    mx = host.column("local_max_qual")
    checks = (
        ("cluster_n", np.array_equal(host.column("cluster_n").values,
                                     want_n)),
        ("local_max_qual", np.array_equal(mx.validity, want_ok)
         and np.array_equal(mx.values[want_ok], want_max[want_ok])),
        ("qual_rank", np.array_equal(host.column("qual_rank").values,
                                     want_rank)))
    for name, ok in checks:
        if not ok:
            fail(f"query L: {name} differs from numpy")
    print(f"query L: {host.length} rows over {len(np.unique(chrom))} contigs "
          f"match numpy exactly (gap, RANGE 35 counts up to "
          f"{int(want_n.max())}, ROWS 5 max with {int((~want_ok).sum())} "
          f"NULL windows, qual ranks with {int((~qv).sum())} NULL quals "
          "first)")


def _check_m(host, calls: dict, regions: list) -> None:
    """Query M against numpy: the (chrom, REF) counts of the regions' rows
    with qual >= 30 in first-seen order, then each contig's subtotal (REF
    NULL), then the total (both NULL); exact."""
    from benchlib.gff_fixture import SEQNAMES

    rows = _qual30_rows(calls, regions)
    first, order, g = _chrom_ref_groups(calls, rows)
    n_groups = len(order)
    chroms = calls["chrom"][rows]
    _u, cfirst = np.unique(chroms, return_index=True)
    contigs = chroms[np.sort(cfirst)]   # first-seen order
    if host.length != n_groups + len(contigs) + 1:
        fail(f"query M: {host.length} rows, expected {n_groups} + "
             f"{len(contigs)} + 1")
    from exon_tpu_torch.batch import host_pylists

    names, refs, cnt = host_pylists(host)
    cnt = np.asarray(cnt)
    fr = rows[first[order]]
    ro = calls["ref_offsets"]
    want_refs = [bytes(calls["ref_values"][ro[r]:ro[r + 1]]).decode()
                 for r in fr] + [None] * (len(contigs) + 1)
    want = ([SEQNAMES[c] for c in calls["chrom"][fr]]
            + [SEQNAMES[c] for c in contigs] + [None])
    if names != want or refs != want_refs:
        fail("query M: the ROLLUP's keys or their order differ")
    sub = [int((chroms == c).sum()) for c in contigs]
    if not (np.array_equal(cnt[:n_groups], np.bincount(g))
            and cnt[n_groups:-1].tolist() == sub and cnt[-1] == len(rows)):
        fail("query M: counts differ from numpy")
    print(f"query M: {n_groups} (chrom, ref) rows, {len(contigs)} contig "
          f"subtotals and the total ({len(rows)} calls with qual >= 30) "
          "match numpy exactly")


def _check_n(host, feats: dict) -> None:
    """Query N against numpy: genes at levels 1-2 counted by gene_type,
    ordered by count (descending), then by name, the first N_TOP."""
    from benchlib.gencode_gff_fixture import GENE_TYPES

    genes = (feats["type"] == 0) & (feats["level"] <= 1)
    counts = np.bincount(feats["gene_type"][genes], minlength=len(GENE_TYPES))
    want = sorted(((-int(c), GENE_TYPES[k]) for k, c in enumerate(counts)
                   if c), key=lambda t: (t[0], t[1].encode()))
    n_types = len(want)
    if n_types <= N_TOP:
        fail(f"query N: {n_types} gene types, so LIMIT {N_TOP} cuts nothing")
    want = want[:N_TOP]
    got = list(zip((-host.column("n").values).tolist(),
                   [x.decode() for x in _names_of(host.column("gene_type"))]))
    if got != want:
        fail(f"query N: {got[:5]} ..., expected {want[:5]} ...")
    print(f"query N: the top {host.length} of {n_types} gene types over "
          f"{int(genes.sum())} genes at levels 1-2 match the generator's "
          "arrays")


def _check_topk(df, fetch: int, q: str) -> None:
    """The plan of ``df`` sorts with a fetch of ``fetch`` rows: the
    planner's Limit(Sort) rewrite, which truncates each sort run (TopK)."""
    from exon_tpu_torch.plan import physical as P
    from exon_tpu_torch.plan.planner import create_physical_plan, optimize

    stack = [create_physical_plan(optimize(df.logical_plan()), "cuda")]
    while stack:
        node = stack.pop()
        if isinstance(node, P.SortExec) and node.fetch == fetch:
            return
        stack.extend(node.children())
    fail(f"query {q}: its plan has no SortExec with fetch {fetch} (TopK)")


def _check_o(batches: list, r: dict, torch) -> None:
    """Query O on the card: each batch's codes, scores and round trip
    against the generator's reads of that batch, uploaded; the names on
    the host."""
    from benchlib.fastq_fixture import READ_LEN
    from exon_tpu_torch.batch import Batch
    from exon_tpu_torch.formats.fasta import DNA_CODE

    lo = 0
    for b in batches:
        hi, dev = lo + b.length, b.device
        code = torch.from_numpy(DNA_CODE).to(dev)
        seq = torch.from_numpy(r["sequences"][lo:hi].reshape(-1)).to(dev)
        qual = torch.from_numpy(r["qualities"][lo:hi].reshape(-1)).to(dev)
        steps = READ_LEN * torch.arange(b.length + 1, dtype=torch.int32,
                                        device=dev)
        codes, scores = b.column("codes"), b.column("scores")
        trip = b.column("round_trip")
        ok = (torch.equal(codes.offsets, steps)
              and torch.equal(codes.child.values, code[seq.long()])
              and torch.equal(scores.offsets, steps)
              and torch.equal(scores.child.values, qual.long() - 33)
              and torch.equal(trip.offsets, steps)
              and torch.equal(trip.values, qual))
        if not ok:
            fail(f"query O: reads {lo}-{hi} differ from the generator")
        names = Batch(None, [b.column("name")], b.length).to_host()
        if not np.array_equal(_names_of(names.columns[0]),
                              r["names"][lo:hi]):
            fail(f"query O: names of reads {lo}-{hi} differ")
        lo = hi
    if lo != len(r["names"]):
        fail(f"query O: {lo} reads, expected {len(r['names'])}")
    print(f"query O: {lo} reads in {len(batches)} batches; codes, scores and "
          "their round trip to text match the generator on the card")


def _check_p(host, spectra: tuple) -> None:
    """Query P against numpy over the replayed spectra: the ids with a peak
    within PEAK_TOL of the reporter, each one's bins summed in peak order."""
    mz, inten = spectra
    rows = [i for i, m in enumerate(mz)
            if bool((np.abs(m - TMT_126) <= PEAK_TOL).any())]
    ids = [b"scan=%d" % i for i in rows]
    if _names_of(host.column("id")).tolist() != ids:
        fail(f"query P: {host.length} spectra, expected {len(rows)}")
    bins = host.column("bins")
    got = bins.child.values.reshape(len(rows), N_BINS) if rows else None
    worst = 0.0
    for k, i in enumerate(rows):
        b = np.floor((mz[i] - BIN_MIN) / BIN_WIDTH)
        ok = (b >= 0) & (b < N_BINS)
        want = np.zeros(N_BINS)
        np.add.at(want, b[ok].astype(np.int64), inten[i][ok])
        nz = want != 0
        if not np.array_equal(got[k] != 0, nz):
            fail(f"query P: spectrum {i}'s filled bins differ")
        worst = max(worst, float(np.max(np.abs(got[k][nz] - want[nz])
                                        / want[nz], initial=0.0)))
    if worst > BINS_RTOL:
        fail(f"query P: bins differ by {worst} (relative)")
    print(f"query P: {len(rows)} of {len(mz)} spectra hold the reporter; "
          f"their {N_BINS} bins match numpy (largest relative error {worst})")


@contextlib.contextmanager
def _host_decode():
    """Scans built inside decode on the host (the JAX package's own
    switch, EXON_TPU_HOST_DECODE)."""
    os.environ["EXON_TPU_HOST_DECODE"] = "1"
    try:
        yield
    finally:
        del os.environ["EXON_TPU_HOST_DECODE"]


def _scan_seconds(df, torch) -> float:
    return _scan_pass(df, torch)[0]


def _scan_pass(df, torch) -> tuple[float, int]:
    """(seconds, rows yielded) of the plan's scans alone: their decode
    streams iterated (device batches for a device decode, host batches
    otherwise), then a sync."""
    from exon_tpu_torch.plan.physical import ScanExec

    plan = df._execute(df.logical_plan())
    scans, stack = [], [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, ScanExec):
            scans.append(p)
        stack.extend(p.children())
    t = time.perf_counter()
    rows = 0
    for scan in scans:
        for b in scan.source():
            rows += b.length
    torch.cuda.synchronize()
    return time.perf_counter() - t, rows


def _decode_matches_host(label: str, read, torch) -> None:
    """Every column of a whole file decoded on the device equals the numpy
    host decode's, byte for byte (values, offsets, validity)."""
    dev = read().collect_host()
    with _host_decode():
        host = read().collect_host()
    if dev.length != host.length or dev.schema != host.schema:
        fail(f"{label}: device decode gives {dev.length} rows, host decode "
             f"{host.length}")
    for name in host.schema.names:
        a, b = dev.column(name), host.column(name)
        if not (np.array_equal(a.offsets, b.offsets)
                and a.values.tobytes() == b.values.tobytes()
                and np.array_equal(a.validity, b.validity)):
            fail(f"{label}: column {name} differs between the device and the "
                 "host decode")
    print(f"{label}: device decode equals the numpy host decode byte for "
          f"byte ({host.length} rows, columns {host.schema.names})")


def _query_c(T, session, bam, gf):
    c = T.col
    reads = session.read_bam(bam).select("name", "reference", "start", "end")
    genes = (session.read_gff(gf).filter(c("type") == "gene")
             .select(c("seqname"), c("start").alias("gene_start"),
                     c("end").alias("gene_end"), c("strand")))
    return (reads.join(genes, on=[("reference", "seqname"),
                                  (c("start") / W, c("gene_start") / W)])
            .filter((c("start") >= c("gene_start"))
                    & (c("start") <= c("gene_end")))
            .sort("reference", "start", "name", "gene_start"))


def _query_d(T, session, bam):
    c = T.col
    r1 = session.read_bam(bam).filter((c("flag") / 64) % 2 == 1).select(
        "name", "reference", "start", "flag")
    r2 = (session.read_bam(bam).filter((c("flag") / 128) % 2 == 1)
          .select(c("name").alias("mate_name"),
                  c("start").alias("mate_start"),
                  c("flag").alias("mate_flag")))
    return r1.join(r2, on=[("name", "mate_name")], how="left").sort(
        "reference", "start", "name")


# the aggregate exchange of Query Q's run: fallbacks, group rows, bytes
Q_EXCHANGE: list = []


def _run_q(dsession, gf):
    from exon_tpu_torch.parallel import distributed as D

    D.reset_stats()
    out = dsession.sql(SQL_Q.format(gf=gf)).collect_host()
    Q_EXCHANGE[:] = [D.fallbacks, D.exchanged_rows, D.exchanged_bytes]
    return out


def _check_q(host, feats) -> None:
    """Query Q against numpy: per (seqname, start / 100,000) over the
    exons, in first-seen order, the count, min(start), max(end) and the
    sum and mean of end - start + 1."""
    from benchlib.gff_fixture import FEATURE_TYPES, SEQNAMES

    m = feats["type"] == FEATURE_TYPES.index("exon")
    seq, start, end = feats["seqname"][m], feats["start"][m], feats["end"][m]
    key = seq.astype(np.int64) * (1 << 32) + start // Q_WIN
    _u, first, inv = np.unique(key, return_index=True, return_inverse=True)
    inv = inv.reshape(-1)
    g = first.shape[0]
    n = np.bincount(inv, minlength=g)
    lo = np.full(g, np.iinfo(np.int64).max)
    np.minimum.at(lo, inv, start)
    hi = np.full(g, np.iinfo(np.int64).min)
    np.maximum.at(hi, inv, end)
    bp = np.zeros(g, np.int64)
    np.add.at(bp, inv, end - start + 1)
    order = np.argsort(first, kind="stable")
    if host.length != g:
        fail(f"query Q: {host.length} windows, expected {g}")
    names = [x.decode() if isinstance(x, bytes) else str(x)
             for x in _values_of(host.columns[0]).tolist()]
    if names != [SEQNAMES[x] for x in seq[first[order]].tolist()]:
        fail("query Q: seqnames or their first-seen order differ")
    win = host.column("win")
    if win.values.dtype != np.int64:
        fail(f"query Q: start / {Q_WIN} is {win.values.dtype}, not int64")
    for name, w in (("win", (start // Q_WIN)[first[order]]),
                    ("n", n[order]), ("lo", lo[order]), ("hi", hi[order]),
                    ("bp", bp[order])):
        col = host.column(name)
        if not col.validity.all() or not np.array_equal(col.values, w):
            fail(f"query Q: column {name} differs")
    mean = host.column("mean_bp").values
    if not np.allclose(mean, bp[order] / n[order], rtol=FLOAT_RTOL, atol=0):
        fail("query Q: mean_bp differs")
    print(f"query Q: {g} windows over {int(m.sum())} exons, keys, order and "
          "every aggregate equal to numpy")


def _check_q_plans(dsession, gf, fa):
    """Q's plan holds a DistributedAggregateExec over Q_SHARDS shards, its
    run fell back to no single-device plan and its exchange moved group
    rows; Q_top's holds a DistributedTopKExec with fetch Q_TOP and
    Q_count's the ungrouped distributed aggregate. Returns Q's operator."""
    from exon_tpu_torch.parallel.distributed import (DistributedAggregateExec,
                                                     DistributedTopKExec)

    df = dsession.sql(SQL_Q.format(gf=gf))
    q_plan = _find(df._execute(df.logical_plan()), DistributedAggregateExec)
    if q_plan.mesh.n_shards != Q_SHARDS:
        fail(f"query Q: {q_plan.mesh.n_shards} shards, not {Q_SHARDS}")
    fallbacks, rows, nbytes = Q_EXCHANGE
    if fallbacks or rows <= 0:
        fail(f"query Q: {fallbacks} fallbacks, {rows} group rows exchanged")
    print(f"query Q: DistributedAggregateExec over {Q_SHARDS} shards of "
          f"{q_plan.mesh.devices[0]}; the exchange moved {rows} group rows, "
          f"{nbytes} bytes; {fallbacks} fallbacks")
    df = dsession.sql(SQL_Q_TOP.format(fa=fa))
    top = _find(df._execute(df.logical_plan()), DistributedTopKExec)
    if top.fetch != Q_TOP or top.mesh.n_shards != Q_SHARDS:
        fail(f"query Q_top: fetch {top.fetch} over {top.mesh.n_shards} "
             "shards")
    df = dsession.sql(SQL_Q_COUNT.format(fa=fa))
    if _find(df._execute(df.logical_plan()),
             DistributedAggregateExec).group_exprs:
        fail("query Q_count: not the ungrouped distributed aggregate")
    return q_plan


def _check_q_top(host, offs) -> None:
    lens = np.diff(offs)
    ids = _fasta_ids(lens.shape[0])
    top = np.lexsort((ids, -lens))[:Q_TOP]
    if host.length != Q_TOP or \
            not np.array_equal(_names_of(host.column("id")), ids[top]) or \
            not np.array_equal(host.column("n").values, lens[top]):
        fail("query Q_top: the longest proteins differ from numpy's")
    print(f"query Q_top: the {Q_TOP} longest proteins ({lens[top[0]]} to "
          f"{lens[top[-1]]} residues) equal to numpy")


def _check_q_count(host, offs) -> None:
    lens = np.diff(offs)
    sel = lens > 300
    got = (int(host.column("n").values[0]), int(host.column("total").values[0]))
    if got != (int(sel.sum()), int(lens[sel].sum())):
        fail(f"query Q_count: {got}, numpy {int(sel.sum())}, "
             f"{int(lens[sel].sum())}")


# the (key, row) pairs D_part's exchange routed and the rows L_dist's
# windows routed, each from its own run
DIST_EXCHANGE: dict = {}


def _run_dist(df, label: str):
    from exon_tpu_torch.parallel import distributed as D

    D.reset_stats()
    out = df.collect_host()
    DIST_EXCHANGE[label] = (D.exchanged_pairs, D.window_rows)
    return out


def _run_d_part(T, dsession, bam):
    """Query D on the shards under SET exon.partitioned_join = true, set
    back to false after."""
    dsession.sql("SET exon.partitioned_join = true")
    try:
        return _run_dist(_query_d(T, dsession, bam), "D_part")
    finally:
        dsession.sql("SET exon.partitioned_join = false")


def _same_rows(a, b) -> bool:
    """Two host batches hold the same rows in the same order: the same
    validity, and the same values where valid."""
    if a.length != b.length or a.schema.names != b.schema.names:
        return False
    for x, y in zip(a.columns, b.columns):
        v = np.asarray(x.validity)
        if not (np.array_equal(v, y.validity) and
                np.array_equal(_values_of(x)[v], _values_of(y)[v])):
            return False
    return True


def _check_dist_plans(T, dsession, bam, gf, vcf, panel, results):
    """C_dist, D_part and L_dist equal C, D and L row for row; their plans
    hold a DistributedJoinExec, a DistributedPartitionedJoinExec and a
    DistributedWindowExec over Q_SHARDS shards; D_part's exchange moved
    (key, row) pairs and L_dist routed every row. Returns D_part's join."""
    from exon_tpu_torch.parallel import distributed as D

    for label, base in (("C_dist", "C"), ("D_part", "D"), ("L_dist", "L")):
        if not _same_rows(results[label], results[base]):
            fail(f"query {label}: differs from query {base}")
    df = _query_c(T, dsession, bam, gf)
    c = _find(df._execute(df.logical_plan()), D.DistributedJoinExec)
    dsession.sql("SET exon.partitioned_join = true")
    try:
        df = _query_d(T, dsession, bam)
        d = _find(df._execute(df.logical_plan()),
                  D.DistributedPartitionedJoinExec)
    finally:
        dsession.sql("SET exon.partitioned_join = false")
    df = dsession.sql(SQL_L.format(vcf=vcf, panel=panel))
    w = _find(df._execute(df.logical_plan()), D.DistributedWindowExec)
    for label, op in (("C_dist", c), ("D_part", d), ("L_dist", w)):
        if op.mesh.n_shards != Q_SHARDS:
            fail(f"query {label}: {op.mesh.n_shards} shards, not {Q_SHARDS}")
    pairs, rows = DIST_EXCHANGE["D_part"][0], DIST_EXCHANGE["L_dist"][1]
    if pairs <= 0 or rows != results["L"].length:
        fail(f"query D_part moved {pairs} pairs, L_dist routed {rows} rows")
    print(f"queries C_dist, D_part and L_dist: DistributedJoinExec, "
          f"DistributedPartitionedJoinExec and DistributedWindowExec over "
          f"{Q_SHARDS} shards of {c.mesh.devices[0]}, equal to C, D and L "
          f"row for row; D_part's exchange routed {pairs} (key, row) pairs, "
          f"L_dist's {rows} rows to their partitions' shards")
    return d


def check_bucket_pack_pairs(torch, d_plan) -> None:
    """bucket_pack at D_part's pair exchange, printed apart: the left
    side's (folded key, row) pairs, int64 and int32, to the Q_SHARDS
    shards in the exchange's two calls (a counting call of capacity 0, then
    the pack at the largest count), every output equal to the twin's;
    beside it a stable torch.sort of the destinations and index_select of
    the two columns."""
    from exon_tpu_torch.kernels import bucket_pack as kb
    from exon_tpu_torch.parallel.distributed import _bucket, _collect_side
    from exon_tpu_torch.parallel.shuffle import exchange
    from exon_tpu_torch.plan.physical import fold_key

    side = _collect_side(d_plan.left, [le for le, _r in d_plan.on],
                         d_plan.mesh, {})
    key, mask = fold_key(side.parts), side.valid
    rows = torch.arange(key.shape[0], dtype=torch.int32, device=key.device)
    n = d_plan.mesh.n_shards

    def run(fn):
        counts = fn(key, mask, [], n, 0)[1]
        return fn(key, mask, [key, rows], n, int(counts.max()))

    got, want = run(kb.bucket_pack), run(kb.bucket_pack_plain)
    for a, b in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
        if not torch.equal(a, b):
            fail("kernel bucket_pack differs from its twin at D_part's "
                 "pairs")
    cap, live = int(got[1].max()), int(mask.sum())

    def library():
        d = torch.where(mask, kb.partition_ids(key, n), n)
        order = torch.sort(d, stable=True).indices
        key.index_select(0, order)
        rows.index_select(0, order)

    m = key.shape[0]
    # both calls read each key and mask byte and write each destination and
    # rank; the pack reads the two columns and writes the buckets, zeros
    # included, and the counts
    nbytes = 2 * m * (8 + 1 + 4 + 4) + m * 12 + n * cap * 12 + 8 * n
    ms = median_ms(lambda: run(kb.bucket_pack), torch)
    plain = median_ms(lambda: run(kb.bucket_pack_plain), torch)
    lib = median_ms(library, torch)
    # the whole route as D_part runs it (hash_partition_shuffle's work):
    # the two calls, the host read of the counts, the exchange's slices
    route = median_ms(lambda: exchange(d_plan.mesh, *[[x] for x in _bucket(
        d_plan.mesh, key, mask, [key, rows])]), torch)
    print(f"kernel bucket_pack at D_part's pair exchange (printed apart): "
          f"matches twin ({m} left rows, {live} (int64, int32) pairs to {n} "
          f"shards, bucket cap {cap}, two calls); median of {REPS}: kernel "
          f"{ms:.4f} ms, twin {plain:.4f} ms, library sort + index_select "
          f"{lib:.4f} ms; bound {bound_ms(nbytes):.4f} ms by bytes "
          f"({nbytes} bytes); the route with the exchange to the {n} "
          f"shards {route:.4f} ms")


def check_bucket_pack(torch, q_plan, q_batches) -> dict:
    """bucket_pack against its twin (every output equal) at Q's shape: the
    groups of Q's shard tables after its scan, all their columns, in the one
    call a card the exchange makes (the card's shard tables concatenated in
    shard order), routed to the Q_SHARDS shards with the bucket capacity
    the exchange picks; beside it the library yardstick, a stable
    torch.sort of the destinations and index_select of the columns."""
    from exon_tpu_torch.kernels import bucket_pack as kb
    from exon_tpu_torch.ops.aggregate import _pow2_at_least

    tables, kinds, _vocab = q_plan.fold(iter(q_batches))
    t0 = next(t for t in tables if t is not None)
    inputs = q_plan.exchange_inputs(tables, (t0.table.keys.shape[0],
                                             t0.specs, kinds))
    n = q_plan.mesh.n_shards
    caps = []
    for route, cols in inputs:
        cap = _pow2_at_least(max(64, 2 * route.shape[0] // n))
        counts = kb.bucket_pack_plain(route, None, [], n, cap)[1]
        caps.append(max(cap, int(counts.max())))

    def run(fn):
        return [fn(route, None, cols, n, cap)
                for (route, cols), cap in zip(inputs, caps)]

    for got, want in zip(run(kb.bucket_pack), run(kb.bucket_pack_plain)):
        for a, b in zip(got[0] + list(got[1:]), want[0] + list(want[1:])):
            if not torch.equal(a, b):
                fail("kernel bucket_pack differs from its twin")
    dests = [kb.partition_ids(route, n) for route, _c in inputs]

    def library():
        for d, (_route, cols) in zip(dests, inputs):
            order = torch.sort(d, stable=True).indices
            for c in cols:
                c.index_select(0, order)

    rows = sum(route.shape[0] for route, _c in inputs)
    row_bytes = sum(c.element_size() * (c.numel() // max(c.shape[0], 1))
                    for c in inputs[0][1])
    # read: each row's key and columns; written: the buckets, zeros
    # included, the counts and each row's destination and rank
    nbytes = rows * (8 + row_bytes + 8) + sum(
        n * cap * row_bytes + 4 * n for cap in caps)
    r = {"max_abs_err": 0.0, "ms": median_ms(lambda: run(kb.bucket_pack),
                                             torch),
         "plain_ms": median_ms(lambda: run(kb.bucket_pack_plain), torch),
         "library_ms": median_ms(library, torch), "bytes": nbytes,
         "shape": f"Q's {n} shard tables in {len(inputs)} call(s): {rows} "
                  f"group rows of {row_bytes} bytes to {n} shards, bucket "
                  f"caps {caps}"}
    r["bound_ms"], r["bound_by"] = _bound(r)
    print(f"kernel bucket_pack: matches twin ({r['shape']}); median of "
          f"{REPS}: kernel {r['ms']:.4f} ms, twin {r['plain_ms']:.4f} ms, "
          f"library sort + index_select {r['library_ms']:.4f} ms; bound "
          f"{r['bound_ms']:.4f} ms by {r['bound_by']} ({nbytes} bytes)")
    return r


def phase_main_path(torch) -> dict:
    import exon_tpu_torch as T
    from benchlib.bam_fixture import bam_reads, make_bam
    from benchlib.fasta_records import fasta_file_size, fasta_records
    from benchlib.fastq_fixture import fastq_reads, make_fastq
    from benchlib.fixtures import make_fasta
    from benchlib.fixtures import make_mzml
    from benchlib.gencode_gff_fixture import gencode_features, make_gencode_gff
    from benchlib.gff_fixture import gff_features, make_gff
    from benchlib.vcf_fixture import make_vcf, vcf_records
    from exon_tpu_torch import kernels
    from exon_tpu_torch.config import new_exon_config

    t0 = time.perf_counter()
    fa = make_fasta(FASTA_RECORDS, mean_len=MEAN_LEN, seed=42)
    flat, offs = fasta_records(FASTA_RECORDS, MEAN_LEN, seed=42)
    if os.path.getsize(fa) != fasta_file_size(offs):
        fail("FASTA fixture does not match the replayed records")
    gf = make_gff(GFF_FEATURES, GFF_SEED)
    feats = gff_features(GFF_FEATURES, GFF_SEED)
    bam = make_bam(N_TEMPLATES, BAM_SEED)
    reads = bam_reads(N_TEMPLATES, BAM_SEED)
    n_bam = len(reads["start"])
    fq = make_fastq(FASTQ_READS, FASTQ_SEED)
    fq_reads = fastq_reads(FASTQ_READS, FASTQ_SEED)
    vcf = make_vcf(VCF_RECORDS, VCF_SEED)  # built in phase 3
    calls = vcf_records(VCF_RECORDS, VCF_SEED)
    panel = _panel_file(vcf)
    gencode = make_gencode_gff(GENCODE_FEATURES, GENCODE_SEED)
    gencode_feats = gencode_features(GENCODE_FEATURES, GENCODE_SEED)
    mzml = make_mzml(MZML_SPECTRA)
    spectra = _mzml_spectra(MZML_SPECTRA)
    print(f"data: {gencode} ({os.path.getsize(gencode)} bytes, "
          f"{GENCODE_FEATURES} features), {mzml} ({os.path.getsize(mzml)} "
          f"bytes, {MZML_SPECTRA} spectra, "
          f"{sum(len(m) for m in spectra[0])} peaks)")
    print(f"data: {fa} ({os.path.getsize(fa)} bytes, {FASTA_RECORDS} records)"
          f", {gf} ({os.path.getsize(gf)} bytes, {GFF_FEATURES} features), "
          f"{bam} ({os.path.getsize(bam)} bytes, {n_bam} records), "
          f"{fq} ({os.path.getsize(fq)} bytes, {FASTQ_READS} reads), "
          f"{vcf} ({os.path.getsize(vcf)} bytes BGZF and a "
          f"{os.path.getsize(vcf + '.tbi')}-byte .tbi, {VCF_RECORDS} "
          f"records); {time.perf_counter() - t0:.1f} s to generate")
    sel = _expected_a(flat, offs)
    first_adapter = _first_adapter(fq_reads)
    rows_e = np.flatnonzero(first_adapter >= 0)

    session = T.ExonSession(device="cuda")
    dsession = T.ExonSession(device="cuda", config=new_exon_config(
        distributed=True, n_shards=Q_SHARDS))
    pred = (T.FunctionCall("length", [T.col("sequence")]) > 300) & \
        T.col("sequence").like("%KK%")
    adapter = T.col("sequence").like(ADAPTER)
    fn, c = T.FunctionCall, T.col
    sql_f = SQL_F.format(q=SW_QUERY.decode(), fq=fq)
    sql_i = SQL_I.format(vcf=vcf, region=VCF_REGION)
    sql_panel = SQL_I.format(vcf=vcf, region=panel)
    frames = {
        "A": lambda: session.read_fasta(fa).filter(pred).select(
            "id", "sequence"),
        "E": lambda: session.read_fastq(fq).filter(adapter).select(
            "name", "sequence", "quality_scores"),
    }
    queries = {
        "A": (lambda: frames["A"]().collect_host(), FASTA_RECORDS),
        "count": (lambda: session.read_fasta(fa).filter(pred).count(),
                  FASTA_RECORDS),
        "B": (lambda: session.read_gff(gf).filter(
            T.col("type") == "exon").aggregate(
            ["seqname"], [T.count().alias("n"), T.min_(T.col("start")),
                          T.max_(T.col("end")),
                          T.sum_(T.col("end") - T.col("start")),
                          T.avg(T.col("end") - T.col("start"))]
        ).collect_host(), GFF_FEATURES),
        "C": (lambda: _query_c(T, session, bam, gf).collect_host(),
              n_bam + GFF_FEATURES),
        "D": (lambda: _query_d(T, session, bam).collect_host(), 2 * n_bam),
        "E": (lambda: frames["E"]().collect_host(), FASTQ_READS),
        "E_count": (lambda: session.read_fastq(fq).filter(adapter).count(),
                    FASTQ_READS),
        "SQL_count": (lambda: int(session.sql(SQL_COUNT.format(fa=fa))
                                  .collect_host().columns[0].values[0]),
                      FASTA_RECORDS),
        "SQL_range": (lambda: session.sql(SQL_RANGE.format(fa=fa))
                      .collect_host(), FASTA_RECORDS),
        "SQL_gff": (lambda: (session.sql(SQL_CREATE.format(gf=gf)),
                             session.sql(SQL_GFF).collect_host())[1],
                    GFF_FEATURES),
        "F": (lambda: session.sql(sql_f).collect_host(), FASTQ_READS),
        "G": (lambda: session.sql(SQL_G.format(bam=bam)).collect_host(),
              n_bam),
        "H": (lambda: session.read_fastq(fq).filter(
            fn("gc_content", [c("sequence")]) >= GC_MIN).select(
            "name", fn("reverse_complement", [
                fn("trim_polya", [c("sequence")])]).alias("rc")
        ).collect_host(), FASTQ_READS),
        # I's input rows: what its scan yields, counted below
        "I": (lambda: session.sql(sql_i).collect_host(), None),
        "I_panel": (lambda: session.sql(sql_panel).collect_host(), None),
        "J": (lambda: session.sql(SQL_J.format(fa=fa)).collect_host(),
              FASTA_RECORDS),
        "J_agg": (lambda: session.sql(SQL_J_AGG.format(fa=fa)).collect_host(),
                  FASTA_RECORDS),
        "K": (lambda: session.sql(SQL_K.format(fq=fq)).collect_host(),
              FASTQ_READS),
        # L reads I_panel's scan, M I's (three times, once a branch)
        "L": (lambda: session.sql(SQL_L.format(vcf=vcf, panel=panel))
              .collect_host(), None),
        "M": (lambda: session.sql(SQL_M.format(vcf=vcf, region=VCF_REGION))
              .collect_host(), None),
        "N": (lambda: session.sql(SQL_N.format(gf=gencode)).collect_host(),
              GENCODE_FEATURES),
        # O's result stays on the card, batch by batch
        "O": (lambda: _device_batches(session.sql(SQL_O.format(fq=fq))),
              FASTQ_READS),
        "P": (lambda: session.sql(SQL_P.format(mz=mzml)).collect_host(),
              MZML_SPECTRA),
        # on Q_SHARDS shards of the card
        "Q": (lambda: _run_q(dsession, gf), GFF_FEATURES),
        "Q_top": (lambda: dsession.sql(SQL_Q_TOP.format(fa=fa))
                  .collect_host(), FASTA_RECORDS),
        "Q_count": (lambda: dsession.sql(SQL_Q_COUNT.format(fa=fa))
                    .collect_host(), FASTA_RECORDS),
        "C_dist": (lambda: _run_dist(_query_c(T, dsession, bam, gf),
                                     "C_dist"), n_bam + GFF_FEATURES),
        "D_part": (lambda: _run_d_part(T, dsession, bam), 2 * n_bam),
        "L_dist": (lambda: _run_dist(dsession.sql(SQL_L.format(
            vcf=vcf, panel=panel)), "L_dist"), None),
    }
    results, stats, counts = {}, {}, {}
    for q, (run, rows_in) in queries.items():
        kernels.reset_launch_counts()
        t = time.perf_counter()
        results[q] = run()
        torch.cuda.synchronize()
        stats[q] = [time.perf_counter() - t, rows_in]
        counts[q] = kernels.launch_counts()
        missing = [k for k in PATH_KERNELS[q] if counts[q][k] == 0]
        if missing:
            fail(f"query {q} never launched its kernels {missing}")
        print(f"launches in query {q}: "
              f"{ {k: v for k, v in counts[q].items() if v} }")

    _check_a(results["A"], flat, offs, sel)
    if results["count"] != len(sel):
        fail(f"count: {results['count']}, expected {len(sel)}")
    _check_b(results["B"], feats)
    _check_c(results["C"], reads, feats, "C")
    _check_d(results["D"], reads)
    _check_e(results["E"], fq_reads, rows_e)
    if results["E_count"] != len(rows_e):
        fail(f"E_count: {results['E_count']}, expected {len(rows_e)}")
    if results["SQL_count"] != len(sel):
        fail(f"SQL_count: {results['SQL_count']}, expected {len(sel)}")
    _check_a(results["SQL_range"], flat, offs, np.arange(100_000, 200_000),
             "SQL_range")
    print("query SQL_range: ids and sequences of records 100,000-199,999")
    _check_sql_gff(results["SQL_gff"], feats)
    with _swapped(_SW_TWIN):
        twin_f = session.sql(sql_f).collect_host()
    _check_f(results["F"], twin_f, fq_reads, rows_e)
    _check_g(results["G"], session.read_bam(bam).select(
        "reference", "flag", "sequence").collect_host())
    _check_h(results["H"], fq_reads)
    _check_i(results["I"], calls, [_region(VCF_REGION)], "I")
    _check_i(results["I_panel"], calls, _panel_regions(), "I_panel")
    _check_j(results["J"], flat, offs)
    _check_j_agg(results["J_agg"], offs)
    _check_k(results["K"], fq_reads, first_adapter)
    _check_l(results["L"], calls)
    _check_m(results["M"], calls, [_region(VCF_REGION)])
    _check_n(results["N"], gencode_feats)
    _check_topk(session.sql(SQL_N.format(gf=gencode)), N_TOP, "N")
    _check_o(results["O"], fq_reads, torch)
    _check_p(results["P"], spectra)
    _check_q(results["Q"], feats)
    q_plan = _check_q_plans(dsession, gf, fa)
    _check_q_top(results["Q_top"], offs)
    _check_q_count(results["Q_count"], offs)
    d_plan = _check_dist_plans(T, dsession, bam, gf, vcf, panel, results)
    _decode_matches_host("FASTA", lambda: session.read_fasta(fa), torch)
    _decode_matches_host("FASTQ", lambda: session.read_fastq(fq), torch)
    # each query's scans alone: the device decode where the format has one,
    # and the numpy host decode of the same files
    device_scan = {q: _scan_seconds(frames[q](), torch) for q in frames}
    # F and H scan the FASTQ's name and sequence columns alone
    device_scan["F"] = device_scan["H"] = _scan_seconds(
        session.read_fastq(fq).select("name", "sequence"), torch)
    # J and J_agg scan the FASTA's three columns, K the FASTQ's sequences
    device_scan["J"] = device_scan["J_agg"] = _scan_seconds(
        session.read_fasta(fa).select("id", "description", "sequence"), torch)
    device_scan["K"] = _scan_seconds(session.read_fastq(fq).select(
        "sequence"), torch)
    with _host_decode():
        host_scan = {q: _scan_seconds(f(), torch) for q, f in (
            *frames.items(), ("C", lambda: _query_c(T, session, bam, gf)),
            ("D", lambda: _query_d(T, session, bam)))}
    # I's scans alone: the tabix seek, the range inflate and the numpy
    # decode of the region chunks (a host decode; no device decoder), with
    # the rows they yield and the records the chunks held before the exact
    # row filter
    inflated = {}
    for q, sql, regions in (
            ("I", sql_i, [_region(VCF_REGION)]),
            ("I_panel", sql_panel, _panel_regions()),
            ("L", SQL_L.format(vcf=vcf, panel=panel), _panel_regions())):
        host_scan[q], stats[q][1] = _scan_pass(session.sql(sql), torch)
        want = _region_rows(calls, regions)
        if stats[q][1] != want:
            fail(f"query {q}: its scans yielded {stats[q][1]} rows, the "
                 f"fixture has {want} in its regions")
        inflated[q] = _chunk_records(vcf, regions)
    # M reads I's scan three times, L_dist L's once; their own scans are
    # not timed again (cut for the smoke's time)
    stats["M"][1], inflated["M"] = 3 * stats["I"][1], 3 * inflated["I"]
    stats["L_dist"][1], inflated["L_dist"] = stats["L"][1], inflated["L"]
    for q, base in (("count", "A"), ("E_count", "E")):
        host_scan[q] = host_scan[base]
        if base in device_scan:
            device_scan[q] = device_scan[base]
    # N's and P's host decodes, O's device decode
    host_scan["N"] = _scan_seconds(session.read_gff(gencode).select(
        "type", "attributes"), torch)
    host_scan["P"] = _scan_seconds(session.read_mzml(mzml).select(
        "id", "mz", "intensity"), torch)
    device_scan["O"] = _scan_seconds(session.read_fastq(fq).select(
        "name", "sequence", "quality_scores"), torch)
    # Q's scan alone (the host decode and the copy to the card), its device
    # batches kept for the bucket_pack case and phase 5; Q_top and Q_count
    # decode A's FASTA on the card
    t = time.perf_counter()
    q_batches = list(q_plan.input.batches())
    torch.cuda.synchronize()
    host_scan["Q"] = time.perf_counter() - t
    device_scan["Q_top"] = device_scan["Q_count"] = device_scan["A"]
    results["O"] = sum(b.length for b in results["O"])
    for q, (sec, rows_in) in stats.items():
        out = results[q] if isinstance(results[q], int) else results[q].length
        share = "".join(
            f", {what} alone {t[q]:.3f} s ({100 * t[q] / sec:.1f} % of wall)"
            for what, t in (("device scan", device_scan),
                            ("host decode", host_scan)) if q in t)
        seek = (f", {rows_in} rows out of the scan ({inflated[q]} records "
                f"inflated from the tabix chunks)") if q in inflated else ""
        print(f"query {q}: {out} rows out, {sec:.3f} s wall, "
              f"{rows_in / sec:,.0f} input rows/s (decode included)"
              f"{seek}{share}")
    print("main path: queries A, count, B, C, D, E, E_count, SQL_count, "
          "SQL_range, SQL_gff, F, G, H, I, I_panel, J, J_agg, K, L, M, N, O, "
          "P, Q, Q_top and Q_count match the generators' arrays; C_dist, "
          "D_part and L_dist equal C, D and L row for row")
    _sql_vs_dataframe(session, T, fa, vcf, torch)
    return {k: sum(c[k] for c in counts.values()) for k in KERNELS}, \
        (q_plan, q_batches, gf), d_plan


# ---------------------------------------------------------------------------
# Phase 5: where the time goes in queries C and D
# ---------------------------------------------------------------------------


def _device_batches(df) -> list:
    """A query's result as its device batches, not copied to the host."""
    return list(df._execute(df.logical_plan()).batches())


def _find(plan, cls):
    stack = [plan]
    while stack:
        p = stack.pop()
        if isinstance(p, cls):
            return p
        stack.extend(p.children())
    fail(f"no {cls.__name__} in the plan")


# (module that calls the wrapper, wrapper name) for sw_score; the kernel
# module bears the wrapper's name
_SW_TWIN = [("exon_tpu_torch.ops.alignment", "sw_score")]


@contextlib.contextmanager
def _swapped(swaps):
    """Each named kernel wrapper replaced by its plain twin where the
    calling module looks it up."""
    mods = [importlib.import_module(m) for m, _n in swaps]
    saved = [getattr(mod, name) for mod, (_m, name) in zip(mods, swaps)]
    for mod, (_m, name) in zip(mods, swaps):
        k = importlib.import_module(f"exon_tpu_torch.kernels.{name}")
        setattr(mod, name, getattr(k, f"{name}_plain"))
    try:
        yield
    finally:
        for mod, (_m, name), f in zip(mods, swaps, saved):
            setattr(mod, name, f)


def _host_ms(fn, torch, reps: int = 5) -> float:
    """Median host-clock time of ``fn`` ending in a sync, after one warm
    run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return 1e3 * float(np.median(times))


def _in_memory(plan, batches=None):
    """A leaf that yields ``batches`` (by default ``plan``'s, run once)
    with ``plan``'s schema."""
    from exon_tpu_torch.plan.physical import PhysicalPlan

    class InMemory(PhysicalPlan):
        def __init__(self):
            self.out_schema = plan.schema()
            self.held = list(plan.batches() if batches is None else batches)

        def schema(self):
            return self.out_schema

        def batches(self):
            return iter(self.held)

    return InMemory()


def _q_cost(torch, q_batches, gf) -> None:
    """Q's aggregate alone on its device batches already in memory, on one
    device (AggregateExec), 2 shards and Q_SHARDS shards of the card: the
    cost of distribution on one card (median of 5 host-clock runs ending in
    a sync; every way gives the same groups), and one more run under
    torch.profiler: the device time of its kernels and copies and of
    hash_aggregate_kernel's launches."""
    import exon_tpu_torch as T
    from exon_tpu_torch.config import new_exon_config
    from exon_tpu_torch.parallel.distributed import DistributedAggregateExec
    from exon_tpu_torch.plan.physical import AggregateExec

    rows = sum(b.length for b in q_batches)
    first = None
    for label, shards in (("AggregateExec", 1), ("2 shards", 2),
                          (f"{Q_SHARDS} shards", Q_SHARDS)):
        s = T.ExonSession(device="cuda", config=new_exon_config(
            distributed=shards > 1, n_shards=shards))
        df = s.sql(SQL_Q.format(gf=gf))
        plan = df._execute(df.logical_plan())
        agg = _find(plan, DistributedAggregateExec if shards > 1
                    else AggregateExec)
        agg.input = _in_memory(agg.input, q_batches)
        out = plan.collect_host()
        if first is None:
            first = out
        elif not _same_batch(out, first):
            fail(f"query Q alone: {label} differs from AggregateExec")
        ms = _host_ms(lambda: list(plan.batches()), torch)
        cuda = _cuda_rows(torch, lambda: list(plan.batches()))
        kern = [e for e in cuda if "hash_aggregate_kernel" in e.key]
        print(f"query Q aggregate alone, {label}: {rows} rows in memory, "
              f"{out.length} groups; median of 5: {ms:.2f} ms; one profiled "
              f"run: {sum(e.self_device_time_total for e in cuda) / 1e3:.2f}"
              f" ms on the device, hash_aggregate_kernel "
              f"{sum(e.self_device_time_total for e in kern) / 1e3:.3f} ms "
              f"in {sum(e.count for e in kern)} launches")


def _join_and_sort_ms(df, torch, label: str):
    """The query's join and its sort on device batches already in memory
    (no scan), with the kernels. Returns the join over its batches."""
    from exon_tpu_torch.plan import join_exec, physical

    plan = df._execute(df.logical_plan())
    sort, join = _find(plan, physical.SortExec), _find(plan, join_exec.JoinExec)
    join.left, join.right = _in_memory(join.left), _in_memory(join.right)
    sort.input = _in_memory(sort.input)
    for part, run, inputs in (
            ("join", lambda: list(join.batches()),
             join.left.held + join.right.held),
            ("sort", lambda: list(sort.batches()), sort.input.held)):
        out = run()
        rows = sum(b.length for b in out)
        nbytes = _batch_bytes(inputs) + _batch_bytes(out)
        ms = _host_ms(run, torch)
        print(f"query {label} {part} alone: {rows} rows out; median of 5: "
              f"{ms:.2f} ms; bound {bound_ms(nbytes):.4f} ms (its input and "
              f"output batches, {nbytes} bytes)")
    return join


def _dist_join_ms(torch, join, label: str, partitioned: bool) -> None:
    """The query's join alone on Q_SHARDS shards of the card (C_dist's
    broadcast join, D_part's partitioned join) over the in-memory batches
    of its one-device JoinExec, beside that JoinExec (median of 5
    host-clock runs ending in a sync; both ways give the same rows in the
    same order)."""
    from exon_tpu_torch.batch import concat_host
    from exon_tpu_torch.parallel import distributed as D
    from exon_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(Q_SHARDS, "cuda")
    args = (join.on, join.how, join.filter, join.out_schema, mesh)
    dist = D.DistributedPartitionedJoinExec(join.left, join.right, *args) \
        if partitioned else D.DistributedJoinExec(join.left, (), join.right,
                                                  *args)
    outs = [concat_host(join.schema(), [b.to_host() for b in op.batches()])
            for op in (join, dist)]
    if not _same_rows(*outs):
        fail(f"query {label}'s join alone: {type(dist).__name__} differs "
             "from JoinExec")
    ms_one = _host_ms(lambda: list(join.batches()), torch)
    ms_dist = _host_ms(lambda: list(dist.batches()), torch)
    print(f"query {label} join alone, inputs in memory: JoinExec on one "
          f"device {ms_one:.2f} ms, {type(dist).__name__} on {Q_SHARDS} "
          f"shards {ms_dist:.2f} ms (median of 5; {outs[0].length} rows out, "
          "the same both ways)")


def _window_ms(torch, session, sql: str) -> None:
    """L's windows alone, their input batches in memory: WindowExec on one
    device beside DistributedWindowExec on Q_SHARDS shards of the card (L
    on 8 shards: L_dist), median of 5 host-clock runs ending in a sync,
    beside the bound of the input and output bytes; both ways give the same
    rows."""
    from exon_tpu_torch.batch import concat_host
    from exon_tpu_torch.parallel import distributed as D
    from exon_tpu_torch.parallel.mesh import make_mesh
    from exon_tpu_torch.plan.window_exec import WindowExec

    df = session.sql(sql)
    one = _find(df._execute(df.logical_plan()), WindowExec)
    one.input = _in_memory(one.input)
    dist = D.DistributedWindowExec(one.calls, one.names, one.out_schema,
                                   one.input, make_mesh(Q_SHARDS, "cuda"))
    outs = [list(op.batches()) for op in (one, dist)]
    if not _same_rows(*[concat_host(one.out_schema, [b.to_host() for b in o])
                        for o in outs]):
        fail("query L's windows alone: DistributedWindowExec differs from "
             "WindowExec")
    nbytes = _batch_bytes(one.input.held) + _batch_bytes(outs[0])
    ms_one = _host_ms(lambda: list(one.batches()), torch)
    ms_dist = _host_ms(lambda: list(dist.batches()), torch)
    print(f"query L windows alone, input in memory: WindowExec on one device "
          f"{ms_one:.2f} ms, DistributedWindowExec on {Q_SHARDS} shards "
          f"{ms_dist:.2f} ms (median of 5; {sum(b.length for b in outs[0])} "
          f"rows, the same both ways); bound {bound_ms(nbytes):.4f} ms (its "
          f"input and output batches, {nbytes} bytes)")


def _batch_bytes(batches) -> int:
    """Bytes of every tensor of the batches' columns."""
    total = 0
    for b in batches:
        for c in b.columns:
            total += sum(t.nbytes for t in vars(c).values()
                         if hasattr(t, "nbytes"))
    return total


def _device_profile(run, torch, label: str) -> None:
    """One run of the query under torch.profiler: wall, and the device time
    of its CUDA kernels and copies (each counted once)."""
    from torch.profiler import ProfilerActivity, profile

    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    if device_ms <= 0:
        fail(f"query {label}: the profile shows no device time")
    htod = [e for e in rows if e.key.startswith("Memcpy HtoD")]
    print(f"query {label} profiled: {wall:.3f} s wall, {device_ms:.1f} ms "
          f"on the device ({100 * device_ms / (1e3 * wall):.2f} % of wall), "
          f"HtoD {sum(e.self_device_time_total for e in htod) / 1e3:.1f} ms "
          f"in {sum(e.count for e in htod)} copies")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms x {e.count:5d}  "
              f"{e.key[:80]}")


def phase_breakdown(torch, q) -> None:
    import exon_tpu_torch as T
    from benchlib.bam_fixture import make_bam
    from benchlib.fastq_fixture import make_fastq
    from benchlib.fixtures import make_fasta
    from benchlib.gff_fixture import make_gff
    from benchlib.vcf_fixture import make_vcf

    session = T.ExonSession(device="cuda")
    bam, gf = make_bam(N_TEMPLATES, BAM_SEED), make_gff(GFF_FEATURES, GFF_SEED)
    queries = {"C": lambda: _query_c(T, session, bam, gf),
               "D": lambda: _query_d(T, session, bam)}
    for label, query in queries.items():
        join = _join_and_sort_ms(query(), torch, label)
        _dist_join_ms(torch, join, label, partitioned=label == "D")
        del join
    _q_cost(torch, q[1], gf)
    del q
    vcf = make_vcf(VCF_RECORDS, VCF_SEED)
    _window_ms(torch, session, SQL_L.format(vcf=vcf, panel=_panel_file(vcf)))
    # C's and D's profiled runs (~50 s and ~30 s) are cut for the smoke's
    # time: the card was under 0.5 % busy in them (PERF.md section 5). The
    # profiler's first use sets up its tracing (~10 s), which would land in
    # the first query profiled: a trivial profiled op takes it
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    # the device-decoded queries: how much of their wall is on the card
    fa = make_fasta(FASTA_RECORDS, mean_len=MEAN_LEN, seed=42)
    fq = make_fastq(FASTQ_READS, FASTQ_SEED)
    pred = (T.FunctionCall("length", [T.col("sequence")]) > 300) & \
        T.col("sequence").like("%KK%")
    _device_profile(lambda: session.read_fasta(fa).filter(pred).select(
        "id", "sequence").collect_host(), torch, "A")
    _device_profile(lambda: session.read_fastq(fq).filter(
        T.col("sequence").like(ADAPTER)).select(
        "name", "sequence", "quality_scores").collect_host(), torch, "E")
    # I's and I_panel's profiled runs (~6 s; the card 0.18-0.25 % busy in
    # them, PERF.md section 5) are cut for the smoke's time, as is P's
    # (its mzML parse, ~7 s; 0.41 % busy)
    # the SQL-function queries: how much of J's, J_agg's (the host grouping)
    # and K's wall is on the card
    for label, sql in (("J", SQL_J.format(fa=fa)),
                       ("J_agg", SQL_J_AGG.format(fa=fa)),
                       ("K", SQL_K.format(fq=fq))):
        _device_profile(lambda: session.sql(sql).collect_host(), torch, label)
    # the windows: how much of L's wall is on the card
    sql = SQL_L.format(vcf=vcf, panel=_panel_file(vcf))
    _device_profile(lambda: session.sql(sql).collect_host(), torch, "L")
    # the list columns: N's map lookups and O's encodings (kept on the card)
    from benchlib.gencode_gff_fixture import make_gencode_gff

    gencode = make_gencode_gff(GENCODE_FEATURES, GENCODE_SEED)
    _device_profile(lambda: session.sql(SQL_N.format(
        gf=gencode)).collect_host(), torch, "N")
    _device_profile(lambda: _device_batches(session.sql(SQL_O.format(
        fq=fq))), torch, "O")
    # Q's profiled run (~14 s; the card 0.45 % busy in it, PERF.md section
    # 5) is cut for the smoke's time


def phase_focus(torch, names: list) -> None:
    """The named cases of FOCUS alone, on fresh seeds."""
    for k in names:
        if k not in FOCUS:
            fail(f"--kernels: {k} is not one of {sorted(FOCUS)}")
    for k in names:
        FOCUS[k](torch)


def check_q_aggregate(torch) -> None:
    """Phase 5's timing of Q's aggregate alone, on the device batches of
    Q's scan."""
    import exon_tpu_torch as T
    from benchlib.gff_fixture import make_gff
    from exon_tpu_torch.config import new_exon_config
    from exon_tpu_torch.parallel.distributed import DistributedAggregateExec

    gf = make_gff(GFF_FEATURES, GFF_SEED)
    df = T.ExonSession(device="cuda", config=new_exon_config(
        distributed=True, n_shards=Q_SHARDS)).sql(SQL_Q.format(gf=gf))
    q_plan = _find(df._execute(df.logical_plan()), DistributedAggregateExec)
    _q_cost(torch, list(q_plan.input.batches()), gf)


# the cases a run with --kernels can take alone: phase 3's of two kernels,
# and phase 5's of Q's aggregate (hash_aggregate on Q's path)
FOCUS = {
    "hash_aggregate": lambda torch: check_hash(
        np.random.default_rng(1234), torch, _query_i_first_batch(torch)),
    "list_bins": check_list_bins,
    "q_aggregate": check_q_aggregate,
}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", default="",
                    help="comma-separated names from FOCUS: run phases 1-2 "
                         "and those cases alone")
    ap.add_argument("--tree", default="",
                    help="import exon_tpu_torch and benchlib from this "
                         "checkout (an earlier commit, unpacked) instead of "
                         "the script's own, to time two versions in one run")
    args = ap.parse_args()
    t0 = time.perf_counter()
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not installed: {e}")
    root = os.path.abspath(args.tree) if args.tree else \
        os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "exon_tpu_torch")):
        fail(f"exon_tpu_torch is not in {root}")
    sys.path.insert(0, root)
    if args.kernels:
        name, card = phase_device(torch)
        phase_build()
        phase_focus(torch, args.kernels.split(","))
        print(f"smoke (--kernels {args.kernels}, exon_tpu_torch from {root})"
              f": {time.perf_counter() - t0:.1f} s in all")
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    name, card = phase_device(torch)
    phase_build()
    results = phase_kernels(torch)
    counts, q, d_plan = phase_main_path(torch)
    # phase 3's bucket_pack cases need Q's shard tables and D_part's join:
    # they run after the main path
    results["bucket_pack"] = check_bucket_pack(torch, q[0], q[1])
    check_bucket_pack_pairs(torch, d_plan)
    del d_plan
    phase_breakdown(torch, q)
    del q
    kernels = []
    for k, (replaces, src) in KERNELS.items():
        r = results[k]
        kernels.append({"name": k, "route": "cuda",
                        "source": f"exon_tpu_torch/kernels/csrc/{src}",
                        "replaces": replaces, "launches": counts[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(f"smoke: {time.perf_counter() - t0:.1f} s in all")
    # the card's name and power limit again, beside the numbers above
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
