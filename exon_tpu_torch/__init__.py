"""exon_tpu_torch: the exon-tpu query engine on PyTorch and CUDA.

A port of ``exon_tpu`` (JAX) to PyTorch for NVIDIA Hopper GPUs. It runs
SQL (``ExonSession.sql``: SELECT, CREATE EXTERNAL TABLE, the scan table
functions, SHOW TABLES, DESCRIBE, DROP TABLE) and the DataFrame API over
FASTA, FASTQ, GFF, BAM and VCF files (VCF with tabix region pushdown):
Scan → Filter → Project, (Filter →) Aggregate with the var/stddev family and
string keys, inner and left equi-joins, Sort, TopK and Limit, CASE and CAST,
and exon's sequence UDFs (``udfs.py``: alignment_score, gc_content,
reverse_complement, trim_polya, length, the SAM-flag predicates and the
region predicates) and the SQL function library (``ops/sqlfuncs.py``: string,
conditional and math functions; median, string_agg and string MIN/MAX
aggregate on the host), with hand-written CUDA kernels for FASTA/FASTQ decode
on the device (newline index, per-line records, span gather), filter
compaction, var-width gather, LIKE, ordered string compares, number
parsing and formatting, the grouped hash aggregate (with sums of squares
and each row's slot), join pair expansion, row hashing, string equality,
sort keys, Smith-Waterman scores, byte-class counts, byte maps (mirrored,
or by word starts), byte-class runs at either end of a row, first-match
positions, the assembly of rows from byte spans and the bucket packing of
the hash-partition shuffle (``exon_tpu_torch.kernels``). With a session
config of ``new_exon_config(distributed=True, n_shards=N)``
(``exon_tpu_torch.config``), aggregates and TopK sorts over a scan run
over N shards, and over several processes through ``torch.distributed``
(``exon_tpu_torch.parallel``).
It imports torch and numpy only; pyarrow is needed only by
``collect_arrow``.
"""

from .batch import Batch
from .datatypes import Schema
from .dataframe import DataFrame
from .errors import ExonError
from .plan.expressions import (AggregateCall, Case, Cast, FunctionCall,
                               NullsOrder, col, lit)
from .session import ExonSession


def count(child=None):
    return AggregateCall("count", child)


def sum_(child):
    return AggregateCall("sum", child)


def min_(child):
    return AggregateCall("min", child)


def max_(child):
    return AggregateCall("max", child)


def avg(child):
    return AggregateCall("avg", child)


__all__ = [
    "ExonSession", "DataFrame", "Batch", "Schema", "col", "lit",
    "FunctionCall", "NullsOrder", "Case", "Cast", "count", "sum_", "min_",
    "max_", "avg", "ExonError",
]
