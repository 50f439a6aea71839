"""Scalar UDFs: the bio function library.

Counterpart of exon_tpu/udfs.py, for the functions that need no list or
struct column: ``gc_content`` (:69), ``reverse_complement`` (:87),
``trim_polya`` (:131), ``length`` (:155), the twelve SAM-flag predicates and
``is_mapped`` (:167-196), ``alignment_score`` (:203) and ``chrom_match``,
``interval_match`` and ``region_match`` (:315-373). They run on four
kernels: count_bytes (the GC count), map_bytes (the mirrored complement),
polya_tail (the trimmed lengths, whose bytes gather_spans copies) and
sw_score (Smith-Waterman, through ops/alignment.py). The flag predicates
and the intervals are elementwise torch ops; a chromosome compares through
like_match, or through the vocabulary of a dictionary column.

Registration follows ``_register_all`` (:436-508). The VCF and BCF
region-filter markers are registered as the JAX package does: a provider
plans them away, and one that reaches execution raises PlanError. The
list-column UDFs, ``locate_regex``, the mass-spec UDFs and the markers of
formats without an indexed provider are registered as not ported: calling
one raises NotImplementedError naming its ROADMAP item. The SQL functions
of exon_tpu/ops/sqlfuncs.py are in ops/sqlfuncs.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import datatypes as dt
from .batch import Batch, DictColumn, FixedColumn, VarColumn
from .errors import PlanError
from .kernels.count_bytes import count_bytes
from .kernels.gather_spans import gather_spans
from .kernels.map_bytes import map_bytes
from .kernels.polya_tail import polya_tail
from .ops import strings as str_ops
from .ops.alignment import alignment_scores, alignment_scores_pairwise
from .ops.device_text import lengths_to_offsets
from .ops.layout import dict_to_var
from .plan.expressions import register_function, register_not_ported
from .plan.regions import REGION_FILTER_UDFS
from .region import Region


def _require_var(v, fn: str, batch: Batch) -> VarColumn:
    """A string argument as a VarColumn: a literal becomes a one-row column
    on the batch's device, a dictionary column is decoded (NULL rows
    empty)."""
    if isinstance(v, (str, bytes)):
        b = v.encode() if isinstance(v, str) else v
        dev = batch.device
        return VarColumn(
            torch.from_numpy(np.frombuffer(b, np.uint8).copy()).to(dev),
            torch.tensor([0, len(b)], dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.bool, device=dev))
    if isinstance(v, DictColumn):
        return dict_to_var(v)
    if not isinstance(v, VarColumn):
        raise PlanError(f"{fn} expects a string/sequence column")
    return v


def _row_lengths(col: VarColumn) -> torch.Tensor:
    return col.offsets[1:] - col.offsets[:-1]


# -- gc_content (udfs/sequence/gc_content.rs) -------------------------------

GC = b"GCgc"


def gc_content(batch: Batch, seq) -> torch.Tensor:
    """The G/C share of each row as float32, 0 for an empty (or NULL) row:
    one IEEE float32 divide, as the JAX function does."""
    col = _require_var(seq, "gc_content", batch)
    gc = count_bytes(col.offsets, col.values, GC)
    lens = _row_lengths(col)
    return torch.where(lens > 0, gc.to(torch.float32) / lens.to(torch.float32),
                       0.0)


# -- reverse_complement (udfs/sequence/reverse_complement.rs) ---------------

_COMPLEMENT = np.arange(256, dtype=np.uint8)
for a, b in [(b"A", b"T"), (b"C", b"G"), (b"G", b"C"), (b"T", b"A"),
             (b"a", b"t"), (b"c", b"g"), (b"g", b"c"), (b"t", b"a"),
             (b"N", b"N"), (b"n", b"n"), (b"U", b"A"), (b"u", b"a")]:
    _COMPLEMENT[a[0]] = b[0]


@functools.lru_cache(maxsize=None)
def _complement_table(device: torch.device) -> torch.Tensor:
    """_COMPLEMENT on ``device``, copied there once."""
    return torch.from_numpy(_COMPLEMENT).to(device)


def reverse_complement(batch: Batch, seq) -> VarColumn:
    col = _require_var(seq, "reverse_complement", batch)
    table = _complement_table(col.values.device)
    return VarColumn(map_bytes(col.offsets, col.values, table, "mirror"),
                     col.offsets, col.validity)


# -- trim_polya (udfs/sequence/trim_polya.rs): strip trailing A/a run -------


def trim_polya(batch: Batch, seq) -> VarColumn:
    """Each row less its trailing run of A/a: the kept lengths from the
    polya_tail kernel, their offsets by torch.cumsum, the kept prefixes
    copied by gather_spans with no byte dropped."""
    col = _require_var(seq, "trim_polya", batch)
    keep = polya_tail(col.offsets, col.values)
    offsets = lengths_to_offsets(keep)
    starts = col.offsets[:-1]
    values = gather_spans(col.values, starts, starts + keep, offsets[:-1],
                          int(offsets[-1]), drop=())
    return VarColumn(values, offsets, col.validity)


# -- char length ------------------------------------------------------------


def length_fn(batch: Batch, v) -> torch.Tensor:
    return _row_lengths(_require_var(v, "length", batch)).to(torch.int64)


# -- SAM flag predicates (udfs/sam/samflags.rs:111-135) ---------------------

SAM_FLAGS = {
    "is_paired": 0x1,
    "is_properly_aligned": 0x2,
    "is_unmapped": 0x4,
    "is_mate_unmapped": 0x8,
    "is_reverse_complemented": 0x10,
    "is_mate_reverse_complemented": 0x20,
    "is_first_segment": 0x40,
    "is_last_segment": 0x80,
    "is_secondary": 0x100,
    "is_qc_fail": 0x200,
    "is_duplicate": 0x400,
    "is_supplementary": 0x800,
}


def _flag_values(flags) -> torch.Tensor:
    vals = flags.values if isinstance(flags, FixedColumn) else \
        torch.as_tensor(flags)
    return vals.to(torch.int32)


def _make_flag_fn(bit: int):
    def fn(batch: Batch, flags) -> torch.Tensor:
        return (_flag_values(flags) & bit) != 0

    return fn


def is_mapped(batch: Batch, flags) -> torch.Tensor:
    return (_flag_values(flags) & 0x4) == 0


# -- alignment_score (udfs/sequence/alignment_score.rs:95-140;
#    the sw_score kernel through ops/alignment.py) ---------------------------


def alignment_score(batch: Batch, seq, other, band=None) -> torch.Tensor:
    if band is not None and not isinstance(band, (int, np.integer)):
        raise PlanError("alignment_score takes an optional third argument "
                        "of type int32")
    if isinstance(seq, str) and isinstance(other, VarColumn):
        seq, other = other, seq
    if isinstance(seq, VarColumn) and isinstance(other, str):
        if not other:
            # the JAX scan over an empty query raises ValueError
            raise PlanError("alignment_score: the query is empty")
        return alignment_scores(seq, other.encode())
    if isinstance(seq, str) and isinstance(other, str):
        return alignment_scores_pairwise(
            _require_var(seq, "alignment_score", batch),
            _require_var(other, "alignment_score", batch))
    if isinstance(seq, VarColumn) and isinstance(other, VarColumn):
        return alignment_scores_pairwise(seq, other)
    raise PlanError("alignment_score expects (sequence_column, 'QUERY')")


# -- region predicates (udfs/vcf/mod.rs) ------------------------------------


def _chrom_eq_mask(batch: Batch, chrom, name: str) -> torch.Tensor:
    if isinstance(chrom, DictColumn):
        return str_ops.dict_equals(chrom, name) & chrom.validity
    chrom = _require_var(chrom, "chrom_match", batch)
    return str_ops.equals_literal(chrom, name.encode()) & chrom.validity


def _interval_mask(batch: Batch, pos, lo, hi) -> torch.Tensor:
    vals = pos.values if isinstance(pos, FixedColumn) else torch.as_tensor(pos)
    m = torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)
    if lo is not None:
        m = m & (vals >= lo)
    if hi is not None:
        m = m & (vals <= hi)
    if isinstance(pos, FixedColumn):
        m = m & pos.validity
    return m


def chrom_match(batch: Batch, chrom, name) -> torch.Tensor:
    """Executable chrom predicate (udfs/vcf/mod.rs:156)."""
    return _chrom_eq_mask(batch, chrom, str(name))


def interval_match(batch: Batch, pos, interval) -> torch.Tensor:
    """pos within '<start>-<end>' (1-based inclusive, udfs/vcf/mod.rs:221)."""
    lo_s, _, hi_s = str(interval).partition("-")
    lo = int(lo_s.replace(",", "")) if lo_s else None
    hi = int(hi_s.replace(",", "")) if hi_s else None
    return _interval_mask(batch, pos, lo, hi)


def region_match(batch: Batch, chrom, pos, region) -> torch.Tensor:
    """chrom:interval overlap predicate (udfs/vcf/mod.rs:54)."""
    r = Region.parse(str(region))
    return _chrom_eq_mask(batch, chrom, r.name) & \
        _interval_mask(batch, pos, r.start, r.end)


# -- what the port does not carry yet ---------------------------------------

# exon_tpu/udfs.py functions over list, struct and mzML columns
LIST_UDFS = ("integer_encode_dna", "integer_encoding",
             "quality_score_string_to_list", "quality_score_list_to_string",
             "quality_scores_to_list", "quality_scores_to_string",
             "make_array", "array_element", "array_length", "locate_regex",
             "contains_peak", "bin_vectors")
# the region-filter markers a ported provider plans away (VcfTable; BCF's
# marker shares the VCF semantics); the rest wait for their formats'
# indexed providers
PUSHED_REGION_FILTERS = ("vcf_region_filter", "bcf_region_filter")
def _region_marker(name: str):
    def fn(batch, *args):
        raise PlanError(
            f"{name} should not be called, check your query "
            "(it must appear as a top-level WHERE conjunct on an "
            "indexed table)")

    return fn


# -- registration -----------------------------------------------------------


def _register_all() -> None:
    register_function("gc_content", gc_content, dt.float32)
    register_function("reverse_complement", reverse_complement, dt.utf8)
    register_function("trim_polya", trim_polya, dt.utf8)
    for name in ("length", "char_length", "character_length"):
        register_function(name, length_fn, dt.int64)
    for name, bit in SAM_FLAGS.items():
        register_function(name, _make_flag_fn(bit), dt.bool_)
    register_function("is_mapped", is_mapped, dt.bool_)
    register_function("alignment_score", alignment_score, dt.int32)
    register_function("chrom_match", chrom_match, dt.bool_)
    register_function("interval_match", interval_match, dt.bool_)
    register_function("region_match", region_match, dt.bool_)
    register_not_ported(LIST_UDFS, "item 2b: list, struct and mzML columns")
    # region-filter markers (exon_tpu/udfs.py:493-509): planned away by
    # the provider, never executed
    for name in PUSHED_REGION_FILTERS:
        register_function(name, _region_marker(name), dt.bool_)
    register_not_ported(
        [n for n in REGION_FILTER_UDFS if n not in PUSHED_REGION_FILTERS],
        "item 2c: indexed tables of other formats and their region filters")


_register_all()
