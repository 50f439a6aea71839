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

The list UDFs (K11b, :47-129, :225-402) return ListColumns over the same
row offsets: ``integer_encode_dna``, ``integer_encoding`` and
``quality_score_string_to_list`` run map_bytes' widen mode (a 256-entry
table, to int8 or int64), ``quality_score_list_to_string`` its narrow mode;
``contains_peak`` and ``bin_vectors`` run the list_bins kernel;
``array_element`` and ``array_length`` are an index gather and offset
differences (Lib); ``make_array`` and ``locate_regex`` (a regex, as in the
JAX package) run on the host. A list argument must hold fixed-width values
or be a string (its bytes), as ``_as_var`` (:275) allows; a list of strings
raises PlanError, as there.

Registration follows ``_register_all`` (:436-508). The VCF and BCF
region-filter markers are registered as the JAX package does: a provider
plans them away, and one that reaches execution raises PlanError. The
markers of formats without an indexed provider are registered as not
ported: calling one raises NotImplementedError naming its ROADMAP item. The
SQL functions of exon_tpu/ops/sqlfuncs.py are in ops/sqlfuncs.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import datatypes as dt
from .batch import (Batch, DictColumn, FixedColumn, ListColumn,
                    StructColumn, VarColumn, fixed_column, utf8_column)
from .errors import PlanError
from .formats.fasta import DNA_CODE
from .kernels.count_bytes import count_bytes
from .kernels.gather_spans import gather_spans
from .kernels.list_bins import list_bins_bins, list_bins_peak
from .kernels.map_bytes import map_bytes, map_bytes_narrow, map_bytes_widen
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
    one IEEE float32 divide, as the JAX function does, inside count_bytes'
    one launch (its share mode)."""
    col = _require_var(seq, "gc_content", batch)
    return count_bytes(col.offsets, col.values, GC, share=True)


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


# -- list columns (K11b) ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _int64_table(table: bytes, device: torch.device) -> torch.Tensor:
    """A 256-entry int64 table (its bytes) on ``device``, copied there
    once."""
    return torch.frombuffer(bytearray(table), dtype=torch.int64).to(device)


def _widen(col: VarColumn, table: np.ndarray, out: torch.dtype) -> ListColumn:
    """Each byte through ``table``: a list per row over the same offsets."""
    t = _int64_table(table.astype(np.int64).tobytes(), col.values.device)
    vals = map_bytes_widen(col.values, t, out)
    return ListColumn(FixedColumn(vals, torch.ones(vals.shape[0],
                                                   dtype=torch.bool,
                                                   device=vals.device)),
                      col.offsets, col.validity)


def _fixed_list(v, fn: str) -> tuple:
    """(values, offsets, validity) of a list argument: a list of
    fixed-width values, or a string's bytes (``_as_var``, :275)."""
    if isinstance(v, ListColumn) and isinstance(v.child, FixedColumn):
        return v.child.values, v.offsets, v.validity
    if isinstance(v, VarColumn):
        return v.values, v.offsets, v.validity
    raise PlanError(f"{fn} expects a list column")


def make_array(batch: Batch, *args) -> ListColumn:
    """DataFusion make_array of literals: the same list on every row
    (:47)."""
    n = batch.capacity if batch is not None and batch.columns else 1
    if any(not isinstance(a, (int, np.integer)) or isinstance(a, bool)
           for a in args):
        # a TypeError, as the JAX package's numpy tile of a column raises
        raise TypeError("make_array takes integer literals")
    dev = batch.device
    flat = torch.tensor(list(args) * n, dtype=torch.int64, device=dev)
    offsets = torch.arange(n + 1, dtype=torch.int32, device=dev) * len(args)
    return ListColumn(fixed_column(flat, torch.ones_like(flat,
                                                         dtype=torch.bool)),
                      offsets, torch.ones(n, dtype=torch.bool, device=dev))


def integer_encode_dna(batch: Batch, seq) -> ListColumn:
    """A, C, G, T, N → 1..5, any other byte 0, as int8 (:106)."""
    return _widen(_require_var(seq, "integer_encode_dna", batch), DNA_CODE,
                  torch.int8)


_PHRED = np.arange(256, dtype=np.int64) - 33


def quality_score_string_to_list(batch: Batch, q) -> ListColumn:
    """Phred+33 ASCII → List<Int64> of scores (:115)."""
    return _widen(_require_var(q, "quality_score_string_to_list", batch),
                  _PHRED, torch.int64)


def quality_score_list_to_string(batch: Batch, q) -> VarColumn:
    """List<Int64> of scores → Phred+33 ASCII, each score x as the byte
    (int32(x) + 33) & 0xFF (:122)."""
    if isinstance(q, (str, bytes, DictColumn)):
        q = _require_var(q, "quality_score_list_to_string", batch)
    vals, offsets, validity = _fixed_list(q, "quality_score_list_to_string")
    return VarColumn(map_bytes_narrow(vals.to(torch.int64)), offsets,
                     validity)


def integer_encoding(batch: Batch, seq, alphabet) -> ListColumn:
    """Each byte's index in ``alphabet`` (the last occurrence of a repeated
    byte wins), 0 for any other byte (:340)."""
    lut = np.zeros(256, np.int64)
    for i, b in enumerate(str(alphabet).encode()):
        lut[b] = i
    return _widen(_require_var(seq, "integer_encoding", batch), lut,
                  torch.int64)


def array_element(batch: Batch, arr, index) -> FixedColumn:
    """1-based list element; out of range or a NULL list gives NULL
    (:285)."""
    vals, offsets, validity = _fixed_list(arr, "array_element")
    i = int(index)
    lens = offsets[1:] - offsets[:-1]
    ok = (lens >= i) & validity if i >= 1 else torch.zeros_like(validity)
    if vals.shape[0] == 0:
        return FixedColumn(torch.zeros(lens.shape[0], dtype=vals.dtype,
                                       device=vals.device), ok)
    pos = (offsets[:-1].long() + (i - 1)).clamp(0, vals.shape[0] - 1)
    return FixedColumn(vals[pos], ok)


def array_length(batch: Batch, arr) -> FixedColumn:
    _vals, offsets, validity = _fixed_list(arr, "array_length")
    return FixedColumn((offsets[1:] - offsets[:-1]).to(torch.int64),
                       validity)


LOCATE_REGEX_T = dt.list_(dt.struct([
    dt.Field("start", dt.int32, True),
    dt.Field("end", dt.int32, True),
    dt.Field("match", dt.utf8, True),
]))


def locate_regex(batch: Batch, seq, pattern) -> ListColumn:
    """List<Struct{start, end, match}> of a regex's matches in each row,
    1-based start and end + 1 (:225-262); the regex runs on the host."""
    import re

    if not isinstance(pattern, str):
        raise PlanError("Execution error: locate_regex takes different "
                        "types of arguments, the a sequence and a pattern")
    col = _require_var(seq, "locate_regex", batch)
    rx = re.compile(pattern)
    offs = col.offsets.cpu().numpy()
    raw = col.values.cpu().numpy().tobytes()
    valid = col.validity.cpu().numpy()
    starts, ends, matches, counts = [], [], [], []
    for i in range(len(offs) - 1):
        if not valid[i]:
            counts.append(0)
            continue
        ms = list(rx.finditer(raw[offs[i]:offs[i + 1]].decode("utf-8",
                                                              "replace")))
        counts.append(len(ms))
        for m in ms:
            starts.append(m.start() + 1)
            ends.append(m.end() + 1)
            matches.append(m.group(0))
    loffs = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=loffs[1:])
    entry = StructColumn({
        "start": fixed_column(np.asarray(starts, np.int32)),
        "end": fixed_column(np.asarray(ends, np.int32)),
        "match": utf8_column(matches),
    }, np.ones(len(starts), np.bool_))
    host = ListColumn(entry, loffs.astype(np.int32), valid)
    return Batch(None, [host], len(counts)).to_device(col.values.device) \
        .columns[0]


def _number(v, fn: str) -> float:
    if not isinstance(v, (int, float, np.integer, np.floating)) or \
            isinstance(v, bool):
        raise PlanError(f"{fn} takes number literals after its lists")
    return float(v)


def contains_peak(batch: Batch, mz, peak_mz, tolerance) -> torch.Tensor:
    """Whether any m/z of the row lies within ±tolerance of peak_mz
    (:376), on list_bins' peak mode."""
    if not (isinstance(mz, ListColumn) and isinstance(mz.child, FixedColumn)):
        raise PlanError("contains_peak expects a List<Float64> column")
    return list_bins_peak(mz.offsets, mz.child.values.to(torch.float64),
                          mz.validity, _number(peak_mz, "contains_peak"),
                          _number(tolerance, "contains_peak"))


def bin_vectors(batch: Batch, mz, intensity, min_mz, num_bins, bin_width
                ) -> ListColumn:
    """Intensities summed into ``num_bins`` m/z bins of ``bin_width`` from
    ``min_mz``: List<Float64>[num_bins] on every row (:389), on list_bins'
    bins mode. Intensity is read at m/z's flat positions, as the JAX
    function reads it."""
    lists = [mz, intensity]
    if not all(isinstance(x, ListColumn) and isinstance(x.child, FixedColumn)
               for x in lists):
        raise PlanError("bin_vectors expects two List<Float64> columns")
    nb = int(num_bins)
    sums = list_bins_bins(mz.offsets, mz.child.values.to(torch.float64),
                          intensity.child.values.to(torch.float64),
                          _number(min_mz, "bin_vectors"),
                          _number(bin_width, "bin_vectors"), nb)
    n = mz.capacity
    dev = sums.device
    offsets = torch.arange(n + 1, dtype=torch.int32, device=dev) * nb
    return ListColumn(FixedColumn(sums, torch.ones(sums.shape[0],
                                                   dtype=torch.bool,
                                                   device=dev)),
                      offsets, mz.validity)


# the exon_tpu/udfs.py functions over list, struct and mzML columns
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
    register_function("integer_encode_dna", integer_encode_dna,
                      dt.list_(dt.int8))
    # the reference session's names (udfs/sequence/mod.rs) beside the
    # long ones
    for name in ("quality_score_string_to_list", "quality_scores_to_list"):
        register_function(name, quality_score_string_to_list,
                          dt.list_(dt.int64))
    for name in ("quality_score_list_to_string", "quality_scores_to_string"):
        register_function(name, quality_score_list_to_string, dt.utf8)
    register_function("make_array", make_array, dt.list_(dt.int64))
    register_function("locate_regex", locate_regex, LOCATE_REGEX_T)
    register_function("integer_encoding", integer_encoding,
                      dt.list_(dt.int64))
    register_function("array_element", array_element, lambda a: (
        a[0].dtype.value_type if a and a[0].dtype.kind == dt.TypeKind.LIST
        else dt.int64))
    register_function("array_length", array_length, dt.int64)
    register_function("contains_peak", contains_peak, dt.bool_)
    register_function("bin_vectors", bin_vectors, dt.list_(dt.float64))
    # region-filter markers (exon_tpu/udfs.py:493-509): planned away by
    # the provider, never executed
    for name in PUSHED_REGION_FILTERS:
        register_function(name, _region_marker(name), dt.bool_)
    register_not_ported(
        [n for n in REGION_FILTER_UDFS if n not in PUSHED_REGION_FILTERS],
        "item 2c: indexed tables of other formats and their region filters")


_register_all()
