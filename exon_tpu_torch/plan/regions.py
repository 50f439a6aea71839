"""Region predicate inference for scans with region pushdown.

Copy of exon_tpu/plan/regions.py: ``REGION_FILTER_UDFS`` (:27),
``infer_region_from_expr`` (:39), ``is_region_filter`` (:55),
``infer_regions_from_filters`` (:66) and ``region_to_point_expr`` (:124).
Marker UDFs (``vcf_region_filter('17:100-200', chrom, pos)``, …) carry a
literal region; a provider declares them Exact and extracts the Region at
scan time. ``rewrite_plain_predicates`` (:85) has no caller in the JAX
package and is not copied: a plain ``chrom = … AND pos …`` stays a filter
in both packages. Intervals are 1-based inclusive.
"""

from __future__ import annotations

from typing import Optional

from ..errors import InvalidRegionError
from ..region import Region
from .expressions import BinaryOp, Expr, FunctionCall, Literal

REGION_FILTER_UDFS = {
    "vcf_region_filter": "point",        # (region, chrom, pos)
    "bcf_region_filter": "point",
    "bam_region_filter": "interval",     # (region, reference[, start, end])
    "cram_region_filter": "interval",
    "sam_region_filter": "interval",
    "gff_region_filter": "interval",
    "bigwig_region_filter": "interval",
    "fasta_region_filter": "name",       # (region, id)
}


def infer_region_from_expr(expr: Expr) -> Optional[Region]:
    """Extract a Region from a marker UDF call (infer_region.rs:25-42)."""
    if isinstance(expr, FunctionCall) and expr.name.lower() in REGION_FILTER_UDFS:
        if not expr.args or not isinstance(expr.args[0], Literal):
            raise InvalidRegionError(
                f"{expr.name} requires a literal region argument")
        return Region.parse(str(expr.args[0].value))
    # `f(...) = true` form
    if isinstance(expr, BinaryOp) and expr.op == "=":
        if isinstance(expr.right, Literal) and expr.right.value is True:
            return infer_region_from_expr(expr.left)
        if isinstance(expr.left, Literal) and expr.left.value is True:
            return infer_region_from_expr(expr.right)
    return None


def is_region_filter(expr: Expr) -> bool:
    try:
        if infer_region_from_expr(expr) is not None:
            return True
    except InvalidRegionError:
        return True  # it *is* one, just malformed — let scan raise
    if isinstance(expr, BinaryOp) and expr.op == "or":
        return is_region_filter(expr.left) and is_region_filter(expr.right)
    return False


def infer_regions_from_filters(filters) -> list[Region]:
    out = []

    def visit(f) -> bool:
        r = infer_region_from_expr(f)
        if r is not None:
            out.append(r)
            return True
        # OR of region markers (region-file expansion) extracts every branch
        if isinstance(f, BinaryOp) and f.op == "or":
            left = visit(f.left)
            return visit(f.right) and left
        return False

    for f in filters:
        visit(f)
    return out


def region_to_point_expr(region: Region, chrom_col: str, pos_col: str) -> Expr:
    """chrom == name AND pos within [start, end] (VCF/BCF row semantics,
    exon-vcf/src/indexed_async_batch_stream.rs:99-115)."""
    from .expressions import col, lit

    e: Expr = BinaryOp("=", col(chrom_col), lit(region.name))
    if region.start is not None:
        e = BinaryOp("and", e, BinaryOp(">=", col(pos_col), lit(region.start)))
    if region.end is not None:
        e = BinaryOp("and", e, BinaryOp("<=", col(pos_col), lit(region.end)))
    return e
