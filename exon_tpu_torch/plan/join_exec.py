"""Hash equi-join: sorted build side + searchsorted probe.

Counterpart of exon_tpu/plan/join_exec.py: ``join_schema`` (:36),
``JoinExec`` (:57), ``_jit_build_sort`` (:98), ``_jit_probe_plan`` (:198),
``_jit_emit`` (:239) and ``_null_where`` (:304, ``ops/layout.py``
``null_where`` here), for inner and left joins.

  build:  collect the build (right) side once with ``concat_batches``; key
          it; ``torch.sort(stable=True)`` orders it by (NULL key last, key)
  probe:  per streamed probe (left) batch, two ``torch.searchsorted`` give
          each row its match range [lo, hi); the expand_segments kernel lays
          out the (probe row, build row) pairs; the pairs are verified, and
          the surviving ones gathered into the output batch

Keys are per-part int64 (``join_key_parts``): the search runs on their fold,
as the JAX package's does, but every match is then verified part by part:
fixed-width parts by value, dictionary parts by their content hash (a hash
shared by two strings raises), var-width parts byte for byte by the
string_eq kernel. The JAX package verifies only var-width parts, and only
their first 32 bytes and length (ROADMAP Queue 3); the results differ from
it only where its unverified matches are wrong.

Host reads per probe batch: the slot total, which sizes the pairs (as
join_exec.py:87 reads its totals), then the surviving row count and the byte
total of each var-width output column, which size the gathers.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch

from ..batch import Batch, DictColumn, Schema, VarColumn, empty_batch
from ..errors import PlanError
from ..kernels.expand_segments import expand_segments
from ..kernels.string_eq import string_eq
from ..ops import layout as layout_ops
from .expressions import Expr, as_bool_mask, eval_expr
from .physical import PhysicalPlan, concat_batches, fold_key, join_key_parts

_I64_MAX = (1 << 63) - 1


def join_schema(lschema: Schema, rschema: Schema,
                right_names: dict | None = None) -> tuple[Schema, list[str]]:
    """Left fields + right fields; a right name that collides with a left
    one gets a ``_right`` suffix unless ``right_names`` pins it
    (exon_tpu/plan/join_exec.py:36, unchanged)."""
    lnames = {f.name for f in lschema.all_fields}
    fields = list(lschema.all_fields)
    rnames = []
    for f in rschema.all_fields:
        if right_names is not None and f.name in right_names:
            name = right_names[f.name]
        else:
            name = f.name
            if name in lnames:
                name = name + "_right"
        rnames.append(name)
        fields.append(dataclasses.replace(f, name=name))
    return Schema(tuple(fields)), rnames


def _is_string(col) -> bool:
    return isinstance(col, (VarColumn, DictColumn))


def _as_var(col) -> VarColumn:
    return layout_ops.dict_to_var(col) if isinstance(col, DictColumn) else col


@dataclasses.dataclass
class _BuildSide:
    batch: Batch          # build rows, live keys first in key order
    keys: torch.Tensor    # int64 [n]: folded keys, INT64_MAX past n_live
    parts: torch.Tensor   # int64 [P, n]: per-part keys in the same order
    cols: list            # per part: the key column, in the same order
    n_live: int           # rows whose every key part is non-NULL
    _var: dict = dataclasses.field(default_factory=dict)

    def var_col(self, p: int) -> VarColumn:
        """Key part p as a var-width column (a dictionary decoded once)."""
        if p not in self._var:
            self._var[p] = _as_var(self.cols[p])
        return self._var[p]


@dataclasses.dataclass
class JoinExec(PhysicalPlan):
    left: PhysicalPlan    # probe side (streamed)
    right: PhysicalPlan   # build side (collected)
    on: list              # [(left_expr, right_expr)]
    how: str              # inner | left
    filter: Optional[Expr]
    out_schema: Schema

    def children(self):
        return [self.left, self.right]

    def schema(self) -> Schema:
        return self.out_schema

    def batches(self) -> Iterator[Batch]:
        if self.how not in ("inner", "left"):
            # the JAX JoinExec gives an inner join for any other ``how``
            # (ROADMAP Queue 3, F21); SQL RIGHT and FULL JOIN plan through
            # LEFT joins and a union
            raise NotImplementedError(
                f"DataFrame.join takes inner or left, not {self.how!r}")
        rschema = self.right.schema()
        parts = [b for b in self.right.batches() if b.length]
        vocab_of: dict = {}
        build = (self._build_side(concat_batches(rschema, parts,
                                                 parts[0].device), vocab_of)
                 if parts else None)
        for pb in self.left.batches():
            if pb.length == 0:
                continue
            if build is None:
                if self.how == "left":
                    yield self._unmatched(pb, rschema)
                continue
            out = self._probe(pb, build, vocab_of)
            if out is not None:
                yield out

    def _build_side(self, build: Batch, vocab_of: dict) -> _BuildSide:
        """Sort the build side by (NULL key, folded key), both stable, as
        ``_jit_build_sort`` (join_exec.py:98) does."""
        parts, valid, _cols = join_key_parts([r for _l, r in self.on], build,
                                             vocab_of)
        keys = fold_key(parts)
        perm = torch.sort(keys, stable=True).indices
        perm = perm[torch.sort((~valid)[perm].to(torch.uint8),
                               stable=True).indices]
        n_live = int(valid.sum())
        skeys = keys[perm]
        skeys[n_live:] = _I64_MAX
        sorted_build = layout_ops.take_batch(build, perm.to(torch.int32))
        return _BuildSide(sorted_build, skeys, parts[:, perm],
                          [eval_expr(r, sorted_build) for _l, r in self.on],
                          n_live)

    def _probe(self, pb: Batch, build: _BuildSide, vocab_of: dict
               ) -> Optional[Batch]:
        parts, valid, cols = join_key_parts([l for l, _r in self.on], pb,
                                            vocab_of)
        keys = fold_key(parts)
        lo = torch.searchsorted(build.keys, keys, side="left")
        hi = torch.searchsorted(build.keys, keys, side="right")
        lo, hi = lo.clamp(max=build.n_live), hi.clamp(max=build.n_live)
        counts = torch.where(valid, hi - lo, 0).to(torch.int32)
        # a left join emits every probe row at least once, unmatched
        out_counts = counts.clamp(min=1) if self.how == "left" else counts
        probe_idx, build_idx, offsets, total = expand_segments(
            lo.to(torch.int32), out_counts, build.batch.length)
        if total == 0:
            return None
        ok = self._verify(parts, cols, build, probe_idx, build_idx)
        ok &= counts[probe_idx.long()] > 0
        if self.filter is not None:
            raw = Batch(self.out_schema,
                        layout_ops.take_batch(pb, probe_idx).columns
                        + layout_ops.take_batch(build.batch,
                                                build_idx).columns, total)
            ok &= as_bool_mask(eval_expr(self.filter, raw), raw)
        null_right = None
        if self.how == "left":
            # a probe row none of whose matches survived keeps one
            # null-extended row: its first slot (join_exec.py:280-297)
            pidx = probe_idx.long()
            surv = torch.zeros(pb.length, dtype=torch.uint8,
                               device=ok.device).scatter_reduce(
                0, pidx, ok.to(torch.uint8), "amax")
            first = torch.arange(total, device=ok.device) == \
                offsets[:-1][pidx]
            null_right = first & (surv[pidx] == 0)
            ok |= null_right
        sel, count = layout_ops.mask_to_indices(ok)
        sel = sel[: int(count)]
        right = layout_ops.take_batch(build.batch, build_idx[sel.long()])
        right_cols = right.columns if null_right is None else \
            [layout_ops.null_where(c, null_right[sel.long()])
             for c in right.columns]
        left = layout_ops.take_batch(pb, probe_idx[sel.long()])
        return Batch(self.out_schema, left.columns + right_cols,
                     sel.shape[0])

    def _verify(self, parts, cols, build: _BuildSide, probe_idx, build_idx
                ) -> torch.Tensor:
        return verify_pairs(parts, cols, build.parts, build.cols, probe_idx,
                            build_idx, build.var_col)

    def _unmatched(self, pb: Batch, rschema: Schema) -> Batch:
        """A left join's probe batch against an empty build side: every
        right column NULL."""
        right = empty_batch(rschema, pb.length).to_device(pb.device)
        return Batch(self.out_schema, pb.columns + right.columns, pb.length)


def verify_pairs(a_parts, a_cols, b_parts, b_cols, ia: torch.Tensor,
                 ib: torch.Tensor, b_var=None) -> torch.Tensor:
    """bool per pair (row ia[k] of side a, row ib[k] of side b): every key
    part equal. String parts (var-width on either side) compare byte for
    byte; the rest by their int64 part (a dictionary's is its verified
    content hash). ``b_var(p)`` gives side b's part p as a var-width column
    (by default decoded here)."""
    ok = torch.ones(ia.shape[0], dtype=torch.bool, device=ia.device)
    for p, (a, b) in enumerate(zip(a_cols, b_cols)):
        if _is_string(a) != _is_string(b):
            raise PlanError("join keys compare a string with a number")
        if isinstance(a, VarColumn) or isinstance(b, VarColumn):
            a, b = _as_var(a), b_var(p) if b_var else _as_var(b)
            ok &= string_eq((a.offsets, a.values, a.validity), ia,
                            (b.offsets, b.values, b.validity), ib)
        else:
            ok &= a_parts[p][ia.long()] == b_parts[p][ib.long()]
    return ok
