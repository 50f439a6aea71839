"""Smith-Waterman local alignment scores of var-width columns.

Counterpart of exon_tpu/ops/alignment.py: ``alignment_scores`` (:125) and
``alignment_scores_pairwise`` (:111) run the sw_score kernel (K9), which
aligns each row whole. The JAX wrappers pad every row into a matrix at
most 2048 bytes wide and so score only a longer row's first 2048 bytes
(F11, ROADMAP Queue 3). A column with no bytes at all scores 0 on every row
(F12: the JAX gather raises on an empty values buffer).
"""

from __future__ import annotations

import numpy as np
import torch

from ..batch import VarColumn
from ..kernels.sw_score import sw_score, sw_score_pairwise


def alignment_scores(col: VarColumn, query: bytes) -> torch.Tensor:
    """alignment_score(seq_col, 'QUERY') → int32 scores per row."""
    q = torch.from_numpy(np.frombuffer(query, np.uint8).copy())
    return sw_score(col.offsets, col.values, q.to(col.offsets.device))


def alignment_scores_pairwise(a: VarColumn, b: VarColumn) -> torch.Tensor:
    """alignment_score(s1_col, s2_col) → int32 per-row scores of row i of a
    against row i of b."""
    return sw_score_pairwise(a.offsets, a.values, b.offsets, b.values)
