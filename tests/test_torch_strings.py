"""LIKE / ILIKE of exon_tpu_torch (the like_match twin) held to
exon_tpu.ops.strings.like on JAX CPU over a table of patterns. Tolerance:
exact (boolean masks)."""

import numpy as np
import pytest
import torch

from exon_tpu import batch as jb
from exon_tpu.ops import strings as jstr
from exon_tpu_torch import batch as tb
from exon_tpu_torch.kernels import like_match as kl
from exon_tpu_torch.ops import strings as tstr

WORDS = ["", "A", "AB", "ABC", "abc", "ABCABC", "KK", "MKKV", "MAKKKC",
         "AXC", "AXXC", "A%C", "A_C", "aBxYz", "XYZ", "ZZXYZ", "exact",
         "EXACT", "exactly", "M", "MA", "AAC", "ACAC", "ab%c", "Ab%", "B"]

PATTERNS = [
    ("prefix", "AB%", False, None),
    ("suffix", "%YZ", False, None),
    ("contains", "%KK%", False, None),
    ("exact", "exact", False, None),
    ("underscore", "A_C", False, None),
    ("underscore_in_middle", "%A_C%", False, None),
    ("multi_percent", "A%B%C", False, None),
    ("multi_percent_overlap", "%C%C", False, None),
    ("only_percent", "%", False, None),
    ("empty_pattern", "", False, None),
    ("escape_percent", "A!%C", False, "!"),
    ("escape_underscore", "%!_%", False, "!"),
    ("escape_trailing", "ab!%%", False, "!"),
    ("ilike_prefix", "ab%", True, None),
    ("ilike_contains", "%xy%", True, None),
    ("ilike_exact", "EXACT", True, None),
    ("ilike_underscore", "a_c", True, None),
]


def _column():
    rng = np.random.default_rng(5)
    words = [WORDS[i] for i in rng.integers(0, len(WORDS), size=120)]
    col = tb.utf8_column(words)
    return col, jb.utf8_column(words)


@pytest.mark.parametrize("pattern,ci,escape",
                         [p[1:] for p in PATTERNS], ids=[p[0] for p in PATTERNS])
def test_like_matches_jax(pattern, ci, escape):
    tcol, jcol = _column()
    n = tcol.capacity
    jpad = jb._pad_to_device(jcol, None, n, n, None)
    want = np.asarray(jstr.like(jpad, pattern, ci, escape))[:n]
    got = tstr.like(tb.VarColumn(torch.from_numpy(tcol.values),
                                 torch.from_numpy(tcol.offsets),
                                 torch.from_numpy(tcol.validity)),
                    pattern, ci, escape)
    assert np.array_equal(got.numpy(), want)


def test_like_on_dictionary_uses_vocab():
    vocab = ("exon", "CDS", "five_prime_UTR", "three_prime_UTR")
    codes = torch.tensor([0, 1, 2, 3, 2, 0], dtype=torch.int32)
    col = tb.DictColumn(codes, torch.ones(6, dtype=torch.bool), vocab)
    got = tstr.dict_like(col, "%prime%", False, None)
    assert got.tolist() == [False, False, True, True, True, False]
    assert tstr.dict_equals(col, "exon").tolist() == \
        [True, False, False, False, False, True]
    assert tstr.dict_isin(col, ["CDS", "nope"]).tolist() == \
        [False, True, False, False, False, False]


def test_like_twin_empty_column():
    offs = torch.zeros(1, dtype=torch.int32)
    out = kl.like_match(offs, torch.zeros(0, dtype=torch.uint8),
                        tstr.tokenize_like("%a%"), False)
    assert out.shape == (0,)


def test_encode_pattern_layout():
    # [chunks, ci, a record a chunk (token start, count, filter start,
    # count), tokens (upper-cased under ILIKE), filter entries value |
    # offsets << 8]
    chunks = tstr.tokenize_like("a_%bc%")
    assert kl.encode_pattern(chunks, True) == \
        [3, 1, 14, 2, 18, 1, 16, 2, 19, 2, 18, 0, 21, 0,
         ord("A"), -1, ord("B"), ord("C"),
         ord("A") | 1 << 8, ord("B") | 1 << 8, ord("C") | 2 << 8]
