"""The twins of row_hash (K3) and sort_keys (K5) held to exon_tpu at the
shapes their Hopper kernels' designs must survive; test_torch_kernels.py
holds the kernels to the twins on the same cases on a card.

(a) row_hash keeps a thread's chain a byte a step (each redesign timed
beside it lost on the card). Its twin equals exon_tpu/plan/physical.py
``_hash_var`` and ``_hash_bytes_host`` on ``hash_case``'s cases (F38: the
JAX hash counts bytes before offsets[0] into row 0, both answers
asserted): rows of 0, 1, 7-9, 15-17, 39-41 and 255-257 bytes at every
alignment mod 16, every byte value alone, in runs and in order (the
b + 1 = 256 edge), a row of 64 KB among short ones, offsets past 0 with
values past the last row, values that end at the last row (5, 16 and 300
bytes), no rows, one row, 3 tiles of 256 rows and one more, long rows at
the first and last lanes of warps, several in one warp, of 511 and of
3 x 512 + 1 bytes, and rows of 0-3,000 bytes; and on rows of 1-4,099
bytes among short ones, values at every offset mod 16 of their storage.
The kernel's constants are the twin's.
(b) sort_keys writes every key in one launch of up to 16 keys, a var key's
row read in place two chunks a 16-byte word. Its twin equals exon_tpu/plan/
physical.py ``sort_key_columns`` on ``sort_case``'s cases under the four
NULL placements (ASC and DESC by default, NULLS FIRST, NULLS LAST): rows of
those lengths at every alignment, 0x00, 0x7f, 0x80 and 0xff at every byte
of a chunk, nchunks 1-9 over rows of up to 80 bytes, a 30,000-byte row cut
at 3 chunks and rows of 100-320 bytes at 39 and 40 chunks, offsets past 0,
values that end at the last row, no rows, one row, 3 tiles and one more
row, every fixed kind (int64 and int32 at their edges, float64 and float32
with +-0, NaN, +-inf and subnormals, bool, int16, int8, uint8) and 35 keys
(three launches' worth). The JAX package on the CPU flushes float32
subnormals to zero as it widens them: there both answers are asserted. The
ctypes key table matches the kernel's. Every comparison is exact."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exon_tpu as J
from exon_tpu import datatypes as jdt
from exon_tpu.batch import Batch as JBatch
from exon_tpu.batch import FixedColumn as JFixedColumn
from exon_tpu.batch import VarColumn as JVarColumn
from exon_tpu.plan.expressions import NullsOrder as JNullsOrder
from exon_tpu.plan.physical import _hash_bytes_host as j_hash_bytes_host
from exon_tpu.plan.physical import _hash_var as j_hash_var
from exon_tpu.plan.physical import _splitmix_host as j_splitmix_host
from exon_tpu.plan.physical import sort_key_columns as j_sort_key_columns
from exon_tpu_torch.kernels import row_hash as kr
from exon_tpu_torch.kernels import sort_keys as kk
from test_torch_kernels import (HASH_CASES, PLACEMENTS, SORT_CASES,
                                hash_case, sort_case, sort_specs)

CSRC = Path(kk.__file__).resolve().parent / "csrc"
P = kr.FNV_PRIME
M64 = (1 << 64) - 1


# ---------------------------------------------------------------------------
# (a) row_hash
# ---------------------------------------------------------------------------


def _polynomial_hash(data: bytes, length: int) -> int:
    """The hash of ``data``'s bytes with ``length`` in place of its own
    length in the salt term, as signed int64."""
    h = 0
    for b in data:
        h = (h * P + b + 1) & M64
    h = j_splitmix_host((h + int(length) * kr.HASH_SALT) & M64)
    return h - (1 << 64) if h >= (1 << 63) else h


@pytest.mark.parametrize("case", HASH_CASES)
def test_row_hash_twin_matches_jax(case):
    offs, vals = hash_case(case)
    got = kr.row_hash(torch.from_numpy(offs), torch.from_numpy(vals))
    rows = [vals[s:e].tobytes() for s, e in zip(offs[:-1], offs[1:])]
    assert got.numpy().tolist() == [j_hash_bytes_host(r) for r in rows]
    if rows:
        want = np.asarray(j_hash_var(JVarColumn(
            jnp.asarray(vals), jnp.asarray(offs),
            jnp.ones(len(rows), bool)))).tolist()
        if offs[0] > 0:
            # F38: the JAX hash counts the bytes before offsets[0] into row
            # 0's polynomial (its length stays the row's); the port hashes
            # the row's own bytes
            assert want[0] == _polynomial_hash(vals[:offs[1]].tobytes(),
                                               offs[1] - offs[0])
            assert want[0] != got[0]
            want[0] = int(got[0])
        assert got.numpy().tolist() == want


@pytest.mark.parametrize("off", [1, 3, 7, 15])
def test_row_hash_twin_on_a_view_of_values(off):
    """values as a view at an odd offset of its storage, ending with it."""
    offs, vals = hash_case("lengths")
    base = torch.zeros(len(vals) + off, dtype=torch.uint8)
    base[off:] = torch.from_numpy(vals)
    got = kr.row_hash(torch.from_numpy(offs), base[off:])
    assert got.numpy().tolist() == [
        j_hash_bytes_host(vals[s:e].tobytes())
        for s, e in zip(offs[:-1], offs[1:])]


def test_row_hash_kernel_constants_match_the_twin():
    text = (CSRC / "row_hash.cu").read_text()
    assert f"kPrime = {kr.FNV_PRIME}ull;" in text
    assert f"kSalt = 0x{kr.HASH_SALT:X}ull;" in text


@pytest.mark.parametrize("length", [1, 7, 8, 9, 15, 16, 17, 255, 256, 257,
                                    511, 512, 513, 1537, 4099])
def test_row_hash_twin_equals_the_horner_chain(length):
    """A row of ``length`` bytes among 31 short ones, on values at offsets
    0-15 of their storage: the twin equals the byte-serial chain mod 2^64
    with its salt and finalizer."""
    rng = np.random.default_rng(length)
    lens = list(rng.integers(0, 70, 31))
    lens.insert(length % 32, length)
    rows = [bytes(rng.integers(0, 256, k, dtype=np.uint8)) for k in lens]
    offs = torch.tensor([sum(lens[:i]) for i in range(33)],
                        dtype=torch.int32)
    vals = torch.from_numpy(np.frombuffer(b"".join(rows), np.uint8).copy())
    want = [_polynomial_hash(r, len(r)) for r in rows]
    for off in range(16):
        base = torch.zeros(len(vals) + off, dtype=torch.uint8)
        base[off:] = vals
        assert kr.row_hash(offs, base[off:]).tolist() == want, off


# ---------------------------------------------------------------------------
# (b) sort_keys
# ---------------------------------------------------------------------------

_JTYPES = {np.dtype(np.int64): jdt.int64, np.dtype(np.int32): jdt.int32,
           np.dtype(np.float64): jdt.float64,
           np.dtype(np.float32): jdt.float32, np.dtype(np.bool_): jdt.bool_,
           np.dtype(np.int16): jdt.int16, np.dtype(np.int8): jdt.int8,
           np.dtype(np.uint8): jdt.uint8}


def _jax_matrix(n: int, keys: list, specs: list) -> np.ndarray:
    """sort_key_columns over a JAX batch of the keys, each under its
    spec's direction and NULL placement."""
    fields, cols, jspecs = [], [], []
    for j, (k, s) in enumerate(zip(keys, specs)):
        name = f"k{j}"
        if "offsets" in k:
            fields.append(jdt.Field(name, jdt.utf8))
            cols.append(JVarColumn(jnp.asarray(k["values"]),
                                   jnp.asarray(k["offsets"]),
                                   jnp.asarray(k["validity"])))
        else:
            fields.append(jdt.Field(name, _JTYPES[k["values"].dtype]))
            cols.append(JFixedColumn(jnp.asarray(k["values"]),
                                     jnp.asarray(k["validity"])))
        e = J.col(name)
        if s.nulls_first is not None:
            e = JNullsOrder(e, s.nulls_first)
        jspecs.append((e, s.asc, k.get("nchunks", 0)))
    batch = JBatch(jdt.Schema.of(*fields), cols, np.int32(n))
    return np.stack([np.asarray(c) for c in j_sort_key_columns(
        batch, tuple(jspecs))])


@pytest.mark.parametrize("placement", PLACEMENTS)
@pytest.mark.parametrize("case", SORT_CASES)
def test_sort_keys_twin_matches_jax(case, placement):
    n, keys = sort_case(case)
    specs = sort_specs(keys, placement, "cpu", shift=case == "many keys")
    got = kk.sort_keys(specs, n, "cpu")
    assert got.shape == (1 + sum(s.rows for s in specs), n)
    if not n:
        return
    want = _jax_matrix(n, keys, specs)
    # the JAX package on the CPU flushes float32 subnormals to zero when it
    # widens them; the port keeps them: both answers, and the rest exact
    row = 1
    for k, spec in zip(keys, specs):
        v = k.get("values")
        if v is not None and v.dtype == np.float32 and "offsets" not in k:
            sub = (v != 0) & (np.abs(v) < np.finfo(np.float32).tiny)
            flat = kk.sort_keys([kk.FixedKey(
                torch.from_numpy(np.where(sub, np.copysign(0, v), v)
                                 .astype(np.float32)), spec.validity,
                spec.asc, spec.nulls_first)], n, "cpu")[2].numpy()
            assert (want[row + 1][sub] == flat[sub]).all()
            assert (got[row + 1].numpy()[sub] != flat[sub]).all()
            want[row + 1][sub] = got[row + 1].numpy()[sub]
        row += spec.rows
    assert got.numpy().tolist() == want.tolist()


def test_sort_keys_table_matches_the_kernel():
    """The wrapper's 7 int64 slots a key are SortKey's 56 bytes: three
    pointers, the values' bytes, kind and nchunks, asc and the NULL mode
    (each pair one slot, the first in its low half), the first row."""
    text = (CSRC / "sort_keys.cu").read_text()
    assert f"constexpr int kMaxKeys = {kk.MAX_KEYS};" in text
    fields = re.search(r"struct SortKey \{(.*?)\};", text, re.S).group(1)
    members = [(t.replace("const ", ""), name) for t, name in re.findall(
        r"^\s*((?:const )?[\w]+\*?) (\w+);", fields, re.M)]
    assert members == [("int32_t*", "offsets"), ("void*", "values"),
                       ("bool*", "valid"), ("int64_t", "n_values"),
                       ("int32_t", "kind"), ("int32_t", "nchunks"),
                       ("int32_t", "asc"), ("int32_t", "mode"),
                       ("int64_t", "row")]
    assert "(56 bytes)" in text and 8 * kk.KEY_SLOTS == 56
    assert len(kk._TABLE) == kk.KEY_SLOTS * kk.MAX_KEYS
    assert kk._KIND[torch.int16] == 5 and kk._KIND[torch.int8] == 6
    assert "5 int16, 6 int8, 7 a var key" in text and kk._VAR == 7


def test_sort_keys_checks_every_key_before_the_twin():
    offs, vals = hash_case("one row")
    t = torch.from_numpy
    good = kk.VarKey(t(offs), t(vals), torch.ones(1, dtype=torch.bool), 3)
    with pytest.raises(TypeError, match="int32 offsets"):
        kk.sort_keys([good, kk.VarKey(t(offs).long(), t(vals),
                                      torch.ones(1, dtype=torch.bool), 3)],
                     1, "cpu")
    with pytest.raises(TypeError, match="bool validity"):
        kk.sort_keys([kk.FixedKey(torch.zeros(1), torch.ones(2, dtype=bool))],
                     1, "cpu")
    assert kk.sort_keys([], 3, "cpu").tolist() == [[0, 0, 0]]
