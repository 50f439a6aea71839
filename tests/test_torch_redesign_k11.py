"""The twins of count_bytes and polya_tail (K11, K12) held to exon_tpu at
the shapes their Hopper kernels' designs must survive;
test_torch_kernels.py holds the kernels to the twins on the same cases on
a card.

count_bytes reads a row as aligned 16-byte words, a thread a row and its
warp for a row past 32 words, tests a class of up to 8 members
by SWAR and a larger one (or none) by a 256-bit mask, and in share mode
divides in the kernel. polya_tail walks a row's scanned end a word a step
by its thread for up to 272 bytes and by its warp past that, 512 bytes a
step, and answers both ends in one launch. So the cases
(``byteclass_case``) are: empty rows (NULL among them: every seventh row's
validity is false) and rows of 1 byte; all-class rows; class runs of 15,
16, 17, 255, 256, 257, 511, 512 and 513 bytes at either end and at both
(a word's, a thread walk's and a warp step's edges); rows of 0-48 bytes,
so that row ends fall at every offset mod 16; a 64 KB row (mixed,
all-class, and runs of 30,000 and 35,535 bytes around one other byte)
among 100-byte rows; offsets that start past 0 with class bytes just
before the first row and just after the last, which no row may take; n of
1 and of 0; over the classes ``BYTECLASSES`` of 0, 1, 2, 3, 4, 5, 8, 9, 40
and 200 members, byte 0 and bytes >= 128 among them.

count_bytes_plain is held to exon_tpu.udfs.gc_content through the port's
gc_content (share mode, float32 bit for bit), to
exon_tpu.ops.sqlfuncs.fn_translate through the port's deletions, and in
count mode to a plain Python count. polya_tail_plain is held to
exon_tpu.udfs.trim_polya through the port's trim_polya, to fn_trim,
fn_ltrim and fn_rtrim through the port's (trim on the both mode), and its
both mode to its two one-end calls; the cube cover that picks the class
test is held to the class. exon_tpu's gc_content counts the class bytes
before offsets[0] into the first row and those past offsets[n] into the
last, and its trims take a byte outside the trim set before offsets[0] as
the first row's first kept byte (F40); its trim_polya, trims and
translate raise on a column of no rows: there the port is held to Python
and the JAX answer asserted. F14 still holds (tests/test_torch_udfs.py). Every
comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from exon_tpu import udfs as JU
from exon_tpu.batch import VarColumn as JVar
from exon_tpu.ops import sqlfuncs as JS
from exon_tpu_torch import udfs as TU
from exon_tpu_torch.batch import VarColumn
from exon_tpu_torch.kernels import count_bytes as kcb
from exon_tpu_torch.kernels import polya_tail as kpt
from exon_tpu_torch.ops import sqlfuncs as TS
from test_torch_kernels import BYTECLASS_CASES, BYTECLASSES, byteclass_case

GC = b"GCgc"
# the classes the JAX comparisons take: each class test and its edges
JAX_SIZES = (0, 1, 3, 4, 9, 200)


def _columns(offs, vals, rows):
    """The case as a port and a JAX VarColumn, every seventh row NULL."""
    valid = np.arange(len(rows)) % 7 != 3
    t = VarColumn(torch.from_numpy(vals), torch.from_numpy(offs),
                  torch.from_numpy(valid))
    j = JVar(jnp.asarray(vals), jnp.asarray(offs), jnp.asarray(valid))
    return t, j


def _row_bytes(col) -> list:
    offs = np.asarray(col.offsets).tolist()
    raw = np.asarray(col.values).tobytes()
    return [raw[a:b] for a, b in zip(offs[:-1], offs[1:])]


def _shares(counts, rows) -> np.ndarray:
    """IEEE float32 count / length, 0 for an empty row."""
    lens = np.array([len(r) for r in rows], np.float32)
    c = np.asarray(counts, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(lens > 0, c / lens, np.float32(0)).astype(np.float32)


def _count(rows, members: bytes) -> list:
    inside = set(members)
    return [sum(b in inside for b in r) for r in rows]


# ---------------------------------------------------------------------------
# count_bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", BYTECLASS_CASES)
def test_gc_content_matches_jax(name):
    offs, vals, rows = byteclass_case(name, GC)
    t, j = _columns(offs, vals, rows)
    got = TU.gc_content(None, t)
    assert got.dtype == torch.float32
    want = _shares(_count(rows, GC), rows)
    assert got.numpy().tobytes() == want.tobytes()
    jax_got = np.asarray(JU.gc_content(None, j)).astype(np.float32)
    if name == "neighbours":
        # F40: exon_tpu counts the bytes before offsets[0] into row 0 and
        # those past offsets[n] into row n - 1
        raw = vals.tobytes()
        leaky = _count(rows, GC)
        leaky[0] += _count([raw[:offs[0]]], GC)[0]
        leaky[-1] += _count([raw[offs[-1]:]], GC)[0]
        assert jax_got.tobytes() == _shares(leaky, rows).tobytes()
        assert jax_got[0] != want[0] and jax_got[-1] != want[-1]
    else:
        assert jax_got.tobytes() == want.tobytes()


@pytest.mark.parametrize("size", JAX_SIZES)
@pytest.mark.parametrize("name", BYTECLASS_CASES)
def test_translate_deletions_match_jax(name, size):
    """fn_translate mapping 'T' to 't' and deleting the class (the deleted
    bytes counted by count_bytes); a 'T' of the class is deleted too, as
    the JAX loop over ``frm`` has it."""
    members = BYTECLASSES[size]
    frm, to = b"T" + members, b"t"
    offs, vals, rows = byteclass_case(name, members)
    t, j = _columns(offs, vals, rows)
    got = _row_bytes(TS.fn_translate(None, t, frm, to))
    gone = set(frm[len(to):])
    want = [bytes(ord("t") if b == ord("T") else b for b in r
                  if b not in gone) for r in rows]
    assert got == want
    if name == "no_rows" and gone:
        with pytest.raises(TypeError):
            JS.fn_translate(None, j, frm, to)
        return
    assert _row_bytes(JS.fn_translate(None, j, frm, to)) == want


@pytest.mark.parametrize("size", sorted(BYTECLASSES))
@pytest.mark.parametrize("name", BYTECLASS_CASES)
def test_count_bytes_twin_counts_in_python(name, size):
    members = BYTECLASSES[size]
    offs, vals, rows = byteclass_case(name, members)
    o, v = torch.from_numpy(offs), torch.from_numpy(vals)
    want = _count(rows, members)
    got = kcb.count_bytes(o, v, members)
    assert got.dtype == torch.int32 and got.tolist() == want
    assert kcb.count_bytes(o, v, list(members)).tolist() == want
    share = kcb.count_bytes(o, v, members, share=True)
    assert share.numpy().tobytes() == _shares(want, rows).tobytes()


@pytest.mark.parametrize("size", sorted(BYTECLASSES))
def test_class_params_pick_the_test_by_cubes(size):
    """The cubes cover exactly the class; SWAR (K = 1, 2, 4 or 8, the first
    cube repeated) for up to 8 cubes, so for any class of up to 8 members;
    the mask for none or more, holding exactly the members."""
    members = BYTECLASSES[size]
    cover = kcb.cubes(sorted(set(members)))
    assert {b for b in range(256) if any(b & m == v for m, v in cover)} == \
        set(members)
    words, k = kcb.class_params(members)
    want_k = 0 if not members or len(cover) > 8 else \
        next(w for w in (1, 2, 4, 8) if w >= len(cover))
    assert k == want_k and (k == 0) == (size in (0, 40))
    mask = words[16:].astype(np.uint64)
    bits = [(int(mask[b >> 5]) >> (b & 31)) & 1 for b in range(256)]
    assert [b for b in range(256) if bits[b]] == sorted(set(members))
    if k:
        got = {(int(m) & 0xff, int(v) & 0xff)
               for m, v in zip(words[8:16], words[:8])}
        assert got == set(cover)
        assert all(int(w) == (int(w) & 0xff) * 0x01010101 for w in words[:16])
    assert kcb.class_params(members) is kcb.class_params(members)


def test_gc_class_is_one_cube():
    """{G, C, g, c} is the one cube b & 0xdb == 0x43."""
    assert kcb.cubes(sorted(set(GC))) == [(0xdb, 0x43)]


# ---------------------------------------------------------------------------
# polya_tail
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", BYTECLASS_CASES)
def test_trim_polya_matches_jax(name):
    offs, vals, rows = byteclass_case(name, kpt.POLY_A)
    t, j = _columns(offs, vals, rows)
    got = _row_bytes(TU.trim_polya(None, t))
    assert got == [r.rstrip(b"Aa") for r in rows]
    if name == "no_rows":
        with pytest.raises(TypeError):
            JU.trim_polya(None, j)
        return
    assert _row_bytes(JU.trim_polya(None, j)) == got


@pytest.mark.parametrize("fn", ["trim", "ltrim", "rtrim"])
@pytest.mark.parametrize("size", JAX_SIZES)
@pytest.mark.parametrize("name", BYTECLASS_CASES)
def test_trim_functions_match_jax(name, size, fn):
    members = BYTECLASSES[size]
    offs, vals, rows = byteclass_case(name, members)
    t, j = _columns(offs, vals, rows)
    got = _row_bytes(getattr(TS, f"fn_{fn}")(None, t, members))
    strip = {"trim": bytes.strip, "ltrim": bytes.lstrip,
             "rtrim": bytes.rstrip}[fn]
    assert got == [strip(r, members) for r in rows]
    if name == "no_rows":
        with pytest.raises(TypeError):
            getattr(JS, f"fn_{fn}")(None, j, members)
        return
    jax_rows = _row_bytes(getattr(JS, f"fn_{fn}")(None, j, members))
    if name == "neighbours" and not members and fn != "rtrim":
        # F40: with no class, the bytes before offsets[0] are not trim
        # bytes, and exon_tpu takes the first as row 0's first kept byte
        assert jax_rows[1:] == got[1:] and jax_rows[0] != got[0]
    else:
        assert jax_rows == got


@pytest.mark.parametrize("size", sorted(BYTECLASSES))
@pytest.mark.parametrize("name", BYTECLASS_CASES)
def test_polya_tail_both_mode_is_its_two_ends(name, size):
    members = BYTECLASSES[size]
    offs, vals, rows = byteclass_case(name, members)
    o, v = torch.from_numpy(offs), torch.from_numpy(vals)
    lead, keep = kpt.polya_tail(o, v, members, "both")
    assert torch.equal(lead, kpt.polya_tail(o, v, members, "start"))
    assert torch.equal(keep, kpt.polya_tail(o, v, members))
    assert lead.dtype == keep.dtype == torch.int32
    assert lead.tolist() == [len(r) - len(r.lstrip(members)) for r in rows]
    assert keep.tolist() == [len(r.rstrip(members)) for r in rows]


@pytest.mark.parametrize("fn", [kpt.polya_tail, kpt.polya_tail_plain])
def test_polya_tail_refuses_an_unknown_end(fn):
    o = torch.tensor([0, 2], dtype=torch.int32)
    v = torch.tensor(list(b"AA"), dtype=torch.uint8)
    with pytest.raises(ValueError):
        fn(o, v, b"A", "left")
