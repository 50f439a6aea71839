"""The hash-partition shuffle of exon_tpu_torch (parallel/shuffle.py, the
bucket_pack twin) held to exon_tpu/parallel/shuffle.py on JAX CPU.

``partition_ids`` and ``bucketize`` are compared bit for bit with the JAX
functions on seeded numpy inputs: negative, large and boundary keys
(INT64_MIN, INT64_MAX, ±2^32), masks, buckets that overflow, columns of 1,
4 and 8-byte elements and [n, 64] byte rows, each row's rank within its
destination against a stable numpy sort. On 8 in-process CPU shards, as
tests/test_parallel_shuffle.py runs on 8 virtual CPU devices: every key
reaches one owner, distributed_group_count/_sum against numpy's bincount
(counts exact, float32 sums at relative 1e-5 as there: the owners add in
another order), and a hot key that overflows small buckets sets the flag
where a lossless bucket stays exact. On a card the same comparisons run
kernel against twin in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exon_tpu.parallel import shuffle as JS
from exon_tpu_torch.kernels import bucket_pack as kb
from exon_tpu_torch.parallel import shuffle as TS
from exon_tpu_torch.parallel.mesh import make_mesh

N_SHARDS = 8
I64 = np.iinfo(np.int64)


def _keys(rng, n):
    edge = np.asarray([0, -1, 1, I64.min, I64.max, 2**32, -2**32, 2**32 - 1,
                       2**31, -2**31, 123456789012345], np.int64)
    return np.concatenate([edge, rng.integers(I64.min, I64.max, n,
                                              dtype=np.int64)])


@pytest.mark.parametrize("n_parts", [1, 3, 8, 1000])
def test_partition_ids_match_jax(n_parts):
    keys = _keys(np.random.default_rng(n_parts), 5000)
    want = np.asarray(JS.partition_ids(jnp.asarray(keys), n_parts))
    got = TS.partition_ids(torch.from_numpy(keys), n_parts).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def _columns(rng, n):
    """One column of every width the kernel takes, as numpy arrays."""
    return [rng.random(n) < 0.5,
            rng.integers(0, 256, n).astype(np.uint8),
            rng.integers(-2**31, 2**31, n).astype(np.int32),
            rng.integers(I64.min, I64.max, n, dtype=np.int64),
            rng.standard_normal(n),
            rng.integers(0, 256, (n, 64)).astype(np.uint8),
            rng.integers(-9, 9, (n, 3)).astype(np.int64)]


@pytest.mark.parametrize("n,n_parts,bucket_cap,masked", [
    (300, 4, 200, True),       # lossless
    (300, 4, 40, True),        # every bucket overflows
    (1000, 8, 128, False),     # some overflow, no mask
    (0, 3, 5, True),           # no rows
    (517, 1, 600, True),       # one destination
])
def test_bucketize_matches_jax(n, n_parts, bucket_cap, masked):
    rng = np.random.default_rng(n + n_parts)
    dest = rng.integers(0, n_parts, n).astype(np.int32)
    mask = rng.random(n) < 0.8 if masked else np.ones(n, bool)
    cols = _columns(rng, n)
    jcols, jcounts = JS.bucketize(jnp.asarray(dest), jnp.asarray(mask),
                                  [jnp.asarray(c) for c in cols], n_parts,
                                  bucket_cap)
    tcols, tcounts = TS.bucketize(torch.from_numpy(dest),
                                  torch.from_numpy(mask),
                                  [torch.from_numpy(c) for c in cols],
                                  n_parts, bucket_cap)
    np.testing.assert_array_equal(tcounts.numpy(), np.asarray(jcounts))
    assert tcounts.dtype == torch.int32
    for j, t in zip(jcols, tcols):
        j = np.asarray(j)
        assert t.numpy().dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t.numpy().view(np.uint8),
                                      j.view(np.uint8))


def test_bucket_pack_ranks_and_hashed_destinations():
    rng = np.random.default_rng(3)
    keys = _keys(rng, 2000)
    mask = rng.random(keys.shape[0]) < 0.7
    n_parts, cap = 8, 150
    out, counts, dest, rank = kb.bucket_pack(
        torch.from_numpy(keys), torch.from_numpy(mask),
        [torch.from_numpy(keys)], n_parts, cap)
    want_dest = np.where(mask, np.asarray(JS.partition_ids(
        jnp.asarray(keys), n_parts)), n_parts)
    np.testing.assert_array_equal(dest.numpy(), want_dest)
    want_rank = np.full(keys.shape[0], -1)
    for d in range(n_parts):
        rows = np.flatnonzero(want_dest == d)
        want_rank[rows] = np.arange(rows.shape[0])
    np.testing.assert_array_equal(rank.numpy(), want_rank)
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(want_dest, minlength=n_parts + 1)[:-1])
    # the same as partition_ids + bucketize of JAX, keys as the column
    jcols, _ = JS.bucketize(JS.partition_ids(jnp.asarray(keys), n_parts),
                            jnp.asarray(mask), [jnp.asarray(keys)], n_parts,
                            cap)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(jcols[0]))
    assert kb.launches == 0  # the twin ran: the tensors lie on the CPU


@pytest.fixture(scope="module")
def mesh():
    m = make_mesh(N_SHARDS, "cpu")
    assert m.n_shards == N_SHARDS and m.n_local == N_SHARDS
    assert all(d == torch.device("cpu") for d in m.devices)
    return m


def _split(x, n=N_SHARDS):
    return [torch.from_numpy(p) for p in np.array_split(x, n)]


def test_make_mesh_shards():
    assert make_mesh(None, "cpu").n_shards == 1
    m = make_mesh(3, "cpu")
    assert (m.n_shards, m.first_shard, m.n_processes) == (3, 0, 1)


def test_shuffle_routes_every_key_to_one_owner(mesh):
    rows_per_shard = 128
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 50, rows_per_shard * N_SHARDS).astype(np.int64)
    recv, overflow = TS.hash_partition_shuffle(
        mesh, _split(keys), [torch.ones(rows_per_shard, dtype=torch.bool)] *
        N_SHARDS, [[] for _ in range(N_SHARDS)],
        rows_per_shard * N_SHARDS)
    assert not overflow
    assert sum(k.shape[0] for k, _ in recv) == keys.shape[0]
    for owner, (k, _) in enumerate(recv):
        assert (TS.partition_ids(k, N_SHARDS) == owner).all()
    got = np.sort(np.concatenate([k.numpy() for k, _ in recv]))
    np.testing.assert_array_equal(got, np.sort(keys))


def test_distributed_group_count_and_sum_parity(mesh):
    rows_per_shard = 256
    total = rows_per_shard * N_SHARDS
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 16, total).astype(np.int32)
    values = rng.random(total).astype(np.float32)
    live = rng.random(total) < 0.7
    counts = TS.distributed_group_count(mesh, _split(codes), _split(live),
                                        16, rows_per_shard)
    sums = TS.distributed_group_sum(mesh, _split(codes), _split(values),
                                    _split(live), 16, rows_per_shard)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(codes[live], minlength=16))
    np.testing.assert_allclose(sums.numpy(), np.bincount(
        codes[live], weights=values[live], minlength=16), rtol=1e-5)


def test_overflow_detected_on_hot_key_skew(mesh):
    rows_per_shard = 256
    total = rows_per_shard * N_SHARDS
    rng = np.random.default_rng(9)
    codes = np.where(rng.random(total) < 0.9, 3,
                     rng.integers(0, 16, total)).astype(np.int64)
    ones = [torch.ones(rows_per_shard, dtype=torch.bool)] * N_SHARDS
    _, overflow = TS.hash_partition_shuffle(
        mesh, _split(codes), ones, [[] for _ in range(N_SHARDS)], 64)
    assert overflow, "a bucket past its capacity must be flagged"
    counts = TS.distributed_group_count(mesh, _split(codes), ones, 16,
                                        rows_per_shard)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(codes, minlength=16))
