"""Pallas NN kernel (Triton route) vs the XLA sweep and the numpy oracle.

The CPU tests run the kernel in interpret mode; the ``gpu`` test compiles it
for the card."""
import numpy as np
import jax.numpy as jnp
import pytest

from pointcloud_stitching_tpu.kernels.nn_pallas import nearest_neighbors_pallas
from pointcloud_stitching_tpu.ops import nearest_neighbors
from oracle import nn_np


def test_pallas_nn_matches_oracle(rng):
    q = rng.normal(size=(300, 3)).astype(np.float32)
    r = rng.normal(size=(500, 3)).astype(np.float32)
    idx, d2 = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(r),
                                       query_tile=128, ref_block=128,
                                       interpret=True)
    ridx, rd2 = nn_np(q, r)
    np.testing.assert_array_equal(np.asarray(idx), ridx)
    np.testing.assert_allclose(np.asarray(d2), rd2, atol=1e-5)


def test_pallas_nn_ref_mask(rng):
    q = np.zeros((4, 3), np.float32)
    r = np.array([[0.01, 0, 0], [5, 5, 5]], np.float32)
    mask = np.array([False, True])
    idx, d2 = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(r),
                                       jnp.asarray(mask),
                                       query_tile=128, ref_block=128,
                                       interpret=True)
    assert (np.asarray(idx) == 1).all()
    np.testing.assert_allclose(np.asarray(d2), 75.0, rtol=1e-6)


def test_pallas_nn_tie_breaks_to_first(rng):
    q = np.zeros((1, 3), np.float32)
    r = np.array([[1, 0, 0], [0, 1, 0], [-1, 0, 0]], np.float32)  # all d2=1
    idx, d2 = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(r),
                                       query_tile=128, ref_block=128,
                                       interpret=True)
    assert int(idx[0]) == 0


def test_pallas_nn_multiblock_sweep(rng):
    # ref spans several blocks; best neighbour lives in a late block
    q = rng.normal(size=(150, 3)).astype(np.float32) + 10.0
    r = rng.normal(size=(700, 3)).astype(np.float32)
    r[600:] += 10.0  # matches live in block 4+ (block=128)
    idx, d2 = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(r),
                                       query_tile=128, ref_block=128,
                                       interpret=True)
    ridx, rd2 = nn_np(q, r)
    np.testing.assert_array_equal(np.asarray(idx), ridx)
    # coords offset by +10: the f32 differences carry ~1e-6 absolute
    # rounding at this magnitude
    np.testing.assert_allclose(np.asarray(d2), rd2, atol=1e-3)


def test_nn_impl_router(rng):
    q = rng.normal(size=(100, 3)).astype(np.float32)
    r = rng.normal(size=(200, 3)).astype(np.float32)
    i1, d1 = nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                               query_tile=128, ref_tile=128, impl="xla")
    i2, d2 = nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                               query_tile=128, ref_tile=128, impl="pallas",
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), atol=1e-5)


def test_pallas_nn_batched_interpret(rng):
    """Batched kernel (one grid row per pair) vs per-pair XLA."""
    from pointcloud_stitching_tpu.kernels.nn_pallas import (
        nearest_neighbors_pallas_batched)
    q = rng.normal(size=(3, 200, 3)).astype(np.float32)
    r = rng.normal(size=(3, 300, 3)).astype(np.float32)
    mask = rng.random((3, 300)) > 0.1
    idx, d2 = nearest_neighbors_pallas_batched(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
        query_tile=128, ref_block=128, interpret=True)
    for b in range(3):
        ri, rd = nearest_neighbors(jnp.asarray(q[b]), jnp.asarray(r[b]),
                                   jnp.asarray(mask[b]),
                                   query_tile=128, ref_tile=128, impl="xla")
        np.testing.assert_array_equal(np.asarray(idx[b]), np.asarray(ri))
        np.testing.assert_allclose(np.asarray(d2[b]), np.asarray(rd),
                                   atol=1e-5)


def test_pruned_nn_exactness(rng):
    """Range-pruned NN must equal the UNPRUNED pallas sweep bit for bit —
    that is the pruning contract (same direct-difference distances, just
    fewer blocks swept). The XLA path is only compared approximately: its
    |q|^2+|r|^2-2qr formulation is different f32 arithmetic, so a genuine
    near-tie can legitimately argmin to a different index."""
    from pointcloud_stitching_tpu.kernels.nn_pallas import (
        nearest_neighbors_pallas_batched, nearest_neighbors_pruned)
    # voxel-key-ordered ref (sorted by x) -> coherent blocks
    r = np.sort(rng.uniform(-3, 3, (2, 600, 3)).astype(np.float32), axis=1)
    q = rng.uniform(-3, 3, (2, 300, 3)).astype(np.float32)
    mask = rng.random((2, 600)) > 0.1
    ip, dp = nearest_neighbors_pruned(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
        coarse_stride=8, query_tile=128, ref_block=128, interpret=True)
    ib, db = nearest_neighbors_pallas_batched(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask),
        query_tile=128, ref_block=128, interpret=True)
    np.testing.assert_array_equal(np.asarray(ip), np.asarray(ib))
    np.testing.assert_array_equal(np.asarray(dp), np.asarray(db))
    for b in range(2):
        ix, dx = nearest_neighbors(jnp.asarray(q[b]), jnp.asarray(r[b]),
                                   jnp.asarray(mask[b]),
                                   query_tile=128, ref_tile=128, impl="xla")
        np.testing.assert_allclose(np.asarray(dp[b]), np.asarray(dx),
                                   atol=1e-5)


@pytest.mark.parametrize("query_tile,ref_block", [(16, 128), (32, 256),
                                                  (64, 512)])
def test_pallas_nn_tile_shapes(rng, query_tile, ref_block):
    """Every power-of-two tile pair gives the oracle's answer, including
    query counts and ref counts that are not tile multiples (padding)."""
    q = rng.normal(size=(173, 3)).astype(np.float32)
    r = rng.normal(size=(611, 3)).astype(np.float32)
    idx, d2 = nearest_neighbors_pallas(jnp.asarray(q), jnp.asarray(r),
                                       query_tile=query_tile,
                                       ref_block=ref_block, interpret=True)
    ridx, rd2 = nn_np(q, r)
    assert idx.shape == (173,) and d2.shape == (173,)
    np.testing.assert_array_equal(np.asarray(idx), ridx)
    np.testing.assert_allclose(np.asarray(d2), rd2, atol=1e-5)


@pytest.mark.gpu
def test_pallas_nn_compiled_matches_xla(rng):
    """The kernel as compiled for the card, at the ring-ICP shape."""
    from pointcloud_stitching_tpu.kernels.nn_pallas import (
        nearest_neighbors_pallas_batched)
    from pointcloud_stitching_tpu.ops.icp import _nn_batched_xla
    q = rng.uniform(-3, 3, (8, 2048, 3)).astype(np.float32)
    r = rng.uniform(-3, 3, (8, 2048, 3)).astype(np.float32)
    mask = rng.random((8, 2048)) > 0.1
    ik, dk = nearest_neighbors_pallas_batched(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(mask))
    ix, dx = _nn_batched_xla(jnp.asarray(q), jnp.asarray(r),
                             jnp.asarray(mask), 1024, 4096)
    np.testing.assert_allclose(np.asarray(dk), np.asarray(dx), atol=2e-5)
    assert (np.asarray(ik) == np.asarray(ix)).mean() > 0.999
