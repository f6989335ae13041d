"""Backend-equivalence fuzzing across random shapes, leaf sizes, masks and
color on/off: the voxel grid against the numpy oracle, and the Pallas NN
kernel (interpret mode) against the XLA sweep. Broad safety net for kernel
changes — any divergence is a bug in one of the implementations.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from pointcloud_stitching_tpu import PointCloud
from pointcloud_stitching_tpu.ops import nearest_neighbors, voxel_downsample
from oracle import voxel_downsample_np


@pytest.mark.parametrize("seed", range(6))
def test_voxel_backends_agree_fuzz(seed):
    rng = np.random.default_rng(1000 + seed)
    n = int(rng.integers(50, 4000))
    cap = int(rng.integers(16, 3000))
    leaf = float(rng.uniform(0.02, 0.7))
    scale = float(rng.uniform(0.5, 8.0))
    pts = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    mask = rng.random(n) > rng.uniform(0.0, 0.4)
    rgb = (rng.uniform(0, 255, (n, 3)).astype(np.float32)
           if rng.random() < 0.5 else None)
    pc = PointCloud(xyz=jnp.asarray(pts), mask=jnp.asarray(mask),
                    rgb=None if rgb is None else jnp.asarray(rgb))
    a = voxel_downsample(pc, leaf, capacity=cap)
    want_xyz, want_rgb = voxel_downsample_np(pts[mask], leaf,
                                             None if rgb is None
                                             else rgb[mask])
    k = min(cap, len(want_xyz))         # overflow drops the sorted tail
    m = np.asarray(a.mask)
    assert m.sum() == k and m[:k].all()
    np.testing.assert_allclose(np.asarray(a.xyz)[:k], want_xyz[:k],
                               atol=1e-4)
    if rgb is not None:
        np.testing.assert_allclose(np.asarray(a.rgb)[:k], want_rgb[:k],
                                   atol=1e-2)


@pytest.mark.parametrize("seed", range(6))
def test_nn_backends_agree_fuzz(seed):
    rng = np.random.default_rng(2000 + seed)
    nq = int(rng.integers(10, 700))
    nr = int(rng.integers(10, 900))
    q = rng.normal(size=(nq, 3)).astype(np.float32) * rng.uniform(0.5, 3)
    r = rng.normal(size=(nr, 3)).astype(np.float32) * rng.uniform(0.5, 3)
    mask = rng.random(nr) > rng.uniform(0.0, 0.5)
    if not mask.any():
        mask[0] = True
    ip, dp = nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                               jnp.asarray(mask), query_tile=128,
                               ref_tile=128, impl="pallas", interpret=True)
    ix, dx = nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                               jnp.asarray(mask), query_tile=128,
                               ref_tile=128, impl="xla")
    np.testing.assert_array_equal(np.asarray(ip), np.asarray(ix))
    np.testing.assert_allclose(np.asarray(dp), np.asarray(dx), atol=1e-4)


@pytest.mark.parametrize("seed", range(4))
def test_pruned_nn_exact_fuzz(seed):
    """Range-pruned NN must be exactly brute force on arbitrary inputs
    (even unsorted/incoherent ones, where pruning just degrades to a full
    sweep)."""
    from pointcloud_stitching_tpu.kernels.nn_pallas import (
        nearest_neighbors_pruned)
    rng = np.random.default_rng(3000 + seed)
    b = int(rng.integers(1, 3))
    nq = int(rng.integers(20, 400))
    nr = int(rng.integers(30, 700))
    sort_ref = rng.random() < 0.5
    q = rng.uniform(-4, 4, (b, nq, 3)).astype(np.float32)
    r = rng.uniform(-4, 4, (b, nr, 3)).astype(np.float32)
    if sort_ref:
        r = np.sort(r, axis=1)
    rmask = rng.random((b, nr)) > 0.2
    rmask[:, 0] = True
    qmask = rng.random((b, nq)) > 0.2
    ip, dp = nearest_neighbors_pruned(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(rmask),
        jnp.asarray(qmask), coarse_stride=int(rng.integers(2, 9)),
        query_tile=128, ref_block=128, interpret=True)
    for bb in range(b):
        ix, dx = nearest_neighbors(jnp.asarray(q[bb]), jnp.asarray(r[bb]),
                                   jnp.asarray(rmask[bb]), query_tile=128,
                                   ref_tile=128, impl="xla")
        sel = qmask[bb]
        np.testing.assert_array_equal(np.asarray(ip[bb])[sel],
                                      np.asarray(ix)[sel])
        np.testing.assert_allclose(np.asarray(dp[bb])[sel],
                                   np.asarray(dx)[sel], atol=1e-5)
