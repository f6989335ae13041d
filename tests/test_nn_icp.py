import numpy as np
import jax.numpy as jnp

from pointcloud_stitching_tpu import PointCloud
from pointcloud_stitching_tpu.ops import (icp, icp_converge, kabsch,
                                          nearest_neighbors, se3_apply)
from oracle import kabsch_np, nn_np, random_se3, transform_np


def test_nn_matches_oracle(rng):
    q = rng.normal(size=(777, 3)).astype(np.float32)
    r = rng.normal(size=(1531, 3)).astype(np.float32)
    idx, d2 = nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                                query_tile=256, ref_tile=512)
    ridx, rd2 = nn_np(q, r)
    # ties can differ in index; distances must match
    np.testing.assert_allclose(np.asarray(d2), rd2, atol=1e-4)
    agree = (np.asarray(idx) == ridx).mean()
    assert agree > 0.999


def test_nn_respects_ref_mask(rng):
    q = np.zeros((4, 3), np.float32)
    r = np.array([[0.01, 0, 0], [5, 5, 5]], np.float32)
    mask = np.array([False, True])
    idx, d2 = nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                                jnp.asarray(mask), query_tile=8, ref_tile=8)
    assert (np.asarray(idx) == 1).all()


def test_kabsch_recovers_exact_transform(rng):
    src = rng.normal(size=(200, 3)).astype(np.float32)
    T = random_se3(seed=5)
    dst = transform_np(T, src)
    got = np.asarray(kabsch(jnp.asarray(src), jnp.asarray(dst),
                            jnp.ones(200)))
    np.testing.assert_allclose(got, T, atol=1e-4)
    np.testing.assert_allclose(got, kabsch_np(src, dst), atol=1e-4)


def test_kabsch_weighted_ignores_outliers(rng):
    src = rng.normal(size=(100, 3)).astype(np.float32)
    T = random_se3(seed=6)
    dst = transform_np(T, src)
    dst[:10] += 100.0  # corrupted correspondences
    w = np.ones(100, np.float32)
    w[:10] = 0.0
    got = np.asarray(kabsch(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
    np.testing.assert_allclose(got, T, atol=1e-4)


def test_kabsch_degenerate_returns_identity():
    src = np.zeros((10, 3), np.float32)
    got = np.asarray(kabsch(jnp.asarray(src), jnp.asarray(src),
                            jnp.zeros(10)))
    np.testing.assert_allclose(got, np.eye(4), atol=1e-6)


def _make_icp_pair(rng, n=2000, noise=0.0, seed=7):
    src = rng.uniform(-1, 1, size=(n, 3)).astype(np.float32)
    T_true = random_se3(seed=seed, max_angle=0.15, max_trans=0.1)
    dst = transform_np(T_true, src)
    if noise:
        dst = dst + rng.normal(scale=noise, size=dst.shape).astype(np.float32)
    return src, dst, T_true


def test_icp_converges_to_truth(rng):
    src, dst, T_true = _make_icp_pair(rng)
    res = icp(PointCloud.from_points(src), PointCloud.from_points(dst),
              iterations=20, max_corr_dist=1.0,
              query_tile=512, ref_tile=512)
    np.testing.assert_allclose(np.asarray(res.T), T_true, atol=5e-3)
    assert float(res.mean_error) < 1e-4


def test_icp_converge_variant_stops_early(rng):
    src, dst, T_true = _make_icp_pair(rng, seed=8)
    # epsilon at PCL's default class (1e-8), not tighter: on an accelerator a genuine
    # correspondence near-tie can flip between iterations, leaving a
    # ~1e-10-scale wobble in dT that never settles below 1e-10 even though
    # the transform is fully converged (passes atol=5e-3 below either way)
    res = icp_converge(PointCloud.from_points(src), PointCloud.from_points(dst),
                       max_iterations=50, transformation_epsilon=1e-8,
                       max_corr_dist=1.0, query_tile=512, ref_tile=512)
    assert int(res.iterations) < 50
    np.testing.assert_allclose(np.asarray(res.T), T_true, atol=5e-3)


def test_icp_with_partial_overlap_and_masks(rng):
    src, dst, T_true = _make_icp_pair(rng, n=3000, seed=9)
    # drop a third of dst (simulates partial overlap), pad with mask
    dst_pc = PointCloud.from_points(dst[:2000], capacity=3072)
    src_pc = PointCloud.from_points(src, capacity=3072)
    res = icp(src_pc, dst_pc, iterations=25, max_corr_dist=0.5,
              query_tile=512, ref_tile=512)
    # transform should still be close (src pts matching dropped dst pts get
    # rejected by max_corr_dist once alignment is near)
    err = np.abs(np.asarray(res.T) - T_true).max()
    assert err < 0.05


def test_trimmed_icp_survives_gross_outliers(rng):
    """30% of the target replaced by garbage: plain ICP drifts, trimmed ICP
    recovers the transform (partial-overlap robustness)."""
    src = rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)
    T_true = random_se3(seed=11, max_angle=0.1, max_trans=0.08)
    dst = transform_np(T_true, src)
    dst[:600] = rng.uniform(-1, 1, (600, 3)) + np.array([5.0, 0, 0])
    plain = icp(PointCloud.from_points(src), PointCloud.from_points(dst),
                iterations=20, max_corr_dist=10.0,
                query_tile=512, ref_tile=512)
    trimmed = icp(PointCloud.from_points(src), PointCloud.from_points(dst),
                  iterations=20, max_corr_dist=10.0, trim_fraction=0.4,
                  query_tile=512, ref_tile=512)
    err_plain = np.abs(np.asarray(plain.T) - T_true).max()
    err_trim = np.abs(np.asarray(trimmed.T) - T_true).max()
    assert err_trim < 0.02, err_trim
    assert err_trim < err_plain


def test_trim_weights_acts_on_accepted_subset_only():
    """Regression: jnp.quantile returns NaN whenever any
    correspondence is rejected (masked / gated), which silently disabled
    trimming for every realistic padded-cloud config. nanquantile must trim
    the accepted subset regardless of how many entries are rejected."""
    from pointcloud_stitching_tpu.ops.icp import _trim_weights
    d2 = jnp.concatenate([jnp.linspace(0.0, 1.0, 100),
                          jnp.full((900,), jnp.inf)])
    w = jnp.concatenate([jnp.ones(100), jnp.zeros(900)])
    kept = int(jnp.sum(_trim_weights(w, d2, 0.3)))
    assert kept == 70, kept  # keep the best 70% of the 100 accepted
    # nothing accepted: must stay all-zero, not NaN-poisoned
    none = _trim_weights(jnp.zeros(1000), d2, 0.3)
    assert int(jnp.sum(none)) == 0
    assert not bool(jnp.any(jnp.isnan(none)))


def test_trimmed_icp_trims_with_padded_clouds(rng):
    """Trimming must engage when clouds are padded and the hard gate is
    finite (the padded entries are rejected -> NaNs in the quantile input)."""
    src = rng.uniform(-1, 1, size=(2000, 3)).astype(np.float32)
    dst = src + rng.normal(scale=0.01, size=src.shape).astype(np.float32)
    src_pc = PointCloud.from_points(src, capacity=4096)
    dst_pc = PointCloud.from_points(dst, capacity=4096)
    res = icp(src_pc, dst_pc, iterations=1, max_corr_dist=0.5,
              trim_fraction=0.25, query_tile=512, ref_tile=512)
    kept = int(res.num_inliers)
    # exactly the best 75% of the 2000 accepted matches (ties aside);
    # the pre-fix behaviour kept all 2000
    assert 1450 <= kept <= 1550, kept
