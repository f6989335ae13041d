"""Adaptive output-grid resolution (cfg.out_leaf_autofit).

A fixed-capacity voxel grid is the fixed-shape replacement for PCL's
dynamically sized VoxelGrid output; when a scene outgrows it, the sorted
tail of voxels drops (spatially biased). The autofit controller instead
trades resolution for coverage: the output leaf is a *traced* operand of
the stitch step, grown on saturation and shrunk back toward the configured
floor when the scene fits — with zero recompiles (asserted here).
"""
import jax
import jax.numpy as jnp
import numpy as np

from pointcloud_stitching_tpu import Intrinsics
from pointcloud_stitching_tpu.models import StitchingPipeline, autofit_out_leaf
from pointcloud_stitching_tpu.utils.config import StitchConfig
from oracle import synth_depth_frame


def _ctrl(pts, leaf, **kw):
    base = dict(capacity=1000, floor=0.01, ceil=0.08)
    base.update(kw)
    return float(autofit_out_leaf(jnp.int32(pts), jnp.float32(leaf), **base))


def test_controller_grows_on_saturation():
    assert np.isclose(_ctrl(1000, 0.01), 0.0125, rtol=1e-6)
    # clamped at the ceiling
    assert np.isclose(_ctrl(1000, 0.08), 0.08, rtol=1e-6)


def test_controller_holds_in_deadband():
    # unsaturated but too full to shrink safely (cubic guard):
    # 600 * 1.25^3 = 1171 > 0.85 * 1000
    assert _ctrl(600, 0.02) == np.float32(0.02)


def test_controller_shrinks_with_headroom():
    # 300 * 1.25^3 = 586 < 850: a finer grid fits with margin
    assert np.isclose(_ctrl(300, 0.02), 0.02 / 1.25, rtol=1e-6)
    # and never below the floor
    assert np.isclose(_ctrl(10, 0.01), 0.01, rtol=1e-6)


def test_controller_does_not_oscillate():
    """From any state, grow->shrink->grow loops must not occur: simulate a
    static volumetric scene (occupancy ~ leaf^-3, the controller's worst
    case) and assert the leaf trajectory becomes constant."""
    occ_at = lambda leaf: int(5000 * (0.01 / leaf) ** 3)
    cap = 1000
    leaf = 0.01
    seen = []
    for _ in range(25):
        pts = min(occ_at(leaf), cap)
        leaf = _ctrl(pts, leaf, capacity=cap)
        seen.append(leaf)
    assert len(set(np.round(seen[-6:], 9))) == 1, seen
    assert occ_at(seen[-1]) < cap  # settled on a fitting resolution


def _rig(ncam=2, h=120, w=212, **cfg_kw):
    base = dict(num_cameras=ncam, height=h, width=w,
                icp_enabled=False, out_voxel_leaf=0.004,
                out_capacity=4096, out_leaf_autofit=True,
                out_leaf_max=0.1)
    base.update(cfg_kw)
    cfg = StitchConfig(**base)
    i0 = Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                           width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1)) if ncam > 1 else i0.stack([])
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    ext[1:, 0, 3] = 0.15
    depths = np.stack([synth_depth_frame(h, w, seed=s) for s in range(ncam)])
    return cfg, intr, jnp.asarray(ext), jnp.asarray(depths)


def test_pipeline_autofits_to_capacity():
    """A scene occupying >> capacity at the floor leaf converges to an
    unsaturated grid within a few frames, without recompiling."""
    cfg, intr, ext, depths = _rig()
    pipe = StitchingPipeline(cfg, intr, ext)
    out = pipe(depths)
    assert int(out.metrics.points_out) == cfg.out_capacity  # saturated start
    n_compiles_before = pipe._step._cache_size()
    for _ in range(25):
        out = pipe(depths)
    assert pipe._step._cache_size() == n_compiles_before  # leaf is traced
    assert int(out.metrics.points_out) < cfg.out_capacity
    assert float(pipe.out_leaf) > cfg.out_voxel_leaf


def test_pipeline_recovers_fine_resolution():
    """When the scene shrinks (crop-like sparse frame), the leaf walks back
    down toward the configured floor."""
    cfg, intr, ext, depths = _rig()
    pipe = StitchingPipeline(cfg, intr, ext)
    for _ in range(25):
        pipe(depths)
    coarse = float(pipe.out_leaf)
    assert coarse > cfg.out_voxel_leaf
    sparse = np.asarray(depths).copy()
    sparse[:, 2:] = 0  # a few hundred points: fits at any leaf
    sparse = jnp.asarray(sparse)
    for _ in range(30):
        out = pipe(sparse)
    assert float(pipe.out_leaf) == np.float32(cfg.out_voxel_leaf)
    assert 0 < int(out.metrics.points_out) < cfg.out_capacity


def test_out_leaf_override_matches_cfg_leaf():
    """stitch_step(out_leaf=x) == stitch_step with cfg.out_voxel_leaf=x."""
    import dataclasses
    from pointcloud_stitching_tpu.models import stitch_step
    cfg, intr, ext, depths = _rig(out_leaf_autofit=False)
    a = stitch_step(cfg, intr, ext, depths, out_leaf=jnp.float32(0.02))
    b = stitch_step(dataclasses.replace(cfg, out_voxel_leaf=0.02),
                    intr, ext, depths)
    assert int(a.metrics.points_out) == int(b.metrics.points_out)
    ga = np.asarray(a.cloud.xyz)[np.asarray(a.cloud.mask)]
    gb = np.asarray(b.cloud.xyz)[np.asarray(b.cloud.mask)]
    np.testing.assert_allclose(np.sort(ga, axis=0), np.sort(gb, axis=0),
                               atol=1e-6)


def test_sharded_out_leaf_override_matches_single_device():
    """The GSPMD path accepts the traced leaf too (autofit over a mesh)."""
    import dataclasses
    from pointcloud_stitching_tpu.models import stitch_step
    from pointcloud_stitching_tpu.parallel import (make_mesh,
                                                   make_sharded_stitch)
    cfg, intr, ext, depths = _rig(ncam=2, out_leaf_autofit=False)
    fn = make_sharded_stitch(cfg, make_mesh(2))
    a = fn(intr, ext, depths, out_leaf=jnp.float32(0.02))
    b = stitch_step(dataclasses.replace(cfg, kernel_impl="xla",
                                        out_voxel_leaf=0.02),
                    intr, ext, depths)
    assert int(a.metrics.points_out) == int(b.metrics.points_out)
    ga = np.asarray(a.cloud.xyz)[np.asarray(a.cloud.mask)]
    gb = np.asarray(b.cloud.xyz)[np.asarray(b.cloud.mask)]
    np.testing.assert_allclose(np.sort(ga, axis=0), np.sort(gb, axis=0),
                               atol=1e-6)


def test_autofit_config_validation():
    import pytest
    with pytest.raises(ValueError):
        StitchConfig(out_leaf_autofit=True, out_voxel_leaf=0.05,
                     out_leaf_max=0.01)
