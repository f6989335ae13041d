import numpy as np
import jax.numpy as jnp

from pointcloud_stitching_tpu import Intrinsics, PointCloud
from pointcloud_stitching_tpu.models import (StitchingPipeline, register_pair,
                                             stitch_step)
from pointcloud_stitching_tpu.utils.config import StitchConfig
from oracle import random_se3, synth_depth_frame, transform_np


INTR = dict(fx=421.5, fy=421.1, ppx=423.2, ppy=238.9)


def _small_cfg(ncam, **kw):
    base = dict(num_cameras=ncam, height=120, width=212,
                cam_voxel_leaf=0.02, cam_capacity=32768,
                out_voxel_leaf=0.02, out_capacity=65536,
                icp_voxel_leaf=0.04, icp_capacity=4096,
                icp_iterations=3, icp_max_corr_dist=0.3,
                icp_query_tile=256, icp_ref_tile=512)
    base.update(kw)
    return StitchConfig(**base)


def _scene(ncam, h=120, w=212):
    depths = np.stack([synth_depth_frame(h, w, seed=s) for s in range(ncam)])
    intr = Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                             width=w, height=h)
    intr_b = intr.stack([intr] * (ncam - 1))
    ext = np.stack([random_se3(seed=10 + i, max_angle=0.1, max_trans=0.2)
                    for i in range(ncam)]).astype(np.float32)
    return depths, intr_b, ext


def test_stitch_step_shapes_and_masks():
    ncam = 3
    cfg = _small_cfg(ncam, icp_enabled=False)
    depths, intr, ext = _scene(ncam)
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    assert out.cloud.xyz.shape == (cfg.out_capacity, 3)
    assert int(out.metrics.points_out) > 100
    assert int(out.metrics.points_in) > 1000
    np.testing.assert_allclose(np.asarray(out.extrinsics), ext)


def test_stitch_matches_manual_composition():
    """Pipeline (no ICP) == deproject+transform+voxel composed by hand."""
    from pointcloud_stitching_tpu.ops import (deproject, fuse,
                                              transform_cloud,
                                              voxel_downsample)
    ncam = 2
    cfg = _small_cfg(ncam, icp_enabled=False,
                     cam_voxel_leaf=1e-6, cam_capacity=120 * 212)
    depths, intr, ext = _scene(ncam)
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))

    # manual: per-cam deproject -> world -> fuse -> voxel
    clouds = []
    for i in range(ncam):
        intr_i = Intrinsics.create(fx=106.0, fy=106.0, ppx=106.0, ppy=60.0,
                                   width=212, height=120)
        pc = deproject(depths[i], intr_i, z_min=cfg.z_min, z_max=cfg.z_max)
        clouds.append(transform_cloud(jnp.asarray(ext[i]), pc))
    fused = fuse(clouds)
    ref = voxel_downsample(fused, cfg.out_voxel_leaf, capacity=cfg.out_capacity)

    got = np.asarray(out.cloud.xyz)[np.asarray(out.cloud.mask)]
    want = np.asarray(ref.xyz)[np.asarray(ref.mask)]
    assert got.shape == want.shape
    # cam_voxel pre-pass with tiny leaf is an identity-ish pass; the fused
    # voxel grid sees per-camera centroids == original points
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(want, axis=0),
                               atol=1e-3)


def test_stitch_step_crop_box():
    """cfg.crop_lo/hi bound the fused world cloud (pcl::CropBox role)
    before the output voxel pass; the config stays jit-hashable through a
    JSON round-trip (tuples come back as lists)."""
    ncam = 2
    depths, intr, ext = _scene(ncam)
    cfg_full = _small_cfg(ncam, icp_enabled=False)
    full = stitch_step(cfg_full, intr, jnp.asarray(ext), jnp.asarray(depths))
    fx = np.asarray(full.cloud.xyz)[np.asarray(full.cloud.mask)]
    mid = np.median(fx, axis=0)
    lo = tuple(float(v) for v in (fx.min(axis=0) - 1e-3))
    hi = tuple(float(v) for v in mid)  # keep roughly the lower half
    cfg = StitchConfig.from_json(
        _small_cfg(ncam, icp_enabled=False, crop_lo=lo, crop_hi=hi)
        .to_json())
    assert isinstance(cfg.crop_lo, tuple)  # hashable again after JSON
    hash(cfg)
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    ox = np.asarray(out.cloud.xyz)[np.asarray(out.cloud.mask)]
    assert len(ox) > 0
    # every surviving voxel centroid sits inside the box (+ leaf slack:
    # centroids of boundary voxels can average just past the corner)
    slack = cfg.out_voxel_leaf
    assert (ox >= np.asarray(lo) - slack).all()
    assert (ox <= np.asarray(hi) + slack).all()
    # and the crop really removed the upper half
    assert len(ox) < 0.8 * len(fx)


def test_stitch_step_mapped_color():
    """Non-aligned color streams through the full step: color attaches via
    texture mapping with separate color intrinsics + depth->color extrinsics
    (rs2 map_to semantics), geometry identical to the colorless step."""
    ncam = 2
    cfg = _small_cfg(ncam, icp_enabled=False)
    depths, intr, ext = _scene(ncam)
    hc, wc = 90, 160
    rng = np.random.default_rng(3)
    colors = rng.integers(40, 256, (ncam, hc, wc, 3)).astype(np.uint8)
    ci = Intrinsics.create(fx=80.0, fy=80.0, ppx=wc / 2, ppy=hc / 2,
                           width=wc, height=hc)
    cintr = ci.stack([ci] * (ncam - 1))
    c_ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    c_ext[:, 0, 3] = 0.015

    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths),
                      colors=jnp.asarray(colors), color_intr=cintr,
                      color_ext=jnp.asarray(c_ext))
    assert out.cloud.rgb is not None
    m = np.asarray(out.cloud.mask)
    rgb = np.asarray(out.cloud.rgb)[m]
    assert (rgb > 0).any()              # in-FOV points picked up texture
    # geometry must match the colorless step exactly
    out0 = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    a = np.sort(np.asarray(out.cloud.xyz)[m], axis=0)
    b = np.sort(np.asarray(out0.cloud.xyz)[np.asarray(out0.cloud.mask)],
                axis=0)
    # rgb clouds take the exact sort; colorless takes the packed sort whose
    # reconstruction quantises at leaf/2048 (= 9.8e-6 at this 0.02 leaf)
    np.testing.assert_allclose(a, b, atol=1.5e-5)


def test_stitch_cam_mask_drops_camera():
    ncam = 3
    cfg = _small_cfg(ncam, icp_enabled=False)
    depths, intr, ext = _scene(ncam)
    full = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    dropped = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths),
                          cam_mask=jnp.asarray([True, False, True]))
    assert int(dropped.metrics.points_in) < int(full.metrics.points_in)

    # dropping cam1 == stitching only cams 0,2
    cfg2 = _small_cfg(2, icp_enabled=False)
    intr2 = Intrinsics.create(fx=106.0, fy=106.0, ppx=106.0, ppy=60.0,
                              width=212, height=120)
    intr2 = intr2.stack([intr2])
    two = stitch_step(cfg2, intr2, jnp.asarray(ext[[0, 2]]),
                      jnp.asarray(depths[[0, 2]]))
    a = np.asarray(dropped.cloud.xyz)[np.asarray(dropped.cloud.mask)]
    b = np.asarray(two.cloud.xyz)[np.asarray(two.cloud.mask)]
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-5)


def test_icp_drift_correction_improves_alignment():
    """Two views of the same wavy surface, one extrinsic perturbed: the
    pipeline's ring ICP should pull the fused clouds back together."""
    h, w = 120, 212
    depth = synth_depth_frame(h, w, seed=42)
    depths = np.stack([depth, depth])  # same sensor view
    intr = Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                             width=w, height=h)
    intr_b = intr.stack([intr])
    # truth: both cameras identical pose => identical world clouds.
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = [0.04, -0.03, 0.02]
    ext = np.stack([np.eye(4, dtype=np.float32), drift])

    cfg = _small_cfg(2, icp_enabled=True, icp_iterations=8)
    out = stitch_step(cfg, intr_b, jnp.asarray(ext), jnp.asarray(depths))
    refined = np.asarray(out.extrinsics)
    # camera 0 anchored
    np.testing.assert_allclose(refined[0], np.eye(4), atol=1e-6)
    # camera 1's refined extrinsic should approach identity (true pose)
    err_before = np.abs(ext[1] - np.eye(4)).max()
    err_after = np.abs(refined[1] - np.eye(4)).max()
    assert err_after < err_before * 0.5, (err_before, err_after)


def test_pipeline_wrapper_carries_extrinsics():
    ncam = 2
    h, w = 120, 212
    depth = synth_depth_frame(h, w, seed=7)
    depths = np.stack([depth, depth])
    intr = Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                             width=w, height=h).stack(
        [Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                           width=w, height=h)])
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = [0.03, 0.0, -0.02]
    ext = np.stack([np.eye(4, dtype=np.float32), drift])
    cfg = _small_cfg(2, icp_enabled=True, icp_iterations=4)
    pipe = StitchingPipeline(cfg, intr, ext, update_mode="track")
    e0 = np.abs(np.asarray(pipe.extrinsics)[1] - np.eye(4)).max()
    for _ in range(3):
        pipe(jnp.asarray(depths))
    e1 = np.abs(np.asarray(pipe.extrinsics)[1] - np.eye(4)).max()
    assert e1 < e0  # tracked extrinsics improve across frames

    # anchored (default) mode: base extrinsics are frozen; the per-frame
    # OUTPUT is refined but ICP noise cannot accumulate into the state
    pipe_a = StitchingPipeline(cfg, intr, ext)
    out = None
    for _ in range(3):
        out = pipe_a(jnp.asarray(depths))
    np.testing.assert_allclose(np.asarray(pipe_a.extrinsics), ext)
    e_ref = np.abs(np.asarray(out.extrinsics)[1] - np.eye(4)).max()
    assert e_ref < e0  # refined output still corrects the drift


def test_register_pair_with_picked_points(rng):
    pts = rng.uniform(-1, 1, (1500, 3)).astype(np.float32)
    T_true = random_se3(seed=3, max_angle=0.6, max_trans=0.6)
    dst = transform_np(T_true, pts)
    src_pc = PointCloud.from_points(pts)
    dst_pc = PointCloud.from_points(dst)
    picks = [3, 100, 777, 1234]
    res = register_pair(src_pc, dst_pc, src_idx=picks, dst_idx=picks,
                        refine=True, query_tile=512, ref_tile=512)
    np.testing.assert_allclose(np.asarray(res.initial_T), T_true, atol=1e-3)
    np.testing.assert_allclose(np.asarray(res.T), T_true, atol=1e-3)


def test_register_pair_writes_cal(tmp_path, rng):
    from pointcloud_stitching_tpu.io import load_cal
    from pointcloud_stitching_tpu.models import write_cal
    pts = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
    T_true = random_se3(seed=4, max_angle=0.2, max_trans=0.2)
    res = register_pair(PointCloud.from_points(pts),
                        PointCloud.from_points(transform_np(T_true, pts)),
                        refine=True, max_corr_dist=1.0,
                        query_tile=512, ref_tile=512)
    p = tmp_path / "pair.cal"
    write_cal(str(p), res)
    np.testing.assert_allclose(load_cal(str(p)), np.asarray(res.T), atol=1e-6)


def test_config_validation():
    import pytest
    with pytest.raises(ValueError):
        StitchConfig(icp_variant="nope")
    with pytest.raises(ValueError):
        StitchConfig(kernel_impl="cuda")
    with pytest.raises(ValueError):
        StitchConfig(icp_trim_fraction=1.5)
    with pytest.raises(ValueError):
        StitchConfig(num_cameras=0)


def test_decimation_preserves_geometry():
    """decimation=2 must produce exactly the points of the full-resolution
    deprojection at the strided pixels (intrinsics rescale with the grid)."""
    from pointcloud_stitching_tpu.ops import deproject
    ncam, h, w = 2, 120, 212
    depths, intr, ext = _scene(ncam)
    cfg = _small_cfg(ncam, icp_enabled=False, decimation=2)
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))

    # reference: full-res deproject, take strided pixels, transform+voxel
    from pointcloud_stitching_tpu.ops import fuse, transform_cloud, \
        voxel_downsample
    clouds = []
    for i in range(ncam):
        i0 = Intrinsics.create(fx=106.0, fy=106.0, ppx=106.0, ppy=60.0,
                               width=w, height=h)
        pc = deproject(depths[i], i0, z_min=cfg.z_min, z_max=cfg.z_max)
        grid = pc.xyz.reshape(h, w, 3)[::2, ::2].reshape(-1, 3)
        gmask = pc.mask.reshape(h, w)[::2, ::2].reshape(-1)
        from pointcloud_stitching_tpu import PointCloud as PC
        clouds.append(transform_cloud(jnp.asarray(ext[i]),
                                      PC(xyz=grid, mask=gmask)))
    ref = voxel_downsample(fuse(clouds), cfg.out_voxel_leaf,
                           capacity=cfg.out_capacity)
    got = np.asarray(out.cloud.xyz)[np.asarray(out.cloud.mask)]
    want = np.asarray(ref.xyz)[np.asarray(ref.mask)]
    assert got.shape == want.shape
    np.testing.assert_allclose(np.sort(got, axis=0), np.sort(want, axis=0),
                               atol=1e-4)


def test_se3_power_endpoints_and_midpoint():
    from pointcloud_stitching_tpu.ops.se3 import se3_power
    T = random_se3(seed=21, max_angle=0.2, max_trans=0.3)
    np.testing.assert_allclose(np.asarray(se3_power(jnp.asarray(T), 0.0)),
                               np.eye(4), atol=1e-7)
    np.testing.assert_allclose(np.asarray(se3_power(jnp.asarray(T), 1.0)),
                               T, atol=1e-6)
    # half-powers compose back for a pure rotation (the pseudo-exp is exact
    # on SO(3); translation is linear so it recombines exactly too there)
    R = T.copy()
    R[:3, 3] = 0.0
    half = np.asarray(se3_power(jnp.asarray(R), 0.5))
    np.testing.assert_allclose(half @ half, R, atol=1e-6)
    # batched alphas broadcast
    out = np.asarray(se3_power(jnp.asarray(T), jnp.asarray([0.0, 1.0])))
    np.testing.assert_allclose(out[0], np.eye(4), atol=1e-7)
    np.testing.assert_allclose(out[1], T, atol=1e-6)


def _ring_scene(ncam, h=120, w=212, depth_noise_mm=6.0, seed=0):
    """Co-located cameras viewing one scene, each with its own depth noise:
    every camera pair overlaps (including the closing pair), and per-pair
    ICP carries a small independent error -> chain drift accumulates."""
    rng = np.random.default_rng(seed)
    base = synth_depth_frame(h, w, seed=99).astype(np.float32)
    depths = []
    for _ in range(ncam):
        noisy = base + rng.normal(scale=depth_noise_mm, size=base.shape)
        noisy[base == 0] = 0
        depths.append(np.clip(noisy, 0, 4000).astype(np.uint16))
    intr = Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                             width=w, height=h)
    intr_b = intr.stack([intr] * (ncam - 1))
    # truth: every camera at identity; injected drift on all but the anchor
    ext = np.stack([np.eye(4, dtype=np.float32)] * ncam)
    for i in range(1, ncam):
        d = random_se3(seed=30 + i, max_angle=0.02, max_trans=0.03)
        ext[i] = d
    return np.stack(depths), intr_b, ext


def test_compose_ring_corrections_reduces_chain_end_error():
    """The closure math, isolated from ICP: with iid per-pair measurement
    noise, the open chain's end-camera error compounds (~sqrt(n) sigma)
    while closure distributes the loop residual and keeps it ~sigma
. Averaged over many draws so the comparison is a
    property, not a coin flip."""
    from pointcloud_stitching_tpu.models.stitcher import (
        _compose_ring_corrections)
    ncam, trials = 8, 30
    errs_chain, errs_ring = [], []
    for t in range(trials):
        # measured deltas = identity truth x small random noise; delta[0]
        # is the closing-pair measurement
        deltas = np.stack([random_se3(seed=1000 + t * ncam + i,
                                      max_angle=0.01, max_trans=0.01)
                           for i in range(ncam)])
        d = jnp.asarray(deltas)
        chain, le0 = _compose_ring_corrections(d, False)
        ring, le1 = _compose_ring_corrections(d, True)
        # truth: every correction should be identity
        errs_chain.append(np.abs(np.asarray(chain)[-1] - np.eye(4)).max())
        errs_ring.append(np.abs(np.asarray(ring)[-1] - np.eye(4)).max())
        assert float(le0) == 0.0
        assert float(le1) > 0.0
        # camera 0 exactly anchored in both modes
        np.testing.assert_allclose(np.asarray(ring)[0], np.eye(4), atol=1e-6)
    mean_c = float(np.mean(errs_chain))
    mean_r = float(np.mean(errs_ring))
    # sqrt(7) ~ 2.6x compounding removed; allow generous margin
    assert mean_r < 0.7 * mean_c, (mean_r, mean_c)


def test_ring_closure_bounds_chain_end_drift():
    """Drift injected on every camera of a 6-ring through the full pipeline:
    with closure the last camera's recovered extrinsic error stays bounded
    and the loop residual is observable in the metrics."""
    ncam = 6
    depths, intr, ext = _ring_scene(ncam)
    kw = dict(icp_enabled=True, icp_iterations=6, icp_max_corr_dist=0.2)
    cfg_chain = _small_cfg(ncam, icp_ring_closure=False, **kw)
    cfg_ring = _small_cfg(ncam, icp_ring_closure=True, **kw)

    out_c = stitch_step(cfg_chain, intr, jnp.asarray(ext), jnp.asarray(depths))
    out_r = stitch_step(cfg_ring, intr, jnp.asarray(ext), jnp.asarray(depths))

    # anchor stays exact in both modes
    np.testing.assert_allclose(np.asarray(out_r.extrinsics)[0], np.eye(4),
                               atol=1e-6)
    # truth for every camera is identity; both modes must recover it well,
    # and closure must not be worse than the chain by more than the noise
    # floor (the statistical chain-vs-ring comparison lives in
    # test_compose_ring_corrections_reduces_chain_end_error)
    err_c = np.abs(np.asarray(out_c.extrinsics)[ncam - 1] - np.eye(4)).max()
    err_r = np.abs(np.asarray(out_r.extrinsics)[ncam - 1] - np.eye(4)).max()
    assert err_r < 0.005, (err_r, err_c)
    # the closure residual is observable (and was actually nonzero)
    assert float(out_r.metrics.loop_error) > 0.0
    assert float(out_c.metrics.loop_error) == 0.0


def test_ring_closure_noop_when_consistent():
    """With a single drifted camera and clean data the chain is already
    consistent: closure must not disturb the recovered extrinsics."""
    h, w = 120, 212
    depth = synth_depth_frame(h, w, seed=42)
    depths = np.stack([depth] * 3)
    intr = Intrinsics.create(fx=106.0, fy=106.0, ppx=w / 2, ppy=h / 2,
                             width=w, height=h)
    intr_b = intr.stack([intr, intr])
    drift = np.eye(4, dtype=np.float32)
    drift[:3, 3] = [0.04, -0.03, 0.02]
    ext = np.stack([np.eye(4, dtype=np.float32), drift,
                    np.eye(4, dtype=np.float32)])
    cfg = _small_cfg(3, icp_enabled=True, icp_iterations=8)
    out = stitch_step(cfg, intr_b, jnp.asarray(ext), jnp.asarray(depths))
    refined = np.asarray(out.extrinsics)
    np.testing.assert_allclose(refined[0], np.eye(4), atol=1e-6)
    err1 = np.abs(refined[1] - np.eye(4)).max()
    assert err1 < 0.02, err1
    assert float(out.metrics.loop_error) < 1e-3


def test_closure_gate_rejects_implausible_residual():
    """A closing-pair 'measurement' with a large false translation (no true
    overlap / ICP slid on a low-texture surface) must NOT be distributed:
    gated closure returns exactly the chain-only corrections, while the
    loop_error still reports the residual for observability."""
    from pointcloud_stitching_tpu.models.stitcher import (
        _compose_ring_corrections)
    ncam = 8
    deltas = np.stack([np.eye(4, dtype=np.float32)] * ncam)
    deltas[0, :3, 3] = [0.5, 0.1, 0.0]   # false 0.51 m closing residual
    d = jnp.asarray(deltas)
    chain, _ = _compose_ring_corrections(d, False)
    gated, le = _compose_ring_corrections(d, True, gate=0.25)
    np.testing.assert_allclose(np.asarray(gated), np.asarray(chain),
                               atol=1e-6)
    assert float(le) > 0.2  # residual observable even when not applied
    # a plausible residual still distributes
    deltas[0, :3, 3] = [0.02, 0.01, 0.0]
    applied, _ = _compose_ring_corrections(jnp.asarray(deltas), True,
                                           gate=0.25)
    assert np.abs(np.asarray(applied)[-1] - np.asarray(chain)[-1]).max() \
        > 1e-3


def test_closure_gate_rejects_rotation_dominated_residual():
    """The rotation arm of the closure gate: a closing residual that is a
    20-degree rotation with negligible translation is just as implausible
    as a half-meter translation and must not be distributed (a
    translation-only gate passes it — r3 review finding)."""
    from pointcloud_stitching_tpu.models.stitcher import (
        _compose_ring_corrections)
    ncam = 8
    th = np.deg2rad(20.0)
    deltas = np.stack([np.eye(4, dtype=np.float32)] * ncam)
    deltas[0, :3, :3] = np.array(
        [[np.cos(th), -np.sin(th), 0],
         [np.sin(th), np.cos(th), 0],
         [0, 0, 1]], np.float32)
    deltas[0, :3, 3] = [0.05, 0.0, 0.0]  # passes the 0.25 m translation arm
    d = jnp.asarray(deltas)
    chain, _ = _compose_ring_corrections(d, False)
    gated, le = _compose_ring_corrections(d, True, gate=0.25, gate_rot=0.26)
    np.testing.assert_allclose(np.asarray(gated), np.asarray(chain),
                               atol=1e-6)
    assert float(le) > 0.1  # still observable
    # a sub-gate rotation still distributes
    th = np.deg2rad(5.0)
    deltas[0, :3, :3] = np.array(
        [[np.cos(th), -np.sin(th), 0],
         [np.sin(th), np.cos(th), 0],
         [0, 0, 1]], np.float32)
    applied, _ = _compose_ring_corrections(jnp.asarray(deltas), True,
                                           gate=0.25, gate_rot=0.26)
    assert np.abs(np.asarray(applied)[-1] - np.asarray(chain)[-1]).max() \
        > 1e-3
    # default gate_rot=inf admits any rotation (no nan-gating)
    th = np.deg2rad(20.0)
    deltas[0, :3, :3] = np.array(
        [[np.cos(th), -np.sin(th), 0],
         [np.sin(th), np.cos(th), 0],
         [0, 0, 1]], np.float32)
    open_gate, _ = _compose_ring_corrections(jnp.asarray(deltas), True,
                                             gate=0.25)
    assert np.abs(np.asarray(open_gate)[-1] - np.asarray(chain)[-1]).max() \
        > 1e-3
