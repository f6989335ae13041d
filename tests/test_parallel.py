"""Multi-device sharding tests on the 8-device virtual CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pointcloud_stitching_tpu import Intrinsics
from pointcloud_stitching_tpu.models import stitch_step
from pointcloud_stitching_tpu.parallel import make_mesh, make_sharded_stitch
from pointcloud_stitching_tpu.utils.config import StitchConfig
from oracle import random_se3, synth_depth_frame



@pytest.fixture(autouse=True)
def _multi_device():
    if len(jax.devices()) < 2:
        pytest.skip("needs multi-device (virtual CPU) mesh")


def _cfg(ncam, icp=True):
    # icp_trim_fraction pinned to 0: these are sharded-vs-single parity
    # tests, and the trim quantile is a discrete cut — a 1-ulp NN-distance
    # difference between backends can flip a correspondence at the
    # threshold and push extrinsics past the 1e-4 parity tolerance.
    # Trimming itself is covered by test_nn_icp / the measured rig.
    return StitchConfig(num_cameras=ncam, height=60, width=106,
                        cam_voxel_leaf=0.03, cam_capacity=4096,
                        out_voxel_leaf=0.03, out_capacity=8192,
                        icp_enabled=icp, icp_voxel_leaf=0.06,
                        icp_capacity=1024, icp_iterations=2,
                        icp_max_corr_dist=0.3, icp_trim_fraction=0.0,
                        icp_query_tile=256, icp_ref_tile=256)


def _scene(ncam, h=60, w=106):
    depths = np.stack([synth_depth_frame(h, w, seed=s) for s in range(ncam)])
    i0 = Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2, ppy=h / 2,
                           width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1))
    ext = np.stack([random_se3(seed=20 + i, max_angle=0.05, max_trans=0.1)
                    for i in range(ncam)]).astype(np.float32)
    return depths, intr, ext


def test_sharded_matches_single_device():
    ncam = len(jax.devices())
    depths, intr, ext = _scene(ncam)
    cfg = _cfg(ncam)
    mesh = make_mesh()
    fn = make_sharded_stitch(cfg, mesh)
    out_sharded = fn(intr, jnp.asarray(ext), jnp.asarray(depths))
    out_single = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))

    a = np.asarray(out_sharded.cloud.xyz)[np.asarray(out_sharded.cloud.mask)]
    b = np.asarray(out_single.cloud.xyz)[np.asarray(out_single.cloud.mask)]
    assert a.shape == b.shape
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(out_sharded.extrinsics),
                               np.asarray(out_single.extrinsics), atol=1e-4)


def _mixed_scene(ncam, h=60, w=106):
    """Scene whose cameras alternate distortion models (MIXED rig)."""
    from pointcloud_stitching_tpu import DistortionModel
    depths = np.stack([synth_depth_frame(h, w, seed=s) for s in range(ncam)])
    cams = []
    for i in range(ncam):
        model = (DistortionModel.BROWN_CONRADY if i % 2
                 else DistortionModel.NONE)
        coeffs = [0.05, -0.02, 0.001, -0.001, 0.002] if i % 2 else None
        cams.append(Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2,
                                      ppy=h / 2, width=w, height=h,
                                      coeffs=coeffs, model=model))
    intr = cams[0].stack(cams[1:])
    ext = np.stack([random_se3(seed=20 + i, max_angle=0.05, max_trans=0.1)
                    for i in range(ncam)]).astype(np.float32)
    return depths, intr, ext


@pytest.mark.parametrize("path", ["gspmd", "shard_map"])
def test_sharded_mixed_distortion_matches_single_device(path):
    """A MIXED-distortion rig through both sharded paths equals the
    single-device program (the shard_map path used to hardcode model=NONE).

    Cloud equality is asserted with ICP off (deproject/voxel are exactly
    deterministic); with ICP on only the refined extrinsics are compared —
    the solver's ~1e-7 cross-partitioning float noise legitimately moves
    single points across voxel boundaries, which is not the property under
    test."""
    import dataclasses as dc
    ncam = len(jax.devices())
    depths, intr, ext = _mixed_scene(ncam)

    def build(cfg):
        if path == "gspmd":
            return cfg, make_sharded_stitch(cfg, make_mesh())
        from pointcloud_stitching_tpu.parallel import make_shardmap_stitch
        cfg = dc.replace(cfg, cam_voxel_enabled=True)
        return cfg, make_shardmap_stitch(cfg, make_mesh())

    # exact cloud parity, ICP off
    cfg0, fn0 = build(dc.replace(_cfg(ncam, icp=False), out_capacity=32768))
    out_sharded = fn0(intr, jnp.asarray(ext), jnp.asarray(depths))
    out_single = stitch_step(cfg0, intr, jnp.asarray(ext),
                             jnp.asarray(depths))
    a = np.asarray(out_sharded.cloud.xyz)[np.asarray(out_sharded.cloud.mask)]
    b = np.asarray(out_single.cloud.xyz)[np.asarray(out_single.cloud.mask)]
    assert a.shape == b.shape
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-4)

    # refined-extrinsics parity, ICP on (exercises distortion through the
    # whole ring-ICP path)
    cfg1, fn1 = build(_cfg(ncam))
    o_sh = fn1(intr, jnp.asarray(ext), jnp.asarray(depths))
    o_si = stitch_step(cfg1, intr, jnp.asarray(ext), jnp.asarray(depths))
    np.testing.assert_allclose(np.asarray(o_sh.extrinsics),
                               np.asarray(o_si.extrinsics), atol=1e-5)


def test_sharded_colored_stream_matches_single_device():
    """Colored (and texture-mapped) streams through the GSPMD path."""
    ncam = len(jax.devices())
    depths, intr, ext = _scene(ncam)
    rng = np.random.default_rng(5)
    hc, wc = 45, 80
    colors = rng.integers(0, 256, (ncam, hc, wc, 3)).astype(np.uint8)
    ci = Intrinsics.create(fx=40.0, fy=40.0, ppx=wc / 2, ppy=hc / 2,
                           width=wc, height=hc)
    cintr = ci.stack([ci] * (ncam - 1))
    c_ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    c_ext[:, 0, 3] = 0.015
    cfg = _cfg(ncam, icp=False)
    fn = make_sharded_stitch(cfg, make_mesh())
    kw = dict(colors=jnp.asarray(colors), color_intr=cintr,
              color_ext=jnp.asarray(c_ext))
    out_sh = fn(intr, jnp.asarray(ext), jnp.asarray(depths), **kw)
    out_si = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths),
                         **kw)
    assert out_sh.cloud.rgb is not None
    m_sh, m_si = np.asarray(out_sh.cloud.mask), np.asarray(out_si.cloud.mask)
    a = np.concatenate([np.asarray(out_sh.cloud.xyz)[m_sh],
                        np.asarray(out_sh.cloud.rgb)[m_sh]], axis=1)
    b = np.concatenate([np.asarray(out_si.cloud.xyz)[m_si],
                        np.asarray(out_si.cloud.rgb)[m_si]], axis=1)
    assert a.shape == b.shape
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-4)


def test_sharded_no_icp_matches():
    ncam = len(jax.devices())
    depths, intr, ext = _scene(ncam)
    cfg = _cfg(ncam, icp=False)
    fn = make_sharded_stitch(cfg, make_mesh())
    out = fn(intr, jnp.asarray(ext), jnp.asarray(depths))
    ref = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    np.testing.assert_allclose(
        np.sort(np.asarray(out.cloud.xyz)[np.asarray(out.cloud.mask)], axis=0),
        np.sort(np.asarray(ref.cloud.xyz)[np.asarray(ref.cloud.mask)], axis=0),
        atol=1e-5)


def test_mesh_size_divisibility_enforced():
    cfg = _cfg(3)
    if len(jax.devices()) == 8:
        with pytest.raises(ValueError):
            make_sharded_stitch(cfg, make_mesh())


def test_ring_nn_matches_single_device(rng):
    from pointcloud_stitching_tpu.parallel import ring_nearest_neighbors
    from pointcloud_stitching_tpu.ops import nearest_neighbors
    d = len(jax.devices())
    n, m = 512 * d, 768 * d
    q = rng.normal(size=(n, 3)).astype(np.float32)
    r = rng.normal(size=(m, 3)).astype(np.float32)
    mask = rng.random(m) > 0.1
    mesh = make_mesh()
    idx, d2 = ring_nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                                     jnp.asarray(mask), mesh,
                                     query_tile=256, ref_tile=256)
    ridx, rd2 = nearest_neighbors(jnp.asarray(q), jnp.asarray(r),
                                  jnp.asarray(mask),
                                  query_tile=256, ref_tile=256, impl="xla")
    np.testing.assert_allclose(np.asarray(d2), np.asarray(rd2), atol=1e-5)
    agree = (np.asarray(idx) == np.asarray(ridx)).mean()
    assert agree > 0.999  # ties may resolve to a different shard's index


def test_sharded_program_contains_collectives():
    """The sharded step must actually communicate over the mesh (ring ICP
    neighbour exchange / fused-cloud gather), not silently replicate."""
    ncam = len(jax.devices())
    depths, intr, ext = _scene(ncam)
    cfg = _cfg(ncam)
    fn = make_sharded_stitch(cfg, make_mesh())
    compiled = fn.lower(intr, jnp.asarray(ext),
                        jnp.asarray(depths)).compile()
    hlo = compiled.as_text()
    assert any(op in hlo for op in
               ("all-gather", "collective-permute", "all-to-all",
                "all-reduce")), "no collectives in sharded program"


def test_shardmap_stitch_matches_single_device():
    """shard_map sharded stitch (Pallas-capable per-chip path) vs the
    single-device pipeline, including ring drift correction."""
    import dataclasses
    from pointcloud_stitching_tpu.parallel import make_shardmap_stitch
    ncam = len(jax.devices())
    depths, intr, ext = _scene(ncam)
    cfg = dataclasses.replace(_cfg(ncam), cam_voxel_enabled=True,
                              cam_voxel_leaf=0.005, cam_capacity=8192)
    fn = make_shardmap_stitch(cfg, make_mesh())
    out_s = fn(intr, jnp.asarray(ext), jnp.asarray(depths))
    out_1 = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    np.testing.assert_allclose(np.asarray(out_s.extrinsics),
                               np.asarray(out_1.extrinsics), atol=1e-4)
    a = np.asarray(out_s.cloud.xyz)[np.asarray(out_s.cloud.mask)]
    b = np.asarray(out_1.cloud.xyz)[np.asarray(out_1.cloud.mask)]
    assert a.shape == b.shape
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-4)
    assert int(out_s.metrics.points_in) == int(out_1.metrics.points_in)


def test_shardmap_stitch_point_to_plane_matches_single_device():
    import dataclasses
    from pointcloud_stitching_tpu.parallel import make_shardmap_stitch
    ncam = len(jax.devices())
    depths, intr, ext = _scene(ncam)
    cfg = dataclasses.replace(_cfg(ncam), cam_voxel_enabled=True,
                              cam_voxel_leaf=0.005, cam_capacity=8192,
                              icp_variant="point_to_plane", icp_stride=2)
    fn = make_shardmap_stitch(cfg, make_mesh())
    out_s = fn(intr, jnp.asarray(ext), jnp.asarray(depths))
    out_1 = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    np.testing.assert_allclose(np.asarray(out_s.extrinsics),
                               np.asarray(out_1.extrinsics), atol=1e-4)
    a = np.asarray(out_s.cloud.xyz)[np.asarray(out_s.cloud.mask)]
    b = np.asarray(out_1.cloud.xyz)[np.asarray(out_1.cloud.mask)]
    assert a.shape == b.shape
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-4)


def test_shardmap_stitch_pallas_interpret_matches_single_device():
    """The Pallas NN kernel executing under shard_map: kernel_impl='pallas'
    with interpret=True on the CPU mesh, parity vs the single-device XLA
    pipeline — the same composed program (shard_map -> NN pallas_call)
    that runs on a multi-GPU mesh, minus only the Triton compiler."""
    import dataclasses
    from pointcloud_stitching_tpu.parallel import make_shardmap_stitch
    ncam = len(jax.devices())
    depths, intr, ext = _scene(ncam)
    cfg = dataclasses.replace(_cfg(ncam), cam_voxel_enabled=True,
                              cam_voxel_leaf=0.005, cam_capacity=8192,
                              kernel_impl="pallas", kernel_interpret=True)
    fn = make_shardmap_stitch(cfg, make_mesh())
    out_s = fn(intr, jnp.asarray(ext), jnp.asarray(depths))
    cfg_xla = dataclasses.replace(cfg, kernel_impl="xla",
                                  kernel_interpret=False)
    out_1 = stitch_step(cfg_xla, intr, jnp.asarray(ext),
                        jnp.asarray(depths))
    np.testing.assert_allclose(np.asarray(out_s.extrinsics),
                               np.asarray(out_1.extrinsics), atol=1e-4)
    a = np.asarray(out_s.cloud.xyz)[np.asarray(out_s.cloud.mask)]
    b = np.asarray(out_1.cloud.xyz)[np.asarray(out_1.cloud.mask)]
    assert a.shape == b.shape
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-4)
    assert int(out_s.metrics.points_in) == int(out_1.metrics.points_in)


# ---------------------------------------------------------------------------
# Z-slab sharded TSDF (parallel/tsdf_shard.py)
# ---------------------------------------------------------------------------

def _tsdf_scene(pow2=True):
    """Two-camera analytic scene + a volume whose leaf/origin are exact
    binary values, so the sharded slab-origin shift is EXACT and parity
    with the unsharded integrate is bitwise (tsdf_shard.py docstring)."""
    from test_tsdf import render_depth
    h, w = 48, 64
    intr = Intrinsics.create(fx=50.0, fy=50.0, ppx=w / 2.0, ppy=h / 2.0,
                             width=w, height=h)
    scene = dict(spheres=[((0.0, 0.1, 1.0), 0.3)],
                 planes=[((0.0, 0.0, -1.0), -1.8)])
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [0.1, -0.05, -0.1]
    d1 = render_depth(intr, np.eye(4, dtype=np.float32), **scene)
    d2 = render_depth(intr, T2, **scene)
    d1[10:14, 8:30] = 0.0            # dead patch: refine-brick coverage
    depth = jnp.stack([jnp.asarray(d1), jnp.asarray(d2)])
    intr_b = intr.stack([intr])
    ext = jnp.stack([jnp.eye(4, dtype=jnp.float32), jnp.asarray(T2)])
    leaf = 0.03125                   # 2^-5: slab origin shifts exact
    origin = (-0.5, -0.5, 0.25)      # multiples of the leaf
    return depth, intr_b, ext, leaf, origin


def test_sharded_tsdf_integrate_single_camera_promotion():
    """The 2-D depth convenience path must promote intr/color/extrinsics
    exactly like the unsharded integrate (r5 review: the wrapper expanded
    only depth, so integrate() skipped its own promotion and _cam_slice
    crashed on the 0-d intrinsics), and stay bitwise with it."""
    from pointcloud_stitching_tpu.models import tsdf as M
    from pointcloud_stitching_tpu.parallel import (make_sharded_integrate,
                                                   shard_volume)
    from test_tsdf import render_depth

    h, w = 48, 64
    intr = Intrinsics.create(fx=50.0, fy=50.0, ppx=w / 2.0, ppy=h / 2.0,
                             width=w, height=h)
    d = render_depth(intr, np.eye(4, dtype=np.float32),
                     spheres=[((0.0, 0.1, 1.0), 0.3)])
    rng = np.random.default_rng(0)
    color = jnp.asarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    kw = dict(depth_scale=1.0, z_min=0.2, z_max=5.0, color=color)
    shape, leaf, origin = (32, 32, 64), 0.03125, (-0.5, -0.5, 0.25)
    ext = jnp.eye(4, dtype=jnp.float32)          # single [4, 4]
    ref = M.integrate(
        M.TSDFVolume.create(shape, leaf, origin=origin, with_rgb=True),
        jnp.asarray(d), intr, ext, method="dense", **kw)
    mesh = make_mesh(axis="z")
    vs = shard_volume(
        M.TSDFVolume.create(shape, leaf, origin=origin, with_rgb=True),
        mesh, axis="z")
    vs = make_sharded_integrate(mesh, axis="z", method="dense")(
        vs, jnp.asarray(d), intr, ext, **kw)     # 2-D depth, 0-d intr
    assert np.array_equal(np.asarray(vs.tsdf), np.asarray(ref.tsdf))
    assert np.array_equal(np.asarray(vs.weight), np.asarray(ref.weight))
    assert np.array_equal(np.asarray(vs.rgb), np.asarray(ref.rgb))


def test_sharded_raycast_refuses_undersized_halo():
    """A halo wider than the slab would silently drop crossings near slab
    boundaries; the builder must refuse with actionable guidance instead
    of clamping (r5 review)."""
    import pytest

    from pointcloud_stitching_tpu.models import tsdf as M
    from pointcloud_stitching_tpu.parallel import (make_sharded_raycast,
                                                   shard_volume)

    mesh = make_mesh(axis="z")                   # 8 devices -> 4-plane slabs
    vs = shard_volume(
        M.TSDFVolume.create((16, 16, 32), 0.03125, origin=(0.0, 0.0, 0.0)),
        mesh, axis="z")
    i0 = Intrinsics.create(fx=50.0, fy=50.0, ppx=8.0, ppy=8.0,
                           width=16, height=16)
    fn = make_sharded_raycast(mesh, axis="z", step=0.5)   # needs 26 planes
    with pytest.raises(ValueError, match="halo"):
        fn(vs, i0, jnp.eye(4, dtype=jnp.float32))


def test_sharded_tsdf_integrate_matches_single_device():
    """Z-slab sharded integrate == unsharded dense, BITWISE (two frames,
    so prior weights are nonzero on the second)."""
    from pointcloud_stitching_tpu.models import tsdf as M
    from pointcloud_stitching_tpu.parallel import (make_sharded_integrate,
                                                   shard_volume)

    depth, intr_b, ext, leaf, origin = _tsdf_scene()
    kw = dict(depth_scale=1.0, z_min=0.2, z_max=5.0)
    shape = (32, 32, 64)
    ref = M.TSDFVolume.create(shape, leaf, origin=origin)
    mesh = make_mesh(axis="z")
    vs = shard_volume(M.TSDFVolume.create(shape, leaf, origin=origin),
                      mesh, axis="z")
    fn = make_sharded_integrate(mesh, axis="z", method="dense")
    for _ in range(2):
        ref = M.integrate(ref, depth, intr_b, ext, method="dense", **kw)
        vs = fn(vs, depth, intr_b, ext, **kw)
    assert np.array_equal(np.asarray(vs.tsdf), np.asarray(ref.tsdf))
    assert np.array_equal(np.asarray(vs.weight), np.asarray(ref.weight))


def test_sharded_tsdf_integrate_mxu_pallas_interpret_color():
    """shard_map -> per-slab one-hot integrate (method='mxu_xla') with
    packed uint8 color — bitwise vs unsharded dense."""
    from pointcloud_stitching_tpu.models import tsdf as M
    from pointcloud_stitching_tpu.parallel import (make_sharded_integrate,
                                                   shard_volume)

    depth, intr_b, ext, leaf, origin = _tsdf_scene()
    rng = np.random.default_rng(0)
    color = jnp.asarray(rng.integers(0, 256, (*depth.shape, 3),
                                     dtype=np.uint8))
    kw = dict(depth_scale=1.0, z_min=0.2, z_max=5.0, color=color)
    shape = (32, 32, 64)
    ref = M.TSDFVolume.create(shape, leaf, origin=origin, with_rgb=True)
    ref = M.integrate(ref, depth, intr_b, ext, method="dense", **kw)
    mesh = make_mesh(axis="z")
    vs = shard_volume(
        M.TSDFVolume.create(shape, leaf, origin=origin, with_rgb=True),
        mesh, axis="z")
    fn = make_sharded_integrate(mesh, axis="z", method="mxu_xla")
    vs = fn(vs, depth, intr_b, ext, **kw)
    assert np.array_equal(np.asarray(vs.tsdf), np.asarray(ref.tsdf))
    assert np.array_equal(np.asarray(vs.weight), np.asarray(ref.weight))
    assert np.array_equal(np.asarray(vs.rgb), np.asarray(ref.rgb))


def test_sharded_tsdf_raycast_matches_single_device():
    """Per-slab halo-extended march + min-combine vs the unsharded
    renderer. The slab origin subtraction reassociates (p - org) vs
    (p - origin) so nearest-voxel rounding can flip on a measure-zero
    set — tolerance on depth, near-complete agreement on validity."""
    from pointcloud_stitching_tpu.models import tsdf as M
    from pointcloud_stitching_tpu.parallel import (make_sharded_integrate,
                                                   make_sharded_raycast,
                                                   shard_volume)

    depth, intr_b, ext, leaf, origin = _tsdf_scene()
    kw = dict(depth_scale=1.0, z_min=0.2, z_max=5.0)
    shape = (32, 32, 64)
    ref = M.TSDFVolume.create(shape, leaf, origin=origin)
    ref = M.integrate(ref, depth, intr_b, ext, method="dense", **kw)
    mesh = make_mesh(axis="z")
    vs = shard_volume(M.TSDFVolume.create(shape, leaf, origin=origin),
                      mesh, axis="z")
    vs = make_sharded_integrate(mesh, axis="z", method="dense")(
        vs, depth, intr_b, ext, **kw)

    i0 = Intrinsics.create(fx=50.0, fy=50.0, ppx=32.0, ppy=24.0,
                           width=64, height=48)
    T = np.eye(4, dtype=np.float32)
    rc1 = M.raycast(ref, i0, T, t_min=0.2, t_max=3.0)
    rcn = make_sharded_raycast(mesh, axis="z", t_min=0.2, t_max=3.0)(
        vs, i0, T)
    v1 = np.asarray(rc1.valid)
    vn = np.asarray(rcn.valid)
    # rounding flips may move single samples; demand near-total agreement
    assert (v1 != vn).mean() < 0.01, (v1 != vn).mean()
    both = v1 & vn
    assert both.sum() > 500
    np.testing.assert_allclose(np.asarray(rcn.depth)[both],
                               np.asarray(rc1.depth)[both], atol=2e-3)
    nrm = np.asarray(rcn.normal)[both]
    np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0,
                               atol=1e-3)
