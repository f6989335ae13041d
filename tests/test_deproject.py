import numpy as np
import jax.numpy as jnp

from pointcloud_stitching_tpu import Intrinsics, DistortionModel
from pointcloud_stitching_tpu.ops import deproject, deproject_with_color
from oracle import deproject_np, synth_depth_frame


INTR = dict(fx=421.5, fy=421.1, ppx=423.2, ppy=238.9)


def test_deproject_matches_oracle():
    depth = synth_depth_frame(seed=3)
    intr = Intrinsics.create(**INTR)
    pc = deproject(depth, intr)
    xyz_ref, mask_ref = deproject_np(depth, **INTR)
    np.testing.assert_array_equal(np.asarray(pc.mask), mask_ref)
    np.testing.assert_allclose(np.asarray(pc.xyz), xyz_ref, atol=1e-5)


def test_deproject_zero_depth_masked():
    depth = np.zeros((480, 848), np.uint16)
    depth[5, 7] = 1000
    pc = deproject(depth, Intrinsics.create(**INTR))
    assert int(pc.count()) == 1
    assert np.asarray(pc.mask)[5 * 848 + 7]


def test_deproject_z_range():
    depth = synth_depth_frame(seed=4)
    pc = deproject(depth, Intrinsics.create(**INTR), z_min=0.5, z_max=2.0)
    xyz = np.asarray(pc.xyz)
    m = np.asarray(pc.mask)
    assert (xyz[m, 2] > 0.5).all() and (xyz[m, 2] <= 2.0).all()


def test_deproject_brown_conrady():
    depth = synth_depth_frame(seed=5)
    coeffs = [0.1, -0.05, 0.001, -0.002, 0.01]
    intr = Intrinsics.create(**INTR, coeffs=coeffs,
                             model=DistortionModel.BROWN_CONRADY)
    pc = deproject(depth, intr)
    xyz_ref, mask_ref = deproject_np(depth, **INTR, coeffs=coeffs,
                                     model="brown_conrady")
    np.testing.assert_allclose(np.asarray(pc.xyz), xyz_ref, atol=1e-4)


def test_deproject_inverse_brown_conrady():
    depth = synth_depth_frame(seed=6)
    coeffs = [0.12, -0.04, 0.002, -0.001, 0.005]
    intr = Intrinsics.create(**INTR, coeffs=coeffs,
                             model=DistortionModel.INVERSE_BROWN_CONRADY)
    pc = deproject(depth, intr)
    xyz_ref, _ = deproject_np(depth, **INTR, coeffs=coeffs,
                              model="inverse_brown_conrady")
    np.testing.assert_allclose(np.asarray(pc.xyz), xyz_ref, atol=1e-4)


def test_deproject_mixed_models_matches_oracle():
    """A rig mixing NONE + BROWN_CONRADY + INVERSE_BROWN_CONRADY cameras
: stack() goes MIXED with traced per-camera ids, and
    every camera matches its own single-model oracle deprojection."""
    depths = np.stack([synth_depth_frame(seed=s) for s in range(3)])
    coeffs = [[0.0] * 5,
              [0.1, -0.05, 0.001, -0.002, 0.01],
              [0.12, -0.04, 0.002, -0.001, 0.005]]
    models = [DistortionModel.NONE, DistortionModel.BROWN_CONRADY,
              DistortionModel.INVERSE_BROWN_CONRADY]
    cams = [Intrinsics.create(**INTR, coeffs=c, model=m)
            for c, m in zip(coeffs, models)]
    intr = cams[0].stack(cams[1:])
    assert intr.model == int(DistortionModel.MIXED)
    assert intr.model_ids is not None

    pc = deproject(depths, intr)
    names = ["none", "brown_conrady", "inverse_brown_conrady"]
    for i in range(3):
        xyz_ref, mask_ref = deproject_np(depths[i], **INTR,
                                         coeffs=coeffs[i], model=names[i])
        np.testing.assert_array_equal(np.asarray(pc.mask)[i], mask_ref)
        np.testing.assert_allclose(np.asarray(pc.xyz)[i], xyz_ref, atol=1e-4)


def test_project_mixed_models_matches_single_model():
    """project() on a MIXED stack must apply each camera's own forward
    distortion (regression: the MIXED branch existed only in deproject, so
    mixed color rigs projected every camera undistorted)."""
    from pointcloud_stitching_tpu.ops.deproject import project

    rng = np.random.default_rng(11)
    xyz = rng.uniform(-0.5, 0.5, (3, 500, 3)).astype(np.float32)
    xyz[..., 2] += 1.5                               # in front of the camera
    coeffs = [[0.0] * 5,
              [0.1, -0.05, 0.001, -0.002, 0.01],
              [0.12, -0.04, 0.002, -0.001, 0.005]]
    models = [DistortionModel.NONE, DistortionModel.BROWN_CONRADY,
              DistortionModel.INVERSE_BROWN_CONRADY]
    cams = [Intrinsics.create(**INTR, coeffs=c, model=m)
            for c, m in zip(coeffs, models)]
    stacked = cams[0].stack(cams[1:])
    assert stacked.model == int(DistortionModel.MIXED)

    uv_mixed, inf_mixed = project(jnp.asarray(xyz), stacked)
    for i in range(3):
        uv_i, inf_i = project(jnp.asarray(xyz[i]), cams[i])
        np.testing.assert_array_equal(np.asarray(inf_mixed)[i],
                                      np.asarray(inf_i))
        np.testing.assert_allclose(np.asarray(uv_mixed)[i],
                                   np.asarray(uv_i), atol=1e-4)
    # the distorted cameras' projections must actually differ from an
    # undistorted projection of the same points (guards against a MIXED
    # branch that silently applies no distortion)
    uv_none, _ = project(jnp.asarray(xyz[1]), cams[0])
    assert not np.allclose(np.asarray(uv_mixed)[1], np.asarray(uv_none),
                           atol=0.5)


def test_stack_uniform_model_stays_static():
    cams = [Intrinsics.create(**INTR) for _ in range(3)]
    intr = cams[0].stack(cams[1:])
    assert intr.model == int(DistortionModel.NONE)
    assert intr.model_ids is None


def test_stack_rejects_mixed_resolutions():
    import pytest
    a = Intrinsics.create(**INTR, width=848, height=480)
    b = Intrinsics.create(**INTR, width=640, height=480)
    with pytest.raises(ValueError, match="width/height"):
        a.stack([b])


def test_map_color_matches_oracle():
    """Texture-coordinate color mapping with separate color calibration
    (rs2 map_to semantics): nearest-pixel lookup
    after projecting through the color camera, vs the numpy oracle."""
    from oracle import map_color_np, random_se3
    from pointcloud_stitching_tpu.ops import deproject_with_color_mapped

    rng = np.random.default_rng(7)
    depth = synth_depth_frame(seed=9)
    hc, wc = 270, 480                    # color stream at its own resolution
    color = rng.integers(0, 256, (hc, wc, 3)).astype(np.uint8)
    c_intr = dict(fx=305.0, fy=304.0, ppx=wc / 2 + 3.0, ppy=hc / 2 - 2.0)
    d2c = random_se3(seed=13, max_angle=0.02, max_trans=0.015)  # ~15mm baseline

    intr = Intrinsics.create(**INTR)
    cintr = Intrinsics.create(**c_intr, width=wc, height=hc)
    pc = deproject_with_color_mapped(depth, color, intr, cintr,
                                     jnp.asarray(d2c))
    xyz_ref, mask_ref = deproject_np(depth, **INTR)
    rgb_ref = map_color_np(xyz_ref, mask_ref, color, **{
        "c_fx": c_intr["fx"], "c_fy": c_intr["fy"],
        "c_ppx": c_intr["ppx"], "c_ppy": c_intr["ppy"]}, d2c=d2c)
    got = np.asarray(pc.rgb)
    # points whose projection rounds within half a pixel of a boundary can
    # legitimately pick the neighbouring texel under f32 vs f64 rounding;
    # require exact agreement on the overwhelming majority
    agree = (got == rgb_ref).all(axis=-1)
    assert agree.mean() > 0.999, 1.0 - agree.mean()
    assert (got[~np.asarray(pc.mask)] == 0).all()


def test_map_color_distorted_and_out_of_fov():
    from oracle import map_color_np
    from pointcloud_stitching_tpu import DistortionModel, PointCloud
    from pointcloud_stitching_tpu.ops import map_color

    rng = np.random.default_rng(8)
    pts = rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(0.3, 3.0, 4096).astype(np.float32)
    pts[:64, 2] = -0.5                  # behind the color camera
    mask = np.ones(4096, bool)
    mask[64:96] = False
    hc, wc = 120, 160
    color = rng.integers(0, 256, (hc, wc, 3)).astype(np.uint8)
    coeffs = [0.08, -0.03, 0.001, -0.001, 0.004]
    c = dict(fx=120.0, fy=121.0, ppx=wc / 2, ppy=hc / 2)
    d2c = np.eye(4, dtype=np.float32)
    d2c[:3, 3] = [0.015, 0.0, 0.0]

    cintr = Intrinsics.create(**c, coeffs=coeffs, width=wc, height=hc,
                              model=DistortionModel.BROWN_CONRADY)
    pc = PointCloud(xyz=jnp.asarray(pts), mask=jnp.asarray(mask))
    out = map_color(pc, jnp.asarray(color), cintr, jnp.asarray(d2c))
    rgb_ref = map_color_np(pts, mask, color, c["fx"], c["fy"], c["ppx"],
                           c["ppy"], d2c, coeffs=coeffs,
                           model="brown_conrady")
    got = np.asarray(out.rgb)
    agree = (got == rgb_ref).all(axis=-1)
    assert agree.mean() > 0.995, 1.0 - agree.mean()
    assert (got[:64] == 0).all()        # behind camera -> black
    assert (got[64:96] == 0).all()      # masked -> black


def test_deproject_batched_cameras():
    depths = np.stack([synth_depth_frame(seed=s) for s in range(3)])
    base = Intrinsics.create(**INTR)
    others = [Intrinsics.create(fx=400.0, fy=401.0, ppx=424.0, ppy=240.0),
              Intrinsics.create(fx=430.0, fy=429.0, ppx=420.0, ppy=241.0)]
    batched = base.stack(others)
    pc = deproject(depths, batched)
    assert pc.xyz.shape == (3, 480 * 848, 3)
    # camera 1 must match its own single-camera result
    pc1 = deproject(depths[1], others[0])
    np.testing.assert_allclose(np.asarray(pc.xyz[1]), np.asarray(pc1.xyz),
                               atol=1e-6)


def test_deproject_with_color():
    depth = synth_depth_frame(seed=7)
    color = (np.arange(480 * 848 * 3) % 255).reshape(480, 848, 3).astype(np.uint8)
    pc = deproject_with_color(depth, color, Intrinsics.create(**INTR))
    m = np.asarray(pc.mask)
    np.testing.assert_allclose(
        np.asarray(pc.rgb)[m], color.reshape(-1, 3)[m].astype(np.float32))
