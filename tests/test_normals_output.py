"""Per-point normals in the fused output (cfg.with_normals).

The pcl::PointNormal capability: full-resolution grid normals rotate to
world frame with the extrinsics, ride the packed voxel sort as quantized
3x8-bit integers (the colored-cloud machinery), and decode back to unit
vectors with ops.decode_normals.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from pointcloud_stitching_tpu import Intrinsics
from pointcloud_stitching_tpu.models import stitch_step
from pointcloud_stitching_tpu.ops import decode_normals
from pointcloud_stitching_tpu.utils.config import StitchConfig


def _flat_scene(ncam=2, h=64, w=96, depth_mm=1000):
    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       icp_enabled=False, with_normals=True,
                       out_voxel_leaf=0.02, out_capacity=16384)
    i0 = Intrinsics.create(fx=80.0, fy=80.0, ppx=w / 2, ppy=h / 2,
                           width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1))
    depths = np.full((ncam, h, w), depth_mm, np.uint16)
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    return cfg, intr, ext, depths


def test_flat_scene_normals_face_the_sensor():
    cfg, intr, ext, depths = _flat_scene()
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    n, ok = decode_normals(out.cloud)
    n, ok = np.asarray(n), np.asarray(ok)
    mask = np.asarray(out.cloud.mask)
    assert mask.sum() > 100
    # nearly every voxel of a clean plane resolves a normal
    assert ok.sum() > 0.9 * mask.sum()
    # the z=1m plane's PCL-convention normal points at the sensor: -z
    dots = n[ok] @ np.array([0.0, 0.0, -1.0], np.float32)
    assert np.all(dots > 0.99), dots.min()
    # decoded normals are unit
    np.testing.assert_allclose(np.linalg.norm(n[ok], axis=-1), 1.0,
                               atol=1e-5)


def test_normals_rotate_with_extrinsics():
    cfg, intr, ext, depths = _flat_scene(ncam=2)
    a = 0.5
    R = np.array([[1, 0, 0],
                  [0, np.cos(a), -np.sin(a)],
                  [0, np.sin(a), np.cos(a)]], np.float32)
    ext = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    ext[:, :3, :3] = R
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    n, ok = decode_normals(out.cloud)
    n, ok = np.asarray(n), np.asarray(ok)
    want = R @ np.array([0.0, 0.0, -1.0], np.float32)
    dots = n[ok] @ want
    assert np.all(dots > 0.99), dots.min()


def test_normals_survive_voxel_averaging_quantization():
    """Quantize->voxel-mean->decode keeps a clean plane's normal within the
    8-bit budget (~0.5 deg) even when several pixels share a voxel."""
    cfg, intr, ext, depths = _flat_scene(h=64, w=96)
    import dataclasses
    cfg = dataclasses.replace(cfg, out_voxel_leaf=0.1, out_capacity=2048)
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    n, ok = decode_normals(out.cloud)
    n, ok = np.asarray(n), np.asarray(ok)
    angles = np.degrees(np.arccos(np.clip(
        n[ok] @ np.array([0.0, 0.0, -1.0]), -1, 1)))
    assert angles.max() < 1.0, angles.max()


def test_with_color_and_normals_mutually_exclusive():
    with pytest.raises(ValueError):
        StitchConfig(with_color=True, with_normals=True)


def test_decode_normals_requires_encoded_cloud():
    from pointcloud_stitching_tpu.utils.types import PointCloud
    pc = PointCloud(xyz=jnp.zeros((4, 3)), mask=jnp.ones((4,), bool))
    with pytest.raises(ValueError):
        decode_normals(pc)


def test_save_cloud_writes_pointnormal_ply(tmp_path):
    from pointcloud_stitching_tpu.io.plyio import save_cloud
    cfg, intr, ext, depths = _flat_scene()
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    path = str(tmp_path / "n.ply")
    save_cloud(path, out.cloud, binary=False, decode_normals=True)
    text = open(path).read().splitlines()
    assert "property float nx" in text
    body_start = text.index("end_header") + 1
    row = text[body_start].split()
    assert len(row) == 6  # x y z nx ny nz
    nz = float(row[5])
    assert abs(nz + 1.0) < 0.05  # plane normal ~ -z


def test_normals_accumulate_into_the_temporal_map():
    """Encoded normals ride the voxel map's rgb channel: a with_rgb map
    absorbing with_normals frames yields a scene model whose accumulated
    cloud still decodes to the surface normals."""
    from pointcloud_stitching_tpu.models import TemporalAccumulator
    cfg, intr, ext, depths = _flat_scene()
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    acc = TemporalAccumulator(capacity=1 << 15, leaf=0.02, with_rgb=True)
    for _ in range(3):
        acc.update(out.cloud)
    scene = acc.cloud(min_weight=1.0)
    n, ok = decode_normals(scene)
    n, ok = np.asarray(n), np.asarray(ok)
    assert ok.sum() > 100
    dots = n[ok] @ np.array([0.0, 0.0, -1.0], np.float32)
    assert np.all(dots > 0.99), dots.min()


def test_viewer_shades_encoded_normals():
    """render_view(shade_normals=True) Lambert-shades: a plane facing the
    view forward renders full-bright gray; the 'shade' steering command
    toggles the mode on a live CloudView."""
    from pointcloud_stitching_tpu.io.render import render_view
    from pointcloud_stitching_tpu.runtime.view_cli import CloudView
    cfg, intr, ext, depths = _flat_scene()
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    mask = np.asarray(out.cloud.mask)
    xyz = np.asarray(out.cloud.xyz)[mask]
    enc = np.asarray(out.cloud.rgb)[mask]
    img = render_view(xyz, enc, azimuth=0.0, elevation=0.0, size=64,
                      shade_normals=True)
    hit = img.reshape(-1, 3)
    hit = hit[hit.any(axis=-1)]
    assert len(hit) > 50
    # grayscale (r == g == b) and near full brightness: n ~ -z, fwd = +z
    assert np.all(hit[:, 0] == hit[:, 1]) and np.all(hit[:, 1] == hit[:, 2])
    assert np.median(hit[:, 0]) > 240
    # live toggle
    v = CloudView(size=64)
    assert not v.shade_normals
    assert v.apply_command("shade")
    assert v.shade_normals
    shaded = v.render(xyz, enc)
    s = shaded.reshape(-1, 3)
    s = s[s.any(axis=-1)]
    assert np.all(s[:, 0] == s[:, 1]) and np.all(s[:, 1] == s[:, 2])


def test_holes_do_not_corrupt_voxel_normals():
    """Pixels without a valid grid normal keep their point but contribute a
    zero normal: the voxel's renormalized direction must be unaffected."""
    cfg, intr, ext, depths = _flat_scene(h=64, w=96)
    import dataclasses
    cfg = dataclasses.replace(cfg, out_voxel_leaf=0.1, out_capacity=2048)
    d = depths.copy()
    d[:, ::3, ::3] = 0  # punch holes: their neighbours lose normals too
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(d))
    n, ok = decode_normals(out.cloud)
    n, ok = np.asarray(n), np.asarray(ok)
    assert ok.sum() > 50
    dots = n[ok] @ np.array([0.0, 0.0, -1.0], np.float32)
    assert np.all(dots > 0.99), dots.min()


def test_normals_survive_cam_voxel_prepass():
    """with_normals + cam_voxel_enabled: the per-camera voxel pass sees
    FLOAT unit normals in the rgb channel — the packed sort's
    integer-rgb gate must route them through the exact path, keeping the
    averaged directions intact (the multi-device configuration)."""
    import dataclasses
    cfg, intr, ext, depths = _flat_scene()
    cfg = dataclasses.replace(cfg, cam_voxel_enabled=True,
                              cam_voxel_leaf=0.01, cam_capacity=8192)
    out = stitch_step(cfg, intr, jnp.asarray(ext), jnp.asarray(depths))
    n, ok = decode_normals(out.cloud)
    n, ok = np.asarray(n), np.asarray(ok)
    mask = np.asarray(out.cloud.mask)
    assert ok.sum() > 0.9 * mask.sum()
    dots = n[ok] @ np.array([0.0, 0.0, -1.0], np.float32)
    assert np.all(dots > 0.99), dots.min()
