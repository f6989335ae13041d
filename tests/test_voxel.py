import numpy as np
import jax.numpy as jnp

from pointcloud_stitching_tpu import Intrinsics, PointCloud
from pointcloud_stitching_tpu.ops import (decimate_depth, deproject, fuse,
                                          voxel_downsample)
from oracle import deproject_np, synth_depth_frame, voxel_downsample_np


def _valid(pc):
    m = np.asarray(pc.mask)
    return np.asarray(pc.xyz)[m]


def test_voxel_matches_oracle_small(rng):
    pts = rng.uniform(-1, 1, size=(5000, 3)).astype(np.float32)
    pc = PointCloud.from_points(pts, capacity=8192)
    out = voxel_downsample(pc, 0.1, capacity=4096)
    ref, _ = voxel_downsample_np(pts, 0.1)
    got = _valid(out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_voxel_ordering_is_lexicographic(rng):
    pts = rng.uniform(0, 2, size=(2000, 3)).astype(np.float32)
    pc = PointCloud.from_points(pts)
    out = voxel_downsample(pc, 0.25, capacity=1024)
    got = _valid(out)
    ref, _ = voxel_downsample_np(pts, 0.25)
    # oracle is already in ascending (ix,iy,iz); exact row order must match
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_voxel_with_rgb(rng):
    pts = rng.uniform(-1, 1, size=(3000, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, size=(3000, 3)).astype(np.float32)
    pc = PointCloud.from_points(pts, rgb=rgb)
    out = voxel_downsample(pc, 0.2, capacity=2048)
    ref_xyz, ref_rgb = voxel_downsample_np(pts, 0.2, rgb=rgb)
    m = np.asarray(out.mask)
    np.testing.assert_allclose(np.asarray(out.xyz)[m], ref_xyz, atol=1e-4)
    np.testing.assert_allclose(np.asarray(out.rgb)[m], ref_rgb, atol=1e-3)


def test_voxel_capacity_overflow_drops_tail(rng):
    pts = rng.uniform(-5, 5, size=(4000, 3)).astype(np.float32)
    pc = PointCloud.from_points(pts)
    cap = 64
    out = voxel_downsample(pc, 0.05, capacity=cap)  # tiny leaf → >cap voxels
    assert int(out.count()) == cap
    ref, _ = voxel_downsample_np(pts, 0.05)
    # kept voxels are the first `cap` in key order
    np.testing.assert_allclose(_valid(out), ref[:cap], atol=1e-4)


def test_voxel_ignores_masked_points(rng):
    pts = rng.uniform(-1, 1, size=(100, 3)).astype(np.float32)
    pc_full = PointCloud.from_points(pts, capacity=256)
    out_full = voxel_downsample(pc_full, 0.3, capacity=128)
    # same points + garbage in masked slots must give identical result
    xyz_dirty = np.asarray(pc_full.xyz).copy()
    xyz_dirty[100:] = 77.7
    pc_dirty = PointCloud(xyz=jnp.asarray(xyz_dirty), mask=pc_full.mask)
    out_dirty = voxel_downsample(pc_dirty, 0.3, capacity=128)
    np.testing.assert_allclose(_valid(out_full), _valid(out_dirty))


def test_voxel_on_real_frame():
    depth = synth_depth_frame(seed=11)
    intr = dict(fx=421.5, fy=421.1, ppx=423.2, ppy=238.9)
    pc = deproject(depth, Intrinsics.create(**intr))
    out = voxel_downsample(pc, 0.05, capacity=65536)
    xyz_ref, mask_ref = deproject_np(depth, **intr)
    ref, _ = voxel_downsample_np(xyz_ref[mask_ref], 0.05)
    got = _valid(out)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-3)


def test_decimate_depth():
    depth = synth_depth_frame(seed=12)
    d2 = decimate_depth(depth, 2)
    assert d2.shape == (240, 424)
    np.testing.assert_array_equal(np.asarray(d2), depth[::2, ::2])


def test_fuse_then_voxel(rng):
    a = PointCloud.from_points(rng.uniform(-1, 1, (500, 3)).astype(np.float32),
                               capacity=1024)
    b = PointCloud.from_points(rng.uniform(-1, 1, (700, 3)).astype(np.float32),
                               capacity=1024)
    f = fuse([a, b])
    assert f.capacity == 2048
    assert int(f.count()) == 1200
    out = voxel_downsample(f, 0.2, capacity=2048)
    allpts = np.concatenate([_valid(a), _valid(b)])
    ref, _ = voxel_downsample_np(allpts, 0.2)
    np.testing.assert_allclose(_valid(out), ref, atol=1e-4)


def test_voxel_rgb_packed_matches_exact(rng):
    """Colored packed path (3-operand sort, RGB as a packed i32): at a
    fine leaf the fits-condition selects it, and the result must match the
    forced exact (8-operand) path within the offset quantisation bound."""
    pts = rng.uniform(-1, 1, size=(4000, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(4000, 3)).astype(np.float32)
    pc = PointCloud.from_points(pts, rgb=rgb)
    leaf = 0.02
    fast = voxel_downsample(pc, leaf, capacity=8192)
    slow = voxel_downsample(pc, leaf, capacity=8192,
                            packed="never")
    mf, ms = np.asarray(fast.mask), np.asarray(slow.mask)
    assert mf.sum() == ms.sum() > 100
    np.testing.assert_allclose(np.asarray(fast.xyz)[mf],
                               np.asarray(slow.xyz)[ms],
                               atol=leaf / 1024)
    # integer-valued colors: per-voxel means are exact on both paths
    np.testing.assert_allclose(np.asarray(fast.rgb)[mf],
                               np.asarray(slow.rgb)[ms], atol=1e-4)


def test_voxel_rgb_nonint_takes_exact_path(rng):
    """Non-integer RGB cannot pack losslessly: the traced fits-condition
    must route to the exact path even at a packed-eligible leaf."""
    pts = rng.uniform(-1, 1, size=(3000, 3)).astype(np.float32)
    rgb = rng.uniform(0, 255, size=(3000, 3)).astype(np.float32)
    pc = PointCloud.from_points(pts, rgb=rgb)
    out = voxel_downsample(pc, 0.02, capacity=8192)
    ref_xyz, ref_rgb = voxel_downsample_np(np.asarray(pts), 0.02,
                                           rgb=np.asarray(rgb))
    m = np.asarray(out.mask)
    assert m.sum() == len(ref_xyz)
    # exact-path accuracy (1e-5-class), NOT the packed leaf/1024 bound:
    # fractional colors survive untruncated
    np.testing.assert_allclose(np.asarray(out.rgb)[m], ref_rgb, atol=1e-3)
    np.testing.assert_allclose(np.asarray(out.xyz)[m], ref_xyz, atol=1e-5)


def test_voxel_rgb_packed_batched(rng):
    """Camera-batched colored packed path (the fused colored stream)."""
    pts = rng.uniform(-1, 1, size=(2, 3000, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, size=(2, 3000, 3)).astype(np.float32)
    mask = np.ones((2, 3000), bool)
    pc = PointCloud(xyz=jnp.asarray(pts), mask=jnp.asarray(mask),
                    rgb=jnp.asarray(rgb))
    fast = voxel_downsample(pc, 0.02, capacity=8192)
    slow = voxel_downsample(pc, 0.02, capacity=8192,
                            packed="never")
    for b in range(2):
        mf, ms = np.asarray(fast.mask[b]), np.asarray(slow.mask[b])
        assert mf.sum() == ms.sum() > 100
        np.testing.assert_allclose(np.asarray(fast.xyz[b])[mf],
                                   np.asarray(slow.xyz[b])[ms],
                                   atol=0.02 / 1024)
        np.testing.assert_allclose(np.asarray(fast.rgb[b])[mf],
                                   np.asarray(slow.rgb[b])[ms], atol=1e-4)
