"""Temporal voxel-map accumulator vs a numpy dict-based oracle.

The oracle is the contract for the map semantics: absolute biased voxel
keys, exponential weight decay with min-weight eviction, weight-averaged
centroids, ascending-key capacity truncation, max-weight rescaling.
"""
import numpy as np
import pytest

import jax.numpy as jnp

from pointcloud_stitching_tpu.models.voxel_map import (
    TemporalAccumulator, VoxelMap, localize, voxel_map_update)
from pointcloud_stitching_tpu.utils.types import PointCloud

from oracle import random_se3, transform_np

BIAS = np.array([16384, 32768, 32768])
BOUND = np.array([32766, 65534, 65534])


def oracle_update(state: dict, xyz, leaf, rgb=None, decay=1.0,
                  min_weight=0.05, max_weight=np.inf, capacity=1 << 20):
    """state: {(ix,iy,iz): [sx,sy,sz,w] or [sx,sy,sz,w,r,g,b]}."""
    out = {}
    for k, v in state.items():
        v = np.asarray(v, np.float64) * decay
        if v[3] >= min_weight:
            out[k] = v
    nch = 7 if rgb is not None else 4
    for i, p in enumerate(np.asarray(xyz, np.float64)):
        ijk = np.floor(p / leaf).astype(np.int64) + BIAS
        if np.any(ijk < 0) or np.any(ijk > BOUND):
            continue
        row = out.setdefault(tuple(ijk), np.zeros(nch))
        row[:3] += p
        row[3] += 1.0
        if rgb is not None:
            row[4:7] += np.asarray(rgb[i], np.float64)
    # capacity truncation in ascending key order, then max-weight rescale
    keys = sorted(out.keys())[:capacity]
    final = {}
    for k in keys:
        v = out[k]
        if v[3] > max_weight:
            v = v * (max_weight / v[3])
        final[k] = v
    return final


def map_to_dict(vm: VoxelMap) -> dict:
    ijk = np.asarray(vm.ijk)
    sums = np.asarray(vm.sums)
    w = np.asarray(vm.weight)
    occ = ijk[:, 0] != np.iinfo(np.int32).max
    d = {}
    for i in np.nonzero(occ)[0]:
        row = list(sums[i]) + [w[i]]
        if vm.rgb_sums is not None:
            row += list(np.asarray(vm.rgb_sums)[i])
        d[tuple(ijk[i])] = np.array(row)
    return d


def assert_maps_match(vm: VoxelMap, oracle: dict, atol=2e-4):
    got = map_to_dict(vm)
    assert set(got.keys()) == set(oracle.keys())
    for k in oracle:
        np.testing.assert_allclose(got[k], oracle[k], atol=atol, rtol=1e-5)


def cloud(xyz, rgb=None, capacity=None):
    return PointCloud.from_points(np.asarray(xyz, np.float32),
                                  rgb=None if rgb is None else
                                  np.asarray(rgb, np.float32),
                                  capacity=capacity)


def random_frames(rng, n_frames=4, n=600, scale=1.5, with_rgb=False):
    frames = []
    for _ in range(n_frames):
        xyz = rng.uniform(-scale, scale, size=(n, 3))
        rgb = rng.integers(0, 256, size=(n, 3)).astype(np.float32) \
            if with_rgb else None
        frames.append((xyz, rgb))
    return frames


def test_single_update_matches_oracle(rng):
    xyz = rng.uniform(-2, 2, size=(800, 3))
    vm = VoxelMap.create(4096, leaf=0.25)
    vm = voxel_map_update(vm, cloud(xyz, capacity=1024))
    assert_maps_match(vm, oracle_update({}, xyz, 0.25))


def test_accumulation_decay_eviction(rng):
    leaf, decay, min_w = 0.2, 0.6, 0.05
    vm = VoxelMap.create(4096, leaf=leaf)
    state = {}
    frames = random_frames(rng, n_frames=3, n=500)
    for xyz, _ in frames:
        vm = voxel_map_update(vm, cloud(xyz, capacity=640), decay=decay,
                              min_weight=min_w)
        state = oracle_update(state, xyz, leaf, decay=decay,
                              min_weight=min_w)
    assert_maps_match(vm, state)
    # stop feeding: weights decay until every voxel evicts
    empty = cloud(np.zeros((0, 3)), capacity=640)
    for _ in range(12):
        vm = voxel_map_update(vm, empty, decay=decay, min_weight=min_w)
        state = oracle_update(state, np.zeros((0, 3)), leaf, decay=decay,
                              min_weight=min_w)
    assert_maps_match(vm, state)
    assert int(vm.count()) == 0 and len(state) == 0


def test_rgb_and_max_weight(rng):
    leaf, max_w = 0.3, 2.5
    vm = VoxelMap.create(2048, leaf=leaf, with_rgb=True)
    state = {}
    for xyz, rgb in random_frames(rng, n_frames=5, n=400, with_rgb=True):
        vm = voxel_map_update(vm, cloud(xyz, rgb=rgb, capacity=512),
                              max_weight=max_w)
        state = oracle_update(state, xyz, leaf, rgb=rgb, max_weight=max_w)
    assert_maps_match(vm, state)
    assert float(jnp.max(vm.weight)) <= max_w + 1e-5
    # clamped weights preserve the running mean: as_cloud centroids match
    # the oracle's sum/weight
    pc = vm.as_cloud()
    got = map_to_dict(vm)
    for k, v in state.items():
        np.testing.assert_allclose(got[k][:3] / got[k][3], v[:3] / v[3],
                                   atol=2e-4)


def test_capacity_truncation(rng):
    xyz = rng.uniform(-2, 2, size=(600, 3))
    cap = 32
    vm = VoxelMap.create(cap, leaf=0.1)
    vm = voxel_map_update(vm, cloud(xyz, capacity=640))
    assert_maps_match(vm, oracle_update({}, xyz, 0.1, capacity=cap))
    assert int(vm.count()) == cap


def test_out_of_bounds_points_dropped():
    xyz = np.array([[0.0, 0.0, 0.0], [1e5, 0.0, 0.0], [0.0, -1e5, 0.0]])
    vm = VoxelMap.create(64, leaf=0.1)
    vm = voxel_map_update(vm, cloud(xyz))
    assert int(vm.count()) == 1  # only the in-bounds point lands


def test_as_cloud_min_weight(rng):
    vm = VoxelMap.create(1024, leaf=0.25)
    a = rng.uniform(-1, 1, size=(300, 3))
    vm = voxel_map_update(vm, cloud(a, capacity=384))
    vm = voxel_map_update(vm, cloud(a, capacity=384))  # every voxel w=2
    b = rng.uniform(-1, 1, size=(50, 3)) + 10.0       # one glimpse, w=1
    vm = voxel_map_update(vm, cloud(b, capacity=384))
    full = vm.as_cloud()
    strong = vm.as_cloud(min_weight=1.5)
    assert int(jnp.sum(strong.mask)) < int(jnp.sum(full.mask))
    # the masked-out voxels are exactly the single-observation ones
    assert int(jnp.sum(full.mask)) - int(jnp.sum(strong.mask)) \
        == int(jnp.sum((vm.weight > 0) & (vm.weight < 1.5)))


def test_leaf_rides_in_state(rng):
    # two maps with different leaves produce different voxelizations from
    # the same update call — leaf is state, not an update argument
    xyz = rng.uniform(-1, 1, size=(200, 3))
    fine = voxel_map_update(VoxelMap.create(2048, leaf=0.05), cloud(xyz))
    coarse = voxel_map_update(VoxelMap.create(2048, leaf=0.5), cloud(xyz))
    assert int(fine.count()) > int(coarse.count())


def test_localize_recovers_transform(rng):
    # build a map from a structured scene, shift a frame, localize it back
    n = 1500
    xyz = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                    np.sin(rng.uniform(-3, 3, n))], axis=-1)
    vm = VoxelMap.create(8192, leaf=0.03)
    vm = voxel_map_update(vm, cloud(xyz, capacity=2048))
    T = random_se3(seed=7, max_angle=0.05, max_trans=0.03)
    moved = cloud(transform_np(np.linalg.inv(T), xyz), capacity=2048)
    res = localize(vm, moved, iterations=15, max_corr_dist=0.2)
    np.testing.assert_allclose(np.asarray(res.T), T, atol=0.02)


def test_temporal_accumulator_wrapper(rng):
    acc = TemporalAccumulator(capacity=2048, leaf=0.2, decay=0.9,
                              min_weight=0.05)
    state = {}
    for xyz, _ in random_frames(rng, n_frames=4, n=300):
        acc.update(cloud(xyz, capacity=384))
        state = oracle_update(state, xyz, 0.2, decay=0.9)
    assert_maps_match(acc.state, state)
    pc = acc.cloud()
    assert int(jnp.sum(pc.mask)) == len(state)


def test_rgb_presence_mismatch_raises(rng):
    vm = VoxelMap.create(64, leaf=0.1)
    xyz = rng.uniform(-1, 1, size=(10, 3))
    with pytest.raises(ValueError):
        voxel_map_update(vm, cloud(xyz, rgb=np.zeros((10, 3))))


def test_accumulation_denoises(rng):
    """The README's denoising claim, quantified: K accumulated noisy
    observations cut centroid RMS error ~sqrt(K)x vs a single frame."""
    leaf = 0.25
    # ground-truth points at voxel centers so sensor noise never hops voxels
    grid = np.stack(np.meshgrid(*[np.arange(6)] * 3), -1).reshape(-1, 3)
    truth = (grid + 0.5) * leaf
    K, sigma = 16, 0.02

    def noisy():
        return truth + rng.normal(0, sigma, truth.shape)

    vm = VoxelMap.create(1024, leaf=leaf)
    first = None
    for k in range(K):
        vm = voxel_map_update(vm, cloud(noisy(), capacity=256))
        if k == 0:
            first = map_to_dict(vm)
    acc = map_to_dict(vm)
    assert set(acc.keys()) == set(first.keys())

    def rms(d):
        errs = []
        for k, v in d.items():
            c = v[:3] / v[3]
            t = (np.array(k) - BIAS + 0.5) * leaf
            errs.append(np.sum((c - t) ** 2))
        return np.sqrt(np.mean(errs))

    e1, eK = rms(first), rms(acc)
    # sqrt(16) = 4x ideal; demand >2.5x to leave room for sampling noise
    assert eK < e1 / 2.5, (e1, eK)


def test_save_load_roundtrip_and_resume(rng, tmp_path):
    """A checkpoint resumed mid-stream accumulates identically to an
    uninterrupted run (the resumable-state contract of save_map/load_map)."""
    from pointcloud_stitching_tpu.models.voxel_map import load_map, save_map

    frames = [rng.uniform(-1, 1, size=(300, 3)) for _ in range(4)]
    kw = dict(decay=0.9, min_weight=0.05)

    vm_full = VoxelMap.create(2048, leaf=0.1)
    for f in frames:
        vm_full = voxel_map_update(vm_full, cloud(f, capacity=512), **kw)

    vm_a = VoxelMap.create(2048, leaf=0.1)
    for f in frames[:2]:
        vm_a = voxel_map_update(vm_a, cloud(f, capacity=512), **kw)
    path = str(tmp_path / "ckpt.npz")
    save_map(path, vm_a)
    vm_b = load_map(path)
    assert float(vm_b.leaf) == pytest.approx(0.1)
    for f in frames[2:]:
        vm_b = voxel_map_update(vm_b, cloud(f, capacity=512), **kw)
    assert_maps_match(vm_b, map_to_dict(vm_full))


def test_load_map_resize(rng, tmp_path):
    """capacity= on load pads with empty slots (grow) or keeps the
    highest-weight voxels (shrink)."""
    from pointcloud_stitching_tpu.models.voxel_map import load_map, save_map

    vm = VoxelMap.create(512, leaf=0.1)
    # two updates of the same first 100 points -> those voxels have weight 2
    base = rng.uniform(-1, 1, size=(200, 3))
    vm = voxel_map_update(vm, cloud(base, capacity=256))
    vm = voxel_map_update(vm, cloud(base[:100], capacity=256))
    path = str(tmp_path / "m.npz")
    save_map(path, vm)

    big = load_map(path, capacity=1024)
    assert big.capacity == 1024
    assert_maps_match(big, map_to_dict(vm))

    heavy = {k for k, v in map_to_dict(vm).items() if v[3] > 1.5}
    small = load_map(path, capacity=len(heavy))
    got = set(map_to_dict(small).keys())
    assert got == heavy  # shrink keeps the most-evidenced voxels


def test_accumulator_save_load_rgb(rng, tmp_path):
    """TemporalAccumulator.save/load round-trips color state and the loaded
    accumulator keeps updating."""
    acc = TemporalAccumulator(capacity=1024, leaf=0.1, with_rgb=True)
    xyz = rng.uniform(-1, 1, size=(200, 3))
    rgb = rng.uniform(0, 255, size=(200, 3))
    acc.update(cloud(xyz, rgb=rgb, capacity=256))
    path = str(tmp_path / "acc.npz")
    acc.save(path)
    acc2 = TemporalAccumulator.load(path)
    assert acc2.state.rgb_sums is not None
    assert_maps_match(acc2.state, map_to_dict(acc.state))
    acc2.update(cloud(xyz, rgb=rgb, capacity=256))  # resumes cleanly
    assert int(acc2.state.count()) == int(acc.state.count())
