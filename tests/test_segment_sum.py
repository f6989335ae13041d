"""The voxel pass's sorted-id segment sum (ops.voxel._reduce_xla) vs numpy.

Shapes follow what the voxel grid feeds it: boundary flags over a key-sorted
stream, a discard tail, capacities that do not divide anything, overflow
past capacity, and the camera-batched (vmapped) form.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pointcloud_stitching_tpu import PointCloud
from pointcloud_stitching_tpu.ops import voxel_downsample
from pointcloud_stitching_tpu.ops.voxel import _reduce_xla
from oracle import voxel_downsample_np


def _reduce_np(flags, vals, capacity):
    """Segment ids from boundary flags; ids >= capacity are discarded."""
    seg = np.cumsum(flags.astype(np.int64)) - 1
    out = np.zeros((capacity + 1, vals.shape[-1]), np.float64)
    np.add.at(out, np.where((seg >= 0) & (seg < capacity), seg, capacity),
              vals.astype(np.float64))
    return out[:capacity]


def _flags(rng, n, p_new=0.4, discard_frac=0.0):
    flags = (rng.random(n) < p_new).astype(np.int32)
    flags[0] = 1
    k = int(n * (1 - discard_frac))
    flags[k:] = 0                        # sentinel tail: rows join no segment
    return flags


@pytest.mark.parametrize("n,capacity", [(1000, 256), (5000, 4096),
                                        (512, 512), (130, 1000)])
def test_reduce_matches_numpy(rng, n, capacity):
    flags = _flags(rng, n)
    vals = rng.normal(size=(n, 8)).astype(np.float32)
    got = _reduce_xla(jnp.asarray(flags), jnp.asarray(vals), capacity)
    assert got.shape == (capacity, 8)
    np.testing.assert_allclose(np.asarray(got),
                               _reduce_np(flags, vals, capacity), atol=1e-4)


def test_reduce_leading_rows_before_first_flag_are_discarded(rng):
    """Rows ahead of the first boundary (id -1) land in the discard slot."""
    n, capacity = 256, 64
    flags = _flags(rng, n)
    flags[:10] = 0
    vals = rng.normal(size=(n, 8)).astype(np.float32)
    got = _reduce_xla(jnp.asarray(flags), jnp.asarray(vals), capacity)
    np.testing.assert_allclose(np.asarray(got),
                               _reduce_np(flags, vals, capacity), atol=1e-4)


def test_reduce_unaligned_capacity_with_overflow(rng):
    """Far more segments than capacity, capacity not a power of two: every
    id < capacity is summed, every later one discarded."""
    n, capacity = 8192, 1000
    flags = _flags(rng, n, p_new=0.3)
    assert flags.sum() > capacity
    vals = rng.normal(size=(n, 8)).astype(np.float32)
    got = _reduce_xla(jnp.asarray(flags), jnp.asarray(vals), capacity)
    np.testing.assert_allclose(np.asarray(got),
                               _reduce_np(flags, vals, capacity), atol=1e-4)


def test_reduce_exact_for_integer_channels(rng):
    """The packed voxel path sums small-integer channels (voxel indices
    <= 65534, 10-bit offsets, counts): f32 sums of those are exact."""
    n, capacity = 4000, 1024
    flags = _flags(rng, n, p_new=0.05)
    vals = rng.integers(0, 1024, size=(n, 7)).astype(np.float32)
    got = _reduce_xla(jnp.asarray(flags), jnp.asarray(vals), capacity)
    np.testing.assert_array_equal(np.asarray(got),
                                  _reduce_np(flags, vals, capacity))


@pytest.mark.parametrize("batch", [1, 3])
def test_reduce_batched_vmap(rng, batch):
    """The camera-batched form voxel_downsample uses: vmap over clouds,
    each with its own segments and discard slot."""
    n, capacity = 700, 200
    flags = np.stack([_flags(rng, n, discard_frac=0.2)
                      for _ in range(batch)])
    vals = rng.normal(size=(batch, n, 8)).astype(np.float32)
    got = jax.vmap(lambda f, v: _reduce_xla(f, v, capacity))(
        jnp.asarray(flags), jnp.asarray(vals))
    for b in range(batch):
        np.testing.assert_allclose(np.asarray(got[b]),
                                   _reduce_np(flags[b], vals[b], capacity),
                                   atol=1e-4)


def test_voxel_packed_integer_channels_match_exact(rng):
    """The packed (integer-channel) voxel path agrees with the exact
    five-operand path within its leaf/2048 reconstruction quantum."""
    pts = rng.uniform(-2, 2, size=(6000, 3)).astype(np.float32)
    mask = rng.random(6000) < 0.9
    pc = PointCloud(xyz=jnp.asarray(pts), mask=jnp.asarray(mask))
    leaf = 0.02
    a = voxel_downsample(pc, leaf, capacity=8192)
    b = voxel_downsample(pc, leaf, capacity=8192, packed="never")
    np.testing.assert_array_equal(np.asarray(a.mask), np.asarray(b.mask))
    m = np.asarray(a.mask)
    np.testing.assert_allclose(np.asarray(a.xyz)[m], np.asarray(b.xyz)[m],
                               atol=leaf / 2048 * 1.01)


def test_voxel_batched_matches_oracle_per_cloud(rng):
    pts = rng.uniform(-1, 1, size=(3, 500, 3)).astype(np.float32)
    pc = PointCloud(xyz=jnp.asarray(pts), mask=jnp.ones((3, 500), bool))
    out = voxel_downsample(pc, 0.2, capacity=512)
    for b in range(3):
        want, _ = voxel_downsample_np(pts[b], 0.2)
        m = np.asarray(out.mask[b])
        assert m.sum() == len(want)
        np.testing.assert_allclose(np.asarray(out.xyz[b])[m], want,
                                   atol=1e-4)
