"""Voxel-grid downsampling with fixed-capacity output.

On-device equivalent of ``pcl::VoxelGrid<pcl::PointXYZRGB>`` (reference:
src/pcs-multicamera-client.cpp applies it to the fused cloud before rendering;
SURVEY.md §2.2 row 3).

PCL semantics reproduced here (the numpy oracle in tests/oracle.py is the
contract):
  * per-axis voxel index  ijk = floor(p / leaf) - floor(min_p / leaf)
  * one output point per occupied voxel = centroid (mean) of its points
  * output ordered by ascending (ix, iy, iz)

Uniquing is sort-based: ``lax.sort`` with a two-key lexicographic voxel
key (packed (ix,iy), then iz — avoids the reference's int32 linearised-index
overflow), then a segment boundary pass, then per-segment mean through
``jax.ops.segment_sum`` over sorted ids (a scatter-add on the GPU).

Everything is fixed shape: invalid inputs sort to the end under a sentinel
key, voxels beyond ``capacity`` fall into a discard bucket, and the output
carries a validity mask. One compiled program serves every frame.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud

_SENTINEL = jnp.iinfo(jnp.int32).max


def voxel_indices(xyz: jax.Array, mask: jax.Array, leaf: jax.Array):
    """Per-axis int32 voxel indices (PCL convention), sentinel for invalid."""
    inv = 1.0 / jnp.asarray(leaf, jnp.float32)
    f = jnp.floor(xyz * inv).astype(jnp.int32)  # floor(p/leaf)
    big = jnp.iinfo(jnp.int32).max
    fm = jnp.where(mask[..., None], f, big)
    min_ijk = jnp.min(fm, axis=-2, keepdims=True)  # floor(min_p/leaf) per axis
    ijk = f - min_ijk
    ijk = jnp.where(mask[..., None], ijk, _SENTINEL)
    return ijk


# --- packed-operand sort path ------------------------------------------------
#
# lax.sort moves every operand through every pass, so its cost grows with
# the operand count. When the frame allows it we sort TWO operands instead
# of five:
#
#   key  : the PCL-order linearised voxel index (ix*ny + iy)*nz + iz built
#          from the frame's *runtime* extents (traced — no recompile), valid
#          whenever nx*ny*nz < 2^30 (PCL's own VoxelGrid refuses scenes past
#          the same int32-index class);
#   off  : 3x10-bit quantised in-voxel offsets (p*inv - floor(p*inv), in
#          units of leaf/1024), reconstructing each coordinate to within
#          leaf/2048 (5 um at the flagship 1 cm leaf).
#
# Reconstruction error must stay far inside the oracle tolerance (1e-4 m),
# so the packed path additionally requires leaf <= _PACK_MAX_LEAF (15 um
# worst case). Both conditions are traced values; `voxel_downsample` selects
# the branch with lax.cond, so big scenes / coarse leaves silently keep the
# exact path. RGB rides as a third packed operand (24 bits of an i32, mean
# exact), so a colored cloud sorts 3 operands instead of the exact path's 8.

_PACK_MAX_LEAF = 0.03
_PACK_MAX_CELLS = float(2 ** 30)


def _extents(ijk):
    """Per-axis occupied extent (nx, ny, nz) of sentinel-masked indices."""
    valid = ijk[..., 0] != _SENTINEL
    mx = jnp.max(jnp.where(valid[..., None], ijk, -1), axis=-2)  # [..., 3]
    return mx + 1  # all-invalid cloud -> extent 0


def _sorted_segments_packed(pc: PointCloud, leaf, ijk):
    """Packed-operand sort: linearised key + quantised offsets (+ RGB).

    Returns (flags, vals [..., N, 7 or 10], min_ijk). The channels are all
    small integers — [ix·flag, iy·flag, iz·flag, q0, q1, q2, 1] plus
    [r, g, b] for colored clouds — so their f32 segment sums are exact.
    The per-axis voxel
    index lands only on each segment's first row (flag-masked: exactly one
    contribution per segment survives the sum), the offsets sum over the
    whole segment, and the centroid reconstructs in _finalize_packed as
    (base + (Σq/n + ½)/1024)·leaf — algebraically the same mean the exact
    path computes, quantised at leaf/2048. RGB rides as a third packed
    operand (24 bits of an i32): a colored cloud sorts 3 operands instead
    of the exact path's 8, and its per-voxel mean is exact (8-bit
    integers).
    """
    xyz, mask = pc.xyz, pc.mask
    inv = 1.0 / jnp.asarray(leaf, jnp.float32)
    ext = _extents(ijk)
    ny = jnp.maximum(ext[..., 1:2], 1)
    nz = jnp.maximum(ext[..., 2:3], 1)
    key = (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]
    key = jnp.where(mask, key, _SENTINEL)

    # in-voxel offsets in units of leaf/1024 (round-to-floor of the exact
    # f32 fractional part; reconstruction adds the half-bin back)
    frac = xyz * inv - jnp.floor(xyz * inv)            # [..., N, 3] in [0,1)
    oq = jnp.clip((frac * 1024.0).astype(jnp.int32), 0, 1023)
    off = (oq[..., 0] << 20) | (oq[..., 1] << 10) | oq[..., 2]

    has_rgb = pc.rgb is not None
    operands = [key, off]
    if has_rgb:
        rq = jnp.clip(pc.rgb.astype(jnp.int32), 0, 255)
        operands.append((rq[..., 0] << 16) | (rq[..., 1] << 8) | rq[..., 2])

    # unstable: a stable sort costs more, and within-voxel order is
    # irrelevant here — the packed path sums exact integer channels, so
    # the result is bit-identical either way
    sorted_ops = jax.lax.sort(operands, num_keys=1, is_stable=False)
    skey, soff = sorted_ops[0], sorted_ops[1]
    valid = skey != _SENTINEL

    # unpack key -> per-axis voxel indices (relative to min_ijk)
    sk = jnp.where(valid, skey, 0)
    iz = sk % nz
    t = sk // nz
    iy = t % ny
    ix = t // ny
    big = jnp.iinfo(jnp.int32).max
    fm = jnp.where(mask[..., None], jnp.floor(xyz * inv).astype(jnp.int32),
                   big)
    min_ijk = jnp.min(fm, axis=-2, keepdims=True)

    prev = lambda a: jnp.concatenate(
        [jnp.full_like(a[..., :1], -1), a[..., :-1]], axis=-1)
    flags = (skey != prev(skey)) & valid
    f = flags.astype(jnp.float32)
    q = jnp.stack([(soff >> 20) & 1023, (soff >> 10) & 1023, soff & 1023],
                  axis=-1).astype(jnp.float32)
    chans = [
        jnp.stack([ix, iy, iz], axis=-1).astype(jnp.float32) * f[..., None],
        q,
        jnp.ones((*f.shape, 1), jnp.float32)]
    if has_rgb:
        srgb = sorted_ops[2]
        chans.append(jnp.stack([(srgb >> 16) & 255, (srgb >> 8) & 255,
                                srgb & 255], axis=-1).astype(jnp.float32))
    vals = jnp.concatenate(chans, axis=-1)
    vals = jnp.where(valid[..., None], vals, 0.0)
    return flags, vals, min_ijk


def _sorted_segments(pc: PointCloud, leaf, capacity: int):
    """Sort by voxel key; return (seg ids clamped to [0, capacity],
    channel matrix [N, ch] zeroed on dropped rows). Works on [N] or [B, N]."""
    xyz, mask = pc.xyz, pc.mask
    ijk = voxel_indices(xyz, mask, leaf)
    # pack (ix, iy) into one key: one fewer sort operand. Per-axis index
    # range is extent/leaf; the clamp bounds it at ~327 m / 655 m of scene
    # extent at 1 cm leaves (same practical-limit class as PCL's int32
    # linearised leaf index). iz keeps full range as the second key.
    kx = jnp.minimum(ijk[..., 0], 32766)
    ky = jnp.minimum(ijk[..., 1], 65534)
    kz = ijk[..., 2]
    k1 = jnp.where(ijk[..., 0] == _SENTINEL, _SENTINEL, kx * 65536 + ky)

    operands = [k1, kz, xyz[..., 0], xyz[..., 1], xyz[..., 2]]
    has_rgb = pc.rgb is not None
    if has_rgb:
        operands += [pc.rgb[..., 0], pc.rgb[..., 1], pc.rgb[..., 2]]
    # unstable: within-voxel order only permutes the f32 centroid summation
    # (ulp-level, same class as PCL's own input-order dependence)
    sorted_ops = jax.lax.sort(operands, num_keys=2, is_stable=False)
    sk1, skz = sorted_ops[0], sorted_ops[1]
    sxyz = jnp.stack(sorted_ops[2:5], axis=-1)
    srgb = jnp.stack(sorted_ops[5:8], axis=-1) if has_rgb else None

    valid = sk1 != _SENTINEL
    prev = lambda a: jnp.concatenate(
        [jnp.full_like(a[..., :1], -1), a[..., :-1]], axis=-1)
    is_new = (sk1 != prev(sk1)) | (skz != prev(skz))
    flags = is_new & valid

    chans = [sxyz, jnp.ones((*sxyz.shape[:-1], 1), jnp.float32)]
    if has_rgb:
        chans.append(srgb)
    vals = jnp.concatenate(chans, axis=-1)          # [..., N, 4(+3)]
    vals = jnp.where(valid[..., None], vals, 0.0)
    return flags, vals, has_rgb


def _flags_to_seg(flags, capacity: int):
    """Boundary flags → clamped segment ids (slot ``capacity`` discards)."""
    seg = jnp.cumsum(flags.astype(jnp.int32), axis=-1) - 1
    return jnp.where((seg >= 0) & (seg < capacity), seg, capacity)


def _finalize(sums: jax.Array, has_rgb: bool) -> PointCloud:
    counts = sums[..., 3]
    out_mask = counts > 0.0
    denom = jnp.maximum(counts, 1.0)[..., None]
    out_xyz = jnp.where(out_mask[..., None], sums[..., :3] / denom, 0.0)
    out_rgb = None
    if has_rgb:
        out_rgb = jnp.where(out_mask[..., None], sums[..., 4:7] / denom, 0.0)
    return PointCloud(xyz=out_xyz, mask=out_mask, rgb=out_rgb)


def _finalize_packed(sums: jax.Array, min_ijk: jax.Array, leaf,
                     has_rgb: bool = False) -> PointCloud:
    """Centroids from integer-channel sums [ix, iy, iz, Σq0, Σq1, Σq2, n
    (+ Σr, Σg, Σb)]: (base + (Σq/n + ½)/1024)·leaf — the same mean the
    exact path computes, quantised at leaf/2048; RGB mean is exact."""
    counts = sums[..., 6]
    out_mask = counts > 0.0
    denom = jnp.maximum(counts, 1.0)[..., None]
    base = sums[..., :3] + min_ijk.astype(jnp.float32)
    mean_q = sums[..., 3:6] / denom
    lf = jnp.asarray(leaf, jnp.float32)
    xyz = (base + (mean_q + 0.5) * (1.0 / 1024.0)) * lf
    rgb = None
    if has_rgb:
        rgb = jnp.where(out_mask[..., None], sums[..., 7:10] / denom, 0.0)
    return PointCloud(xyz=jnp.where(out_mask[..., None], xyz, 0.0),
                      mask=out_mask, rgb=rgb)


def _reduce_xla(flags, vals, capacity: int):
    seg = _flags_to_seg(flags, capacity)
    return jax.ops.segment_sum(vals, seg, num_segments=capacity + 1,
                               indices_are_sorted=True)[:capacity]


@partial(jax.jit, static_argnames=("capacity", "packed"))
def voxel_downsample(pc: PointCloud, leaf, capacity: int,
                     packed: str = "auto") -> PointCloud:
    """Downsample to one centroid per occupied voxel; output padded to capacity.

    Args:
      pc: PointCloud with xyz [N, 3] or camera-batched [B, N, 3] (+mask).
      leaf: voxel edge length in meters (scalar, traced — no recompile on change).
      capacity: static per-cloud output size. Voxels past capacity drop.
      packed: 'auto' | 'never' — 'auto' switches (at runtime, via lax.cond)
        to the packed sort (2 operands, 3 with RGB) when the scene extents
        fit 2^30 voxel cells AND leaf <= 0.03 m (xyz reconstruction error
        <= leaf/2048, far inside the oracle tolerance; RGB means exact).
        'never' forces the exact 5/8-operand sort unconditionally.
    """
    batched = pc.xyz.ndim == 3

    def reduce_fn(flags, vals):
        if batched:
            return jax.vmap(
                lambda s, v: _reduce_xla(s, v, capacity))(flags, vals)
        return _reduce_xla(flags, vals, capacity)

    has_rgb = pc.rgb is not None
    if packed == "never":
        flags, vals, has_rgb = _sorted_segments(pc, leaf, capacity)
        return _finalize(reduce_fn(flags, vals), has_rgb)

    ijk = voxel_indices(pc.xyz, pc.mask, leaf)
    ext = _extents(ijk)
    cells = jnp.prod(ext.astype(jnp.float32), axis=-1)
    # per-axis extent <= 2^16 keeps each index channel within 16 bits, the
    # range the packed path has been checked over
    fits = (jnp.all(cells <= _PACK_MAX_CELLS)
            & jnp.all(ext <= 65536)
            & (jnp.asarray(leaf, jnp.float32) <= _PACK_MAX_LEAF))
    if has_rgb:
        # the RGB operand packs 8-bit integers; wire colors are exactly
        # that, but the public API accepts arbitrary floats — only pack
        # when packing is lossless (traced, like the other conditions)
        fits = fits & jnp.all(pc.rgb == jnp.round(pc.rgb)) \
            & jnp.all((pc.rgb >= 0) & (pc.rgb <= 255))

    def fast(_):
        flags, vals, min_ijk = _sorted_segments_packed(pc, leaf, ijk)
        sums = reduce_fn(flags, vals)
        out = _finalize_packed(sums, min_ijk, leaf, has_rgb)
        return (out.xyz, out.mask, out.rgb) if has_rgb \
            else (out.xyz, out.mask)

    def slow(_):
        flags, vals, _hr = _sorted_segments(pc, leaf, capacity)
        out = _finalize(reduce_fn(flags, vals), has_rgb)
        return (out.xyz, out.mask, out.rgb) if has_rgb \
            else (out.xyz, out.mask)

    parts = jax.lax.cond(fits, fast, slow, None)
    if has_rgb:
        return PointCloud(xyz=parts[0], mask=parts[1], rgb=parts[2])
    return PointCloud(xyz=parts[0], mask=parts[1])


def decimate_depth(depth: jax.Array, stride: int) -> jax.Array:
    """Grid-stride decimation of a depth image before deprojection.

    Equivalent of the reference camera server's downsample flag (stride
    subsampling of the frame to cut bandwidth; SURVEY.md §2.1 'Voxel-grid
    downsample / decimation' row, server side).
    """
    if stride <= 1:
        return depth
    return depth[..., ::stride, ::stride]
