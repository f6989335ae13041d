"""Point-cloud filters: passthrough / crop-box / radius outlier removal.

PCL-staple conditioning filters a rig operator coming from the reference
stack expects around the stitching loop (PCL: ``pcl::PassThrough``,
``pcl::CropBox``, ``pcl::RadiusOutlierRemoval``; the reference itself
applies only VoxelGrid — SURVEY.md §2.2 row 3 — but its PCL ecosystem
makes these the standard pre/post-processing vocabulary).

Design: filters never change shapes — they only clear validity
mask bits (fixed-shape padded buffers are the framework's invariant), so
they compose freely inside one jitted program with zero recompiles.
``fuse.compact`` re-packs survivors when a dense cloud is wanted.

Selection bounds (lo/hi/radius/min_neighbors) are all traced values: one
compiled program serves every setting.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud


def passthrough(pc: PointCloud, axis: int, lo, hi,
                invert: bool = False) -> PointCloud:
    """Keep points with lo <= p[axis] <= hi (pcl::PassThrough semantics:
    limits inclusive; ``invert`` = setNegative)."""
    v = pc.xyz[..., axis]
    keep = (v >= lo) & (v <= hi)
    if invert:
        keep = ~keep
    return pc.replace(mask=pc.mask & keep)


def crop_box(pc: PointCloud, lo, hi, invert: bool = False) -> PointCloud:
    """Keep points inside the axis-aligned box [lo, hi] (pcl::CropBox
    without the box transform; apply ops.se3 to the cloud for an oriented
    crop)."""
    lo = jnp.asarray(lo, jnp.float32)
    hi = jnp.asarray(hi, jnp.float32)
    keep = jnp.all((pc.xyz >= lo) & (pc.xyz <= hi), axis=-1)
    if invert:
        keep = ~keep
    return pc.replace(mask=pc.mask & keep)


def frustum_cull(pc: PointCloud, intr, extrinsic=None,
                 z_min=0.0, z_max=jnp.inf, invert: bool = False
                 ) -> PointCloud:
    """Keep points a camera actually sees (pcl::FrustumCulling role).

    The rig question this answers: which part of the fused world cloud is
    inside camera k's view? Points transform into the camera frame (the
    inverse of the camera→world ``extrinsic``, i.e. a .cal matrix —
    identity = the cloud is already camera-frame), project through the
    REAL intrinsics incl. distortion (ops.deproject.project — exact pixel
    frustum, not PCL's symmetric FOV-angle approximation), and survive
    when the pixel lands inside the image and z within [z_min, z_max].
    Mask-only, fixed shape; all bounds traced. ``invert`` keeps the
    complement (everything the camera does NOT see).
    """
    from .deproject import project
    from .se3 import se3_apply, se3_inverse
    xyz = pc.xyz
    if extrinsic is not None:
        xyz = se3_apply(se3_inverse(jnp.asarray(extrinsic, jnp.float32)),
                        xyz)
    uv, in_front = project(xyz, intr)
    z = xyz[..., 2]
    # pixel-AREA bounds (centers 0..w-1, areas extend half a pixel): the
    # sensor sees anything landing on a pixel, and a point deprojected
    # from the border pixel must round-trip inside (an f32 ulp past the
    # center would otherwise cull it)
    inside = (in_front & (z >= z_min) & (z <= z_max)
              & (uv[..., 0] >= -0.5) & (uv[..., 0] <= intr.width - 0.5)
              & (uv[..., 1] >= -0.5) & (uv[..., 1] <= intr.height - 0.5))
    if invert:
        inside = ~inside
    return pc.replace(mask=pc.mask & inside)


@partial(jax.jit, static_argnames=("query_tile", "ref_tile"))
def count_neighbors(pc: PointCloud, radius,
                    query_tile: int = 1024,
                    ref_tile: int = 1024) -> jax.Array:
    """Per-point count of OTHER valid points within ``radius`` (inclusive).

    Blockwise exact O(N^2) sweep: per query tile, a fori_loop over
    reference blocks accumulates counts from direct squared differences on
    the VPU ([tile, block, 3] broadcast — exact f32, no a^2+b^2-2ab
    cancellation at the decision boundary; same formulation as the NN
    kernel's 'vpu' distances, docs/KERNELS.md). Fixed [tile, block]
    working set, never an [N, N] matrix. Each point's self-match (d2 = 0)
    is subtracted, so exact duplicates count as neighbors of each other
    but no point counts itself. Invalid points count 0 and are never
    counted. Batched clouds ([B, N, 3]) map over the leading axis.
    """
    if pc.xyz.ndim == 3:
        return jax.lax.map(
            lambda args: count_neighbors(PointCloud(xyz=args[0], mask=args[1]),
                                         radius, query_tile=query_tile,
                                         ref_tile=ref_tile),
            (pc.xyz, pc.mask))
    xyz, mask = pc.xyz, pc.mask
    n = xyz.shape[0]
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))
    qt, rt = min(query_tile, n), min(ref_tile, n)
    nq = -(-n // qt)
    nr = -(-n // rt)
    # pad refs once; padded rows are invalid and never count
    pad_r = nr * rt - n
    rxyz = jnp.pad(xyz, ((0, pad_r), (0, 0)))
    rmask = jnp.pad(mask, (0, pad_r))
    qxyz = jnp.pad(xyz, ((0, nq * qt - n), (0, 0)))

    def query_block(qi):
        q = jax.lax.dynamic_slice(qxyz, (qi * qt, 0), (qt, 3))

        def ref_step(ri, acc):
            r = jax.lax.dynamic_slice(rxyz, (ri * rt, 0), (rt, 3))
            rm = jax.lax.dynamic_slice(rmask, (ri * rt,), (rt,))
            d = q[:, None, :] - r[None, :, :]              # [qt, rt, 3]
            d2 = jnp.sum(d * d, axis=-1)
            return acc + jnp.sum((d2 <= r2) & rm[None, :],
                                 axis=1).astype(jnp.int32)

        return jax.lax.fori_loop(0, nr, ref_step,
                                 jnp.zeros((qt,), jnp.int32))

    counts = jax.lax.map(query_block, jnp.arange(nq)).reshape(-1)[:n]
    # remove the self-match (every valid point sees its own d2 = 0)
    return jnp.where(mask, counts - 1, 0)


def radius_outlier_removal(pc: PointCloud, radius, min_neighbors,
                           query_tile: int = 1024,
                           ref_tile: int = 1024) -> PointCloud:
    """Drop points with fewer than ``min_neighbors`` OTHER points within
    ``radius`` (pcl::RadiusOutlierRemoval semantics with the self-match
    excluded). Mask-only, fixed shape; radius/min_neighbors are traced."""
    counts = count_neighbors(pc, radius, query_tile=query_tile,
                             ref_tile=ref_tile)
    return pc.replace(mask=pc.mask & (counts >= min_neighbors))


@partial(jax.jit, static_argnames=("k", "query_tile", "ref_tile"))
def knn_mean_distance(pc: PointCloud, k: int, query_tile: int = 512,
                      ref_tile: int = 1024) -> jax.Array:
    """Per-point mean distance to its k nearest OTHER valid points.

    Blockwise exact sweep with a running top-k: per query tile, each
    reference block's [tile, block] distances merge into the tile's k-best
    via one ``lax.top_k`` over [tile, k + block] (k is static and small, so
    the merge stays cheap and the working set fixed). Self-matches are
    excluded by global-index comparison, invalid points by +inf. Points
    with fewer than k valid co-points average over fewer (+inf distances
    are dropped from the mean); invalid queries return 0.
    """
    if pc.xyz.ndim == 3:
        return jax.lax.map(
            lambda args: knn_mean_distance(
                PointCloud(xyz=args[0], mask=args[1]), k,
                query_tile=query_tile, ref_tile=ref_tile),
            (pc.xyz, pc.mask))
    xyz, mask = pc.xyz, pc.mask
    n = xyz.shape[0]
    qt, rt = min(query_tile, n), min(ref_tile, n)
    nq, nr = -(-n // qt), -(-n // rt)
    inf = jnp.float32(jnp.inf)
    rxyz = jnp.pad(xyz, ((0, nr * rt - n), (0, 0)))
    rmask = jnp.pad(mask, (0, nr * rt - n))
    qxyz = jnp.pad(xyz, ((0, nq * qt - n), (0, 0)))

    def query_block(qi):
        q = jax.lax.dynamic_slice(qxyz, (qi * qt, 0), (qt, 3))
        qidx = qi * qt + jnp.arange(qt)

        def ref_step(ri, best):                      # best: [qt, k]
            r = jax.lax.dynamic_slice(rxyz, (ri * rt, 0), (rt, 3))
            rm = jax.lax.dynamic_slice(rmask, (ri * rt,), (rt,))
            ridx = ri * rt + jnp.arange(rt)
            d = q[:, None, :] - r[None, :, :]
            d2 = jnp.sum(d * d, axis=-1)             # [qt, rt]
            bad = (~rm)[None, :] | (qidx[:, None] == ridx[None, :])
            d2 = jnp.where(bad, inf, d2)
            merged = jnp.concatenate([best, d2], axis=1)
            return -jax.lax.top_k(-merged, k)[0]     # k smallest

        best = jax.lax.fori_loop(0, nr, ref_step,
                                 jnp.full((qt, k), inf))
        have = jnp.isfinite(best)
        dist = jnp.where(have, jnp.sqrt(jnp.maximum(best, 0.0)), 0.0)
        cnt = jnp.maximum(jnp.sum(have, axis=1), 1)
        return jnp.sum(dist, axis=1) / cnt.astype(jnp.float32)

    md = jax.lax.map(query_block, jnp.arange(nq)).reshape(-1)[:n]
    return jnp.where(mask, md, 0.0)


def statistical_outlier_removal(pc: PointCloud, k: int = 50,
                                std_ratio: float = 1.0,
                                query_tile: int = 512,
                                ref_tile: int = 1024) -> PointCloud:
    """pcl::StatisticalOutlierRemoval: drop points whose mean distance to
    their k nearest neighbors exceeds (global mean + std_ratio * global
    stddev) of that statistic over the cloud's valid points. ``k`` is
    static (it shapes the running top-k); ``std_ratio`` is traced."""
    md = knn_mean_distance(pc, k, query_tile=query_tile, ref_tile=ref_tile)
    m = pc.mask
    cnt = jnp.maximum(jnp.sum(m, axis=-1, keepdims=True), 1)
    mean = jnp.sum(jnp.where(m, md, 0.0), axis=-1, keepdims=True) / cnt
    # sample variance (n - 1 divisor), matching PCL's stddev computation
    var = jnp.sum(jnp.where(m, jnp.square(md - mean), 0.0), axis=-1,
                  keepdims=True) / jnp.maximum(cnt - 1, 1)
    thresh = mean + std_ratio * jnp.sqrt(var)
    return pc.replace(mask=m & (md <= thresh))


@partial(jax.jit, static_argnames=("radius",))
def bilateral_depth(depth: jax.Array, sigma_spatial=3.0, sigma_range=0.03,
                    radius: int = 6, depth_scale: float = 0.001
                    ) -> jax.Array:
    """Edge-preserving smoothing of an organized depth image.

    On-device role of ``pcl::FastBilateralFilter`` (PCL's organized-cloud
    denoiser; the reference sends raw sensor depth — SURVEY.md §3.1 — and
    D400 depth carries ~0.5-2% range noise that survives into the fused
    cloud). PCL approximates the bilateral with a downsampled bilateral
    grid because exact windows are slow on a CPU; on an accelerator the direct
    form IS the fast form — a (2*radius+1)^2 stack of statically shifted
    image reads, each a fused multiply-add over the whole [H, W] plane on
    the VPU, ~50 MB of HBM traffic per megapixel at the default radius.

    Args:
      depth: [..., H, W] uint16 raw units or float (any scale).
      sigma_spatial: traced Gaussian width in PIXELS.
      sigma_range: traced Gaussian width in METERS — edges deeper than a
        few sigma_range never blend, which is the edge-preserving part.
      radius: static window radius in pixels (support = 2*radius+1;
        make it >= ~2*sigma_spatial).
      depth_scale: meters per raw unit (only converts sigma_range's
        units; the OUTPUT stays in the input's raw units).

    Returns [..., H, W] float32 filtered depth in the input's raw units,
    0 where the input pixel was invalid (depth 0) — feed it straight to
    ``deproject`` with the same depth_scale.
    """
    z = depth.astype(jnp.float32)
    valid = z > 0
    inv2s = 0.5 / jnp.square(jnp.asarray(sigma_spatial, jnp.float32))
    # range sigma in raw units so the kernel never rescales the image
    sr = jnp.asarray(sigma_range, jnp.float32) / jnp.float32(depth_scale)
    inv2r = 0.5 / jnp.square(sr)

    r = radius
    pad = [(0, 0)] * (z.ndim - 2) + [(r, r), (r, r)]
    zp = jnp.pad(z, pad)
    vp = jnp.pad(valid, pad)
    h, w = z.shape[-2], z.shape[-1]

    num = jnp.zeros_like(z)
    den = jnp.zeros_like(z)
    for di in range(-r, r + 1):
        for dj in range(-r, r + 1):
            zs = jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(zp, r + di, r + di + h, axis=-2),
                r + dj, r + dj + w, axis=-1)
            vs = jax.lax.slice_in_dim(
                jax.lax.slice_in_dim(vp, r + di, r + di + h, axis=-2),
                r + dj, r + dj + w, axis=-1)
            ws = jnp.exp(-(di * di + dj * dj) * inv2s
                         - jnp.square(zs - z) * inv2r)
            ws = jnp.where(vs, ws, 0.0)
            num = num + ws * zs
            den = den + ws
    out = num / jnp.maximum(den, 1e-12)
    return jnp.where(valid, out, 0.0)
