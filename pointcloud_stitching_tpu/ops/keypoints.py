"""Intrinsic Shape Signatures keypoint detection on fixed-shape clouds.

On-device role of ``pcl::ISSKeypoint3D`` (Zhong, ICCV-W 2009) — the
standard detector in PCL's keypoints -> descriptors -> correspondences
pipeline: keep only points whose local neighborhood has genuinely 3-D
structure (three well-separated scatter eigenvalues), then thin them to
local saliency maxima. Pairs with ops/fpfh.py: computing descriptors at
keypoints only cuts the matching problem by an order of magnitude while
keeping the repeatable, geometry-rich points.

PCL's implementation is a serial KD-tree crawl per point. Here every
stage is a blockwise all-pairs sweep (ops/sweep.py):

  1. neighbor counts within ``salient_radius`` -> each point's density
     weight w_i = 1/count_i (ISS's density compensation, so oversampled
     patches don't dominate their neighbors' scatter matrices),
  2. weighted scatter matrices accumulate per block; one batched
     ``eigvalsh`` yields eigenvalues l1 >= l2 >= l3 for every point at
     once,
  3. the eigenvalue-ratio tests l2/l1 < gamma_21, l3/l2 < gamma_32
     (distinct principal directions = a true 3-D feature; planes fail
     the first, edges the second) gate eligibility; saliency = l3,
  4. non-maximum suppression is one more sweep: a point survives iff its
     saliency is the maximum within ``non_max_radius``.

Everything fixed-shape and traced (radii/gammas are operands, never
recompile); cost O(N^2) per sweep — analysis scale, like the other
scene ops. Returns a mask, composing with the framework's mask-only
philosophy (feed ``pc.replace(mask=pc.mask & kp)`` to fpfh/match).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud
from .sweep import blockwise_accumulate


@partial(jax.jit, static_argnames=("query_tile", "ref_tile"))
def iss_keypoints(pc: PointCloud, salient_radius, non_max_radius=None,
                  gamma_21=0.975, gamma_32=0.975,
                  min_neighbors: int | jax.Array = 5,
                  query_tile: int = 256, ref_tile: int = 512):
    """ISS keypoints (pcl::ISSKeypoint3D role).

    Args:
      pc: cloud [N, 3] + mask.
      salient_radius: scatter-matrix neighborhood (meters, traced); PCL
        guidance is ~6x the cloud resolution.
      non_max_radius: suppression radius (traced; default = salient_radius;
        PCL guidance ~4x resolution).
      gamma_21, gamma_32: eigenvalue-ratio thresholds (traced; PCL
        defaults 0.975).
      min_neighbors: eligibility floor on OTHER in-radius points (traced).

    Returns (keypoints [N] bool, saliency [N] float32 = smallest scatter
    eigenvalue, 0 where ineligible).
    """
    xyz, mask = pc.xyz, pc.mask
    r2 = jnp.square(jnp.asarray(salient_radius, jnp.float32))
    nm2 = r2 if non_max_radius is None else \
        jnp.square(jnp.asarray(non_max_radius, jnp.float32))

    # pass 1: in-radius counts -> density weights
    def count_step(q, qv, qe, r, rv, re):
        d = q[:, None, :] - r[None, :, :]
        d2 = jnp.sum(d * d, axis=-1)
        inside = (d2 <= r2) & qv[:, None] & rv[None, :]
        return jnp.sum(inside.astype(jnp.float32), axis=1)

    cnt = blockwise_accumulate(xyz, mask, [], query_tile, ref_tile,
                               count_step)                  # incl. self
    wgt = 1.0 / jnp.maximum(cnt, 1.0)

    # pass 2: density-weighted scatter matrices (keep a [3, 3] PER POINT —
    # unlike the MLS moments there is no mean subtraction: ISS scatters
    # neighbor offsets around the QUERY point itself)
    def scatter_step(q, qv, qe, r, rv, re):
        rw = re[0]
        d = r[None, :, :] - q[:, None, :]                   # [qt, rt, 3]
        d2 = jnp.sum(d * d, axis=-1)
        inside = (d2 <= r2) & (d2 > 1e-12) & qv[:, None] & rv[None, :]
        w = jnp.where(inside, rw[None, :], 0.0)
        scat = jnp.einsum("qr,qri,qrj->qij", w, d, d,
                          precision="highest")              # [qt, 3, 3]
        return scat, jnp.sum(w, axis=1), \
            jnp.sum(inside.astype(jnp.float32), axis=1)

    scat, wsum, k = blockwise_accumulate(xyz, mask, [wgt], query_tile,
                                         ref_tile, scatter_step)
    scat = scat / jnp.maximum(wsum, 1e-12)[:, None, None]
    vals = jnp.linalg.eigvalsh(scat + 1e-12 * jnp.eye(3, dtype=jnp.float32))
    vals = jnp.maximum(vals, 0.0)                            # ascending
    l3, l2, l1 = vals[:, 0], vals[:, 1], vals[:, 2]

    g21 = jnp.asarray(gamma_21, jnp.float32)
    g32 = jnp.asarray(gamma_32, jnp.float32)
    eligible = mask & (k >= jnp.asarray(min_neighbors, jnp.float32)) \
        & (l2 < g21 * l1) & (l3 < g32 * l2) & (l3 > 0)
    saliency = jnp.where(eligible, l3, 0.0)

    # pass 3: non-maximum suppression — survive iff no in-radius neighbor
    # is MORE salient (strictly; exact ties both survive, measure-zero)
    def nms_step(q, qv, qe, r, rv, re):
        qs, rs = qe[0], re[0]
        d = q[:, None, :] - r[None, :, :]
        d2 = jnp.sum(d * d, axis=-1)
        inside = (d2 <= nm2) & qv[:, None] & rv[None, :]
        beaten = inside & (rs[None, :] > qs[:, None])
        return jnp.sum(beaten.astype(jnp.int32), axis=1)

    n_beaten = blockwise_accumulate(xyz, eligible, [saliency], query_tile,
                                    ref_tile, nms_step)
    keypoints = eligible & (n_beaten == 0)
    return keypoints, saliency
