"""Viewpoint Feature Histogram — one global descriptor per cloud/object.

On-device role of ``pcl::VFHEstimation`` (Rusu et al., IROS 2010): where
FPFH describes a POINT's neighborhood, VFH describes a whole segmented
object with a single 308-dim vector — the classic recognition pipeline is
``pcs-segment``-style cluster extraction, then one VFH per cluster, then
nearest-descriptor lookup against a model library (``match_fpfh`` works
unchanged on any fixed-width descriptor, VFH included).

Structure (dimensions, in this layout order):
  [0:45)    alpha — Darboux angle of every (centroid -> point) pair
  [45:90)   phi
  [90:135)  theta
  [135:180) point distance from the centroid, normalized by the max
  [180:308) viewpoint component: cos of the angle between each point's
            normal and the centroid's viewpoint direction, 128 bins

Every pair uses the SAME shared Darboux math as FPFH (ops.fpfh.pair_angles
— one source-selection rule across the descriptor family). Each block is
normalized to sum 100, PCL's convention. Unlike FPFH there is no radius
search at all — every stage is a single vectorized pass over the cloud
(one-hot histogram reductions), so a VFH costs O(N).

PCL's exact bin ORDER within VFHSignature308 is an implementation detail
of its serial loops; this layout is the contract here (documented above,
fixed by tests/test_vfh.py's oracle) — descriptors are only ever compared
against descriptors computed by the same code.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud
from .fpfh import pair_angles

VFH_ANGLE_BINS = 45
VFH_VP_BINS = 128
VFH_DIM = 4 * VFH_ANGLE_BINS + VFH_VP_BINS     # 308


def _hist(x, lo, hi, wgt, bins):
    b = jnp.clip(jnp.floor((x - lo) * (bins / (hi - lo))).astype(jnp.int32),
                 0, bins - 1)
    iota = jnp.arange(bins, dtype=jnp.int32)
    h = jnp.sum(jnp.where(b[:, None] == iota, wgt[:, None], 0.0), axis=0)
    s = jnp.sum(h)
    return jnp.where(s > 0, 100.0 * h / jnp.maximum(s, 1e-12), 0.0)


@jax.jit
def vfh(pc: PointCloud, normals: jax.Array,
        normals_valid: jax.Array | None = None,
        viewpoint=(0.0, 0.0, 0.0)):
    """308-dim global descriptor of a cloud (pcl::VFHEstimation role).

    Args:
      pc: cloud [N, 3] + mask — typically one extracted cluster
        (compose: ``pc.replace(mask=pc.mask & (labels == k))``).
      normals: [N, 3] unit normals; ``normals_valid`` optional validity.
      viewpoint: sensor position (traced) — the viewpoint component
        measures normals against the direction from the centroid to it.

    Returns (desc [308] float32 — each block summing to 100 when any
    point contributes — and valid: False when fewer than 2 valid points).
    """
    valid = pc.mask if normals_valid is None else pc.mask & normals_valid
    w = valid.astype(jnp.float32)
    tot = jnp.sum(w)
    c = jnp.sum(pc.xyz * w[:, None], axis=0) / jnp.maximum(tot, 1.0)
    nc = jnp.sum(normals * w[:, None], axis=0)
    nc = nc / jnp.maximum(jnp.linalg.norm(nc), 1e-12)

    dp = pc.xyz - c                                       # centroid -> point
    d = jnp.sqrt(jnp.maximum(jnp.sum(dp * dp, axis=-1), 1e-24))
    near0 = jnp.sum(dp * dp, axis=-1) <= 1e-12
    nc_b = jnp.broadcast_to(nc, normals.shape)
    alpha, phi, theta, ok = pair_angles(nc_b, normals, dp, d)
    wgt = (valid & ok & ~near0).astype(jnp.float32)

    dmax = jnp.max(jnp.where(valid, d, 0.0))
    dn = d / jnp.maximum(dmax, 1e-12)

    vp = jnp.asarray(viewpoint, jnp.float32) - c
    vp = vp / jnp.maximum(jnp.linalg.norm(vp), 1e-12)
    cos_vp = jnp.sum(normals * vp, axis=-1)

    desc = jnp.concatenate([
        _hist(alpha, -1.0, 1.0, wgt, VFH_ANGLE_BINS),
        _hist(phi, -1.0, 1.0, wgt, VFH_ANGLE_BINS),
        _hist(theta, -jnp.pi, jnp.pi, wgt, VFH_ANGLE_BINS),
        _hist(dn, 0.0, 1.0, wgt, VFH_ANGLE_BINS),
        _hist(cos_vp, -1.0, 1.0, w, VFH_VP_BINS),
    ])
    ok_out = tot >= 2.0
    return jnp.where(ok_out, desc, 0.0), ok_out
