"""Moving-least-squares surface smoothing on fixed-shape clouds.

On-device role of ``pcl::MovingLeastSquares`` (plane-projection mode —
the sensor-noise smoother PCL users run before meshing/normals). PCL
builds an explicit neighbor list per point through a KD-tree radius
search and fits each local surface serially; neither the tree nor the
ragged neighbor lists map to fixed shapes.

The reformulation: a local plane fit needs only the kernel-weighted
*moments* of the neighborhood —

    sum(w), sum(w p), sum(w p p^T)

— and moments ACCUMULATE, so the ragged neighbor gather disappears: one
blockwise all-pairs sweep (the same [tile, block] pattern as
ops.filters.count_neighbors / the NN kernel) adds every reference block's
kernel-weighted contribution into 13 running scalars per query point. A
batched 3x3 ``eigh`` then yields each point's local plane (smallest
eigenvector of the weighted covariance), and the point projects onto it.

Cost is exact O(N^2) like the brute NN sweep — fine at stitched-output
scale (the fused cloud is already voxel-bounded); voxel-downsample first
for registration-scale inputs.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud


def _radius_moments(xyz, mask, radius, sg, query_tile, ref_tile):
    """Kernel-weighted neighborhood moments per point, blockwise.

    Returns (sum_w [N], sum_w·(p-q) [N,3], sum_w·(p-q)(p-q)^T [N,3,3],
    count [N]) over valid points p within ``radius`` of each query q
    (self included), Gaussian weights exp(-d2/sg) — QUERY-CENTERED
    displacements, so the downstream covariance never cancels origin-
    scale moments (see ref_step). The shared engine of mls_smooth,
    estimate_normals and estimate_curvature:
    mu = q + swd/sw, cov = swddt/sw - (swd/sw)(swd/sw)^T.
    """
    n = xyz.shape[0]
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))
    qt, rt = min(query_tile, n), min(ref_tile, n)
    nq, nr = -(-n // qt), -(-n // rt)
    rxyz = jnp.pad(xyz, ((0, nr * rt - n), (0, 0)))
    rmask = jnp.pad(mask, (0, nr * rt - n))
    qxyz = jnp.pad(xyz, ((0, nq * qt - n), (0, 0)))

    def query_block(qi):
        q = jax.lax.dynamic_slice(qxyz, (qi * qt, 0), (qt, 3))

        def ref_step(ri, acc):
            sw, swd, swddt, cnt = acc
            r = jax.lax.dynamic_slice(rxyz, (ri * rt, 0), (rt, 3))
            rm = jax.lax.dynamic_slice(rmask, (ri * rt,), (rt,))
            d = q[:, None, :] - r[None, :, :]            # [qt, rt, 3]
            d2 = jnp.sum(d * d, axis=-1)
            inside = (d2 <= r2) & rm[None, :]
            w = jnp.where(inside, jnp.exp(-d2 / jnp.maximum(sg, 1e-12)),
                          0.0)                           # [qt, rt]
            sw = sw + jnp.sum(w, axis=1)
            # QUERY-CENTERED moments (r - q = -d), not origin moments:
            # E[pp^T] - mu mu^T around the origin is ~|p|^2-scale sums
            # whose subtraction cancels catastrophically for scenes tens
            # of meters out (f32 ulp at 1e4 is ~1e-3 — the size of a
            # whole cm-scale covariance). Displacements are radius-sized,
            # so every accumulated square is computed at full relative
            # precision. (HIGHEST — the covariance decides each plane
            # normal; CLAUDE.md precision rule.)
            swd = swd - jnp.einsum("qr,qri->qi", w, d,
                                   precision="highest")
            swddt = swddt + jnp.einsum("qr,qri,qrj->qij", w, d, d,
                                       precision="highest")
            cnt = cnt + jnp.sum(inside, axis=1).astype(jnp.int32)
            return sw, swd, swddt, cnt

        return jax.lax.fori_loop(
            0, nr, ref_step,
            (jnp.zeros((qt,), jnp.float32), jnp.zeros((qt, 3), jnp.float32),
             jnp.zeros((qt, 3, 3), jnp.float32),
             jnp.zeros((qt,), jnp.int32)))

    sw, swd, swddt, cnt = jax.lax.map(query_block, jnp.arange(nq))
    return (sw.reshape(-1)[:n], swd.reshape(-1, 3)[:n],
            swddt.reshape(-1, 3, 3)[:n], cnt.reshape(-1)[:n])


def _local_planes(xyz, sw, swd, swddt):
    """Per-point weighted centroid + plane normal from centered moments.

    The mean displacement is radius-bounded, so the shifted-moment
    covariance below subtracts small like-sized quantities — no
    origin-scale cancellation."""
    denom = jnp.maximum(sw, 1e-12)[:, None]
    md = swd / denom                       # mean displacement from query
    cov = swddt / denom[..., None] - md[:, :, None] * md[:, None, :]
    mu = xyz + md
    # guard eigh against the all-zero covariance of unsupported points
    eye = jnp.eye(3, dtype=jnp.float32)
    _, vecs = jnp.linalg.eigh(cov + 1e-12 * eye)
    return mu, vecs[..., 0]                  # smallest-eigenvalue direction


@partial(jax.jit, static_argnames=("query_tile", "ref_tile"))
def estimate_normals(pc: PointCloud, radius, viewpoint=(0.0, 0.0, 0.0),
                     sqr_gauss=None, min_neighbors: int | jax.Array = 3,
                     query_tile: int = 512, ref_tile: int = 1024):
    """Surface normals for UNORGANIZED clouds (pcl::NormalEstimation role).

    Organized grids get normals for free (ops.normals.grid_normals); an
    arbitrary cloud (a fused output, a loaded .ply, a voxel map) needs the
    neighborhood-PCA form: each point's normal is the smallest eigenvector
    of its radius-neighborhood's weighted covariance — exactly the moments
    the MLS sweep accumulates, so both ops share one blockwise engine (no
    KD-tree, no neighbor lists; see module docstring).

    Returns (normals [N, 3] unit vectors oriented toward ``viewpoint`` —
    PCL's flipNormalTowardsViewpoint convention — and valid [N]: False
    where fewer than ``min_neighbors`` other points support the fit;
    normals are zero there).
    """
    xyz, mask = pc.xyz, pc.mask
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))
    sg = r2 if sqr_gauss is None else jnp.asarray(sqr_gauss, jnp.float32)
    sw, swd, swddt, cnt = _radius_moments(xyz, mask, radius, sg,
                                          query_tile, ref_tile)
    _, nrm = _local_planes(xyz, sw, swd, swddt)
    vp = jnp.asarray(viewpoint, jnp.float32)
    flip = jnp.sum(nrm * (vp[None, :] - xyz), axis=-1) < 0
    nrm = jnp.where(flip[:, None], -nrm, nrm)
    ok = mask & (cnt - 1 >= jnp.asarray(min_neighbors, jnp.int32))
    return jnp.where(ok[:, None], nrm, 0.0), ok


@partial(jax.jit, static_argnames=("query_tile", "ref_tile"))
def estimate_curvature(pc: PointCloud, radius, sqr_gauss=None,
                       min_neighbors: int | jax.Array = 3,
                       query_tile: int = 512, ref_tile: int = 1024):
    """Surface variation per point — PCL's NormalEstimation "curvature".

    lambda_0 / (lambda_0 + lambda_1 + lambda_2) of the radius-neighborhood
    covariance (kernel-weighted here, like estimate_normals — PCL's is
    unweighted; both go to 0 on planes and grow toward 1/3 at corners and
    isolated noise). The classic gate for region growing: crease/edge
    points score high and can be excluded so regions don't bleed across
    sharp edges (ops.region_growing's ``curvature`` input).

    Returns (curvature [N] float32 in [0, ~1/3], valid [N]); zeros where
    fewer than ``min_neighbors`` other points support the estimate.
    """
    xyz, mask = pc.xyz, pc.mask
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))
    sg = r2 if sqr_gauss is None else jnp.asarray(sqr_gauss, jnp.float32)
    sw, swd, swddt, cnt = _radius_moments(xyz, mask, radius, sg,
                                          query_tile, ref_tile)
    denom = jnp.maximum(sw, 1e-12)[:, None]
    md = swd / denom                       # centered moments: see engine
    cov = swddt / denom[..., None] - md[:, :, None] * md[:, None, :]
    vals = jnp.linalg.eigvalsh(cov + 1e-12 * jnp.eye(3, dtype=jnp.float32))
    vals = jnp.maximum(vals, 0.0)                  # clamp fp cancellation
    curv = vals[..., 0] / jnp.maximum(jnp.sum(vals, axis=-1), 1e-12)
    ok = mask & (cnt - 1 >= jnp.asarray(min_neighbors, jnp.int32))
    return jnp.where(ok, curv, 0.0), ok


@partial(jax.jit, static_argnames=("query_tile", "ref_tile"))
def mls_smooth(pc: PointCloud, radius, sqr_gauss=None,
               min_neighbors: int | jax.Array = 3,
               query_tile: int = 512, ref_tile: int = 1024) -> PointCloud:
    """Project each point onto its kernel-weighted local plane.

    Args:
      pc: cloud [N, 3] (+mask, optional rgb — passed through untouched) or
        camera-batched [B, N, 3].
      radius: neighborhood radius in meters (traced). PCL's
        setSearchRadius.
      sqr_gauss: Gaussian kernel width (meters^2); default radius^2, PCL's
        setSqrGaussParam default.
      min_neighbors: points with fewer OTHER neighbors in the radius keep
        their original coordinates (a plane needs support; PCL drops such
        points — here the mask-only philosophy keeps them unsmoothed, and
        ``radius_outlier_removal`` composes in front when dropping is
        wanted).

    Returns the cloud with smoothed xyz; mask/rgb unchanged. Matches the
    direct numpy computation (tests/test_mls.py) — this is PCL's
    plane-projection MLS (polynomial fit off), not the polynomial
    upsampling variants.
    """
    if pc.xyz.ndim == 3:
        sm = jax.lax.map(
            lambda args: mls_smooth(PointCloud(xyz=args[0], mask=args[1]),
                                    radius, sqr_gauss, min_neighbors,
                                    query_tile=query_tile,
                                    ref_tile=ref_tile).xyz,
            (pc.xyz, pc.mask))
        return pc.replace(xyz=sm)
    xyz, mask = pc.xyz, pc.mask
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))
    sg = r2 if sqr_gauss is None else jnp.asarray(sqr_gauss, jnp.float32)
    sw, swd, swddt, cnt = _radius_moments(xyz, mask, radius, sg,
                                          query_tile, ref_tile)
    mu, nrm = _local_planes(xyz, sw, swd, swddt)
    off = jnp.sum((xyz - mu) * nrm, axis=-1, keepdims=True)
    projected = xyz - off * nrm

    # self-match is inside every valid point's neighborhood: cnt includes
    # it, so "other neighbors" is cnt - 1
    ok = mask & (cnt - 1 >= jnp.asarray(min_neighbors, jnp.int32))
    return pc.replace(xyz=jnp.where(ok[:, None], projected, xyz))
