"""Sample-consensus plane segmentation on fixed-shape clouds.

On-device equivalent of ``pcl::SACSegmentation<pcl::PointXYZ>`` with
``SACMODEL_PLANE`` + ``pcl::ExtractIndices`` (the staple PCL workflow this
class of stitching rig uses to drop the floor/walls from a fused scene;
the reference leaves it to downstream PCL — SURVEY.md §2.2 lists the
compute-path ops this composes with).

PCL's RANSAC draws hypotheses *sequentially* until an inlier ratio is
reached; an accelerator inverts that: draw EVERY hypothesis up front (a [M, 3]
index sample), evaluate all of them against all points as one batched
distance computation (an [M, 3] x [3, N] matmul — plane evaluation IS a
dot product), and argmax the inlier counts. Degenerate samples (collinear
triples, masked points) score zero and lose. The winner is polished with
a fixed number of least-squares refits (weighted centroid + smallest
eigenvector of the 3x3 scatter — the classic total-least-squares plane),
which is PCL's ``setOptimizeCoefficients(true)``.

Everything is fixed shape: M hypotheses, chunked evaluation so the
[M, N] distance matrix never materializes beyond one [M, chunk] tile.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud


def _plane_from_triples(p0, p1, p2):
    """Unit plane [*, 4] (n, d) through three points; zero when collinear."""
    n = jnp.cross(p1 - p0, p2 - p0)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    ok = norm[..., 0] > 1e-9
    n = jnp.where(ok[..., None], n / jnp.maximum(norm, 1e-12), 0.0)
    d = -jnp.sum(n * p0, axis=-1)
    return jnp.concatenate([n, d[..., None]], axis=-1), ok


def _count_inliers(models, xyz, mask, threshold, chunk):
    """Inlier counts [M] of each plane, evaluated in [M, chunk] tiles."""
    m4 = models  # [M, 4]
    n = xyz.shape[0]
    npad = -(-n // chunk) * chunk
    xyz_p = jnp.pad(xyz, ((0, npad - n), (0, 0)))
    mask_p = jnp.pad(mask, (0, npad - n))
    xyz_c = xyz_p.reshape(npad // chunk, chunk, 3)
    mask_c = mask_p.reshape(npad // chunk, chunk)

    def body(carry, xm):
        x, msk = xm
        # distance of every point to every plane: one [M,3]x[3,chunk] dot.
        # HIGHEST precision: reduced-precision (bf16/TF32) passes err at
        # ~1 cm for meter-scale points — the same magnitude as a typical
        # inlier threshold
        # (CLAUDE.md precision rule; CPU tests cannot catch a violation)
        dist = jnp.abs(jnp.matmul(m4[:, :3], x.T, precision="highest")
                       + m4[:, 3:4])                      # [M, chunk]
        hit = (dist <= threshold) & msk[None, :]
        return carry + jnp.sum(hit, axis=1, dtype=jnp.int32), None

    counts, _ = jax.lax.scan(body, jnp.zeros((m4.shape[0],), jnp.int32),
                             (xyz_c, mask_c))
    return counts


def _refit(model, xyz, mask, threshold):
    """One total-least-squares refit on the model's inliers."""
    dist = jnp.abs(jnp.matmul(xyz, model[:3], precision="highest")
                   + model[3])
    w = ((dist <= threshold) & mask).astype(jnp.float32)
    tot = jnp.maximum(jnp.sum(w), 3.0)
    c = jnp.sum(xyz * w[:, None], axis=0) / tot
    dxyz = (xyz - c) * w[:, None]
    # 3x3 scatter of inliers (HIGHEST: see _count_inliers)
    cov = jnp.einsum("ni,nj->ij", dxyz, dxyz, precision="highest")
    # smallest-eigenvalue eigenvector = plane normal (eigh: ascending)
    _, vecs = jnp.linalg.eigh(cov)
    nrm = vecs[:, 0]
    # keep the incoming orientation (eigenvectors have arbitrary sign)
    nrm = jnp.where(jnp.dot(nrm, model[:3]) < 0, -nrm, nrm)
    return jnp.concatenate([nrm, -jnp.dot(nrm, c)[None]])


@partial(jax.jit, static_argnames=("num_hypotheses", "refine_iters",
                                   "chunk"))
def segment_plane(pc: PointCloud, threshold, key: jax.Array,
                  num_hypotheses: int = 1024, refine_iters: int = 2,
                  chunk: int = 16384):
    """Find the dominant plane. Returns (model [4], inlier_mask [N], count).

    Args:
      pc: cloud [N, 3] + mask (a fused/voxelized output works directly).
        Clouds that cannot support a plane (< 3 inliers) return the zero
        model with count 0.
      threshold: inlier point-to-plane distance (meters, traced).
      key: jax.random key — deterministic given (key, cloud).
      num_hypotheses: minimal-sample planes drawn up front and evaluated
        together. 1024 gives >99.9% success down to ~20% inlier ratio
        ((1-0.2^3)^1024); raise it for sparser planes.
      refine_iters: least-squares polish rounds on the winner's inliers
        (PCL setOptimizeCoefficients).

    The model is (nx, ny, nz, d) with |n| = 1 and n·p + d = 0 on the plane,
    PCL's ModelCoefficients layout.
    """
    xyz = pc.xyz
    n = xyz.shape[0]
    # sample valid points: draw from the compacted-index distribution —
    # invalid slots get probability 0, so every triple lands on real points
    # (a cloud with < 3 valid points yields count 0 and a zero model)
    p = pc.mask.astype(jnp.float32)
    p = p / jnp.maximum(jnp.sum(p), 1.0)
    idx = jax.random.choice(key, n, shape=(num_hypotheses, 3), p=p)
    tri = xyz[idx]  # [M, 3, 3]
    models, ok = _plane_from_triples(tri[:, 0], tri[:, 1], tri[:, 2])
    counts = _count_inliers(models, xyz, pc.mask, threshold, chunk)
    counts = jnp.where(ok, counts, 0)
    best = jnp.argmax(counts)
    model = models[best]

    for _ in range(refine_iters):
        model = _refit(model, xyz, pc.mask, threshold)

    dist = jnp.abs(jnp.matmul(xyz, model[:3], precision="highest")
                   + model[3])
    inliers = (dist <= threshold) & pc.mask
    count = jnp.sum(inliers, dtype=jnp.int32)
    # degenerate contract: a plane is determined by >= 3 points; with
    # fewer supporting inliers (e.g. a < 3-valid-point cloud) the refit's
    # eigh would fabricate an identity-basis plane [1, 0, 0, 0] — return
    # the zero model / zero inliers instead
    ok = count >= 3
    model = jnp.where(ok, model, jnp.zeros_like(model))
    inliers = inliers & ok
    count = jnp.where(ok, count, 0)
    return model, inliers, count


def extract_plane(pc: PointCloud, model: jax.Array, threshold,
                  negative: bool = True) -> PointCloud:
    """pcl::ExtractIndices for a plane model: mask-only, zero copies.

    negative=True removes the plane's inliers (drop the floor); False keeps
    only them (isolate the floor).
    """
    dist = jnp.abs(jnp.matmul(pc.xyz, model[:3], precision="highest")
                   + model[3])
    on_plane = dist <= threshold
    keep = pc.mask & (~on_plane if negative else on_plane)
    return pc.replace(mask=keep)


@jax.jit
def project_plane(pc: PointCloud, model: jax.Array) -> PointCloud:
    """Project every valid point onto a plane model.

    On-device role of ``pcl::ProjectInliers`` with ``SACMODEL_PLANE``
    (PCL's flatten-the-inliers step between segmentation and 2-D
    processing like hull extraction): ``p' = p - (n.p + d) n`` with the
    model normalized first. Mask and row order are preserved, so labels
    and RGB stay aligned.
    """
    n = model[:3] / jnp.maximum(jnp.linalg.norm(model[:3]), 1e-12)
    d = model[3] / jnp.maximum(jnp.linalg.norm(model[:3]), 1e-12)
    dist = jnp.matmul(pc.xyz, n, precision="highest") + d
    xyz = pc.xyz - dist[..., None] * n
    return pc.replace(xyz=jnp.where(pc.mask[..., None], xyz, pc.xyz))
