"""Fast Point Feature Histograms on fixed-shape clouds.

On-device role of ``pcl::FPFHEstimation`` — the 33-dimensional local-geometry
descriptor behind PCL's automatic coarse alignment
(``pcl::SampleConsensusInitialAlignment``; the reference's registration tool
is pick-based, SURVEY.md §3.4, and models/registration.py's ``register_global``
covers the pick-free role geometrically — FPFH adds the *descriptor* evidence
that survives scene symmetry, where geometry-only starts can lock onto the
wrong lobe).

PCL computes FPFH through a KD-tree radius search and ragged per-point
neighbor lists — pointer-chasing that does not map to fixed shapes. The accelerator
formulation keeps the published math (Rusu et al., ICRA 2009) but restates
both passes as blockwise all-pairs sweeps, the same [query_tile x ref_tile]
pattern as ops/nn.py and ops/mls.py:

  pass 1 (SPFH): every in-radius pair's Darboux-frame angles are computed
    branchlessly for the whole [qt, rt] block at once, and the three 11-bin
    histograms accumulate via one-hot reductions — no neighbor lists, no
    scatter.
  pass 2 (weighting): FPFH_i = SPFH_i + (1/k_i) sum_j (1/d2_ij) SPFH_j is a
    masked [qt, rt] weight matrix times the [rt, 33] SPFH block — one matrix
    product.

Descriptor layout: bins [0:11] = alpha, [11:22] = phi, [22:33] = theta, where
for each neighbor pair the *source* endpoint s is the one whose normal makes
the smaller angle with the connecting line (the standard symmetry-fixing
rule), u = n_s, v = unit((p_t - p_s) x u), w = u x v, and

  alpha = v . n_t            in [-1, 1]   (11 uniform bins)
  phi   = u . (p_t - p_s)/d  in [-1, 1]
  theta = atan2(w . n_t, u . n_t) in [-pi, pi]

Each 11-bin block of the final descriptor is normalised to sum 100 (PCL's
convention), so descriptors are comparable across neighborhoods of different
density. Pairs whose connecting line is parallel to the source normal have no
defined Darboux frame and contribute nothing (PCL skips them too).

Cost is exact O(N^2) like the other sweeps — run it on voxel skeletons
(``ops.voxel.voxel_downsample``), which is also what SAC-IA does.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud
from .sweep import blockwise_accumulate as _blockwise

FPFH_BINS = 11
FPFH_DIM = 3 * FPFH_BINS


def _one_hot_hist(bins: jax.Array, weight: jax.Array) -> jax.Array:
    """sum_r weight[q, r] * onehot(bins[q, r]) -> [qt, FPFH_BINS]."""
    iota = jnp.arange(FPFH_BINS, dtype=jnp.int32)
    return jnp.sum(jnp.where(bins[..., None] == iota, weight[..., None], 0.0),
                   axis=1)


def pair_angles(n_src, n_tgt, dp, d):
    """Darboux-frame pair angles for a broadcast stack of point pairs.

    Args (already broadcast to a common [..., 3] / [...] shape):
      n_src, n_tgt: the two endpoints' unit normals.
      dp: p_tgt - p_src; d: |dp| (positive; caller guards d ~ 0).

    Applies the standard source-selection rule (the endpoint whose normal
    makes the smaller angle with the connecting line becomes the Darboux
    source) as a select, not a branch. Returns (alpha, phi, theta, ok)
    where ok is False for degenerate frames (line parallel to the source
    normal; |v| scales with d so the gate is on the ANGLE |v|/d = sin).
    Shared by FPFH (all-pairs blocks) and VFH (centroid-to-point stack).
    """
    a1 = jnp.sum(n_src * dp, axis=-1) / d
    a2 = jnp.sum(n_tgt * dp, axis=-1) / d
    swap = jnp.abs(a1) < jnp.abs(a2)
    ns = jnp.where(swap[..., None], n_tgt, n_src)
    nt = jnp.where(swap[..., None], n_src, n_tgt)
    dvec = jnp.where(swap[..., None], -dp, dp)           # source -> target
    phi = jnp.where(swap, -a2, a1)                       # = ns . dvec / d

    v = jnp.cross(dvec, ns)
    vnorm = jnp.linalg.norm(v, axis=-1)
    ok = vnorm > 1e-5 * d
    v = v / jnp.maximum(vnorm, 1e-24)[..., None]
    w = jnp.cross(ns, v)
    alpha = jnp.sum(v * nt, axis=-1)
    theta = jnp.arctan2(jnp.sum(w * nt, axis=-1), jnp.sum(ns * nt, axis=-1))
    return alpha, phi, theta, ok


def _pair_hist_block(q, qn, qv, r, rn, rv, r2):
    """SPFH histogram contributions of one [qt, rt] pair block.

    Returns (hist [qt, 33], k [qt]) — raw angle-bin counts over the block's
    in-radius, non-degenerate pairs, and the count of contributing pairs.
    All-pairs branchless: the source/target swap is a select, not a branch.
    """
    dp = r[None, :, :] - q[:, None, :]                   # [qt, rt, 3]
    d2 = jnp.sum(dp * dp, axis=-1)
    d = jnp.sqrt(jnp.maximum(d2, 1e-24))
    inside = (d2 <= r2) & (d2 > 1e-12) & qv[:, None] & rv[None, :]

    qn_b = jnp.broadcast_to(qn[:, None, :], dp.shape)
    rn_b = jnp.broadcast_to(rn[None, :, :], dp.shape)
    alpha, phi, theta, ok = pair_angles(qn_b, rn_b, dp, d)
    ok = ok & inside

    nb = jnp.float32(FPFH_BINS)
    to_bin = lambda x, lo, hi: jnp.clip(
        jnp.floor((x - lo) * (nb / (hi - lo))).astype(jnp.int32),
        0, FPFH_BINS - 1)
    wgt = ok.astype(jnp.float32)
    hist = jnp.concatenate([
        _one_hot_hist(to_bin(alpha, -1.0, 1.0), wgt),
        _one_hot_hist(to_bin(phi, -1.0, 1.0), wgt),
        _one_hot_hist(to_bin(theta, -jnp.pi, jnp.pi), wgt),
    ], axis=-1)                                          # [qt, 33]
    return hist, jnp.sum(wgt, axis=1)


@partial(jax.jit, static_argnames=("query_tile", "ref_tile"))
def fpfh(pc: PointCloud, normals: jax.Array,
         normals_valid: jax.Array | None = None, radius=0.25,
         min_neighbors: int | jax.Array = 3,
         query_tile: int = 256, ref_tile: int = 512):
    """33-dim FPFH descriptor per point (pcl::FPFHEstimation role).

    Args:
      pc: cloud [N, 3] + mask (a voxel skeleton at registration scale).
      normals: [N, 3] unit normals (ops.mls.estimate_normals for unorganized
        clouds, ops.normals for organized/fused ones).
      normals_valid: [N] bool; points without a valid normal neither get a
        descriptor nor contribute to their neighbors'.
      radius: feature radius in meters (traced). Use > the normal-estimation
        radius (PCL's standing guidance).
      min_neighbors: descriptors supported by fewer contributing pairs are
        marked invalid (traced).

    Returns (desc [N, 33] float32 — each 11-bin block summing to 100 for
    valid points, zeros elsewhere — and valid [N]).
    """
    valid = pc.mask if normals_valid is None else pc.mask & normals_valid
    r2 = jnp.square(jnp.asarray(radius, jnp.float32))

    spfh, k = _blockwise(
        pc.xyz, valid, [normals], query_tile, ref_tile,
        lambda q, qv, qe, r, rv, re: _pair_hist_block(
            q, qe[0], qv, r, re[0], rv, r2))

    # pass 2: distance-weighted neighbor SPFH sum — a masked matmul per block
    def weight_step(q, qv, qe, r, rv, re):
        spfh_blk, k_blk = re
        dp = r[None, :, :] - q[:, None, :]
        d2 = jnp.sum(dp * dp, axis=-1)
        inside = (d2 <= r2) & (d2 > 1e-12) & qv[:, None] & rv[None, :]
        w = jnp.where(inside, 1.0 / jnp.maximum(d2, 1e-12), 0.0)
        # neighbors' SPFH enter pre-normalised (PCL divides each by its own
        # pair count), so sparse and dense neighbors weigh equally
        nrm = spfh_blk / jnp.maximum(k_blk, 1.0)[:, None]
        acc = jnp.matmul(w, nrm, precision="highest")     # [qt, 33]
        return acc, jnp.sum(inside.astype(jnp.float32), axis=1)

    wsum, kn = _blockwise(pc.xyz, valid, [spfh, k], query_tile, ref_tile,
                          weight_step)
    desc = spfh / jnp.maximum(k, 1.0)[:, None] \
        + wsum / jnp.maximum(kn, 1.0)[:, None]

    ok = valid & (k >= jnp.asarray(min_neighbors, jnp.float32))
    # per-block normalisation to 100 (PCL convention)
    d3 = desc.reshape(-1, 3, FPFH_BINS)
    s = jnp.sum(d3, axis=-1, keepdims=True)
    d3 = jnp.where(s > 0, 100.0 * d3 / jnp.maximum(s, 1e-12), 0.0)
    desc = jnp.where(ok[:, None], d3.reshape(-1, FPFH_DIM), 0.0)
    return desc, ok


@partial(jax.jit, static_argnames=("k", "query_tile", "ref_tile"))
def match_fpfh(desc_a: jax.Array, ok_a: jax.Array,
               desc_b: jax.Array, ok_b: jax.Array, k: int = 1,
               query_tile: int = 512, ref_tile: int = 1024):
    """k nearest descriptors in B for every descriptor in A.

    Running top-k over ref tiles (the ops.filters.knn_mean_distance pattern),
    cross terms as a matrix product. Invalid B rows never match; invalid A rows return
    sentinel distances (~1e12).

    Returns (idx [N, k] int32 into B, d2 [N, k] ascending).
    """
    n, m = desc_a.shape[0], desc_b.shape[0]
    far = jnp.float32(1e12)
    qt, rt = min(query_tile, n), min(ref_tile, m)
    nq, nr = -(-n // qt), -(-m // rt)
    a = jnp.pad(desc_a, ((0, nq * qt - n), (0, 0)))
    av = jnp.pad(ok_a, (0, nq * qt - n))
    b = jnp.pad(desc_b, ((0, nr * rt - m), (0, 0)))
    bv = jnp.pad(ok_b, (0, nr * rt - m))
    b_sq = jnp.sum(b * b, axis=-1)

    def query_block(qi):
        q = jax.lax.dynamic_slice(a, (qi * qt, 0), (qt, desc_a.shape[1]))
        q_sq = jnp.sum(q * q, axis=-1)

        def ref_step(ri, best):
            bd2, bidx = best
            r = jax.lax.dynamic_slice(b, (ri * rt, 0), (rt, b.shape[1]))
            rv = jax.lax.dynamic_slice(bv, (ri * rt,), (rt,))
            rsq = jax.lax.dynamic_slice(b_sq, (ri * rt,), (rt,))
            cross = jnp.dot(q, r.T, preferred_element_type=jnp.float32,
                            precision="highest")
            d2 = q_sq[:, None] + rsq[None, :] - 2.0 * cross
            d2 = jnp.where(rv[None, :], jnp.maximum(d2, 0.0), far)
            idx = ri * rt + jax.lax.broadcasted_iota(jnp.int32,
                                                     (qt, rt), 1)
            md2 = jnp.concatenate([bd2, d2], axis=1)     # [qt, k + rt]
            midx = jnp.concatenate([bidx, idx], axis=1)
            top, pos = jax.lax.top_k(-md2, k)
            return -top, jnp.take_along_axis(midx, pos, axis=1)

        init = (jnp.full((qt, k), far), jnp.zeros((qt, k), jnp.int32))
        return jax.lax.fori_loop(0, nr, ref_step, init)

    d2, idx = jax.lax.map(query_block, jnp.arange(nq))
    d2 = d2.reshape(-1, k)[:n]
    idx = jnp.minimum(idx.reshape(-1, k)[:n], m - 1)
    d2 = jnp.where(av[:n, None], d2, far)
    return idx, d2
