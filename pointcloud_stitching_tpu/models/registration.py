"""Offline pairwise registration — the calibration workflow.

On-device equivalent of the reference's registration tool (reference:
registration/ directory, adapted from PCL's manual_registration example —
SURVEY.md §3.4): pick >=3 corresponding point pairs between two clouds →
closed-form SVD (Kabsch) solve → optional ICP refinement → write the 4x4
extrinsic as a .cal file the streaming client consumes.

The interactive picking UI is host-side and out of scope for the device
path; this module takes picked index pairs (or none, for pure ICP) and does
the solves on-device.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..io.calio import save_cal
from ..ops.icp import ICPResult, icp_converge
from ..ops.kabsch import kabsch
from ..utils.types import PointCloud


class RegistrationResult(NamedTuple):
    T: jax.Array               # src→dst 4x4
    initial_T: jax.Array       # from correspondences only (pre-ICP)
    icp: Optional[ICPResult]   # None if refinement disabled


def register_from_correspondences(src: PointCloud, dst: PointCloud,
                                  src_idx: Sequence[int],
                                  dst_idx: Sequence[int]) -> jax.Array:
    """Closed-form rigid solve from picked correspondence pairs.

    Mirrors pcl::registration::TransformationEstimationSVD over the picked
    pairs (>=3 non-collinear pairs required for a unique solution).
    """
    si = jnp.asarray(src_idx, jnp.int32)
    di = jnp.asarray(dst_idx, jnp.int32)
    if si.shape != di.shape or si.shape[0] < 3:
        raise ValueError("need >=3 correspondence pairs")
    s = src.xyz[si]
    d = dst.xyz[di]
    w = (src.mask[si] & dst.mask[di]).astype(jnp.float32)
    return kabsch(s, d, w)


def register_pair(src: PointCloud, dst: PointCloud,
                  src_idx: Optional[Sequence[int]] = None,
                  dst_idx: Optional[Sequence[int]] = None,
                  refine: bool = True,
                  max_iterations: int = 50,
                  transformation_epsilon: float = 1e-8,
                  max_corr_dist: float = 0.25,
                  query_tile: int = 1024,
                  ref_tile: int = 4096,
                  trim_fraction: float = 0.0,
                  prune: bool = False) -> RegistrationResult:
    """Full calibration solve: optional picked-pair init + ICP refinement."""
    if src_idx is not None:
        init_T = register_from_correspondences(src, dst, src_idx, dst_idx)
    else:
        init_T = jnp.eye(4, dtype=jnp.float32)
    icp_res = None
    T = init_T
    if refine:
        icp_res = icp_converge(src, dst, init_T=init_T,
                               max_iterations=max_iterations,
                               transformation_epsilon=transformation_epsilon,
                               max_corr_dist=max_corr_dist,
                               query_tile=query_tile, ref_tile=ref_tile,
                               trim_fraction=trim_fraction, prune=prune)
        T = icp_res.T
    return RegistrationResult(T=T, initial_T=init_T, icp=icp_res)


def _quat_rotations(q: jax.Array) -> jax.Array:
    """Unit-quaternion batch [M, 4] (wxyz) → rotation matrices [M, 3, 3]."""
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return jnp.stack([
        jnp.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], -1),
        jnp.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], -1),
        jnp.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], -1),
    ], axis=-2)


def _pca_axes(xyz: jax.Array, w: jax.Array) -> jax.Array:
    """Weighted principal axes [3, 3] (columns, ascending eigenvalue).

    The basis is forced right-handed (det +1): eigh returns eigenvector
    matrices of arbitrary determinant sign, and a left-handed Vs or Vd
    would turn EVERY det(+1) alignment in _ALIGN24 into a reflection —
    silently defeating the PCA starts for ~half of all cloud pairs.
    HIGHEST-precision scatter: a bf16 3x3 accumulation can reorder
    near-equal eigenvalues (CLAUDE.md precision rule).
    """
    tot = jnp.maximum(jnp.sum(w), 1.0)
    c = jnp.sum(xyz * w[:, None], 0) / tot
    d = (xyz - c) * w[:, None]
    cov = jnp.einsum("ni,nj->ij", d, d, precision="highest")
    _, v = jnp.linalg.eigh(cov)
    det = jnp.linalg.det(v)
    return v.at[:, 0].multiply(jnp.where(det < 0, -1.0, 1.0))


# the 24 proper rotations mapping one orthonormal basis onto another with
# all axis permutations and sign flips (det +1 only), as permutation/sign
# matrices applied between the two eigenbases
def _basis_alignments() -> np.ndarray:
    mats = []
    from itertools import permutations, product
    for perm in permutations(range(3)):
        for signs in product((1.0, -1.0), repeat=3):
            m = np.zeros((3, 3), np.float32)
            for i, (p, s) in enumerate(zip(perm, signs)):
                m[i, p] = s
            if np.linalg.det(m) > 0:
                mats.append(m)
    return np.stack(mats)  # [24, 3, 3]


_ALIGN24 = _basis_alignments()


def _fpfh_start_transforms(cs: PointCloud, cd: PointCloud, key: jax.Array,
                           n_starts: int, leaf: float, k_corr: int = 8,
                           normal_radius: Optional[float] = None,
                           feature_radius: Optional[float] = None) -> jax.Array:
    """Descriptor-seeded rigid hypotheses [n_starts, 4, 4].

    The correspondence half of ``pcl::SampleConsensusInitialAlignment``:
    FPFH descriptors on both skeletons, then ``n_starts`` sampled source
    triples, each matched to one of its ``k_corr`` nearest target descriptors
    (picked at random, like SAC-IA's similar-feature sampling), closed-form
    Kabsch per triple — all batched; no serial RANSAC loop. The hypotheses
    join register_global's common scoring pool, so a bad triple simply
    loses; only descriptor-consistent ones can win.

    Normals are estimated per cloud with viewpoint at that cloud's own
    origin — each cloud lives in its own sensor frame during calibration, so
    orientation is consistent across the pair without knowing the relative
    pose.
    """
    from ..ops.fpfh import fpfh, match_fpfh
    from ..ops.mls import estimate_normals

    nr = 2.5 * leaf if normal_radius is None else normal_radius
    fr = 5.0 * leaf if feature_radius is None else feature_radius
    ns_, oks = estimate_normals(cs, nr)
    nd_, okd = estimate_normals(cd, nr)
    fs, vs = fpfh(cs, ns_, oks, radius=fr)
    fd, vd = fpfh(cd, nd_, okd, radius=fr)
    idx, md2 = match_fpfh(fs, vs, fd, vd, k=k_corr)      # [N, k_corr]

    k1, k2 = jax.random.split(key)
    # -1e9, not -inf: with zero valid descriptors the categorical must stay
    # finite (junk hypotheses lose in scoring; -inf would NaN the softmax)
    logits = jnp.where(vs, 0.0, -1e9)
    si = jax.random.categorical(k1, logits, shape=(n_starts, 3))
    pick = jax.random.randint(k2, (n_starts, 3), 0, k_corr)
    di = idx[si, pick]                                   # [n_starts, 3]
    # match_fpfh pads unmatched k-NN slots with a clamped index + a ~1e12
    # sentinel distance (e.g. fewer than k_corr valid target descriptors):
    # zero-weight those, or Kabsch would fit fabricated correspondences
    matched = md2[si, pick] < 1e11
    w = (vs[si] & vd[di] & matched).astype(jnp.float32)
    return jax.vmap(kabsch)(cs.xyz[si], cd.xyz[di], w)


def register_global(src: PointCloud, dst: PointCloud, key: jax.Array,
                    num_starts: int = 64,
                    coarse_leaf: float = 0.05,
                    coarse_capacity: int = 1024,
                    coarse_iterations: int = 15,
                    coarse_corr_dist: Optional[float] = None,
                    coarse_trim: float = 0.1,
                    query_tile: int = 512, ref_tile: int = 1024,
                    refine: bool = True,
                    fpfh_starts: int = 0, fpfh_k_corr: int = 8,
                    **refine_kw) -> RegistrationResult:
    """Automatic pairwise registration — no picked correspondences.

    The reference's workflow (and PCL's manual_registration) needs a human
    to click >=3 pairs before ICP can converge; PCL's automatic
    alternative (FPFH + SAC-IA) is a serial descriptor/RANSAC pipeline.
    The accelerator formulation is *parallel multi-start*: draw ``num_starts``
    rotations uniformly at random (normalized 4-D Gaussians = uniform on
    SO(3)), center each with a centroid-matching translation, and run ALL
    the ICPs at once — the same batched machinery that powers the ring
    drift correction, here with the batch axis = hypothesis instead of
    camera pair. The basin of attraction of the true pose only has to
    catch ONE of the starts (start 0 is pinned to identity so an
    already-roughly-aligned pair never regresses). The winner — most
    inliers, mean error as the tie-break — seeds a full-resolution
    ``icp_converge`` polish.

    The multi-start stage runs on voxel skeletons (``coarse_capacity``
    points at ``coarse_leaf`` — the finest resolution tried; the leaf
    auto-coarsens until both clouds fit, since a saturated voxel pass
    would keep orientation-dependent, non-matching crops of the scene)
    with a loose correspondence gate (``coarse_corr_dist``, default 4x
    the fitted leaf) and light trimming, so all ``num_starts`` ICPs cost
    about one registration-scale ICP.

    Start composition: [identity] + [the 24 proper rotations aligning the
    two clouds' PCA eigenbases under every axis permutation/sign flip] +
    random fill. Random rotations alone need hundreds of draws to land
    within ICP's capture radius of an arbitrary pose; on any scene with
    distinct principal directions (rooms, height-fields, rigs), one of
    the 24 PCA alignments IS within it, deterministically. Scenes with
    degenerate principal axes fall back on the random starts.

    Suited to calibration scenes with substantial overlap (the rig case);
    like any geometry-only global method it can lock onto a symmetry of
    the scene — check ``icp.mean_error`` / ``num_inliers`` as usual. For
    scenes where geometry alone is ambiguous, ``fpfh_starts > 0`` appends
    that many FPFH-correspondence hypotheses (sampled descriptor-matched
    triples + Kabsch — the pcl::SampleConsensusInitialAlignment role,
    batched; see ``_fpfh_start_transforms``) to the same scoring pool.
    """
    from ..ops.voxel import voxel_downsample

    # auto-coarsen the skeleton leaf until BOTH clouds fit the capacity: a
    # saturated voxel pass keeps the lowest-key voxels — a spatially biased
    # crop whose location depends on each cloud's orientation, so the two
    # skeletons would cover DIFFERENT parts of the scene and neither PCA
    # nor ICP could match them (coarse_leaf is the finest resolution tried;
    # the leaf is traced, so this host loop reuses one compiled program)
    leaf = float(coarse_leaf)
    for _ in range(8):
        cs = voxel_downsample(src, leaf, capacity=coarse_capacity)
        cd = voxel_downsample(dst, leaf, capacity=coarse_capacity)
        if max(int(cs.count()), int(cd.count())) < 0.9 * coarse_capacity:
            break
        leaf *= 1.6
    coarse_leaf = leaf

    m = num_starts
    ws = cs.mask.astype(jnp.float32)
    wd = cd.mask.astype(jnp.float32)
    fkey = None
    if fpfh_starts > 0:
        key, fkey = jax.random.split(key)
    n_rand = max(m - 25, 1)
    q = jax.random.normal(key, (n_rand, 4), jnp.float32)
    rot_rand = _quat_rotations(q)
    vs = _pca_axes(cs.xyz, ws)
    vd = _pca_axes(cd.xyz, wd)
    rot_pca = jnp.einsum("ij,ajk,lk->ail", vd, jnp.asarray(_ALIGN24), vs,
                         precision="highest")       # vd @ A @ vs^T, [24,3,3]
    eye = jnp.eye(3, dtype=jnp.float32)[None]
    rot = jnp.concatenate([eye, rot_pca, rot_rand])[:m]
    m = rot.shape[0]
    c_src = jnp.sum(cs.xyz * ws[:, None], 0) / jnp.maximum(jnp.sum(ws), 1.0)
    c_dst = jnp.sum(cd.xyz * wd[:, None], 0) / jnp.maximum(jnp.sum(wd), 1.0)
    t = c_dst[None] - jnp.einsum("mij,j->mi", rot, c_src,
                                 precision="highest")
    init_T = jnp.tile(jnp.eye(4, dtype=jnp.float32), (m, 1, 1))
    init_T = init_T.at[:, :3, :3].set(rot).at[:, :3, 3].set(t)
    if fpfh_starts > 0:
        init_T = jnp.concatenate([
            init_T, _fpfh_start_transforms(cs, cd, fkey, fpfh_starts,
                                           coarse_leaf, fpfh_k_corr)])
        m = init_T.shape[0]

    tile = lambda a: jnp.broadcast_to(a[None], (m, *a.shape))
    bs = PointCloud(xyz=tile(cs.xyz), mask=tile(cs.mask))
    bd = PointCloud(xyz=tile(cd.xyz), mask=tile(cd.mask))
    from ..ops.icp import icp_batched
    corr = (coarse_corr_dist if coarse_corr_dist is not None
            else 4.0 * coarse_leaf)
    res = icp_batched(bs, bd, init_T=init_T, iterations=coarse_iterations,
                      max_corr_dist=corr, query_tile=query_tile,
                      ref_tile=ref_tile, trim_fraction=coarse_trim)
    # most inliers wins; mean error (<= corr^2 by construction) tie-breaks
    score = res.num_inliers.astype(jnp.float32) \
        - res.mean_error / jnp.asarray(corr, jnp.float32) ** 2
    best = jnp.argmax(score)
    t0 = res.T[best]

    icp_res = None
    T = t0
    if refine:
        refine_kw.setdefault("max_corr_dist", 2.0 * coarse_leaf)
        icp_res = icp_converge(src, dst, init_T=t0, **refine_kw)
        T = icp_res.T
    return RegistrationResult(T=T, initial_T=t0, icp=icp_res)


def write_cal(path: str, result: RegistrationResult) -> None:
    save_cal(path, np.asarray(result.T))
