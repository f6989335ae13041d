"""Euclidean cluster extraction on fixed-shape clouds.

On-device role of ``pcl::EuclideanClusterExtraction`` (the canonical step
after plane removal: split the remaining scene into objects). PCL grows
clusters point by point through KD-tree radius searches — a serial,
pointer-chasing algorithm. The accelerator formulation is grid connectivity plus
parallel label propagation:

  1. quantize to a voxel grid at leaf = ``tolerance``: any two points
     within ``tolerance`` land in the same or 26-adjacent voxels, so voxel
     adjacency over-approximates the radius graph (two points in touching
     voxels can be up to ``2*sqrt(3)*tolerance`` apart — clusters separated
     by less than that may merge; clusters separated by more never do, and
     points within ``tolerance`` always connect). That approximation is
     what buys the data-parallel form; for exact-radius semantics at the
     gap scale, shrink ``tolerance`` accordingly.
  2. unique voxels by one sort (the framework's standard scatter
     substitute); neighbor lookups are 13 symmetric offset probes into the
     sorted key array (binary search — no hash map, no tree),
  3. connected components by iterated min-label propagation over the probe
     edges with pointer jumping (``l = l[l]``) between rounds — converges
     in O(log diameter) rounds inside one ``lax.while_loop``,
  4. clusters rank by point count; the top ``max_clusters`` that clear
     ``min_size`` get ids 0..k-1 (PCL's size-filtered extraction), all
     other points label -1.

Everything is fixed shape; one compiled program serves every frame.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud
from .voxel import voxel_indices, _SENTINEL


def _linearize(ijk, ny, nz, valid):
    key = (ijk[..., 0] * ny + ijk[..., 1]) * nz + ijk[..., 2]
    return jnp.where(valid, key, _SENTINEL)


@partial(jax.jit, static_argnames=("max_clusters", "rounds"))
def euclidean_clusters(pc: PointCloud, tolerance, min_size: int = 1,
                       max_clusters: int = 16, rounds: int | None = None):
    """Cluster a cloud by Euclidean proximity (voxel connectivity).

    Args:
      pc: cloud [N, 3] + mask.
      tolerance: cluster distance (meters, traced) — the voxel leaf.
      min_size: clusters below this many POINTS are dropped (traced ok).
      max_clusters: static — how many clusters (largest first) get ids.
      rounds: propagation-round cap; None = a safe bound (log2-jumping
        converges long before; the while_loop exits early on fixpoint).

    Returns (labels [N] int32: cluster id 0..max_clusters-1 largest-first,
    -1 for invalid/small-cluster points; num_clusters ≥-min_size found,
    capped at max_clusters; sizes [max_clusters] int32 point counts).

    Scene-size bound: the linearized int32 voxel key requires
    nx*ny*nz < 2^31 occupied-extent cells at leaf = ``tolerance`` (the
    same index class PCL's VoxelGrid refuses past; ~128 m of extent at a
    1 cm tolerance). Past it keys would alias and weld distant points, so
    the guard FAILS SAFE instead: every label -1, num_clusters 0 —
    coarsen the tolerance or crop the cloud first.
    """
    xyz, mask = pc.xyz, pc.mask
    n = xyz.shape[0]
    ijk = voxel_indices(xyz, mask, tolerance)
    valid = ijk[..., 0] != _SENTINEL
    mx = jnp.max(jnp.where(valid[..., None], ijk, -1), axis=-2)
    ext = mx + 1
    ny = jnp.maximum(ext[1], 1)
    nz = jnp.maximum(ext[2], 1)
    # int32-key bound (see docstring): past 2^31 cells keys alias and
    # distant points weld — degrade to the documented fail-safe output by
    # invalidating every point (traced, so no recompile)
    cells_ok = (jnp.prod(ext.astype(jnp.float32)) < float(2 ** 31)) \
        & jnp.all(ext >= 0)
    valid = valid & cells_ok
    key = _linearize(ijk, ny, nz, valid)

    # unique voxels via one sort; remember each point's voxel slot
    order = jnp.argsort(key)
    skey = key[order]
    svalid = skey != _SENTINEL
    prev = jnp.concatenate([jnp.full((1,), -1, skey.dtype), skey[:-1]])
    flags = (skey != prev) & svalid
    vox_sorted = jnp.cumsum(flags.astype(jnp.int32)) - 1      # [N] slot ids
    vox_sorted = jnp.where(svalid, vox_sorted, n - 1)
    vox_of_point = jnp.zeros((n,), jnp.int32).at[order].set(vox_sorted)
    # sorted unique keys land in slots 0..V-1 (sentinel elsewhere)
    ukeys = jnp.full((n,), _SENTINEL, skey.dtype).at[vox_sorted].min(
        jnp.where(svalid, skey, _SENTINEL))
    uvalid = ukeys != _SENTINEL

    # neighbor probes: 13 symmetric offsets cover all 26 directions
    uz = jnp.where(uvalid, ukeys, 0)
    uiz = uz % nz
    ut = uz // nz
    uiy = ut % ny
    uix = ut // ny
    offs = [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if (dx, dy, dz) > (0, 0, 0)]
    nb_idx = []
    nb_ok = []
    for dx, dy, dz in offs:
        nix, niy, niz = uix + dx, uiy + dy, uiz + dz
        inside = ((nix >= 0) & (nix < ext[0]) & (niy >= 0) & (niy < ny)
                  & (niz >= 0) & (niz < nz) & uvalid)
        nkey = (nix * ny + niy) * nz + niz
        j = jnp.searchsorted(ukeys, nkey)
        j = jnp.minimum(j, n - 1).astype(jnp.int32)
        found = inside & (ukeys[j] == nkey)
        nb_idx.append(j)
        nb_ok.append(found)
    nb_idx = jnp.stack(nb_idx)          # [13, N]
    nb_ok = jnp.stack(nb_ok)

    labels0 = jnp.where(uvalid, jnp.arange(n, dtype=jnp.int32), n - 1)

    def propagate(l):
        nb = jnp.where(nb_ok, l[nb_idx], jnp.int32(n - 1))
        pulled = jnp.minimum(l, jnp.min(nb, axis=0))   # pull from neighbors
        # push the other direction (min-scatter): edges are symmetric
        l2 = pulled.at[jnp.where(nb_ok, nb_idx, n - 1).reshape(-1)].min(
            jnp.where(nb_ok, pulled[None, :], jnp.int32(n - 1)).reshape(-1))
        l2 = l2[l2]                                    # pointer jumping
        return l2[l2]

    if rounds is None:
        rounds = 64  # 2^(2*64) reachable span — far past any real scene

    def cond(state):
        i, l, changed = state
        return changed & (i < rounds)

    def body(state):
        i, l, _ = state
        l2 = propagate(l)
        return i + 1, l2, jnp.any(l2 != l)

    _, labels, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), propagate(labels0), jnp.bool_(True)))

    # per-point root label -> cluster sizes in POINTS at each root slot
    lab_pt = jnp.where(mask & valid, labels[vox_of_point], n - 1)
    sizes_at_root = jax.ops.segment_sum(
        (mask & valid).astype(jnp.int32), lab_pt, num_segments=n)
    # roots only (a root labels itself); kill the dump slot n-1 unless it
    # genuinely is a root of a real cluster — sentinel points were summed
    # into n-1, so subtract them by masking: sizes at non-root slots are 0
    is_root = (labels == jnp.arange(n)) & uvalid
    sizes_at_root = jnp.where(is_root, sizes_at_root, 0)
    return _rank_from_sizes(sizes_at_root, lab_pt, mask & valid,
                            min_size, max_clusters)


def _rank_from_sizes(sizes_at_root, lab_pt, active, min_size,
                     max_clusters):
    """Shared extraction tail: root-slot sizes -> size-filtered,
    largest-first relabel (labels 0..k-1 / -1, num, sizes). Root "slots"
    are voxel slots in the voxel variant and point indices in the exact
    variants; only the caller knows which, so it supplies sizes_at_root
    and the per-point root slot lab_pt."""
    n = sizes_at_root.shape[0]
    k = max_clusters
    top_sizes, top_roots = jax.lax.top_k(sizes_at_root, k)
    min_size = jnp.asarray(min_size, jnp.int32)
    keep = top_sizes >= jnp.maximum(min_size, 1)
    num = jnp.sum(keep.astype(jnp.int32))
    rank_of_root = jnp.full((n,), -1, jnp.int32).at[top_roots].set(
        jnp.where(keep, jnp.arange(k, dtype=jnp.int32), -1))
    out_labels = jnp.where(active, rank_of_root[lab_pt], -1)
    return out_labels, num, jnp.where(keep, top_sizes, 0)


def _propagate_exact(xyz, mask, r2, cos_thr, normals, rounds,
                     query_tile, ref_tile):
    """Min-label propagation + pointer jumping over the EXACT pairwise
    graph: edge(i, j) iff |p_i - p_j|^2 <= r2 (and, when ``normals`` is
    given, |n_i . n_j| >= cos_thr — the region-growing smoothness gate).
    Each round is a blockwise all-pairs sweep (the ops/nn.py [tile, block]
    pattern; no KD-tree, no neighbor lists). Returns per-point root labels
    (n-1 for invalid points)."""
    n = xyz.shape[0]
    qt, rt = min(query_tile, n), min(ref_tile, n)
    nq, nr = -(-n // qt), -(-n // rt)
    pad_n = max(nq * qt, nr * rt)
    pxyz = jnp.pad(xyz, ((0, pad_n - n), (0, 0)))
    pmask = jnp.pad(mask, (0, pad_n - n))
    pnrm = None if normals is None else jnp.pad(
        normals, ((0, pad_n - n), (0, 0)))

    def pull(l):
        pl = jnp.pad(l, (0, pad_n - n), constant_values=n - 1)

        def query_block(qi):
            q = jax.lax.dynamic_slice(pxyz, (qi * qt, 0), (qt, 3))
            qv = jax.lax.dynamic_slice(pmask, (qi * qt,), (qt,))
            own = jax.lax.dynamic_slice(pl, (qi * qt,), (qt,))
            qn = None if pnrm is None else jax.lax.dynamic_slice(
                pnrm, (qi * qt, 0), (qt, 3))

            def ref_step(ri, best):
                r = jax.lax.dynamic_slice(pxyz, (ri * rt, 0), (rt, 3))
                rv = jax.lax.dynamic_slice(pmask, (ri * rt,), (rt,))
                lb = jax.lax.dynamic_slice(pl, (ri * rt,), (rt,))
                d = q[:, None, :] - r[None, :, :]
                d2 = jnp.sum(d * d, axis=-1)
                inside = (d2 <= r2) & qv[:, None] & rv[None, :]
                if pnrm is not None:
                    rn = jax.lax.dynamic_slice(pnrm, (ri * rt, 0), (rt, 3))
                    cosang = jnp.abs(jnp.sum(qn[:, None, :] * rn[None, :, :],
                                             axis=-1))
                    inside = inside & (cosang >= cos_thr)
                cand = jnp.where(inside, lb[None, :], jnp.int32(n - 1))
                return jnp.minimum(best, jnp.min(cand, axis=1))

            return jax.lax.fori_loop(0, nr, ref_step, own)

        out = jax.lax.map(query_block, jnp.arange(nq)).reshape(-1)[:n]
        return jnp.where(mask, out, jnp.int32(n - 1))

    labels0 = jnp.where(mask, jnp.arange(n, dtype=jnp.int32), n - 1)

    def cond(state):
        i, l, changed = state
        return changed & (i < rounds)

    def body(state):
        i, l, _ = state
        l2 = pull(l)
        l2 = l2[l2]
        l2 = l2[l2]
        # re-mask after jumping: an invalid point's n-1 label would index
        # point n-1's (possibly real) label and fake a change at fixpoint
        l2 = jnp.where(mask, l2, jnp.int32(n - 1))
        return i + 1, l2, jnp.any(l2 != l)

    _, labels, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), pull(labels0), jnp.bool_(True)))
    return labels


def _rank_tail(labels, mask, min_size, max_clusters):
    """Size-filtered largest-first relabel (shared extraction contract):
    per-point root labels in point space -> (labels 0..k-1 / -1, num,
    sizes)."""
    n = labels.shape[0]
    lab_pt = jnp.where(mask, labels, n - 1)
    sizes_at_root = jax.ops.segment_sum(
        mask.astype(jnp.int32), lab_pt, num_segments=n)
    is_root = (labels == jnp.arange(n)) & mask
    sizes_at_root = jnp.where(is_root, sizes_at_root, 0)
    return _rank_from_sizes(sizes_at_root, lab_pt, mask,
                            min_size, max_clusters)


@partial(jax.jit, static_argnames=("max_clusters", "rounds", "query_tile",
                                   "ref_tile"))
def euclidean_clusters_exact(pc: PointCloud, tolerance, min_size: int = 1,
                             max_clusters: int = 16,
                             rounds: int | None = None,
                             query_tile: int = 512, ref_tile: int = 1024):
    """Cluster by EXACT radius connectivity (PCL's precise semantics).

    ``euclidean_clusters`` buys its data-parallel form by clustering over
    voxel adjacency, which can merge clusters separated by less than
    ``2*sqrt(3)*tolerance`` (its docstring, step 1). This variant keeps
    pcl::EuclideanClusterExtraction's exact contract — points connect iff
    ``|p_i - p_j| <= tolerance`` — via ``_propagate_exact``.

    Cost is O(N^2) per round (log-diameter rounds): for cluster-analysis
    scale — voxel skeletons, plane-removed remainders, <= ~16k points.
    Full fused outputs should use ``euclidean_clusters`` (linear) or
    downsample first.

    Same returns as ``euclidean_clusters``.
    """
    r2 = jnp.square(jnp.asarray(tolerance, jnp.float32))
    labels = _propagate_exact(pc.xyz, pc.mask, r2, None, None,
                              64 if rounds is None else rounds,
                              query_tile, ref_tile)
    return _rank_tail(labels, pc.mask, min_size, max_clusters)


@partial(jax.jit, static_argnames=("max_clusters", "rounds", "query_tile",
                                   "ref_tile"))
def region_growing(pc: PointCloud, normals: jax.Array, tolerance,
                   angle_threshold, normals_valid: jax.Array | None = None,
                   curvature: jax.Array | None = None,
                   curvature_threshold=None,
                   min_size: int = 1, max_clusters: int = 16,
                   rounds: int | None = None,
                   query_tile: int = 512, ref_tile: int = 1024):
    """Smoothness-constrained segmentation (pcl::RegionGrowing role).

    Splits a scene into smooth surface patches: two points join the same
    region iff they are within ``tolerance`` AND their normals agree to
    within ``angle_threshold`` (radians, traced; compared as |n_i . n_j|
    so normal sign flips don't split a surface). PCL grows regions
    serially from low-curvature seeds, comparing each neighbor's normal
    to the current point's — i.e. smoothness is enforced pairwise along
    the growth path, which is exactly the transitive closure of this
    pairwise-gated graph, so the parallel min-label propagation form
    (``_propagate_exact``) keeps PCL's smooth-mode semantics without the
    serial queue.

    PCL's secondary curvature test maps to the optional
    ``curvature``/``curvature_threshold`` pair (``ops.estimate_curvature``):
    high-curvature points (creases, edges) are excluded — they get label
    -1 and stop regions from bleeding across sharp edges that happen to
    have a smooth chain around them.

    Same returns as ``euclidean_clusters``.
    """
    valid = pc.mask if normals_valid is None else pc.mask & normals_valid
    if curvature is not None:
        if curvature_threshold is None:
            raise ValueError("curvature needs curvature_threshold")
        valid = valid & (curvature <= jnp.asarray(curvature_threshold,
                                                  jnp.float32))
    r2 = jnp.square(jnp.asarray(tolerance, jnp.float32))
    cos_thr = jnp.cos(jnp.asarray(angle_threshold, jnp.float32))
    labels = _propagate_exact(pc.xyz, valid, r2, cos_thr, normals,
                              64 if rounds is None else rounds,
                              query_tile, ref_tile)
    return _rank_tail(labels, valid, min_size, max_clusters)


@partial(jax.jit, static_argnames=("max_clusters",))
def cluster_stats(pc: PointCloud, labels: jax.Array,
                  max_clusters: int = 16):
    """Per-cluster centroid and axis-aligned bounding box.

    The downstream consumer's first question about each extracted object
    (PCL idiom: getMinMax3D + compute3DCentroid per cluster). labels as
    returned by euclidean_clusters (-1 ignored).

    Returns (centroids [K, 3], aabb_lo [K, 3], aabb_hi [K, 3],
    counts [K]) — zero rows for absent clusters.
    """
    k = max_clusters
    lab = jnp.where((labels >= 0) & pc.mask, labels, k)
    w = (lab < k).astype(jnp.float32)
    sums = jax.ops.segment_sum(pc.xyz * w[:, None], lab, num_segments=k + 1)
    cnt = jax.ops.segment_sum(w, lab, num_segments=k + 1)
    centroids = sums[:k] / jnp.maximum(cnt[:k, None], 1.0)
    big = jnp.float32(3.4e38)
    lo_in = jnp.where(w[:, None] > 0, pc.xyz, big)
    hi_in = jnp.where(w[:, None] > 0, pc.xyz, -big)
    lo = jax.ops.segment_min(lo_in, lab, num_segments=k + 1)[:k]
    hi = jax.ops.segment_max(hi_in, lab, num_segments=k + 1)[:k]
    present = cnt[:k] > 0
    zero = jnp.zeros_like(centroids)
    return (jnp.where(present[:, None], centroids, zero),
            jnp.where(present[:, None], lo, zero),
            jnp.where(present[:, None], hi, zero),
            cnt[:k].astype(jnp.int32))


@partial(jax.jit, static_argnames=("max_clusters",))
def oriented_bboxes(pc: PointCloud, labels: jax.Array,
                    max_clusters: int = 16):
    """Per-cluster oriented bounding boxes from covariance eigenvectors.

    On-device role of ``pcl::MomentOfInertiaEstimation::getOBB`` run per
    extracted cluster (the object-analysis step after clustering: a tight
    box even when the object is rotated, where the AABB of
    ``cluster_stats`` over-covers). All clusters are solved at once: one
    pass of segment sums builds every 3x3 second-moment matrix, one
    batched ``eigh`` diagonalizes them, and the per-axis extents come from
    segment min/max of each point projected into ITS OWN cluster's frame
    (a gather of the axes by label — no per-cluster loop).

    Returns ``(centers [K,3], axes [K,3,3], half [K,3], counts [K])``:
    ``axes[k]`` rows are the box axes (major first, right-handed),
    world-frame corner = ``centers[k] + axes[k].T @ (s * half[k])`` for
    each sign vector s in {-1,1}^3. Zero rows for absent clusters;
    degenerate (<3 point) clusters get well-defined axes from eigh's
    orthonormal fallback.
    """
    k = max_clusters
    lab = jnp.where((labels >= 0) & pc.mask, labels, k)
    w = (lab < k).astype(jnp.float32)
    xyz = pc.xyz * w[:, None]
    cnt = jax.ops.segment_sum(w, lab, num_segments=k + 1)
    mean = (jax.ops.segment_sum(xyz, lab, num_segments=k + 1)
            / jnp.maximum(cnt[:, None], 1.0))                    # [k+1,3]
    # second moments E[pp^T] - cc^T (f32 around the centroid would need a
    # second pass; moments around the origin lose precision at range —
    # subtract the PER-CLUSTER mean first via a gather, one extra read)
    d = (pc.xyz - mean[lab]) * w[:, None]
    outer = d[:, :, None] * d[:, None, :]                        # [N,3,3]
    cov = (jax.ops.segment_sum(outer.reshape(-1, 9), lab,
                               num_segments=k + 1)[:k]
           / jnp.maximum(cnt[:k, None], 1.0)).reshape(k, 3, 3)
    evals, evecs = jnp.linalg.eigh(cov)                          # ascending
    axes = jnp.flip(evecs, axis=-1)                              # major first
    axes = jnp.transpose(axes, (0, 2, 1))                        # rows = axes
    # right-handed frame: minor axis = major x middle
    axes = axes.at[:, 2].set(jnp.cross(axes[:, 0], axes[:, 1]))
    # project each point into its own cluster's frame
    pad_axes = jnp.concatenate([axes, jnp.eye(3)[None]], 0)      # [k+1,3,3]
    q = jnp.einsum("nij,nj->ni", pad_axes[lab], d)               # [N,3]
    big = jnp.float32(3.4e38)
    lo = jax.ops.segment_min(jnp.where(w[:, None] > 0, q, big), lab,
                             num_segments=k + 1)[:k]
    hi = jax.ops.segment_max(jnp.where(w[:, None] > 0, q, -big), lab,
                             num_segments=k + 1)[:k]
    present = cnt[:k] > 0
    half = jnp.where(present[:, None], (hi - lo) / 2.0, 0.0)
    centers = jnp.where(
        present[:, None],
        mean[:k] + jnp.einsum("kij,kj->ki", jnp.transpose(axes, (0, 2, 1)),
                              (hi + lo) / 2.0), 0.0)
    axes = jnp.where(present[:, None, None], axes,
                     jnp.zeros_like(axes))
    return centers, axes, half, cnt[:k].astype(jnp.int32)
