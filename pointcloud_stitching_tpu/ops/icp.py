"""Iterative Closest Point, fully on-device.

On-device equivalent of ``pcl::IterativeClosestPoint::align`` (reference:
registration/ tool; SURVEY.md §2.2 row 7 and §3.4). PCL's CPU loop
(KD-tree correspondences → SVD solve → repeat until epsilon/max-iter) becomes
a ``lax.fori_loop`` whose body is: tiled brute-force NN →
max-distance correspondence rejection → weighted Kabsch. Fixed iteration
count keeps the program jit-static; a while_loop variant with PCL-style
transformation-epsilon termination is provided for offline registration.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.platform import kernel_impl
from ..utils.types import PointCloud
from .kabsch import kabsch
from .nn import nearest_neighbors
from .se3 import mm, se3_apply


class ICPResult(NamedTuple):
    T: jax.Array          # [4, 4] refined src→dst transform
    mean_error: jax.Array  # mean squared correspondence distance (inliers)
    num_inliers: jax.Array
    iterations: jax.Array


def _nn_batched_xla(query, ref, ref_mask, query_tile, ref_tile):
    """[B, N, 3] vs [B, M, 3] pairwise NN, portable XLA path (the pallas
    path pre-prepares the reference once per ICP call instead)."""
    return jax.vmap(
        lambda q, r, rm: nearest_neighbors(
            q, r, rm, query_tile=query_tile, ref_tile=ref_tile, impl="xla")
    )(query, ref, ref_mask)


def _make_nn_batched(dst: PointCloud, query_tile: int, ref_tile: int,
                     nn_impl: str, nn_interpret: bool):
    """Resolve the batched-NN backend once per ICP call: nn(p)->(idx, d2).

    On the Pallas path the reference cloud is loop-invariant, so it is
    masked and padded once here. query_tile/ref_tile tile the XLA sweep;
    the kernel keeps its own tile sizes.
    """
    if kernel_impl(nn_impl, nn_interpret) == "pallas":
        from ..kernels.nn_pallas import nn_prepared, prepare_ref
        planes = prepare_ref(dst.xyz, dst.mask)
        return lambda p: nn_prepared(p, planes, num_ref=dst.xyz.shape[1],
                                     interpret=nn_interpret)
    return lambda p: _nn_batched_xla(p, dst.xyz, dst.mask,
                                     query_tile, ref_tile)


def _trim_weights(w, d2, trim_fraction):
    """Zero the worst trim_fraction of currently-accepted correspondences.

    Trimmed ICP (robustness under partial overlap): per iteration, keep the
    (1-f) best matches by distance among those passing the hard gate. The
    quantile sorts only the (small) ICP cloud, so the cost is negligible.
    """
    if trim_fraction <= 0.0:
        return w
    # nanquantile, NOT quantile: rejected/masked entries are NaN, and
    # jnp.quantile returns NaN whenever any NaN is present — which would
    # silently disable trimming for every realistically padded cloud.
    q = jnp.nanquantile(jnp.where(w > 0, d2, jnp.nan),
                        1.0 - trim_fraction, axis=-1, keepdims=True,
                        method="lower")
    q = jnp.where(jnp.isnan(q), jnp.inf, q)  # nothing accepted: keep w as-is
    return jnp.where(d2 <= q, w, 0.0)


@partial(jax.jit, static_argnames=("iterations", "query_tile", "ref_tile",
                                   "nn_impl", "trim_fraction",
                                   "nn_interpret"))
def icp_batched(src: PointCloud, dst: PointCloud,
                init_T: jax.Array | None = None, iterations: int = 5,
                max_corr_dist: float | jax.Array = 0.1,
                query_tile: int = 1024, ref_tile: int = 4096,
                nn_impl: str = "auto",
                trim_fraction: float = 0.0,
                nn_interpret: bool = False) -> ICPResult:
    """Fixed-iteration ICP over B independent cloud pairs at once.

    src/dst are batched PointClouds ([B, N, 3] xyz). All B correspondence
    searches run as one batched-NN kernel per iteration (the stitcher's
    ring drift correction runs ncam-1 pairs this way — SURVEY.md §2.4).
    trim_fraction > 0 additionally drops that fraction of the worst accepted
    matches each iteration (trimmed ICP, for partial overlap).
    """
    b = src.xyz.shape[0]
    # derive loop carries from the inputs so shard_map's varying-axis type
    # system accepts the fori_loop (plain constants are 'unvarying' and
    # mismatch the body outputs under manual sharding)
    zero_b = src.xyz[:, 0, 0] * 0.0                     # [B]
    if init_T is None:
        init_T = jnp.eye(4, dtype=jnp.float32) + zero_b[:, None, None]
    else:
        init_T = init_T + zero_b[:, None, None]
    max_d2 = jnp.asarray(max_corr_dist, jnp.float32) ** 2

    nn = _make_nn_batched(dst, query_tile, ref_tile, nn_impl, nn_interpret)

    def body(_, carry):
        T, _, _ = carry
        p = se3_apply(T, src.xyz)                       # [B, N, 3]
        idx, d2 = nn(p)
        w = (src.mask & (d2 <= max_d2)).astype(jnp.float32)
        w = _trim_weights(w, d2, trim_fraction)
        matched = jnp.take_along_axis(dst.xyz, idx[..., None], axis=1)
        dT = jax.vmap(kabsch)(p, matched, w)
        n_in = jnp.sum(w, axis=-1)
        err = jnp.sum(w * d2, axis=-1) / jnp.maximum(n_in, 1.0)
        return (mm(dT, T), err, n_in)

    T, err, n_in = jax.lax.fori_loop(
        0, iterations, body,
        (init_T, zero_b + jnp.inf, zero_b))
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.astype(jnp.int32),
                     iterations=jnp.full((b,), iterations, jnp.int32))


def _exp_se3(x: jax.Array) -> jax.Array:
    """Small-motion SE(3) from x = [omega, t] (the point-to-plane update).

    Rodrigues for the rotation; translation applied directly (the standard
    point-to-plane linearisation). Batched over leading dims.
    """
    from .se3 import se3_from_rt, so3_exp
    return se3_from_rt(so3_exp(x[..., :3]), x[..., 3:])


@partial(jax.jit, static_argnames=("iterations", "query_tile", "ref_tile",
                                   "nn_impl", "trim_fraction",
                                   "nn_interpret"))
def icp_point_to_plane_batched(src: PointCloud, dst: PointCloud,
                               dst_normals: jax.Array,
                               init_T: jax.Array | None = None,
                               iterations: int = 5,
                               max_corr_dist: float | jax.Array = 0.1,
                               query_tile: int = 1024, ref_tile: int = 4096,
                               nn_impl: str = "auto",
                               trim_fraction: float = 0.0,
                               nn_interpret: bool = False) -> ICPResult:
    """Point-to-plane ICP over B cloud pairs (Chen & Medioni formulation).

    Minimises sum w ((R p + t - q) . n_q)^2 per iteration via the linearised
    6x6 normal equations. Beyond-reference capability: converges in roughly
    half the iterations of point-to-point and does not slide along smooth
    surfaces. dst_normals: [B, M, 3] unit normals (see ops/normals.py);
    correspondences with near-zero normals are dropped.
    """
    b = src.xyz.shape[0]
    zero_b = src.xyz[:, 0, 0] * 0.0                     # [B]; see icp_batched
    if init_T is None:
        init_T = jnp.eye(4, dtype=jnp.float32) + zero_b[:, None, None]
    else:
        init_T = init_T + zero_b[:, None, None]
    max_d2 = jnp.asarray(max_corr_dist, jnp.float32) ** 2

    nn = _make_nn_batched(dst, query_tile, ref_tile, nn_impl, nn_interpret)

    def body(_, carry):
        T, _, _ = carry
        p = se3_apply(T, src.xyz)                        # [B, N, 3]
        idx, d2 = nn(p)
        q = jnp.take_along_axis(dst.xyz, idx[..., None], axis=1)
        n = jnp.take_along_axis(dst_normals, idx[..., None], axis=1)
        n_ok = jnp.sum(n * n, axis=-1) > 0.25            # unit or zeroed
        w = (src.mask & (d2 <= max_d2) & n_ok).astype(jnp.float32)
        w = _trim_weights(w, d2, trim_fraction)

        r0 = jnp.sum((p - q) * n, axis=-1)               # [B, N]
        J = jnp.concatenate([jnp.cross(p, n), n], axis=-1)  # [B, N, 6]
        wJ = w[..., None] * J
        A = jnp.einsum("bni,bnj->bij", wJ, J, precision="highest")
        rhs = -jnp.einsum("bni,bn->bi", J, w * r0, precision="highest")
        # Tikhonov floor keeps degenerate frames (all-rejected) solvable
        A = A + 1e-8 * jnp.eye(6, dtype=jnp.float32)
        x = jnp.linalg.solve(A, rhs[..., None])[..., 0]
        n_in = jnp.sum(w, axis=-1)
        x = jnp.where((n_in > 5.0)[:, None], x, 0.0)     # identity if starved
        dT = _exp_se3(x)
        err = jnp.sum(w * r0 * r0, axis=-1) / jnp.maximum(n_in, 1.0)
        return (mm(dT, T), err, n_in)

    T, err, n_in = jax.lax.fori_loop(
        0, iterations, body,
        (init_T, zero_b + jnp.inf, zero_b))
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.astype(jnp.int32),
                     iterations=jnp.full((b,), iterations, jnp.int32))


def _icp_step(T, src_xyz, src_mask, dst_xyz, dst_mask, max_dist2,
              query_tile, ref_tile, nn_impl, trim_fraction=0.0,
              prune=False):
    p = se3_apply(T, src_xyz)
    impl = kernel_impl(nn_impl)
    if prune and impl == "pallas":
        from ..kernels.nn_pallas import nearest_neighbors_pruned
        idx, d2 = nearest_neighbors_pruned(
            p[None], dst_xyz[None], dst_mask[None], src_mask[None])
        idx, d2 = idx[0], d2[0]
    else:
        idx, d2 = nearest_neighbors(p, dst_xyz, dst_mask,
                                    query_tile=query_tile,
                                    ref_tile=ref_tile, impl=impl)
    w = (src_mask & (d2 <= max_dist2)).astype(jnp.float32)
    w = _trim_weights(w, d2, trim_fraction)
    matched = dst_xyz[idx]
    dT = kabsch(p, matched, w)
    n_in = jnp.sum(w)
    err = jnp.sum(w * d2) / jnp.maximum(n_in, 1.0)
    return mm(dT, T), err, n_in


@partial(jax.jit, static_argnames=("iterations", "query_tile", "ref_tile",
                                   "nn_impl", "trim_fraction", "prune"))
def icp(src: PointCloud, dst: PointCloud, init_T: jax.Array | None = None,
        iterations: int = 5, max_corr_dist: float | jax.Array = 0.1,
        query_tile: int = 1024, ref_tile: int = 4096,
        nn_impl: str = "auto", trim_fraction: float = 0.0,
        prune: bool = False) -> ICPResult:
    """Fixed-iteration ICP (streaming-friendly: constant cost per frame).

    prune=True uses the key-range-pruned NN kernel (exact on voxel-sorted
    clouds — see kernels.nn_pallas.nearest_neighbors_pruned). Pruning needs
    the Pallas kernel: where nn_impl resolves to XLA (no GPU, or
    nn_impl="xla") it runs the unpruned brute-force NN — same results.
    """
    if init_T is None:
        init_T = jnp.eye(4, dtype=jnp.float32)
    max_d2 = jnp.asarray(max_corr_dist, jnp.float32) ** 2

    def body(_, carry):
        T, _, _ = carry
        T2, err, n_in = _icp_step(T, src.xyz, src.mask, dst.xyz, dst.mask,
                                  max_d2, query_tile, ref_tile, nn_impl,
                                  trim_fraction, prune)
        return (T2, err, n_in)

    T, err, n_in = jax.lax.fori_loop(
        0, iterations, body,
        (init_T, jnp.float32(jnp.inf), jnp.float32(0.0)))
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.astype(jnp.int32),
                     iterations=jnp.int32(iterations))


@partial(jax.jit, static_argnames=("max_iterations", "query_tile", "ref_tile",
                                   "nn_impl", "trim_fraction", "prune"))
def icp_converge(src: PointCloud, dst: PointCloud,
                 init_T: jax.Array | None = None,
                 max_iterations: int = 50,
                 transformation_epsilon: float = 1e-8,
                 max_corr_dist: float | jax.Array = 0.25,
                 query_tile: int = 1024, ref_tile: int = 4096,
                 nn_impl: str = "auto",
                 trim_fraction: float = 0.0,
                 prune: bool = False) -> ICPResult:
    """ICP with PCL-style termination: stop when the incremental transform's
    deviation from identity drops below ``transformation_epsilon`` (Frobenius
    norm squared) or after ``max_iterations``. Offline-registration variant.
    prune=True only takes effect on the Pallas kernel (see ``icp``).
    """
    if init_T is None:
        init_T = jnp.eye(4, dtype=jnp.float32)
    max_d2 = jnp.asarray(max_corr_dist, jnp.float32) ** 2
    eye = jnp.eye(4, dtype=jnp.float32)

    def cond(carry):
        _, _, _, it, delta = carry
        return (it < max_iterations) & (delta > transformation_epsilon)

    def body(carry):
        T, _, _, it, _ = carry
        T2, err, n_in = _icp_step(T, src.xyz, src.mask, dst.xyz, dst.mask,
                                  max_d2, query_tile, ref_tile, nn_impl,
                                  trim_fraction, prune)
        from .se3 import se3_inverse
        # rigid inverse: transpose + negate, exact. mm (HIGHEST), not `@`:
        # a reduced-precision product (bf16 or TF32) rounds dT's entries at
        # ~1e-3, so delta floors near 1e-5 and epsilon termination never
        # fires
        dT = mm(T2, se3_inverse(T))
        delta = jnp.sum((dT - eye) ** 2)
        return (T2, err, n_in, it + 1, delta)

    T, err, n_in, it, _ = jax.lax.while_loop(
        cond, body,
        (init_T, jnp.float32(jnp.inf), jnp.float32(0.0), jnp.int32(0),
         jnp.float32(jnp.inf)))
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.astype(jnp.int32),
                     iterations=it)
