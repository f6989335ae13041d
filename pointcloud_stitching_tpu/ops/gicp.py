"""Generalized ICP (plane-to-plane), fully on-device.

On-device role of ``pcl::GeneralizedIterativeClosestPoint`` (Segal et
al., RSS 2009) — the registration-family member between point-to-point
and point-to-plane: every point on BOTH clouds carries a surface
covariance (disc-shaped: free to slide in its tangent plane, stiff along
its normal), and each correspondence is weighted by the Mahalanobis
metric of the combined covariance

    M_i = (C_i^dst + R C_i^src R^T)^-1,
    cost = sum_i w_i d_i^T M_i d_i,   d_i = q_i - (R p_i + t).

PCL's loop is serial per correspondence (KD-tree search, per-point BFGS
cost terms); here every stage is batched: the NN search is the shared
tiled sweep (ops/nn.py / kernels/nn_pallas.py), the N combined 3x3
covariances invert in one batched solve, and the SE(3) update is one
6x6 Gauss-Newton step from einsum-reduced normal equations — the same
shape as the point-to-plane solver (ops/icp.py), of which GICP is the
full-metric generalisation (point-to-plane is M = n n^T exactly).

Covariances come from normals (``gicp_covariances``): C = eps n n^T +
(I - n n^T), PCL's (eps, 1, 1) eigenvalue regularisation. Points
without a valid normal fall back to isotropic C = I, which degrades
those correspondences to point-to-point instead of dropping them.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud
from .icp import ICPResult, _exp_se3, _trim_weights
from .nn import nearest_neighbors
from .se3 import mm, se3_apply, se3_inverse


def gicp_covariances(normals: jax.Array, valid: jax.Array,
                     epsilon=1e-3) -> jax.Array:
    """Per-point GICP surface covariances [N, 3, 3] from unit normals.

    C = eps n n^T + (I - n n^T): eigenvalues (eps, 1, 1) with the small
    axis along the normal (Segal et al.'s regularised disc). Invalid
    normals get the isotropic identity (point-to-point behaviour).
    """
    eps = jnp.asarray(epsilon, jnp.float32)
    nnt = normals[..., :, None] * normals[..., None, :]
    eye = jnp.eye(3, dtype=jnp.float32)
    c = eye - (1.0 - eps) * nnt
    return jnp.where(valid[..., None, None], c, eye)


@partial(jax.jit, static_argnames=("max_iterations", "query_tile",
                                   "ref_tile", "nn_impl", "trim_fraction"))
def gicp(src: PointCloud, dst: PointCloud,
         src_normals: jax.Array, dst_normals: jax.Array,
         src_normals_valid: jax.Array | None = None,
         dst_normals_valid: jax.Array | None = None,
         init_T: jax.Array | None = None,
         max_iterations: int = 50,
         transformation_epsilon: float = 1e-8,
         max_corr_dist: float | jax.Array = 0.25,
         cov_epsilon=1e-3,
         query_tile: int = 1024, ref_tile: int = 4096,
         nn_impl: str = "auto",
         trim_fraction: float = 0.0) -> ICPResult:
    """Plane-to-plane ICP with PCL-style epsilon/max-iteration termination.

    Args:
      src, dst: clouds [N, 3] / [M, 3] (+masks).
      src_normals, dst_normals: [N, 3] / [M, 3] unit normals
        (ops.estimate_normals for unorganized clouds, ops.grid_normals
        for organized ones).
      *_normals_valid: optional validity; invalid-normal points use an
        isotropic covariance rather than dropping out.
      cov_epsilon: the small normal-direction eigenvalue (PCL's
        gicp_epsilon_, default 1e-3; 1.0 = isotropic = point-to-point).
      One Gauss-Newton step per correspondence set (PCL runs an inner
      BFGS; one linearised step per fresh NN set converges equivalently
      in practice and keeps the loop jit-static).

    Returns ICPResult; ``mean_error`` is the mean Mahalanobis residual
    d^T M d over inliers (not raw meters^2 — compare runs, not units).
    """
    sv = src.mask if src_normals_valid is None else \
        src.mask & src_normals_valid
    dv = dst.mask if dst_normals_valid is None else \
        dst.mask & dst_normals_valid
    c_src = gicp_covariances(src_normals, sv, cov_epsilon)   # [N, 3, 3]
    c_dst = gicp_covariances(dst_normals, dv, cov_epsilon)   # [M, 3, 3]

    if init_T is None:
        init_T = jnp.eye(4, dtype=jnp.float32)
    max_d2 = jnp.asarray(max_corr_dist, jnp.float32) ** 2
    eye4 = jnp.eye(4, dtype=jnp.float32)
    eye3 = jnp.eye(3, dtype=jnp.float32)

    def body(carry):
        T, _, _, it, _ = carry
        p = se3_apply(T, src.xyz)
        idx, d2 = nearest_neighbors(p, dst.xyz, dst.mask,
                                    query_tile=query_tile,
                                    ref_tile=ref_tile, impl=nn_impl)
        q = dst.xyz[idx]
        w = (src.mask & (d2 <= max_d2)).astype(jnp.float32)
        w = _trim_weights(w, d2, trim_fraction)

        r = T[:3, :3]
        ca = jnp.einsum("ij,njk,lk->nil", r, c_src, r,
                        precision="highest")
        csum = ca + c_dst[idx] + 1e-6 * eye3
        m = jnp.linalg.inv(csum)

        d = q - p
        # J[n] = [-[p_n]_x | I]  ([3, 6]); -[p]_x row i = e_i x p... build
        # from the cross-product expansion: (-[p]_x)[i, j] = -eps_ijk p_k
        zeros = jnp.zeros_like(p[:, 0])
        neg_px = jnp.stack([
            jnp.stack([zeros, p[:, 2], -p[:, 1]], -1),
            jnp.stack([-p[:, 2], zeros, p[:, 0]], -1),
            jnp.stack([p[:, 1], -p[:, 0], zeros], -1),
        ], axis=-2)                                          # [N, 3, 3]
        J = jnp.concatenate(
            [neg_px, jnp.broadcast_to(eye3, neg_px.shape)], axis=-1)
        mw = m * w[:, None, None]                            # [N, 3, 3]
        mJ = jnp.einsum("nik,nkj->nij", mw, J, precision="highest")
        A = jnp.einsum("nki,nkj->ij", J, mJ, precision="highest")
        b = jnp.einsum("nki,nk->i", mJ, d, precision="highest")
        A = A + 1e-8 * jnp.eye(6, dtype=jnp.float32)
        x = jnp.linalg.solve(A, b[:, None])[:, 0]
        n_in = jnp.sum(w)
        x = jnp.where(n_in > 5.0, x, jnp.zeros_like(x))
        dT = _exp_se3(x)
        T2 = mm(dT, T)
        err = jnp.sum(w * jnp.einsum("ni,nij,nj->n", d, m, d,
                                     precision="highest")) \
            / jnp.maximum(n_in, 1.0)
        delta = jnp.sum((mm(T2, se3_inverse(T)) - eye4) ** 2)
        return (T2, err, n_in, it + 1, delta)

    def cond(carry):
        _, _, _, it, delta = carry
        return (it < max_iterations) & (delta > transformation_epsilon)

    T, err, n_in, it, _ = jax.lax.while_loop(
        cond, body,
        (init_T, jnp.float32(jnp.inf), jnp.float32(0.0), jnp.int32(0),
         jnp.float32(jnp.inf)))
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.astype(jnp.int32),
                     iterations=it)
