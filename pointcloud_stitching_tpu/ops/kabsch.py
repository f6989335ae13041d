"""Weighted Kabsch / Umeyama rigid alignment via SVD.

On-device equivalent of ``pcl::registration::TransformationEstimationSVD``
(reference: registration/ tool; SURVEY.md §2.2 row 6). The whole solve is a
masked reduction to a 3x3 cross-covariance (one matmul) followed by a 3x3 SVD
— tiny, fully on-device, differentiable, and batchable with vmap.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .se3 import mm, se3_from_rt


def kabsch(src: jax.Array, dst: jax.Array, weights: jax.Array) -> jax.Array:
    """Best-fit rigid transform T (4x4) minimising sum_i w_i |T*src_i - dst_i|^2.

    Args:
      src, dst: [N, 3] corresponding points.
      weights: [N] non-negative; zero drops a correspondence (masking).
    Returns identity when total weight is ~0 (degenerate frame — e.g. all
    correspondences rejected), so a streaming ICP step can never NaN out.
    """
    w = weights.astype(jnp.float32)
    wsum = jnp.sum(w)
    safe = wsum > 1e-6
    denom = jnp.where(safe, wsum, 1.0)
    cs = jnp.sum(w[:, None] * src, axis=0) / denom
    cd = jnp.sum(w[:, None] * dst, axis=0) / denom
    s = src - cs
    d = dst - cd
    # H = sum_i w_i s_i d_i^T  (3x3) — one [3,N]x[N,3] matmul
    H = jnp.einsum("ni,nj->ij", w[:, None] * s, d, precision="highest")
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(mm(Vt.T, U.T))
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0], jnp.float32)).at[2, 2].set(det)
    R = mm(mm(Vt.T, S), U.T)
    t = cd - mm(R, cs[:, None])[:, 0]
    T = se3_from_rt(R, t)
    return jnp.where(safe, T, jnp.eye(4, dtype=jnp.float32))
