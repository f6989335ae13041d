"""SE(3) rigid transforms on padded point clouds.

On-device equivalent of ``pcl::transformPointCloud`` with the per-camera
4x4 ``.cal`` extrinsics (reference: src/pcs-multicamera-client.cpp, Eigen
``Matrix4f`` loaded from .cal files; SURVEY.md §2.2 row 2).

``R @ p + t`` is expressed as one [N,3]x[3,3] matmul plus a broadcast add so
XLA fuses it with neighbouring elementwise work (and, batched over cameras,
it is one batched matrix product).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud


def mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Matmul at HIGHEST precision. A default-precision f32 matmul may run
    in TF32 on a GPU (10-bit mantissa) or bf16 elsewhere, which rounds
    rotation-matrix entries at ~1e-3 — catastrophic for composed
    extrinsics (kabsch recovered R with ~4e-3 max error through bf16 3x3
    products, 1e-6 with this).
    Every transform composition in the library routes through here."""
    return jnp.matmul(a, b, precision="highest")


def se3_apply(T: jax.Array, xyz: jax.Array) -> jax.Array:
    """Apply 4x4 (or batched [...,4,4]) rigid transform(s) to [..., N, 3] points."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return (jnp.einsum("...ij,...nj->...ni", R, xyz, precision="highest")
            + t[..., None, :])


def transform_cloud(T: jax.Array, pc: PointCloud) -> PointCloud:
    xyz = se3_apply(T, pc.xyz)
    xyz = jnp.where(pc.mask[..., None], xyz, 0.0)
    return pc.replace(xyz=xyz)


def se3_compose(A: jax.Array, B: jax.Array) -> jax.Array:
    """Return A @ B (apply B first, then A)."""
    return mm(A, B)


def se3_inverse(T: jax.Array) -> jax.Array:
    R = T[..., :3, :3]
    t = T[..., :3, 3:4]
    Rt = jnp.swapaxes(R, -1, -2)
    top = jnp.concatenate([Rt, -mm(Rt, t)], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], T.dtype), (*T.shape[:-2], 1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def se3_from_rt(R: jax.Array, t: jax.Array) -> jax.Array:
    top = jnp.concatenate([R, t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], R.dtype), (*R.shape[:-2], 1, 4))
    return jnp.concatenate([top, bottom], axis=-2)


def se3_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)


def so3_exp(omega: jax.Array) -> jax.Array:
    """Rodrigues: rotation vector [..., 3] -> rotation matrix [..., 3, 3].

    Autodiff-safe AT omega = 0: R = I + A [w]_x + B [w]_x^2 with
    A = sin(t)/t, B = (1-cos t)/t^2 series-guarded on t^2 — no norm() of
    a zero vector anywhere (its gradient is NaN, and a trailing where()
    cannot block it: NaN * 0 = NaN). NDT's optimizer takes jax.hessian
    THROUGH this at exactly omega = 0 every iteration.
    """
    t2 = jnp.sum(omega * omega, axis=-1, keepdims=True)   # theta^2
    small = t2 < 1e-12
    t2s = jnp.where(small, 1.0, t2)       # finite primal for BOTH branches
    th = jnp.sqrt(t2s)
    A = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(th) / th)
    B = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(th)) / t2s)
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = jnp.zeros_like(wx)
    K = jnp.stack([
        jnp.stack([zero, -wz, wy], axis=-1),
        jnp.stack([wz, zero, -wx], axis=-1),
        jnp.stack([-wy, wx, zero], axis=-1)], axis=-2)    # [w]_x, unnormalized
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), K.shape)
    return eye + A[..., None] * K + B[..., None] * mm(K, K)


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix [..., 3, 3] -> rotation vector [..., 3].

    Safe for small angles (series limit); not intended near theta = pi
    (loop-closure residuals and ICP increments are always tiny).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = jnp.arccos(cos)
    w = jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], axis=-1)  # 2 sin(theta) axis
    scale = jnp.where(theta < 1e-6, 0.5,
                      theta / jnp.maximum(2.0 * jnp.sin(theta), 1e-12))
    return w * scale[..., None]


def se3_power(T: jax.Array, alpha) -> jax.Array:
    """Fractional power of a near-identity rigid transform.

    Uses the pseudo log/exp pair on SO(3) x R^3 (rotation via so3_log/exp,
    translation scaled linearly) — exact at alpha in {0, 1}, smooth in
    between, and the same parameterisation as the ICP point-to-plane update.
    Used to distribute a ring loop-closure residual along the camera chain
    (models/stitcher._ring_drift_correction).
    """
    alpha = jnp.asarray(alpha, T.dtype)
    omega = so3_log(T[..., :3, :3])
    R = so3_exp(alpha[..., None] * omega)
    t = alpha[..., None] * T[..., :3, 3]
    return se3_from_rt(R, t)


def se3_blend(A: jax.Array, B: jax.Array, alpha) -> jax.Array:
    """Blend rigid transforms: (1-alpha)*A + alpha*B, re-projected to SE(3).

    Rotation part: linear blend followed by polar projection (SVD) back to
    the nearest rotation; translation: linear. Used for EMA extrinsic
    tracking, where alpha is small and the transforms are near each other.
    """
    alpha = jnp.asarray(alpha, A.dtype)
    M = (1.0 - alpha) * A[..., :3, :3] + alpha * B[..., :3, :3]
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(mm(U, Vt))
    S = jnp.broadcast_to(jnp.eye(3, dtype=A.dtype), M.shape).copy()
    S = S.at[..., 2, 2].set(det)
    R = mm(mm(U, S), Vt)
    t = (1.0 - alpha) * A[..., :3, 3] + alpha * B[..., :3, 3]
    return se3_from_rt(R, t)
