"""Normal Distributions Transform registration, fully on-device.

On-device role of ``pcl::NormalDistributionsTransform`` (Biber &
Strasser 2003; Magnusson's 3D formulation) — the scan-to-map
registration family member: the target cloud becomes a grid of local
Gaussians (one mean + covariance per occupied cell), and a pose is
scored by how probable the transformed source points are under their
cells' Gaussians. No correspondences at all — the map IS the model,
which is why NDT is the classic choice for repeated localization
against a persistent map.

PCL's build is a per-cell accumulation loop and its optimizer is a
serial Newton iteration with hand-derived gradients. The accelerator
formulation:

  map build (``ndt_build``): one sort of the cell keys + segment sums
    give every cell's count / mean / second moment at once (the voxel
    machinery's pattern); a batched ``eigh`` regularises all covariances
    in one pass (small eigenvalues floored at ``eigen_floor`` x the
    largest, Magnusson's fix for degenerate planar cells) and they
    invert in one batched solve.
  scoring: transformed points -> cell keys -> ``searchsorted`` into the
    sorted key table (the binary-probe trick from ops/cluster.py — no
    hash map), gather (mu, inv_cov), one fused Mahalanobis + exponential
    over all points.
  optimisation (``ndt_align``): the score is a scalar jax function of
    the 6-dof increment, so the gradient AND the 6x6 Hessian come from
    ``jax.grad``/``jax.hessian`` instead of pages of hand-derived
    Jacobians; each Newton step tries a small fixed fan of step scales
    and keeps the best score (branchless substitute for PCL's
    More-Thuente line search). Cell assignment is piecewise-constant in
    the pose, so the lookup index is stop_gradient'ed — standard NDT
    semantics (the gradient lives in the Gaussian term).

The exponential score uses Magnusson's robustified mixture constants
(d1, d2 from ``outlier_ratio``), so a point in a wrong cell saturates
instead of dominating the Hessian.

Fixed shapes throughout: the map's tables are sized by the build cloud's
capacity with validity masks; cell size / outlier ratio are traced.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud
from .icp import ICPResult, _exp_se3
from .se3 import mm, se3_apply

_SENT = jnp.iinfo(jnp.int32).max


class NDTMap(NamedTuple):
    """A grid of Gaussians: sorted cell-key table + per-cell statistics."""
    keys: jax.Array      # [C] sorted linearized cell keys (sentinel-padded)
    mu: jax.Array        # [C, 3] cell means
    inv_cov: jax.Array   # [C, 3, 3] regularised inverse covariances
    valid: jax.Array     # [C] cell has >= min_points
    base: jax.Array      # [3] int32 grid origin (floor(min/cell))
    dims: jax.Array      # [3] int32 grid extents (for key arithmetic)
    cell: jax.Array      # scalar cell size (meters)


def _cell_keys(xyz, mask, cell, base, dims):
    """Linearized int32 cell keys (sentinel where invalid/out of grid)."""
    f = jnp.floor(xyz * (1.0 / cell)).astype(jnp.int32) - base
    inb = mask & jnp.all((f >= 0) & (f < dims), axis=-1)
    key = (f[..., 0] * dims[1] + f[..., 1]) * dims[2] + f[..., 2]
    return jnp.where(inb, key, _SENT), inb


@partial(jax.jit, static_argnames=("min_points",))
def ndt_build(dst: PointCloud, cell_size, min_points: int = 6,
              eigen_floor=0.05) -> NDTMap:
    """Build the NDT map (grid of Gaussians) from a target cloud.

    Cells with fewer than ``min_points`` members are invalid (their
    covariance is meaningless). Covariance eigenvalues below
    ``eigen_floor`` x the largest are floored (planar/linear cells stay
    invertible without distorting their principal structure). PCL floors
    at 0.01; the default here is 0.05 because razor-thin cell Gaussians
    shrink the optimizer's convergence basin to millimeters on smooth
    surfaces (measured: 52 mm stall at 0.01 vs 4 mm convergence at 0.05
    on the depth-camera-scale test scene) — set 0.01 for PCL-exact
    covariances when cells have true 3-D structure (coarse outdoor
    grids). The int32 key bound of the scene ops applies (extent^3
    cells < 2^31); past it the whole map degrades to invalid,
    fail-safe.
    """
    xyz, mask = dst.xyz, dst.mask
    n = xyz.shape[0]
    cell = jnp.asarray(cell_size, jnp.float32)
    f = jnp.floor(xyz * (1.0 / cell)).astype(jnp.int32)
    fm = jnp.where(mask[:, None], f, _SENT)
    base = jnp.min(fm, axis=0)
    base = jnp.where(base == _SENT, 0, base)          # all-invalid cloud
    mx = jnp.max(jnp.where(mask[:, None], f, jnp.iinfo(jnp.int32).min),
                 axis=0)
    dims = jnp.maximum(mx - base + 1, 1)
    cells_ok = jnp.prod(dims.astype(jnp.float32)) < float(2 ** 31)
    key, inb = _cell_keys(xyz, mask, cell, base, dims)
    key = jnp.where(cells_ok, key, _SENT)
    inb = inb & cells_ok

    order = jnp.argsort(key)
    skey = key[order]
    sxyz = xyz[order]
    svalid = skey != _SENT
    prev = jnp.concatenate([jnp.full((1,), -1, skey.dtype), skey[:-1]])
    flags = (skey != prev) & svalid
    slot = jnp.cumsum(flags.astype(jnp.int32)) - 1     # cell slot per point
    slot = jnp.where(svalid, slot, n - 1)

    w = svalid.astype(jnp.float32)
    cnt = jax.ops.segment_sum(w, slot, num_segments=n)
    sx = jax.ops.segment_sum(sxyz * w[:, None], slot, num_segments=n)
    # cell slots beyond the last real cell keep cnt 0 -> invalid below;
    # the dump slot n-1 may mix sentinel points in, but it is only valid
    # if it is ALSO a real cell's slot, in which case the sentinel points
    # contributed weight 0
    denom = jnp.maximum(cnt, 1.0)
    mu = sx / denom[:, None]
    # covariance from CENTERED residuals (second pass, one mu gather) —
    # NOT E[pp^T] - mu mu^T: origin moments of a scene tens of meters out
    # are ~1e4 with f32 ulp ~1e-3, and the subtraction cancels to noise
    # against ~1e-2-scale cell covariances (same fix as cluster.py's
    # oriented_bboxes). Residuals are cell-sized, so their squares are
    # computed at full relative precision.
    d = (sxyz - mu[slot]) * w[:, None]
    sdd = jax.ops.segment_sum(d[:, :, None] * d[:, None, :],
                              slot, num_segments=n)
    cov = sdd / denom[:, None, None]

    # Magnusson regularisation: floor small eigenvalues relative to the
    # largest, reconstruct, invert — all batched
    vals, vecs = jnp.linalg.eigh(cov + 1e-12 * jnp.eye(3, dtype=jnp.float32))
    vals = jnp.maximum(vals, jnp.asarray(eigen_floor, jnp.float32)
                       * jnp.maximum(vals[:, 2:], 1e-12))
    inv_vals = 1.0 / jnp.maximum(vals, 1e-12)
    inv_cov = jnp.einsum("nij,nj,nkj->nik", vecs, inv_vals, vecs,
                         precision="highest")
    cell_valid = cnt >= float(min_points)

    ukeys = jnp.full((n,), _SENT, skey.dtype).at[slot].min(
        jnp.where(svalid, skey, _SENT))
    return NDTMap(keys=ukeys, mu=mu, inv_cov=inv_cov,
                  valid=cell_valid & (ukeys != _SENT),
                  base=base, dims=dims, cell=cell)


def _ndt_consts(outlier_ratio, cell):
    """Magnusson's robust-mixture exponential constants d1, d2."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (cell ** 3)
    d3 = -jnp.log(c2)
    d1 = -jnp.log(c1 + c2) - d3
    d2 = -2.0 * jnp.log((-jnp.log(c1 * jnp.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


@partial(jax.jit, static_argnames=("max_iterations",))
def ndt_align(src: PointCloud, ndt_map: NDTMap,
              init_T: jax.Array | None = None,
              max_iterations: int = 35,
              transformation_epsilon: float = 1e-8,
              outlier_ratio=0.55, step_scales=None) -> ICPResult:
    """Register a cloud against an NDT map (scan-to-map localization).

    Maximises sum_i -d1 exp(-d2/2 (p'_i - mu)^T S^-1 (p'_i - mu)) over the
    pose by damped Newton with autodiff derivatives; every step evaluates
    a fan of step scales and keeps the best (see module docstring). The
    capture basin is about one cell — initialise within it (stitching
    rigs are; for global init compose with register_global).

    Returns ICPResult: ``mean_error`` is the mean Mahalanobis q over
    scoring points (not meters^2), ``num_inliers`` the points that landed
    in a valid cell at convergence.
    """
    if init_T is None:
        init_T = jnp.eye(4, dtype=jnp.float32)
    d1, d2 = _ndt_consts(jnp.asarray(outlier_ratio, jnp.float32),
                         ndt_map.cell)
    scales = jnp.asarray([1.0, 0.5, 0.25, 0.1, 0.03, 0.01] if step_scales is None
                         else step_scales, jnp.float32)
    kmask = ndt_map.valid

    def score_terms(x, T):
        p = se3_apply(mm(_exp_se3(x), T), src.xyz)
        key, inb = _cell_keys(p, src.mask, ndt_map.cell, ndt_map.base,
                              ndt_map.dims)
        j = jnp.searchsorted(ndt_map.keys, jax.lax.stop_gradient(key))
        j = jnp.minimum(j, ndt_map.keys.shape[0] - 1)
        hit = inb & (ndt_map.keys[j] == key) & kmask[j]
        dmu = p - ndt_map.mu[j]
        q = jnp.einsum("ni,nij,nj->n", dmu, ndt_map.inv_cov[j], dmu,
                       precision="highest")
        q = jnp.maximum(q, 0.0)
        s = jnp.where(hit, -d1 * jnp.exp(-0.5 * d2 * q), 0.0)
        return s, q, hit

    def score(x, T):
        return jnp.sum(score_terms(x, T)[0])

    grad_fn = jax.grad(score)
    hess_fn = jax.hessian(score)

    def body(carry):
        T, _, _, it, _ = carry
        z = jnp.zeros((6,), jnp.float32)
        g = grad_fn(z, T)
        H = hess_fn(z, T)
        # damp toward negative definite (we maximise): H - lam*I. The
        # damping must be RELATIVE to H's scale — the robustified score is
        # numerically tiny (|d1| ~ 1e-2), and any absolute floor would
        # swamp H and turn the solve into a huge 1/lam gradient step
        lam = 1e-2 * (jnp.linalg.norm(H) / 6.0 + 1e-12)
        dx = jnp.linalg.solve(H - lam * jnp.eye(6, dtype=jnp.float32),
                              -g[:, None])[:, 0]
        # guard non-finite solves (singular Hessian far from structure)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        # candidate fan: Newton at several scales, plus plain gradient
        # ascent normalised to fractions of a cell (rescues indefinite /
        # ill-scaled Hessians far from the basin), plus zero (= stop)
        gstep = g * (ndt_map.cell / (jnp.linalg.norm(g) + 1e-12))
        cand = jnp.concatenate([
            scales[:, None] * dx[None, :],
            jnp.asarray([0.3, 0.1, 0.03], jnp.float32)[:, None]
            * gstep[None, :],
            jnp.zeros((1, 6), jnp.float32)])
        cs = jax.vmap(lambda c: score(c, T))(cand)
        best = jnp.argmax(cs)
        bx = cand[best]
        s_new, q, hit = score_terms(bx, T)
        n_in = jnp.sum(hit)
        err = jnp.sum(jnp.where(hit, q, 0.0)) / jnp.maximum(n_in, 1)
        T2 = mm(_exp_se3(bx), T)
        delta = jnp.sum(bx * bx)
        return (T2, err, n_in.astype(jnp.float32), it + 1, delta)

    def cond(carry):
        _, _, _, it, delta = carry
        return (it < max_iterations) & (delta > transformation_epsilon)

    T, err, n_in, it, _ = jax.lax.while_loop(
        cond, body,
        (init_T, jnp.float32(jnp.inf), jnp.float32(0.0), jnp.int32(0),
         jnp.float32(jnp.inf)))
    return ICPResult(T=T, mean_error=err, num_inliers=n_in.astype(jnp.int32),
                     iterations=it)


@partial(jax.jit, static_argnames=("max_iterations", "min_points"))
def ndt(src: PointCloud, dst: PointCloud, cell_size,
        init_T: jax.Array | None = None, max_iterations: int = 35,
        transformation_epsilon: float = 1e-8, min_points: int = 6,
        outlier_ratio=0.55) -> ICPResult:
    """One-shot NDT: build the map from ``dst`` and align ``src`` to it.

    The pairwise-registration convenience wrapper (pcl::NDT's align());
    for repeated localization against one scene build the map once with
    ``ndt_build`` and call ``ndt_align`` per frame.
    """
    m = ndt_build(dst, cell_size, min_points=min_points)
    return ndt_align(src, m, init_T=init_T, max_iterations=max_iterations,
                     transformation_epsilon=transformation_epsilon,
                     outlier_ratio=outlier_ratio)
