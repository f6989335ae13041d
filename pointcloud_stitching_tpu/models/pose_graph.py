"""Multi-way extrinsic refinement: pose-graph optimization on SE(3).

Beyond-the-reference capability for the offline calibration workflow
(reference: registration/ produces INDEPENDENT pairwise .cal files —
SURVEY.md §3.4 — so chaining them around a ring accumulates drift, and a
measurement between non-adjacent cameras has nowhere to go). Given any set
of pairwise rigid measurements over the camera graph, this solves for the
globally most consistent world poses:

    minimize over {T_i}   sum_e  w_e * || r_e ||^2
    r_e = pseudo-log( (T_i @ T_e_meas)^-1 @ T_j )      for edge e = (i, j)

where ``T_e_meas`` maps camera j's frame into camera i's frame (exactly
what ``register_pair(src=cloud_j, dst=cloud_i)`` / a pairwise .cal file
contains), so a perfectly consistent graph has T_j == T_i @ T_e_meas for
every edge. The pseudo-log is the codebase's standard small-motion chart
([translation, rotation-vector] — the same parameterisation as
ops.se3.se3_power and the ICP updates), used both for the residual and as
the retraction for updates.

Design notes:
  * The state is tiny (6 DoF x ncam <= ~100 for any physical rig), so the
    right tool is exact dense Gauss-Newton, not stochastic descent: the
    full Jacobian comes from ``jax.jacrev`` of the stacked residual at the
    current linearisation point (no hand-derived SE(3) adjoints to get
    subtly wrong), and the normal equations solve is one
    ``jnp.linalg.solve`` on a [6N, 6N] matrix.
  * Everything is fixed-shape and jittable: a ``lax.fori_loop`` over GN
    iterations, edges as static-shape index arrays. One compiled program
    serves every frame/graph of the same size.
  * Rank handling: a pose graph only fixes poses up to one global rigid
    motion, so the anchor node's 6 columns are zeroed out of J and its
    diagonal block set to identity — the anchor's update is exactly 0 and
    the system is full rank; Levenberg damping covers under-constrained
    remainders (disconnected nodes keep their initial pose).

The online streaming path keeps its O(1)-per-frame ring-closure
distribution (models/stitcher._compose_ring_corrections); this solver is
the offline counterpart for arbitrary overlap graphs, run once per
calibration session (pcs-graph CLI) or whenever all pairwise measurements
should be reconciled jointly.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

from ..ops.se3 import mm, se3_from_rt, se3_inverse, so3_exp


class PoseGraphResult(NamedTuple):
    poses: jax.Array          # [N, 4, 4] refined world-from-camera poses
    residual_before: jax.Array  # [E] pseudo-log norms at the initial poses
    residual_after: jax.Array   # [E] pseudo-log norms at the solution
    iterations: jax.Array     # scalar int32: GN iterations executed


# Differentiable-safe SO(3) log. ops.se3's so3_exp is autodiff-safe since
# its NDT-round rewrite (squared-angle guard + Taylor branches) and is
# used directly; so3_log's arccos() still has a non-finite derivative at
# exactly the point GN linearises (theta -> 0, and `where` does not stop
# the NaN from the untaken branch propagating through the cotangent), so
# the log keeps this finite-derivative variant; values match so3_log to
# float tolerance.


def _so3_log_diff(R: jax.Array) -> jax.Array:
    w = jnp.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], axis=-1)   # 2 sin(theta) axis
    s2 = jnp.sum(w * w, axis=-1, keepdims=True)              # 4 sin^2(theta)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = jnp.clip((trace[..., None] - 1.0) * 0.5, -1.0, 1.0)
    small = s2 < 1e-12
    s2s = jnp.where(small, 1.0, s2)
    sin = 0.5 * jnp.sqrt(s2s)
    # scale = theta / (2 sin theta); Taylor 1/2 + theta^2/12 with
    # theta^2 ~= 2 (1 - cos) near zero
    scale = jnp.where(small, 0.5 + (1.0 - cos) / 6.0,
                      jnp.arctan2(sin, cos) / (2.0 * sin))
    return w * scale


def _pseudo_exp(xi: jax.Array) -> jax.Array:
    """[..., 6] = [t(3), omega(3)] -> [..., 4, 4] (SO(3) x R^3 chart)."""
    return se3_from_rt(so3_exp(xi[..., 3:]), xi[..., :3])


def _pseudo_log(T: jax.Array) -> jax.Array:
    """[..., 4, 4] -> [..., 6]; inverse of _pseudo_exp on its image."""
    return jnp.concatenate([T[..., :3, 3],
                            _so3_log_diff(T[..., :3, :3])], axis=-1)


def _edge_residuals(poses: jax.Array, xi: jax.Array, src: jax.Array,
                    dst: jax.Array, meas_inv: jax.Array) -> jax.Array:
    """Stacked [E, 6] residuals of perturbed poses T_k @ exp(xi_k).

    src/dst are the edges' (i, j) node ids; meas_inv[e] = T_e_meas^-1.
    Kept as a standalone function of xi so jax.jacrev yields the exact
    Gauss-Newton Jacobian at the current linearisation point (xi = 0).
    """
    perturbed = mm(poses, _pseudo_exp(xi))
    ti = perturbed[src]                       # [E, 4, 4]
    tj = perturbed[dst]
    err = mm(mm(meas_inv, se3_inverse(ti)), tj)
    return _pseudo_log(err)


@partial(jax.jit, static_argnames=("iterations", "anchor"))
def optimize_pose_graph(T_init: jax.Array, edges: jax.Array,
                        T_meas: jax.Array,
                        weights: Optional[jax.Array] = None,
                        iterations: int = 10, damping: float = 1e-9,
                        anchor: int = 0) -> PoseGraphResult:
    """Jointly refine world poses against pairwise measurements.

    Args:
      T_init: [N, 4, 4] initial world-from-camera poses (e.g. chained
        pairwise .cal files, or the streaming rig's current extrinsics).
      edges: [E, 2] int32 (i, j) node indices. T_meas[e] maps camera
        edges[e, 1]'s frame into camera edges[e, 0]'s frame — the direct
        output of ``register_pair(src=cloud_j, dst=cloud_i)``.
      T_meas: [E, 4, 4] pairwise rigid measurements.
      weights: optional [E] per-edge confidences (e.g. ICP inlier counts);
        residuals scale by sqrt(w) so the objective weighs by w.
      iterations: Gauss-Newton iterations (static; each is exact-Jacobian).
      damping: Levenberg diagonal added to the normal equations. The
        default only guards bitwise rank loss; raise it for nearly
        unconstrained graphs.
      anchor: node whose pose stays exactly T_init[anchor] (gauge freedom).

    Returns PoseGraphResult; disconnected nodes keep their initial pose
    (their normal-equation rows are zero and damping pins them).
    """
    T_init = jnp.asarray(T_init, jnp.float32)
    n = T_init.shape[0]
    edges = jnp.asarray(edges, jnp.int32)
    src, dst = edges[:, 0], edges[:, 1]
    meas_inv = se3_inverse(jnp.asarray(T_meas, jnp.float32))
    e = edges.shape[0]
    sqw = (jnp.ones((e,), jnp.float32) if weights is None
           else jnp.sqrt(jnp.asarray(weights, jnp.float32)))

    # anchor mask: zero the anchor's 6 Jacobian columns; identity on its
    # diagonal block makes the solve well-posed with delta_anchor == 0
    free = (jnp.arange(n) != anchor).astype(jnp.float32)      # [N]

    def residual_norms(poses):
        z = jnp.zeros((n, 6), jnp.float32)
        return jnp.linalg.norm(
            _edge_residuals(poses, z, src, dst, meas_inv), axis=-1)

    def gn_step(_, poses):
        z = jnp.zeros((n, 6), jnp.float32)
        r = _edge_residuals(poses, z, src, dst, meas_inv)      # [E, 6]
        jac = jax.jacrev(
            lambda xi: _edge_residuals(poses, xi, src, dst, meas_inv))(z)
        jac = (jac * sqw[:, None, None, None]) * free[None, None, :, None]
        r = r * sqw[:, None]
        jf = jac.reshape(e * 6, n * 6)
        jtj = jf.T @ jf
        # exact-zero update for the anchor AND for unconstrained columns
        # (disconnected nodes): unit diagonal + zero rhs — damping alone
        # leaves a ~1e-9 pivot whose f32 LU can blow up the whole solve
        dead = jnp.sum(jnp.abs(jf), axis=0) == 0.0          # [6N]
        diag_fix = jnp.maximum(jnp.repeat(1.0 - free, 6),
                               dead.astype(jnp.float32)) \
            + jnp.float32(damping) * jnp.ones((n * 6,), jnp.float32)
        jtj = jtj + jnp.diag(diag_fix)
        rhs = -(jf.T @ r.reshape(-1))
        delta = jnp.linalg.solve(jtj, rhs).reshape(n, 6)
        delta = delta * free[:, None]
        return mm(poses, _pseudo_exp(delta))

    before = residual_norms(T_init)
    poses = jax.lax.fori_loop(0, iterations, gn_step, T_init)
    after = residual_norms(poses)
    return PoseGraphResult(poses=poses, residual_before=before,
                           residual_after=after,
                           iterations=jnp.int32(iterations))


def register_rig(clouds, edges: jax.Array, T_init: jax.Array,
                 icp_iterations: int = 20, gn_iterations: int = 10,
                 max_corr_dist: float = 0.25, trim_fraction: float = 0.0,
                 query_tile: int = 1024, ref_tile: int = 4096,
                 nn_impl: str = "auto",
                 anchor: int = 0) -> PoseGraphResult:
    """Turn-key multiway registration: pairwise ICP on every graph edge,
    then the joint pose-graph solve.

    The one-call composition of the two calibration stages (the reference
    needs a human to run its pairwise tool per pair and chain the results
    by hand — SURVEY.md §3.4): for each edge (i, j), camera j's cloud is
    ICP-aligned to camera i's under the initial poses — ALL edges run as
    one batched ICP, one NN kernel per iteration over every pair
    (ops.icp.icp_batched, the same machinery as the streaming ring drift
    stage) — and each aligned pose becomes the edge measurement
    ``T_meas = T_i^-1 @ delta @ T_j`` for optimize_pose_graph, weighted by
    its ICP inlier count so weak overlaps pull proportionally less.

    Args:
      clouds: camera-batched sensor-frame PointCloud ([N, C, 3] + mask).
      edges: [E, 2] int32 (i, j) pairs expected to overlap; clouds must be
        roughly pre-aligned by T_init (ICP basin, a few cm — the streaming
        rig's standing assumption).
      T_init: [N, 4, 4] initial world-from-camera poses.

    Returns the PoseGraphResult of the joint solve (anchor fixed).
    """
    from ..ops.icp import icp_batched
    from ..ops.se3 import se3_apply
    from ..utils.types import PointCloud

    edges = jnp.asarray(edges, jnp.int32)
    T_init = jnp.asarray(T_init, jnp.float32)
    world_xyz = se3_apply(T_init, clouds.xyz)            # [N, C, 3]
    si, di = edges[:, 1], edges[:, 0]
    src = PointCloud(xyz=world_xyz[si], mask=clouds.mask[si])
    dst = PointCloud(xyz=world_xyz[di], mask=clouds.mask[di])
    res = icp_batched(src, dst, iterations=icp_iterations,
                      max_corr_dist=max_corr_dist,
                      query_tile=query_tile, ref_tile=ref_tile,
                      nn_impl=nn_impl, trim_fraction=trim_fraction)
    # res.T[e] aligns camera j's world-frame cloud onto camera i's, so the
    # measured world pose of j is res.T[e] @ T_init[j]; in i's frame:
    meas = mm(se3_inverse(T_init[di]), mm(res.T, T_init[si]))
    weights = jnp.maximum(res.num_inliers.astype(jnp.float32), 1.0)
    return optimize_pose_graph(T_init, edges, meas, weights=weights,
                               iterations=gn_iterations, anchor=anchor)


def chain_initial_poses(num_nodes: int, edges: Sequence[Sequence[int]],
                        T_meas: jax.Array,
                        anchor: int = 0) -> jax.Array:
    """Spanning-tree initialisation: breadth-first chain of measurements.

    Host-side helper (runs once per calibration session, shapes vary with
    the graph): walks a BFS tree from ``anchor`` over the measurement
    graph, composing T_parent @ T_meas (or its inverse against the edge
    direction) — the multi-edge generalisation of "chain the pairwise .cal
    files", giving optimize_pose_graph a topologically sound start even
    when the edge list is not a simple ring. Unreached nodes get identity.
    """
    import numpy as np

    T_meas = np.asarray(T_meas, np.float32)
    poses = [None] * num_nodes
    poses[anchor] = np.eye(4, dtype=np.float32)
    adj: list[list[tuple[int, int, bool]]] = [[] for _ in range(num_nodes)]
    for k, (i, j) in enumerate(edges):
        adj[int(i)].append((int(j), k, False))   # forward: T_j = T_i @ M
        adj[int(j)].append((int(i), k, True))    # reverse: T_i = T_j @ M^-1
    queue = [anchor]
    while queue:
        i = queue.pop(0)
        for j, k, rev in adj[i]:
            if poses[j] is not None:
                continue
            m = np.linalg.inv(T_meas[k]) if rev else T_meas[k]
            poses[j] = poses[i] @ m
            queue.append(j)
    for i in range(num_nodes):
        if poses[i] is None:
            poses[i] = np.eye(4, dtype=np.float32)
    return jnp.asarray(np.stack(poses))
