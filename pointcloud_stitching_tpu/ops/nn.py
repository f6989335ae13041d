"""Brute-force nearest-neighbour correspondence search, tiled.

Accelerator replacement for ``pcl::KdTreeFLANN`` inside PCL's ICP (reference:
registration/ tool, ``pcl::IterativeClosestPoint``; SURVEY.md §2.2 row 5).

A KD-tree is pointer-chasing and branch-heavy. The data-parallel formulation
is a tiled distance-matrix sweep:

    d2[i, j] = |q_i|^2 + |r_j|^2 - 2 q_i . r_j

where the cross term is a matrix product. The full N x M matrix is never
materialised (100k x 100k would be 40 GB): we sweep reference tiles with a
running (best_d2, best_idx) pair, and query tiles via an outer ``lax.map``.
Intermediates stay at [query_tile x ref_tile].

A Pallas kernel with the same contract lives in kernels/nn_pallas.py; this
module is the portable XLA version and the numerical contract for both.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils.platform import kernel_impl

_FAR = 1e12  # coordinate sentinel for invalid reference points


def _pad_to(x: jax.Array, n: int, value=0.0) -> jax.Array:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    cfg = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, cfg, constant_values=value)


@partial(jax.jit, static_argnames=("query_tile", "ref_tile", "impl",
                                   "interpret"))
def nearest_neighbors(query: jax.Array, ref: jax.Array,
                      ref_mask: jax.Array | None = None,
                      query_tile: int = 1024, ref_tile: int = 4096,
                      impl: str = "auto", interpret: bool = False):
    """For each query point, index + squared distance of its nearest ref point.

    Args:
      query: [N, 3] float32.
      ref: [M, 3] float32.
      ref_mask: [M] bool; invalid reference points are never matched.
      query_tile/ref_tile: tiling of the XLA sweep (the Pallas kernel keeps
        its own tile sizes).
      impl: 'auto' | 'pallas' | 'xla', resolved by
        utils.platform.kernel_impl ('auto' is the kernel on a GPU).
      interpret: run the Pallas kernel in interpret mode (CPU tests).
    Returns:
      (idx [N] int32, d2 [N] float32). If every ref point is masked out the
      distances are ~_FAR^2; callers gate on that via their own masks.
    """
    if kernel_impl(impl, interpret) == "pallas":
        from ..kernels.nn_pallas import nearest_neighbors_pallas
        return nearest_neighbors_pallas(query, ref, ref_mask,
                                        interpret=interpret)
    n, m = query.shape[0], ref.shape[0]
    if ref_mask is None:
        ref_mask = jnp.ones((m,), bool)
    refm = jnp.where(ref_mask[:, None], ref, _FAR)

    n_pad = -(-n // query_tile) * query_tile
    m_pad = -(-m // ref_tile) * ref_tile
    qp = _pad_to(query, n_pad)
    rp = _pad_to(refm, m_pad, value=_FAR)
    r_sq = jnp.sum(rp * rp, axis=-1)  # [m_pad]

    r_tiles = rp.reshape(m_pad // ref_tile, ref_tile, 3)
    rsq_tiles = r_sq.reshape(m_pad // ref_tile, ref_tile)

    def per_query_tile(q):  # q: [query_tile, 3]
        q_sq = jnp.sum(q * q, axis=-1)  # [QT]

        def body(carry, tile):
            best_d2, best_idx = carry
            rt, rsqt, tile_i = tile
            # precision='highest' keeps the product in full f32 (no TF32 or
            # bf16 passes): the |q|^2+|r|^2-2qr decomposition amplifies
            # their rounding into centimetre-scale distance errors.
            cross = jnp.dot(q, rt.T, preferred_element_type=jnp.float32,
                            precision="highest")
            d2 = q_sq[:, None] + rsqt[None, :] - 2.0 * cross  # [QT, RT]
            loc = jnp.argmin(d2, axis=1)
            loc_d2 = jnp.take_along_axis(d2, loc[:, None], axis=1)[:, 0]
            better = loc_d2 < best_d2
            best_d2 = jnp.where(better, loc_d2, best_d2)
            best_idx = jnp.where(better, tile_i * ref_tile + loc, best_idx)
            return (best_d2, best_idx), None

        # derive the init carry from q so shard_map's varying-axis typing
        # matches the loop outputs (constants are 'unvarying' under manual
        # sharding and break lax.scan's carry type check)
        init = (q[:, 0] * 0.0 + jnp.inf,
                (q[:, 0] * 0.0).astype(jnp.int32))
        tiles = (r_tiles, rsq_tiles,
                 jnp.arange(m_pad // ref_tile, dtype=jnp.int32))
        (best_d2, best_idx), _ = jax.lax.scan(body, init, tiles)
        return best_d2, best_idx

    q_tiles = qp.reshape(n_pad // query_tile, query_tile, 3)
    d2, idx = jax.lax.map(per_query_tile, q_tiles)
    d2 = d2.reshape(-1)[:n]
    idx = jnp.minimum(idx.reshape(-1)[:n], m - 1)
    # clamp fp cancellation: d2 >= 0
    return idx, jnp.maximum(d2, 0.0)
