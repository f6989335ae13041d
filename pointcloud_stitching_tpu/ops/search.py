"""Fixed-shape spatial search: the pcl::KdTreeFLANN public surface.

PCL programs query `nearestKSearch` / `radiusSearch` directly (the
reference itself only uses the tree indirectly, inside
pcl::IterativeClosestPoint — SURVEY.md §2.2 row "NN correspondence" —
but any migrating PCL user reaches for these entry points). There is no
tree on an accelerator: both searches are blockwise exact sweeps with a running
top-k merge, the same pattern as kernels/nn_pallas.py and
ops/filters.py's k-NN statistic, so dense matrix and vector work replaces traversal and
the output shapes are static.

Conventions follow PCL: squared distances, results sorted ascending,
radiusSearch capped at ``max_nn``. Fixed shapes mean absent neighbors
(masked points, fewer than k valid references) come back as index -1
with distance +inf instead of shortening the row.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud


@functools.partial(jax.jit, static_argnames=("k", "exclude_self",
                                             "query_tile", "ref_tile"))
def knn_search(query: PointCloud, ref: PointCloud, k: int,
               exclude_self: bool = False, query_tile: int = 512,
               ref_tile: int = 1024):
    """k nearest valid ref points per valid query point.

    Returns ``(d2, idx)``, both [N, k]: squared distances ascending and
    indices into ``ref``'s padded buffer; -1 / +inf fill the slots of
    invalid queries and missing neighbors. ``exclude_self=True`` drops
    same-global-index matches (pass the SAME cloud as query and ref —
    PCL's self-query idiom where hit 0 is always the point itself).
    """
    if query.xyz.ndim != 2 or ref.xyz.ndim != 2:
        raise ValueError("knn_search expects unbatched [N,3] clouds")
    n = query.xyz.shape[0]
    m = ref.xyz.shape[0]
    qt, rt = min(query_tile, n), min(ref_tile, m)
    nq, nr = -(-n // qt), -(-m // rt)
    inf = jnp.float32(jnp.inf)
    rxyz = jnp.pad(ref.xyz, ((0, nr * rt - m), (0, 0)))
    rmask = jnp.pad(ref.mask, (0, nr * rt - m))
    qxyz = jnp.pad(query.xyz, ((0, nq * qt - n), (0, 0)))

    def query_block(qi):
        q = jax.lax.dynamic_slice(qxyz, (qi * qt, 0), (qt, 3))
        qidx = qi * qt + jnp.arange(qt)

        def ref_step(ri, carry):
            bd, bi = carry                          # [qt, k] each
            r = jax.lax.dynamic_slice(rxyz, (ri * rt, 0), (rt, 3))
            rm = jax.lax.dynamic_slice(rmask, (ri * rt,), (rt,))
            ridx = (ri * rt + jnp.arange(rt)).astype(jnp.int32)
            d = q[:, None, :] - r[None, :, :]
            d2 = jnp.sum(d * d, axis=-1)            # [qt, rt] exact f32
            bad = (~rm)[None, :]
            if exclude_self:
                bad = bad | (qidx[:, None] == ridx[None, :])
            d2 = jnp.where(bad, inf, d2)
            md = jnp.concatenate([bd, d2], axis=1)
            mi = jnp.concatenate(
                [bi, jnp.broadcast_to(ridx, (qt, rt))], axis=1)
            vals, pos = jax.lax.top_k(-md, k)       # k smallest, ascending
            return -vals, jnp.take_along_axis(mi, pos, axis=1)

        init = (jnp.full((qt, k), inf),
                jnp.full((qt, k), -1, jnp.int32))
        return jax.lax.fori_loop(0, nr, ref_step, init)

    d2, idx = jax.lax.map(query_block, jnp.arange(nq))
    d2 = d2.reshape(-1, k)[:n]
    idx = idx.reshape(-1, k)[:n]
    ok = jnp.isfinite(d2) & query.mask[:, None]
    return (jnp.where(query.mask[:, None], d2, inf),
            jnp.where(ok, idx, -1))


def radius_search(query: PointCloud, ref: PointCloud, radius, max_nn: int,
                  exclude_self: bool = False, query_tile: int = 512,
                  ref_tile: int = 1024):
    """Up to ``max_nn`` valid ref points within ``radius`` of each query.

    Returns ``(d2, idx, count)``: [N, max_nn] squared distances / ref
    indices (ascending, -1 / +inf beyond ``count``) and the per-query
    neighbor count (capped at max_nn — PCL's radiusSearch contract for
    max_nn >= 1).  Deviation from pcl::KdTreeFLANN: PCL treats
    ``max_nn=0`` as "return ALL neighbors in radius"; fixed on-device
    shapes cannot express an unbounded result, so max_nn < 1 raises
    instead (use ops.count_neighbors for exact uncapped counts).
    ``radius`` is a traced operand. ``exclude_self`` as in knn_search.
    """
    if max_nn < 1:
        raise ValueError(
            "radius_search needs max_nn >= 1 (PCL's max_nn=0 'unlimited' "
            "has no fixed-shape equivalent; use ops.count_neighbors)")
    d2, idx = knn_search(query, ref, max_nn, exclude_self=exclude_self,
                         query_tile=query_tile, ref_tile=ref_tile)
    within = (idx >= 0) & (d2 <= jnp.square(jnp.float32(radius)))
    return (jnp.where(within, d2, jnp.inf),
            jnp.where(within, idx, -1),
            jnp.sum(within, axis=1).astype(jnp.int32))
