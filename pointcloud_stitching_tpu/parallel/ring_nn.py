"""Cross-device nearest-neighbour search: ppermute ring over point shards.

The point-cloud analogue of ring attention (SURVEY.md §2.5/§5: the scaling
axis here is POINT COUNT, not sequence length). When reference clouds are
too large for one device — or simply sharded across the mesh with the rest of
the pipeline — the O(N*M) distance sweep decomposes blockwise:

  * queries stay resident, sharded over the mesh (each device owns N/D),
  * the reference shard rotates around the ring D-1 times via
    ``lax.ppermute`` (neighbour exchange, no all-gather),
  * each device keeps a running (best_d2, best_idx) over the shards it has
    seen; global indices come from offsetting by the source shard's base.

Inside each step the local block search is the single-device kernel
path (ops.nn.nearest_neighbors), so per-device compute is identical to the
unsharded case — the ring only adds D-1 shard-sized transfers that overlap
poorly only when D is tiny.

Replaces: nothing in the reference (its NN search is single-machine
KdTreeFLANN); this is the capability that lets registration scale past one
chip's HBM.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.nn import nearest_neighbors


def ring_nearest_neighbors(query: jax.Array, ref: jax.Array,
                           ref_mask: jax.Array, mesh: Mesh,
                           axis: str = "cam",
                           query_tile: int = 1024, ref_tile: int = 4096,
                           impl: str = "auto"):
    """NN with both query and reference sharded over ``mesh`` along dim 0.

    Args:
      query: [N, 3] (N divisible by mesh size).
      ref: [M, 3] (M divisible by mesh size).
      ref_mask: [M] bool.
    Returns (idx [N] i32 into the global ref, d2 [N] f32), sharded like query.
    """
    d = mesh.devices.size
    m_shard = ref.shape[0] // d

    def shard_fn(q, r, rm):
        # q: [N/D, 3] local queries; r/rm: local ref shard
        my = jax.lax.axis_index(axis)

        def body(step, carry):
            best_d2, best_idx, r_cur, rm_cur = carry
            src = (my - step) % d          # shard currently held
            idx, dd = nearest_neighbors(q, r_cur, rm_cur,
                                        query_tile=query_tile,
                                        ref_tile=ref_tile, impl=impl)
            gidx = src * m_shard + idx
            better = dd < best_d2
            best_d2 = jnp.where(better, dd, best_d2)
            best_idx = jnp.where(better, gidx, best_idx)
            # rotate the ref shard to the right neighbour (ring)
            perm = [(i, (i + 1) % d) for i in range(d)]
            r_nxt = jax.lax.ppermute(r_cur, axis, perm)
            rm_nxt = jax.lax.ppermute(rm_cur, axis, perm)
            return best_d2, best_idx, r_nxt, rm_nxt

        # init carries derive from q/r so their varying axes match the body
        # outputs under shard_map's manual-sharding type system
        init = (q[:, 0] * 0.0 + jnp.inf,
                (q[:, 0] * 0.0).astype(jnp.int32), r, rm)
        best_d2, best_idx, _, _ = jax.lax.fori_loop(0, d, body, init)
        return best_idx, jnp.maximum(best_d2, 0.0)

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(P(axis), P(axis), P(axis)),
                       out_specs=(P(axis), P(axis)))
    return fn(query, ref, ref_mask)
