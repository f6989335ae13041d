"""Shared blockwise all-pairs sweep driver.

The framework's standard substitute for PCL's KD-tree radius searches:
instead of per-point ragged neighbor lists, evaluate the query x reference
interaction one [query_tile x ref_tile] block at a time and ACCUMULATE —
fixed shapes, contiguous loads, broadcasts and matmuls,
never an [N, N] intermediate. ops/nn.py, ops/mls.py, ops/filters.py
and ops/cluster.py each hand-roll the pattern where their accumulators are
bespoke; this driver serves the ops whose per-block step is pluggable
(FPFH's histogram passes, ISS's density-weighted scatter matrices).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def blockwise_accumulate(xyz, valid, extras, query_tile, ref_tile, step):
    """lax.map over query tiles, fori_loop over ref tiles, summed results.

    ``extras`` arrays (leading dim N) ride along sliced to BOTH the query
    block and the ref block; ``step`` maps
    (q, qv, q_extras, r, rv, r_extras) -> pytree of [qt, ...] accumulators,
    summed over ref blocks. Returns the pytree with leading dim N.
    """
    n = xyz.shape[0]
    qt, rt = min(query_tile, n), min(ref_tile, n)
    nq, nr = -(-n // qt), -(-n // rt)
    pad_n = max(nq * qt, nr * rt)
    pxyz = jnp.pad(xyz, ((0, pad_n - n), (0, 0)))
    pvalid = jnp.pad(valid, (0, pad_n - n))
    pex = [jnp.pad(e, ((0, pad_n - n),) + ((0, 0),) * (e.ndim - 1))
           for e in extras]
    slc = lambda a, i, w: jax.lax.dynamic_slice(
        a, (i * w,) + (0,) * (a.ndim - 1), (w,) + a.shape[1:])

    def query_block(qi):
        q, qv = slc(pxyz, qi, qt), slc(pvalid, qi, qt)
        qe = [slc(e, qi, qt) for e in pex]

        def ref_step(ri, acc):
            r, rv = slc(pxyz, ri, rt), slc(pvalid, ri, rt)
            re = [slc(e, ri, rt) for e in pex]
            return jax.tree.map(jnp.add, acc, step(q, qv, qe, r, rv, re))

        # structure-only eval: a zeros_like over a real step() would burn
        # one extra block sweep per query tile just to learn the shapes
        zero = jax.tree.map(
            lambda s: jnp.zeros(s.shape, s.dtype),
            jax.eval_shape(step, q, qv, qe, pxyz[:rt], pvalid[:rt],
                           [e[:rt] for e in pex]))
        return jax.lax.fori_loop(0, nr, ref_step, zero)

    out = jax.lax.map(query_block, jnp.arange(nq))
    return jax.tree.map(
        lambda a: a.reshape((nq * qt,) + a.shape[2:])[:n], out)
