"""Pallas kernel (Triton route): tiled brute-force nearest-neighbour search.

Replaces PCL's KD-tree NN with a dense blockwise distance sweep that never
stores a distance. Each program owns one query tile and loops over the
reference blocks inside the kernel, carrying the running (min d², argmin)
pair in registers; only the per-query result reaches device memory. The
XLA form (ops/nn.py) instead writes every [query_tile x ref_tile] distance
tile to device memory and reads it back for the argmin.

Distances are direct squared differences, exact in f32: with a contraction
depth of 3 there is no matrix product worth making, and the direct form has
no |a|²+|b|²-2ab cancellation and no TF32 question.

Tie behaviour matches numpy/XLA argmin: the smallest reference index wins
(strict `<` across blocks, argmin's first index within a block).

For large voxel-sorted clouds, ``nearest_neighbors_pruned`` adds exact
key-range pruning (coarse-pass distance bound + block bounding boxes ->
contiguous block ranges per query tile). Each program reads its own
[lo, hi] block range from an input array, so the sweep length is a dynamic
loop bound.

Replaces: pcl::KdTreeFLANN::nearestKSearch(k=1) inside
pcl::IterativeClosestPoint (reference: registration/ tool; SURVEY.md §2.2
row 5). Contract-identical to ops.nn.nearest_neighbors (the XLA version).
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_FAR = 1e12  # coordinate sentinel for invalid reference points

# Tile sizes and launch shape, chosen by a sweep on an H100 at the ring-ICP
# shape (8 x 2048 x 2048) and at 131k x 131k (scripts/gpu_timing.py
# --sweep; PERF.md, Findings). Both tiles are powers of two, as the Triton
# route requires.
QUERY_TILE = 16
REF_BLOCK = 512
NUM_WARPS = 2
NUM_STAGES = 2


def _planes(x: jax.Array, mask: jax.Array | None, tile: int,
            fill: float) -> tuple[jax.Array, ...]:
    """[B, N, 3] -> three [B, Npad] coordinate planes (Npad a tile multiple).

    Masked and padded rows carry ``fill`` so they never win an argmin.
    """
    b, n, _ = x.shape
    if mask is not None:
        x = jnp.where(mask[..., None], x, fill)
    npad = -(-n // tile) * tile
    x = jnp.pad(x, ((0, 0), (0, npad - n), (0, 0)), constant_values=fill)
    return tuple(x[..., c] for c in range(3))


def prepare_ref(ref: jax.Array, ref_mask: jax.Array | None,
                ref_block: int = REF_BLOCK) -> tuple[jax.Array, ...]:
    """Pad the reference once for repeated batched-NN calls.

    ICP calls NN every iteration against the same reference cloud; this
    keeps the masking and padding out of the loop. Returns three [B, Mpad]
    coordinate planes.
    """
    return _planes(ref, ref_mask, ref_block, _FAR)


def _nn_kernel(*refs, ref_block: int, nm: int, ranged: bool):
    """One (batch, query-tile) program: sweep ref blocks, keep the best."""
    if ranged:
        qx, qy, qz, rx, ry, rz, jlo_ref, jhi_ref, d2_ref, idx_ref = refs
        jlo, jhi = jlo_ref[()], jhi_ref[()] + 1
    else:
        qx, qy, qz, rx, ry, rz, d2_ref, idx_ref = refs
        jlo, jhi = 0, nm
    q = [c[...][:, None] for c in (qx, qy, qz)]            # [QT, 1] each

    def body(j, carry):
        best_d2, best_idx = carry
        sl = pl.ds(j * ref_block, ref_block)
        d2 = None
        for qc, rc in zip(q, (rx, ry, rz)):
            diff = qc - rc[sl][None, :]                    # [QT, RB]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        m = jnp.min(d2, axis=1)
        am = jnp.argmin(d2, axis=1).astype(jnp.int32)
        better = m < best_d2
        return (jnp.where(better, m, best_d2),
                jnp.where(better, j * ref_block + am, best_idx))

    qt = d2_ref.shape[0]
    init = (jnp.full((qt,), jnp.inf, jnp.float32),
            jnp.zeros((qt,), jnp.int32))
    best_d2, best_idx = jax.lax.fori_loop(jlo, jhi, body, init)
    d2_ref[...] = best_d2
    idx_ref[...] = best_idx


@partial(jax.jit, static_argnames=("num_ref", "query_tile", "ref_block",
                                   "num_warps", "num_stages", "interpret"))
def nn_prepared(query: jax.Array, ref_planes: tuple[jax.Array, ...],
                num_ref: int, ranges: tuple[jax.Array, jax.Array] | None = None,
                query_tile: int = QUERY_TILE, ref_block: int = REF_BLOCK,
                num_warps: int = NUM_WARPS, num_stages: int = NUM_STAGES,
                interpret: bool = False):
    """Batched NN of query [B, N, 3] against ``prepare_ref`` planes.

    ranges: optional (jlo, jhi) [B, nq] int32 inclusive block ranges per
    (batch, query tile); see ``block_ranges``. ``ref_block`` must be the
    block the planes were padded to. Returns (idx [B, N] int32, d2 [B, N]
    float32).
    """
    b, n, _ = query.shape
    q_planes = _planes(query, None, query_tile, 0.0)
    npad = q_planes[0].shape[1]
    mpad = ref_planes[0].shape[1]
    q_spec = pl.BlockSpec((None, query_tile), lambda bb, i: (bb, i))
    r_spec = pl.BlockSpec((None, mpad), lambda bb, i: (bb, 0))
    in_specs = [q_spec] * 3 + [r_spec] * 3
    args = [*q_planes, *ref_planes]
    if ranges is not None:
        in_specs += [pl.BlockSpec((None, None), lambda bb, i: (bb, i))] * 2
        args += [r.astype(jnp.int32) for r in ranges]
    d2, idx = pl.pallas_call(
        partial(_nn_kernel, ref_block=ref_block, nm=mpad // ref_block,
                ranged=ranges is not None),
        out_shape=[jax.ShapeDtypeStruct((b, npad), jnp.float32),
                   jax.ShapeDtypeStruct((b, npad), jnp.int32)],
        grid=(b, npad // query_tile),
        in_specs=in_specs,
        out_specs=[q_spec, q_spec],
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=num_stages),
        backend="triton",
        interpret=interpret,
        name="nn_sweep",
    )(*args)
    idx = jnp.minimum(idx[:, :n], num_ref - 1)
    return idx, d2[:, :n]


@partial(jax.jit, static_argnames=("query_tile", "ref_block", "interpret"))
def nearest_neighbors_pallas_batched(query: jax.Array, ref: jax.Array,
                                     ref_mask: jax.Array | None = None,
                                     query_tile: int = QUERY_TILE,
                                     ref_block: int = REF_BLOCK,
                                     interpret: bool = False):
    """Batched NN: query [B, N, 3] vs ref [B, M, 3] pairwise per batch row.

    The batch is a grid axis, so the ring-ICP drift correction runs all its
    camera pairs in one launch.
    """
    planes = prepare_ref(ref, ref_mask, ref_block)
    return nn_prepared(query, planes, num_ref=ref.shape[1],
                       query_tile=query_tile, ref_block=ref_block,
                       interpret=interpret)


def nearest_neighbors_pallas(query: jax.Array, ref: jax.Array,
                             ref_mask: jax.Array | None = None,
                             query_tile: int = QUERY_TILE,
                             ref_block: int = REF_BLOCK,
                             interpret: bool = False):
    """Single-pair NN; same contract as ops.nn.nearest_neighbors."""
    idx, d2 = nearest_neighbors_pallas_batched(
        query[None], ref[None], None if ref_mask is None else ref_mask[None],
        query_tile=query_tile, ref_block=ref_block, interpret=interpret)
    return idx[0], d2[0]


def block_ranges(query: jax.Array, query_mask: jax.Array, ref: jax.Array,
                 ref_mask: jax.Array, d2_ub: jax.Array,
                 query_tile: int = QUERY_TILE, ref_block: int = REF_BLOCK):
    """Exact per-query-tile ref-block ranges from bounding-box lower bounds.

    Voxel-sorted reference clouds are spatially coherent, so consecutive
    blocks have compact bounding boxes and the blocks that can beat a known
    upper bound d2_ub form (a superset of) a contiguous key range.

    Args:
      query: [B, N, 3]; query_mask: [B, N].
      ref: [B, M, 3]; ref_mask: [B, M].
      d2_ub: [B, N] — per-query upper bound on the squared NN distance
        (e.g. from a coarse pass over a subsampled ref). Must satisfy
        d2_ub >= true NN squared distance.
    Returns (jlo, jhi): [B, nq] inclusive block index ranges.
    """
    b, n, _ = query.shape
    m = ref.shape[1]
    npad = -(-n // query_tile) * query_tile
    mpad = -(-m // ref_block) * ref_block
    nq, nm = npad // query_tile, mpad // ref_block

    def bbox(x, mask, tile, tpad):
        big = jnp.float32(3.0e38)
        xm = jnp.where(mask[..., None], x, big)
        xM = jnp.where(mask[..., None], x, -big)
        xm = jnp.pad(xm, ((0, 0), (0, tpad - x.shape[1]), (0, 0)),
                     constant_values=big)
        xM = jnp.pad(xM, ((0, 0), (0, tpad - x.shape[1]), (0, 0)),
                     constant_values=-big)
        lo = jnp.min(xm.reshape(b, -1, tile, 3), axis=2)
        hi = jnp.max(xM.reshape(b, -1, tile, 3), axis=2)
        return lo, hi  # [B, ntiles, 3]

    qlo, qhi = bbox(query, query_mask, query_tile, npad)
    rlo, rhi = bbox(ref, ref_mask, ref_block, mpad)

    # squared box-to-box distance [B, nq, nm]
    gap = jnp.maximum(
        0.0, jnp.maximum(qlo[:, :, None] - rhi[:, None, :],
                         rlo[:, None, :] - qhi[:, :, None]))
    lb2 = jnp.sum(gap * gap, axis=-1)

    ubm = jnp.where(query_mask, d2_ub, 0.0)
    ubm = jnp.pad(ubm, ((0, 0), (0, npad - n)))
    ub_tile = jnp.max(ubm.reshape(b, nq, query_tile), axis=-1)  # [B, nq]

    # empty ref blocks (all-masked) get +inf lower bound automatically via
    # the sentinel bbox; candidate blocks:
    cand = lb2 <= ub_tile[..., None] * (1.0 + 1e-5) + 1e-12
    idxs = jnp.arange(nm, dtype=jnp.int32)
    jlo = jnp.min(jnp.where(cand, idxs, nm - 1), axis=-1)
    jhi = jnp.max(jnp.where(cand, idxs, 0), axis=-1)
    jhi = jnp.maximum(jhi, jlo)  # degenerate tiles sweep one block
    return jlo.astype(jnp.int32), jhi.astype(jnp.int32)


@partial(jax.jit, static_argnames=("query_tile", "ref_block",
                                   "coarse_stride", "interpret"))
def nearest_neighbors_pruned(query: jax.Array, ref: jax.Array,
                             ref_mask: jax.Array | None = None,
                             query_mask: jax.Array | None = None,
                             coarse_stride: int = 16,
                             query_tile: int = QUERY_TILE,
                             ref_block: int = REF_BLOCK,
                             interpret: bool = False):
    """Exact batched NN with key-range pruning (BVH-lite for sorted clouds).

    Pass 1 searches a stride-subsampled reference for a per-query upper
    bound; pass 2 sweeps only the ref blocks whose bounding boxes can beat
    that bound. On voxel-sorted clouds after rough alignment this skips the
    vast majority of blocks; results remain exactly the brute-force answer
    (the subsampled ref is a subset, so pass 1's bound is valid).
    """
    b, n, _ = query.shape
    m = ref.shape[1]
    if ref_mask is None:
        ref_mask = jnp.ones((b, m), bool)
    if query_mask is None:
        query_mask = jnp.ones((b, n), bool)

    _, d2_ub = nearest_neighbors_pallas_batched(
        query, ref[:, ::coarse_stride], ref_mask[:, ::coarse_stride],
        query_tile=query_tile, ref_block=ref_block, interpret=interpret)
    ranges = block_ranges(query, query_mask, ref, ref_mask, d2_ub,
                          query_tile=query_tile, ref_block=ref_block)
    return nn_prepared(query, prepare_ref(ref, ref_mask, ref_block),
                       num_ref=m, ranges=ranges, query_tile=query_tile,
                       ref_block=ref_block, interpret=interpret)
