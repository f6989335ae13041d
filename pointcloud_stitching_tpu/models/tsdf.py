"""Dense TSDF volume: KinectFusion-style scene fusion on the accelerator.

The reference system fuses *point sets* per frame and throws them away
(reference: src/pcs-multicamera-client.cpp render loop, SURVEY.md §3.2);
`models/voxel_map.py` already upgrades that to a persistent sparse
centroid map. This module adds the third representation a capture rig
wants — a **truncated signed distance field** (Curless–Levoy / KinFu,
the `pcl::gpu::kinfu::TsdfVolume` role) — because it is the one that
supports watertight surface extraction, free-space carving (a removed
object actually disappears instead of fading), view synthesis by ray
casting, and drift-free *frame-to-model* camera tracking.

Design — the volume is a **dense [X, Y, Z] grid**, not a voxel hash:

  * Integration is one elementwise map over the grid: every voxel center
    is projected into every camera (a [V,3]x[3,3] matmul + the pinhole
    division) and samples the depth image with one gather. No scatter,
    no atomics, no hash probes — the scatter direction ("which voxels
    does this pixel touch?") becomes a gather direction ("which pixel
    does this voxel see?"). Cameras accumulate in a `fori_loop` so peak memory stays at a
    few V-sized f32 temporaries (a 256³ grid is 67 MB per temporary).
  * Ray casting is a fixed-step `lax.scan` march (nearest-voxel samples
    while marching, trilinear refinement + gradient normals at the hit):
    [rays] is the vector axis, steps are the loop — no data-dependent
    trip counts under jit.
  * Tracking is projective point-to-plane ICP against the ray-cast model
    map — correspondence is a *projection* (one gather per pixel), not a
    nearest-neighbour search, so a whole tracking iteration is a couple
    of fused elementwise passes plus a 6×6 solve.
  * Fixed shapes everywhere: one compiled integrate program serves the
    volume's entire life; `max_weight` caps per-voxel evidence so the
    volume keeps adapting (running weighted average, the Curless–Levoy
    update).

Mesh extraction reuses `ops/surface.py`'s marching tetrahedra on the
(negated) TSDF field at iso 0 — the same crack-free Kuhn split the
occupancy path uses, with unobserved nodes masked out so occlusion
boundaries don't grow fake walls.

Speed on the card: the integrate (dense), raycast and track times at
256³ with 4×848×480 frames are in PERF.md; nothing else here has been
measured on the H100.
"""
from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.deproject import deproject, project
from ..ops.se3 import mm, se3_apply, se3_compose, se3_from_rt, se3_inverse, so3_exp
from ..utils.types import Intrinsics, PointCloud, pytree_dataclass


@pytree_dataclass
class TSDFVolume:
    """Dense truncated signed distance volume (see module docstring).

    tsdf:   [X, Y, Z] f32 in [-1, 1] (distance / trunc; +1 = free space)
    weight: [X, Y, Z] f32 accumulated evidence (0 = never observed)
    origin: [3] f32 world position of voxel (0, 0, 0)'s CENTER
    leaf:   scalar f32 voxel edge (meters)
    trunc:  scalar f32 truncation band (meters; typically 3-6 leaves)
    rgb:    [X, Y, Z, 3] f32 running-average color in [0, 255], or None
    """

    tsdf: jax.Array
    weight: jax.Array
    origin: jax.Array
    leaf: jax.Array
    trunc: jax.Array
    rgb: Optional[jax.Array] = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.tsdf.shape

    @classmethod
    def create(cls, shape: tuple[int, int, int], leaf: float,
               origin=(0.0, 0.0, 0.0), trunc: float | None = None,
               with_rgb: bool = False) -> "TSDFVolume":
        """An empty volume: ``shape`` voxels of edge ``leaf`` anchored so
        voxel (0,0,0)'s center sits at ``origin``. ``trunc`` defaults to
        4 leaves (the usual KinFu band: wide enough that several noisy
        observations overlap, narrow enough not to blur thin structure).
        """
        X, Y, Z = shape
        t = 4.0 * leaf if trunc is None else trunc
        return cls(
            tsdf=jnp.ones((X, Y, Z), jnp.float32),
            weight=jnp.zeros((X, Y, Z), jnp.float32),
            origin=jnp.asarray(origin, jnp.float32),
            leaf=jnp.asarray(leaf, jnp.float32),
            trunc=jnp.asarray(t, jnp.float32),
            rgb=jnp.zeros((X, Y, Z, 3), jnp.float32) if with_rgb else None,
        )


def _voxel_centers(shape, origin, leaf) -> jax.Array:
    """[V, 3] world positions of every voxel center (V = X·Y·Z)."""
    X, Y, Z = shape
    gi = jax.lax.broadcasted_iota(jnp.float32, (X, Y, Z), 0)
    gj = jax.lax.broadcasted_iota(jnp.float32, (X, Y, Z), 1)
    gk = jax.lax.broadcasted_iota(jnp.float32, (X, Y, Z), 2)
    g = jnp.stack([gi, gj, gk], axis=-1).reshape(-1, 3)
    return origin + g * leaf


def _cam_slice(intr: Intrinsics, c) -> Intrinsics:
    """Select camera ``c`` from batched Intrinsics (traced index ok)."""
    return jax.tree_util.tree_map(lambda a: a[c], intr)


def integrate(vol: TSDFVolume, depth: jax.Array, intr: Intrinsics,
              extrinsics: jax.Array, depth_scale: float = 0.001,
              max_weight: float | jax.Array = 64.0,
              color: Optional[jax.Array] = None,
              cam_mask: Optional[jax.Array] = None,
              z_min: float | jax.Array = 0.0,
              z_max: float | jax.Array = jnp.inf,
              method: str = "auto") -> TSDFVolume:
    """Fuse one multi-camera depth frame into the volume (pure; donated).

    The Curless–Levoy projective update: every voxel center projects into
    each camera; the signed distance along the ray is approximated by
    ``depth(pixel) - z_cam`` and folded into a truncated running weighted
    average. Voxels more than ``trunc`` *behind* the observed surface are
    left untouched (occluded — no evidence either way); voxels in front
    accumulate free-space evidence (+1), which is what lets the volume
    *carve*: geometry that vanishes from the scene gets overwritten by
    free space instead of lingering (compare voxel_map's decay, which
    only forgets).

    Args:
      vol: current state (donated — updated in place on device).
      depth: [ncam, H, W] (or [H, W]) u16 raw units or float meters.
      intr: per-camera Intrinsics (batched to match, or single).
      extrinsics: [ncam, 4, 4] (or [4, 4]) camera→world transforms (the
        same .cal matrices the stitcher uses).
      depth_scale: meters per raw unit for integer depth (0.001 = D400).
      max_weight: evidence cap — bounds how slowly a long-observed voxel
        adapts to change (KinFu uses 64-128 at 30 Hz).
      color: [ncam, H, W, 3] (or [H, W, 3]) uint8/float color aligned to
        the depth stream, required iff the volume was built with_rgb.
      cam_mask: [ncam] bool — False drops a camera (a dead slot in the
        streaming runtime) without recompiling.
      z_min/z_max: per-camera depth validity range (meters).
      method: 'auto' | 'dense' | 'mxu' | 'mxu_xla' | 'brick'. 'dense' is
        the one-gather-per-voxel map (the oracle, and what 'auto' runs).
        'mxu_xla' ('mxu' is an alias) replaces the random depth gather
        with brick-local one-hot contractions, pruned by the brick
        classifier so only truncation-band / boundary bricks are gathered
        at all (FREE bricks broadcast +1, SKIP bricks cost nothing;
        overflow of the static brick capacities lax.cond-falls back to the
        unpruned full-grid lookup, so results never depend on the
        capacities) — BITWISE the dense result, any grid shape
        (non-8-divisible volumes are padded internally), color included.
        'brick' is the older hierarchical integrator that routes REFINE
        bricks through the random gather; kept as the scatter-path oracle.

    Returns the new volume.
    """
    if (color is not None) != (vol.rgb is not None):
        raise ValueError("color presence must match the volume's with_rgb")
    if depth.ndim == 2:
        depth = depth[None]
        extrinsics = jnp.asarray(extrinsics)[None] \
            if jnp.asarray(extrinsics).ndim == 2 else extrinsics
        if color is not None and color.ndim == 3:
            color = color[None]
        intr = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a)[None], intr) \
            if jnp.asarray(intr.fx).ndim == 0 else intr
    if cam_mask is None:
        cam_mask = jnp.ones((depth.shape[0],), bool)
    methods = ("auto", "brick", "dense", "mxu", "mxu_xla")
    if method not in methods:
        raise ValueError(f"unknown integrate method {method!r}")
    divisible = all(s % _BRICK == 0 for s in vol.shape)
    if method == "brick" and not divisible:
        raise ValueError(
            f"{method} integration needs 8-divisible grid, got {vol.shape}")
    if method == "auto":
        method = "dense"
    # canonical f32 scalars: avoids one recompile per distinct python
    # float (same cache-hygiene rule as voxel_map_update)
    args = (vol, depth, intr, jnp.asarray(extrinsics),
            jnp.asarray(depth_scale, jnp.float32),
            jnp.asarray(max_weight, jnp.float32))
    tail = (cam_mask, jnp.asarray(z_min, jnp.float32),
            jnp.asarray(z_max, jnp.float32))
    if method.startswith("mxu"):
        return _integrate_mxu_jit(*args, color, *tail)
    impl = _integrate_brick_jit if method == "brick" else _integrate_jit
    return impl(*args, color, *tail)


def _terms_from_depth(d, p_cz, pix_ok, trunc, z_min, z_max, mask_c):
    """Curless–Levoy terms given an already-looked-up depth d [N] (meters).

    Shared by every integrator (dense / brick-refine / mxu) so the update
    math cannot drift between them. Returns (wt = w·t_obs, w_obs, obs,
    sdf); d at pix_ok-false voxels is DON'T-CARE (gated to zero weight),
    which is what lets the mxu path substitute 0 there.
    """
    d_ok = pix_ok & (d > z_min) & (d > 0.0) & (d < z_max)
    sdf = d - p_cz
    obs = d_ok & (sdf > -trunc) & mask_c
    t_obs = jnp.minimum(sdf / trunc, 1.0)
    w_obs = obs.astype(jnp.float32)
    return w_obs * t_obs, w_obs, obs, sdf


def _voxel_update_terms(p_w, depth_flat, intr_c, inv_ext_c, trunc,
                        z_min, z_max, W: int, H: int, mask_c,
                        color_flat=None):
    """Exact Curless–Levy per-voxel terms for ONE camera.

    p_w [N, 3] world voxel centers, depth_flat [H*W] meters. Returns
    (wt [N] = w·t_obs, w [N], rgb4 [N, 4] or None). This is THE update
    math — the dense map and the brick integrator's refine pass both
    call it, so they cannot drift apart.
    """
    p_c = se3_apply(inv_ext_c, p_w)
    uv, in_front = project(p_c, intr_c)
    ui = jnp.round(uv[:, 0]).astype(jnp.int32)
    vi = jnp.round(uv[:, 1]).astype(jnp.int32)
    pix_ok = in_front & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    flat = jnp.clip(vi, 0, H - 1) * W + jnp.clip(ui, 0, W - 1)
    d = depth_flat[flat]
    wt, w_obs, obs, sdf = _terms_from_depth(
        d, p_c[:, 2], pix_ok, trunc, z_min, z_max, mask_c)
    rgb4 = None
    if color_flat is not None:
        near = obs & (jnp.abs(sdf) <= trunc)
        wc = near.astype(jnp.float32)
        rgb_px = color_flat[flat].astype(jnp.float32)
        rgb4 = jnp.concatenate([wc[:, None] * rgb_px, wc[:, None]],
                               axis=-1)
    return wt, w_obs, rgb4


@partial(jax.jit, donate_argnames=("vol",))
def _integrate_jit(vol: TSDFVolume, depth, intr, extrinsics, depth_scale,
                   max_weight, color, cam_mask, z_min, z_max) -> TSDFVolume:
    shape = vol.shape
    V = shape[0] * shape[1] * shape[2]
    ncam, H, W = depth.shape
    has_rgb = vol.rgb is not None

    p_w = _voxel_centers(shape, vol.origin, vol.leaf)         # [V, 3]
    depth_m = depth.astype(jnp.float32) * depth_scale         # [ncam, H, W]
    inv_ext = se3_inverse(extrinsics)                         # world→cam

    # rgb needs its own weight channel (the near-surface gate differs from
    # the tsdf gate), so accumulate [V, 4]: rgb-sum + rgb-weight
    def body_full(c, acc):
        sum_wt, sum_w, sum_rgb = acc
        wt, w_obs, rgb4 = _voxel_update_terms(
            p_w, depth_m[c].reshape(-1), _cam_slice(intr, c), inv_ext[c],
            vol.trunc, z_min, z_max, W, H, cam_mask[c],
            color_flat=color[c].reshape(-1, 3) if has_rgb else None)
        sum_wt = sum_wt + wt
        sum_w = sum_w + w_obs
        if has_rgb:
            sum_rgb = sum_rgb + rgb4
        return sum_wt, sum_w, sum_rgb

    init_rgb = jnp.zeros((V, 4), jnp.float32) if has_rgb \
        else jnp.zeros((1, 4), jnp.float32)
    sum_wt, sum_w, sum_rgb = jax.lax.fori_loop(
        0, ncam, body_full,
        (jnp.zeros((V,), jnp.float32), jnp.zeros((V,), jnp.float32),
         init_rgb))

    w_old = vol.weight.reshape(-1)
    w_new = w_old + sum_w
    t_new = jnp.where(w_new > 0.0,
                      (vol.tsdf.reshape(-1) * w_old + sum_wt)
                      / jnp.maximum(w_new, 1e-12),
                      1.0)
    new_rgb = None
    if has_rgb:
        # rgb has its own (near-band) weight; reuse the volume's weight as
        # the prior mass so colors track the same evidence cap
        rw_old = jnp.minimum(w_old, max_weight)
        rgb_new = (vol.rgb.reshape(-1, 3) * rw_old[:, None]
                   + sum_rgb[:, :3])
        rw_new = rw_old + sum_rgb[:, 3]
        new_rgb = jnp.where(rw_new[:, None] > 0.0,
                            rgb_new / jnp.maximum(rw_new, 1e-12)[:, None],
                            0.0).reshape(*shape, 3)
    return TSDFVolume(
        tsdf=t_new.reshape(shape),
        weight=jnp.minimum(w_new, max_weight).reshape(shape),
        origin=vol.origin, leaf=vol.leaf, trunc=vol.trunc, rgb=new_rgb)


# --------------------------------------------------------------------------
# hierarchical (brick) integration
# --------------------------------------------------------------------------
#
# The dense map's work is dominated by its 16.7M-row random gather from
# the depth image (at 256³). Most of those gathers are wasted: far-from-surface voxels
# all resolve to "uniform free space" (+1 evidence) or "no update"
# (occluded / outside the frustum / invalid pixels). So integrate
# hierarchically over 8³ bricks:
#
#   FREE        whole brick provably sdf >= trunc with every pixel valid
#               and strictly inside the image → one +1 count per brick,
#               broadcast at merge time (no per-voxel work at all).
#   FREE_BORDER same but the footprint crosses the image border → the
#               per-voxel bounds test runs (projection math on the VPU)
#               but the depth GATHER is skipped — the pooled depth
#               minimum already proves sdf >= trunc for in-image pixels.
#   SKIP        provably no voxel updates: behind the camera, footprint
#               fully outside the image, footprint entirely invalid, or
#               the whole brick deeper than trunc behind every valid
#               depth (occluded).
#   REFINE      everything unproven (the truncation band, valid/invalid
#               boundaries, image-border + near-camera bricks): the
#               EXACT dense math via _voxel_update_terms, gathers and
#               all, scattered back at brick granularity.
#
# Classification bounds are conservative by construction: two-level
# 3×3-neighborhood-folded depth tiles (32-px fine / 64-px coarse, plus
# a global fallback for the widest footprints — see _tile_stats),
# corner-projected footprint boxes (perspective images of convex boxes
# are convex; a margin absorbs Brown–Conrady bending and f32 rounding), and
# a 1e-4 m slack on every trunc comparison — anything uncertain lands in
# REFINE, which is exact. If a camera's REFINE/FREE_BORDER selection
# overflows its static capacity (tiered NB//8..NB//2 refine, NB//8
# border bricks), a lax.cond
# falls back to the dense map FOR THAT CAMERA, so results never depend
# on the capacities. Delta accumulation is per-frame across cameras
# (like the dense path), so max_weight clamp semantics are identical.

_BRICK = 8
_BVOX = _BRICK ** 3
_BBOX_MARGIN_PX = 3.0       # footprint slack: distortion bend + rounding
_FM = 1e-4                  # meters of slack on trunc comparisons

_CORNERS = np.array([[x, y, z] for x in (0, 1) for y in (0, 1)
                     for z in (0, 1)], np.float32)


def _to_bricks(a: jax.Array, shape) -> jax.Array:
    """[X,Y,Z](,C) → [NB, 512](,C) brick-major (8³ bricks contiguous)."""
    X, Y, Z = shape
    chan = a.shape[3:]
    t = a.reshape(X // _BRICK, _BRICK, Y // _BRICK, _BRICK,
                  Z // _BRICK, _BRICK, *chan)
    t = t.transpose(0, 2, 4, 1, 3, 5, *range(6, 6 + len(chan)))
    return t.reshape(-1, _BVOX, *chan)


def _from_bricks(ab: jax.Array, shape) -> jax.Array:
    """Inverse of _to_bricks."""
    X, Y, Z = shape
    chan = ab.shape[2:]
    t = ab.reshape(X // _BRICK, Y // _BRICK, Z // _BRICK,
                   _BRICK, _BRICK, _BRICK, *chan)
    t = t.transpose(0, 3, 1, 4, 2, 5, *range(6, 6 + len(chan)))
    return t.reshape(X, Y, Z, *chan)


def _brick_voxel_world(bids: jax.Array, shape, origin, leaf) -> jax.Array:
    """[K] brick ids → [K, 512, 3] world voxel centers (sentinel ids ==
    NB produce out-of-range coordinates; their scatter rows are dropped)."""
    _, Y, Z = shape
    nby, nbz = Y // _BRICK, Z // _BRICK
    bi = bids // (nby * nbz)
    bj = (bids // nbz) % nby
    bk = bids % nbz
    o = jnp.arange(_BVOX, dtype=jnp.int32)
    di, dj, dk = o // 64, (o // 8) % 8, o % 8
    g = jnp.stack([bi[:, None] * _BRICK + di[None],
                   bj[:, None] * _BRICK + dj[None],
                   bk[:, None] * _BRICK + dk[None]],
                  axis=-1).astype(jnp.float32)
    return origin + g * leaf


def _tile_stats(depth_m_c, z_min, z_max, tile: int):
    """Per-tile valid-depth stats with a 3×3 tile-neighborhood fold.

    Returns (dmin, dmax, allv) [⌈H/tile⌉, ⌈W/tile⌉] where entry (i, j)
    bounds the 3·tile-px window centered on tile (i, j) — so ONE read
    per brick conservatively bounds any footprint spanning ≤ 2 tiles
    (the round-3 classifier read a 2×2 block = 4 gathers per stat and
    bounded a 2·tile window; the fold moves that work into a cheap
    separable image-space pass and HALVES the window per read, which is
    what shrinks silhouette-shadow REFINE cones). Pads: +inf / -inf /
    True, so out-of-image pixels never poison a tile (they're
    pix_ok-false, not bad-depth).
    """
    H, W = depth_m_c.shape
    valid = (depth_m_c > jnp.maximum(z_min, 0.0)) & (depth_m_c < z_max)
    ph, pw = -(-H // tile), -(-W // tile)
    pad = ((0, ph * tile - H), (0, pw * tile - W))
    dmin = jnp.pad(jnp.where(valid, depth_m_c, jnp.inf), pad,
                   constant_values=jnp.inf) \
        .reshape(ph, tile, pw, tile).min(axis=(1, 3))
    dmax = jnp.pad(jnp.where(valid, depth_m_c, -jnp.inf), pad,
                   constant_values=-jnp.inf) \
        .reshape(ph, tile, pw, tile).max(axis=(1, 3))
    allv = jnp.pad(valid, pad, constant_values=True) \
        .reshape(ph, tile, pw, tile).all(axis=(1, 3))

    def fold3(a, op, ident):
        p = jnp.pad(a, 1, constant_values=ident)
        rows = op(op(p[:-2], p[1:-1]), p[2:])
        return op(op(rows[:, :-2], rows[:, 1:-1]), rows[:, 2:])

    return (fold3(dmin, jnp.minimum, jnp.inf),
            fold3(dmax, jnp.maximum, -jnp.inf),
            fold3(allv, jnp.logical_and, True))


# fine tile: the window is 3·tile px and a brick uses it only when its
# margined footprint spans ≤ 2 tiles — 32 px fits the common regime
# (8·leaf·f/z ≈ 30 px at 1 cm/421 px/1.2 m) with a 96-px window; 16/24/48
# gave worse refine counts on a structured test scene (16 pushes typical
# footprints to the coarse level, 48 widens the window)
_TILE_F = 32
_TILE_C = 64       # coarse fallback tile (192-px window)


def _classify_bricks(depth_m_c, intr_c, inv_ext_c, shape, origin, leaf,
                     trunc, z_min, z_max):
    """Per-brick class flags for one camera: (free_full, free_border,
    refine) bool [NB] (everything else provably updates nothing)."""
    X, Y, Z = shape
    H, W = depth_m_c.shape
    nb = (X // _BRICK) * (Y // _BRICK) * (Z // _BRICK)

    # two-level neighborhood-folded depth stats (see _tile_stats): the
    # fine level serves the bulk of the volume with a 96-px window, the
    # coarse level catches near-camera bricks, the global scalars catch
    # anything wider still
    fine = _tile_stats(depth_m_c, z_min, z_max, _TILE_F)
    coarse = _tile_stats(depth_m_c, z_min, z_max, _TILE_C)
    dmin_g, dmax_g = fine[0].min(), fine[1].max()
    allv_g = fine[2].all()

    # brick corner boxes → camera-frame z range + footprint pixel box.
    # z is linear in position so the corner min/max is exact; the pinhole
    # image of a convex box is convex so the corner uv box bounds the
    # footprint, up to distortion bend — absorbed by the margin.
    nby, nbz = Y // _BRICK, Z // _BRICK
    bidx = jnp.arange(nb, dtype=jnp.int32)
    lo = jnp.stack([bidx // (nby * nbz), (bidx // nbz) % nby, bidx % nbz],
                   axis=-1).astype(jnp.float32) * float(_BRICK)
    corn = lo[:, None, :] + (float(_BRICK) - 1.0) * _CORNERS[None]
    p_c = se3_apply(inv_ext_c, (origin + corn * leaf).reshape(-1, 3)) \
        .reshape(nb, 8, 3)
    zmin_b = p_c[..., 2].min(axis=1)
    zmax_b = p_c[..., 2].max(axis=1)
    uv, _ = project(p_c.reshape(-1, 3), intr_c)
    uv = uv.reshape(nb, 8, 2)
    m = _BBOX_MARGIN_PX + 1.0   # +1: round() widens the index range
    u0 = uv[..., 0].min(axis=1) - m
    u1 = uv[..., 0].max(axis=1) + m
    v0 = uv[..., 1].min(axis=1) - m
    v1 = uv[..., 1].max(axis=1) + m

    in_front_all = zmin_b > 1e-6      # project()'s gate is z > 1e-9
    in_front_none = zmax_b <= 0.0
    fully_in = (u0 >= 0) & (u1 <= W - 1) & (v0 >= 0) & (v1 <= H - 1)
    fully_out = (u1 < 0) | (u0 > W - 1) | (v1 < 0) | (v0 > H - 1)

    def level(tile, stats):
        """One folded read per stat; fits when the footprint spans ≤ 2
        tiles (the fold at floor(·/tile) of the min corner then covers
        it: window [t−1, t+2)·tile ⊇ tiles {t, t+1})."""
        ph, pw = stats[0].shape
        tu0 = jnp.floor(u0 / tile).astype(jnp.int32)
        tv0 = jnp.floor(v0 / tile).astype(jnp.int32)
        fits = ((jnp.floor(u1 / tile).astype(jnp.int32) - tu0 <= 1)
                & (jnp.floor(v1 / tile).astype(jnp.int32) - tv0 <= 1))
        iv = jnp.clip(tv0, 0, ph - 1)
        iu = jnp.clip(tu0, 0, pw - 1)
        return fits, tuple(s[iv, iu] for s in stats)

    fits_f, vf = level(_TILE_F, fine)
    fits_c, vc = level(_TILE_C, coarse)

    def pick(i, glob):
        return jnp.where(fits_f, vf[i], jnp.where(fits_c, vc[i], glob))

    dmin_r = pick(0, dmin_g)
    dmax_r = pick(1, dmax_g)
    allv_r = pick(2, allv_g)

    free_c = in_front_all & allv_r & (dmin_r - zmax_b >= trunc + _FM)
    # dmax_r == -inf (footprint entirely invalid) makes this true too —
    # exactly right, those voxels all have d_ok == False
    occl = in_front_all & (dmax_r - zmin_b < -trunc - _FM)
    free_full = free_c & fully_in
    free_border = free_c & ~fully_in & ~fully_out
    skip = in_front_none | (in_front_all & (fully_out | occl))
    refine = ~(free_full | free_border | skip)
    return free_full, free_border, refine


@partial(jax.jit, donate_argnames=("vol",))
def _integrate_brick_jit(vol: TSDFVolume, depth, intr, extrinsics,
                         depth_scale, max_weight, color, cam_mask,
                         z_min, z_max) -> TSDFVolume:
    shape = vol.shape
    X, Y, Z = shape
    nb = (X // _BRICK) * (Y // _BRICK) * (Z // _BRICK)
    rcap = min(nb, max(256, nb // 8))    # refine bricks per camera
    bcap = min(nb, max(256, nb // 4))    # border bricks per camera
    ncam, H, W = depth.shape
    has_rgb = vol.rgb is not None

    depth_m = depth.astype(jnp.float32) * depth_scale
    inv_ext = se3_inverse(extrinsics)

    def camera_deltas(c):
        intr_c = _cam_slice(intr, c)
        depth_flat = depth_m[c].reshape(-1)
        color_flat = color[c].reshape(-1, 3) if has_rgb else None
        free_full, free_border, refine = _classify_bricks(
            depth_m[c], intr_c, inv_ext[c], shape, vol.origin, vol.leaf,
            vol.trunc, z_min, z_max)
        overflow = (jnp.sum(refine) > rcap) | (jnp.sum(free_border) > bcap)

        def fast(_):
            (rb,) = jnp.nonzero(refine, size=rcap, fill_value=nb)
            p_w = _brick_voxel_world(rb, shape, vol.origin, vol.leaf)
            wt, w, rgb4 = _voxel_update_terms(
                p_w.reshape(-1, 3), depth_flat, intr_c, inv_ext[c],
                vol.trunc, z_min, z_max, W, H, cam_mask[c],
                color_flat=color_flat)
            # sentinel rows (rb == nb) scatter out of bounds → dropped
            # (jax's default FILL_OR_DROP scatter mode)
            d_wt = jnp.zeros((nb, _BVOX), jnp.float32) \
                .at[rb].add(wt.reshape(rcap, _BVOX))
            d_w = jnp.zeros((nb, _BVOX), jnp.float32) \
                .at[rb].add(w.reshape(rcap, _BVOX))
            if has_rgb:
                d_rgb = jnp.zeros((nb, _BVOX, 4), jnp.float32) \
                    .at[rb].add(rgb4.reshape(rcap, _BVOX, 4))
            else:
                d_rgb = jnp.zeros((1, 1, 4), jnp.float32)

            # border bricks: classification already proved sdf >= trunc
            # and valid depth for every in-image pixel — only the
            # per-voxel pix_ok test remains. No depth gather.
            (bb,) = jnp.nonzero(free_border, size=bcap, fill_value=nb)
            p_wb = _brick_voxel_world(bb, shape, vol.origin, vol.leaf)
            q_c = se3_apply(inv_ext[c], p_wb.reshape(-1, 3))
            uvb, in_front = project(q_c, intr_c)
            ub = jnp.round(uvb[:, 0]).astype(jnp.int32)
            vb = jnp.round(uvb[:, 1]).astype(jnp.int32)
            pix_ok = (in_front & (ub >= 0) & (ub < W)
                      & (vb >= 0) & (vb < H) & cam_mask[c])
            wb = pix_ok.astype(jnp.float32).reshape(bcap, _BVOX)
            d_wt = d_wt.at[bb].add(wb)   # t_obs == 1 in proven free space
            d_w = d_w.at[bb].add(wb)
            fc = free_full.astype(jnp.float32) \
                * cam_mask[c].astype(jnp.float32)
            return d_wt, d_w, d_rgb, fc

        def dense(_):
            # capacity overflow (more than rcap band/boundary bricks):
            # exact dense map for this camera — correctness never
            # depends on the static capacities
            p_w = _voxel_centers(shape, vol.origin, vol.leaf)
            wt, w, rgb4 = _voxel_update_terms(
                p_w, depth_flat, intr_c, inv_ext[c], vol.trunc,
                z_min, z_max, W, H, cam_mask[c], color_flat=color_flat)
            d_wt = _to_bricks(wt.reshape(shape), shape)
            d_w = _to_bricks(w.reshape(shape), shape)
            d_rgb = _to_bricks(rgb4.reshape(*shape, 4), shape) if has_rgb \
                else jnp.zeros((1, 1, 4), jnp.float32)
            return d_wt, d_w, d_rgb, jnp.zeros((nb,), jnp.float32)

        return jax.lax.cond(overflow, dense, fast, None)

    def body(c, acc):
        sum_wt, sum_w, sum_rgb, fc_tot = acc
        d_wt, d_w, d_rgb, fc = camera_deltas(c)
        return (sum_wt + d_wt, sum_w + d_w, sum_rgb + d_rgb, fc_tot + fc)

    init_rgb = jnp.zeros((nb, _BVOX, 4), jnp.float32) if has_rgb \
        else jnp.zeros((1, 1, 4), jnp.float32)
    sum_wt, sum_w, sum_rgb, fc = jax.lax.fori_loop(
        0, ncam, body,
        (jnp.zeros((nb, _BVOX), jnp.float32),
         jnp.zeros((nb, _BVOX), jnp.float32), init_rgb,
         jnp.zeros((nb,), jnp.float32)))

    # merge in brick-major space (same arithmetic as the dense path)
    t_b = _to_bricks(vol.tsdf, shape)
    w_b = _to_bricks(vol.weight, shape)
    sum_w = sum_w + fc[:, None]
    sum_wt = sum_wt + fc[:, None]     # free space contributes t_obs = 1
    w_new = w_b + sum_w
    t_new = jnp.where(w_new > 0.0,
                      (t_b * w_b + sum_wt) / jnp.maximum(w_new, 1e-12),
                      1.0)
    new_rgb = None
    if has_rgb:
        rgb_b = _to_bricks(vol.rgb, shape)
        rw_old = jnp.minimum(w_b, max_weight)
        rgb_acc = rgb_b * rw_old[..., None] + sum_rgb[..., :3]
        rw_new = rw_old + sum_rgb[..., 3]
        new_rgb = _from_bricks(
            jnp.where(rw_new[..., None] > 0.0,
                      rgb_acc / jnp.maximum(rw_new, 1e-12)[..., None],
                      0.0), shape)
    return TSDFVolume(
        tsdf=_from_bricks(t_new, shape),
        weight=_from_bricks(jnp.minimum(w_new, max_weight), shape),
        origin=vol.origin, leaf=vol.leaf, trunc=vol.trunc, rgb=new_rgb)


# --------------------------------------------------------------------------
# one-hot matmul integration
# --------------------------------------------------------------------------
#
# The dense map's cost is the 16.7M-row random gather from the depth image
# (at 256³). The access pattern has *structure* a plain gather can't
# exploit: an 8³ voxel brick projects into a small, contiguous image patch.
# So turn the random gather into dense matrix work:
#
#   per brick:  patch = dynamic_slice(depth, (v0, u0), (64, 64))
#               rows  = onehot(v_local) @ patch     # one-hot exact
#               d     = sum(rows * (iota == u_local), -1)
#
# One-hot rows select exactly one element, so with HIGHEST precision the
# result is BITWISE the gathered f32 value — parity with the dense path is
# exact equality, not a tolerance. Bricks whose valid
# footprint exceeds the static patch (camera closer than roughly
# 8·leaf·f/PATCH ≈ 0.5 m at 1 cm/421 px) are patched by a brick-granular
# gather capped at `kb` bricks, and if even that overflows a lax.cond
# falls back to the dense gather for that camera — results never depend
# on the capacities (same contract as the brick integrator).
#
# On top of the lookup, the integrator PRUNES with the same classifier
# the brick integrator uses (_classify_bricks): only REFINE bricks —
# the truncation band, valid/invalid depth boundaries, image-border and
# near-camera bricks — are gathered at all; FREE bricks broadcast their
# provable +1 per camera, FREE_BORDER bricks run the per-voxel bounds
# test with no gather, SKIP bricks cost nothing. An overflowing camera
# falls back to the unpruned full-grid one-hot lookup. Every per-voxel delta is a single value added
# into a zero buffer per camera (categories are mutually exclusive), and
# cameras accumulate in the same fori_loop order as dense — so pruning
# preserves BITWISE parity, not just a tolerance.
#
# Color rides the same one-hot windows: 8-bit channels pack into ONE
# integer-valued f32 image (r + 256·g + 65536·b ≤ 2²⁴−1, exactly
# representable) so a colored
# integrate costs ONE extra gathered plane; wider color dtypes gather
# three f32-cast planes. Non-8-divisible grids are padded internally —
# bricks tile the padded grid, and the padded voxels' terms are sliced
# off before the elementwise merge, so results are exact for any shape.

_PATCH = 64        # image patch edge (pixels) for the one-hot lookup
_MXU_CHUNK = 1024  # bricks per lax.map step


def _plan_windows(ui, vi, pix_ok, H: int, W: int):
    """Per-brick window plan shared by every image plane gathered at the
    same voxel indices (depth + color ride identical windows).

    ui/vi [K, 512] int32 CLIPPED image coords, pix_ok [K, 512] marks
    voxels whose unclipped projection is valid. Returns (v0, u0, fits):
    window starts [K], clamped so the static patch stays in bounds, and a
    mask of bricks whose valid footprint fits one window.
    """
    big = jnp.int32(1 << 20)
    u_min = jnp.min(jnp.where(pix_ok, ui, big), axis=1)
    u_max = jnp.max(jnp.where(pix_ok, ui, -1), axis=1)
    v_min = jnp.min(jnp.where(pix_ok, vi, big), axis=1)
    v_max = jnp.max(jnp.where(pix_ok, vi, -1), axis=1)
    none_ok = ~jnp.any(pix_ok, axis=1)
    pv, pu = min(_PATCH, H), min(_PATCH, W)
    fits = none_ok | ((u_max - u_min < pu) & (v_max - v_min < pv))
    # clamped patch origin still covers the span: u0 = min(u_min, W-pu)
    # and u_max <= W-1 give iu in [0, pu) whenever the brick fits
    u0 = jnp.clip(jnp.where(none_ok, 0, u_min), 0, W - pu)
    v0 = jnp.clip(jnp.where(none_ok, 0, v_min), 0, H - pv)
    return v0, u0, fits


def _onehot_gather(img, v0, u0, iv, iu):
    """img[v0+iv, u0+iu] via one-hot dots — ONE [H, W] f32 plane.

    Bitwise the gathered value for every index that lands in its brick's
    window (fitting bricks' pix_ok voxels); elsewhere don't-care (0) —
    callers patch non-fitting bricks and the update math gates invalid
    voxels. Streams [chunk, 512, 64] one-hots through memory at HIGHEST
    precision.
    """
    nb = v0.shape[0]
    H, W = img.shape
    pv, pu = min(_PATCH, H), min(_PATCH, W)

    def chunk_fn(args):
        v0c, u0c, ivc, iuc = args
        patches = jax.vmap(
            lambda v_, u_: jax.lax.dynamic_slice(
                img, (v_, u_), (pv, pu)))(v0c, u0c)         # [C, pv, pu]
        ov = (ivc[:, :, None] == jnp.arange(pv, dtype=jnp.int32)) \
            .astype(jnp.float32)                            # [C, 512, pv]
        rows = jnp.einsum('bvp,bpq->bvq', ov, patches,
                          precision=jax.lax.Precision.HIGHEST)
        sel = iuc[:, :, None] == jnp.arange(pu, dtype=jnp.int32)
        return jnp.sum(jnp.where(sel, rows, 0.0), axis=-1)  # [C, 512]

    # full chunks via sentinel padding, NOT gcd(chunk, nb): the pruned
    # tier capacities (nb//3, nb//2) and any-shape brick counts are
    # rarely chunk-divisible, and a gcd chunk degenerates to 1-2 rows —
    # thousands of serialized map steps. Pad rows gather window (0,0) (in
    # bounds, don't-care) and are sliced off; per-row values are
    # chunk-size independent, so this stays bitwise.
    c = min(_MXU_CHUNK, nb)
    k = -(-nb // c) * c
    if k != nb:
        pad = k - nb
        v0 = jnp.concatenate([v0, jnp.zeros((pad,), v0.dtype)])
        u0 = jnp.concatenate([u0, jnp.zeros((pad,), u0.dtype)])
        iv = jnp.concatenate([iv, jnp.zeros((pad, _BVOX), iv.dtype)])
        iu = jnp.concatenate([iu, jnp.zeros((pad, _BVOX), iu.dtype)])
    d = jax.lax.map(chunk_fn,
                    (v0.reshape(-1, c), u0.reshape(-1, c),
                     iv.reshape(-1, c, _BVOX), iu.reshape(-1, c, _BVOX)))
    return d.reshape(k, _BVOX)[:nb]


@partial(jax.jit, donate_argnames=("vol",))
def _integrate_mxu_jit(vol: TSDFVolume, depth, intr, extrinsics,
                       depth_scale, max_weight, color, cam_mask,
                       z_min, z_max) -> TSDFVolume:
    X0, Y0, Z0 = vol.shape
    # any-shape: bricks tile an internally padded grid; the pad voxels
    # are real world positions whose terms get computed and then sliced
    # off before the elementwise merge, so results are exact
    shape = tuple(-(-s // _BRICK) * _BRICK for s in (X0, Y0, Z0))
    X, Y, Z = shape
    nb = (X // _BRICK) * (Y // _BRICK) * (Z // _BRICK)
    # tiered gather capacities: the lookup's cost is proportional to the
    # STATIC capacity (sentinel-padded), so a per-camera lax.cond chain
    # picks the smallest tier that fits its REFINE count — a thin-band
    # rig pays nb//8, a plane-heavy scene nb//3, pepper-hole frames
    # nb//2, and only a band-saturating frame pays the full unpruned grid
    gcaps = sorted({min(nb, max(256, nb // 8)),
                    min(nb, max(256, nb // 3)),
                    min(nb, max(256, nb // 2))})
    bcap = min(nb, max(256, nb // 8))   # FREE_BORDER bricks/camera
    ncam, H, W = depth.shape
    has_rgb = vol.rgb is not None

    # the lookup gathers the PRE-scale image; raw*scale after the gather
    # is bitwise the dense value
    depth_raw = depth.astype(jnp.float32)
    depth_m = depth_raw * depth_scale
    inv_ext = se3_inverse(extrinsics)

    # color planes riding the same one-hot windows: 8-bit channels pack
    # into ONE integer-valued f32 image (≤ 24 significant bits, exact in
    # f32); wider dtypes gather three f32-cast
    # planes (the dense path gathers then casts, and per-element
    # cast-then-gather is the same value)
    packed_rgb = has_rgb and color.dtype == jnp.uint8
    if has_rgb:
        colf = color.astype(jnp.float32)
        col_planes = (colf[..., 0] + 256.0 * colf[..., 1]
                      + 65536.0 * colf[..., 2],) if packed_rgb \
            else tuple(colf[..., i] for i in range(3))
    else:
        col_planes = ()

    def unpack_rgb(planes):
        """[K*512] gathered plane(s) → [K*512, 3] exact channel values."""
        if packed_rgb:
            p = planes[0]
            b = jnp.floor(p / 65536.0)          # /2^16 is exact scaling
            rem = p - b * 65536.0               # integers ≤ 2^24: exact
            g = jnp.floor(rem / 256.0)
            r = rem - g * 256.0
            return jnp.stack([r, g, b], axis=-1)
        return jnp.stack(planes, axis=-1)

    def lookup_terms(bsel, c, intr_c):
        """Per-voxel (wt, w, rgb4) for bricks ``bsel`` [K] of camera c
        via the one-hot lookup. Sentinel rows (bsel == nb) carry
        don't-care values — callers drop them at scatter time."""
        K = bsel.shape[0]
        p_w = _brick_voxel_world(bsel, shape, vol.origin, vol.leaf) \
            .reshape(-1, 3)
        p_c = se3_apply(inv_ext[c], p_w)
        uv, in_front = project(p_c, intr_c)
        ui = jnp.round(uv[:, 0]).astype(jnp.int32)
        vi = jnp.round(uv[:, 1]).astype(jnp.int32)
        pix_ok = in_front & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
        uib = jnp.clip(ui, 0, W - 1).reshape(K, _BVOX)
        vib = jnp.clip(vi, 0, H - 1).reshape(K, _BVOX)
        v0, u0, fits = _plan_windows(
            uib, vib, pix_ok.reshape(K, _BVOX), H, W)
        fits = fits | (bsel == nb)      # sentinels never eat kb slots
        iv = vib - v0[:, None]
        iu = uib - u0[:, None]
        d = _onehot_gather(depth_raw[c], v0, u0, iv, iu) * depth_scale
        cols = tuple(_onehot_gather(p[c], v0, u0, iv, iu)
                     for p in col_planes)
        flat = vib * W + uib
        kb = min(K, max(64, K // 8))    # near-camera fallback bricks

        def patched(_):
            # gather ONLY the non-fitting bricks (fill_value K rows are
            # dropped by the OOB-scatter contract)
            (bad,) = jnp.nonzero(~fits, size=kb, fill_value=K)
            rows = flat[jnp.clip(bad, 0, K - 1)]            # [kb, 512]
            return (d.at[bad].set(depth_m[c].reshape(-1)[rows],
                                  mode="drop"),
                    *(cp.at[bad].set(plane[c].reshape(-1)[rows],
                                     mode="drop")
                      for cp, plane in zip(cols, col_planes)))

        def full(_):
            r = flat.reshape(-1)
            return (depth_m[c].reshape(-1)[r].reshape(K, _BVOX),
                    *(plane[c].reshape(-1)[r].reshape(K, _BVOX)
                      for plane in col_planes))

        out = jax.lax.cond(jnp.sum(~fits) > kb, full, patched, None)
        wt, w_obs, obs, sdf = _terms_from_depth(
            out[0].reshape(-1), p_c[:, 2], pix_ok, vol.trunc,
            z_min, z_max, cam_mask[c])
        rgb4 = None
        if has_rgb:
            near = obs & (jnp.abs(sdf) <= vol.trunc)
            wc = near.astype(jnp.float32)
            rgb_px = unpack_rgb([cp.reshape(-1) for cp in out[1:]])
            rgb4 = jnp.concatenate([wc[:, None] * rgb_px, wc[:, None]],
                                   axis=-1).reshape(K, _BVOX, 4)
        return wt.reshape(K, _BVOX), w_obs.reshape(K, _BVOX), rgb4

    no_rgb_delta = jnp.zeros((1, 1, 4), jnp.float32)

    def camera_deltas(c):
        intr_c = _cam_slice(intr, c)
        free_full, free_border, refine = _classify_bricks(
            depth_m[c], intr_c, inv_ext[c], shape, vol.origin, vol.leaf,
            vol.trunc, z_min, z_max)
        n_refine = jnp.sum(refine)
        border_over = jnp.sum(free_border) > bcap

        def pruned(gcap, _):
            (rb,) = jnp.nonzero(refine, size=gcap, fill_value=nb)
            wt, w, rgb4 = lookup_terms(rb, c, intr_c)
            d_wt = jnp.zeros((nb, _BVOX), jnp.float32) \
                .at[rb].add(wt, mode="drop")
            d_w = jnp.zeros((nb, _BVOX), jnp.float32) \
                .at[rb].add(w, mode="drop")
            d_rgb = jnp.zeros((nb, _BVOX, 4), jnp.float32) \
                .at[rb].add(rgb4, mode="drop") if has_rgb else no_rgb_delta
            # FREE_BORDER: classification proved sdf >= trunc and valid
            # depth for every in-image pixel — only the per-voxel bounds
            # test runs, no gather (same move as _integrate_brick_jit;
            # color needs nothing: |sdf| <= trunc is provably false)
            (bb,) = jnp.nonzero(free_border, size=bcap, fill_value=nb)
            p_wb = _brick_voxel_world(bb, shape, vol.origin, vol.leaf)
            q_c = se3_apply(inv_ext[c], p_wb.reshape(-1, 3))
            uvb, in_front = project(q_c, intr_c)
            ub = jnp.round(uvb[:, 0]).astype(jnp.int32)
            vb = jnp.round(uvb[:, 1]).astype(jnp.int32)
            ok = (in_front & (ub >= 0) & (ub < W) & (vb >= 0) & (vb < H)
                  & cam_mask[c])
            wb = ok.astype(jnp.float32).reshape(bcap, _BVOX)
            d_wt = d_wt.at[bb].add(wb, mode="drop")
            d_w = d_w.at[bb].add(wb, mode="drop")
            # FREE interior bricks: every voxel contributes exactly 1.0
            # (t_obs clamps to 1) — broadcast INTO the per-camera delta,
            # keeping the camera accumulation order identical to dense
            # (merge-time broadcast like the brick integrator would
            # reorder the f32 sum and break bitwise parity)
            fb = (free_full & cam_mask[c]).astype(jnp.float32)[:, None]
            return d_wt + fb, d_w + fb, d_rgb

        def unpruned(_):
            bids = jnp.arange(nb, dtype=jnp.int32)
            wt, w, rgb4 = lookup_terms(bids, c, intr_c)
            return wt, w, rgb4 if has_rgb else no_rgb_delta

        def tiered(x, caps=tuple(gcaps)):
            if len(caps) == 1:
                return pruned(caps[0], x)
            return jax.lax.cond(n_refine > caps[0],
                                lambda y: tiered(y, caps[1:]),
                                partial(pruned, caps[0]), x)

        return jax.lax.cond(border_over | (n_refine > gcaps[-1]),
                            unpruned, tiered, None)

    def body(c, acc):
        sum_wt, sum_w, sum_rgb = acc
        d_wt, d_w, d_rgb = camera_deltas(c)
        return sum_wt + d_wt, sum_w + d_w, sum_rgb + d_rgb

    init_rgb = jnp.zeros((nb, _BVOX, 4), jnp.float32) if has_rgb \
        else no_rgb_delta
    sum_wt, sum_w, sum_rgb = jax.lax.fori_loop(
        0, ncam, body,
        (jnp.zeros((nb, _BVOX), jnp.float32),
         jnp.zeros((nb, _BVOX), jnp.float32), init_rgb))

    # merge in the volume's natural layout: only the camera-sum arrays
    # cross from brick-major back (2 transposes, not a 4-transpose
    # volume round trip — the update arithmetic is elementwise, so it
    # commutes with the layout permutation bitwise), cropping the
    # internal padding first
    crop = (slice(0, X0), slice(0, Y0), slice(0, Z0))
    sum_wt = _from_bricks(sum_wt, shape)[crop]
    sum_w = _from_bricks(sum_w, shape)[crop]
    w_new = vol.weight + sum_w
    t_new = jnp.where(w_new > 0.0,
                      (vol.tsdf * vol.weight + sum_wt)
                      / jnp.maximum(w_new, 1e-12),
                      1.0)
    new_rgb = None
    if has_rgb:
        sum_rgb = _from_bricks(sum_rgb, shape)[crop]
        rw_old = jnp.minimum(vol.weight, max_weight)
        rgb_acc = vol.rgb * rw_old[..., None] + sum_rgb[..., :3]
        rw_new = rw_old + sum_rgb[..., 3]
        new_rgb = jnp.where(rw_new[..., None] > 0.0,
                            rgb_acc / jnp.maximum(rw_new, 1e-12)[..., None],
                            0.0)
    return TSDFVolume(
        tsdf=t_new, weight=jnp.minimum(w_new, max_weight),
        origin=vol.origin, leaf=vol.leaf, trunc=vol.trunc, rgb=new_rgb)


# --------------------------------------------------------------------------
# sampling helpers
# --------------------------------------------------------------------------

def _sample_trilinear(field, weight, p, origin, leaf):
    """Trilinear sample of ``field`` at world points [R, 3] (or [R,3]-
    leading channels if field is [X,Y,Z,C]).

    Returns (values [R] or [R,C], valid [R]) — valid requires all 8
    support voxels observed (weight > 0) and in bounds.
    """
    X, Y, Z = field.shape[:3]
    chan = field.ndim == 4
    g = (p - origin) / leaf
    g0 = jnp.floor(g)
    f = g - g0
    i0 = g0.astype(jnp.int32)
    ok = jnp.all((i0 >= 0) & (i0 < jnp.asarray([X - 1, Y - 1, Z - 1])),
                 axis=-1)
    i0c = jnp.clip(i0, 0, jnp.asarray([X - 2, Y - 2, Z - 2]))
    vals = 0.0
    wmin = jnp.inf
    ff = field.reshape(-1, field.shape[-1]) if chan else field.reshape(-1)
    wf = weight.reshape(-1)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                flat = ((i0c[:, 0] + dx) * Y + (i0c[:, 1] + dy)) * Z \
                    + (i0c[:, 2] + dz)
                wgt = (jnp.where(dx, f[:, 0], 1 - f[:, 0])
                       * jnp.where(dy, f[:, 1], 1 - f[:, 1])
                       * jnp.where(dz, f[:, 2], 1 - f[:, 2]))
                v = ff[flat]
                vals = vals + (wgt[:, None] * v if chan else wgt * v)
                wmin = jnp.minimum(wmin, wf[flat])
    return vals, ok & (wmin > 0.0)


def _nan_field(vol: TSDFVolume) -> jax.Array:
    """Flat tsdf with NaN where never observed (weight == 0).

    One fused elementwise pass folds the observation mask INTO the value
    stream, so every later sample needs ONE random read instead of two
    (tsdf + weight). Random reads dominate the raycast, so halving them
    halves the march.
    """
    return jnp.where(vol.weight > 0.0, vol.tsdf,
                     jnp.float32(jnp.nan)).reshape(-1)


def _sample_nearest_soa(flat_field, shape, gx, gy, gz):
    """Nearest sample of a NaN-masked flat field at grid coords (SoA).

    gx/gy/gz are (p - origin)/leaf, any matching shape. Returns values
    with NaN for out-of-volume or never-observed — comparisons against
    NaN are False, so march logic needs no separate masks.
    """
    X, Y, Z = shape
    ix = jnp.round(gx).astype(jnp.int32)
    iy = jnp.round(gy).astype(jnp.int32)
    iz = jnp.round(gz).astype(jnp.int32)
    inside = ((ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
              & (iz >= 0) & (iz < Z))
    flat = ((jnp.clip(ix, 0, X - 1) * Y + jnp.clip(iy, 0, Y - 1)) * Z
            + jnp.clip(iz, 0, Z - 1))
    return jnp.where(inside, flat_field[flat], jnp.float32(jnp.nan))


def _cell_corners_soa(flat_field, shape, gx, gy, gz):
    """Fetch the 8 cell corners + interpolation fractions at grid coords.

    Returns (corners [2][2][2] arrays, fx, fy, fz) with out-of-volume
    cells yielding NaN corners. 8 random reads — shared by the trilinear
    value AND its analytic gradient (the old central-difference normals
    re-sampled 6 trilinear neighborhoods = 96 reads per ray)."""
    X, Y, Z = shape
    g0x, g0y, g0z = jnp.floor(gx), jnp.floor(gy), jnp.floor(gz)
    fx_, fy_, fz_ = gx - g0x, gy - g0y, gz - g0z
    i0x = g0x.astype(jnp.int32)
    i0y = g0y.astype(jnp.int32)
    i0z = g0z.astype(jnp.int32)
    ok = ((i0x >= 0) & (i0x < X - 1) & (i0y >= 0) & (i0y < Y - 1)
          & (i0z >= 0) & (i0z < Z - 1))
    i0x = jnp.clip(i0x, 0, X - 2)
    i0y = jnp.clip(i0y, 0, Y - 2)
    i0z = jnp.clip(i0z, 0, Z - 2)
    nan = jnp.float32(jnp.nan)
    c = [[[None, None], [None, None]], [[None, None], [None, None]]]
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                flat = (((i0x + dx) * Y + (i0y + dy)) * Z + (i0z + dz))
                c[dx][dy][dz] = jnp.where(ok, flat_field[flat], nan)
    return c, fx_, fy_, fz_


def _trilinear_from_corners(c, fx_, fy_, fz_):
    """Trilinear value from _cell_corners_soa output (NaN-propagating)."""
    val = 0.0
    for dx in (0, 1):
        wx = fx_ if dx else 1.0 - fx_
        for dy in (0, 1):
            wy = fy_ if dy else 1.0 - fy_
            for dz in (0, 1):
                wz = fz_ if dz else 1.0 - fz_
                val = val + wx * wy * wz * c[dx][dy][dz]
    return val


def _sample_trilinear_soa(flat_field, shape, gx, gy, gz):
    """Trilinear sample (SoA, NaN-masked) — 8 random reads."""
    c, fx_, fy_, fz_ = _cell_corners_soa(flat_field, shape, gx, gy, gz)
    return _trilinear_from_corners(c, fx_, fy_, fz_)


def _project_soa(xc, yc, zc, intr):
    """SoA mirror of ops.deproject.project for ONE camera.

    Same math on separate coordinate planes instead of an [N, 3] array,
    so every elementwise op runs over long contiguous planes instead of a
    minor dimension of 3. Returns (u, v, in_front)."""
    from ..ops.deproject import (DistortionModel,
                                 _distort_inverse_brown_conrady,
                                 _undistort_brown_conrady_iterative)
    in_front = zc > 1e-9
    zs = jnp.where(in_front, zc, 1.0)
    x = xc / zs
    y = yc / zs
    model = int(intr.model)
    if model != int(DistortionModel.NONE):
        coeffs = jnp.asarray(intr.coeffs, jnp.float32)
        if model == int(DistortionModel.BROWN_CONRADY):
            x, y = _distort_inverse_brown_conrady(x, y, coeffs)
        elif model == int(DistortionModel.INVERSE_BROWN_CONRADY):
            x, y = _undistort_brown_conrady_iterative(x, y, coeffs)
        elif model == int(DistortionModel.MIXED):
            x_bc, y_bc = _distort_inverse_brown_conrady(x, y, coeffs)
            x_ibc, y_ibc = _undistort_brown_conrady_iterative(x, y, coeffs)
            mid = jnp.asarray(intr.model_ids, jnp.int32)
            is_bc = mid == int(DistortionModel.BROWN_CONRADY)
            is_ibc = mid == int(DistortionModel.INVERSE_BROWN_CONRADY)
            x = jnp.where(is_bc, x_bc, jnp.where(is_ibc, x_ibc, x))
            y = jnp.where(is_bc, y_bc, jnp.where(is_ibc, y_ibc, y))
    u = x * jnp.asarray(intr.fx, jnp.float32) \
        + jnp.asarray(intr.ppx, jnp.float32)
    v = y * jnp.asarray(intr.fy, jnp.float32) \
        + jnp.asarray(intr.ppy, jnp.float32)
    return u, v, in_front


# --------------------------------------------------------------------------
# ray casting
# --------------------------------------------------------------------------

class RaycastResult(NamedTuple):
    """Per-pixel model view rendered from the volume (world frame)."""

    depth: jax.Array            # [h, w] f32 z-depth in the camera frame
    vertex: jax.Array           # [h, w, 3] f32 world-frame hit points
    normal: jax.Array           # [h, w, 3] f32 world-frame surface normals
    valid: jax.Array            # [h, w] bool — ray found a surface
    rgb: Optional[jax.Array] = None  # [h, w, 3] f32 if the volume has color


def raycast(vol: TSDFVolume, intr: Intrinsics, extrinsics: jax.Array,
            t_min: float = 0.2, t_max: float = 8.0,
            step: float | None = None, stride: int = 1,
            prior_depth: Optional[jax.Array] = None,
            prior_window: float = 0.3,
            depth_scale: float = 0.001) -> RaycastResult:
    """Render the volume from a camera by marching rays to the zero level.

    Fixed-step march (nearest-voxel samples) + linear refinement at the
    sign change + trilinear-gradient normals — the KinFu renderer, with
    the per-ray while-loop turned into a masked `lax.scan` so one program
    serves every frame.

    Args:
      vol: the volume (concrete arrays — `t_min/t_max/step` fix the
        static trip count, so this wrapper reads `leaf` off-device once).
      intr: ONE camera's Intrinsics (unbatched).
      extrinsics: [4, 4] camera→world.
      t_min/t_max: march range along the ray (meters, static).
      step: march step (meters, static; default 0.5·trunc — half the
        band, so a crossing can't be stepped over).
      stride: render every ``stride``-th pixel (cheap preview / tracking
        resolution; the returned maps are [H/stride, W/stride]).
      prior_depth: optional [H, W] live depth frame (raw u16 units or
        meters). When given, each ray marches only a ±``prior_window``
        band around its pixel's live depth instead of [t_min, t_max] —
        the frame-to-model tracking regime, where the live frame is an
        excellent surface prior. ~15× fewer volume samples at the
        default settings (the march gathers are the measured raycast
        cost). Rays whose live pixel is invalid march the window at
        t_min and typically report valid=False — exactly the rays
        tracking cannot use anyway. Full-range render: leave None.
      prior_window: half-width of the prior band (meters, static).
      depth_scale: meters per raw unit for an integer prior_depth.

    Returns a RaycastResult.
    """
    if step is None:
        step = 0.5 * float(vol.trunc)
    if prior_depth is None:
        n_steps = max(2, int(np.ceil((t_max - t_min) / step)))
        prior = None
    else:
        n_steps = max(2, int(np.ceil(2.0 * prior_window / step)) + 2)
        h = -(-int(intr.height) // stride)
        w = -(-int(intr.width) // stride)
        d = prior_depth[::stride, ::stride][:h, :w]
        prior = d.astype(jnp.float32) * (
            jnp.float32(depth_scale) if not jnp.issubdtype(
                prior_depth.dtype, jnp.floating) else jnp.float32(1.0))
    return _raycast_jit(vol, intr, jnp.asarray(extrinsics),
                        jnp.float32(t_min), jnp.float32(step),
                        prior, jnp.float32(prior_window),
                        n_steps=n_steps, stride=int(stride))


@partial(jax.jit, static_argnames=("n_steps", "stride"))
def _raycast_jit(vol: TSDFVolume, intr: Intrinsics, extrinsics,
                 t_min, step, prior, window,
                 n_steps: int, stride: int) -> RaycastResult:
    """SoA renderer. Random reads are THE cost (XLA gather ≈115 M/s,
    measured): one NaN-masked field fuses the tsdf+weight pair into a
    single read per sample, the crossing logic rides on NaN-compare
    semantics instead of mask arrays, and the normal comes from the
    analytic gradient of the trilinear interpolant at the hit cell —
    re-using its 8 corner reads instead of central-differencing six
    extra trilinear samples (96 reads). Coordinates stay in separate
    x/y/z planes throughout, not an [N, 3] layout with a minor
    dimension of 3."""
    h = -(-intr.height // stride)
    w = -(-intr.width // stride)
    intr_s = _strided_intr(intr, stride, h, w)
    # unit-depth deprojection = per-pixel ray direction incl. distortion
    dirs_cam = deproject(jnp.ones((h, w), jnp.float32), intr_s,
                         depth_scale=1.0).xyz                 # [h*w, 3]
    dir_norm = jnp.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    dirs_cam_n = dirs_cam / dir_norm                          # unit length
    R = extrinsics[:3, :3]
    o_w = extrinsics[:3, 3]
    # SoA world-frame ray dirs: d_w = R @ d_cam, one plane per component
    dcx, dcy, dcz = (dirs_cam_n[:, 0], dirs_cam_n[:, 1], dirs_cam_n[:, 2])
    dwx = R[0, 0] * dcx + R[0, 1] * dcy + R[0, 2] * dcz
    dwy = R[1, 0] * dcx + R[1, 1] * dcy + R[1, 2] * dcz
    dwz = R[2, 0] * dcx + R[2, 1] * dcy + R[2, 2] * dcz
    nray = h * w

    if prior is None:
        t_start = jnp.full((nray,), 1.0, jnp.float32) * t_min
    else:
        # live z-depth → distance along the unit ray; invalid pixels
        # (d <= 0) fall back to marching the short window from t_min
        d_live = prior.reshape(-1)
        t_live = d_live / jnp.maximum(dcz, 1e-6)
        t_start = jnp.where(d_live > 0.0,
                            jnp.maximum(t_live - window, t_min), t_min)

    field = _nan_field(vol)
    shape = vol.shape
    ox, oy, oz = vol.origin[0], vol.origin[1], vol.origin[2]
    leaf = vol.leaf

    def grid_coords(t):
        gx = (o_w[0] + dwx * t - ox) / leaf
        gy = (o_w[1] + dwy * t - oy) / leaf
        gz = (o_w[2] + dwz * t - oz) / leaf
        return gx, gy, gz

    def march(carry, k):
        prev_val, hit_t, found = carry
        t = t_start + step * k.astype(jnp.float32)
        val = _sample_nearest_soa(field, shape, *grid_coords(t))
        # NaN (outside / unobserved) compares False on both sides, so an
        # unobserved sample can neither open nor close a crossing
        cross = (prev_val > 0.0) & (val <= 0.0) & ~found
        frac = prev_val / jnp.maximum(prev_val - val, 1e-12)
        t_cross = (t - step) + step * jnp.clip(frac, 0.0, 1.0)
        hit_t = jnp.where(cross, t_cross, hit_t)
        found = found | cross
        return (val, hit_t, found), None

    init = (jnp.full((nray,), jnp.nan, jnp.float32),
            jnp.zeros((nray,), jnp.float32), jnp.zeros((nray,), bool))
    (_, hit_t, found), _ = jax.lax.scan(
        march, init, jnp.arange(n_steps, dtype=jnp.int32))

    # one trilinear secant refinement: the linear interp above used
    # nearest-voxel values; re-solve the crossing with trilinear samples
    # half a step either side (sub-voxel accuracy on smooth fields)
    hs = 0.5 * step
    v_a = _sample_trilinear_soa(field, shape, *grid_coords(hit_t - hs))
    v_b = _sample_trilinear_soa(field, shape, *grid_coords(hit_t + hs))
    denom = v_a - v_b
    tr = jnp.clip(v_a / jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom),
                  0.0, 1.0)
    refine_ok = v_a >= v_b            # False when either side is NaN
    t_ref = hit_t - hs + 2.0 * hs * tr
    hit_t = jnp.where(found & refine_ok, t_ref, hit_t)

    # normals: central differences of trilinear samples one leaf apart
    # (the KinFu estimator, unchanged semantics incl. its validity
    # region: the hit cell and its six face-neighbor cells fully
    # observed). A +/-leaf-shifted trilinear sample reuses the SAME
    # in-cell fractions in the face-neighbor cell, so all six samples
    # are linear combinations of one shared 32-node corner lattice --
    # 32 random reads instead of the 96 of sampling each neighborhood
    # independently (reads are the measured cost; see _nan_field).
    gx, gy, gz = grid_coords(hit_t)
    X, Y, Z = shape
    g0x, g0y, g0z = jnp.floor(gx), jnp.floor(gy), jnp.floor(gz)
    fx_, fy_, fz_ = gx - g0x, gy - g0y, gz - g0z
    i0x = g0x.astype(jnp.int32)
    i0y = g0y.astype(jnp.int32)
    i0z = g0z.astype(jnp.int32)
    okc = ((i0x >= 0) & (i0x < X - 1) & (i0y >= 0) & (i0y < Y - 1)
           & (i0z >= 0) & (i0z < Z - 1))
    b0x = jnp.clip(i0x, 0, X - 2)
    b0y = jnp.clip(i0y, 0, Y - 2)
    b0z = jnp.clip(i0z, 0, Z - 2)
    nanf = jnp.float32(jnp.nan)

    def node(dx, dy, dz):
        ix, iy, iz = b0x + dx, b0y + dy, b0z + dz
        ok = (okc & (ix >= 0) & (ix < X) & (iy >= 0) & (iy < Y)
              & (iz >= 0) & (iz < Z))
        flat = ((jnp.clip(ix, 0, X - 1) * Y + jnp.clip(iy, 0, Y - 1)) * Z
                + jnp.clip(iz, 0, Z - 1))
        return jnp.where(ok, field[flat], nanf)

    nd = {}
    for dx in (-1, 0, 1, 2):
        for dy in (0, 1):
            for dz in (0, 1):
                nd[(dx, dy, dz)] = node(dx, dy, dz)
    for dy in (-1, 2):
        for dx in (0, 1):
            for dz in (0, 1):
                nd[(dx, dy, dz)] = node(dx, dy, dz)
    for dz in (-1, 2):
        for dx in (0, 1):
            for dy in (0, 1):
                nd[(dx, dy, dz)] = node(dx, dy, dz)

    def tri(sx, sy, sz):
        # trilinear sample at the hit fractions, cell shifted one leaf
        val = 0.0
        for dx in (0, 1):
            wx = fx_ if dx else 1.0 - fx_
            for dy in (0, 1):
                wy = fy_ if dy else 1.0 - fy_
                for dz in (0, 1):
                    wz = fz_ if dz else 1.0 - fz_
                    val = val + wx * wy * wz * nd[(dx + sx, dy + sy,
                                                   dz + sz)]
        return val

    nx = tri(1, 0, 0) - tri(-1, 0, 0)
    ny = tri(0, 1, 0) - tri(0, -1, 0)
    nz = tri(0, 0, 1) - tri(0, 0, -1)
    gvalid = ~jnp.isnan(nx + ny + nz)  # any NaN node poisons the sums
    nn = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    nrm = jnp.maximum(nn, 1e-12)
    nx, ny, nz = nx / nrm, ny / nrm, nz / nrm
    # the TSDF grows along +outward (free space is +1), so the gradient
    # already points out of the surface; flip any stragglers toward the
    # camera so downstream point-to-plane sees a consistent hemisphere
    flip = (nx * dwx + ny * dwy + nz * dwz) > 0
    nx = jnp.where(flip, -nx, nx)
    ny = jnp.where(flip, -ny, ny)
    nz = jnp.where(flip, -nz, nz)
    valid = found & gvalid & (nn > 1e-9)

    z_cam = hit_t * dcz                                       # z-depth
    phx = o_w[0] + dwx * hit_t
    phy = o_w[1] + dwy * hit_t
    phz = o_w[2] + dwz * hit_t
    rgb = None
    if vol.rgb is not None:
        p_hit3 = jnp.stack([phx, phy, phz], axis=-1)
        rgb_v, _ = _sample_trilinear(vol.rgb, vol.weight, p_hit3,
                                     vol.origin, vol.leaf)
        rgb = jnp.where(valid[:, None], rgb_v, 0.0).reshape(h, w, 3)
    zero = jnp.zeros((nray,), jnp.float32)
    vm = lambda a: jnp.where(valid, a, zero)  # noqa: E731
    return RaycastResult(
        depth=vm(z_cam).reshape(h, w),
        vertex=jnp.stack([vm(phx), vm(phy), vm(phz)],
                         axis=-1).reshape(h, w, 3),
        normal=jnp.stack([vm(nx), vm(ny), vm(nz)],
                         axis=-1).reshape(h, w, 3),
        valid=valid.reshape(h, w),
        rgb=rgb)


def _strided_intr(intr: Intrinsics, stride: int, h: int, w: int
                  ) -> Intrinsics:
    """Intrinsics for the every-``stride``-th-pixel image: u' = u/stride
    maps through x = (u - ppx)/fx ⇔ fx' = fx/stride, ppx' = ppx/stride."""
    if stride == 1 and (h, w) == (intr.height, intr.width):
        return intr
    s = jnp.float32(stride)
    return Intrinsics(fx=intr.fx / s, fy=intr.fy / s,
                      ppx=intr.ppx / s, ppy=intr.ppy / s,
                      coeffs=intr.coeffs, model_ids=intr.model_ids,
                      width=w, height=h, model=intr.model)


# --------------------------------------------------------------------------
# frame-to-model tracking (projective point-to-plane ICP)
# --------------------------------------------------------------------------

class TrackResult(NamedTuple):
    T: jax.Array                # [4, 4] refined camera→world
    rms: jax.Array              # point-to-plane RMS over inliers (m)
    n_matched: jax.Array        # inlier count at the last iteration


def track(vol: TSDFVolume, depth: jax.Array, intr: Intrinsics,
          T_init: jax.Array, iterations: int = 6, rounds: int = 2,
          depth_scale: float = 0.001, dist_gate: float = 0.1,
          normal_gate: float = 0.5, stride: int = 2,
          t_min: float = 0.2, t_max: float = 8.0,
          prior_window: Optional[float] = None) -> TrackResult:
    """Refine a camera pose against the volume (KinFu frame-to-model).

    Ray-casts the model from the current estimate, then runs projective
    point-to-plane ICP: each live pixel's 3-D point projects into the
    model view (one gather — no NN search), pairs with the model vertex +
    normal there, and a 6-DoF twist is solved from the normal-projected
    residuals. Tracking against the *model* (not the previous frame)
    is what keeps per-frame drift from accumulating. ``rounds`` re-casts
    the model view from the refined pose and repeats — the model's
    self-occlusions and gating follow the estimate in, which removes most
    of the single-cast residual (measured: a 1.7° init error converges to
    0.65° with one round, 0.1° with two).

    Args:
      vol: the volume (concrete; ray-cast statics read off-device).
      depth: [H, W] live depth (u16 raw units or float meters).
      intr: the camera's Intrinsics.
      T_init: [4, 4] initial camera→world (previous frame's pose).
      iterations: fixed Gauss-Newton iterations per round (static).
      rounds: raycast-then-iterate passes (static; 2 is the sweet spot —
        at 30 Hz frame-to-frame motion one is usually enough, keep 2 for
        relocalization-sized jumps).
      dist_gate: reject pairs further than this along the normal (m).
      normal_gate: reject pairs whose live/model normals disagree beyond
        ``acos`` of this dot product (live normals from the depth grid).
      stride: tracking resolution (2 = quarter of the pixels; KinFu
        tracks on a pyramid — one strided level is the flat equivalent).
      prior_window: OPT-IN fast path — march the model raycast only
        ±this band (meters) around each pixel's live depth (see
        raycast's prior_depth). The march is the dominant tracking cost
        (~10× at default settings), and in the tracking regime the live
        frame bounds the model surface — but the band must exceed the
        largest expected model↔live displacement (0.3 m covers several
        degrees of pose error at room scale), and frames whose live
        depth is largely invalid lose their model view with it. The
        default None marches the full [t_min, t_max] range — always
        safe. Callers in a streaming loop (small inter-frame motion,
        mostly-valid depth) should pass 0.3.

    Returns TrackResult(T, rms, n_matched).
    """
    T = jnp.asarray(T_init, jnp.float32)
    res = None
    for _ in range(max(1, int(rounds))):
        model = raycast(vol, intr, T, t_min=t_min, t_max=t_max,
                        stride=stride,
                        prior_depth=None if prior_window is None else depth,
                        prior_window=prior_window or 0.0,
                        depth_scale=depth_scale)
        res = _track_jit(vol, depth, intr, T, model,
                         jnp.float32(depth_scale),
                         jnp.float32(dist_gate), jnp.float32(normal_gate),
                         iterations=int(iterations), stride=int(stride))
        T = res.T
    return res


@partial(jax.jit, static_argnames=("iterations", "stride"))
def _track_jit(vol: TSDFVolume, depth, intr, T_init, model: RaycastResult,
               depth_scale, dist_gate, normal_gate,
               iterations: int, stride: int) -> TrackResult:
    h, w = model.depth.shape
    intr_s = _strided_intr(intr, stride, h, w)
    d_live = depth[::stride, ::stride][:h, :w]
    live = deproject(d_live, intr_s, depth_scale=depth_scale)  # cam frame
    p_live = live.xyz                                          # [h*w, 3]
    live_ok = live.mask & (p_live[:, 2] > 1e-6)

    # live normals from the organized grid (cross of image-axis tangents)
    pg = p_live.reshape(h, w, 3)
    du = jnp.diff(pg, axis=1, append=pg[:, -1:, :])
    dv = jnp.diff(pg, axis=0, append=pg[-1:, :, :])
    n_live = jnp.cross(du, dv).reshape(-1, 3)
    n_norm = jnp.linalg.norm(n_live, axis=-1, keepdims=True)
    n_live = n_live / jnp.maximum(n_norm, 1e-12)
    # orient toward the camera (origin in the camera frame) — the model's
    # ray-cast normals face the viewer, so the agreement gate needs live
    # normals on the same hemisphere
    n_live = jnp.where(jnp.sum(n_live * p_live, -1, keepdims=True) > 0,
                       -n_live, n_live)
    n_ok = n_norm[:, 0] > 1e-12

    # SoA planes for the hot per-iteration math (no minor dimension of
    # 3); the model's validity is folded into its vertex-x plane as NaN so the
    # gather count per iteration drops from 7 to 6
    vmx = jnp.where(model.valid, model.vertex[..., 0],
                    jnp.nan).reshape(-1)
    vmy, vmz = (model.vertex[..., 1].reshape(-1),
                model.vertex[..., 2].reshape(-1))
    nmx, nmy, nmz = (model.normal[..., 0].reshape(-1),
                     model.normal[..., 1].reshape(-1),
                     model.normal[..., 2].reshape(-1))
    plx, ply, plz = p_live[:, 0], p_live[:, 1], p_live[:, 2]
    nlx, nly, nlz = n_live[:, 0], n_live[:, 1], n_live[:, 2]
    inv_init = se3_inverse(T_init)

    def gn_step(T, _):
        pwx = T[0, 0] * plx + T[0, 1] * ply + T[0, 2] * plz + T[0, 3]
        pwy = T[1, 0] * plx + T[1, 1] * ply + T[1, 2] * plz + T[1, 3]
        pwz = T[2, 0] * plx + T[2, 1] * ply + T[2, 2] * plz + T[2, 3]
        nwx = T[0, 0] * nlx + T[0, 1] * nly + T[0, 2] * nlz
        nwy = T[1, 0] * nlx + T[1, 1] * nly + T[1, 2] * nlz
        nwz = T[2, 0] * nlx + T[2, 1] * nly + T[2, 2] * nlz
        # project into the model view, gather its vertex+normal there
        qx = inv_init[0, 0] * pwx + inv_init[0, 1] * pwy \
            + inv_init[0, 2] * pwz + inv_init[0, 3]
        qy = inv_init[1, 0] * pwx + inv_init[1, 1] * pwy \
            + inv_init[1, 2] * pwz + inv_init[1, 3]
        qz = inv_init[2, 0] * pwx + inv_init[2, 1] * pwy \
            + inv_init[2, 2] * pwz + inv_init[2, 3]
        u, v, in_front = _project_soa(qx, qy, qz, intr_s)
        ui = jnp.round(u).astype(jnp.int32)
        vi = jnp.round(v).astype(jnp.int32)
        pix_ok = in_front & (ui >= 0) & (ui < w) & (vi >= 0) & (vi < h)
        flat = jnp.clip(vi, 0, h - 1) * w + jnp.clip(ui, 0, w - 1)
        gvmx, gvmy, gvmz = vmx[flat], vmy[flat], vmz[flat]
        gnmx, gnmy, gnmz = nmx[flat], nmy[flat], nmz[flat]
        r = gnmx * (pwx - gvmx) + gnmy * (pwy - gvmy) \
            + gnmz * (pwz - gvmz)          # NaN where the model is invalid
        ok = (live_ok & n_ok & pix_ok
              & (nwx * gnmx + nwy * gnmy + nwz * gnmz > normal_gate)
              & (jnp.abs(r) < dist_gate))  # NaN r compares False
        wgt = ok.astype(jnp.float32)
        r = jnp.where(ok, r, 0.0)
        # J = [p_w x n_m, n_m] as six planes; A = Jt W J via one [6,N]
        # HIGHEST matmul
        Jt = jnp.stack([pwy * gnmz - pwz * gnmy,
                        pwz * gnmx - pwx * gnmz,
                        pwx * gnmy - pwy * gnmx,
                        gnmx, gnmy, gnmz], axis=0)             # [6, N]
        Jt = jnp.where(ok[None, :], Jt, 0.0)
        A = mm(Jt * wgt[None, :], Jt.T)                        # [6, 6]
        b = -mm(Jt, (wgt * r)[:, None])[:, 0]
        n_in = jnp.sum(wgt)
        # Degenerate-direction handling: a geometrically thin scene (one
        # plane, or plane+sphere — which has an exact rotational symmetry)
        # leaves some twist directions unconstrained. Plain damped solves
        # still random-walk along that null space (residual noise divided
        # by the tiny damped eigenvalue), which measured as 33° of drift
        # over 4 re-cast rounds while RMS sat at 0.3 mm. Solve in the
        # eigenbasis and zero the step along any direction whose
        # eigenvalue is below 1e-5 of the largest — the pose then *stays
        # at the prior* in directions the scene cannot observe.
        evals, evecs = jnp.linalg.eigh(A)
        lam_max = jnp.maximum(evals[-1], 1e-12)
        keep = evals > 1e-5 * lam_max
        # eigenbasis products at HIGHEST precision: default precision may
        # run in TF32 or bf16 (~1e-3 relative) and biases the final
        # iteration's step (the repo-wide mm() invariant, ops/se3.py)
        coef = jnp.where(keep,
                         mm(evecs.T, b[:, None])[:, 0]
                         / jnp.maximum(evals, 1e-12), 0.0)
        xi = mm(evecs, coef[:, None])[:, 0]
        dT = se3_from_rt(so3_exp(xi[:3]), xi[3:])
        T_new = se3_compose(dT, T)
        rms = jnp.sqrt(jnp.sum(wgt * r * r) / jnp.maximum(n_in, 1.0))
        return T_new, (rms, n_in)

    T_fin, (rmss, nins) = jax.lax.scan(gn_step, T_init,
                                       jnp.arange(iterations))
    return TrackResult(T=T_fin, rms=rmss[-1],
                       n_matched=nins[-1].astype(jnp.int32))


class RigTrackResult(NamedTuple):
    extrinsics: jax.Array   # [ncam, 4, 4] corrected rig (== input if gated)
    G: jax.Array            # [4, 4] world-frame correction (I if gated)
    applied: bool           # the correction passed every gate
    track: TrackResult      # the anchor camera's raw frame-to-model result


def rig_track(vol: TSDFVolume, depth: jax.Array, intr: Intrinsics,
              extrinsics: jax.Array, cam: int = 0,
              depth_scale: float = 0.001,
              prior_window: Optional[float] = 0.3,
              min_matched: int = 300, max_rms: float = 0.05,
              max_step: float = 0.5, max_step_rot: float = 0.5,
              **track_kw) -> RigTrackResult:
    """Use the persistent volume as an *online extrinsics source* for a rig.

    The streaming stitcher's ring ICP measures only relative inter-camera
    alignment (camera 0 anchors the chain — models/stitcher.py), so a
    global rig drift (the mount slips, the whole rig is carried) is
    invisible to it: every pairwise residual stays zero while the world
    poses walk away together. Frame-to-model tracking against the scene
    the volume has already fused is the complementary observation — the
    KinectFusion loop (the reference has no online correction at all;
    its .cal extrinsics are frozen — SURVEY.md §2.2 ICP row).

    Tracks camera ``cam`` against the volume with :func:`track`, lifts the
    single-camera correction to the whole rig under the rigid-rig
    assumption (every camera is bolted to the same mount, so one
    world-frame left-correction ``G = T_tracked @ T_est^-1`` moves them
    all), and gates it: a correction from too few matched pixels, a
    poor point-to-plane fit, or an implausibly large single-keyframe
    step (``max_step`` meters / ``max_step_rot`` radians — real drift is
    slow; a big "correction" means tracking latched onto the wrong
    geometry) leaves the rig untouched rather than corrupting every
    camera at once — same defensive posture as the stitcher's
    ring-closure gate.

    Args:
      vol: the fused volume (must carry evidence — track a volume with
        ``weight.sum() == 0`` and the gates reject the result).
      depth: [ncam, H, W] (or [H, W]) raw u16 / float-meter depth — the
        exact frame the stitch saw (StitchOutput.depth).
      intr: per-camera Intrinsics (batched to match, or single).
      extrinsics: [ncam, 4, 4] (or [4, 4]) current camera→world estimates.
      cam: which camera anchors the track (default 0 — the ring anchor,
        so the corrected rig stays consistent with the chain).
      prior_window: passed to :func:`track` (0.3 m — the streaming
        regime's fast path; None marches the full ray range).
      min_matched / max_rms / max_step / max_step_rot: the gates.
      **track_kw: forwarded to :func:`track` (iterations, rounds, stride,
        t_min/t_max, ...).

    Returns RigTrackResult. ``applied`` is a host bool (this runs at
    keyframe cadence on the host side of the streaming loop; the sync it
    costs is one scalar, amortised over the keyframe interval).
    """
    ext = jnp.asarray(extrinsics, jnp.float32)
    squeeze = ext.ndim == 2
    if squeeze:
        ext = ext[None]
    d = depth if depth.ndim == 3 else depth[None]
    intr_b = intr if jnp.asarray(intr.fx).ndim else \
        jax.tree_util.tree_map(lambda a: jnp.asarray(a)[None], intr)
    T_est = ext[cam]
    res = track(vol, d[cam], _cam_slice(intr_b, cam), T_est,
                depth_scale=depth_scale, prior_window=prior_window,
                **track_kw)
    G = mm(res.T, se3_inverse(T_est))
    # gate arms (host scalars): fit quality, support, step plausibility
    dt = float(jnp.linalg.norm(G[:3, 3]))
    cos_th = (float(jnp.trace(G[:3, :3])) - 1.0) * 0.5
    ang = math.acos(min(1.0, max(-1.0, cos_th)))
    ok = (int(res.n_matched) >= int(min_matched)
          and float(res.rms) <= float(max_rms)
          and math.isfinite(dt) and dt <= float(max_step)
          and ang <= float(max_step_rot))
    if ok:
        out = mm(G[None], ext)
    else:
        out, G = ext, jnp.eye(4, dtype=jnp.float32)
    return RigTrackResult(extrinsics=out[0] if squeeze else out,
                          G=G, applied=ok, track=res)


# --------------------------------------------------------------------------
# extraction / persistence
# --------------------------------------------------------------------------

def extract_cloud(vol: TSDFVolume, capacity: int,
                  band: float = 0.5, min_weight: float = 1.0
                  ) -> PointCloud:
    """Near-surface voxels as a PointCloud (for feeding existing NN/ICP/
    analysis machinery). ``band`` is the |tsdf| threshold in truncation
    units (0.5 = within half the band of the surface)."""
    return _extract_cloud_jit(vol, jnp.float32(band),
                              jnp.float32(min_weight), capacity=capacity)


@partial(jax.jit, static_argnames=("capacity",))
def _extract_cloud_jit(vol: TSDFVolume, band, min_weight,
                       capacity: int) -> PointCloud:
    near = ((jnp.abs(vol.tsdf) <= band)
            & (vol.weight >= min_weight)).reshape(-1)
    (sel,) = jnp.nonzero(near, size=capacity, fill_value=0)
    n = jnp.sum(near.astype(jnp.int32))
    ok = jnp.arange(capacity) < n
    p = _voxel_centers(vol.shape, vol.origin, vol.leaf)[sel]
    rgb = None
    if vol.rgb is not None:
        rgb = jnp.where(ok[:, None], vol.rgb.reshape(-1, 3)[sel], 0.0)
    return PointCloud(xyz=jnp.where(ok[:, None], p, 0.0), mask=ok, rgb=rgb)


def extract_mesh(vol: TSDFVolume, cell_capacity: int,
                 min_weight: float = 1.0):
    """Marching-tetrahedra mesh of the TSDF zero level.

    Reuses ops/surface.py's crack-free Kuhn-split extractor with the
    negated field (its convention is inside = field > iso; TSDF inside is
    tsdf < 0) and unobserved nodes masked so occlusion boundaries don't
    grow walls. Returns ``(verts, valid, n_active)`` as
    ``marching_tetrahedra`` does (verts in its [3, 3, T] coordinate-major
    layout — convert with ``ops.surface.soup_triangles`` or weld with
    ``ops.surface.weld_mesh``, which accepts it directly).
    """
    from ..ops.surface import marching_tetrahedra
    field = -vol.tsdf
    node_valid = vol.weight >= jnp.float32(min_weight)
    return marching_tetrahedra(field, 0.0, cell_capacity,
                               origin=vol.origin, leaf=vol.leaf,
                               node_valid=node_valid)


def save_volume(path: str, vol: TSDFVolume) -> None:
    """Persist the volume (resumable checkpoint, ``.npz``)."""
    arrs = dict(tsdf=np.asarray(vol.tsdf), weight=np.asarray(vol.weight),
                origin=np.asarray(vol.origin), leaf=np.asarray(vol.leaf),
                trunc=np.asarray(vol.trunc), version=np.int32(1))
    if vol.rgb is not None:
        arrs["rgb"] = np.asarray(vol.rgb)
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(path, **arrs)


def load_volume(path: str) -> TSDFVolume:
    """Load a ``save_volume`` checkpoint."""
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        if int(z["version"]) != 1:
            raise ValueError(
                f"unknown tsdf checkpoint version {z['version']}")
        rgb = jnp.asarray(z["rgb"], jnp.float32) if "rgb" in z else None
        return TSDFVolume(
            tsdf=jnp.asarray(z["tsdf"], jnp.float32),
            weight=jnp.asarray(z["weight"], jnp.float32),
            origin=jnp.asarray(z["origin"], jnp.float32),
            leaf=jnp.asarray(z["leaf"], jnp.float32),
            trunc=jnp.asarray(z["trunc"], jnp.float32),
            rgb=rgb)
