"""Temporal voxel-map accumulator: a persistent world model on device.

The reference is strictly per-frame — each tick the client fuses the live
clouds, renders, and throws the result away; the only persistent artifact is
a manually saved ``.ply`` snapshot (reference: src/pcs-multicamera-client.cpp
render loop, SURVEY.md §3.2/§5 checkpoint row). This module goes beyond
that: a fixed-capacity voxel map that *accumulates* stitched frames over
time, so the rig builds a denoised, ever-completing scene model instead of a
30 Hz instantaneous view, and a frame (or a camera whose mount slipped) can
be re-localized against the accumulated scene rather than a single noisy
frame.

Design — the map is three dense arrays and its update is one sort + one
segment reduction, the exact machinery the per-frame voxel grid already
uses (ops/voxel.py):

  * state: ``ijk`` [cap, 3] absolute voxel indices (int32, sentinel-marked
    empty slots), ``sums`` [cap, 3] weighted coordinate sums, ``weight``
    [cap], optional ``rgb_sums`` — a struct-of-arrays hash-map replacement.
    Fixed shapes: one compiled update program serves the map's whole life.
  * update: decay existing weights (exponential forgetting), concatenate the
    map rows with the incoming cloud's rows as (key, weighted-sum) records,
    ``lax.sort`` by voxel key, segment-sum into the new map. Same-voxel
    records land adjacent and merge exactly; out-of-capacity voxels fall
    into the discard bucket (ascending key order, like the per-frame grid).
  * keys are *absolute* (fixed world-origin bias), unlike the per-frame
    grid's frame-relative extents — successive frames must agree on voxel
    identity. At the default bias that bounds the mapped scene to
    ±16384·leaf in x and ±32768·leaf in y/z (±163 m / ±327 m at 1 cm
    leaves — the same int32-key practical-limit class as PCL's VoxelGrid);
    out-of-bounds points are dropped, not clamped.

The weight is a per-voxel evidence counter: each observation adds 1, decay
multiplies by ``decay`` each update, so steady state is 1/(1-decay) for a
continuously seen voxel and stale geometry fades toward the ``min_weight``
eviction threshold (a moving person leaves no permanent ghost). Centroids
are weight-averaged, so a voxel seen 100 times carries sqrt(100)x less
sensor noise than any single frame — the accumulated map is *smoother* than
what the reference renders.
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.icp import ICPResult, icp
from ..ops.voxel import _SENTINEL, _reduce_xla
from ..utils.types import PointCloud, pytree_dataclass

# per-axis index bias / bound: x packs into the upper half of the 31-bit
# lexicographic key (15 bits), y/z get 16 bits — matching the per-frame
# grid's packing in ops/voxel.py _sorted_segments. Plain numpy: no jax
# array work at import time (it would initialise the backend and break
# late jax.distributed.initialize in multihost children)
_BIAS = np.array([16384, 32768, 32768], np.int32)
_BOUND = np.array([32766, 65534, 65534], np.int32)


@pytree_dataclass
class VoxelMap:
    """Fixed-capacity persistent voxel map (see module docstring).

    ``leaf`` rides in the state so a map can never be updated under a
    different grid than it was built with. All fields are traced arrays;
    ``capacity`` is the (static) leading dimension.
    """

    ijk: jax.Array                      # [cap, 3] int32, _SENTINEL = empty
    sums: jax.Array                     # [cap, 3] f32 weighted xyz sums
    weight: jax.Array                   # [cap] f32 evidence weight
    leaf: jax.Array                     # scalar f32 voxel edge (meters)
    rgb_sums: Optional[jax.Array] = None  # [cap, 3] f32 weighted color sums

    @property
    def capacity(self) -> int:
        return self.ijk.shape[0]

    def count(self) -> jax.Array:
        """Occupied-voxel count."""
        return jnp.sum((self.ijk[:, 0] != _SENTINEL).astype(jnp.int32))

    @classmethod
    def create(cls, capacity: int, leaf: float, with_rgb: bool = False
               ) -> "VoxelMap":
        """An empty map. ``capacity`` bounds the occupied-voxel count; size
        it to the scene (a 10 m room at 1 cm leaves holds ~1-2M surface
        voxels; decay + min_weight reclaim slots from stale geometry)."""
        return cls(
            ijk=jnp.full((capacity, 3), _SENTINEL, jnp.int32),
            sums=jnp.zeros((capacity, 3), jnp.float32),
            weight=jnp.zeros((capacity,), jnp.float32),
            leaf=jnp.asarray(leaf, jnp.float32),
            rgb_sums=jnp.zeros((capacity, 3), jnp.float32) if with_rgb
            else None,
        )

    def as_cloud(self, min_weight: float | jax.Array = 0.0) -> PointCloud:
        """View the map as a PointCloud (weight-averaged centroids).

        min_weight masks low-evidence voxels (e.g. a single glimpse of a
        passer-by) without evicting them from the map.
        """
        occ = (self.ijk[:, 0] != _SENTINEL) & (self.weight > 0.0)
        keep = occ & (self.weight >= jnp.asarray(min_weight, jnp.float32))
        denom = jnp.maximum(self.weight, 1e-12)[:, None]
        xyz = jnp.where(keep[:, None], self.sums / denom, 0.0)
        rgb = None
        if self.rgb_sums is not None:
            rgb = jnp.where(keep[:, None], self.rgb_sums / denom, 0.0)
        return PointCloud(xyz=xyz, mask=keep, rgb=rgb)


def _keys_from_ijk(ijk: jax.Array) -> tuple[jax.Array, jax.Array]:
    """(k1, kz) lexicographic sort keys from biased per-axis indices."""
    invalid = ijk[:, 0] == _SENTINEL
    k1 = jnp.where(invalid, _SENTINEL, ijk[:, 0] * 65536 + ijk[:, 1])
    kz = jnp.where(invalid, _SENTINEL, ijk[:, 2])
    return k1, kz


def voxel_map_update(vmap: VoxelMap, cloud: PointCloud,
                     decay: float | jax.Array = 1.0,
                     min_weight: float | jax.Array = 0.05,
                     max_weight: float | jax.Array = jnp.inf
                     ) -> VoxelMap:
    """Merge one world-frame cloud into the map (pure; state is donated).

    Args:
      vmap: current map state (donated — update in place on device).
      cloud: world-frame points to absorb ([N, 3] xyz + mask, optional rgb
        iff the map was created ``with_rgb``). Typically a
        ``StitchOutput.cloud`` — already voxel-downsampled, but any cloud
        works (the sort merges duplicates regardless).
      decay: per-update multiplicative weight decay (1.0 = never forget;
        0.98 at 30 Hz forgets with a ~1.7 s time constant). Sums decay with
        weights, so centroids stay weight-averaged.
      min_weight: decayed slots below this evict (slot reclaimed). With
        decay < 1 this bounds how long vanished geometry ghosts persist:
        ~log(min_weight)/log(decay) updates.
      max_weight: cap on accumulated evidence (sums rescale to preserve the
        mean). Bounds how slowly a long-observed voxel adapts when the
        scene actually changes; inf = pure accumulation.

    Returns the new map. Occupied voxels beyond capacity drop in ascending
    key order (same discard-bucket policy as the per-frame grid); size
    capacity generously and let decay reclaim slots.
    """
    if (cloud.rgb is not None) != (vmap.rgb_sums is not None):
        raise ValueError("cloud rgb presence must match map rgb presence")
    # normalise every scalar to a canonical f32 array and route through ONE
    # call structure: jax.jit keys its cache on the positional/keyword
    # shape of the call AND on weak-type/int-vs-float scalar signatures, so
    # without this a user alternating `decay=0.5` with positional 0.99
    # would recompile the whole update program for the same computation
    return _update_jit(vmap, cloud, jnp.asarray(decay, jnp.float32),
                       jnp.asarray(min_weight, jnp.float32),
                       jnp.asarray(max_weight, jnp.float32))


@partial(jax.jit, donate_argnames=("vmap",))
def _update_jit(vmap: VoxelMap, cloud: PointCloud, decay: jax.Array,
                min_weight: jax.Array, max_weight: jax.Array) -> VoxelMap:
    cap = vmap.capacity
    has_rgb = vmap.rgb_sums is not None
    min_w = min_weight

    # -- decay + evict existing rows
    w = vmap.weight * decay
    live = (vmap.ijk[:, 0] != _SENTINEL) & (w >= min_w)
    map_ijk = jnp.where(live[:, None], vmap.ijk, _SENTINEL)
    map_sums = jnp.where(live[:, None], vmap.sums * decay, 0.0)
    map_w = jnp.where(live, w, 0.0)

    # -- incoming points -> absolute biased voxel indices, unit weight
    inv = 1.0 / vmap.leaf
    pij = jnp.floor(cloud.xyz * inv).astype(jnp.int32) + _BIAS
    in_bounds = jnp.all((pij >= 0) & (pij <= _BOUND), axis=-1)
    ok = cloud.mask & in_bounds
    new_ijk = jnp.where(ok[:, None], pij, _SENTINEL)
    new_sums = jnp.where(ok[:, None], cloud.xyz, 0.0)
    new_w = ok.astype(jnp.float32)

    # -- merge: sort (map rows ++ new rows) by voxel key, segment-sum.
    # Sum channels ride the sort as f32 operands (they are arbitrary
    # weighted sums — nothing to pack), keys as two int32 operands.
    all_ijk = jnp.concatenate([map_ijk, new_ijk], axis=0)
    k1, kz = _keys_from_ijk(all_ijk)
    chans = [jnp.concatenate([map_sums, new_sums], axis=0),
             jnp.concatenate([map_w, new_w], axis=0)[:, None]]
    if has_rgb:
        rgbw = cloud.rgb * new_w[:, None]
        chans.append(jnp.concatenate([vmap.rgb_sums * live[:, None] * decay,
                                      rgbw], axis=0))
    vals_in = jnp.concatenate(chans, axis=-1)       # [cap+N, 4(+3)]
    ops = [k1, kz] + [vals_in[:, i] for i in range(vals_in.shape[-1])]
    # unstable sort: same-voxel rows merge by summation, order-independent
    # up to f32 rounding (same class as the per-frame grid's choice)
    sorted_ops = jax.lax.sort(ops, num_keys=2, is_stable=False)
    sk1, skz = sorted_ops[0], sorted_ops[1]
    svals = jnp.stack(sorted_ops[2:], axis=-1)

    valid = sk1 != _SENTINEL
    prev = lambda a: jnp.concatenate([jnp.full_like(a[:1], -1), a[:-1]])
    flags = ((sk1 != prev(sk1)) | (skz != prev(skz))) & valid
    f = flags.astype(jnp.float32)
    # recover per-axis indices on each segment's first row only (flag-
    # masked: exactly one contribution survives the segment sum). The
    # biased indices are <= 65534, exact in f32.
    iy = jnp.where(valid, sk1, 0) % 65536
    ix = jnp.where(valid, sk1, 0) // 65536
    iz = jnp.where(valid, skz, 0)
    idx_ch = jnp.stack([ix, iy, iz], axis=-1).astype(jnp.float32) * f[:, None]
    vals = jnp.concatenate([idx_ch, jnp.where(valid[:, None], svals, 0.0)],
                           axis=-1)                 # [cap+N, 7(+3)]

    sums = _reduce_xla(flags, vals, cap)

    # -- finalize new state
    out_w = sums[:, 6]
    occ = out_w > 0.0
    out_ijk = jnp.where(occ[:, None],
                        jnp.round(sums[:, :3]).astype(jnp.int32), _SENTINEL)
    scale = jnp.where(out_w > max_weight,
                      jnp.asarray(max_weight, jnp.float32)
                      / jnp.maximum(out_w, 1e-12), 1.0)
    new_rgb = None
    if has_rgb:
        new_rgb = sums[:, 7:10] * scale[:, None]
    return VoxelMap(ijk=out_ijk, sums=sums[:, 3:6] * scale[:, None],
                    weight=out_w * scale, leaf=vmap.leaf, rgb_sums=new_rgb)


def save_map(path: str, vmap: VoxelMap) -> None:
    """Persist the full map state (resumable checkpoint, ``.npz``).

    Unlike the ``.ply`` snapshot (centroids only), this keeps the raw
    accumulation state — voxel indices, weighted sums, evidence weights —
    so a later session can ``load_map`` and keep accumulating exactly where
    this one stopped (the reference's only persistent artifact is a manual
    ``.ply`` snapshot; SURVEY.md §5 checkpoint row).
    """
    arrs = dict(ijk=np.asarray(vmap.ijk), sums=np.asarray(vmap.sums),
                weight=np.asarray(vmap.weight),
                leaf=np.asarray(vmap.leaf), version=np.int32(1))
    if vmap.rgb_sums is not None:
        arrs["rgb_sums"] = np.asarray(vmap.rgb_sums)
    # np.savez silently appends .npz to an extensionless path, which would
    # desynchronize save("ckpt") from load("ckpt"); normalize on both sides
    if not path.endswith(".npz"):
        path += ".npz"
    np.savez_compressed(path, **arrs)


def load_map(path: str, capacity: int | None = None) -> VoxelMap:
    """Load a ``save_map`` checkpoint.

    ``capacity`` resizes on load: padding with empty slots when larger than
    the saved map, keeping the highest-weight voxels when smaller (the same
    evidence-ordered policy eviction uses). Default keeps the saved size.
    """
    if not path.endswith(".npz"):
        path += ".npz"
    with np.load(path) as z:
        if int(z["version"]) != 1:
            raise ValueError(f"unknown map checkpoint version {z['version']}")
        ijk = z["ijk"].astype(np.int32)
        sums = z["sums"].astype(np.float32)
        weight = z["weight"].astype(np.float32)
        leaf = float(z["leaf"])
        rgb = z["rgb_sums"].astype(np.float32) if "rgb_sums" in z else None
    cap0 = ijk.shape[0]
    if capacity is not None and capacity != cap0:
        if capacity > cap0:
            pad = capacity - cap0
            ijk = np.concatenate(
                [ijk, np.full((pad, 3), _SENTINEL, np.int32)])
            sums = np.concatenate([sums, np.zeros((pad, 3), np.float32)])
            weight = np.concatenate([weight, np.zeros((pad,), np.float32)])
            if rgb is not None:
                rgb = np.concatenate([rgb, np.zeros((pad, 3), np.float32)])
        else:
            keep = np.argsort(-weight, kind="stable")[:capacity]
            ijk, sums, weight = ijk[keep], sums[keep], weight[keep]
            if rgb is not None:
                rgb = rgb[keep]
    return VoxelMap(ijk=jnp.asarray(ijk), sums=jnp.asarray(sums),
                    weight=jnp.asarray(weight),
                    leaf=jnp.asarray(leaf, jnp.float32),
                    rgb_sums=None if rgb is None else jnp.asarray(rgb))


def localize(vmap: VoxelMap, cloud: PointCloud,
             init_T: jax.Array | None = None, iterations: int = 10,
             max_corr_dist: float | jax.Array = 0.1,
             min_weight: float | jax.Array = 0.0,
             nn_impl: str = "auto") -> ICPResult:
    """Register a cloud against the accumulated map (map-based localization).

    ICP with the map as the (denoised, scene-complete) reference — for
    re-localizing a camera whose mount moved, or an ad-hoc handheld frame,
    against everything the rig has seen rather than one instantaneous
    frame. Returns the cloud→map transform as an ICPResult.
    """
    return icp(cloud, vmap.as_cloud(min_weight), init_T=init_T,
               iterations=iterations, max_corr_dist=max_corr_dist,
               nn_impl=nn_impl)


class TemporalAccumulator:
    """Stateful wrapper: holds the map, jits the update, feeds on stitches.

    Drop-in sink for the streaming runtime::

        acc = TemporalAccumulator(capacity=2**20, leaf=0.01, decay=0.98)
        ...
        def on_frame(out, meta):           # MulticameraClient callback
            acc.update(out.cloud)
        snapshot = acc.cloud()             # denoised accumulated scene
    """

    def __init__(self, capacity: int, leaf: float, decay: float = 1.0,
                 min_weight: float = 0.05, max_weight: float = jnp.inf,
                 with_rgb: bool = False):
        self.state = VoxelMap.create(capacity, leaf, with_rgb=with_rgb)
        self._decay = decay
        self._min_weight = min_weight
        self._max_weight = max_weight

    def update(self, cloud: PointCloud) -> None:
        """Absorb one world-frame cloud (donates the old state buffer)."""
        self.state = voxel_map_update(self.state, cloud, self._decay,
                                      self._min_weight, self._max_weight)

    def cloud(self, min_weight: float | jax.Array = 0.0) -> PointCloud:
        return self.state.as_cloud(min_weight)

    def localize(self, cloud: PointCloud, **kw) -> ICPResult:
        return localize(self.state, cloud, **kw)

    def save(self, path: str) -> None:
        """Checkpoint the accumulation state (resumable; see save_map)."""
        save_map(path, self.state)

    @classmethod
    def load(cls, path: str, capacity: int | None = None,
             decay: float = 1.0, min_weight: float = 0.05,
             max_weight: float = jnp.inf) -> "TemporalAccumulator":
        """Resume from a ``save`` checkpoint. ``leaf``/``with_rgb`` come
        from the file (a map can't change grids mid-life); the update
        policy knobs are per-session and passed fresh."""
        acc = cls.__new__(cls)
        acc.state = load_map(path, capacity=capacity)
        acc._decay = decay
        acc._min_weight = min_weight
        acc._max_weight = max_weight
        return acc
