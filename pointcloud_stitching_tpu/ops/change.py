"""Spatial change detection: which query points occupy voxels the
reference never touched.

On-device role of ``pcl::OctreePointCloudChangeDetector`` (the
double-buffered octree whose ``getPointIndicesFromNewVoxels`` reports
points of cloud B falling in voxels absent from cloud A). The reference
system has no change detection (it re-fuses every frame from scratch;
reference: src/pcs-multicamera-client.cpp main loop, SURVEY.md §1 L3) —
PCL ships it and a rig watching a scene wants exactly this primitive:
"what appeared since the baseline?".

Design — no octree, no hash map. Both clouds are hashed onto one shared
**absolute** voxel grid (``floor(p/leaf) + bias``, the voxel-map grid, so
the diff never shifts with either cloud's bounding box), and the diff is
one fused sort-and-scan, the same machinery as the voxel downsample:

    sort [ref rows ++ query rows] by voxel key
    -> segment boundaries where the key changes
    -> per-segment "contains a ref point" via segment_max of a flag
    -> scatter back to the query's slots

Everything is fixed-shape (padded buffers + masks), the leaf is traced,
and the cost is one 4-operand sort of cap_ref + cap_query rows — the
sorted diff replaces pointer-chasing tree traversal with the accelerator's fast
primitive, exactly as voxel_downsample replaces the voxel hash map.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.types import PointCloud
from .voxel import _SENTINEL

# the voxel-map bias/bounds: imported from the authoritative definition
# (models/voxel_map.py — an absolute grid covering ±163 m in x and
# ±327 m in y/z at a 1 cm leaf) so detect_changes_map's query keys can
# never drift from the map's own grid. Lazy import (inside the deferred
# function body below would also work, but these are plain numpy and the
# module keeps voxel_map's no-jnp-at-import rule, so a top import is
# safe — voxel_map.py itself imports no jnp at module level).
from ..models.voxel_map import _BIAS, _BOUND  # noqa: E402


def _abs_keys(xyz: jax.Array, mask: jax.Array, leaf) -> tuple[jax.Array,
                                                              jax.Array]:
    """(k1, kz) lexicographic keys on the absolute biased grid; sentinel
    for masked or out-of-range rows. Multiplies by the reciprocal like
    PCL (tests/oracle.py contract)."""
    inv = 1.0 / jnp.asarray(leaf, jnp.float32)
    ijk = jnp.floor(xyz * inv).astype(jnp.int32) + _BIAS
    ok = mask & jnp.all((ijk >= 0) & (ijk <= _BOUND), axis=-1)
    k1 = jnp.where(ok, ijk[..., 0] * 65536 + ijk[..., 1], _SENTINEL)
    kz = jnp.where(ok, ijk[..., 2], _SENTINEL)
    return k1, kz


@jax.jit
def detect_changes(ref: PointCloud, query: PointCloud, leaf) -> jax.Array:
    """Mask of query points in voxels no valid ref point occupies.

    Args:
      ref: the baseline cloud (capacities may differ from the query's).
      query: the new observation.
      leaf: traced voxel edge (meters) — the change-detection resolution.

    Returns [Nq] bool: True where ``query.mask`` is set AND the point's
    voxel contains no reference point. Points outside the ±163/±327 m
    absolute grid are never reported (same envelope as the voxel map).
    """
    rk1, rkz = _abs_keys(ref.xyz, ref.mask, leaf)
    return _diff_mask(rk1, rkz, query, leaf)


@jax.jit
def detect_changes_map(vmap, query: PointCloud, min_weight=0.0) -> jax.Array:
    """``detect_changes`` against a ``models.voxel_map.VoxelMap``.

    The map's occupied voxels (with at least ``min_weight`` evidence) are
    the baseline; the map's own leaf is the resolution. This is the
    streaming form: accumulate the scene with the temporal map, then ask
    each new frame what it added — without ever materialising a baseline
    cloud.
    """
    occ = ((vmap.ijk[:, 0] != _SENTINEL)
           & (vmap.weight >= jnp.asarray(min_weight, jnp.float32)))
    rk1 = jnp.where(occ, vmap.ijk[:, 0] * 65536 + vmap.ijk[:, 1], _SENTINEL)
    rkz = jnp.where(occ, vmap.ijk[:, 2], _SENTINEL)
    return _diff_mask(rk1, rkz, query, vmap.leaf)


def _diff_mask(rk1, rkz, query: PointCloud, leaf) -> jax.Array:
    qk1, qkz = _abs_keys(query.xyz, query.mask, leaf)
    nq = qk1.shape[0]
    n = rk1.shape[0] + nq

    k1 = jnp.concatenate([rk1, qk1])
    kz = jnp.concatenate([rkz, qkz])
    is_ref = jnp.concatenate([jnp.ones_like(rk1), jnp.zeros_like(qk1)])
    # query rows carry their slot id; ref and invalid rows go to a drop slot
    slot = jnp.concatenate([jnp.full_like(rk1, nq),
                            jnp.arange(nq, dtype=jnp.int32)])
    slot = jnp.where(k1 == _SENTINEL, nq, slot)

    sk1, skz, sref, sslot = jax.lax.sort(
        (k1, kz, is_ref, slot), num_keys=2, is_stable=False)

    def prev(x):
        return jnp.concatenate([x[:1] - 1, x[:-1]])

    new_seg = (sk1 != prev(sk1)) | (skz != prev(skz))
    seg = jnp.cumsum(new_seg.astype(jnp.int32)) - 1
    has_ref = jax.ops.segment_max(sref, seg, num_segments=n,
                                  indices_are_sorted=True)
    changed = (has_ref[seg] == 0) & (sk1 != _SENTINEL)

    out = jnp.zeros((nq + 1,), jnp.int32)
    out = out.at[sslot].max(changed.astype(jnp.int32))
    return out[:nq].astype(jnp.bool_)
