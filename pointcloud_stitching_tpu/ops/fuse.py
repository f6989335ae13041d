"""Multi-cloud fusion (concatenation) on padded buffers.

On-device equivalent of ``pcl::PointCloud::operator+=`` concatenation in the
reference's render loop (src/pcs-multicamera-client.cpp; SURVEY.md §3.2).
With fixed-capacity padded clouds, fusion is a reshape/concat — the masks do
the bookkeeping, so a dropped camera (all-False mask) costs nothing
(SURVEY.md §5: failure handling via batch masks).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.types import PointCloud


def fuse(clouds: list[PointCloud]) -> PointCloud:
    """Concatenate clouds along the point axis."""
    xyz = jnp.concatenate([c.xyz for c in clouds], axis=-2)
    mask = jnp.concatenate([c.mask for c in clouds], axis=-1)
    rgbs = [c.rgb for c in clouds]
    rgb = None
    if all(r is not None for r in rgbs):
        rgb = jnp.concatenate(rgbs, axis=-2)
    return PointCloud(xyz=xyz, mask=mask, rgb=rgb)


def fuse_batched(pc: PointCloud) -> PointCloud:
    """Flatten a camera-batched cloud [..., ncam, N, 3] → [..., ncam*N, 3]."""
    *lead, ncam, n, _ = pc.xyz.shape
    xyz = pc.xyz.reshape(*lead, ncam * n, 3)
    mask = pc.mask.reshape(*lead, ncam * n)
    rgb = pc.rgb.reshape(*lead, ncam * n, 3) if pc.rgb is not None else None
    return PointCloud(xyz=xyz, mask=mask, rgb=rgb)


def compact(pc: PointCloud) -> PointCloud:
    """Sort valid points to the front (stable). Shape-preserving.

    Useful before slicing a fused cloud down to a smaller capacity, and for
    host-side export where the valid prefix is what gets written.
    """
    key = jnp.where(pc.mask, 0, 1).astype(jnp.int32)
    operands = [key, pc.xyz[..., 0], pc.xyz[..., 1], pc.xyz[..., 2],
                pc.mask.astype(jnp.int32)]
    if pc.rgb is not None:
        operands += [pc.rgb[..., 0], pc.rgb[..., 1], pc.rgb[..., 2]]
    s = jax.lax.sort(operands, num_keys=1, is_stable=True)
    xyz = jnp.stack(s[1:4], axis=-1)
    mask = s[4].astype(bool)
    rgb = jnp.stack(s[5:8], axis=-1) if pc.rgb is not None else None
    return PointCloud(xyz=xyz, mask=mask, rgb=rgb)
