"""Triangle meshing of organized clouds.

On-device role of ``pcl::OrganizedFastMesh``: depth frames are organized
grids, so surface triangulation needs no Delaunay/greedy search at all —
every 2x2 pixel quad contributes (up to) two triangles, and the whole
mesh is one elementwise validity computation over the grid:

    v ── v+1        triangle A: (v, v+w, v+1)
    │  ╱  │         triangle B: (v+1, v+w, v+w+1)
    v+w ─ v+w+1     (counter-clockwise seen from the sensor at -z)

A triangle survives when its three vertices are valid and no edge exceeds
``max_edge`` (the depth-discontinuity cut — PCL's MAX_EDGE_LENGTH
shadow-triangle suppression). Output is fixed shape: 2*(H-1)*(W-1)
triangle slots + a validity mask, so one compiled program serves every
frame; ``io.plyio.save_mesh`` writes the valid subset as a standard PLY
face list viewable anywhere.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=())
def organized_mesh(xyz_grid: jax.Array, mask_grid: jax.Array,
                   max_edge=0.05):
    """Mesh an organized cloud. Returns (triangles [M, 3] int32 indices
    into the flattened [H*W] grid, valid [M] bool), M = 2(H-1)(W-1).

    Args:
      xyz_grid: [H, W, 3] sensor- or world-frame points.
      mask_grid: [H, W] validity.
      max_edge: maximum triangle edge length in meters (traced) — longer
        edges span depth discontinuities and are cut.
    """
    h, w = mask_grid.shape
    idx = jnp.arange(h * w, dtype=jnp.int32).reshape(h, w)
    v00 = idx[:-1, :-1].reshape(-1)
    v01 = idx[:-1, 1:].reshape(-1)
    v10 = idx[1:, :-1].reshape(-1)
    v11 = idx[1:, 1:].reshape(-1)
    tri = jnp.concatenate([
        jnp.stack([v00, v10, v01], axis=-1),     # upper-left triangles
        jnp.stack([v01, v10, v11], axis=-1),     # lower-right triangles
    ])                                           # [M, 3]

    flat = xyz_grid.reshape(-1, 3)
    fmask = mask_grid.reshape(-1)
    p = flat[tri]                                # [M, 3, 3]
    ok = fmask[tri].all(axis=-1)
    e = p - jnp.roll(p, 1, axis=1)               # the three edges
    elen2 = jnp.sum(e * e, axis=-1)              # [M, 3]
    me2 = jnp.square(jnp.asarray(max_edge, jnp.float32))
    ok = ok & jnp.all(elen2 <= me2, axis=-1)
    return tri, ok


def mesh_cloud_arrays(xyz_grid, mask_grid, max_edge=0.05):
    """Host convenience: (vertices [H*W, 3] np, faces [K, 3] np) with
    invalid triangles removed (vertices keep grid order so faces index
    directly; unreferenced vertices are harmless in PLY)."""
    import numpy as np
    tri, ok = organized_mesh(jnp.asarray(xyz_grid), jnp.asarray(mask_grid),
                             max_edge)
    return (np.asarray(xyz_grid).reshape(-1, 3),
            np.asarray(tri)[np.asarray(ok)])
