"""Isosurface reconstruction from a scalar field / the accumulated voxel map.

On-device role of ``pcl::MarchingCubes`` (Hoppe/RBF variants): turn the
persistent scene model into a *surface* — a triangle mesh — instead of a
point set. The reference system never reconstructs surfaces (its viewer
draws raw points; reference: src/pcs-multicamera-client.cpp render loop,
SURVEY.md §1 L4); PCL ships the capability and a rig operator doing scene
capture expects it, so this module provides it on top of
``models/voxel_map.py``: accumulate frames → occupancy field → isosurface.

Design — **marching tetrahedra**, not the classic 256-case cubes table:

  * Each grid cell splits into 6 tetrahedra (the Kuhn/Freudenthal split
    around the main diagonal, which tiles space *consistently* — shared
    cube faces get the same diagonal from both sides, so the mesh is
    crack-free by construction, verified by the watertightness test).
  * A tetrahedron has 16 sign configurations and at most 2 triangles —
    the whole case table is 16×2×3 small integers (vs 256×16), has no
    ambiguous saddle cases (cubes' cases 3/6/7/10/12/13 need disambiguation
    to avoid holes; tets never do), and every step is a tiny gather —
    exactly what the VPU wants. The cost is ~2× more (smaller) triangles,
    which the host-side ``weld_mesh`` dedups anyway.
  * Fixed shapes throughout: cells whose corner values straddle the iso
    level are compacted to a static ``cell_capacity`` with
    ``jnp.nonzero(size=...)`` (surface cells are O(n²) of an n³ grid), and
    every active cell emits a constant 12-triangle block with a validity
    mask — one compiled program per grid size, no recompiles as the scene
    evolves.

Winding is fixed *geometrically* (each triangle is flipped so its normal
points away from the tet's inside-corner centroid, i.e. outward along
-∇field for an occupancy field), which keeps the case table orientation-
free and branchless.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# --- static geometry tables (numpy: no jax work at import time — the
# multihost children initialise jax.distributed after import) ------------

# cube corners in the classic MC order; c0=(0,0,0) .. c6=(1,1,1)
_CORNER = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
                    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int32)

# Kuhn 6-tet decomposition: every tet contains the main diagonal c0-c6,
# volumes are all 1/6 (checked), and the induced face diagonals agree
# between neighbouring cubes (translation-invariant split).
_TETS = np.array([[0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
                  [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int32)

# tet-local edges 0..5 between tet-local vertices 0..3
_EDGE_V = np.array([[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
                   np.int32)

# case -> up to 2 triangles of tet-local edge ids (-1 = unused slot).
# bit i of the case = tet vertex i is inside (value > iso). Winding is
# irrelevant here (fixed geometrically below).
_N = -1
_TRI_TABLE = np.array([
    [[_N, _N, _N], [_N, _N, _N]],   # 0000
    [[0, 1, 2],    [_N, _N, _N]],   # 0001  v0 in: edges 01,02,03
    [[0, 3, 4],    [_N, _N, _N]],   # 0010  v1
    [[1, 3, 4],    [1, 4, 2]],      # 0011  v0,v1: quad 02,12,13,03
    [[1, 3, 5],    [_N, _N, _N]],   # 0100  v2
    [[0, 3, 5],    [0, 5, 2]],      # 0101  v0,v2: quad 01,12,23,03
    [[0, 1, 5],    [0, 5, 4]],      # 0110  v1,v2: quad 01,02,23,13
    [[2, 4, 5],    [_N, _N, _N]],   # 0111  v3 out
    [[2, 4, 5],    [_N, _N, _N]],   # 1000  v3
    [[0, 4, 5],    [0, 5, 1]],      # 1001  v0,v3: quad 01,13,23,02
    [[0, 2, 5],    [0, 5, 3]],      # 1010  v1,v3: quad 01,03,23,12
    [[1, 3, 5],    [_N, _N, _N]],   # 1011  v2 out
    [[1, 2, 4],    [1, 4, 3]],      # 1100  v2,v3: quad 02,03,13,12
    [[0, 3, 4],    [_N, _N, _N]],   # 1101  v1 out
    [[0, 1, 2],    [_N, _N, _N]],   # 1110  v0 out
    [[_N, _N, _N], [_N, _N, _N]],   # 1111
], np.int32)

# triangles emitted per cell: 6 tets x 2 slots
TRIS_PER_CELL = 12


@partial(jax.jit, static_argnames=("cell_capacity", "chunk"))
def marching_tetrahedra(field: jax.Array, iso, cell_capacity: int,
                        origin=None, leaf=1.0, node_valid=None,
                        chunk: int = 4096):
    """Extract the ``field == iso`` surface as a triangle soup.

    Args:
      field: [X, Y, Z] float32 scalar samples at grid nodes; "inside" is
        ``field > iso`` (an occupancy field from ``field_from_map`` uses
        iso≈0.5, a signed distance uses iso=0 with inside positive).
      iso: traced iso level.
      cell_capacity: static bound on *active* cells (cells whose corners
        straddle iso). Active cells are the surface shell — for an n³
        grid budget O(n²·k), and check the returned count for saturation.
      origin: world position of grid node (0,0,0) ([3] f32, default 0).
      leaf: grid node spacing in meters (traced scalar).
      node_valid: optional [X, Y, Z] bool — nodes where the field value
        is meaningful. Cells touching any invalid node are skipped
        entirely (a TSDF volume passes ``weight > 0`` so occlusion
        boundaries — observed surface meeting never-observed space —
        don't grow fake walls).
      chunk: static cells processed per ``lax.map`` step. Bounds the
        padded size of the per-cell geometry temporaries (unchunked
        extraction at 2^19 cells asks for tens of GB).

    Returns ``(verts, valid, n_active)``:
      verts: [3, 3, cell_capacity·12] f32 — ``verts[i, j, t]`` is world
        coordinate j of corner i of triangle t (coordinate-major SoA:
        the triangle axis is minor, so every plane is one long contiguous
        run instead of an AoS [T, 3, 3] layout with tiny minor dims). Host code converts with
        ``soup_triangles(verts, valid)``. Triangles wind so normals
        point outward (away from the inside region).
      valid: [cell_capacity·12] bool — real triangles.
      n_active: scalar int32 — active cells found; if this exceeds
        ``cell_capacity`` the surface is truncated (raise the capacity).
    """
    X, Y, Z = field.shape
    if min(X, Y, Z) < 2:
        raise ValueError("field must be at least 2 nodes per axis")
    iso = jnp.asarray(iso, jnp.float32)
    leaf = jnp.asarray(leaf, jnp.float32)
    origin = (jnp.zeros((3,), jnp.float32) if origin is None
              else jnp.asarray(origin, jnp.float32))
    cx, cy, cz = X - 1, Y - 1, Z - 1

    # -- per-cell corner straddle test: fold max/min over the 8 shifted
    # views rather than stacking them (a 256³ grid stacked 8x is 536 MB)
    cmax = cmin = None
    all_ok = None
    for ox, oy, oz in _CORNER:
        s = field[ox:cx + ox, oy:cy + oy, oz:cz + oz]
        cmax = s if cmax is None else jnp.maximum(cmax, s)
        cmin = s if cmin is None else jnp.minimum(cmin, s)
        if node_valid is not None:
            m = node_valid[ox:cx + ox, oy:cy + oy, oz:cz + oz]
            all_ok = m if all_ok is None else (all_ok & m)
    straddle = (cmax > iso) & (cmin <= iso)
    if all_ok is not None:
        straddle = straddle & all_ok
    active = straddle.reshape(-1)
    n_active = jnp.sum(active.astype(jnp.int32))

    # -- compact active cells to the static capacity (padded to a whole
    # number of chunks; the tail is sliced off the outputs, so behavior
    # at saturation — truncate, report the count — is unchanged)
    chunk = max(1, min(int(chunk), cell_capacity))
    n_chunks = -(-cell_capacity // chunk)
    cap_pad = n_chunks * chunk
    (sel,) = jnp.nonzero(active, size=cap_pad, fill_value=0)
    cell_ok = jnp.arange(cap_pad) < n_active

    fflat = field.reshape(-1)

    # Composed static tables, one column per output slot n = (t·2+s)·3+v
    # (tet t, triangle slot s, triangle vertex v): the cube-corner ids of
    # the slot's edge endpoints for every case. Composing
    # case→edge→corner at trace time turns the kernel's chained runtime
    # gathers into 15-deep where-chains over [36, chunk] planes, in a
    # slot-major layout instead of [chunk,6,2,3,3] temporaries whose
    # tiny minor dims pad badly in device memory.
    _ts = [(n // 6, (n // 3) % 2, n % 3) for n in range(36)]
    a36 = np.zeros((16, 36), np.int32)
    b36 = np.zeros((16, 36), np.int32)
    ok12 = np.zeros((16, 12), bool)
    for c in range(16):
        for n, (t, s, v) in enumerate(_ts):
            e = max(int(_TRI_TABLE[c, s, v]), 0)
            a36[c, n] = _TETS[t, _EDGE_V[e, 0]]
            b36[c, n] = _TETS[t, _EDGE_V[e, 1]]
        for m in range(12):
            ok12[c, m] = _TRI_TABLE[c, m % 2, 0] >= 0
    offf = _CORNER.astype(np.float32)                         # [8,3] static

    def cell_geom(args):
        sel_c, ok_c = args                                    # [chunk]
        ci = sel_c // (cy * cz)
        cj = (sel_c // cz) % cy
        ck = sel_c % cz
        cf = [ci.astype(jnp.float32), cj.astype(jnp.float32),
              ck.astype(jnp.float32)]

        # 8 corner-value planes per active cell (flat gathers — the only
        # gathers in the kernel)
        v8 = [fflat[(ci + int(ox)) * (Y * Z) + (cj + int(oy)) * Z
                    + (ck + int(oz))] for ox, oy, oz in _CORNER]

        # per-tet case planes (bit i = tet vertex i inside)
        cases = []
        for t in range(6):
            c = (v8[_TETS[t, 0]] > iso).astype(jnp.int32)
            for bit, tv in enumerate(_TETS[t, 1:4], start=1):
                c = c + (v8[tv] > iso).astype(jnp.int32) * (1 << bit)
            cases.append(c)

        case36 = jnp.stack([cases[t] for t, _, _ in _ts])     # [36, chunk]

        def by_case(cols):
            """15-deep where-chain: per-slot [36] columns picked by case."""
            out = jnp.broadcast_to(
                jnp.asarray(cols[0])[:, None], case36.shape)
            for c in range(1, 16):
                out = jnp.where(case36 == c,
                                jnp.asarray(cols[c])[:, None], out)
            return out

        def by_corner(ids, planes):
            """7-deep where-chain: [36,chunk] int ids pick [chunk] planes."""
            out = jnp.broadcast_to(planes[0][None, :], ids.shape)
            for k in range(1, 8):
                out = jnp.where(ids == k, planes[k][None, :], out)
            return out

        # corner ids per slot under each case (static [16,36] columns),
        # then the endpoint VALUES by id-select over the 8 corner planes
        # and the endpoint OFFSETS by case-select over static columns
        ida = by_case([a36[c] for c in range(16)])            # [36, chunk]
        idb = by_case([b36[c] for c in range(16)])
        va = by_corner(ida, v8)
        vb = by_corner(idb, v8)
        oa = [by_case([offf[a36[c], ax] for c in range(16)])
              for ax in range(3)]                             # 3×[36,chunk]
        ob = [by_case([offf[b36[c], ax] for c in range(16)])
              for ax in range(3)]

        # interpolate the crossing; a used edge always straddles iso so
        # the denominator is nonzero, but guard the padded slots
        denom = vb - va
        denom = jnp.where(jnp.abs(denom) < 1e-12, 1e-12, denom)
        tt = jnp.clip((iso - va) / denom, 0.0, 1.0)
        vx = [origin[ax] + leaf * (cf[ax][None, :] + oa[ax]
                                   + tt * (ob[ax] - oa[ax]))
              for ax in range(3)]                             # 3×[36,chunk]

        # orient: normal away from the tet's inside-corner centroid
        pin = []                                              # 3×[12,chunk]
        for t6 in range(6):
            w = [(v8[_TETS[t6, v]] > iso).astype(jnp.float32)
                 for v in range(4)]
            wsum = jnp.maximum(w[0] + w[1] + w[2] + w[3], 1e-12)
            pin.append([origin[ax] + leaf * (cf[ax] + sum(
                w[v] * float(offf[_TETS[t6, v], ax]) for v in range(4))
                / wsum) for ax in range(3)])
        pinx = [jnp.stack([pin[m // 2][ax] for m in range(12)])
                for ax in range(3)]

        v0 = [vx[ax][0::3] for ax in range(3)]                # [12, chunk]
        v1 = [vx[ax][1::3] for ax in range(3)]
        v2 = [vx[ax][2::3] for ax in range(3)]
        e1 = [v1[ax] - v0[ax] for ax in range(3)]
        e2 = [v2[ax] - v0[ax] for ax in range(3)]
        nx = e1[1] * e2[2] - e1[2] * e2[1]
        ny = e1[2] * e2[0] - e1[0] * e2[2]
        nz = e1[0] * e2[1] - e1[1] * e2[0]
        cen = [(v0[ax] + v1[ax] + v2[ax]) / 3.0 for ax in range(3)]
        flip = (nx * (cen[0] - pinx[0]) + ny * (cen[1] - pinx[1])
                + nz * (cen[2] - pinx[2])) < 0
        v1f = [jnp.where(flip, v2[ax], v1[ax]) for ax in range(3)]
        v2f = [jnp.where(flip, v1[ax], v2[ax]) for ax in range(3)]

        # validity straight from the case table
        tv = jnp.zeros((12,) + ok_c.shape, bool)
        case12 = jnp.stack([cases[m // 2] for m in range(12)])
        for c in range(16):
            tv = jnp.where(case12 == c,
                           jnp.asarray(ok12[c])[:, None], tv)
        tri_valid = tv & ok_c[None, :]

        # (corner, axis)-major SoA: the big triangle axis goes minor;
        # triangle order n = cell·12 + t·2 + s matches the AoS original
        corners = (v0, v1f, v2f)
        soa = jnp.stack([
            jnp.stack([corners[i][j].T.reshape(-1) for j in range(3)])
            for i in range(3)])
        return soa, tri_valid.T.reshape(-1)

    if n_chunks == 1:
        verts_soa, tri_valid = cell_geom((sel, cell_ok))
    else:
        verts_c, valid_c = jax.lax.map(
            cell_geom, (sel.reshape(n_chunks, chunk),
                        cell_ok.reshape(n_chunks, chunk)))
        verts_soa = jnp.moveaxis(verts_c, 0, 2).reshape(
            3, 3, cap_pad * TRIS_PER_CELL)
        tri_valid = valid_c.reshape(-1)

    ntri = cell_capacity * TRIS_PER_CELL
    return verts_soa[..., :ntri], tri_valid[:ntri], n_active


@partial(jax.jit, static_argnames=("shape", "smooth_iters"))
def field_from_map(ijk: jax.Array, weight: jax.Array, origin_ijk: jax.Array,
                   shape: tuple[int, int, int], min_weight=0.0,
                   saturate=1.0, smooth_iters: int = 1) -> jax.Array:
    """Densify a sparse voxel map into an occupancy field for meshing.

    Args:
      ijk: [cap, 3] absolute biased voxel indices (``VoxelMap.ijk``;
        sentinel rows ignored).
      weight: [cap] evidence weights (``VoxelMap.weight``).
      origin_ijk: [3] int32 — absolute biased index mapped to grid node
        (0,0,0) (choose from the occupied bounds, e.g. ``map_grid_bounds``).
      shape: static (X, Y, Z) node counts.
      min_weight: voxels below this evidence are treated as empty.
      saturate: weight at which occupancy clips to 1 (weights ramp
        occupancy linearly up to it — a barely-seen voxel pulls the
        surface inward rather than flipping it).
      smooth_iters: 3³ box-filter passes over the field. One pass turns
        the binary occupancy into a field whose iso-0.5 crossing sits
        between occupied and empty nodes with sub-voxel interpolation
        (0 = blocky Minecraft surface exactly on voxel faces).

    Returns [X, Y, Z] float32 occupancy in [0, 1]. World position of node
    (i, j, k) is ``(origin_ijk - BIAS + (i,j,k) + 0.5) * map_leaf`` —
    ``marching_tetrahedra(origin=...)`` gets that from ``map_grid_bounds``.
    """
    from ..models.voxel_map import _SENTINEL
    X, Y, Z = shape
    occ = ((ijk[:, 0] != _SENTINEL)
           & (weight >= jnp.asarray(min_weight, jnp.float32)))
    g = ijk - jnp.asarray(origin_ijk, jnp.int32)[None, :]
    inb = jnp.all((g >= 0) & (g < jnp.asarray([X, Y, Z])), axis=-1)
    val = jnp.where(occ & inb,
                    jnp.clip(weight / jnp.asarray(saturate, jnp.float32),
                             0.0, 1.0), 0.0)
    gi = jnp.where((occ & inb)[:, None], g, 0)
    field = jnp.zeros((X, Y, Z), jnp.float32)
    field = field.at[gi[:, 0], gi[:, 1], gi[:, 2]].max(val)
    for _ in range(smooth_iters):
        field = _box3(field)
    return field


def _box3(f: jax.Array) -> jax.Array:
    """Separable 3³ box filter with zero (empty-space) borders."""
    for ax in range(3):
        z = jnp.zeros_like(jax.lax.slice_in_dim(f, 0, 1, axis=ax))
        lo = jnp.concatenate([z, jax.lax.slice_in_dim(
            f, 0, f.shape[ax] - 1, axis=ax)], axis=ax)
        hi = jnp.concatenate([jax.lax.slice_in_dim(
            f, 1, f.shape[ax], axis=ax), z], axis=ax)
        f = (lo + f + hi) / 3.0
    return f


def map_grid_bounds(vmap, min_weight: float = 0.0, pad: int = 2,
                    max_nodes: int = 256):
    """Host-side: fit a dense grid to a map's occupied voxels.

    Returns ``(origin_ijk [3] int32, shape (X,Y,Z), origin_world [3]
    f32)`` sized to the occupied bounding box plus ``pad`` empty layers
    (so the surface can close around the outermost voxels), clamped to
    ``max_nodes`` per axis. Pulls the index array to the host — an
    offline meshing step, not a streaming-path op.
    """
    from ..models.voxel_map import _BIAS, _SENTINEL
    ijk = np.asarray(vmap.ijk)
    w = np.asarray(vmap.weight)
    occ = (ijk[:, 0] != _SENTINEL) & (w >= min_weight)
    if not occ.any():
        raise ValueError("map has no occupied voxels at this min_weight")
    lo = ijk[occ].min(0) - pad
    hi = ijk[occ].max(0) + pad
    shape = tuple(int(min(h - l + 2, max_nodes)) for l, h in zip(lo, hi))
    leaf = float(np.asarray(vmap.leaf))
    origin_world = ((lo - _BIAS).astype(np.float32) + 0.5) * leaf
    return (lo.astype(np.int32), shape,
            np.asarray(origin_world, np.float32))


def reconstruct_surface(vmap, iso: float = 0.5, min_weight: float = 0.0,
                        saturate: float = 1.0, smooth_iters: int = 1,
                        cell_capacity: int | None = None, pad: int = 2,
                        max_nodes: int = 256):
    """Voxel map → crack-free triangle mesh, one call.

    Composes ``map_grid_bounds`` → ``field_from_map`` →
    ``marching_tetrahedra`` and welds the soup on the host. Returns
    ``(verts [V,3] np.f32, faces [F,3] np.int32, n_active int)``. Feed
    straight to ``io.plyio.save_mesh``.
    """
    origin_ijk, shape, origin_world = map_grid_bounds(
        vmap, min_weight=min_weight, pad=pad, max_nodes=max_nodes)
    field = field_from_map(vmap.ijk, vmap.weight, origin_ijk, shape,
                           min_weight=min_weight, saturate=saturate,
                           smooth_iters=smooth_iters)
    if cell_capacity is None:
        ncells = (shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)
        # surface shell heuristic: ~n² cells of the n³ grid, padded 8x
        cell_capacity = int(min(ncells, max(4096, 8 * ncells ** (2 / 3))))
    verts, valid, n_active = marching_tetrahedra(
        field, iso, cell_capacity, origin=origin_world, leaf=vmap.leaf)
    n_active = int(n_active)
    if n_active > cell_capacity:
        raise ValueError(
            f"surface has {n_active} active cells > capacity "
            f"{cell_capacity}; pass a larger cell_capacity")
    v, f = weld_mesh(np.asarray(verts), np.asarray(valid))
    return v, f, n_active


def soup_triangles(verts, valid=None) -> np.ndarray:
    """Device triangle soup → host [n, 3, 3] f32 (triangle-major AoS).

    Accepts either ``marching_tetrahedra``'s coordinate-major [3, 3, T]
    layout or a triangle-major [T, 3, 3] array; ``valid`` (if given)
    selects the real triangles.
    """
    v = np.asarray(verts, np.float32)
    if v.ndim != 3:
        raise ValueError(f"expected a triangle soup, got shape {v.shape}")
    if v.shape[0] == 3 and v.shape[1] == 3 and v.shape[2] != 3:
        v = np.moveaxis(v, 2, 0)
    if valid is not None:
        v = v[np.asarray(valid, bool)]
    return np.ascontiguousarray(v)


def weld_mesh(verts: np.ndarray, valid: np.ndarray, decimals: int = 6):
    """Host-side soup → indexed mesh: dedup shared vertices, drop
    degenerate triangles. Marching-tet neighbours emit bit-identical
    crossing coordinates (same edge, same two field values), so welding
    on rounded coordinates closes the mesh exactly.

    Accepts either soup layout (see ``soup_triangles``). Returns
    ``(vertices [V,3] f32, faces [F,3] int32)``.
    """
    tris = soup_triangles(verts, valid)
    if tris.size == 0:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32)
    flat = tris.reshape(-1, 3)
    key = np.round(flat, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3).astype(np.int32)
    # degenerate = a triangle whose interpolated corners collapsed
    ok = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
          & (faces[:, 0] != faces[:, 2]))
    return uniq.astype(np.float32), faces[ok]
