"""Convex hulls of point clouds (pcl::ConvexHull + pcl::CropHull roles).

The reference never computes hulls, but its downstream PCL toolchain does
(hull extraction after plane projection is the canonical pcl tutorial
pipeline — see ops/sac.py's project_plane, whose output exists to feed
exactly this). Split of the work:

- The O(N·D) part — finding the cloud's support point in D sampled
  directions — is a blockwise [block,3]x[3,D] matmul with a running
  masked argmax, on device. Every true hull vertex is the argmax of
  *some* direction, so a dense direction set (Fibonacci sphere) recovers
  the hull's vertex set up to facets subtending less than the ~(4pi/D)
  steradian sampling gap; the result is an inner approximation whose
  vertices are all real cloud points.
- The O(H log H) facet enumeration over the <=D surviving candidates runs
  through qhull (scipy) on the host — the same library PCL's ConvexHull
  defers to. ``exact=True`` skips the device reduction and hands qhull
  every valid point (PCL-identical output, host O(N log N)).
- Cropping against a hull (pcl::CropHull role) is again device-side and
  jit-friendly: one [N,3]x[3,F] matmul against the facet plane normals
  and an all-reduce — no polygon ray casting, the half-space intersection
  IS the convex hull.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.types import PointCloud


def fibonacci_directions(n: int) -> np.ndarray:
    """n approximately-uniform unit directions (golden-spiral sphere)."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + np.sqrt(5.0)) * i
    return np.stack([np.sin(phi) * np.cos(theta),
                     np.sin(phi) * np.sin(theta),
                     np.cos(phi)], axis=1).astype(np.float32)


@functools.partial(jax.jit, static_argnames="block")
def _support_indices(xyz, mask, dirs, block: int = 4096):
    """Index of the valid point maximising x . d for each direction.

    Blockwise running argmax: never materialises the [N, D] score matrix
    (262k points x 2048 directions would be 2 GB). HIGHEST precision so
    the selected vertices are the true f32 argmaxima — bf16 scores would
    still pick legal cloud points, but parity with the numpy oracle (and
    run-to-run determinism across backends) is worth the few matmuls.
    """
    n = xyz.shape[0]
    nb = -(-n // block)
    pad = nb * block - n
    pxyz = jnp.pad(xyz, ((0, pad), (0, 0)))
    pmask = jnp.pad(mask, (0, pad))
    dirs_t = dirs.T  # [3, D]

    def body(i, carry):
        best, bidx = carry
        p = jax.lax.dynamic_slice(pxyz, (i * block, 0), (block, 3))
        v = jax.lax.dynamic_slice(pmask, (i * block,), (block,))
        s = jnp.dot(p, dirs_t, precision=jax.lax.Precision.HIGHEST)
        s = jnp.where(v[:, None], s, -jnp.inf)
        loc = jnp.argmax(s, axis=0).astype(jnp.int32)
        val = jnp.max(s, axis=0)
        take = val > best
        return (jnp.where(take, val, best),
                jnp.where(take, i * block + loc, bidx))

    d = dirs.shape[0]
    init = (jnp.full((d,), -jnp.inf, jnp.float32),
            jnp.zeros((d,), jnp.int32))
    _, bidx = jax.lax.fori_loop(0, nb, body, init)
    return bidx


@dataclasses.dataclass(frozen=True)
class ConvexHullResult:
    """Host-side hull: the analogue of pcl::ConvexHull's PolygonMesh
    output plus the qhull facet planes that make device-side cropping a
    matmul."""

    vertices: np.ndarray    # [H, 3] float32 hull vertex positions
    faces: np.ndarray       # [F, 3] int32 into vertices, outward-wound
    equations: np.ndarray   # [F, 4] outward planes: n.x + d <= 0 inside
    area: float
    volume: float
    vertex_ids: np.ndarray  # [H] indices into the input (padded) cloud


def convex_hull(pc: PointCloud, n_dirs: int = 2048, exact: bool = False,
                block: int = 4096) -> ConvexHullResult:
    """Convex hull of the valid points of a (single, unbatched) cloud.

    ``exact=False`` (default): device support-point reduction over
    ``n_dirs`` Fibonacci directions, qhull over the <= n_dirs candidates.
    ``exact=True``: qhull over every valid point (PCL-identical).
    Raises ValueError when fewer than 4 non-degenerate points remain.
    """
    from scipy.spatial import ConvexHull as SciHull
    from scipy.spatial import QhullError

    if pc.xyz.ndim != 2:
        raise ValueError("convex_hull expects an unbatched [N,3] cloud")
    xyz = np.asarray(pc.xyz, np.float32)
    mask = np.asarray(pc.mask, bool)
    if exact:
        cand = np.nonzero(mask)[0]
    else:
        dirs = jnp.asarray(fibonacci_directions(n_dirs))
        idx = np.asarray(_support_indices(pc.xyz, pc.mask, dirs,
                                          block=block))
        cand = np.unique(idx)
        cand = cand[mask[cand]]  # empty-cloud sentinel indices drop here
    if cand.size < 4:
        raise ValueError(f"convex_hull needs >= 4 valid points, "
                         f"got {cand.size}")
    try:
        h = SciHull(xyz[cand])
    except QhullError as e:
        raise ValueError(f"degenerate cloud (coplanar/collinear): {e}")

    # qhull indices point into the candidate array; compact to hull-local.
    remap = np.full(cand.size, -1, np.int32)
    remap[h.vertices] = np.arange(h.vertices.size, dtype=np.int32)
    faces = remap[h.simplices]
    verts = xyz[cand[h.vertices]]
    # Wind each triangle outward (qhull's simplex order is arbitrary; its
    # `equations` normals are the outward ground truth).
    tri = verts[faces]
    wn = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fi,fi->f", wn, h.equations[:, :3]) < 0
    faces[flip] = faces[flip][:, ::-1]
    return ConvexHullResult(
        vertices=verts, faces=faces.astype(np.int32),
        equations=h.equations.astype(np.float32),
        area=float(h.area), volume=float(h.volume),
        vertex_ids=cand[h.vertices].astype(np.int32))


@dataclasses.dataclass(frozen=True)
class ConcaveHullResult:
    """Alpha-shape boundary (pcl::ConcaveHull role).

    3-D: a boundary triangle mesh over the kept (circumradius < alpha)
    Delaunay tetrahedra, outward-wound, plus their total volume. Planar:
    ``rings`` holds the ordered boundary polygon(s) as indices into
    ``vertices`` (outer ring + any hole rings), faces empty.
    """

    vertices: np.ndarray    # [H, 3] float32 boundary vertex positions
    faces: np.ndarray       # [F, 3] int32 into vertices (3-D mode)
    area: float             # boundary surface area (3-D) / shape area (2-D)
    volume: float           # enclosed volume (3-D; 0.0 in planar mode)
    vertex_ids: np.ndarray  # [H] indices into the input (padded) cloud
    rings: tuple = ()       # planar mode: tuple of [k] int32 ring indices


@functools.partial(jax.jit, static_argnames=())
def _tet_circumradii(tets):
    """Circumradius of each tetrahedron [T, 4, 3] — batched 3x3 solves.

    Degenerate (flat) tets solve to nan/inf, which compare False against
    any alpha and so drop out, exactly the behavior alpha shapes want.
    """
    p0 = tets[:, 0]
    a = 2.0 * (tets[:, 1:] - p0[:, None])                       # [T,3,3]
    b = jnp.sum(tets[:, 1:] ** 2 - p0[:, None] ** 2, axis=-1)   # [T,3]
    c = jnp.linalg.solve(a, b[..., None])[..., 0]               # [T,3]
    return jnp.linalg.norm(c - p0, axis=-1)


@functools.partial(jax.jit, static_argnames=())
def _tri_circumradii(tris):
    """Circumradius of each 2-D triangle [T, 3, 2]: r = abc / (4A)."""
    a = jnp.linalg.norm(tris[:, 1] - tris[:, 0], axis=-1)
    b = jnp.linalg.norm(tris[:, 2] - tris[:, 1], axis=-1)
    c = jnp.linalg.norm(tris[:, 0] - tris[:, 2], axis=-1)
    e1, e2 = tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]
    area2 = jnp.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0])  # 2A
    return a * b * c / jnp.maximum(2.0 * area2, 1e-30)


def _pad_pow2(x, lo=4096):
    n = len(x)
    m = lo
    while m < n:
        m *= 2
    return np.pad(x, ((0, m - n),) + ((0, 0),) * (x.ndim - 1)), n


def _chain_rings(edges: np.ndarray) -> list:
    """Order once-used boundary edges into closed rings (host, O(E))."""
    nxt = {}
    for i, j in edges:
        nxt.setdefault(int(i), []).append(int(j))
        nxt.setdefault(int(j), []).append(int(i))
    seen, rings = set(), []
    for start in nxt:
        if start in seen:
            continue
        ring, prev, cur = [start], -1, start
        seen.add(start)
        while True:
            cand = [v for v in nxt[cur] if v != prev and v not in seen]
            if not cand:
                break
            prev, cur = cur, cand[0]
            ring.append(cur)
            seen.add(cur)
        # A ring must close: at a non-manifold (pinched) boundary vertex
        # the greedy walk can terminate early, leaving an open chain —
        # drop it rather than hand downstream a fake polygon.
        if len(ring) >= 3 and ring[0] in nxt[ring[-1]]:
            rings.append(np.asarray(ring, np.int32))
    return rings


def concave_hull(pc: PointCloud, alpha: float,
                 planar: bool = False) -> ConcaveHullResult:
    """Alpha-shape concave hull of the valid points (pcl::ConcaveHull
    role, matching its setAlpha circumradius-bound semantics).

    Split like convex_hull: scipy's Delaunay supplies the connectivity
    (the sequential part PCL also takes from qhull), the O(T) geometric
    filter — one circumradius per simplex — runs batched on device.
    ``planar=True`` projects onto the cloud's best-fit plane first (the
    pcl idiom downstream of project_plane) and returns ordered boundary
    ring(s) instead of a triangle mesh.
    """
    from scipy.spatial import Delaunay, QhullError

    if pc.xyz.ndim != 2:
        raise ValueError("concave_hull expects an unbatched [N,3] cloud")
    xyz = np.asarray(pc.xyz, np.float32)
    mask = np.asarray(pc.mask, bool)
    valid = np.nonzero(mask)[0]
    if valid.size < (3 if planar else 4):
        raise ValueError(f"concave_hull needs >= 4 valid points, "
                         f"got {valid.size}")
    pts = xyz[valid].astype(np.float64)

    if planar:
        centered = pts - pts.mean(axis=0)
        _, _, vt = np.linalg.svd(centered, full_matrices=False)
        uv = centered @ vt[:2].T
        try:
            d = Delaunay(uv)
        except QhullError as e:
            raise ValueError(f"degenerate planar cloud: {e}")
        ptris, t = _pad_pow2(uv[d.simplices].astype(np.float32))
        r = np.asarray(_tri_circumradii(jnp.asarray(ptris)))[:t]
        keep = d.simplices[r < alpha]
        if keep.size == 0:
            raise ValueError("alpha too small: no triangles survive")
        e1, e2 = uv[keep[:, 1]] - uv[keep[:, 0]], uv[keep[:, 2]] - uv[keep[:, 0]]
        area = float(np.abs(e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum()
                     / 2.0)
        edges = np.sort(keep[:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2),
                        axis=1)
        uniq, counts = np.unique(edges, axis=0, return_counts=True)
        rings_local = _chain_rings(uniq[counts == 1])
        used = np.unique(np.concatenate(rings_local)) if rings_local \
            else np.arange(0)
        remap = np.full(len(pts), -1, np.int32)
        remap[used] = np.arange(used.size, dtype=np.int32)
        return ConcaveHullResult(
            vertices=xyz[valid[used]],
            faces=np.zeros((0, 3), np.int32), area=area, volume=0.0,
            vertex_ids=valid[used].astype(np.int32),
            rings=tuple(remap[r] for r in rings_local))

    try:
        d = Delaunay(pts)
    except QhullError as e:
        raise ValueError(f"degenerate cloud (coplanar/collinear): {e}")
    ptets, t = _pad_pow2(pts[d.simplices].astype(np.float32))
    r = np.asarray(_tet_circumradii(jnp.asarray(ptets)))[:t]
    keep = d.simplices[np.nan_to_num(r, nan=np.inf) < alpha]
    if keep.size == 0:
        raise ValueError("alpha too small: no tetrahedra survive")
    # volume of the kept solid
    e = pts[keep[:, 1:]] - pts[keep[:, 0]][:, None]             # [K,3,3]
    volume = float(np.abs(np.linalg.det(e)).sum() / 6.0)
    # boundary = faces used by exactly one kept tet; remember the
    # opposite vertex so each face can be wound away from its tet
    fidx = np.array([[1, 2, 3], [0, 2, 3], [0, 1, 3], [0, 1, 2]])
    faces_all = keep[:, fidx].reshape(-1, 3)                     # [4K,3]
    opp = keep[:, [0, 1, 2, 3]].reshape(-1)                      # [4K]
    key = np.sort(faces_all, axis=1)
    uniq, inv, counts = np.unique(key, axis=0, return_inverse=True,
                                  return_counts=True)
    on_boundary = counts[inv] == 1
    bfaces, bopp = faces_all[on_boundary], opp[on_boundary]
    tri = pts[bfaces]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    flip = np.einsum("fi,fi->f", n, pts[bopp] - tri[:, 0]) > 0
    bfaces[flip] = bfaces[flip][:, ::-1]
    area = float(np.linalg.norm(n, axis=1).sum() / 2.0)
    used = np.unique(bfaces)
    remap = np.full(len(pts), -1, np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    return ConcaveHullResult(
        vertices=xyz[valid[used]], faces=remap[bfaces].astype(np.int32),
        area=area, volume=volume,
        vertex_ids=valid[used].astype(np.int32))


def crop_hull(pc: PointCloud, hull, invert: bool = False,
              eps: float | None = None) -> PointCloud:
    """Keep points inside the hull (pcl::CropHull role), as a mask-only op.

    ``hull`` is a ConvexHullResult or a raw [F, 4] plane array (outward
    normals, n.x + d <= 0 inside); passing planes keeps the op fully
    traceable under jit. One [N,3]x[3,F] matmul + an all-reduce — the
    convex hull IS its half-space intersection, so no ray casting.

    ``eps`` is an ABSOLUTE slack on the signed plane distance; the
    default scales with the hull's extent (1e-6 x (1 + max |plane d|),
    unit normals make |d| the plane's distance from the origin) so the
    hull's own vertices survive f32 plane-equation rounding at any
    coordinate magnitude.
    """
    planes = jnp.asarray(getattr(hull, "equations", hull), jnp.float32)
    tol = (jnp.float32(eps) if eps is not None
           else 1e-6 * (1.0 + jnp.max(jnp.abs(planes[:, 3]))))
    d = jnp.dot(pc.xyz, planes[:, :3].T,
                precision=jax.lax.Precision.HIGHEST) + planes[:, 3]
    inside = jnp.all(d <= tol, axis=-1)
    keep = jnp.logical_xor(inside, invert)
    return pc.replace(mask=pc.mask & keep)
