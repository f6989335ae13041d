"""Z-slab sharded TSDF: the volume's last grid axis over a device mesh.

The TSDF integrate is voxel-local — every voxel's update reads only its
own projection into the (small) depth images — so the natural multi-device
decomposition is a **slab of the grid per device with the frames
replicated**, not a camera split:

  * integrate: each device fuses all cameras into its own Z slab against
    replicated depth images. ZERO bytes of gather traffic cross devices —
    the only per-step comms is the host broadcast of the frames
    (~814 KB/camera at 848×480 u16), and the random-gather wall that
    dominates integrate (models/tsdf.py module docstring) divides by
    the mesh size.
  * raycast: each device marches rays through its slab extended by a
    ``halo`` of neighbour boundary planes (one ``ppermute`` per
    neighbour, X·Y·halo·4 B ≈ 1.6 MB at 256² — so a crossing straddling
    a slab boundary is seen by the slab that owns its far sample), then
    per-pixel hits min-combine across the mesh (3 all-reduces over
    [h, w] maps). Slabs that find the same crossing (in the halo
    overlap) compute IDENTICAL values from identical samples, so the
    tie-average is exact.

Memory arithmetic (docs/SCALING.md): a 512³ f32 volume is 512 MB per
array (tsdf + weight = 1 GB, +1.5 GB colored); 8-way Z slabs hold
128 MB/device — volumes that cannot exist on one device run unmodified.

Exactness: slab voxel centers are ``(origin + Zs·k·leaf) + j·leaf``
versus the unsharded ``origin + (Zs·k + j)·leaf`` — bitwise equal when
``leaf`` is a power of two and ``origin`` a multiple of it (all
products exact in f32), and within an ulp of the voxel center
otherwise (which can flip a pixel ROUNDING at exact half-pixel
boundaries — tests pin power-of-two geometry for bitwise parity;
see tests/test_parallel.py).

Reference role: pcl::gpu::kinfu::TsdfVolume is single-GPU; the
reference system has no multi-device scene model at all (the
multi-device tier is this framework's addition).
"""
from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.tsdf import RaycastResult, TSDFVolume, integrate, raycast


def shard_volume(vol: TSDFVolume, mesh: Mesh, axis: str = "z"
                 ) -> TSDFVolume:
    """Place a volume with its Z grid axis sharded over ``mesh``.

    The grid's Z extent must divide by the mesh size. Scalars (origin/
    leaf/trunc) replicate; a colored volume shards its rgb the same way.
    """
    n = mesh.devices.size
    if vol.shape[2] % n != 0:
        raise ValueError(f"grid Z={vol.shape[2]} not divisible by "
                         f"mesh size {n}")
    zs = NamedSharding(mesh, P(None, None, axis))
    rep = NamedSharding(mesh, P())
    return TSDFVolume(
        tsdf=jax.device_put(vol.tsdf, zs),
        weight=jax.device_put(vol.weight, zs),
        origin=jax.device_put(vol.origin, rep),
        leaf=jax.device_put(vol.leaf, rep),
        trunc=jax.device_put(vol.trunc, rep),
        rgb=None if vol.rgb is None else jax.device_put(
            vol.rgb, NamedSharding(mesh, P(None, None, axis, None))))


def _slab_origin(origin, leaf, zs_owned: int, axis: str,
                 extra_lo: int = 0):
    """World origin of this device's slab: the global origin shifted by
    the slab's first GLOBAL z index (minus ``extra_lo`` halo planes).
    ``zs_owned`` is the owned (pre-halo) slab depth."""
    idx = jax.lax.axis_index(axis).astype(jnp.float32)
    off = (idx * float(zs_owned) - float(extra_lo)) * leaf
    return origin + jnp.array([0.0, 0.0, 1.0], jnp.float32) * off


def make_sharded_integrate(mesh: Mesh, axis: str = "z",
                           method: str = "auto"):
    """Build ``fn(vol, depth, intr, extrinsics, **kw) -> TSDFVolume``
    integrating one multi-camera frame into a Z-slab sharded volume.

    ``vol`` must be sharded with :func:`shard_volume`; frames/intrinsics/
    extrinsics replicate (the host feed broadcasts them). Each device
    runs the full single-device integrate (models/tsdf.py, any
    ``method``) on its slab with a shifted origin; no collective appears
    in the step at all.
    """
    zs_spec = P(None, None, axis)
    rep = P()
    cache = {}

    def build(has_rgb: bool, has_color: bool):
        def local_fn(tsdf, weight, rgb, depth, intr, ext, origin, leaf,
                     trunc, scale, maxw, color, mask, zmin, zmax):
            org = _slab_origin(origin, leaf, tsdf.shape[2], axis)
            vol = TSDFVolume(tsdf=tsdf, weight=weight, origin=org,
                             leaf=leaf, trunc=trunc, rgb=rgb)
            out = integrate(vol, depth, intr, ext, depth_scale=scale,
                            max_weight=maxw, color=color, cam_mask=mask,
                            z_min=zmin, z_max=zmax, method=method)
            return out.tsdf, out.weight, out.rgb

        del has_color   # color rides a replicated spec whether present
        # or None (an empty pytree ignores its spec); the cache key
        # still splits the two so retracing stays explicit
        in_specs = (zs_spec, zs_spec,
                    P(None, None, axis, None) if has_rgb else rep,
                    rep, rep, rep, rep, rep, rep, rep, rep,
                    rep, rep, rep, rep)
        out_specs = (zs_spec, zs_spec,
                     P(None, None, axis, None) if has_rgb else rep)
        return jax.jit(jax.shard_map(local_fn, mesh=mesh,
                                     in_specs=in_specs,
                                     out_specs=out_specs,
                                     check_vma=False))

    def fn(vol: TSDFVolume, depth, intr, extrinsics,
           depth_scale: float = 0.001, max_weight: float = 64.0,
           color=None, cam_mask=None, z_min: float = 0.0,
           z_max: float = float("inf")) -> TSDFVolume:
        if depth.ndim == 2:
            # mirror integrate()'s single-camera promotion IN FULL (intr
            # and color too): local_fn hands these straight to integrate
            # with depth already 3-D, so its own promotion won't fire
            depth = depth[None]
            extrinsics = jnp.asarray(extrinsics)
            if extrinsics.ndim == 2:
                extrinsics = extrinsics[None]
            if color is not None and color.ndim == 3:
                color = color[None]
            if jnp.asarray(intr.fx).ndim == 0:
                intr = jax.tree_util.tree_map(
                    lambda a: jnp.asarray(a)[None], intr)
        if cam_mask is None:
            cam_mask = jnp.ones((depth.shape[0],), bool)
        key = (vol.rgb is not None, color is not None)
        if key not in cache:
            cache[key] = build(*key)
        tsdf, weight, rgb = cache[key](
            vol.tsdf, vol.weight, vol.rgb, depth, intr,
            jnp.asarray(extrinsics), vol.origin, vol.leaf, vol.trunc,
            jnp.asarray(depth_scale, jnp.float32),
            jnp.asarray(max_weight, jnp.float32), color, cam_mask,
            jnp.asarray(z_min, jnp.float32),
            jnp.asarray(z_max, jnp.float32))
        return TSDFVolume(tsdf=tsdf, weight=weight, origin=vol.origin,
                          leaf=vol.leaf, trunc=vol.trunc, rgb=rgb)

    return fn


def _exchange_halo(a, halo: int, axis: str, n: int, channels: bool):
    """Extend a slab with ``halo`` boundary planes from each Z
    neighbour. Edge slabs receive zeros (ppermute's unmatched-source
    fill) — weight-0 planes read as UNOBSERVED downstream, exactly the
    out-of-volume semantics the unsharded field has there."""
    zax = 3 if channels else 2
    lo = jax.lax.slice_in_dim(a, 0, halo, axis=zax)
    hi = jax.lax.slice_in_dim(a, a.shape[zax] - halo, a.shape[zax],
                              axis=zax)
    from_prev = jax.lax.ppermute(hi, axis,
                                 [(i, i + 1) for i in range(n - 1)])
    from_next = jax.lax.ppermute(lo, axis,
                                 [(i + 1, i) for i in range(n - 1)])
    return jnp.concatenate([from_prev, a, from_next], axis=zax)


def make_sharded_raycast(mesh: Mesh, axis: str = "z",
                         t_min: float = 0.2, t_max: float = 8.0,
                         step: Optional[float] = None, stride: int = 1,
                         halo: Optional[int] = None):
    """Build ``fn(vol, intr, extrinsics) -> RaycastResult`` rendering a
    Z-slab sharded volume: per-slab march over a halo-extended field,
    then a per-pixel min-combine of the hits across the mesh.

    ``step`` is the march step in meters (static; defaults to half the
    truncation band read off the CONCRETE volume at call time, like the
    unsharded wrapper). ``halo`` defaults to ``ceil(1.5·step/leaf) + 2``
    planes — enough that the slab owning a crossing's far sample also
    holds the march's previous sample, the trilinear refinement's
    ±step/2 probes, and the normal lattice around the refined hit.
    """
    n = mesh.devices.size
    rep = P()
    zs_spec = P(None, None, axis)
    cache = {}

    def build(has_rgb: bool, step_f: float, halo_p: int):
        def local_fn(tsdf, weight, rgb, intr, ext, origin, leaf, trunc):
            tsdf_e = _exchange_halo(tsdf, halo_p, axis, n, False)
            # halo weights arrive 0 on edge slabs and as the neighbour's
            # real evidence elsewhere — the NaN-masked field treats both
            # correctly (models/tsdf.py _nan_field)
            weight_e = _exchange_halo(weight, halo_p, axis, n, False)
            rgb_e = None if rgb is None else _exchange_halo(
                rgb, halo_p, axis, n, True)
            org = _slab_origin(origin, leaf, tsdf.shape[2], axis,
                               extra_lo=halo_p)
            vol = TSDFVolume(tsdf=tsdf_e, weight=weight_e, origin=org,
                             leaf=leaf, trunc=trunc, rgb=rgb_e)
            rc = raycast(vol, intr, ext, t_min=t_min, t_max=t_max,
                         step=step_f, stride=stride)
            # min-combine: the earliest valid hit across slabs wins; on
            # exact ties (a crossing inside the halo overlap) every
            # winner computed identical values, so the average is exact
            d = jnp.where(rc.valid, rc.depth, jnp.inf)
            dmin = jax.lax.pmin(d, axis)
            sel = rc.valid & (d == dmin)
            cnt = jax.lax.psum(sel.astype(jnp.float32), axis)
            den = jnp.maximum(cnt, 1.0)

            def comb(x):
                m = sel[..., None] if x.ndim == 3 else sel
                s = jax.lax.psum(jnp.where(m, x, 0.0), axis)
                return s / (den[..., None] if x.ndim == 3 else den)

            valid_g = cnt > 0.0
            return RaycastResult(
                depth=jnp.where(valid_g, dmin, 0.0),
                vertex=comb(rc.vertex), normal=comb(rc.normal),
                valid=valid_g,
                rgb=None if rc.rgb is None else comb(rc.rgb))

        out_rc = RaycastResult(depth=rep, vertex=rep, normal=rep,
                               valid=rep,
                               rgb=rep if has_rgb else None)
        return jax.jit(jax.shard_map(
            local_fn, mesh=mesh,
            in_specs=(zs_spec, zs_spec,
                      P(None, None, axis, None) if has_rgb else rep,
                      rep, rep, rep, rep, rep),
            out_specs=out_rc, check_vma=False))

    def fn(vol: TSDFVolume, intr, extrinsics) -> RaycastResult:
        import numpy as np
        step_f = step if step is not None else 0.5 * float(
            np.asarray(vol.trunc))
        leaf_f = float(np.asarray(vol.leaf))
        halo_p = halo if halo is not None else (
            int(np.ceil(1.5 * step_f / leaf_f)) + 2)
        if halo_p > vol.shape[2] // n:
            # a clamped halo would SILENTLY drop crossings near slab
            # boundaries (neither neighbour sees both march samples);
            # refuse instead — every remedy changes results or shapes,
            # so it must be the caller's explicit choice
            raise ValueError(
                f"sharded raycast needs a {halo_p}-plane halo "
                f"(step {step_f:.4g} m at leaf {leaf_f:.4g} m) but the "
                f"Z slab is only {vol.shape[2] // n} planes deep on this "
                f"{n}-device mesh — use a smaller step, fewer devices / "
                f"a deeper grid, or pass halo= explicitly (risking "
                f"missed crossings at slab boundaries)")
        key = (vol.rgb is not None, step_f, halo_p)
        if key not in cache:
            cache[key] = build(*key)
        return cache[key](vol.tsdf, vol.weight, vol.rgb, intr,
                          jnp.asarray(extrinsics), vol.origin, vol.leaf,
                          vol.trunc)

    return fn
