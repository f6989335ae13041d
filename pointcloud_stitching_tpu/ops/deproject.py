"""Depth-image → 3-D point deprojection.

On-device equivalent of the reference's on-camera-node deprojection
(reference: src/pcs-camera-server.cpp, ``rs2::pointcloud::calculate``, which
calls librealsense's ``rs2_deproject_pixel_to_point``; see SURVEY.md §2.2 row 1).

The math (librealsense, public):
    x = (u - ppx) / fx
    y = (v - ppy) / fy
    [optional distortion correction]
    X = x * d,  Y = y * d,  Z = d        (d = depth_raw * depth_scale)

Pixels with zero depth produce masked-out points (the reference's pack loop
sends them as zeros; downstream PCL ops ignore NaN/zero points).

Everything is a pure elementwise map over the [H, W] grid — on the device this
is a single fused elementwise pass, batched over the camera axis. No per-pixel loop exists
anywhere (contrast with the reference's hot pack loop, SURVEY.md §3.1).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.types import DistortionModel, Intrinsics, PointCloud


def _undistort_brown_conrady_iterative(x, y, coeffs, iters: int = 10):
    """Invert the forward Brown–Conrady model by fixed-point iteration.

    Matches librealsense's deprojection for RS2_DISTORTION_BROWN_CONRADY
    (fixed iteration count keeps it jit-static).
    """
    k1, k2, p1, p2, k3 = (coeffs[..., i] for i in range(5))
    xo, yo = x, y

    def body(_, carry):
        xq, yq = carry
        r2 = xq * xq + yq * yq
        icdist = 1.0 / (1.0 + ((k3 * r2 + k2) * r2 + k1) * r2)
        dx = 2.0 * p1 * xq * yq + p2 * (r2 + 2.0 * xq * xq)
        dy = 2.0 * p2 * xq * yq + p1 * (r2 + 2.0 * yq * yq)
        return ((xo - dx) * icdist, (yo - dy) * icdist)

    x, y = jax.lax.fori_loop(0, iters, body, (x, y))
    return x, y


def _distort_inverse_brown_conrady(x, y, coeffs):
    """Apply the forward polynomial during deprojection.

    librealsense semantics: a stream with RS2_DISTORTION_INVERSE_BROWN_CONRADY
    stores coefficients of the *inverse* map, so deprojection applies them
    forward (closed form, no iteration).
    """
    k1, k2, p1, p2, k3 = (coeffs[..., i] for i in range(5))
    r2 = x * x + y * y
    f = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    ux = x * f + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    uy = y * f + 2.0 * p2 * x * y + p1 * (r2 + 2.0 * y * y)
    return ux, uy


def deproject(depth: jax.Array, intr: Intrinsics,
              depth_scale: float = 0.001,
              z_min: float = 0.0, z_max: float = jnp.inf) -> PointCloud:
    """Deproject a (possibly camera-batched) u16 depth image to 3-D points.

    Args:
      depth: [..., H, W] uint16 (raw depth units) or float (meters if scale=1).
      intr: Intrinsics; batched fields broadcast against leading depth dims.
      depth_scale: meters per raw unit (0.001 for D400 series).
      z_min/z_max: optional validity range (reference cameras clip ~0.3–10 m).

    Returns:
      PointCloud with xyz [..., H*W, 3] and mask [..., H*W]; row-major pixel
      order (v major), matching the reference's pack loop ordering.
    """
    h, w = depth.shape[-2], depth.shape[-1]
    z = depth.astype(jnp.float32) * jnp.float32(depth_scale)

    u = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    v = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)

    def expand(p):  # [...] -> [..., 1, 1] for broadcasting over H, W
        return jnp.asarray(p, jnp.float32)[..., None, None]

    x = (u - expand(intr.ppx)) / expand(intr.fx)
    y = (v - expand(intr.ppy)) / expand(intr.fy)

    if intr.model == int(DistortionModel.BROWN_CONRADY):
        coeffs = jnp.asarray(intr.coeffs, jnp.float32)[..., None, None, :]
        x, y = _undistort_brown_conrady_iterative(x, y, coeffs)
    elif intr.model == int(DistortionModel.INVERSE_BROWN_CONRADY):
        coeffs = jnp.asarray(intr.coeffs, jnp.float32)[..., None, None, :]
        x, y = _distort_inverse_brown_conrady(x, y, coeffs)
    elif intr.model == int(DistortionModel.MIXED):
        # mixed rig (real D400 fleets mix models): compute every correction
        # and select per camera by the traced id — branchless, so one
        # compiled program serves any id assignment. The extra corrections
        # are pure VPU elementwise work, negligible next to the NN/voxel
        # kernels, and only mixed rigs pay it.
        coeffs = jnp.asarray(intr.coeffs, jnp.float32)[..., None, None, :]
        x_bc, y_bc = _undistort_brown_conrady_iterative(x, y, coeffs)
        x_ibc, y_ibc = _distort_inverse_brown_conrady(x, y, coeffs)
        mid = jnp.asarray(intr.model_ids, jnp.int32)[..., None, None]
        is_bc = mid == int(DistortionModel.BROWN_CONRADY)
        is_ibc = mid == int(DistortionModel.INVERSE_BROWN_CONRADY)
        x = jnp.where(is_bc, x_bc, jnp.where(is_ibc, x_ibc, x))
        y = jnp.where(is_bc, y_bc, jnp.where(is_ibc, y_ibc, y))

    xyz = jnp.stack([x * z, y * z, z], axis=-1)
    mask = (z > jnp.float32(max(z_min, 0.0))) if z_max == jnp.inf else (
        (z > jnp.float32(max(z_min, 0.0))) & (z <= jnp.float32(z_max)))

    batch = depth.shape[:-2]
    xyz = xyz.reshape(*batch, h * w, 3)
    mask = mask.reshape(*batch, h * w)
    # Zero out invalid slots so downstream reductions never see garbage.
    xyz = jnp.where(mask[..., None], xyz, 0.0)
    return PointCloud(xyz=xyz, mask=mask)


def project(xyz: jax.Array, intr: Intrinsics) -> tuple[jax.Array, jax.Array]:
    """Project 3-D points (camera frame) to pixel coordinates.

    The inverse of deproject — librealsense's ``rs2_project_point_to_pixel``:
    normalise by z, apply the *forward* distortion polynomial for
    BROWN_CONRADY / (MODIFIED_)BROWN_CONRADY-style color streams, then the
    pinhole. For INVERSE_BROWN_CONRADY streams projection inverts the stored
    inverse map by fixed-point iteration (mirror of deprojection).

    Returns (uv [..., N, 2] float32, in_front [..., N] bool — z > 0).
    """
    z = xyz[..., 2]
    in_front = z > 1e-9
    zs = jnp.where(in_front, z, 1.0)
    x = xyz[..., 0] / zs
    y = xyz[..., 1] / zs

    if intr.model == int(DistortionModel.BROWN_CONRADY):
        coeffs = jnp.asarray(intr.coeffs, jnp.float32)[..., None, :]
        x, y = _distort_inverse_brown_conrady(x, y, coeffs)  # forward poly
    elif intr.model == int(DistortionModel.INVERSE_BROWN_CONRADY):
        coeffs = jnp.asarray(intr.coeffs, jnp.float32)[..., None, :]
        x, y = _undistort_brown_conrady_iterative(x, y, coeffs)
    elif intr.model == int(DistortionModel.MIXED):
        # per-camera select by traced model id, mirroring deproject's MIXED
        # branch (without this, a mixed color rig would silently project
        # every camera undistorted)
        coeffs = jnp.asarray(intr.coeffs, jnp.float32)[..., None, :]
        x_bc, y_bc = _distort_inverse_brown_conrady(x, y, coeffs)
        x_ibc, y_ibc = _undistort_brown_conrady_iterative(x, y, coeffs)
        mid = jnp.asarray(intr.model_ids, jnp.int32)[..., None]
        is_bc = mid == int(DistortionModel.BROWN_CONRADY)
        is_ibc = mid == int(DistortionModel.INVERSE_BROWN_CONRADY)
        x = jnp.where(is_bc, x_bc, jnp.where(is_ibc, x_ibc, x))
        y = jnp.where(is_bc, y_bc, jnp.where(is_ibc, y_ibc, y))

    def expand(p):  # [...] -> [..., 1] for broadcasting over N
        return jnp.asarray(p, jnp.float32)[..., None]

    u = x * expand(intr.fx) + expand(intr.ppx)
    v = y * expand(intr.fy) + expand(intr.ppy)
    return jnp.stack([u, v], axis=-1), in_front


def map_color(pc: PointCloud, color: jax.Array, color_intr: Intrinsics,
              depth_to_color: jax.Array) -> PointCloud:
    """Attach color by texture-coordinate mapping with separate color
    calibration (reference: ``rs2::pointcloud::map_to`` + ``pc.calculate``
    texture coordinates in src/pcs-camera-server.cpp — SURVEY.md §2.1; the
    D4xx color imager is NOT depth-aligned, it has its own intrinsics and a
    depth→color extrinsic).

    Per point: transform into the color camera frame, project with the
    color intrinsics (forward distortion), sample the color image at the
    nearest pixel (librealsense's texture lookup). Points that land outside
    the color frame keep their geometry but get zero color, matching the
    reference's black out-of-FOV texels.

    Args:
      pc: deprojected cloud in the DEPTH camera frame ([..., N, 3]).
      color: [..., Hc, Wc, 3] uint8 color image (its own resolution).
      color_intr: the color stream's Intrinsics (batched like pc).
      depth_to_color: [..., 4, 4] depth→color extrinsic transform.

    Everything is elementwise + one gather per camera — VPU work, no
    pixel loops (the reference does this lookup inside its hot pack loop).
    """
    from .se3 import se3_apply

    hc, wc = color.shape[-3], color.shape[-2]
    xyz_c = se3_apply(depth_to_color, pc.xyz)
    uv, in_front = project(xyz_c, color_intr)
    ui = jnp.round(uv[..., 0]).astype(jnp.int32)
    vi = jnp.round(uv[..., 1]).astype(jnp.int32)
    in_fov = in_front & (ui >= 0) & (ui < wc) & (vi >= 0) & (vi < hc)
    ui = jnp.clip(ui, 0, wc - 1)
    vi = jnp.clip(vi, 0, hc - 1)
    flat = color.astype(jnp.float32).reshape(*color.shape[:-3], hc * wc, 3)
    idx = (vi * wc + ui)[..., None]
    rgb = jnp.take_along_axis(flat, idx, axis=-2)
    rgb = jnp.where((pc.mask & in_fov)[..., None], rgb, 0.0)
    return pc.replace(rgb=rgb)


def deproject_with_color_mapped(depth: jax.Array, color: jax.Array,
                                intr: Intrinsics, color_intr: Intrinsics,
                                depth_to_color: jax.Array,
                                depth_scale: float = 0.001,
                                z_min: float = 0.0,
                                z_max: float = jnp.inf) -> PointCloud:
    """Deproject depth and texture-map color from a non-aligned color stream.

    The full reference camera-node path (rs2 pc.calculate + map_to) for rigs
    that do NOT run the rs2 align processing block: depth deprojects with
    the depth intrinsics, color attaches by projecting each point into the
    color camera (separate intrinsics + extrinsic). For depth-aligned color
    use deproject_with_color (a plain per-pixel lookup).
    """
    pc = deproject(depth, intr, depth_scale, z_min, z_max)
    return map_color(pc, color, color_intr, depth_to_color)


def deproject_with_color(depth: jax.Array, color: jax.Array, intr: Intrinsics,
                         depth_scale: float = 0.001,
                         z_min: float = 0.0, z_max: float = jnp.inf) -> PointCloud:
    """Deproject depth and attach per-pixel RGB (depth-aligned color).

    The reference maps color via texture coordinates (rs2::pointcloud::map_to,
    src/pcs-camera-server.cpp); with depth-aligned color streams this reduces
    to a per-pixel lookup, which is the form we keep on device.

    color: [..., H, W, 3] uint8.
    """
    pc = deproject(depth, intr, depth_scale, z_min, z_max)
    batch = depth.shape[:-2]
    rgb = color.astype(jnp.float32).reshape(*batch, -1, 3)
    rgb = jnp.where(pc.mask[..., None], rgb, 0.0)
    return pc.replace(rgb=rgb)
