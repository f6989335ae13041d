"""The flagship model: the multi-camera stitching pipeline.

Accelerator re-design of the reference client's per-frame path (reference:
src/pcs-multicamera-client.cpp render loop + per-camera threads —
SURVEY.md §3.2/§3.3). Where the reference runs thread-per-camera CPU work
(parse → transform) followed by serial concat/filter, here the *camera axis
is a batch dimension*: one jitted program per frame does

  batched deproject → grid-stride ICP subsample → ring-pairwise ICP drift
  correction (all pairs in one batched NN kernel per iteration, corrections
  composed with an associative scan) → SE(3) into world frame → fuse →
  one global voxel-grid pass (the reference's own dataflow)

entirely on-device, with fixed shapes, so XLA compiles it once. Per-frame
drift correction runs >=5 ICP iterations per camera pair per frame
(BASELINE.json north star; the reference has no online refinement at all —
extrinsics there are frozen .cal files).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.deproject import deproject, deproject_with_color, map_color
from ..ops.filters import crop_box
from ..ops.fuse import fuse_batched
from ..ops.icp import icp_batched, icp_point_to_plane_batched
from ..ops.normals import grid_normals
from ..ops.se3 import mm, se3_apply, se3_power
from ..ops.voxel import decimate_depth, voxel_downsample
from ..utils.config import StitchConfig
from ..utils.types import Intrinsics, PointCloud


class StitchMetrics(NamedTuple):
    points_in: jax.Array        # valid raw points this frame
    points_out: jax.Array       # voxels in the fused output
    icp_mean_error: jax.Array   # [ncam-1] per-pair mean sq corr distance
    icp_inliers: jax.Array      # [ncam-1]
    # squared Frobenius deviation from identity of the ring-closure residual
    # (the loop camera(n-1)->camera 0 mismatch after chain corrections);
    # 0.0 when closure is off or ncam < 3. This is the accumulated-drift
    # observability the anchored chain lacked.
    # (plain-float default: no jax array work at import time)
    loop_error: jax.Array | float = 0.0


class StitchOutput(NamedTuple):
    cloud: PointCloud           # fused, downsampled world-frame cloud
    extrinsics: jax.Array       # [ncam, 4, 4] refined extrinsics
    metrics: StitchMetrics
    # raw device-resident inputs of the frame that produced this output,
    # attached by the streaming client (None from direct pipeline calls):
    # lets consumers run depth-domain models (TSDF integrate, tracking)
    # on the exact frame the stitch saw, without a second H2D transfer
    depth: Optional[jax.Array] = None       # [ncam, H, W] raw units
    color: Optional[jax.Array] = None       # [ncam, H, W, 3] aligned rgb
    cam_mask: Optional[jax.Array] = None    # [ncam] bool


def autofit_out_leaf(points_out: jax.Array, leaf: jax.Array, *,
                     capacity: int, floor: float, ceil: float,
                     grow: float = 1.25,
                     headroom: float = 0.85) -> jax.Array:
    """Per-frame output-leaf controller for a fixed-capacity voxel grid.

    PCL's VoxelGrid reallocates when a scene outgrows it; a fixed-shape program
    cannot (fixed shapes), so a saturated output drops the sorted tail of
    voxels — a spatially biased amputation. This controller instead adapts
    the *resolution*: the leaf is a traced operand of the stitch step
    (never a recompile), grown by ``grow`` whenever the last frame
    saturated and shrunk back toward ``floor`` (the configured target
    resolution) when a finer grid would fit with ``headroom`` to spare.

    The shrink guard is cubic (``points_out * grow**3 < headroom *
    capacity``): occupancy scales ~leaf^-2 for surface-like scenes but up
    to leaf^-3 for volumetric ones, and a quadratic guard on a volumetric
    scene re-saturates right after shrinking (grow/shrink oscillation). The
    cubic bound is safe for both — at worst it shrinks a surface scene one
    frame later.

    Pure and jittable; StitchingPipeline applies it between frames when
    ``cfg.out_leaf_autofit`` is set (the device scalar feeds back without
    any host sync, same pattern as the refined-extrinsics feedback).
    """
    pts = points_out.astype(jnp.float32)
    cap = jnp.float32(capacity)
    leaf = jnp.asarray(leaf, jnp.float32)
    nxt = jnp.where(pts >= cap, leaf * grow,
                    jnp.where(pts * grow ** 3 < headroom * cap,
                              leaf / grow, leaf))
    return jnp.clip(nxt, floor, ceil)


def _compose_ring_corrections(deltas: jax.Array, closure: bool,
                              gate: jax.Array | float = jnp.inf,
                              gate_rot: jax.Array | float = jnp.inf
                              ) -> tuple[jax.Array, jax.Array]:
    """Chain-compose per-pair ICP corrections, optionally closing the ring.

    deltas: [ncam, 4, 4] where deltas[i] aligns camera i to camera i-1
    (mod ncam) in the world frame; deltas[0] is the ring-closing pair
    (camera 0 vs camera ncam-1) — pass identity there when closure is off.

    Chain: corrections[k] = deltas[1] @ ... @ deltas[k]; camera 0 anchors.
    Closure: the loop residual r = corrections[ncam-1] @ deltas[0] would be
    identity if all pairwise estimates were consistent; the accumulated
    mismatch is distributed uniformly along the chain by left-multiplying
    camera k with r^(-k/ncam) (fractional SE(3) power) — camera 0 stays
    exactly anchored, camera ncam-1 absorbs (ncam-1)/ncam of the residual,
    so chain-end drift no longer compounds monotonically with ncam.

    gate: residual sanity bound (meters). Per-pair corrections are
    small-drift estimates, so a closing residual whose translation exceeds
    ``gate`` cannot be real accumulated drift — it means the "closing" pair
    has no true overlap (a physically open ring, e.g. a camera line) or
    ICP slid along a low-texture surface to a false alignment; distributing
    such a residual corrupts every camera (measured: a 0.52 m false
    residual turned a 0.032 m injected drift into 16x that). gate_rot
    (radians) is the rotation arm of the same test — a rotation-dominated
    false closure has small translation but a large angle and is equally
    implausible as per-frame drift. Gated frames keep the chain-only
    corrections; loop_error still reports the residual for observability.
    Returns (corrections [ncam, 4, 4], loop_error scalar = |r - I|_F^2).
    """
    eye = jnp.eye(4, dtype=jnp.float32)
    prefix = jax.lax.associative_scan(mm, deltas.at[0].set(eye))
    if not closure:
        return prefix, jnp.float32(0.0)
    ncam = deltas.shape[0]
    residual = mm(prefix[-1], deltas[0])
    loop_err = jnp.sum((residual - eye) ** 2)
    # both arms must pass: a rotation-dominated false closure (ICP slid
    # around a rotationally ambiguous surface) has small translation but a
    # large angle — trace(R) = 1 + 2 cos(theta)
    cos_theta = (jnp.trace(residual[:3, :3]) - 1.0) * 0.5
    g_rot = jnp.asarray(gate_rot, jnp.float32)
    # gate_rot >= pi admits any rotation (cos(inf) would be nan and
    # spuriously gate everything; -2 is below any cos_theta incl. float
    # error past -1)
    rot_thresh = jnp.where(g_rot >= jnp.pi, -2.0, jnp.cos(g_rot))
    ok = (jnp.sum(residual[:3, 3] ** 2)
          <= jnp.asarray(gate, jnp.float32) ** 2) \
        & (cos_theta >= rot_thresh)
    alphas = (-jnp.arange(ncam, dtype=jnp.float32) / ncam
              * ok.astype(jnp.float32))  # alpha 0 == identity correction
    return mm(se3_power(residual, alphas), prefix), loop_err


def _ring_drift_correction(cfg: StitchConfig, clouds: PointCloud,
                           extrinsics: jax.Array
                           ) -> tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Refine extrinsics by aligning each camera's cloud to its ring predecessor.

    clouds: camera-batched *sensor-frame* clouds [ncam, C, 3] (+mask).
    Returns (refined_extrinsics [ncam,4,4], per-pair chain mean errors,
    inliers, loop closure error).

    All pairwise ICPs run as one batched ICP (one NN kernel per iteration
    over every pair); the near-identity corrections compose along the ring
    with an associative scan, so nothing is sequential in ncam but the
    O(log n) scan. With cfg.icp_ring_closure (and ncam >= 3) the closing
    pair (camera 0 vs camera ncam-1) is measured too and its residual
    distributed along the chain — without it the reference-style anchored
    chain accumulates drift monotonically toward camera ncam-1.
    """
    ncam = cfg.num_cameras
    closure = cfg.icp_ring_closure and ncam >= 3
    # clouds.rgb carries sensor-frame normals in point-to-plane mode
    # (averaged through the voxel pass, renormalised here)
    world_xyz = se3_apply(extrinsics, clouds.xyz)
    world = PointCloud(xyz=world_xyz, mask=clouds.mask)
    if closure:
        # pair i aligns camera i to camera i-1 (mod ncam); pair 0 closes
        # the ring (same layout as parallel/shard_stitch's ppermute ring)
        src = world
        dst = jax.tree.map(lambda a: jnp.roll(a, 1, axis=0), world)
    else:
        src = jax.tree.map(lambda a: a[1:], world)    # cameras 1..n-1
        dst = jax.tree.map(lambda a: a[:-1], world)   # cameras 0..n-2

    if cfg.icp_variant == "point_to_plane" and clouds.rgb is not None:
        # clouds.rgb carries voxel-averaged sensor-frame normals (the
        # legacy points payload has no grid to derive normals from, so it
        # falls back to point-to-point below)
        n = clouds.rgb                             # [ncam, C, 3] normals
        norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
        # voxel-averaged normals that cancel out (>60 deg disagreement)
        # are dropped by the n_ok gate inside the solver
        n = jnp.where(norm > 0.5, n / jnp.maximum(norm, 1e-12), 0.0)
        R = extrinsics[:, :3, :3]
        n_world = jnp.einsum("cij,cnj->cni", R, n, precision="highest")
        dst_n = jnp.roll(n_world, 1, axis=0) if closure else n_world[:-1]
        res = icp_point_to_plane_batched(
            src, dst, dst_n, iterations=cfg.icp_iterations,
            max_corr_dist=cfg.icp_max_corr_dist,
            query_tile=cfg.icp_query_tile, ref_tile=cfg.icp_ref_tile,
            nn_impl=cfg.kernel_impl, trim_fraction=cfg.icp_trim_fraction,
            nn_interpret=cfg.kernel_interpret)
    else:
        res = icp_batched(src, dst, iterations=cfg.icp_iterations,
                          max_corr_dist=cfg.icp_max_corr_dist,
                          query_tile=cfg.icp_query_tile,
                          ref_tile=cfg.icp_ref_tile,
                          nn_impl=cfg.kernel_impl,
                          nn_interpret=cfg.kernel_interpret,
                          trim_fraction=cfg.icp_trim_fraction)
    if closure:
        deltas = res.T                              # [ncam, 4, 4]
        err, inl = res.mean_error[1:], res.num_inliers[1:]
    else:
        eye = jnp.eye(4, dtype=jnp.float32)[None]
        deltas = jnp.concatenate([eye, res.T], axis=0)
        err, inl = res.mean_error, res.num_inliers
    corrections, loop_err = _compose_ring_corrections(
        deltas, closure, gate=cfg.icp_closure_gate,
        gate_rot=cfg.icp_closure_gate_rot)
    refined = mm(corrections, extrinsics)
    return refined, err, inl, loop_err


def _stitch_tail(cfg: StitchConfig, raw: PointCloud, extrinsics: jax.Array,
                 points_in: jax.Array, sub: PointCloud,
                 out_leaf: Optional[jax.Array] = None) -> StitchOutput:
    """Shared back half: ring drift correction → world → fuse → voxel."""
    ncam = cfg.num_cameras
    icp_err = jnp.zeros((max(ncam - 1, 1),), jnp.float32)
    icp_inl = jnp.zeros((max(ncam - 1, 1),), jnp.int32)
    loop_err = jnp.float32(0.0)
    if cfg.icp_enabled and ncam > 1:
        icp_clouds = voxel_downsample(sub, cfg.icp_voxel_leaf,
                                      capacity=cfg.icp_capacity)
        extrinsics, icp_err, icp_inl, loop_err = _ring_drift_correction(
            cfg, icp_clouds, extrinsics)

    clouds = raw
    if cfg.cam_voxel_enabled:
        # bound the per-camera cloud (useful when cameras shard across devices
        # and fused points must cross the interconnect)
        clouds = voxel_downsample(clouds, cfg.cam_voxel_leaf,
                                  capacity=cfg.cam_capacity)
    world = clouds.replace(xyz=se3_apply(extrinsics, clouds.xyz))
    if cfg.with_normals and clouds.rgb is not None:
        # normals rotate with the refined extrinsics (translation-free),
        # then quantize to 3x8-bit so the output voxel pass takes the
        # packed 3-operand sort (the colored-cloud fast path; mean exact);
        # ops.normals.decode_normals recovers unit world normals
        R = extrinsics[..., :3, :3]
        nw = jnp.einsum("cij,cnj->cni", R, clouds.rgb, precision="highest")
        world = world.replace(
            rgb=jnp.clip(jnp.round((nw + 1.0) * 127.5), 0.0, 255.0))
    fused = fuse_batched(world)
    if cfg.crop_lo is not None:
        # world-frame scene bound (mask-only, free): crop BEFORE the voxel
        # pass so out-of-bounds points don't consume output capacity
        fused = crop_box(fused, list(cfg.crop_lo), list(cfg.crop_hi))
    # one global voxel pass, same dataflow as the reference's fused
    # VoxelGrid. The leaf may arrive as a traced operand (out_leaf): the
    # autofit controller / callers vary resolution per frame with no
    # recompile.
    leaf = cfg.out_voxel_leaf if out_leaf is None else out_leaf
    out = voxel_downsample(fused, leaf,
                           capacity=cfg.out_capacity)

    metrics = StitchMetrics(points_in=points_in, points_out=out.count(),
                            icp_mean_error=icp_err, icp_inliers=icp_inl,
                            loop_error=loop_err)
    return StitchOutput(cloud=out, extrinsics=extrinsics, metrics=metrics)


def stitch_step(cfg: StitchConfig, intr: Intrinsics, extrinsics: jax.Array,
                depths: jax.Array, colors: Optional[jax.Array] = None,
                cam_mask: Optional[jax.Array] = None,
                color_intr: Optional[Intrinsics] = None,
                color_ext: Optional[jax.Array] = None,
                out_leaf: Optional[jax.Array] = None) -> StitchOutput:
    """One full stitching step. Pure function of its inputs; jit over `cfg`.

    Args:
      cfg: static configuration.
      intr: camera-batched Intrinsics ([ncam] leading axis on fields).
      extrinsics: [ncam, 4, 4] camera→world transforms (.cal matrices).
      depths: [ncam, H, W] uint16 raw depth.
      colors: optional [ncam, H, W, 3] uint8 depth-aligned color — or, when
        color_intr/color_ext are given, [ncam, Hc, Wc, 3] non-aligned color
        at the color stream's own resolution.
      cam_mask: optional [ncam] bool — False drops a camera (timeout/failure
        handling per SURVEY.md §5: a dead camera costs nothing, no reshape).
      color_intr/color_ext: optional per-camera color-stream Intrinsics and
        [ncam, 4, 4] depth→color extrinsics. When given, color attaches by
        texture-coordinate mapping (rs2 map_to semantics — projects each
        point into the color camera; see ops.deproject.map_color) instead of
        assuming depth-aligned streams.
      out_leaf: optional traced scalar overriding cfg.out_voxel_leaf for the
        fused output grid — per-frame resolution changes with no recompile
        (fed by autofit_out_leaf when cfg.out_leaf_autofit is set).
    """
    ncam = cfg.num_cameras
    assert depths.shape[0] == ncam
    if colors is not None and cfg.with_normals:
        # both ride the cloud's rgb channel (the same exclusivity
        # StitchConfig enforces for with_color): the normals pass below
        # would silently OVERWRITE the attached color, wasting the color
        # work and handing consumers normals labeled as rgb
        raise ValueError("stitch_step got a colors array but "
                         "cfg.with_normals is set — normals and color "
                         "both ride the rgb channel; drop one")

    depths = decimate_depth(depths, cfg.decimation)
    if cfg.decimation > 1:
        # decimated pixel (u, v) is original pixel (u*s, v*s):
        # (u - ppx/s) / (fx/s) == (u*s - ppx) / fx, so scale the intrinsics
        s0 = float(cfg.decimation)
        intr = intr.replace(fx=intr.fx / s0, fy=intr.fy / s0,
                            ppx=intr.ppx / s0, ppy=intr.ppy / s0,
                            width=cfg.width // cfg.decimation,
                            height=cfg.height // cfg.decimation)
    if colors is not None and color_intr is not None:
        # non-aligned color: map by projecting 3-D points into the color
        # camera, so depth decimation needs no color-side counterpart
        raw = deproject(depths, intr, depth_scale=cfg.depth_scale,
                        z_min=cfg.z_min, z_max=cfg.z_max)
        raw = map_color(raw, colors, color_intr,
                        jnp.eye(4, dtype=jnp.float32) if color_ext is None
                        else color_ext)
    elif colors is not None:
        colors = colors[..., ::cfg.decimation, ::cfg.decimation, :] \
            if cfg.decimation > 1 else colors
        raw = deproject_with_color(depths, colors, intr,
                                   depth_scale=cfg.depth_scale,
                                   z_min=cfg.z_min, z_max=cfg.z_max)
    else:
        raw = deproject(depths, intr, depth_scale=cfg.depth_scale,
                        z_min=cfg.z_min, z_max=cfg.z_max)

    if cam_mask is not None:
        raw = raw.replace(mask=raw.mask & cam_mask[:, None])

    points_in = jnp.sum(raw.mask)
    h = cfg.height // cfg.decimation
    w = cfg.width // cfg.decimation

    if cfg.with_normals:
        # full-resolution grid normals ride the rgb channel as unit floats
        # (sensor frame here; _stitch_tail rotates them to world with the
        # refined extrinsics and quantizes them for the packed voxel sort).
        # Pixels without a valid normal (holes, depth edges, grid border)
        # keep their point but carry a zero normal: zeros only shorten the
        # voxel's mean — the renormalized direction is untouched.
        nrm_full, _ = grid_normals(raw.xyz.reshape(ncam, h, w, 3),
                                   raw.mask.reshape(ncam, h, w))
        raw = raw.replace(rgb=nrm_full.reshape(ncam, -1, 3))

    # ICP clouds from a grid-stride subsample (cheap, preserves spatial
    # uniformity) + a small voxel pass — not a full-resolution voxel grid
    s = cfg.icp_stride
    sub_xyz = raw.xyz.reshape(ncam, h, w, 3)[:, ::s, ::s]
    sub_mask = raw.mask.reshape(ncam, h, w)[:, ::s, ::s]
    sub_rgb = None
    if cfg.icp_enabled and cfg.icp_variant == "point_to_plane":
        # normals from the strided organised grid ride the voxel pass in the
        # rgb channels (centroid-averaged, renormalised at the solver)
        nrm, nvalid = grid_normals(sub_xyz, sub_mask)
        sub_mask = sub_mask & nvalid
        sub_rgb = nrm.reshape(ncam, -1, 3)
    sub = PointCloud(xyz=sub_xyz.reshape(ncam, -1, 3),
                     mask=sub_mask.reshape(ncam, -1), rgb=sub_rgb)
    return _stitch_tail(cfg, raw, extrinsics, points_in, sub, out_leaf)


def stitch_points_step(cfg: StitchConfig, extrinsics: jax.Array,
                       clouds: PointCloud,
                       cam_mask: Optional[jax.Array] = None,
                       out_leaf: Optional[jax.Array] = None) -> StitchOutput:
    """Stitch pre-deprojected per-camera point clouds (legacy interop mode).

    For reference-protocol camera servers that deproject on the camera node
    and send packed int16-mm points (reference: src/pcs-camera-server.cpp
    pack loop — SURVEY.md §3.1). clouds: camera-batched [ncam, P, 3] + mask,
    in sensor frames.
    """
    ncam = cfg.num_cameras
    assert clouds.xyz.shape[0] == ncam
    if cam_mask is not None:
        clouds = clouds.replace(mask=clouds.mask & cam_mask[:, None])
    points_in = jnp.sum(clouds.mask)
    s = cfg.icp_stride * cfg.icp_stride  # match the depth path's area ratio
    sub = PointCloud(xyz=clouds.xyz[:, ::s], mask=clouds.mask[:, ::s])
    return _stitch_tail(cfg, clouds, extrinsics, points_in, sub, out_leaf)


class StitchingPipeline:
    """Stateful convenience wrapper: holds config + calibration, jits the step.

    Extrinsic update modes (what happens to the per-camera transforms after
    each frame's ICP drift correction):

      * 'anchored' (default): the calibrated .cal extrinsics stay frozen and
        every frame's correction is computed fresh from them. Stateless —
        per-frame ICP noise cannot accumulate (accumulating corrections on a
        static scene random-walks away from truth at ~sqrt(frames)).
      * 'track': feed refined extrinsics back as the next frame's base —
        follows real mechanical drift but integrates ICP noise.
      * 'ema': exponential blend toward the refined transforms (SE(3)
        polar-projected) — tracks slow drift with bounded noise gain.
    """

    def __init__(self, cfg: StitchConfig, intr: Intrinsics,
                 extrinsics: jax.Array, update_mode: str = "anchored",
                 ema_alpha: float = 0.05,
                 color_intr: Optional[Intrinsics] = None,
                 color_ext: Optional[jax.Array] = None):
        """color_intr/color_ext: per-camera color-stream calibration for
        non-aligned color (texture mapping — see stitch_step); required when
        cfg.color_height is set."""
        if update_mode not in ("anchored", "track", "ema"):
            raise ValueError(update_mode)
        if cfg.color_height is not None and color_intr is None:
            raise ValueError("cfg.color_height set but no color_intr given")
        self.cfg = cfg
        self.intr = intr
        self.color_intr = color_intr
        self.color_ext = (None if color_ext is None
                          else jnp.asarray(color_ext, jnp.float32))
        self.extrinsics = jnp.asarray(extrinsics, jnp.float32)
        self.update_mode = update_mode
        self.ema_alpha = ema_alpha
        self._step = jax.jit(partial(stitch_step, cfg))
        self._points_step = jax.jit(partial(stitch_points_step, cfg))
        from ..ops.se3 import se3_blend
        self._blend = jax.jit(se3_blend)
        # adaptive output resolution (cfg.out_leaf_autofit): the leaf is a
        # device scalar fed back frame to frame, like the extrinsics — the
        # controller runs on device, no host sync, no recompile (the leaf
        # is a traced operand of the step)
        self.out_leaf = None
        self._leaf_ctrl = None
        if cfg.out_leaf_autofit:
            self.out_leaf = jnp.float32(cfg.out_voxel_leaf)
            self._leaf_ctrl = jax.jit(partial(
                autofit_out_leaf, capacity=cfg.out_capacity,
                floor=cfg.out_voxel_leaf, ceil=cfg.out_leaf_max))

    def _update(self, refined: jax.Array) -> None:
        if not self.cfg.icp_enabled or self.update_mode == "anchored":
            return
        if self.update_mode == "track":
            self.extrinsics = refined
        else:
            self.extrinsics = self._blend(self.extrinsics, refined,
                                          self.ema_alpha)

    def __call__(self, depths, colors=None, cam_mask=None) -> StitchOutput:
        out = self._step(self.intr, self.extrinsics, depths, colors, cam_mask,
                         self.color_intr, self.color_ext, self.out_leaf)
        self._update(out.extrinsics)
        self._update_leaf(out)
        return out

    def step_points(self, xyz, point_mask, rgb=None,
                    cam_mask=None) -> StitchOutput:
        """Stitch pre-deprojected clouds (legacy reference-protocol mode)."""
        rgb_f = None if rgb is None else rgb.astype(jnp.float32)
        clouds = PointCloud(xyz=xyz, mask=point_mask, rgb=rgb_f)
        out = self._points_step(self.extrinsics, clouds, cam_mask,
                                self.out_leaf)
        self._update(out.extrinsics)
        self._update_leaf(out)
        return out

    def _update_leaf(self, out: StitchOutput) -> None:
        if self._leaf_ctrl is not None:
            self.out_leaf = self._leaf_ctrl(out.metrics.points_out,
                                            self.out_leaf)
