"""shard_map sharded stitching: Pallas kernels stay active per device.

The pjit path (parallel/mesh.py) lets GSPMD partition the program but must
force the XLA kernel backend — Pallas custom calls have no partitioning
rule. Under ``jax.shard_map`` each device executes *local* code on its own
camera shard, so the Pallas NN kernel runs unmodified per device, and the
cross-device dataflow is explicit (SURVEY.md §2.5):

  * deproject / ICP-cloud prep / per-camera voxel: device-local,
  * ring drift correction: each device's first camera needs the LAST
    camera cloud of the previous device — one ``ppermute`` around the ring,
  * the (tiny) per-pair corrections are ``all_gather``-ed so every device
    computes the same global prefix composition,
  * per-device world clouds are voxel-bounded then ``all_gather``-ed
    (only ~cam_capacity points per camera cross the wire, never raw
    frames); the final fused voxel pass is replicated.

Requires cfg.cam_voxel_enabled (it bounds the gathered bytes) and
num_cameras divisible by the mesh size. Both icp_variant values are
honoured: point-to-plane carries the (voxel-averaged) grid normals across
the ring ppermute together with the boundary cloud.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.stitcher import (StitchMetrics, StitchOutput,
                               _compose_ring_corrections)
from ..ops.deproject import deproject
from ..ops.icp import icp_batched, icp_point_to_plane_batched
from ..ops.normals import grid_normals
from ..ops.se3 import mm, se3_apply
from ..ops.voxel import voxel_downsample
from ..utils.config import StitchConfig
from ..utils.types import Intrinsics, PointCloud


def make_shardmap_stitch(cfg: StitchConfig, mesh: Mesh, axis: str = "cam"):
    """Build a sharded stitch step: (intr, extrinsics, depths) -> StitchOutput.

    intr is camera-batched Intrinsics; extrinsics [ncam,4,4]; depths
    [ncam,H,W]. Outputs are replicated.
    """
    d = mesh.devices.size
    if cfg.num_cameras % d != 0:
        raise ValueError(f"num_cameras={cfg.num_cameras} not divisible by "
                         f"mesh size {d}")
    if not cfg.cam_voxel_enabled:
        cfg = dataclasses.replace(cfg, cam_voxel_enabled=True)
    ncl = cfg.num_cameras // d  # cameras per device

    def local_fn(model, fx, fy, ppx, ppy, coeffs, model_ids, ext_l,
                 depths_l):
        my = jax.lax.axis_index(axis)
        intr_l = Intrinsics(fx=fx, fy=fy, ppx=ppx, ppy=ppy, coeffs=coeffs,
                            model_ids=model_ids,
                            width=cfg.width, height=cfg.height, model=model)
        raw = deproject(depths_l, intr_l, depth_scale=cfg.depth_scale,
                        z_min=cfg.z_min, z_max=cfg.z_max)
        points_in = jax.lax.psum(jnp.sum(raw.mask), axis)

        if not cfg.icp_enabled:
            # parity with stitch_step: frozen extrinsics, zero ICP metrics
            refined_full = jax.lax.all_gather(ext_l, axis).reshape(
                cfg.num_cameras, 4, 4)
            zeros = jnp.zeros((cfg.num_cameras - 1,), jnp.float32)
            return _finish(raw, ext_l, refined_full, points_in,
                           err=zeros, inl=zeros.astype(jnp.int32),
                           loop_err=jnp.float32(0.0))

        h, w = cfg.height, cfg.width
        s = cfg.icp_stride
        sub_xyz = raw.xyz.reshape(ncl, h, w, 3)[:, ::s, ::s]
        sub_mask = raw.mask.reshape(ncl, h, w)[:, ::s, ::s]
        p2l = cfg.icp_variant == "point_to_plane"
        sub_rgb = None
        if p2l:
            nrm, nvalid = grid_normals(sub_xyz, sub_mask)
            sub_mask = sub_mask & nvalid
            sub_rgb = nrm.reshape(ncl, -1, 3)
        sub = PointCloud(xyz=sub_xyz.reshape(ncl, -1, 3),
                         mask=sub_mask.reshape(ncl, -1), rgb=sub_rgb)
        icp_clouds = voxel_downsample(sub, cfg.icp_voxel_leaf,
                                      capacity=cfg.icp_capacity)

        ext_full = ext_l  # [ncl, 4, 4] local extrinsics
        world = icp_clouds.replace(xyz=se3_apply(ext_full, icp_clouds.xyz))

        # predecessor clouds: local shift + ring ppermute for the boundary
        perm = [(i, (i + 1) % d) for i in range(d)]
        prev_xyz = jax.lax.ppermute(world.xyz[ncl - 1], axis, perm)
        prev_mask = jax.lax.ppermute(world.mask[ncl - 1], axis, perm)
        dst_xyz = jnp.concatenate([prev_xyz[None], world.xyz[:-1]], axis=0)
        dst_mask = jnp.concatenate([prev_mask[None], world.mask[:-1]], axis=0)
        closure = cfg.icp_ring_closure and cfg.num_cameras >= 3
        if not closure:
            # chain mode: global camera 0 (chip 0, local 0) has no
            # predecessor — mask its pair out (kabsch returns identity for
            # zero total weight). With closure the wrap-around pair the
            # ppermute already delivers IS the measurement we want.
            anchor = (my == 0)
            dst_mask = dst_mask.at[0].set(
                jnp.where(anchor, False, dst_mask[0]))

        src_world = PointCloud(xyz=world.xyz, mask=world.mask)
        dst_world = PointCloud(xyz=dst_xyz, mask=dst_mask)
        if p2l:
            n = icp_clouds.rgb
            norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
            n = jnp.where(norm > 0.5, n / jnp.maximum(norm, 1e-12), 0.0)
            R = ext_full[:, :3, :3]
            n_world = jnp.einsum("cij,cnj->cni", R, n, precision="highest")
            prev_n = jax.lax.ppermute(n_world[ncl - 1], axis, perm)
            dst_n = jnp.concatenate([prev_n[None], n_world[:-1]], axis=0)
            res = icp_point_to_plane_batched(
                src_world, dst_world, dst_n,
                iterations=cfg.icp_iterations,
                max_corr_dist=cfg.icp_max_corr_dist,
                query_tile=cfg.icp_query_tile, ref_tile=cfg.icp_ref_tile,
                nn_impl=cfg.kernel_impl,
                nn_interpret=cfg.kernel_interpret,
                trim_fraction=cfg.icp_trim_fraction)
        else:
            res = icp_batched(src_world, dst_world,
                              iterations=cfg.icp_iterations,
                              max_corr_dist=cfg.icp_max_corr_dist,
                              query_tile=cfg.icp_query_tile,
                              ref_tile=cfg.icp_ref_tile,
                              nn_impl=cfg.kernel_impl,
                              nn_interpret=cfg.kernel_interpret,
                              trim_fraction=cfg.icp_trim_fraction)
        # gather every device's deltas; all devices compute the same composition
        # (deltas[0] is the ring-closing pair — identity when closure is off,
        # since its dst is fully masked and kabsch then returns identity)
        deltas = jax.lax.all_gather(res.T, axis).reshape(cfg.num_cameras, 4, 4)
        corrections, loop_err = _compose_ring_corrections(
            deltas, closure, gate=cfg.icp_closure_gate,
            gate_rot=cfg.icp_closure_gate_rot)
        refined_full = mm(
            corrections,
            jax.lax.all_gather(ext_l, axis).reshape(cfg.num_cameras, 4, 4))
        refined_l = jax.lax.dynamic_slice_in_dim(refined_full, my * ncl, ncl)

        err = jax.lax.all_gather(res.mean_error, axis).reshape(-1)[1:]
        inl = jax.lax.all_gather(res.num_inliers, axis).reshape(-1)[1:]
        return _finish(raw, refined_l, refined_full, points_in,
                       err=err, inl=inl, loop_err=loop_err)

    def _finish(raw, ext_local, refined_full, points_in, err, inl, loop_err):
        """Shared tail: bounded per-camera world clouds -> all_gather ->
        global voxel -> metrics."""
        cam_clouds = voxel_downsample(raw, cfg.cam_voxel_leaf,
                                      capacity=cfg.cam_capacity)
        world_cams = cam_clouds.replace(
            xyz=se3_apply(ext_local, cam_clouds.xyz))
        g_xyz = jax.lax.all_gather(world_cams.xyz, axis).reshape(-1, 3)
        g_mask = jax.lax.all_gather(world_cams.mask, axis).reshape(-1)
        fused = PointCloud(xyz=g_xyz, mask=g_mask)
        out = voxel_downsample(fused, cfg.out_voxel_leaf,
                               capacity=cfg.out_capacity)
        metrics = StitchMetrics(points_in=points_in,
                                points_out=out.count(),
                                icp_mean_error=err, icp_inliers=inl,
                                loop_error=loop_err)
        return StitchOutput(cloud=out, extrinsics=refined_full,
                            metrics=metrics)

    def _make_sharded(model: int, with_model_ids: bool):
        return jax.shard_map(
            functools.partial(local_fn, model), mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis),
                      P(axis) if with_model_ids else None,
                      P(axis), P(axis)),
            out_specs=StitchOutput(
                cloud=PointCloud(xyz=P(), mask=P(), rgb=None),
                extrinsics=P(),
                metrics=StitchMetrics(points_in=P(), points_out=P(),
                                      icp_mean_error=P(), icp_inliers=P(),
                                      loop_error=P())),
            # outputs ARE replicated (everything downstream of the
            # all_gathers), but the static varying-axis checker can't prove
            # it through the sort/segment machinery; cross-device equality
            # is covered by tests/test_parallel.py instead
            check_vma=False)

    # intr.model is static (changes the traced program), so it keys the jit
    # cache; model_ids is an operand only for MIXED rigs (None cannot ride
    # a P(axis) spec), so its presence keys the shard_map variant.
    _sharded = {}

    def step(intr: Intrinsics, extrinsics, depths):
        key = (intr.model, intr.model_ids is not None)
        if key not in _sharded:
            _sharded[key] = jax.jit(_make_sharded(*key))
        return _sharded[key](intr.fx, intr.fy, intr.ppx, intr.ppy,
                             intr.coeffs, intr.model_ids,
                             extrinsics, depths)

    return step
