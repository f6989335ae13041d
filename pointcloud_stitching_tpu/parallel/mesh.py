"""Multi-device execution: camera axis sharded over a device mesh.

Accelerator replacement for the reference's process-per-camera distribution
(reference: one pcs-camera-server per NUC + thread-per-camera in the client —
SURVEY.md §2.4). The camera axis is already a batch dimension in
``stitch_step``; here we lay it over a 1-D ``jax.sharding.Mesh`` so each chip
deprojects/downsamples its own cameras, and XLA's GSPMD partitioner inserts
the device collectives:

  * per-camera deproject + voxel: fully local (no comms),
  * ring-pairwise ICP: the [1:] / [:-1] neighbour slicing becomes a
    collective-permute of each camera's ICP cloud to its ring predecessor,
  * fusion + global voxel grid: an all-gather of the (already downsampled)
    per-camera clouds over the interconnect — only ~cam_capacity points per device cross
    the wire, never raw frames (SURVEY.md §2.5).

This is annotate-shardings-and-let-XLA-partition by design; a hand-written
Pallas ring kernel is only worth it if profiling shows GSPMD's schedule is
the bottleneck.
"""
from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.stitcher import stitch_step
from ..utils.config import StitchConfig


def make_mesh(n_devices: Optional[int] = None, axis: str = "cam") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(
                f"need {n_devices} devices, have {len(devs)} "
                f"({[d.platform for d in devs[:3]]}...)")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def make_sharded_stitch(cfg: StitchConfig, mesh: Mesh, axis: str = "cam"):
    """Jit stitch_step with the camera axis sharded over ``mesh``.

    num_cameras must be a multiple of the mesh size. Output cloud and refined
    extrinsics are replicated (every chip ends the step with the fused cloud,
    so the host can pull it from any one of them).
    """
    import dataclasses
    # a Pallas (Triton) custom call has no GSPMD partitioning rule; under
    # pjit it would silently replicate. Force the XLA path when sharding.
    if cfg.kernel_impl != "xla":
        cfg = dataclasses.replace(cfg, kernel_impl="xla")
    if cfg.num_cameras % mesh.devices.size != 0:
        raise ValueError(
            f"num_cameras={cfg.num_cameras} not divisible by mesh size "
            f"{mesh.devices.size}")
    cam = NamedSharding(mesh, P(axis))
    cam3 = NamedSharding(mesh, P(axis, None, None))

    def step(intr, extrinsics, depths, colors=None, cam_mask=None,
             color_intr=None, color_ext=None, out_leaf=None):
        return stitch_step(cfg, intr, extrinsics, depths, colors, cam_mask,
                           color_intr, color_ext, out_leaf)

    # `cam` as a pytree prefix shards every per-camera Intrinsics field on
    # its leading (camera) axis; depths/colors shard their camera rows the
    # same way. Optional args (colors, per-camera color calibration, the
    # cam_mask — which is replicated: every chip needs every camera's
    # liveness for the ring composition) keep working: None entries are
    # empty pytrees, so their shardings are ignored.
    rep = NamedSharding(mesh, P())
    in_shardings = (
        cam,                                    # intr (prefix → all fields)
        cam3,                                   # extrinsics [ncam, 4, 4]
        cam,                                    # depths [ncam, H, W]
        cam,                                    # colors [ncam, H(c), W(c), 3]
        rep,                                    # cam_mask [ncam]
        cam,                                    # color_intr (prefix)
        cam3,                                   # color_ext [ncam, 4, 4]
        rep,                                    # out_leaf scalar (traced)
    )
    jitted = jax.jit(step, in_shardings=in_shardings)

    def call(intr, extrinsics, depths, colors=None, cam_mask=None,
             color_intr=None, color_ext=None, out_leaf=None):
        # always pass all positions: pjit requires in_shardings to match
        # the call's positional arity (None = empty pytree, sharding unused)
        return jitted(intr, extrinsics, depths, colors, cam_mask,
                      color_intr, color_ext, out_leaf)

    # keep jit introspection available (tests inspect the compiled HLO)
    call.lower = lambda intr, extrinsics, depths, colors=None, \
        cam_mask=None, color_intr=None, color_ext=None, out_leaf=None: \
        jitted.lower(intr, extrinsics, depths, colors, cam_mask, color_intr,
                     color_ext, out_leaf)
    return call


def replicate(mesh: Mesh, x):
    """Explicitly replicate a pytree across the mesh."""
    s = NamedSharding(mesh, P())
    return jax.device_put(x, s)
