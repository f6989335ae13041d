"""Multi-host (DCN) initialization for capture rigs spanning machines.

SURVEY.md §2.5 host↔host tier: each capture host runs its own ingest and
feeds its local devices; only fused, downsampled clouds cross DCN (which the
shard_map stitch's all_gather already expresses — under multi-host JAX the
same collective rides DCN between hosts and NVLink within them).

This is a thin, documented wrapper over jax.distributed so a multi-host
launch is one call per process:

    from pointcloud_stitching_tpu.parallel import init_multihost, make_mesh
    init_multihost(coordinator="10.0.0.1:9999",
                   num_processes=2, process_id=int(os.environ["RANK"]))
    mesh = make_mesh()          # now spans every host's devices

Single-process use is a no-op (returns False), so the same entry point
works on one machine and on a rig.
"""
from __future__ import annotations

from typing import Optional


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> bool:
    """Initialize jax.distributed when multi-host args are provided.

    Returns True when distributed mode was initialized. With no arguments,
    falls back to environment-driven auto-detection (JAX_COORDINATOR_ADDRESS
    etc.) and returns False if none is configured.
    """
    import os

    import jax

    if coordinator is None:
        coordinator = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id)
    return True
