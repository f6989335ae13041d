"""Child process for test_multihost: one capture host in a 2-host DCN rig.

Each "host" ingests its own cameras, voxel-downsamples locally, and only the
fused, downsampled cloud crosses DCN (SURVEY.md §2.5 host<->host tier) —
here via a real jax.distributed process_allgather between two localhost
processes (Gloo over TCP, the CPU stand-in for DCN).
"""
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
# 4 virtual devices per process -> an 8-device global mesh across 2 hosts,
# so part 2 can shard the camera axis over a genuinely multi-process mesh
flags = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
               os.environ.get("XLA_FLAGS", ""))
os.environ["XLA_FLAGS"] = (
    flags + " --xla_force_host_platform_device_count=4").strip()


def main() -> None:
    pid, port = int(sys.argv[1]), sys.argv[2]
    from pointcloud_stitching_tpu.parallel import init_multihost

    assert init_multihost(coordinator=f"127.0.0.1:{port}",
                          num_processes=2, process_id=pid)
    import jax
    import numpy as np

    assert jax.process_count() == 2
    # global devices = both hosts' local devices (local count depends on
    # whether the caller forced a virtual multi-device CPU platform)
    assert len(jax.devices()) == 2 * len(jax.local_devices())

    # local half of the rig: this host's cameras -> local voxel downsample
    from pointcloud_stitching_tpu import PointCloud
    from pointcloud_stitching_tpu.ops import voxel_downsample

    rng = np.random.default_rng(pid)
    xyz = rng.uniform(pid, pid + 1, (4096, 3)).astype(np.float32)
    local = voxel_downsample(PointCloud.from_points(xyz, capacity=4096),
                             0.25, capacity=1024)

    # only the downsampled cloud crosses DCN
    from jax.experimental import multihost_utils

    fused_xyz = multihost_utils.process_allgather(np.asarray(local.xyz))
    fused_mask = multihost_utils.process_allgather(np.asarray(local.mask))
    assert fused_xyz.shape == (2, 1024, 3)
    pts = fused_xyz[fused_mask]
    # both hosts' disjoint unit cubes must be present in the fused cloud
    assert (pts.min(0) < 0.5).all() and (pts.max(0) > 1.5).all(), pts

    # ---- part 2: the sharded stitcher ACROSS processes ----
    # Camera axis laid over a global mesh spanning both hosts' devices (the
    # SURVEY.md §2.5 DCN-tier configuration proper): GSPMD decides which
    # collectives cross the process boundary. Inputs are identical on both
    # hosts (seeded), device_put with a cross-process NamedSharding places
    # each host's camera shards; parity is asserted against a process-local
    # single-device run of the same step.
    from functools import partial

    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from pointcloud_stitching_tpu import Intrinsics
    from pointcloud_stitching_tpu.models.stitcher import stitch_step
    from pointcloud_stitching_tpu.parallel import (make_mesh,
                                                   make_sharded_stitch)
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    ncam = len(jax.devices())              # one camera per global device
    h, w = 60, 106
    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       cam_voxel_enabled=True,
                       cam_voxel_leaf=0.03, cam_capacity=8192,
                       out_voxel_leaf=0.03, out_capacity=65536,
                       icp_enabled=True, icp_voxel_leaf=0.06,
                       icp_capacity=512, icp_iterations=2,
                       icp_max_corr_dist=0.3, icp_trim_fraction=0.0,
                       icp_query_tile=256, icp_ref_tile=256,
                       kernel_impl="xla")
    i0 = Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2.0, ppy=h / 2.0,
                           width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1))
    srng = np.random.default_rng(0)        # same scene on both hosts
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    ext[:, :3, 3] = srng.uniform(-0.2, 0.2, (ncam, 3)).astype(np.float32)
    depths = srng.integers(200, 4000, size=(ncam, h, w), dtype=np.uint16)

    mesh = make_mesh(ncam)
    assert len({d.process_index for d in mesh.devices.flat}) == 2, \
        "mesh does not span both processes"
    cam = NamedSharding(mesh, P("cam"))

    def to_global(x):
        # same-on-all-hosts numpy -> global sharded array (each process
        # fills the shards it can address)
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, cam, lambda idx: x[idx])

    g_intr = jax.tree.map(to_global, intr)
    g_ext = to_global(ext)
    g_depths = to_global(depths)

    fn = make_sharded_stitch(cfg, mesh)
    out = fn(g_intr, g_ext, g_depths)
    jax.block_until_ready(out.cloud.xyz)
    assert out.cloud.xyz.sharding.is_fully_replicated

    # outputs are replicated, but a multi-process array still can't be read
    # with np.asarray from one process — read this host's shard copy
    def host_read(garr):
        return np.asarray(garr.addressable_shards[0].data)

    ref = jax.jit(partial(stitch_step, cfg))(intr, jnp.asarray(ext),
                                             jnp.asarray(depths))
    a = host_read(out.cloud.xyz)[host_read(out.cloud.mask)]
    b = np.asarray(ref.cloud.xyz)[np.asarray(ref.cloud.mask)]
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_allclose(np.sort(a, axis=0), np.sort(b, axis=0),
                               atol=1e-4)
    # refined extrinsics stay camera-sharded: check every shard this host
    # can address against the matching rows of the local reference
    ref_ext = np.asarray(ref.extrinsics)
    for sh in out.extrinsics.addressable_shards:
        np.testing.assert_allclose(np.asarray(sh.data), ref_ext[sh.index],
                                   atol=1e-4)
    n_out = int(host_read(out.metrics.points_out))
    assert 0 < n_out < cfg.out_capacity        # unsaturated, like the dryrun
    assert n_out == int(ref.metrics.points_out)

    print(f"MULTIHOST_OK {pid} fused={int(fused_mask.sum())} "
          f"stitched={n_out}", flush=True)


if __name__ == "__main__":
    main()
