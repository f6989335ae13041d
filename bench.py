"""Benchmark: 8-camera full pipeline on one NVIDIA GPU (BASELINE config 5).

    python bench.py

Prints ONE JSON line:
  metric: stitched points/sec on the 8-cam 848x480 pipeline with >=5 ICP
          iterations per camera pair per frame.
  vs_baseline: ratio to the reference's implied design point — 8 cameras x
          848x480 x 30 FPS = 97.7M points/s (BASELINE.md: the reference
          publishes no concrete numbers).
  device: platform, device_kind, device count, and the card's name and
          power limit as nvidia-smi reports them.

Every device time ends in jax.block_until_ready. Exits non-zero when JAX
finds no GPU, and when any phase fails.
"""
from __future__ import annotations

import json
import time

import numpy as np

from chip_smoke import card_line, require_gpu, timed, tsdf_scene


def _make_stream_rig(ncam: int, h: int, w: int):
    """Loopback-rig setup for the streaming bench: flagship StitchConfig,
    intrinsics/extrinsics, fake servers (snappy when the native codec
    builds), and a started client. Returns (client, servers, codec)."""
    from pointcloud_stitching_tpu import Intrinsics
    from pointcloud_stitching_tpu.models import StitchingPipeline
    from pointcloud_stitching_tpu.runtime import (Codec, FakeCameraServer,
                                                  MulticameraClient,
                                                  synthetic_frames)
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    codec = Codec.RAW
    try:
        from pointcloud_stitching_tpu.native import snappy as _sn
        _sn.compress(b"probe")  # builds the ctypes lib on first use
        codec = Codec.SNAPPY
    except Exception:
        pass

    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       cam_voxel_leaf=0.01, cam_capacity=131072,
                       out_voxel_leaf=0.01, out_capacity=262144,
                       icp_enabled=True, icp_stride=6, icp_voxel_leaf=0.07,
                       icp_capacity=2048, icp_iterations=5,
                       icp_max_corr_dist=0.1,
                       icp_query_tile=1024, icp_ref_tile=4096)
    i0 = Intrinsics.create(fx=421.5, fy=421.1, ppx=w / 2.0, ppy=h / 2.0,
                           width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1))
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    for i in range(ncam):
        ext[i, :3, 3] = np.array([0.1 * i, -0.05 * i, 0.02 * i], np.float32)

    servers = [FakeCameraServer(synthetic_frames(8, h, w, seed=s),
                                codec=codec).start()
               for s in range(ncam)]
    client = MulticameraClient(
        [("127.0.0.1", s.port) for s in servers],
        StitchingPipeline(cfg, intr, ext)).start()
    return client, servers, codec


def _stream_bench(ncam: int, h: int, w: int, rounds: int = 4,
                  frames: int = 20) -> dict:
    """End-to-end loopback streaming: TCP recv -> decompress -> snapshot
    -> overlapped H2D -> stitch -> sync, on one rig, alternating windows
    synced every frame (true per-frame latency) with pipelined windows
    (sync_every=8, sustainable throughput). Medians over the windows."""
    client, servers, codec = _make_stream_rig(ncam, h, w)
    try:
        if not client.wait_for_first_frames(timeout=20):
            raise RuntimeError("no frames from loopback servers")
        client.step()  # compile outside the timed windows
        fps_sync, fps_pipe, p50s = [], [], []
        stages_sync = stages_pipe = None
        for _ in range(rounds):
            client.stages.reset()
            client.metrics.reset()
            s = client.run(num_frames=frames, overlap=True).summary()
            fps_sync.append(s["fps"])
            p50s.append(s["p50_latency_ms"])
            stages_sync = client.stages.summary()
            client.stages.reset()
            t0 = time.perf_counter()
            client.run(num_frames=frames, overlap=True, sync_every=8)
            fps_pipe.append(frames / (time.perf_counter() - t0))
            stages_pipe = client.stages.summary()
        return {
            "fps_e2e": float(np.median(fps_sync)),
            "fps_e2e_windows": fps_sync,
            "fps_e2e_pipelined": float(np.median(fps_pipe)),
            "fps_e2e_pipelined_windows": fps_pipe,
            "p50_latency_ms_e2e": float(np.median(p50s)),
            "codec": codec.name.lower(),
            "stages_ms": stages_sync,            # last per-frame-sync window
            "stages_ms_pipelined": stages_pipe,  # last sync_every=8 window
        }
    finally:
        client.stop()
        for srv in servers:
            srv.stop()


def _tsdf_bench() -> dict:
    """TSDF block: 4x848x480 analytic depth (three spheres + two planes, one
    dead rectangle per camera) into a 256^3 1-cm volume — integrate dense
    (the 'auto' method) and one-hot ('mxu_xla', checked bitwise against
    dense), a colored integrate, the prior-window and full raycast, and
    frame-to-model track."""
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.models import tsdf as M

    i1, exts, dm = tsdf_scene()
    ncam, h, w = dm.shape
    ext = jnp.asarray(exts)
    depth = jnp.asarray((dm * 1000.0).astype(np.uint16))
    intr = i1.stack([i1] * (ncam - 1))
    grid, origin, leaf = (256, 256, 256), (-1.28, -0.6, 0.2), 0.01
    rng = np.random.default_rng(2)
    color = jnp.asarray(rng.integers(0, 256, (ncam, h, w, 3),
                                     dtype=np.uint8))
    res = {"grid": "256^3 @ 1 cm", "frame": f"{ncam}x{w}x{h} u16"}

    def integ(method, with_rgb):
        state = {"v": M.TSDFVolume.create(grid, leaf, origin=origin,
                                          with_rgb=with_rgb)}

        def step():
            state["v"] = M.integrate(
                state["v"], depth, intr, ext, method=method,
                color=color if with_rgb else None)
            return state["v"].tsdf

        return step

    for method in ("dense", "mxu_xla"):
        res[f"integrate_ms_{method}"] = timed(integ(method, False), 5) * 1e3
        res[f"integrate_ms_{method}_rgb"] = timed(integ(method, True),
                                                  3) * 1e3
    vol = M.integrate(M.TSDFVolume.create(grid, leaf, origin=origin),
                      depth, intr, ext, method="dense")
    vm = M.integrate(M.TSDFVolume.create(grid, leaf, origin=origin),
                     depth, intr, ext, method="mxu_xla")
    if not (np.array_equal(np.asarray(vol.tsdf), np.asarray(vm.tsdf))
            and np.array_equal(np.asarray(vol.weight),
                               np.asarray(vm.weight))):
        raise AssertionError("mxu_xla integrate differs from dense")
    T0, d0 = ext[0], depth[0]
    res["raycast_prior_ms"] = timed(lambda: M.raycast(
        vol, i1, T0, stride=2, prior_depth=d0).depth) * 1e3
    res["raycast_full_ms"] = timed(lambda: M.raycast(
        vol, i1, T0, stride=2).depth) * 1e3
    res["track_ms"] = timed(lambda: M.track(
        vol, d0, i1, T0, prior_window=0.3).T, 3) * 1e3
    return res


def main():
    devs = require_gpu(1)
    card = card_line()
    from pointcloud_stitching_tpu.utils.platform import (
        setup_compilation_cache)
    setup_compilation_cache()
    import dataclasses
    from functools import partial

    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _flagship
    from pointcloud_stitching_tpu.models import autofit_out_leaf, stitch_step
    from pointcloud_stitching_tpu.runtime import synthetic_frames

    ncam, h, w = 8, 480, 848
    cfg, intr, ext, depths = _flagship(ncam, h, w)
    fn = jax.jit(partial(stitch_step, cfg))

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(intr, ext, depths))
    compile_s = time.perf_counter() - t0

    # steady state, streaming mode: refined extrinsics feed back each frame
    frames = 30
    ext_cur = out.extrinsics
    for _ in range(4):
        out = fn(intr, ext_cur, depths)
        ext_cur = out.extrinsics
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(frames):
        out = fn(intr, ext_cur, depths)
        ext_cur = out.extrinsics
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / frames
    voxels = int(out.metrics.points_out)

    pts_per_frame = ncam * h * w
    pps = pts_per_frame / dt
    design_point = 8 * 848 * 480 * 30  # reference's implied realtime target

    # 16 cameras on the same card, and the colored 8-cam frame (RGB through
    # the packed voxel sort)
    cfg16, intr16, ext16, depths16 = _flagship(16, h, w)
    fn16 = jax.jit(partial(stitch_step, cfg16))
    dt16 = timed(lambda: fn16(intr16, ext16, depths16), 15)

    cfg8c = dataclasses.replace(cfg, with_color=True)
    rng = np.random.default_rng(1)
    colors8 = jnp.asarray(rng.integers(0, 256, (ncam, h, w, 3),
                                       dtype=np.uint8))
    fn8c = jax.jit(partial(stitch_step, cfg8c))
    dt8c = timed(lambda: fn8c(intr, ext_cur, depths, colors8), 15)

    # structured-scene row. The flagship scene above is max-entropy
    # (uniform random depths): the worst case for the sort/reduce, and it
    # saturates the output grid by construction. This row runs the smooth
    # synthetic_frames surfaces (what the streaming bench ships over TCP)
    # through the SAME compiled pipeline with the output leaf as a traced
    # operand + the autofit controller — the grid desaturates in a handful
    # of frames with zero recompiles, and the steady state is measured at
    # the converged leaf.
    sd = jnp.asarray(np.stack([synthetic_frames(1, h, w, seed=s)[0]
                               for s in range(ncam)]))
    ctrl = jax.jit(partial(autofit_out_leaf, capacity=cfg.out_capacity,
                           floor=cfg.out_voxel_leaf, ceil=0.04))
    leaf = jnp.float32(cfg.out_voxel_leaf)
    frames_to_fit = None
    for i in range(12):
        out_s = fn(intr, ext, sd, out_leaf=leaf)
        n = int(out_s.metrics.points_out)  # convergence probe, untimed
        leaf = ctrl(out_s.metrics.points_out, leaf)
        if frames_to_fit is None and n < cfg.out_capacity:
            frames_to_fit = i + 1
    dt_s = timed(lambda: fn(intr, ext, sd, out_leaf=leaf), 15)
    n_struct = int(fn(intr, ext, sd, out_leaf=leaf).metrics.points_out)

    # host-side ground truth for the saturation claims: occupied 1-cm
    # voxels of both scenes (numpy; the device grid is capacity-bounded so
    # it cannot report this itself)
    def occupied_1cm(d):
        zs = d.astype(np.float32) * 0.001
        u = np.arange(w, dtype=np.float32) - w / 2.0
        v = np.arange(h, dtype=np.float32) - h / 2.0
        pts = []
        for i in range(ncam):
            z = zs[i]
            m = (z > 0.1) & (z < 10.0)
            p = np.stack([(u[None, :] * z) / 421.5, (v[:, None] * z) / 421.1,
                          z], -1)[m]
            pts.append(p @ np.asarray(ext)[i, :3, :3].T
                       + np.asarray(ext)[i, :3, 3])
        ijk = np.floor(np.concatenate(pts) / 0.01).astype(np.int64)
        ijk -= ijk.min(axis=0)
        key = ((ijk[:, 0] * (ijk[:, 1].max() + 1) + ijk[:, 1])
               * (ijk[:, 2].max() + 1) + ijk[:, 2])
        return int(np.unique(key).size)

    occ_flagship = occupied_1cm(np.asarray(depths))
    occ_struct = occupied_1cm(np.asarray(sd))

    # p50 latency at 4 cameras (BASELINE metric): one synced frame each
    cfg4, intr4, ext4, depths4 = _flagship(4, h, w)
    fn4 = jax.jit(partial(stitch_step, cfg4))
    jax.block_until_ready(fn4(intr4, ext4, depths4))
    lats = []
    for _ in range(20):
        t = time.perf_counter()
        jax.block_until_ready(fn4(intr4, ext4, depths4))
        lats.append(time.perf_counter() - t)
    p50 = float(np.median(lats) * 1e3)

    # end-to-end streaming: loopback fake servers -> TCP ingest ->
    # pipelined H2D/compute overlap -> stitch, 4 cameras at 848x480 with
    # the native snappy codec when it builds
    stream = _stream_bench(ncam=4, h=h, w=w)
    tsdf = _tsdf_bench()

    print(json.dumps({
        "metric": "stitched points/sec (8cam 848x480, 5 ICP iters/pair/frame)",
        "value": round(pps, 0),
        "unit": "points/s",
        "vs_baseline": round(pps / design_point, 3),
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs),
                   "card": card},
        "extras": {
            "frame_time_ms_8cam": dt * 1e3,
            "fps_8cam": 1.0 / dt,
            "p50_latency_ms_4cam": p50,
            "compile_s": compile_s,
            # the max-entropy scene occupies more voxels than out_capacity
            # by construction (occupied_1cm_voxels below), so the fused
            # output sits exactly at capacity — the worst case for the
            # sort/reduce. The *_structured row is the realistic
            # counterpart and is unsaturated (autofit-converged leaf).
            "fused_voxels": voxels,
            "fused_voxels_at_capacity": voxels >= cfg.out_capacity,
            "occupied_1cm_voxels": {"flagship_scene": occ_flagship,
                                    "structured_scene": occ_struct},
            "frame_time_ms_8cam_structured": dt_s * 1e3,
            "fps_8cam_structured": 1.0 / dt_s,
            "fused_voxels_structured": n_struct,
            "structured_unsaturated": n_struct < cfg.out_capacity,
            "out_leaf_structured_m": float(leaf),
            "autofit_frames_to_fit": frames_to_fit,
            "frame_time_ms_16cam": dt16 * 1e3,
            "fps_16cam": 1.0 / dt16,
            "pps_16cam": 16 * h * w / dt16,
            "frame_time_ms_8cam_colored": dt8c * 1e3,
            "fps_8cam_colored": 1.0 / dt8c,
            "streaming_4cam": stream,
            "tsdf": tsdf,
        },
    }))


if __name__ == "__main__":
    main()
