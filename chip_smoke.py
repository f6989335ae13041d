"""On-card smoke test: the served stitch path, oracle parity at real widths,
and the TSDF path, on one NVIDIA GPU.

    python chip_smoke.py                # one GPU: every phase below
    python chip_smoke.py --four-cards   # four GPUs: the sharded paths only

Phases (one GPU), in order:
  served   8 fake camera servers (848x480, snappy) -> MulticameraClient ->
           StitchingPipeline at the flagship config, >= 20 stitched frames
  stitch   one 8x848x480 frame through stitch_step (ICP off) vs the numpy
           oracle (deproject -> transform -> voxel grid)
  nn       the NN kernel and the XLA sweep vs exhaustive numpy NN, at the
           ring-ICP shape and at 131k references
  icp      batched ring ICP, per pair, vs the numpy ICP
  tsdf     256^3 @ 1 cm integrate (dense), raycast and track on 4x848x480
           analytic frames; the one-hot integrate bitwise vs dense

Any failed check raises, and the process exits non-zero without printing
the result line. With no GPU it exits non-zero before any phase. The last
line of stdout is one JSON object.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

H, W = 480, 848              # one D400-series depth stream
NN_REFS = 131072             # registration scale (BASELINE config 3)
TSDF_GRID = (256, 256, 256)  # the TSDF block's volume ...
TSDF_LEAF = 0.01             # ... at 1 cm


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def require_gpu(count: int):
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: no GPU (JAX backend is "
                 f"{jax.default_backend()!r}); nothing was run")
    devs = jax.devices()
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX sees {len(devs)}")
    return devs


def timed(fn, reps: int = 5) -> float:
    """Median wall seconds of ``fn()`` after one warm call (synced)."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


# ---------------------------------------------------------------------------
# scenes
# ---------------------------------------------------------------------------

# a 6 m x 6 m room (walls, floor, ceiling) with furniture-sized spheres
ROOM = dict(
    spheres=[((0.0, 0.3, 0.0), 0.5), ((0.9, 0.6, 0.6), 0.35),
             ((-0.8, 0.2, -0.7), 0.4), ((0.4, -0.4, -1.0), 0.3)],
    planes=[((1.0, 0.0, 0.0), 3.0), ((-1.0, 0.0, 0.0), 3.0),
            ((0.0, 0.0, 1.0), 3.0), ((0.0, 0.0, -1.0), 3.0),
            ((0.0, 1.0, 0.0), 1.2), ((0.0, -1.0, 0.0), 2.0)],
)


def ring_extrinsics(ncam: int) -> np.ndarray:
    """Camera->world poses of a rig facing the room's centre.

    Cameras sit 1.5 m from the centre in four directions, ``ncam // 4``
    levels 0.25 m apart, ordered so ring neighbours mostly share a
    direction. Rotations are multiples of 90 degrees and translations are
    short binary fractions, so camera->world products are exact in f32 and
    voxel boundaries land identically on every backend and in the oracle.
    """
    levels = ncam // 4
    ext = np.zeros((ncam, 4, 4), np.float32)
    for i in range(ncam):
        c, s = [(1, 0), (0, 1), (-1, 0), (0, -1)][i // levels]
        ext[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        ext[i, :3, 3] = [-1.5 * s, -0.25 * (i % levels), -1.5 * c]
        ext[i, 3, 3] = 1.0
    return ext


def flagship(ncam: int):
    """The flagship StitchConfig and intrinsics (__graft_entry__)."""
    from __graft_entry__ import _flagship
    cfg, intr, _, _ = _flagship(ncam, H, W)
    return cfg, intr


def room_frames(intr, ext: np.ndarray) -> np.ndarray:
    """[ncam, H, W] uint16 mm depth of ROOM from each pose."""
    from pointcloud_stitching_tpu import Intrinsics
    from test_tsdf import render_depth
    i1 = Intrinsics.create(fx=float(intr.fx[0]), fy=float(intr.fy[0]),
                           ppx=float(intr.ppx[0]), ppy=float(intr.ppy[0]),
                           width=W, height=H)
    return np.stack([np.round(render_depth(i1, T, **ROOM) * 1000.0)
                     .astype(np.uint16) for T in ext])


def oracle_stitch(cfg, intr, ext, depths) -> np.ndarray:
    """numpy deproject -> transform -> concat -> VoxelGrid."""
    from oracle import deproject_np, transform_np, voxel_downsample_np
    pts = []
    for i, d in enumerate(depths):
        xyz, m = deproject_np(d, float(intr.fx[i]), float(intr.fy[i]),
                              float(intr.ppx[i]), float(intr.ppy[i]),
                              depth_scale=cfg.depth_scale,
                              z_min=cfg.z_min, z_max=cfg.z_max)
        pts.append(transform_np(ext[i], xyz[m]))
    return voxel_downsample_np(np.concatenate(pts), cfg.out_voxel_leaf)[0]


def icp_clouds(cfg, intr, ext, depths):
    """World-frame ICP clouds as the stitcher builds them: a grid-stride
    subsample of the deprojected frame, then a per-camera voxel pass."""
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.ops import (deproject, se3_apply,
                                              voxel_downsample)
    ncam, s = len(depths), cfg.icp_stride
    raw = deproject(jnp.asarray(depths), intr, depth_scale=cfg.depth_scale,
                    z_min=cfg.z_min, z_max=cfg.z_max)
    sub = raw.replace(
        xyz=raw.xyz.reshape(ncam, H, W, 3)[:, ::s, ::s].reshape(ncam, -1, 3),
        mask=raw.mask.reshape(ncam, H, W)[:, ::s, ::s].reshape(ncam, -1))
    pc = voxel_downsample(sub, cfg.icp_voxel_leaf, capacity=cfg.icp_capacity)
    return pc.replace(xyz=se3_apply(jnp.asarray(ext), pc.xyz))


# ---------------------------------------------------------------------------
# phases (one GPU)
# ---------------------------------------------------------------------------

def phase_served(card: str, frames: int = 24) -> dict:
    from pointcloud_stitching_tpu.models import StitchingPipeline
    from pointcloud_stitching_tpu.native import snappy
    from pointcloud_stitching_tpu.runtime import (Codec, FakeCameraServer,
                                                  MulticameraClient,
                                                  synthetic_frames)
    snappy.compress(b"probe")   # the native codec must build: no RAW path
    ncam = 8
    cfg, intr = flagship(ncam)
    ext = ring_extrinsics(ncam)
    servers = [FakeCameraServer(synthetic_frames(8, H, W, seed=s),
                                codec=Codec.SNAPPY).start()
               for s in range(ncam)]
    try:
        client = MulticameraClient([("127.0.0.1", s.port) for s in servers],
                                   StitchingPipeline(cfg, intr, ext)).start()
        try:
            assert client.wait_for_first_frames(timeout=60.0), \
                "no frames from the camera servers"
            t0 = time.perf_counter()
            warm = client.step()                     # compiles stitch_step
            compile_s = time.perf_counter() - t0
            assert warm is not None, "warm-up tick stitched nothing"
            client.metrics.reset()
            client.stages.reset()
            seen = []
            m = client.run(num_frames=frames, overlap=True,
                           on_frame=lambda n, o: seen.append(
                               (o.cam_mask, o.metrics.points_out)))
            summary = m.summary()
            errors = client.camera_errors()
        finally:
            client.stop()
    finally:
        for srv in servers:
            srv.stop()
    cams = np.stack([np.asarray(c) for c, _ in seen])
    pts = np.array([int(p) for _, p in seen])
    assert len(seen) == frames and summary["frames"] == frames, \
        (len(seen), summary)
    assert cams.all(), f"a camera dropped: live counts {cams.sum(1)}"
    assert not errors, errors
    assert (pts > 0).all(), pts
    log(f"served [{card}]: {frames} frames from {ncam} cameras at {W}x{H} "
        f"(snappy), fps {summary['fps']}, p50 {summary['p50_latency_ms']} ms,"
        f" p99 {summary['p99_latency_ms']} ms, compile {compile_s:.1f} s, "
        f"points_out {pts.min()}..{pts.max()}")
    return {"fps": summary["fps"], "p50_ms": summary["p50_latency_ms"]}


def phase_stitch_parity() -> None:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.models import stitch_step
    ncam = 8
    cfg, intr = flagship(ncam)
    # ICP off and a 6 cm output leaf: the grid stays unsaturated, so the
    # voxel count is a real check
    cfg = dataclasses.replace(cfg, icp_enabled=False, out_voxel_leaf=0.06)
    ext = ring_extrinsics(ncam)
    depths = room_frames(intr, ext)
    fn = jax.jit(partial(stitch_step, cfg))
    out = fn(intr, jnp.asarray(ext), jnp.asarray(depths))
    got = np.asarray(out.cloud.xyz)[np.asarray(out.cloud.mask)]
    want = oracle_stitch(cfg, intr, ext, depths)
    n = len(got)
    assert 0 < n < cfg.out_capacity, f"grid empty or saturated: {n}"
    assert n == len(want), f"voxel count {n} != oracle {len(want)}"
    # both sides list voxels in ascending (ix, iy, iz) order (PCL's)
    err = float(np.abs(got - want).max())
    # centroids: f32 sums in scatter order on the card vs float64 sums in
    # the oracle; the golden-stream tolerance
    atol = 2e-4
    assert err <= atol, err
    t = timed(lambda: fn(intr, jnp.asarray(ext), jnp.asarray(depths)))
    log(f"stitch parity: {ncam}x{H}x{W}, ICP off, leaf 6 cm: {n} voxels == "
        f"oracle; max |centroid - oracle| {err:.2e} m (atol {atol:.0e}); "
        f"stitch_step {t * 1e3:.2f} ms")


def _check_nn(tag, idx, d2, q, r, rmask, d2_tol) -> str:
    """idx/d2 of queries ``q`` vs an exhaustive float64 search over the
    valid refs. A differing index is accepted only at a distance tie.

    ``d2_tol = (a, b)`` bounds |d2 - oracle| by a + b * sqrt(oracle d2):
    f32 coordinate differences carry an absolute error proportional to
    the coordinates' magnitude, which the square scales by the distance.
    """
    valid = np.flatnonzero(rmask)
    rv = r[valid].astype(np.float64)
    n_tie = 0
    worst = 0.0
    for s in range(0, len(q), 64):
        qq = q[s:s + 64].astype(np.float64)
        dd = ((qq[:, None, :] - rv[None]) ** 2).sum(-1)
        best = dd.min(1)
        got_i = idx[s:s + 64]
        assert np.isin(got_i, valid).all(), f"{tag}: masked ref returned"
        tol = d2_tol[0] + d2_tol[1] * np.sqrt(best)
        got_d = dd[np.arange(len(qq)), np.searchsorted(valid, got_i)]
        assert (got_d <= best + tol).all(), \
            f"{tag}: returned neighbour is not nearest " \
            f"(excess {float((got_d - best).max()):.3e} m^2)"
        n_tie += int((got_i != valid[dd.argmin(1)]).sum())
        err = np.abs(d2[s:s + 64] - best)
        assert (err <= tol).all(), \
            f"{tag}: |d2 - oracle| {float((err - tol).max()):.3e} over"
        worst = max(worst, float(err.max()))
    return f"{tag}: {len(q)} queries, |d2 - oracle| max {worst:.2e} m^2 " \
           f"(tol {d2_tol[0]:.0e} + {d2_tol[1]:.1e} * d), {n_tie} index " \
           f"differences (all at ties)"


def phase_nn() -> dict:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.kernels.nn_pallas import (
        nearest_neighbors_pallas_batched, nearest_neighbors_pruned)
    from pointcloud_stitching_tpu.ops import voxel_downsample
    from pointcloud_stitching_tpu.ops.icp import _nn_batched_xla
    from pointcloud_stitching_tpu.ops import deproject, se3_apply
    from oracle import random_se3

    ncam = 8
    cfg, intr = flagship(ncam)
    ext = ring_extrinsics(ncam)
    depths = room_frames(intr, ext)
    # kernel: direct f32 differences, each off by <= eps * |coordinate|
    # (coordinates <= 5 m: 3e-7 m per axis), so d2 is off by at most
    # 2 * sqrt(3) * 3e-7 * d ~ 1.1e-6 * d; doubled for margin. XLA:
    # |q|^2 + |r|^2 - 2 q.r, whose cancellation adds ~eps * (|q|^2 + |r|^2)
    # ~ 3e-6 m^2 — 2e-5 leaves margin for the summation order
    tol = {"kernel": (1e-7, 2.4e-6), "xla": (2e-5, 2.4e-6)}
    times = {}

    # ring-ICP shape: 8 pairs x 2048 x 2048 (camera i vs camera i-1)
    pc = icp_clouds(cfg, intr, ext, depths)
    q, qm = pc.xyz, pc.mask
    r, rm = jnp.roll(pc.xyz, 1, axis=0), jnp.roll(pc.mask, 1, axis=0)
    kern = jax.jit(nearest_neighbors_pallas_batched)
    xla = jax.jit(partial(_nn_batched_xla, query_tile=cfg.icp_query_tile,
                          ref_tile=cfg.icp_ref_tile))
    res = {"kernel": kern(q, r, rm), "xla": xla(q, r, rm)}
    qn, qmn, rn, rmn = map(np.asarray, (q, qm, r, rm))
    for name, (idx, d2) in res.items():
        idx, d2 = np.asarray(idx), np.asarray(d2)
        for b in range(ncam):
            sel = qmn[b]
            msg = _check_nn(f"nn[{name}] ICP shape pair {b}", idx[b][sel],
                            d2[b][sel], qn[b][sel], rn[b], rmn[b], tol[name])
        log(msg)
    times["icp_shape_kernel_ms"] = timed(lambda: kern(q, r, rm)) * 1e3
    times["icp_shape_xla_ms"] = timed(lambda: xla(q, r, rm)) * 1e3

    # registration scale: two voxel-sorted 131072-point clouds at 1 cm
    m = NN_REFS
    _, intr2 = flagship(2)
    cloud = deproject(jnp.asarray(depths[:2]), intr2,
                      z_min=cfg.z_min, z_max=cfg.z_max)
    cloud = cloud.replace(xyz=se3_apply(jnp.asarray(ext[:2]), cloud.xyz)
                          .reshape(-1, 3), mask=cloud.mask.reshape(-1))
    ref = voxel_downsample(cloud, 0.01, capacity=m)
    T = jnp.asarray(random_se3(seed=5, max_angle=0.02, max_trans=0.02))
    qry = se3_apply(T, ref.xyz)
    assert int(ref.mask.sum()) == m, "131k cloud not full"
    rb, rmb, qb = ref.xyz[None], ref.mask[None], qry[None]
    pruned = jax.jit(nearest_neighbors_pruned)
    res = {"kernel": kern(qb, rb, rmb), "kernel pruned": pruned(qb, rb, rmb),
           "xla": xla(qb, rb, rmb)}
    sub = np.arange(0, m, m // 1024)                # 1024-query subsample
    for name, (idx, d2) in res.items():
        log(_check_nn(f"nn[{name}] 131k", np.asarray(idx[0])[sub],
                      np.asarray(d2[0])[sub], np.asarray(qry)[sub],
                      np.asarray(ref.xyz), np.asarray(ref.mask),
                      tol["xla" if name == "xla" else "kernel"]))
    times["131k_kernel_ms"] = timed(lambda: kern(qb, rb, rmb), 3) * 1e3
    times["131k_kernel_pruned_ms"] = timed(lambda: pruned(qb, rb, rmb)) * 1e3
    times["131k_xla_ms"] = timed(lambda: xla(qb, rb, rmb), 3) * 1e3
    log("nn times (ms): " + ", ".join(f"{k[:-3]} {v:.3f}"
                                      for k, v in times.items()))
    return times


def phase_icp() -> None:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu import PointCloud
    from pointcloud_stitching_tpu.ops import icp_batched, se3_apply
    from oracle import icp_np, random_se3

    ncam = 8
    cfg, intr = flagship(ncam)
    ext = ring_extrinsics(ncam)
    depths = room_frames(intr, ext)
    pc = icp_clouds(cfg, intr, ext, depths)
    # pair each camera with the one above or below it (same direction,
    # 0.25 m apart): full overlap, so every pair has correspondences
    nb = np.arange(ncam) ^ 1
    dst = PointCloud(xyz=pc.xyz[nb], mask=pc.mask[nb])
    # each source camera knocked off by a small known pose error
    P = jnp.asarray(np.stack([random_se3(seed=30 + i, max_angle=0.02,
                                         max_trans=0.02)
                              for i in range(ncam)]))
    src = PointCloud(xyz=se3_apply(P, pc.xyz), mask=pc.mask)
    kw = dict(iterations=cfg.icp_iterations,
              max_corr_dist=cfg.icp_max_corr_dist, trim_fraction=0.0,
              query_tile=cfg.icp_query_tile, ref_tile=cfg.icp_ref_tile)
    sx, sm, dx, dm = map(np.asarray, (src.xyz, src.mask, dst.xyz, dst.mask))
    want = np.stack([icp_np(sx[b][sm[b]], dx[b][dm[b]],
                            iterations=cfg.icp_iterations,
                            max_corr_dist=cfg.icp_max_corr_dist)
                     for b in range(ncam)])
    # f32 Kabsch on the card vs float64 in the oracle, and a correspondence
    # that flips at a near-tie: 1e-4 on every entry of T (rotation entries
    # are unitless, translation in metres: 0.1 mm)
    atol = 1e-4
    for impl in ("pallas", "xla"):
        got = np.asarray(jax.jit(partial(icp_batched, nn_impl=impl, **kw))(
            src, dst).T)
        err = np.abs(got - want).max(axis=(1, 2))
        assert (err <= atol).all(), (impl, err)
        log(f"icp[{impl}]: {ncam} pairs x {cfg.icp_capacity} points, "
            f"{cfg.icp_iterations} iterations: max |T - oracle| per pair "
            f"{np.array2string(err, precision=1)} (atol {atol:.0e})")


def tsdf_scene():
    """The analytic 4-camera scene of the TSDF block: three spheres, two
    planes, one dead rectangle per camera."""
    from pointcloud_stitching_tpu import Intrinsics
    from test_tsdf import render_depth
    ncam = 4
    f = W / 848.0                       # field of view kept at any width
    i1 = Intrinsics.create(fx=421.5 * f, fy=421.1 * f, ppx=W / 2.0,
                           ppy=H / 2.0, width=W, height=H)
    scene = dict(
        spheres=[((-0.4, 0.1, 1.4), 0.35), ((0.5, -0.2, 1.8), 0.3),
                 ((0.0, 0.45, 1.1), 0.2)],
        planes=[((0.0, 0.0, -1.0), -2.4), ((0.0, -1.0, 0.0), -0.8)],
    )
    exts, ds = [], []
    for i in range(ncam):
        ang = 0.12 * (i - 1.5)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                     [-np.sin(ang), 0, np.cos(ang)]]
        T[:3, 3] = [0.25 * (i - 1.5), 0.0, -0.05 * i]
        exts.append(T)
        d = render_depth(i1, T, **scene)
        d[140 + 30 * i:220 + 30 * i, 280:420] = 0.0     # dead rectangle
        ds.append(d)
    return i1, np.stack(exts), np.stack(ds)


def phase_tsdf() -> dict:
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.models import tsdf as M

    i1, exts, dm = tsdf_scene()
    ncam = len(exts)
    intr = i1.stack([i1] * (ncam - 1))
    ext = jnp.asarray(exts)
    depth = jnp.asarray((dm * 1000.0).astype(np.uint16))
    grid, origin, leaf = TSDF_GRID, (-1.28, -0.6, 0.2), TSDF_LEAF

    def fresh():
        return M.TSDFVolume.create(grid, leaf, origin=origin)

    vol = M.integrate(fresh(), depth, intr, ext, method="dense")
    vmx = M.integrate(fresh(), depth, intr, ext, method="mxu_xla")
    assert np.array_equal(np.asarray(vol.tsdf), np.asarray(vmx.tsdf))
    assert np.array_equal(np.asarray(vol.weight), np.asarray(vmx.weight))
    occ = int(jnp.sum(vol.weight > 0))
    assert occ > 10000, occ

    T0 = ext[0]
    rc = M.raycast(vol, i1, T0)
    valid = np.asarray(rc.valid)
    nrm = np.linalg.norm(np.asarray(rc.normal)[valid], axis=-1)
    assert valid.sum() > 0.1 * H * W, int(valid.sum())     # coverage
    assert abs(nrm.min() - 1) < 1e-3 and abs(nrm.max() - 1) < 1e-3
    sel = valid & (dm[0] > 0)
    dz = np.abs(np.asarray(rc.depth) - dm[0])[sel]
    assert np.median(dz) < 0.004, np.median(dz)

    ang = np.deg2rad(1.2)
    dT = np.eye(4, dtype=np.float32)
    dT[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    dT[:3, 3] = [0.008, -0.006, 0.005]
    res = M.track(vol, depth[0], i1, jnp.asarray(dT) @ T0, prior_window=0.3)
    E = np.linalg.inv(np.asarray(T0, np.float64)) @ np.asarray(res.T)
    ang_err = np.rad2deg(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2,
                                           -1, 1)))
    t_err = float(np.linalg.norm(np.asarray(res.T)[:3, 3]
                                 - np.asarray(T0)[:3, 3]))
    assert ang_err < 0.1 and t_err < 2e-3, (ang_err, t_err)
    log(f"tsdf: 256^3 @ 1 cm, {ncam}x{W}x{H}: {occ} observed voxels, "
        f"mxu_xla bitwise == dense; raycast {int(valid.sum())} hits, "
        f"|n| in [{nrm.min():.5f}, {nrm.max():.5f}], |depth - analytic| "
        f"median {np.median(dz) * 1e3:.3f} mm (< 4), p99 "
        f"{np.percentile(dz, 99) * 1e3:.3f} mm; track from 1.2 deg + 11 mm "
        f"-> {ang_err:.4f} deg / {t_err * 1e3:.3f} mm (< 0.1 deg / 2 mm)")

    state = {"v": fresh()}

    def integ():
        state["v"] = M.integrate(state["v"], depth, intr, ext,
                                 method="dense")
        return state["v"].tsdf

    times = {"integrate_dense_ms": timed(integ) * 1e3,
             "raycast_ms": timed(lambda: M.raycast(vol, i1, T0,
                                                   stride=2).depth) * 1e3,
             "track_ms": timed(lambda: M.track(
                 vol, depth[0], i1, T0, prior_window=0.3).T, 3) * 1e3}
    log("tsdf times (ms): " + ", ".join(f"{k[:-3]} {v:.2f}"
                                        for k, v in times.items()))
    return times


# ---------------------------------------------------------------------------
# four GPUs: the sharded paths and what they are compared with
# ---------------------------------------------------------------------------

def phase_four_cards(ndev: int = 4) -> None:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.models import stitch_step
    from pointcloud_stitching_tpu.models import tsdf as M
    from pointcloud_stitching_tpu.parallel import (make_mesh,
                                                   make_sharded_integrate,
                                                   make_sharded_raycast,
                                                   make_sharded_stitch,
                                                   make_shardmap_stitch,
                                                   shard_volume)
    ncam = 16
    cfg, intr = flagship(ncam)
    # the shard_map path bounds each camera's cloud before the all_gather;
    # both paths and the one-card reference share the config. 6 cm output
    # leaf keeps the grid unsaturated; trim off: its quantile cut is
    # discrete, so a last-bit NN difference could flip a correspondence
    cfg = dataclasses.replace(cfg, cam_voxel_enabled=True,
                              out_voxel_leaf=0.06, icp_trim_fraction=0.0)
    ext = jnp.asarray(ring_extrinsics(ncam))
    depths = jnp.asarray(room_frames(intr, np.asarray(ext)))
    mesh = make_mesh(ndev)
    one = jax.jit(partial(stitch_step, cfg))
    one_xla = jax.jit(partial(stitch_step,
                              dataclasses.replace(cfg, kernel_impl="xla")))
    paths = {"gspmd": (make_sharded_stitch(cfg, mesh), one_xla),
             "shard_map": (make_shardmap_stitch(cfg, mesh), one)}
    for icp_on in (False, True):
        for name, (sharded, single) in paths.items():
            if not icp_on:
                c = dataclasses.replace(cfg, icp_enabled=False)
                sharded = (make_sharded_stitch(c, mesh) if name == "gspmd"
                           else make_shardmap_stitch(c, mesh))
                single = jax.jit(partial(stitch_step, c))
            a = sharded(intr, ext, depths)
            b = single(intr, ext, depths)
            na, nb = int(a.metrics.points_out), int(b.metrics.points_out)
            assert 0 < nb < cfg.out_capacity, nb
            dext = float(np.abs(np.asarray(a.extrinsics)
                                - np.asarray(b.extrinsics)).max())
            if icp_on:
                # ICP on: extrinsics within 1e-4 (last-bit differences in
                # the per-device reductions); the fused cloud then moves by
                # up to that much, so voxel counts are compared to 0.1 %
                assert dext <= 1e-4, (name, dext)
                assert abs(na - nb) <= 1e-3 * nb, (name, na, nb)
                log(f"four-cards [{name}, ICP on]: {ncam}x{H}x{W} over "
                    f"{ndev} GPUs, {na} voxels vs one-card {nb}; max "
                    f"|extrinsics - one-card| {dext:.2e} (atol 1e-4)")
            else:
                assert na == nb, (name, na, nb)
                pa = np.asarray(a.cloud.xyz)[np.asarray(a.cloud.mask)]
                pb = np.asarray(b.cloud.xyz)[np.asarray(b.cloud.mask)]
                err = float(np.abs(pa - pb).max())
                assert err <= 1e-4, (name, err)
                log(f"four-cards [{name}, ICP off]: {ncam}x{H}x{W} over "
                    f"{ndev} GPUs, {na} voxels == one-card; max |centroid "
                    f"- one-card| {err:.2e} m (atol 1e-4)")
    t = {name: timed(lambda: fn(intr, ext, depths)) * 1e3
         for name, fn in (("gspmd", paths["gspmd"][0]),
                          ("shard_map", paths["shard_map"][0]),
                          ("one card", one))}
    log(f"four-cards: {ncam}-camera frame, ICP on (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in t.items()))

    # Z-slab TSDF: integrate bitwise vs the unsharded dense volume, then the
    # halo raycast vs the unsharded raycast
    i1, exts, dm = tsdf_scene()
    intr4 = i1.stack([i1] * (len(exts) - 1))
    depth = jnp.asarray((dm * 1000.0).astype(np.uint16))
    # power-of-two leaf and an origin on its lattice: the slab origins are
    # then exact in f32 and the sharded integrate is bitwise
    grid, origin, leaf = TSDF_GRID, (-1.25, -0.625, 0.25), TSDF_LEAF / 1.28
    ref = M.integrate(M.TSDFVolume.create(grid, leaf, origin=origin),
                      depth, intr4, jnp.asarray(exts), method="dense")
    mesh_z = make_mesh(ndev, axis="z")
    vs = shard_volume(M.TSDFVolume.create(grid, leaf, origin=origin),
                      mesh_z, axis="z")
    vs = make_sharded_integrate(mesh_z, axis="z", method="dense")(
        vs, depth, intr4, jnp.asarray(exts))
    assert np.array_equal(np.asarray(vs.tsdf), np.asarray(ref.tsdf))
    assert np.array_equal(np.asarray(vs.weight), np.asarray(ref.weight))
    T0 = jnp.asarray(exts[0])
    rs = make_sharded_raycast(mesh_z, axis="z")(vs, i1, T0)
    r1 = M.raycast(ref, i1, T0)
    va, vb = np.asarray(rs.valid), np.asarray(r1.valid)
    both = va & vb
    agree = both.sum() / max(vb.sum(), 1)
    dd = np.abs(np.asarray(rs.depth) - np.asarray(r1.depth))[both]
    assert agree > 0.999 and np.median(dd) < 1e-4, (agree, np.median(dd))
    log(f"four-cards [tsdf]: Z-slab 256^3 over {ndev} GPUs, integrate "
        f"bitwise == unsharded dense; halo raycast {int(va.sum())} hits vs "
        f"{int(vb.sum())} unsharded ({agree:.5f} shared), |depth| diff "
        f"median {np.median(dd):.2e} m, max {dd.max():.2e} m")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths, on four GPUs")
    args = ap.parse_args(argv)
    if not __debug__:
        sys.exit("chip_smoke: its checks are asserts; run it without -O")
    count = 4 if args.four_cards else 1
    devs = require_gpu(count)
    card = card_line()
    import jax
    log(card)
    log(f"jax {jax.__version__}, {devs[0].device_kind}, {len(devs)} "
        f"device(s)")
    from pointcloud_stitching_tpu.utils.platform import (
        setup_compilation_cache)
    log(f"compile cache: {setup_compilation_cache()}")
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(count)
    else:
        phase_served(card)
        phase_stitch_parity()
        phase_nn()
        phase_icp()
        phase_tsdf()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
