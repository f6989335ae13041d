"""Kernel-versus-XLA timings on one NVIDIA GPU, at the shapes that decide
which implementation each op keeps.

    python scripts/gpu_timing.py [--sweep] [--out FILE]

  nn       the Pallas NN kernel (Triton) vs the XLA sweep at the ring-ICP
           shape (8 pairs x 2048 x 2048) and at 131k x 131k, brute force
           and range-pruned; --sweep adds a tile / warp / stage grid
  stitch   stitch_step end to end at the flagship 8-camera frame with the
           NN kernel vs XLA, run in turns (xla, kernel, kernel, xla)
  icp      icp() at 131k points: pruned kernel vs unpruned kernel vs XLA
  reduce   the sorted-id segment sum (jax.ops.segment_sum) of the 8-camera
           fused pass, 3.26 M rows x 8 channels, and the whole voxel pass
  tsdf     integrate at 256^3 with 4x848x480 frames, dense and one-hot

Every time is the median of synced repetitions (jax.block_until_ready)
after a warm-up call. Prints one JSON object as the last line; exits
non-zero without a GPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402


def ms(fn, reps=10):
    return round(C.timed(fn, reps) * 1e3, 4)


def nn_timings(sweep: bool) -> dict:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.kernels import nn_pallas as K
    from pointcloud_stitching_tpu.ops import deproject, se3_apply
    from pointcloud_stitching_tpu.ops import voxel_downsample
    from pointcloud_stitching_tpu.ops.icp import _nn_batched_xla
    from oracle import random_se3

    cfg, intr = C.flagship(8)
    ext = C.ring_extrinsics(8)
    depths = C.room_frames(intr, ext)
    pc = C.icp_clouds(cfg, intr, ext, depths)
    icp_args = (pc.xyz, jnp.roll(pc.xyz, 1, axis=0),
                jnp.roll(pc.mask, 1, axis=0))
    _, intr2 = C.flagship(2)
    cloud = deproject(jnp.asarray(depths[:2]), intr2)
    cloud = cloud.replace(xyz=se3_apply(jnp.asarray(ext[:2]), cloud.xyz)
                          .reshape(-1, 3), mask=cloud.mask.reshape(-1))
    ref = voxel_downsample(cloud, 0.01, capacity=C.NN_REFS)
    qry = se3_apply(jnp.asarray(random_se3(5, 0.02, 0.02)), ref.xyz)
    reg_args = (qry[None], ref.xyz[None], ref.mask[None])

    xla = jax.jit(partial(_nn_batched_xla, query_tile=cfg.icp_query_tile,
                          ref_tile=cfg.icp_ref_tile))
    out = {"icp_shape": {"xla_ms": ms(lambda: xla(*icp_args))},
           "131k": {"xla_ms": ms(lambda: xla(*reg_args), 3)}}
    configs = [(K.QUERY_TILE, K.REF_BLOCK, K.NUM_WARPS, K.NUM_STAGES)]
    if sweep:
        configs += [(qt, rb, nw, ns)
                    for qt in (8, 16, 32) for rb in (128, 256, 512)
                    for nw in (2, 4) for ns in (2, 3)]
    for qt, rb, nw, ns in dict.fromkeys(configs):
        kw = dict(query_tile=qt, ref_block=rb)
        tag = f"q{qt}_r{rb}_w{nw}_s{ns}"

        @jax.jit
        def brute(q, r, m):
            return K.nn_prepared(q, K.prepare_ref(r, m, rb),
                                 num_ref=r.shape[1], num_warps=nw,
                                 num_stages=ns, **kw)
        try:
            out["icp_shape"][tag] = ms(lambda: brute(*icp_args))
            out["131k"][tag] = ms(lambda: brute(*reg_args), 3)
        except Exception as e:          # a config Triton refuses
            out["icp_shape"][tag] = f"error: {type(e).__name__}"
    pruned = jax.jit(K.nearest_neighbors_pruned)
    out["131k"]["pruned_default_ms"] = ms(lambda: pruned(*reg_args))
    return out


def stitch_timings() -> dict:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.models import stitch_step
    from __graft_entry__ import _flagship

    cfg, intr, ext, depths = _flagship(8, C.H, C.W)
    room_ext = jnp.asarray(C.ring_extrinsics(8))
    room = jnp.asarray(C.room_frames(intr, np.asarray(room_ext)))
    fns = {impl: jax.jit(partial(stitch_step,
                                 dataclasses.replace(cfg, kernel_impl=impl)))
           for impl in ("xla", "pallas")}
    res = {}
    for scene, (e, d) in {"max_entropy": (ext, depths),
                          "room": (room_ext, room)}.items():
        t = {"xla": [], "pallas": []}
        for impl in ("xla", "pallas", "pallas", "xla"):
            t[impl].append(ms(lambda: fns[impl](intr, e, d)))
        res[scene] = {f"{k}_ms": v for k, v in t.items()}
    return res


def icp_timings() -> dict:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu import PointCloud
    from pointcloud_stitching_tpu.ops import (deproject, icp, se3_apply,
                                              voxel_downsample)
    from oracle import random_se3

    cfg, intr = C.flagship(2)
    ext = C.ring_extrinsics(8)[:2]
    depths = C.room_frames(intr, ext)
    cloud = deproject(jnp.asarray(depths), intr)
    cloud = cloud.replace(xyz=se3_apply(jnp.asarray(ext), cloud.xyz)
                          .reshape(-1, 3), mask=cloud.mask.reshape(-1))
    dst = voxel_downsample(cloud, 0.01, capacity=C.NN_REFS)
    src = PointCloud(xyz=se3_apply(jnp.asarray(random_se3(7, 0.02, 0.02)),
                                   dst.xyz), mask=dst.mask)
    res = {}
    for tag, kw in {"xla": dict(nn_impl="xla"),
                    "kernel": dict(nn_impl="pallas"),
                    "kernel_pruned": dict(nn_impl="pallas", prune=True)
                    }.items():
        fn = jax.jit(partial(icp, iterations=5, max_corr_dist=0.1, **kw))
        res[f"{tag}_ms"] = ms(lambda: fn(src, dst).T, 3)
    return res


def reduce_timings() -> dict:
    import jax
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.ops import deproject, se3_apply
    from pointcloud_stitching_tpu.ops import voxel_downsample
    from pointcloud_stitching_tpu.ops.voxel import (_reduce_xla,
                                                    _sorted_segments_packed,
                                                    voxel_indices)
    from pointcloud_stitching_tpu.ops.fuse import fuse_batched
    from __graft_entry__ import _flagship

    cfg, intr, ext, depths = _flagship(8, C.H, C.W)
    raw = deproject(depths, intr)
    fused = fuse_batched(raw.replace(xyz=se3_apply(ext, raw.xyz)))
    leaf = jnp.float32(0.01)
    flags, vals, _ = jax.jit(lambda pc: _sorted_segments_packed(
        pc, leaf, voxel_indices(pc.xyz, pc.mask, leaf)))(fused)
    vals8 = jnp.concatenate([vals, jnp.zeros((vals.shape[0], 1))], -1)
    red = jax.jit(partial(_reduce_xla, capacity=cfg.out_capacity))
    vox = jax.jit(partial(voxel_downsample, capacity=cfg.out_capacity))
    return {"rows": int(vals8.shape[0]), "channels": int(vals8.shape[1]),
            "segment_sum_ms": ms(lambda: red(flags, vals8)),
            "voxel_downsample_ms": ms(lambda: vox(fused, leaf))}


def tsdf_timings() -> dict:
    import jax.numpy as jnp
    from pointcloud_stitching_tpu.models import tsdf as M

    i1, exts, dm = C.tsdf_scene()
    intr = i1.stack([i1] * (len(exts) - 1))
    ext = jnp.asarray(exts)
    depth = jnp.asarray((dm * 1000.0).astype(np.uint16))
    res = {}
    for method in ("dense", "mxu_xla"):
        st = {"v": M.TSDFVolume.create(C.TSDF_GRID, C.TSDF_LEAF,
                                       origin=(-1.28, -0.6, 0.2))}

        def step():
            st["v"] = M.integrate(st["v"], depth, intr, ext, method=method)
            return st["v"].tsdf
        res[f"integrate_{method}_ms"] = ms(step, 5)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time a grid of NN kernel launch shapes")
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args(argv)
    devs = C.require_gpu(1)
    from pointcloud_stitching_tpu.utils.platform import (
        setup_compilation_cache)
    setup_compilation_cache()
    card = C.card_line()
    res = {"card": card, "device_kind": devs[0].device_kind,
           "platform": devs[0].platform, "device_count": len(devs)}
    for name, fn in (("nn", lambda: nn_timings(args.sweep)),
                     ("stitch", stitch_timings), ("icp", icp_timings),
                     ("reduce", reduce_timings), ("tsdf", tsdf_timings)):
        res[name] = fn()
        C.log(f"{name}: {json.dumps(res[name])}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
