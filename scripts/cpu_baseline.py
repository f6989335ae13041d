"""Measure the CPU-baseline throughput the ">=10x" north star compares against.

BASELINE.md line 16 demands ">=10x the C++/PCL CPU baseline throughput" but the
reference publishes no numbers (BASELINE.json "published": {}), so the ratio
must be measured on the host CPU, over the same 8-cam 848x480 flagship
workload the GPU bench runs (bench.py). Two baselines:

  * numpy/scipy: the oracle math (tests/oracle.py — the PCL-parity contract)
    with scipy.spatial.cKDTree for NN (what pcl::KdTreeFLANN is), vectorized
    numpy everywhere else. This is an honest "optimized CPU library" path.
  * native C++ (optional, if native/cpu_baseline is built): same pipeline in
    -O3 C++ with a hash-grid voxel filter and a KD-tree — closer to what the
    reference's PCL stack compiles to.

The per-frame work mirrors models/stitcher.stitch_step at the flagship config
(reference dataflow: src/pcs-multicamera-client.cpp render loop, SURVEY.md
§3.2): 8x deproject -> ICP subsample (stride 6, 5 cm voxel) -> 7 pairwise
ICPs x 5 iterations -> transform to world -> concat -> 1 cm global voxel.

Prints one JSON line {"cpu_pps": ..., "frame_ms": ..., ...} and, with
--out, writes it to that file.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_REPO, "tests"))

from oracle import (deproject_np, kabsch_np, synth_depth_frame,  # noqa: E402
                    transform_np, voxel_downsample_np)


def icp_kdtree(src, dst, iterations=5, max_corr_dist=0.1):
    """PCL-style ICP: KD-tree correspondences (cKDTree = KdTreeFLANN's exact
    twin) -> max-distance rejection -> SVD solve -> iterate."""
    from scipy.spatial import cKDTree
    tree = cKDTree(dst)
    T = np.eye(4, dtype=np.float32)
    for _ in range(iterations):
        p = transform_np(T, src)
        d, idx = tree.query(p, workers=-1)
        w = (d <= max_corr_dist).astype(np.float64)
        dT = kabsch_np(p, dst[idx], w)
        T = dT @ T
    return T


def run_frame(depths, intrs, exts, icp_stride=6, icp_leaf=0.05,
              icp_iters=5, icp_max_corr=0.1, out_leaf=0.01):
    """One flagship frame on the CPU. Returns the fused voxel count."""
    ncam = len(depths)
    clouds, masks = [], []
    for d, (fx, fy, ppx, ppy) in zip(depths, intrs):
        xyz, m = deproject_np(d, fx, fy, ppx, ppy, z_min=0.1, z_max=10.0)
        clouds.append(xyz)
        masks.append(m)

    # ICP clouds: grid-stride subsample + small voxel pass (stitcher parity)
    h, w = depths[0].shape
    icp_clouds = []
    for xyz, m in zip(clouds, masks):
        g = xyz.reshape(h, w, 3)[::icp_stride, ::icp_stride].reshape(-1, 3)
        gm = m.reshape(h, w)[::icp_stride, ::icp_stride].reshape(-1)
        v, _ = voxel_downsample_np(g[gm], icp_leaf)
        icp_clouds.append(v)

    # ring drift correction: align camera i to i-1 in world frame
    world_icp = [transform_np(T, c) for T, c in zip(exts, icp_clouds)]
    exts = list(exts)
    corr = np.eye(4, dtype=np.float32)
    for i in range(1, ncam):
        dT = icp_kdtree(world_icp[i], world_icp[i - 1],
                        iterations=icp_iters, max_corr_dist=icp_max_corr)
        corr = dT @ corr
        exts[i] = corr @ exts[i]

    # transform full clouds -> concat -> global voxel (reference dataflow)
    world = [transform_np(T, xyz[m])
             for T, xyz, m in zip(exts, clouds, masks)]
    fused = np.concatenate(world, axis=0)
    out, _ = voxel_downsample_np(fused, out_leaf)
    return len(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cameras", type=int, default=8)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", help="also write the JSON result here")
    args = ap.parse_args()

    ncam, h, w = args.cameras, 480, 848
    rng = np.random.default_rng(0)
    depths = [synth_depth_frame(h, w, seed=i) for i in range(ncam)]
    intrs = [(421.5, 421.1, w / 2.0, h / 2.0)] * ncam
    exts = []
    for i in range(ncam):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
        exts.append(T)

    voxels = run_frame(depths, intrs, exts)  # warm caches / allocators
    times = []
    for _ in range(args.frames):
        t0 = time.time()
        voxels = run_frame(depths, intrs, exts)
        times.append(time.time() - t0)
    frame_s = float(np.min(times))  # best case is the generous baseline
    pps = ncam * h * w / frame_s

    numpy_result = {
        "impl": "numpy+scipy cKDTree (oracle math, tests/oracle.py)",
        "cameras": ncam,
        "frame_ms": round(frame_s * 1e3, 1),
        "cpu_pps": round(pps, 0),
        "fused_voxels": voxels,
    }

    native_result = run_native(ncam, args.frames)
    # the ratio is claimed against the FASTER baseline (conservative)
    fastest = numpy_result
    if native_result and native_result["cpu_pps"] > fastest["cpu_pps"]:
        fastest = native_result
    result = {
        "cpu_pps": fastest["cpu_pps"],
        "frame_ms": fastest["frame_ms"],
        "impl": fastest["impl"],
        "numpy": numpy_result,
        "native": native_result,
        "host": os.uname().nodename,
        "nproc": os.cpu_count(),
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=2)
    print(json.dumps(result))


def run_native(ncam, frames):
    """Build + run the C++ twin (native/cpu_baseline.cc); None if no g++."""
    import shutil
    import subprocess
    if shutil.which("g++") is None:
        return None
    binary = os.path.join(_REPO, "native", "cpu-baseline")
    src = os.path.join(_REPO, "native", "cpu_baseline.cc")
    if (not os.path.exists(binary)
            or os.path.getmtime(binary) < os.path.getmtime(src)):
        subprocess.run(["g++", "-O3", "-march=native", "-std=c++17",
                        "-o", binary, src], check=True)
    out = subprocess.run([binary, str(ncam), str(frames)], check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out)


if __name__ == "__main__":
    main()
