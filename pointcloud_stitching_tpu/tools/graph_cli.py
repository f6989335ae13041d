#!/usr/bin/env python
"""Pose-graph CLI: reconcile pairwise .cal measurements into global ones.

Beyond-the-reference calibration step (the reference's registration/ tool
emits INDEPENDENT pairwise .cal files — SURVEY.md §3.4 — so multi-camera
rigs inherit whatever inconsistency the chain of pairs accumulated).
This tool takes every pairwise measurement at once, solves the joint
pose-graph least-squares problem on device
(models/pose_graph.optimize_pose_graph), and writes one refined
world-from-camera .cal per camera — drop-in files for `pcs-stitch
--cal-dir`.

Edges file: one measurement per line,

    DST_CAM SRC_CAM PAIR_CAL_PATH [WEIGHT]

where PAIR_CAL_PATH holds the transform produced by
`pcs-register src_cam_cloud.ply dst_cam_cloud.ply pair.cal` — i.e. it maps
SRC_CAM's frame into DST_CAM's frame. WEIGHT (optional, default 1) scales
the edge's contribution (e.g. ICP inlier counts). Lines starting with #
are comments.

With ``--ply-dir`` the measurements are produced here instead of read
from pairwise .cal files: edge lines are just ``DST_CAM SRC_CAM``, the
per-camera sensor-frame clouds load from the directory's .ply files
(sorted name order = camera order), every edge runs as one batched ICP
under the ``--init-dir`` poses, and the joint solve weighs each edge by
its inlier count (models.pose_graph.register_rig) — the whole multiway
calibration in one command.

Usage:
  python -m pointcloud_stitching_tpu.tools.graph_cli edges.txt out_dir \
      [--cameras N] [--anchor 0] [--iterations 10] \
      [--init-dir existing_cal_dir] \
      [--ply-dir clouds_dir --max-corr-dist 0.25 --icp-iter 20]
"""
from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("edges", help="edges file (DST SRC pair.cal [weight])")
    ap.add_argument("out_dir", help="directory for refined cam_%%d.cal files")
    ap.add_argument("--cameras", type=int, default=None,
                    help="number of cameras (default: 1 + max index seen)")
    ap.add_argument("--anchor", type=int, default=0,
                    help="camera whose pose is held fixed (gauge)")
    ap.add_argument("--iterations", type=int, default=10,
                    help="Gauss-Newton iterations")
    ap.add_argument("--init-dir", default=None,
                    help="directory of existing per-camera .cal files used "
                         "as the starting point (default: BFS-chain the "
                         "pairwise measurements from the anchor)")
    ap.add_argument("--ply-dir", default=None,
                    help="directory of per-camera sensor-frame .ply clouds "
                         "(sorted name order = camera order): edge lines "
                         "become 'DST SRC' and measurements come from "
                         "batched ICP under --init-dir poses (required)")
    ap.add_argument("--max-corr-dist", type=float, default=0.25,
                    help="ICP correspondence gate for --ply-dir (meters)")
    ap.add_argument("--icp-iter", type=int, default=20,
                    help="ICP iterations per edge for --ply-dir")
    ap.add_argument("--voxel", type=float, default=None,
                    help="pre-downsample --ply-dir clouds (meters)")
    args = ap.parse_args(argv)

    from pointcloud_stitching_tpu.utils.platform import setup_compilation_cache
    setup_compilation_cache()

    import numpy as np

    from pointcloud_stitching_tpu.io.calio import (discover_cals, load_cal,
                                                   load_cals, save_cal)
    from pointcloud_stitching_tpu.models import (chain_initial_poses,
                                                 optimize_pose_graph)

    ply_mode = args.ply_dir is not None
    edges, meas, weights = [], [], []
    with open(args.edges) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if ply_mode:
                if len(parts) != 2:
                    raise SystemExit(f"--ply-dir edge lines are 'DST SRC'; "
                                     f"bad line: {line!r}")
                edges.append((int(parts[0]), int(parts[1])))
                continue
            if len(parts) not in (3, 4):
                raise SystemExit(f"bad edges line: {line!r}")
            i, j, path = int(parts[0]), int(parts[1]), parts[2]
            edges.append((i, j))
            meas.append(load_cal(path))
            weights.append(float(parts[3]) if len(parts) == 4 else 1.0)
    if not edges:
        raise SystemExit("edges file has no measurements")

    n = args.cameras or (1 + max(max(i, j) for i, j in edges))
    edges_a = np.asarray(edges, np.int32)

    def load_init():
        paths = discover_cals(args.init_dir)
        if len(paths) != n:
            raise SystemExit(f"--init-dir has {len(paths)} .cal files, "
                             f"expected {n}")
        return load_cals(paths)

    if ply_mode:
        if not args.init_dir:
            raise SystemExit("--ply-dir needs --init-dir (clouds must be "
                             "roughly pre-aligned for ICP)")
        import glob

        from pointcloud_stitching_tpu import PointCloud
        from pointcloud_stitching_tpu.io import load_pcd, load_ply
        from pointcloud_stitching_tpu.models import register_rig
        from pointcloud_stitching_tpu.ops import voxel_downsample
        from pointcloud_stitching_tpu.utils.types import round_up

        paths = sorted(glob.glob(os.path.join(args.ply_dir, "*.ply"))
                       + glob.glob(os.path.join(args.ply_dir, "*.pcd")))
        if len(paths) != n:
            raise SystemExit(f"--ply-dir has {len(paths)} clouds, "
                             f"expected {n}")
        raw = [(load_pcd(p) if p.endswith(".pcd") else load_ply(p))[0]
               for p in paths]
        cap = round_up(max(len(x) for x in raw), 1024)
        clouds = PointCloud(
            xyz=np.stack([np.pad(x, ((0, cap - len(x)), (0, 0)))
                          for x in raw]).astype(np.float32),
            mask=np.stack([np.arange(cap) < len(x) for x in raw]))
        if args.voxel:
            clouds = voxel_downsample(clouds, args.voxel, capacity=cap)
        init = load_init()
        res = register_rig(clouds, edges_a, init,
                           icp_iterations=args.icp_iter,
                           gn_iterations=args.iterations,
                           max_corr_dist=args.max_corr_dist,
                           anchor=args.anchor)
    else:
        meas_a = np.stack(meas).astype(np.float32)
        w_a = np.asarray(weights, np.float32)
        init = load_init() if args.init_dir else chain_initial_poses(
            n, edges, meas_a, anchor=args.anchor)
        res = optimize_pose_graph(init, edges_a, meas_a, weights=w_a,
                                  iterations=args.iterations,
                                  anchor=args.anchor)
    before = float(np.sqrt(np.square(res.residual_before).mean()))
    after = float(np.sqrt(np.square(res.residual_after).mean()))
    print(f"pose graph: {n} cameras, {len(edges)} measurements, "
          f"rms residual {before:.6f} -> {after:.6f} "
          f"({args.iterations} GN iterations, anchor cam {args.anchor})")

    os.makedirs(args.out_dir, exist_ok=True)
    poses = np.asarray(res.poses)
    for k in range(n):
        save_cal(os.path.join(args.out_dir, f"cam_{k}.cal"), poses[k])
    print(f"wrote {n} refined .cal files to {args.out_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
