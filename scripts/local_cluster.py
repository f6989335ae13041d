#!/usr/bin/env python
"""Launch a loopback camera cluster: N fake servers + the stitching client.

The zero-hardware equivalent of the reference's scripts/ ssh orchestration
(reference: scripts/*.sh start/kill pcs-camera-server on each NUC —
SURVEY.md §1 L6). Here the "cluster" is N fake-server processes on
localhost; for real remote hosts use scripts/start_cameras.sh.

Usage:
  python scripts/local_cluster.py --cameras 4 --frames 120 [--fps 30]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--base-port", type=int, default=18800)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--fps", type=float, default=None)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=848)
    ap.add_argument("--codec", default="zlib")
    ap.add_argument("--points", action="store_true",
                    help="legacy mode: servers send packed points")
    ap.add_argument("--color", action="store_true",
                    help="colored streams (depth-aligned RGB)")
    ap.add_argument("--client-args", default="",
                    help="extra args forwarded to stitch_cli")
    args = ap.parse_args()

    # the servers stay on the CPU: only the stitch process opens the GPU
    # (a JAX process reserves most of a card's memory when it starts)
    server_env = dict(os.environ, JAX_PLATFORMS="cpu")
    servers = []
    try:
        for i in range(args.cameras):
            cmd = [sys.executable, "-m",
                   "pointcloud_stitching_tpu.runtime.fake_server",
                   "--port", str(args.base_port + i), "--synthetic",
                   "--seed", str(i), "--height", str(args.height),
                   "--width", str(args.width), "--codec", args.codec]
            if args.fps:
                cmd += ["--fps", str(args.fps)]
            if args.points:
                cmd += ["--points"]
            if args.color:
                cmd += ["--color"]
            p = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                                 env=server_env)
            print(p.stdout.readline().strip(), flush=True)
            servers.append(p)

        client_cmd = [sys.executable, "-m",
                      "pointcloud_stitching_tpu.runtime.stitch_cli",
                      "--frames", str(args.frames),
                      "--height", str(args.height),
                      "--width", str(args.width)]
        for i in range(args.cameras):
            client_cmd += ["--camera", f"127.0.0.1:{args.base_port + i}"]
        if args.points:
            client_cmd += ["--payload", "points"]
        if args.color:
            client_cmd += ["--color"]
        client_cmd += args.client_args.split()
        rc = subprocess.call(client_cmd)
        sys.exit(rc)
    finally:
        for p in servers:
            p.terminate()
        time.sleep(0.2)


if __name__ == "__main__":
    main()
