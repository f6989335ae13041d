"""Single-camera test harness: pull frames from one server, print timing.

Equivalent of the reference's pcs-camera-test binary (reference:
src/pcs-camera-test.cpp — SURVEY.md §2.1 'Single-camera test harness': local
loopback test of one camera plus FPS/latency measurement without the full
cluster).

CLI:
  python -m pointcloud_stitching_tpu.runtime.camera_test \
      --host 127.0.0.1 --port 8000 --frames 120 [--deproject]
"""
from __future__ import annotations

import argparse
import socket
import time

import numpy as np

from ..utils.metrics import FrameMetrics
from .wire import Kind, recv_frame, send_pull


def run(host: str, port: int, frames: int, deproject: bool = False,
        quiet: bool = False) -> FrameMetrics:
    metrics = FrameMetrics()
    sock = socket.create_connection((host, port), timeout=10)
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    dep_fn = None
    if deproject:
        import jax
        from ..ops.deproject import deproject as dep
        from ..utils.types import Intrinsics
        intr = Intrinsics.d435_default()
        dep_fn = jax.jit(lambda d: dep(d, intr))

    for i in range(frames):
        t0 = time.time()
        send_pull(sock)
        kind, seq, payload = recv_frame(sock)
        if kind != Kind.DEPTH16:
            raise ValueError(f"unexpected kind {kind}")
        npts = int(np.count_nonzero(payload))
        if dep_fn is not None:
            pc = dep_fn(payload)
            npts = int(pc.count())
        metrics.record(time.time() - t0, points=payload.size)
        if not quiet and i > 0 and i % 30 == 0:
            print(f"frame {i}: {metrics.fps:.1f} FPS, "
                  f"p50 {metrics.latency_ms(50):.1f} ms, "
                  f"{npts} valid points", flush=True)
    sock.close()
    return metrics


def main(argv=None):
    from ..utils.platform import setup_compilation_cache
    setup_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--frames", type=int, default=120)
    ap.add_argument("--deproject", action="store_true",
                    help="also run on-device deprojection per frame")
    args = ap.parse_args(argv)
    m = run(args.host, args.port, args.frames, args.deproject)
    print(m)


if __name__ == "__main__":
    main()
