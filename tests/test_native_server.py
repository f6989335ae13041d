"""Native C++ camera server: build, serve, interop with the Python client."""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIN = os.path.join(REPO, "native", "pcs-camera-server")


@pytest.fixture(scope="module")
def server_bin():
    r = subprocess.run(
        ["g++", "-O2", "-std=c++17", "-o", BIN,
         os.path.join(REPO, "native", "camera_server.cc"),
         os.path.join(REPO, "native", "snappy.cc"), "-lpthread"],
        capture_output=True, text=True)
    if r.returncode != 0:
        pytest.skip(f"native toolchain failed: {r.stderr[:500]}")
    return BIN


def _start(args):
    # the ready banner arrives on stderr (stdout is reserved for the --rs2
    # intrinsics JSON dump, which operators redirect into an .intr.json)
    p = subprocess.Popen([*args], stderr=subprocess.PIPE, text=True)
    line = p.stderr.readline()
    assert "native camera server" in line, line
    port = int(line.split(":")[1].split(" ")[0])
    return p, port


def test_native_server_snappy_stream(server_bin):
    from pointcloud_stitching_tpu.runtime.wire import (Kind, recv_frame,
                                                       send_pull)
    p, port = _start([server_bin, "--port", "0" if False else "18920",
                      "--synthetic", "--n-frames", "4",
                      "--height", "48", "--width", "128"])
    try:
        s = socket.create_connection(("127.0.0.1", 18920), timeout=5)
        seen = []
        for i in range(6):  # loops past T
            send_pull(s)
            kind, seq, depth = recv_frame(s)
            assert kind == Kind.DEPTH16 and seq == i
            assert depth.shape == (48, 128)
            seen.append(depth)
        np.testing.assert_array_equal(seen[0], seen[4])  # loop replay
        s.close()
    finally:
        p.terminate()


def test_native_server_color_stream(server_bin):
    """--color serves DEPTH16_COLOR with the same synthetic RGB formula as
    the Python fake server (hue from depth)."""
    from pointcloud_stitching_tpu.runtime.wire import (Kind, recv_frame,
                                                       send_pull)
    p, port = _start([server_bin, "--port", "18922", "--synthetic",
                      "--n-frames", "3", "--height", "48", "--width", "128",
                      "--color"])
    try:
        s = socket.create_connection(("127.0.0.1", 18922), timeout=5)
        for i in range(3):
            send_pull(s)
            kind, seq, payload = recv_frame(s)
            assert kind == Kind.DEPTH16_COLOR and seq == i
            depth, rgb = payload
            assert depth.shape == (48, 128) and rgb.shape == (48, 128, 3)
            d = depth.astype(np.float32)
            np.testing.assert_array_equal(
                rgb[..., 0], np.clip(d / 16.0, 0, 255).astype(np.uint8))
            np.testing.assert_array_equal(
                rgb[..., 1], np.clip(255 - d / 16.0, 0, 255).astype(np.uint8))
            assert (rgb[..., 2] == 128).all()
        s.close()
    finally:
        p.terminate()


def test_native_server_npy_replay(server_bin, tmp_path):
    from pointcloud_stitching_tpu.runtime.wire import recv_frame, send_pull
    frames = (np.arange(3 * 16 * 32) % 2000).reshape(3, 16, 32).astype(
        np.uint16)
    path = tmp_path / "rec.npy"
    np.save(path, frames)
    p, port = _start([server_bin, "--port", "18921", "--file", str(path)])
    try:
        s = socket.create_connection(("127.0.0.1", 18921), timeout=5)
        for i in range(3):
            send_pull(s)
            _, seq, depth = recv_frame(s)
            np.testing.assert_array_equal(depth, frames[i])
        s.close()
    finally:
        p.terminate()


def test_rs2_capture_path_compiles():
    """The live-capture Rs2Source (behind -DPCS_WITH_RS2) must stay
    buildable: syntax-check it against the stub librealsense2 headers
    (native/rs2_stub/) — the SDK itself is not installable here, so this is
    the CI guard that keeps the real-capture path code, not a seam
."""
    try:
        r = subprocess.run(
            ["g++", "-std=c++17", "-DPCS_WITH_RS2",
             "-I" + os.path.join(REPO, "native", "rs2_stub"), "-fsyntax-only",
             os.path.join(REPO, "native", "camera_server.cc")],
            capture_output=True, text=True)
    except FileNotFoundError:
        # exec-style subprocess.run raises rather than returning rc 127
        pytest.skip("no g++")
    assert r.returncode == 0, r.stderr[:2000]


def test_rs2_flag_requires_rs2_build(server_bin):
    """A non-rs2 build must reject --rs2 with a pointer at the rs2 target,
    not crash or silently serve synthetic frames."""
    r = subprocess.run([server_bin, "--rs2"], capture_output=True, text=True,
                       timeout=30)
    assert r.returncode == 2
    assert "native-server-rs2" in r.stderr
