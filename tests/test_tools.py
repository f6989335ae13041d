"""Registration CLI, rendering sink, record+replay."""
import os
import subprocess
import sys
import time

import numpy as np

from pointcloud_stitching_tpu.io import load_cal, load_ply, save_ply
from pointcloud_stitching_tpu.io.render import render_orthographic, save_image
from pointcloud_stitching_tpu.runtime import (FakeCameraServer,
                                              MulticameraClient,
                                              synthetic_frames)
from oracle import random_se3, transform_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_register_cli_end_to_end(tmp_path, rng):
    pts = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    T_true = random_se3(seed=5, max_angle=0.4, max_trans=0.4)
    src_p, dst_p = tmp_path / "src.ply", tmp_path / "dst.ply"
    save_ply(str(src_p), pts)
    save_ply(str(dst_p), transform_np(T_true, pts))
    picks = tmp_path / "picks.txt"
    picks.write_text("\n".join(f"{i} {i}" for i in [5, 300, 999, 1500]))
    out = tmp_path / "pair.cal"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "registration/register_cli.py"),
         str(src_p), str(dst_p), str(out), "--picks", str(picks),
         "--max-corr-dist", "1.0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    T = load_cal(str(out))
    np.testing.assert_allclose(T, T_true, atol=1e-3)


def test_render_orthographic_shapes(rng):
    xyz = rng.normal(size=(5000, 3)).astype(np.float32)
    img = render_orthographic(xyz, size=256)
    assert img.shape == (256, 256, 3) and img.dtype == np.uint8
    assert (img != 0).any()
    # with rgb
    rgb = rng.integers(0, 255, (5000, 3))
    img2 = render_orthographic(xyz, rgb, axis="x", size=128)
    assert img2.shape == (128, 128, 3)


def test_render_empty_cloud():
    img = render_orthographic(np.zeros((0, 3), np.float32), size=64)
    assert (img == 0).all()


def test_save_image(tmp_path, rng):
    img = rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
    p = str(tmp_path / "x.png")
    save_image(p, img)
    files = os.listdir(tmp_path)
    assert files and files[0].startswith("x.")


def test_stream_viewer_consumes_publisher(rng):
    """The live-view consumer: CloudPublisher -> StreamViewer -> rendered
    frames (the PCLVisualizer-replacement loop)."""
    import threading

    from pointcloud_stitching_tpu.runtime import CloudPublisher, StreamViewer

    pub = CloudPublisher(host="127.0.0.1").start()
    imgs = []
    try:
        viewer = StreamViewer(("127.0.0.1", pub.port), size=128)
        done = threading.Event()

        def consume():
            viewer.run(lambda i, img: imgs.append(img) or True,
                       num_frames=3)
            done.set()

        t = threading.Thread(target=consume, daemon=True)
        t.start()
        deadline = time.time() + 10
        while pub.num_subscribers == 0 and time.time() < deadline:
            time.sleep(0.02)
        assert pub.num_subscribers == 1
        xyz = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
        for k in range(4):  # one spare in case the first races the accept
            pub.publish(xyz + 0.01 * k)
            time.sleep(0.02)
        assert done.wait(timeout=15)
        assert len(imgs) == 3
        for img in imgs:
            assert img.shape == (128, 128, 3) and (img != 0).any()
    finally:
        pub.stop()


def test_viewer_directory_sink(tmp_path, rng):
    from pointcloud_stitching_tpu.runtime.view_cli import _directory_sink

    sink = _directory_sink(str(tmp_path), keep=2)
    img = rng.integers(0, 255, (32, 32, 3)).astype(np.uint8)
    for i in range(4):
        assert sink(i, img)
    names = sorted(os.listdir(tmp_path))
    # rolling window of 2 + latest; frames 0,1 pruned
    assert any(n.startswith("latest.") for n in names)
    frame_names = [n for n in names if n.startswith("frame_")]
    assert len(frame_names) == 2
    assert frame_names[0].startswith("frame_00002")


def test_render_indexed_pixel_to_point(rng):
    """The picker contract: clicking the pixel a point rendered to returns
    that point's index."""
    from pointcloud_stitching_tpu.io import (pick_index, project_pixels,
                                             projection_bounds,
                                             render_indexed)

    xyz = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    # landmarks closest to the camera (smallest z wins the depth test)
    landmarks = np.array([[-0.9, -0.9, -3.0], [0.9, -0.85, -3.0],
                          [-0.85, 0.9, -3.0], [0.8, 0.85, -3.0]], np.float32)
    cloud = np.concatenate([xyz, landmarks])
    img, idx_map = render_indexed(cloud, size=512)
    assert img.shape == (512, 512, 3) and idx_map.shape == (512, 512)
    bounds = projection_bounds(cloud)
    px = project_pixels(landmarks, "z", 512, bounds)
    for k, (u, v) in enumerate(px):
        got = pick_index(idx_map, int(u), int(v), radius=0)
        assert got == len(xyz) + k
    # empty corner -> -1
    assert pick_index(np.full((64, 64), -1, np.int32), 5, 5, radius=3) == -1


def test_pick_cli_to_register_cli_end_to_end(tmp_path, rng):
    """A fresh two-cloud rig calibrated with repo tooling alone: render ->
    pick pixel pairs -> picks file -> register_cli -> .cal matching the
    ground-truth transform (the reference's manual_registration workflow,
    SURVEY.md §3.4)."""
    from pointcloud_stitching_tpu.io import project_pixels, projection_bounds

    pts = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    landmarks = np.array([[-0.9, -0.9, -3.0], [0.9, -0.85, -3.0],
                          [-0.85, 0.9, -3.0], [0.8, 0.85, -3.0]], np.float32)
    src = np.concatenate([pts, landmarks])
    T_true = random_se3(seed=11, max_angle=0.1, max_trans=0.5)
    dst = transform_np(T_true, src)
    src_p, dst_p = tmp_path / "src.ply", tmp_path / "dst.ply"
    save_ply(str(src_p), src)
    save_ply(str(dst_p), dst)

    size = 512
    lm_idx = np.arange(len(pts), len(src))
    src_px = project_pixels(src[lm_idx], "z", size, projection_bounds(src))
    dst_px = project_pixels(dst[lm_idx], "z", size, projection_bounds(dst))
    pairs = " ".join(f"{su},{sv}:{tu},{tv}"
                     for (su, sv), (tu, tv) in zip(src_px, dst_px))

    picks = tmp_path / "picks.txt"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "registration/pick_cli.py"),
         str(src_p), str(dst_p), str(picks), "--size", str(size),
         "--pairs", pairs, "--radius", "2",
         "--render-dir", str(tmp_path / "views")],
        capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:] + r.stdout[-500:]
    got = np.loadtxt(picks, dtype=np.int64).reshape(-1, 2)
    assert len(got) >= 3
    assert os.path.exists(tmp_path / "views" / "source.png") or \
        os.path.exists(tmp_path / "views" / "source.ppm")

    out = tmp_path / "pair.cal"
    r2 = subprocess.run(
        [sys.executable, os.path.join(REPO, "registration/register_cli.py"),
         str(src_p), str(dst_p), str(out), "--picks", str(picks),
         "--max-corr-dist", "1.0"],
        capture_output=True, text=True, env=env, timeout=300)
    assert r2.returncode == 0, r2.stderr[-2000:]
    T = load_cal(str(out))
    np.testing.assert_allclose(T, T_true, atol=5e-3)


def test_stitch_cli_with_intr_dir(tmp_path):
    """Full CLI drive: fake servers + per-camera .intr.json intrinsics ->
    stitched PLY snapshots (the real-rig bring-up path: intrinsics come from
    files the camera daemon dumps, not hard-coded factory values)."""
    from pointcloud_stitching_tpu import Intrinsics
    from pointcloud_stitching_tpu.io import save_intrinsics

    h, w = 60, 106
    ncam = 2
    servers = [FakeCameraServer(synthetic_frames(6, h, w, seed=s)).start()
               for s in range(ncam)]
    try:
        idir = tmp_path / "intr"
        os.makedirs(idir)
        for i in range(ncam):
            save_intrinsics(
                str(idir / f"cam{i}.intr.json"),
                Intrinsics.create(fx=53.0 + i, fy=53.0, ppx=w / 2,
                                  ppy=h / 2, width=w, height=h))
        out_dir = tmp_path / "out"
        env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, "-m",
               "pointcloud_stitching_tpu.runtime.stitch_cli",
               "--frames", "3", "--height", str(h), "--width", str(w),
               "--no-icp", "--intr-dir", str(idir),
               "--save-dir", str(out_dir), "--save-every", "1"]
        for s in servers:
            cmd += ["--camera", f"127.0.0.1:{s.port}"]
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-2000:]
        plys = [f for f in os.listdir(out_dir) if f.endswith(".ply")]
        assert plys
        xyz, _ = load_ply(os.path.join(out_dir, sorted(plys)[0]))
        assert len(xyz) > 100
    finally:
        for s in servers:
            s.stop()


def test_record_and_replay(tmp_path):
    """Client records incoming frames; the recording replays byte-identically
    through a new fake server (SURVEY.md §5 record+replay)."""
    from pointcloud_stitching_tpu import Intrinsics
    from pointcloud_stitching_tpu.models import StitchingPipeline
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    frames = synthetic_frames(4, h, w, seed=3)
    srv = FakeCameraServer(frames).start()
    try:
        cfg = StitchConfig(num_cameras=1, height=h, width=w,
                           out_voxel_leaf=0.05, out_capacity=4096,
                           icp_enabled=False)
        i0 = Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2, ppy=h / 2,
                               width=w, height=h)
        pipe = StitchingPipeline(cfg, i0.stack([]), np.eye(4)[None])
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe,
                                   record_frames=4).start()
        assert client.wait_for_first_frames(10)
        deadline = time.time() + 10
        while len(client._threads[0].recorded) < 4 and time.time() < deadline:
            time.sleep(0.05)
        client.stop()
        paths = client.save_recording(str(tmp_path))
        assert len(paths) == 1
        rec = np.load(paths[0])
        assert rec.shape == (4, h, w)
        np.testing.assert_array_equal(rec, frames)
    finally:
        srv.stop()


def test_record_and_replay_color(tmp_path):
    """Color streams record alongside depth and replay byte-identically
    through fake_server(color_frames=...)."""
    from pointcloud_stitching_tpu import Intrinsics
    from pointcloud_stitching_tpu.models import StitchingPipeline
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    frames = synthetic_frames(3, h, w, seed=5)
    srv = FakeCameraServer(frames, color=True).start()
    try:
        cfg = StitchConfig(num_cameras=1, height=h, width=w,
                           out_voxel_leaf=0.05, out_capacity=4096,
                           icp_enabled=False, with_color=True)
        i0 = Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2, ppy=h / 2,
                               width=w, height=h)
        pipe = StitchingPipeline(cfg, i0.stack([]), np.eye(4)[None])
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe,
                                   record_frames=3).start()
        assert client.wait_for_first_frames(10)
        deadline = time.time() + 10
        while len(client._threads[0].recorded) < 3 and time.time() < deadline:
            time.sleep(0.05)
        client.stop()
        paths = client.save_recording(str(tmp_path))
        assert len(paths) == 2
        rec_c = np.load(str(tmp_path / "cam0_color.npy"))
        assert rec_c.shape == (3, h, w, 3)
        np.testing.assert_array_equal(rec_c, srv.colors[:3])

        # replay the recording through a fresh server, byte-identical
        srv2 = FakeCameraServer(np.load(str(tmp_path / "cam0.npy")),
                                color_frames=rec_c).start()
        try:
            import socket as sk
            from pointcloud_stitching_tpu.runtime.wire import (Kind,
                                                               recv_frame,
                                                               send_pull)
            s = sk.create_connection(("127.0.0.1", srv2.port), timeout=5)
            send_pull(s)
            kind, seq, (d, c) = recv_frame(s)
            assert kind == Kind.DEPTH16_COLOR
            np.testing.assert_array_equal(d, frames[0])
            np.testing.assert_array_equal(c, rec_c[0])
            s.close()
        finally:
            srv2.stop()
    finally:
        srv.stop()


def test_stitch_cli_rejects_native_color_without_calibration(tmp_path):
    """A config using non-aligned color (color_height set) without
    --color-intr-dir must fail fast with an actionable message, not crash
    inside StitchingPipeline."""
    import pytest
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    cfg = StitchConfig(num_cameras=1, height=60, width=106, with_color=True,
                       color_height=45, color_width=80)
    p = tmp_path / "cfg.json"
    cfg.save(str(p))
    with pytest.raises(SystemExit, match="color-intr-dir"):
        stitch_cli.main(["--camera", "127.0.0.1:1", "--config", str(p)])


def test_stitch_cli_native_color_with_calibration(tmp_path):
    """The shipped CLI can drive the DEPTH16_COLOR_NATIVE path end to end:
    per-camera color intrinsics via --color-intr-dir (+ depth->color
    extrinsics via --color-cal-dir) reach StitchingPipeline."""
    from pointcloud_stitching_tpu import Intrinsics
    from pointcloud_stitching_tpu.io.calio import save_cal, save_intrinsics
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w, hc, wc = 60, 106, 45, 80
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False, with_color=True,
                       color_height=hc, color_width=wc)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    cintr_dir = tmp_path / "cintr"
    ccal_dir = tmp_path / "ccal"
    os.makedirs(cintr_dir)
    os.makedirs(ccal_dir)
    ci = Intrinsics.create(fx=40.0, fy=40.0, ppx=wc / 2, ppy=hc / 2,
                           width=wc, height=hc)
    save_intrinsics(str(cintr_dir / "cam0.intr.json"), ci)
    save_cal(str(ccal_dir / "cam0.cal"), np.eye(4, dtype=np.float32))

    srv = FakeCameraServer(synthetic_frames(4, h, w, seed=3),
                           color=True, color_shape=(hc, wc)).start()
    try:
        metrics = stitch_cli.main(
            ["--camera", f"127.0.0.1:{srv.port}", "--config", str(cfgp),
             "--frames", "2", "--print-every", "0",
             "--color-intr-dir", str(cintr_dir),
             "--color-cal-dir", str(ccal_dir)])
        assert metrics.total_frames == 2
    finally:
        srv.stop()


def test_render_view_matches_axis_z_at_origin(rng):
    """render_view(0, 0) must reproduce the fixed axis='z' projection
    exactly (same splat, identity basis)."""
    from pointcloud_stitching_tpu.io.render import (render_orthographic,
                                                    render_view)
    xyz = rng.uniform(-1, 1, (3000, 3)).astype(np.float32)
    a = render_orthographic(xyz, axis="z", size=96)
    b = render_view(xyz, azimuth=0.0, elevation=0.0, size=96)
    np.testing.assert_array_equal(a, b)


def test_cloud_view_orbit_changes_projection(rng):
    """Orbiting re-renders from a different basis:
    images differ, reset restores the original exactly (sticky bounds
    re-lock per viewpoint, so the round trip is deterministic)."""
    from pointcloud_stitching_tpu.runtime.view_cli import CloudView

    xyz = rng.uniform(-1, 1, (5000, 3)).astype(np.float32)
    view = CloudView(axis="z", size=96)
    img0 = view.render(xyz)
    assert view.apply_command("az+")
    img1 = view.render(xyz)
    assert (img0 != img1).any()
    assert view.azimuth == 15.0
    assert view.apply_command("el-") and view.elevation == -15.0
    assert view.apply_command("reset")
    assert view.azimuth == 0.0 and view.elevation == 0.0
    np.testing.assert_array_equal(view.render(xyz), img0)
    assert not view.apply_command(True)       # plain continue: not a command
    assert not view.apply_command("quit")     # quit is the caller's business


def test_stream_viewer_orbit_rerenders_retained_cloud(rng):
    """A sink returning an orbit command gets an immediate re-render of the
    retained cloud from the new viewpoint (no new frame needed)."""
    import threading

    from pointcloud_stitching_tpu.runtime import CloudPublisher, StreamViewer

    pub = CloudPublisher(host="127.0.0.1").start()
    frames = []
    try:
        viewer = StreamViewer(("127.0.0.1", pub.port), size=96)

        def sink(i, img):
            frames.append(img)
            return "az+" if len(frames) == 1 else True

        done = threading.Event()

        def consume():
            viewer.run(sink, num_frames=2)
            done.set()

        threading.Thread(target=consume, daemon=True).start()
        deadline = time.time() + 10
        while pub.num_subscribers == 0 and time.time() < deadline:
            time.sleep(0.02)
        xyz = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
        for _ in range(3):
            pub.publish(xyz)
            time.sleep(0.05)
        assert done.wait(timeout=15)
        # ONE published frame produced TWO rendered frames: the original
        # view plus the orbited re-render, and they differ
        assert len(frames) == 2
        assert (frames[0] != frames[1]).any()
        assert viewer.azimuth == 15.0
    finally:
        pub.stop()


def test_stream_viewer_snap_saves_ply(tmp_path, rng):
    """A sink returning "snap" writes the retained cloud as a .ply (the
    reference client's keypress savePLYFile — SURVEY §3.2) and streaming
    continues."""
    import threading

    from pointcloud_stitching_tpu.runtime import CloudPublisher, StreamViewer

    pub = CloudPublisher(host="127.0.0.1").start()
    snaps = str(tmp_path / "snaps")
    try:
        viewer = StreamViewer(("127.0.0.1", pub.port), size=96,
                              snapshot_dir=snaps)
        n_frames = []

        def sink(i, img):
            n_frames.append(i)
            return "snap" if len(n_frames) == 1 else True

        done = threading.Event()

        def consume():
            viewer.run(sink, num_frames=2)
            done.set()

        threading.Thread(target=consume, daemon=True).start()
        deadline = time.time() + 10
        while pub.num_subscribers == 0 and time.time() < deadline:
            time.sleep(0.02)
        xyz = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
        rgb = rng.integers(0, 255, (500, 3)).astype(np.uint8)
        for _ in range(3):
            pub.publish(xyz, rgb)
            time.sleep(0.05)
        assert done.wait(timeout=15)
        assert len(n_frames) == 2  # snap consumed no rendered-frame budget
        files = sorted(os.listdir(snaps))
        assert files == ["snapshot_00000.ply"]
        sx, srgb = load_ply(os.path.join(snaps, files[0]))
        # the wire quantizes to int16 mm: 1 mm tolerance
        assert sx.shape == xyz.shape and srgb is not None
        np.testing.assert_allclose(sx, xyz, atol=2e-3)
        np.testing.assert_array_equal(srgb, rgb)
    finally:
        pub.stop()


def test_stream_viewer_snap_after_orbit(rng, tmp_path):
    """'snap' must be honored mid-steering-loop (after an orbit re-render),
    not only as the first sink response."""
    import threading

    from pointcloud_stitching_tpu.runtime import CloudPublisher, StreamViewer

    pub = CloudPublisher(host="127.0.0.1").start()
    snaps = str(tmp_path / "snaps")
    try:
        viewer = StreamViewer(("127.0.0.1", pub.port), size=96,
                              snapshot_dir=snaps)
        responses = iter(["az+", "snap"])

        def sink(i, img):
            return next(responses, True)

        done = threading.Event()

        def consume():
            viewer.run(sink, num_frames=3)
            done.set()

        threading.Thread(target=consume, daemon=True).start()
        deadline = time.time() + 10
        while pub.num_subscribers == 0 and time.time() < deadline:
            time.sleep(0.02)
        xyz = rng.uniform(-1, 1, (500, 3)).astype(np.float32)
        for _ in range(4):
            pub.publish(xyz)
            time.sleep(0.05)
        assert done.wait(timeout=15)
        # frame 1 = orbit re-render whose sink response was "snap"
        assert sorted(os.listdir(snaps)) == ["snapshot_00000.ply"]
    finally:
        pub.stop()


def test_stitch_cli_view_snap(tmp_path, monkeypatch):
    """--view 'p' key (sink returning 'snap') writes a .ply of the cloud
    that produced the frame (reference keypress savePLYFile parity)."""
    from pointcloud_stitching_tpu.runtime import stitch_cli, view_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    responses = iter(["snap"])
    monkeypatch.setattr(
        view_cli, "_window_sink",
        lambda *a, **k: (lambda i, img: next(responses, True)))
    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    view_dir = tmp_path / "view"
    srv = FakeCameraServer(synthetic_frames(4, h, w, seed=2)).start()
    try:
        stitch_cli.main(["--camera", f"127.0.0.1:{srv.port}",
                         "--config", str(cfgp), "--frames", "3",
                         "--view", "--view-dir", str(view_dir),
                         "--view-size", "64"])
    finally:
        srv.stop()
    snaps = [f for f in os.listdir(view_dir) if f.endswith(".ply")]
    assert snaps == ["snapshot_00000.ply"]
    xyz, _ = load_ply(str(view_dir / snaps[0]))
    assert len(xyz) > 50


def test_stitch_cli_in_process_view(tmp_path):
    """--view renders stitched clouds from inside the client process (the
    reference's -v flag), headless fallback =
    rolling image sequence."""
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    view_dir = tmp_path / "view"
    srv = FakeCameraServer(synthetic_frames(4, h, w, seed=2)).start()
    try:
        metrics = stitch_cli.main(
            ["--camera", f"127.0.0.1:{srv.port}", "--config", str(cfgp),
             "--frames", "3", "--print-every", "0", "--view",
             "--view-dir", str(view_dir)])
        assert metrics.total_frames == 3
        names = os.listdir(view_dir)
        assert any(n.startswith("frame_") for n in names)
        assert any(n.startswith("latest.") for n in names)
    finally:
        srv.stop()


def test_stitch_cli_temporal_map(tmp_path):
    """--map-leaf accumulates stitched frames into a persistent voxel map
    and saves the denoised scene as PLY on exit."""
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    map_out = tmp_path / "scene.ply"
    srv = FakeCameraServer(synthetic_frames(4, h, w, seed=3)).start()
    try:
        metrics = stitch_cli.main(
            ["--camera", f"127.0.0.1:{srv.port}", "--config", str(cfgp),
             "--frames", "4", "--print-every", "0",
             "--map-leaf", "0.03", "--map-capacity", "16384",
             "--map-out", str(map_out)])
        assert metrics.total_frames == 4
        xyz, _rgb = load_ply(str(map_out))
        assert len(xyz) > 100  # a real accumulated scene landed on disk
    finally:
        srv.stop()


def test_stitch_cli_tsdf_to_mesh(tmp_path):
    """--tsdf-leaf fuses depth keyframes into a TSDF checkpoint through
    the streaming CLI, and mesh_cli auto-detects the checkpoint kind and
    extracts the zero-level-set mesh — the full KinFu capture loop
    through CLIs alone (stitch_cli tsdf_state + tools/mesh_cli
    _mesh_tsdf)."""
    import numpy as np

    from pointcloud_stitching_tpu.models.tsdf import load_volume
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.tools import mesh_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    vol_out = tmp_path / "scene_tsdf.npz"
    srv = FakeCameraServer(synthetic_frames(4, h, w, seed=3)).start()
    try:
        metrics = stitch_cli.main(
            ["--camera", f"127.0.0.1:{srv.port}", "--config", str(cfgp),
             "--frames", "4", "--print-every", "0",
             "--tsdf-leaf", "0.04", "--tsdf-shape", "48,48,48",
             "--tsdf-origin=-0.96,-0.96,0.6", "--tsdf-every", "2",
             "--tsdf-out", str(vol_out)])
        assert metrics.total_frames == 4
    finally:
        srv.stop()
    vol = load_volume(str(vol_out))
    # the default D435 intrinsics keep the 848-px focal at 106 px wide
    # (a ~14 deg cone), so only ~1k voxels of the 48^3 grid see the
    # frustum — the count varies with which frames the freshest-slot
    # snapshot catches (965-1044 observed across loads)
    assert int((np.asarray(vol.weight) > 0).sum()) > 500
    mesh_out = tmp_path / "scene.ply"
    n = mesh_cli.main([str(vol_out), str(mesh_out),
                       "--cell-capacity", "16384"])
    assert n > 50 and mesh_out.exists()


def test_stitch_cli_tsdf_resume(tmp_path):
    """--tsdf-in resumes a checkpoint: two 2-frame runs accumulate the
    same total keyframe evidence as one 4-frame run at the same cadence
    (weights add; the volume geometry comes from the file)."""
    import numpy as np

    from pointcloud_stitching_tpu.models.tsdf import load_volume
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    frames = synthetic_frames(2, h, w, seed=5)
    a = tmp_path / "a.npz"

    def run(extra):
        srv = FakeCameraServer(frames).start()
        try:
            stitch_cli.main(
                ["--camera", f"127.0.0.1:{srv.port}", "--config",
                 str(cfgp), "--frames", "2", "--print-every", "0",
                 "--tsdf-every", "1"] + extra)
        finally:
            srv.stop()

    run(["--tsdf-leaf", "0.04", "--tsdf-shape", "48,48,48",
         "--tsdf-origin=-0.96,-0.96,0.6", "--tsdf-out", str(a)])
    w1 = np.asarray(load_volume(str(a)).weight)
    run(["--tsdf-in", str(a), "--tsdf-out", str(a)])
    w2 = np.asarray(load_volume(str(a)).weight)
    assert w2.max() > w1.max() and w2.sum() > 1.5 * w1.sum()


def test_stitch_cli_tsdf_track_recovers_drift(tmp_path, capsys):
    """--tsdf-track uses the TSDF volume as an online extrinsics source
: a loopback rig whose camera truly slides toward
    the wall while its .cal pose stays frozen — the mount-slip drift ring
    ICP cannot observe. Without tracking, keyframes integrate the wall at
    drifted positions and the fused zero-crossing lands away from the true
    plane; with --tsdf-track every keyframe is corrected frame-to-model
    first, so the surface stays anchored where the first keyframe put it.

    Deterministic by wall-clock pacing (an earlier per-pull ramp design
    was racy: startup trickle pulls slid keyframe 0 past the whole ramp
    and the tracked run anchored at full drift). Both sides now pace to
    30 FPS — the server via its fps replay pacing, the client via the
    product --fps flag — so the server's frame index is ~30·t while the
    keyframe times are pinned at t ≈ 0 / 2.5 / 5 / 7.5 s. The drift is a
    STEP at server frame 40 (t ≈ 1.33 s): keyframe 0 lands in the flat
    head with ≥ 5x startup margin, keyframes 1–3 land past the step with
    ≥ 45% mutual pacing-slip margin, and the tail is long enough that
    the looping replay cannot wrap mid-run (~90 s of tail)."""
    import re

    import pytest  # noqa: F401  (slow marker below)

    from test_tsdf import render_depth
    from pointcloud_stitching_tpu.io.calio import save_intrinsics
    from pointcloud_stitching_tpu.models.tsdf import load_volume
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig
    from pointcloud_stitching_tpu.utils.types import Intrinsics

    h, w, f = 72, 96, 75.0
    intr = Intrinsics.create(fx=f, fy=f, ppx=w / 2.0, ppy=h / 2.0,
                             width=w, height=h)
    scene = dict(planes=[((0.0, 0.0, -1.0), -0.9)])  # wall at z = 0.9

    def pose(dz):
        T = np.eye(4, dtype=np.float32)
        T[2, 3] = dz
        return T

    def depth_at(dz):
        return np.round(render_depth(intr, pose(dz), **scene)
                        * 1000.0).astype(np.uint16)

    # step drift: flat head (camera at truth), then the mount slips 6 cm
    # toward the wall in one step and stays there
    frames = np.concatenate([np.repeat(depth_at(0.0)[None], 40, axis=0),
                             np.repeat(depth_at(0.06)[None], 2800, axis=0)])

    intr_dir = tmp_path / "intr"
    os.makedirs(intr_dir)
    save_intrinsics(str(intr_dir / "cam0.intr.json"), intr)
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.02, cam_capacity=8192,
                       out_voxel_leaf=0.02, out_capacity=8192,
                       icp_enabled=False, z_min=0.05, z_max=2.0)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))

    def run(track, out_path, recording, paced=True):
        srv = FakeCameraServer(recording,
                               fps=30.0 if paced else None).start()
        pacing = (["--fps", "30", "--frames", "250", "--tsdf-every", "75"]
                  if paced else ["--frames", "8", "--tsdf-every", "2"])
        try:
            stitch_cli.main(
                ["--camera", f"127.0.0.1:{srv.port}", "--config", str(cfgp),
                 "--intr-dir", str(intr_dir),
                 "--print-every", "0", "--tsdf-leaf", "0.02",
                 "--tsdf-shape", "64,48,64", "--tsdf-origin=-0.64,-0.48,0.0",
                 "--tsdf-out", str(out_path)] + pacing
                + (["--tsdf-track"] if track else []))
        finally:
            srv.stop()

    # warmup on a STATIC recording, unpaced: the first run in a process
    # pays backend init + every jit compile (stitch, integrate, rig_track);
    # with a warm process the timed runs' keyframe times hold their pinned
    # wall-clock schedule
    static = np.repeat(depth_at(0.0)[None], 300, axis=0)
    run(True, tmp_path / "warm.npz", static, paced=False)
    capsys.readouterr()

    def wall_rms(path):
        """RMS distance of the fused zero-crossing from the true wall."""
        vol = load_volume(str(path))
        t = np.asarray(vol.tsdf)
        wt = np.asarray(vol.weight)
        a, b = t[:, :, :-1], t[:, :, 1:]
        cross = ((a > 0) & (b <= 0)
                 & (wt[:, :, :-1] > 0.5) & (wt[:, :, 1:] > 0.5))
        i, j, k = np.nonzero(cross)
        frac = a[i, j, k] / np.maximum(a[i, j, k] - b[i, j, k], 1e-12)
        z = float(vol.origin[2]) + (k + frac) * float(vol.leaf)
        assert len(z) > 50
        return float(np.sqrt(np.mean((z - 0.9) ** 2)))

    tracked = tmp_path / "tracked.npz"
    drifted = tmp_path / "drifted.npz"
    run(True, tracked, frames.copy())
    out_text = capsys.readouterr().out
    m = re.search(r"tracking applied (\d+)/(\d+)", out_text)
    assert m, out_text[-2000:]
    assert int(m.group(1)) >= 2 and int(m.group(2)) == 3
    run(False, drifted, frames.copy())

    err_t, err_n = wall_rms(tracked), wall_rms(drifted)
    assert err_n > 0.006, (err_t, err_n)   # the drift really moved the wall
    assert err_t < 0.6 * err_n, (err_t, err_n)
    assert err_t < 0.012, (err_t, err_n)   # anchored near the true wall


def test_stitch_cli_drop_plane(tmp_path):
    """--drop-plane removes the dominant plane from every saved output: a
    constant-depth rig (one big wall) saves nearly empty clouds with the
    flag and full ones without."""
    import numpy as np
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    frames = np.full((3, h, w), 1000, np.uint16)  # a wall at z = 1 m

    def run(extra, sub):
        d = tmp_path / sub
        srv = FakeCameraServer(frames).start()
        try:
            stitch_cli.main(["--camera", f"127.0.0.1:{srv.port}",
                             "--config", str(cfgp), "--frames", "2",
                             "--print-every", "0", "--save-dir", str(d),
                             "--save-every", "1"] + extra)
        finally:
            srv.stop()
        xyz, _ = load_ply(str(d / "cloud_000000.ply"))
        return len(xyz)

    full = run([], "plain")
    rest = run(["--drop-plane", "0.01"], "dropped")
    # the default D435 focal at 106x60 sees a ~0.25 m wall patch: small in
    # voxels, but entirely planar — the flag must remove essentially all
    # of it
    assert full > 40, full
    assert rest < 0.2 * full, (rest, full)


def test_stitch_cli_map_checkpoint_resume(tmp_path):
    """--map-out foo.npz checkpoints the full accumulation state and a
    second run resumes it via --map-in (leaf comes from the file, no
    --map-leaf needed)."""
    import pytest

    from pointcloud_stitching_tpu.models.voxel_map import load_map
    from pointcloud_stitching_tpu.runtime import stitch_cli
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w = 60, 106
    cfg = StitchConfig(num_cameras=1, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    cfgp = tmp_path / "cfg.json"
    cfg.save(str(cfgp))
    ckpt = tmp_path / "scene.npz"
    final = tmp_path / "scene.ply"
    srv = FakeCameraServer(synthetic_frames(4, h, w, seed=3)).start()
    try:
        stitch_cli.main(
            ["--camera", f"127.0.0.1:{srv.port}", "--config", str(cfgp),
             "--frames", "2", "--print-every", "0",
             "--map-leaf", "0.03", "--map-capacity", "16384",
             "--map-out", str(ckpt)])
        vm = load_map(str(ckpt))
        n_ckpt = int(vm.count())
        assert n_ckpt > 100 and float(vm.leaf) == pytest.approx(0.03)
        # resume: accumulated evidence carries over (total weight grows)
        stitch_cli.main(
            ["--camera", f"127.0.0.1:{srv.port}", "--config", str(cfgp),
             "--frames", "2", "--print-every", "0",
             "--map-in", str(ckpt), "--map-out", str(final)])
        xyz, _rgb = load_ply(str(final))
        assert len(xyz) >= n_ckpt  # resumed map contains the checkpoint
    finally:
        srv.stop()


def test_stitch_cli_rejects_points_payload_with_normals():
    import pytest
    from pointcloud_stitching_tpu.runtime import stitch_cli
    with pytest.raises(SystemExit, match="normals"):
        stitch_cli.main(["--camera", "127.0.0.1:1", "--payload", "points",
                         "--normals"])
