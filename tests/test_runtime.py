"""Loopback-cluster tests: fake servers + streaming client, no hardware."""
import socket
import threading
import time

import numpy as np
import pytest

from pointcloud_stitching_tpu import Intrinsics
from pointcloud_stitching_tpu.models import StitchingPipeline
from pointcloud_stitching_tpu.runtime import (Codec, FakeCameraServer,
                                              MulticameraClient,
                                              pack_points_i16mm,
                                              recv_frame, synthetic_frames,
                                              unpack_points_i16mm)
from pointcloud_stitching_tpu.runtime.wire import send_pull
from pointcloud_stitching_tpu.utils.config import StitchConfig


def test_pack_unpack_i16mm_roundtrip(rng):
    xyz = rng.uniform(-5, 5, (1000, 3)).astype(np.float32)
    data = pack_points_i16mm(xyz)
    got, got_rgb = unpack_points_i16mm(data)
    assert got_rgb is None
    np.testing.assert_allclose(got, xyz, atol=5.1e-4)  # 1mm quantization


def test_pack_unpack_with_rgb(rng):
    xyz = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    rgb = rng.integers(0, 256, (500, 3)).astype(np.uint8)
    data = pack_points_i16mm(xyz, rgb)
    got, got_rgb = unpack_points_i16mm(data, with_rgb=True)
    np.testing.assert_allclose(got, xyz, atol=5.1e-4)
    np.testing.assert_array_equal(got_rgb, rgb)


@pytest.mark.parametrize("codec", [Codec.RAW, Codec.ZLIB])
def test_fake_server_serves_frames(codec):
    frames = synthetic_frames(4, h=60, w=106, seed=1)
    srv = FakeCameraServer(frames, codec=codec).start()
    try:
        sock = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        for i in range(6):  # loops past the end
            send_pull(sock)
            kind, seq, payload = recv_frame(sock)
            assert seq == i
            np.testing.assert_array_equal(payload, frames[i % 4])
        sock.close()
    finally:
        srv.stop()


def _make_pipeline(ncam, h=60, w=106):
    cfg = StitchConfig(num_cameras=ncam, height=h, width=w,
                       cam_voxel_leaf=0.03, cam_capacity=4096,
                       out_voxel_leaf=0.03, out_capacity=8192,
                       icp_enabled=False)
    i0 = Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2, ppy=h / 2,
                           width=w, height=h)
    intr = i0.stack([i0] * (ncam - 1))
    ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
    return StitchingPipeline(cfg, intr, ext)


def test_loopback_stream_end_to_end():
    """N fake servers on localhost -> client -> stitched clouds (config 4
    topology with zero hardware)."""
    ncam, h, w = 3, 60, 106
    servers = [FakeCameraServer(synthetic_frames(8, h, w, seed=s)).start()
               for s in range(ncam)]
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient(
            [("127.0.0.1", s.port) for s in servers], pipe).start()
        assert client.wait_for_first_frames(timeout=10)
        outs = []
        metrics = client.run(num_frames=5,
                             on_frame=lambda i, o: outs.append(o))
        assert metrics.total_frames == 5
        assert len(outs) == 5
        assert int(outs[-1].metrics.points_out) > 100
        assert metrics.dropped_cameras == 0
        s = metrics.summary()
        assert s["fps"] > 0
    finally:
        client.stop()
        for s in servers:
            s.stop()


def test_native_color_wire_roundtrip(rng):
    """DEPTH16_COLOR_NATIVE: color rides at its own resolution."""
    from pointcloud_stitching_tpu.runtime.wire import (decode_frame,
                                                       encode_depth_frame,
                                                       HEADER_SIZE, Kind)
    depth = rng.integers(0, 4000, (60, 106)).astype(np.uint16)
    color = rng.integers(0, 256, (45, 80, 3)).astype(np.uint8)
    frame = encode_depth_frame(depth, 7, color=color)
    kind, seq, (d, c) = decode_frame(frame[:HEADER_SIZE], frame[HEADER_SIZE:])
    assert kind == Kind.DEPTH16_COLOR_NATIVE and seq == 7
    np.testing.assert_array_equal(d, depth)
    np.testing.assert_array_equal(c, color)


def test_loopback_native_color_stream():
    """Unaligned color end to end: fake servers ship color at its own
    resolution, the pipeline texture-maps it through separate color
    intrinsics + depth->color extrinsics (rs2 map_to semantics)."""
    from pointcloud_stitching_tpu.utils.config import StitchConfig as SC

    ncam, h, w = 2, 60, 106
    hc, wc = 45, 80
    servers = [FakeCameraServer(synthetic_frames(6, h, w, seed=s),
                                color=True, color_shape=(hc, wc)).start()
               for s in range(ncam)]
    try:
        cfg = SC(num_cameras=ncam, height=h, width=w,
                 cam_voxel_leaf=0.03, cam_capacity=4096,
                 out_voxel_leaf=0.03, out_capacity=8192,
                 icp_enabled=False, with_color=True,
                 color_height=hc, color_width=wc)
        i0 = Intrinsics.create(fx=53.0, fy=53.0, ppx=w / 2, ppy=h / 2,
                               width=w, height=h)
        ci = Intrinsics.create(fx=40.0, fy=40.0, ppx=wc / 2, ppy=hc / 2,
                               width=wc, height=hc)
        ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
        c_ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))
        c_ext[:, 0, 3] = 0.015
        pipe = StitchingPipeline(cfg, i0.stack([i0] * (ncam - 1)), ext,
                                 color_intr=ci.stack([ci] * (ncam - 1)),
                                 color_ext=c_ext)
        client = MulticameraClient(
            [("127.0.0.1", s.port) for s in servers], pipe).start()
        assert client.wait_for_first_frames(timeout=10)
        out = client.step()
        assert out is not None and out.cloud.rgb is not None
        m = np.asarray(out.cloud.mask)
        rgb = np.asarray(out.cloud.rgb)[m]
        assert m.sum() > 100 and (rgb > 0).any()
        client.stop()
    finally:
        for s in servers:
            s.stop()


def test_overlap_pipeline_matches_serial():
    """The software-pipelined run loop (H2D of frame N+1 overlapping frame
    N's compute) must deliver the same number of
    frames, in order, as the serial loop, and record its sync_wait stage."""
    ncam, h, w = 2, 60, 106
    servers = [FakeCameraServer(synthetic_frames(8, h, w, seed=s)).start()
               for s in range(ncam)]
    try:
        addrs = [("127.0.0.1", s.port) for s in servers]
        outs = []
        client = MulticameraClient(addrs, _make_pipeline(ncam, h, w)).start()
        assert client.wait_for_first_frames(timeout=10)
        m = client.run(num_frames=6, overlap=True,
                       on_frame=lambda i, o: outs.append((i, o)))
        assert m.total_frames == 6 and len(outs) == 6
        assert [i for i, _ in outs] == list(range(6))
        assert "sync_wait" in client.stages.stages
        assert all(int(o.metrics.points_out) > 100 for _, o in outs)
        # release the servers (they serve one connection at a time) before
        # the serial rig connects — run() no longer stops the client itself
        client.stop()

        outs_serial = []
        client2 = MulticameraClient(addrs, _make_pipeline(ncam, h, w)).start()
        assert client2.wait_for_first_frames(timeout=10)
        m2 = client2.run(num_frames=6, overlap=False,
                         on_frame=lambda i, o: outs_serial.append(o))
        assert m2.total_frames == 6 and len(outs_serial) == 6
        # same synthetic streams -> same stitched voxel counts per frame
        # (both loops consume the freshest frame, so counts match the
        # per-seed scene; compare the sets of counts rather than exact
        # ordering because pull timing may differ by one frame)
        c1 = {int(o.metrics.points_out) for _, o in outs}
        c2 = {int(o.metrics.points_out) for o in outs_serial}
        assert c1 and c2
    finally:
        client.stop()
        if "client2" in locals():
            client2.stop()
        for s in servers:
            s.stop()


def test_bounded_overlap_run_dispatches_exactly_n():
    """run(num_frames=N, overlap=True) must dispatch exactly N stitches —
    the pipelined loop used to start an (N+1)-th frame (full H2D + stitch)
    that was then discarded at the break."""
    ncam, h, w = 2, 60, 106
    servers = [FakeCameraServer(synthetic_frames(8, h, w, seed=s)).start()
               for s in range(ncam)]
    try:
        pipe = _make_pipeline(ncam, h, w)
        calls = {"n": 0}
        client = MulticameraClient([("127.0.0.1", s.port) for s in servers],
                                   pipe).start()
        real_dispatch = client._dispatch

        def counted_dispatch(dev, d_mask):
            calls["n"] += 1
            return real_dispatch(dev, d_mask)

        client._dispatch = counted_dispatch
        calls["n"] = 0
        assert client.wait_for_first_frames(timeout=10)
        m = client.run(num_frames=5, overlap=True)
        assert m.total_frames == 5
        assert calls["n"] == 5, calls["n"]
    finally:
        client.stop()
        for s in servers:
            s.stop()


def test_run_fps_paces_the_loop():
    """run(fps=K) paces stitch ticks to the wall clock in both loop modes
    (the reference client is implicitly paced by the 30 FPS camera
    cadence; unpaced, this loop free-runs on the freshest frames). The
    floor is exact — N frames at K FPS cannot finish before (N-1)/K — and
    a generous ceiling guards against pacing that sleeps per-dispatch-AND-
    per-drain (double pacing) without flaking on a loaded host."""
    ncam, h, w = 1, 48, 64
    srv = FakeCameraServer(synthetic_frames(8, h, w, seed=0)).start()
    try:
        client = MulticameraClient([("127.0.0.1", srv.port)],
                                   _make_pipeline(ncam, h, w)).start()
        assert client.wait_for_first_frames(timeout=10)
        client.run(num_frames=2)  # compile outside the timed windows
        for overlap in (True, False):
            t0 = time.time()
            m = client.run(num_frames=10, overlap=overlap, fps=50.0)
            dt = time.time() - t0
            assert m.total_frames >= 10
            assert dt >= 9 / 50.0, (overlap, dt)
            assert dt < 10 * (2 / 50.0) + 1.0, (overlap, dt)
    finally:
        client.stop()
        srv.stop()


def test_run_sync_every_counts_all_frames():
    """sync_every=K syncs (and records a latency sample) only every K-th
    frame but still counts and delivers every frame in order; the final
    pending frame is always drained before run() returns."""
    ncam, h, w = 2, 60, 106
    servers = [FakeCameraServer(synthetic_frames(8, h, w, seed=s)).start()
               for s in range(ncam)]
    try:
        outs = []
        client = MulticameraClient([("127.0.0.1", s.port) for s in servers],
                                   _make_pipeline(ncam, h, w)).start()
        assert client.wait_for_first_frames(timeout=10)
        m = client.run(num_frames=9, overlap=True, sync_every=4,
                       on_frame=lambda i, o: outs.append(i))
        assert m.total_frames == 9 and outs == list(range(9))
        # latency samples only on synced frames: indices 0, 4, 8 (the last
        # frame syncs via the index rule here)
        assert len(m.latencies) == 3
        assert len(m.points) == 9  # throughput counts every frame
    finally:
        client.stop()
        for s in servers:
            s.stop()


def test_dead_camera_is_dropped_not_fatal():
    """A server that dies mid-stream must not stall the client (the
    reference client blocks forever on a dead socket — SURVEY.md §5)."""
    ncam, h, w = 2, 60, 106
    good = FakeCameraServer(synthetic_frames(8, h, w, seed=0)).start()
    dying = FakeCameraServer(synthetic_frames(8, h, w, seed=1),
                             die_after=2).start()
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient(
            [("127.0.0.1", good.port), ("127.0.0.1", dying.port)],
            pipe, stale_timeout=0.3).start()
        assert client.wait_for_first_frames(timeout=10)
        time.sleep(0.6)  # let the dying camera die and go stale
        out = client.step()
        assert out is not None
        assert client.metrics.dropped_cameras == 1
        client.stop()
    finally:
        good.stop()
        dying.stop()


def test_all_cameras_dead_returns_none():
    ncam, h, w = 1, 60, 106
    srv = FakeCameraServer(synthetic_frames(4, h, w), die_after=1).start()
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe,
                                   stale_timeout=0.2).start()
        client.wait_for_first_frames(timeout=10)
        time.sleep(0.5)
        assert client.step() is None
        client.stop()
    finally:
        srv.stop()


def test_legacy_points_protocol_end_to_end():
    """Reference-style camera servers (packed int16-mm points) -> client in
    points mode -> stitched cloud. Interop path, SURVEY.md §3.1."""
    ncam, h, w = 2, 60, 106
    servers = [FakeCameraServer(synthetic_frames(4, h, w, seed=s),
                                points=True, intrinsics=(53.0, 53.0, None, None)
                                ).start()
               for s in range(ncam)]
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient(
            [("127.0.0.1", s.port) for s in servers], pipe,
            payload="points").start()
        assert client.wait_for_first_frames(timeout=10)
        out = client.step()
        assert out is not None
        assert int(out.metrics.points_out) > 100
        # sanity: stitched points live in plausible sensor range
        import numpy as _np
        xyz = _np.asarray(out.cloud.xyz)[_np.asarray(out.cloud.mask)]
        assert (_np.abs(xyz) < 20).all() and (xyz[:, 2] > 0).all()
        client.stop()
    finally:
        for s in servers:
            s.stop()


def test_colored_depth_stream_end_to_end():
    """DEPTH16_COLOR wire mode -> colored stitched cloud (PointXYZRGB parity)."""
    import dataclasses
    ncam, h, w = 2, 60, 106
    servers = [FakeCameraServer(synthetic_frames(4, h, w, seed=s),
                                color=True).start() for s in range(ncam)]
    try:
        pipe = _make_pipeline(ncam, h, w)
        pipe.cfg = dataclasses.replace(pipe.cfg, with_color=True)
        # rebuild pipeline with color-enabled config
        from pointcloud_stitching_tpu.models import StitchingPipeline
        pipe = StitchingPipeline(pipe.cfg, pipe.intr, pipe.extrinsics)
        client = MulticameraClient(
            [("127.0.0.1", s.port) for s in servers], pipe).start()
        assert client.wait_for_first_frames(timeout=10)
        out = client.step()
        assert out is not None
        assert out.cloud.rgb is not None
        m = np.asarray(out.cloud.mask)
        rgb = np.asarray(out.cloud.rgb)[m]
        assert (rgb >= 0).all() and (rgb <= 255).all()
        assert rgb.std() > 1.0  # actual color variation came through
        client.stop()
    finally:
        for s in servers:
            s.stop()


def test_colored_points_stream_end_to_end():
    """Legacy points payload with RGB (the reference's PointXYZRGB wire)."""
    import dataclasses
    ncam, h, w = 2, 60, 106
    servers = [FakeCameraServer(synthetic_frames(4, h, w, seed=s),
                                points=True, color=True,
                                intrinsics=(53.0, 53.0, None, None)).start()
               for s in range(ncam)]
    try:
        pipe = _make_pipeline(ncam, h, w)
        cfg = dataclasses.replace(pipe.cfg, with_color=True)
        from pointcloud_stitching_tpu.models import StitchingPipeline
        pipe = StitchingPipeline(cfg, pipe.intr, pipe.extrinsics)
        client = MulticameraClient(
            [("127.0.0.1", s.port) for s in servers], pipe,
            payload="points").start()
        assert client.wait_for_first_frames(timeout=10)
        out = client.step()
        assert out is not None and out.cloud.rgb is not None
        m = np.asarray(out.cloud.mask)
        assert np.asarray(out.cloud.rgb)[m].std() > 1.0
        client.stop()
    finally:
        for s in servers:
            s.stop()


def test_garbage_protocol_degrades_gracefully():
    """A server speaking garbage must kill only its camera slot, with a
    readable error — never the client."""
    import socket as socketlib
    import threading

    srv = socketlib.socket(socketlib.AF_INET, socketlib.SOCK_STREAM)
    srv.setsockopt(socketlib.SOL_SOCKET, socketlib.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def junk_server():
        conn, _ = srv.accept()
        try:
            conn.recv(1)
            conn.sendall(b"\xde\xad\xbe\xef" * 64)  # not a valid frame
            time.sleep(1)
        finally:
            conn.close()

    t = threading.Thread(target=junk_server, daemon=True)
    t.start()
    try:
        pipe = _make_pipeline(1, 60, 106)
        client = MulticameraClient([("127.0.0.1", port)], pipe,
                                   stale_timeout=0.3,
                                   reconnect=False).start()
        deadline = time.time() + 5
        while client._slots[0].alive and time.time() < deadline:
            time.sleep(0.05)
        assert not client._slots[0].alive
        assert client.camera_errors()  # cause is surfaced
        assert client.step() is None   # no live cameras -> clean None
        client.stop()
    finally:
        srv.close()


def test_camera_reconnects_after_server_restart():
    """Ingest threads retry with backoff: when a camera server comes back,
    its slot resurrects and frames flow again (the reference client would
    be stuck forever)."""
    ncam, h, w = 1, 60, 106
    frames = synthetic_frames(4, h, w, seed=2)
    srv = FakeCameraServer(frames, die_after=2).start()
    port = srv.port
    pipe = _make_pipeline(ncam, h, w)
    client = MulticameraClient([("127.0.0.1", port)], pipe,
                               stale_timeout=0.3).start()
    try:
        assert client.wait_for_first_frames(timeout=10)
        time.sleep(0.8)  # server dies after 2 frames; slot goes stale
        assert client.step() is None
        srv.stop()
        # restart a fresh server on the same port
        srv = FakeCameraServer(frames, port=port).start()
        deadline = time.time() + 15
        out = None
        while out is None and time.time() < deadline:
            time.sleep(0.2)
            out = client.step()
        assert out is not None, "camera did not resurrect"
        client.stop()
    finally:
        srv.stop()


def test_camera_survives_corrupt_frame(rng):
    """A corrupt compressed body raises zlib.error — NOT in the old
    (OSError, ConnectionError, ValueError) catch list (r5 review): the
    ingest thread died with slot.alive still True, no error surfaced, no
    reconnect. The contract: any decode failure marks the slot dead with
    an error and the backoff/resurrect machinery rides out the fault."""
    from pointcloud_stitching_tpu.runtime.wire import (
        HEADER_SIZE, Codec, encode_depth_frame, recv_exact)

    h, w = 60, 106
    frame = (rng.random((h, w)) * 4000).astype(np.uint16)
    good = encode_depth_frame(frame, 0, codec=Codec.ZLIB)
    bad = bytearray(good)
    for i in range(HEADER_SIZE + 4, min(len(bad), HEADER_SIZE + 64)):
        bad[i] ^= 0xFF                  # corrupt the zlib body, keep size
    bad = bytes(bad)

    state = {"conns": 0}
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(2)
    port = srv.getsockname()[1]

    def serve():
        while state["conns"] < 4:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            state["conns"] += 1
            first = state["conns"] == 1
            try:
                while True:
                    recv_exact(conn, 1)
                    conn.sendall(bad if first else good)
                    if first:
                        break           # one poisoned frame, then hang up
            except (OSError, ConnectionError):
                pass
            finally:
                conn.close()

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    client = MulticameraClient([("127.0.0.1", port)],
                               _make_pipeline(1, h, w),
                               stale_timeout=0.5).start()
    try:
        deadline = time.time() + 15
        out = None
        while out is None and time.time() < deadline:
            time.sleep(0.2)
            out = client.step()
        assert out is not None, \
            f"camera never resurrected after the corrupt frame " \
            f"(errors: {client.camera_errors()})"
        assert state["conns"] >= 2      # it actually reconnected
    finally:
        client.stop()
        srv.close()


def test_wire_decompress_bounded():
    """decode_frame bounds the DECOMPRESSED size (r5 review): a zlib bomb
    inside a small body must fail fast with ValueError, not allocate
    gigabytes; the snappy preamble is rejected before any allocation."""
    import zlib

    import pytest

    from pointcloud_stitching_tpu.runtime import wire

    bomb = zlib.compress(b"\x00" * 200_000, 9)        # ~200 B compressed
    with pytest.raises(ValueError, match="exceeds"):
        wire.decompress(bomb, wire.Codec.ZLIB, max_out=100_000)
    # in-bound streams round-trip unchanged through the bounded path
    data = b"abc" * 1000
    assert wire.decompress(zlib.compress(data), wire.Codec.ZLIB,
                           max_out=10_000) == data
    # snappy: a varint preamble claiming ~4 GB is rejected from the
    # preamble alone (no native decompress call, no allocation)
    assert wire._snappy_preamble_len(b"\xff\xff\xff\xff\x0f") == 0xFFFFFFFF
    if wire._get_snappy() is not None:
        with pytest.raises(ValueError, match="claims"):
            wire.decompress(b"\xff\xff\xff\xff\x0f" + b"\x00" * 16,
                            wire.Codec.SNAPPY, max_out=1 << 20)


def test_fake_server_rejects_points_with_native_color():
    """points=True textures each depth pixel with its own color pixel, so
    a native-resolution color grid must be refused up front (r5 review:
    it used to crash with an opaque boolean-index IndexError)."""
    import pytest

    frames = synthetic_frames(2, 24, 32, seed=0)
    with pytest.raises(ValueError, match="depth-aligned"):
        FakeCameraServer(frames, points=True, color=True,
                         color_shape=(48, 64))


def test_cloud_publisher_fanout(rng):
    """Stitched-cloud publisher: consumers receive the stream in the wire
    format; a dead consumer is dropped without affecting the rest."""
    from pointcloud_stitching_tpu.runtime import CloudPublisher
    from pointcloud_stitching_tpu.runtime.wire import Kind, recv_frame

    pub = CloudPublisher(host="127.0.0.1").start()
    try:
        c1 = socket.create_connection(("127.0.0.1", pub.port), timeout=5)
        c2 = socket.create_connection(("127.0.0.1", pub.port), timeout=5)
        deadline = time.time() + 5
        while pub.num_subscribers < 2 and time.time() < deadline:
            time.sleep(0.01)
        xyz = rng.uniform(-2, 2, (500, 3)).astype(np.float32)
        rgb = rng.integers(0, 255, (500, 3)).astype(np.uint8)
        n = pub.publish(xyz, rgb)
        assert n == 2
        for c in (c1, c2):
            kind, seq, (got_xyz, got_rgb) = recv_frame(c)
            assert kind == Kind.POINTS_I16MM and seq == 0
            np.testing.assert_allclose(got_xyz, xyz, atol=5.1e-4)
            np.testing.assert_array_equal(got_rgb, rgb)
        c2.close()
        time.sleep(0.05)
        n = pub.publish(xyz)  # dead consumer dropped, stream continues
        kind, seq, (got_xyz, got_rgb) = recv_frame(c1)
        assert seq == 1 and got_rgb is None
        c1.close()
    finally:
        pub.stop()


def test_publisher_stalled_subscriber_is_dropped(rng):
    """A subscriber that connects but never reads must not backpressure
    publish(): its TCP buffer fills, sendall times out, and the consumer is
    dropped — the stitch loop keeps pacing."""
    from pointcloud_stitching_tpu.runtime import CloudPublisher

    pub = CloudPublisher(host="127.0.0.1", send_timeout=0.2).start()
    try:
        stalled = socket.create_connection(("127.0.0.1", pub.port), timeout=5)
        # shrink both receive windows so the stall trips quickly
        stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
        deadline = time.time() + 5
        while pub.num_subscribers < 1 and time.time() < deadline:
            time.sleep(0.01)
        xyz = rng.uniform(-2, 2, (200000, 3)).astype(np.float32)
        # publish until the stalled consumer's buffers fill and it drops;
        # each publish must return within ~send_timeout, never block forever
        dropped_at = None
        for i in range(50):
            t0 = time.time()
            n = pub.publish(xyz)
            assert time.time() - t0 < 5.0, "publish blocked on stalled consumer"
            if n == 0:
                dropped_at = i
                break
        assert dropped_at is not None, "stalled subscriber never dropped"
        assert pub.num_subscribers == 0
        stalled.close()
        # publisher still serves fresh consumers afterwards
        fresh = socket.create_connection(("127.0.0.1", pub.port), timeout=5)
        deadline = time.time() + 5
        while pub.num_subscribers < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert pub.publish(xyz[:100]) == 1
        from pointcloud_stitching_tpu.runtime.wire import recv_frame as rf
        kind, _, (got, _) = rf(fresh)
        assert len(got) == 100
        fresh.close()
    finally:
        pub.stop()


def test_bounded_run_terminates_when_all_cameras_die():
    """With every camera dead, a bounded overlapped
    run(num_frames=N) must return after dead_timeout instead of spinning
    forever; num_frames still counts only stitched frames."""
    ncam, h, w = 1, 60, 106
    srv = FakeCameraServer(synthetic_frames(4, h, w), die_after=1).start()
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe,
                                   stale_timeout=0.2, reconnect=False).start()
        client.wait_for_first_frames(timeout=10)
        time.sleep(0.5)  # camera dies and goes stale
        t0 = time.time()
        metrics = client.run(num_frames=100, overlap=True, dead_timeout=1.0)
        assert time.time() - t0 < 10.0
        assert metrics.total_frames < 100  # outage: fewer frames, honest count
    finally:
        client.stop()
        srv.stop()


def test_serial_run_counts_only_stitched_frames():
    """_run_serial must not count dead ticks toward
    num_frames — a bounded serial run returns exactly N stitched frames
    when the cameras are healthy, and terminates via dead_timeout when not."""
    ncam, h, w = 1, 60, 106
    srv = FakeCameraServer(synthetic_frames(8, h, w)).start()
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe).start()
        assert client.wait_for_first_frames(timeout=10)
        outs = []
        metrics = client.run(num_frames=4, overlap=False,
                             on_frame=lambda i, o: outs.append(o))
        assert len(outs) == 4
        assert metrics.total_frames == 4
    finally:
        client.stop()
        srv.stop()


def test_repeated_bounded_runs_on_one_client():
    """run() must leave the client started so bounded runs can be issued
    repeatedly on one rig (the interleaved benchmark alternates sync_every
    modes this way; run() used to stop() in a finally, so every window
    after the first returned instantly with zero frames)."""
    ncam, h, w = 2, 60, 106
    servers = [FakeCameraServer(synthetic_frames(8, h, w, seed=s)).start()
               for s in range(ncam)]
    try:
        pipe = _make_pipeline(ncam, h, w)
        with MulticameraClient([("127.0.0.1", s.port) for s in servers],
                               pipe) as client:
            assert client.wait_for_first_frames(timeout=10)
            for sync_every in (1, 4, 1):
                client.metrics.reset()
                m = client.run(num_frames=3, overlap=True,
                               sync_every=sync_every)
                assert m.total_frames == 3, sync_every
    finally:
        for s in servers:
            s.stop()


def test_run_zero_frames_returns_immediately():
    ncam, h, w = 1, 60, 106
    srv = FakeCameraServer(synthetic_frames(4, h, w)).start()
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe).start()
        assert client.wait_for_first_frames(timeout=10)
        t0 = time.time()
        metrics = client.run(num_frames=0)
        assert time.time() - t0 < 1.0
        assert metrics.total_frames == 0
        client.stop()
    finally:
        srv.stop()


def test_unbounded_run_survives_outage_past_dead_timeout():
    """r3 review: dead_timeout must only bound *bounded* runs. An unbounded
    run (num_frames=None — a long-lived streaming service) must keep
    waiting through an outage longer than dead_timeout so the reconnect
    machinery can bring cameras back."""
    ncam, h, w = 1, 60, 106
    srv = FakeCameraServer(synthetic_frames(4, h, w), die_after=1).start()
    client = None
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe,
                                   stale_timeout=0.2, reconnect=False).start()
        client.wait_for_first_frames(timeout=10)
        time.sleep(0.5)  # camera dies and goes stale
        done = threading.Event()

        def run():
            client.run(num_frames=None, overlap=True, dead_timeout=0.3)
            done.set()

        t = threading.Thread(target=run, daemon=True)
        t.start()
        # well past dead_timeout with zero live cameras: must still be in
        # the loop (a bounded run with these settings exits in ~0.3 s)
        assert not done.wait(timeout=1.5)
        client.stop()  # stop() is the only way an unbounded run ends
        assert done.wait(timeout=5.0)
    finally:
        if client is not None:
            client.stop()
        srv.stop()


def test_on_demand_trickle_stays_under_stale_timeout():
    """r3 review: the on-demand stall-trickle period must sit well under
    stale_timeout, or a healthy camera's frame age oscillates past the
    staleness test whenever the stitch tick outpaces consumption."""
    ncam, h, w = 1, 60, 106
    srv = FakeCameraServer(synthetic_frames(8, h, w)).start()
    client = None
    try:
        pipe = _make_pipeline(ncam, h, w)
        client = MulticameraClient([("127.0.0.1", srv.port)], pipe,
                                   stale_timeout=0.2).start()
        assert client._threads[0]._trickle <= 0.2 / 2
        client.wait_for_first_frames(timeout=10)
        # a consumer slower than stale_timeout: the camera must never be
        # masked stale while the server is healthy
        for _ in range(4):
            time.sleep(0.3)
            _data, mask = client._snapshot()
            assert bool(mask[0]), "healthy camera flapped stale"
    finally:
        if client is not None:
            client.stop()
        srv.stop()
