"""Streaming multicamera client: TCP ingest → batched device feed → stitcher.

Accelerator re-design of the reference client's runtime (reference:
src/pcs-multicamera-client.cpp — SURVEY.md §3.2/§3.3). Kept from the
reference: pull-based protocol, one ingest thread per camera, freshest-frame
semantics. Changed for the accelerator:

  * ingest threads only move bytes (decompress into a pinned staging slot);
    all geometry happens in the jitted device step,
  * the per-camera clouds of the reference become one [ncam, H, W] batch,
    transferred per tick with a single host-to-device copy,
  * single-writer slots (one thread per camera, main loop reads a snapshot)
    replace the reference's shared-cloud mutex dance (SURVEY.md §5: its
    client has real data races; this design has none by construction),
  * a camera that stalls or dies is dropped from the batch via cam_mask —
    fixed shapes make failure handling free (the reference blocks/crashes).
"""
from __future__ import annotations

import socket
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from ..models.stitcher import StitchingPipeline, StitchOutput
from ..utils.metrics import FrameMetrics, StageTimer
from .wire import Kind, recv_frame, send_pull


class _CameraSlot:
    """Single-writer staging slot holding a camera's freshest frame.

    Depth mode: a [H, W] uint16 image. Points mode (legacy interop): a
    padded [H*W, 3] float32 point buffer + valid count.
    """

    def __init__(self, h: int, w: int, points: bool = False,
                 color: bool = False, color_shape=None):
        self.points = points
        self.color = color
        if points:
            self.xyz = np.zeros((h * w, 3), np.float32)
            self.rgb = np.zeros((h * w, 3), np.uint8) if color else None
            self.count = 0
        else:
            self.frame = np.zeros((h, w), np.uint16)
            ch, cw = color_shape if color_shape is not None else (h, w)
            self.rgb = np.zeros((ch, cw, 3), np.uint8) if color else None
        self.seq = -1
        self.stamp = 0.0
        self.lock = threading.Lock()
        self.alive = True
        self.error: Optional[str] = None
        # pull gate for on-demand mode: set when the consumer has read this
        # slot (pull the next frame), cleared right after each pull.
        # Starts set so the first frame fetches immediately.
        self.consumed = threading.Event()
        self.consumed.set()


class CameraIngest(threading.Thread):
    """Per-camera ingest thread: pull → recv → decompress → slot."""

    def __init__(self, index: int, address: tuple[str, int], slot: _CameraSlot,
                 stop: threading.Event, connect_timeout: float = 5.0,
                 record_frames: int = 0, reconnect: bool = True,
                 reconnect_backoff: float = 0.5,
                 pull_mode: str = "on_demand",
                 trickle: float = 0.25):
        super().__init__(daemon=True, name=f"ingest-cam{index}")
        self.index = index
        self.address = address
        self.slot = slot
        self._stop = stop
        self._connect_timeout = connect_timeout
        self._reconnect = reconnect
        self._backoff = reconnect_backoff
        self._on_demand = pull_mode == "on_demand"
        self._trickle = trickle
        # record+replay (SURVEY.md §5 checkpoint/record): keep the first K
        # received depth (+color) frames for .npy export via
        # Client.save_recording
        self.record_frames = record_frames
        self.recorded: list[np.ndarray] = []
        self.recorded_color: list[np.ndarray] = []

    def run(self) -> None:
        """Pull loop with reconnection: a dead camera server marks its slot
        stale (so the stitcher drops it from the batch) but the thread keeps
        retrying with backoff and resurrects the slot when the server
        returns — the reference client permanently blocks/crashes instead
        (SURVEY.md §5 failure handling)."""
        backoff = self._backoff
        while not self._stop.is_set():
            self._run_once()
            if not self._reconnect:
                return
            # slot is dead; wait and retry (capped exponential backoff)
            if self._stop.wait(backoff):
                return
            backoff = min(backoff * 2, 5.0)

    def _run_once(self) -> None:
        try:
            sock = socket.create_connection(self.address,
                                            timeout=self._connect_timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.settimeout(5.0)
        except OSError as e:
            self.slot.error = f"connect {self.address}: {e}"
            self.slot.alive = False
            return
        self.slot.alive = True
        self.slot.error = None
        try:
            while not self._stop.is_set():
                if self._on_demand:
                    # pull only after the consumer read the previous frame:
                    # a slower-than-camera stitch loop then never pays for
                    # frames it would discard, and the decompress work stops
                    # competing with dispatch for the CPU (on a 1-core host
                    # continuous pulls starve the main loop). The timeout
                    # keeps a trickle of pulls flowing when the consumer
                    # stalls, so freshness probing and death detection via
                    # recv errors both keep working. The trickle period must
                    # sit well under the client's stale_timeout (the caller
                    # derives it), or a healthy camera's frame age would
                    # oscillate past the staleness test between consumptions.
                    self.slot.consumed.wait(timeout=self._trickle)
                    self.slot.consumed.clear()
                send_pull(sock)
                kind, seq, payload = recv_frame(sock)
                if self.slot.points:
                    if kind != Kind.POINTS_I16MM:
                        raise ValueError(f"expected point frames, got {kind}")
                    xyz, rgb = payload
                    n = min(len(xyz), len(self.slot.xyz))
                    with self.slot.lock:
                        self.slot.xyz[:n] = xyz[:n]
                        if self.slot.rgb is not None and rgb is not None:
                            self.slot.rgb[:n] = rgb[:n]
                        self.slot.count = n
                        self.slot.seq = seq
                        self.slot.stamp = time.time()
                    continue
                rgb = None
                if kind in (Kind.DEPTH16_COLOR, Kind.DEPTH16_COLOR_NATIVE):
                    payload, rgb = payload
                    if self.slot.rgb is not None and \
                            rgb.shape != self.slot.rgb.shape:
                        raise ValueError(
                            f"camera {self.index} sent color {rgb.shape} "
                            f"but the pipeline expects "
                            f"{self.slot.rgb.shape} (set StitchConfig "
                            f"color_height/color_width to match)")
                elif kind != Kind.DEPTH16:
                    raise ValueError(f"unexpected frame kind {kind}")
                if payload.shape != self.slot.frame.shape:
                    raise ValueError(
                        f"camera {self.index} sent {payload.shape} frames "
                        f"but the pipeline expects {self.slot.frame.shape} "
                        f"(set StitchConfig height/width to match)")
                if len(self.recorded) < self.record_frames:
                    self.recorded.append(payload.copy())
                    if rgb is not None:
                        self.recorded_color.append(rgb.copy())
                with self.slot.lock:
                    self.slot.frame[...] = payload
                    if self.slot.rgb is not None and rgb is not None:
                        self.slot.rgb[...] = rgb
                    self.slot.seq = seq
                    self.slot.stamp = time.time()
        except Exception as e:  # noqa: BLE001 — deliberate breadth:
            # the decode path raises more than (OSError, ValueError):
            # zlib.error on a corrupt stream, struct.error on a short
            # native-color payload, RuntimeError when the snappy codec
            # isn't built, MemoryError on a hostile size preamble. Any
            # of those escaping would KILL the thread with slot.alive
            # still True — no error surfaced, no reconnect, the camera
            # silently stale forever. The contract of this loop is that
            # every failure marks the slot dead and feeds the backoff/
            # resurrect machinery (SURVEY.md §5); a one-frame corruption
            # then costs one reconnect, not the camera.
            self.slot.error = f"{type(e).__name__}: {e}"
            self.slot.alive = False
        finally:
            try:
                sock.close()
            except OSError:
                pass


class MulticameraClient:
    """Connects to N camera servers and runs the stitching pipeline live."""

    def __init__(self, addresses: Sequence[tuple[str, int]],
                 pipeline: StitchingPipeline,
                 stale_timeout: float = 0.5,
                 payload: str = "depth",
                 record_frames: int = 0,
                 reconnect: bool = True,
                 pull_mode: str = "on_demand"):
        """pull_mode: 'on_demand' (default) pulls a camera only after the
        previous frame was consumed by a snapshot — when the stitch loop is
        at least as fast as the cameras this is identical to continuous
        pulling, and when it is slower it stops fetching/decompressing
        frames nobody will use. 'continuous' pulls flat-out for the
        freshest-possible frame at any snapshot instant (worth up to one
        camera period of staleness; costs a core per few cameras)."""
        cfg = pipeline.cfg
        if len(addresses) != cfg.num_cameras:
            raise ValueError("address count != cfg.num_cameras")
        if payload not in ("depth", "points"):
            raise ValueError("payload must be 'depth' or 'points'")
        if pull_mode not in ("on_demand", "continuous"):
            raise ValueError("pull_mode must be 'on_demand' or 'continuous'")
        self.pipeline = pipeline
        self.payload = payload
        self.stale_timeout = stale_timeout
        self.metrics = FrameMetrics()
        self.stages = StageTimer()
        self._stop = threading.Event()
        cshape = (None if cfg.color_height is None
                  else (cfg.color_height, cfg.color_width))
        self._slots = [_CameraSlot(cfg.height, cfg.width,
                                   points=payload == "points",
                                   color=cfg.with_color, color_shape=cshape)
                       for _ in addresses]
        self._threads = [
            CameraIngest(i, addr, slot, self._stop,
                         record_frames=record_frames, reconnect=reconnect,
                         pull_mode=pull_mode,
                         # keep the stall-trickle period well under the
                         # staleness test or a healthy camera flaps stale
                         # whenever the stitch tick outpaces consumption
                         trickle=min(0.25, stale_timeout / 4.0))
            for i, (addr, slot) in enumerate(zip(addresses, self._slots))]
        self._stage_ring: list = []   # see _ensure_stage_ring
        self._stage_i = 0

    def _ensure_stage_ring(self, depth: int) -> None:
        """Size the snapshot staging ring for a given in-flight bound.

        jax.device_put may read the host buffer asynchronously, so a
        staging buffer must not be rewritten until the program that
        consumed it has executed. With host syncs every K frames at most
        K+1 frames are in flight; a ring of K+2 buffers is therefore
        tear-safe. Buffers are reused (not reallocated) because fresh
        np.empty page-faults ~3.3 MB/tick inside the snapshot window."""
        cfg = self.pipeline.cfg
        ch = cfg.color_height or cfg.height
        cw = cfg.color_width or cfg.width
        while len(self._stage_ring) < depth:
            if self.payload == "points":
                cap = cfg.height * cfg.width
                buf = (np.zeros((cfg.num_cameras, cap, 3), np.float32),
                       np.zeros((cfg.num_cameras, cap), bool),
                       np.zeros((cfg.num_cameras, cap, 3), np.uint8)
                       if cfg.with_color else None)
            else:
                buf = (np.empty((cfg.num_cameras, cfg.height, cfg.width),
                                np.uint16),
                       np.zeros((cfg.num_cameras, ch, cw, 3), np.uint8)
                       if cfg.with_color else None)
            self._stage_ring.append(buf)

    def _next_stage(self):
        if not self._stage_ring:
            self._ensure_stage_ring(3)
        buf = self._stage_ring[self._stage_i % len(self._stage_ring)]
        self._stage_i += 1
        return buf

    def save_recording(self, directory: str) -> list[str]:
        """Dump recorded per-camera depth (+color) streams as replayable
        .npy files (feed them back through fake_server --frames
        [--color-frames])."""
        import os
        os.makedirs(directory, exist_ok=True)
        paths = []
        for t in self._threads:
            if t.recorded:
                p = os.path.join(directory, f"cam{t.index}.npy")
                np.save(p, np.stack(t.recorded))
                paths.append(p)
            if t.recorded_color:
                p = os.path.join(directory, f"cam{t.index}_color.npy")
                np.save(p, np.stack(t.recorded_color))
                paths.append(p)
        return paths

    def start(self) -> "MulticameraClient":
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def __enter__(self) -> "MulticameraClient":
        if all(t.ident is None for t in self._threads):  # never started
            self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def wait_for_first_frames(self, timeout: float = 10.0) -> bool:
        """Wait until every camera has either delivered a frame or is down
        (with at least one frame somewhere). `alive` flaps during reconnect
        backoff, so "delivered a frame ever" (seq >= 0) is the stable signal.
        """
        deadline = time.time() + timeout
        while time.time() < deadline:
            if all((s.seq >= 0) or not s.alive for s in self._slots) and \
                    any(s.seq >= 0 for s in self._slots):
                return True
            time.sleep(0.01)
        return False

    def camera_errors(self) -> list[str]:
        """Why dead cameras died (for operator diagnostics)."""
        return [f"cam{i}: {s.error}" for i, s in enumerate(self._slots)
                if s.error]

    def _wake_pulls(self) -> None:
        """Release the on-demand ingest pulls (one per camera).

        Scheduling matters on a host with few cores: waking a camera
        thread makes it send_pull + recv + decompress immediately,
        contending (GIL) with whatever the main loop does next. Waking
        *after* the next frame's program is dispatched parks that work
        under the sync wait — where the main thread blocks with the GIL
        released — instead of under the snapshot/H2D window."""
        for s in self._slots:
            s.consumed.set()

    def _snapshot(self, wake: bool = True):
        """Copy the freshest frames out of the slots; compute the cam mask."""
        cfg = self.pipeline.cfg
        now = time.time()
        mask = np.zeros((cfg.num_cameras,), bool)
        if self.payload == "points":
            xyz, pmask, rgb = self._next_stage()
            pmask[...] = False
            for i, s in enumerate(self._slots):
                with s.lock:
                    xyz[i] = s.xyz
                    if rgb is not None and s.rgb is not None:
                        rgb[i] = s.rgb
                    pmask[i, :s.count] = True
                    fresh = s.alive and s.seq >= 0 and \
                        (now - s.stamp) <= self.stale_timeout
                mask[i] = fresh
            if wake:
                self._wake_pulls()
            return (xyz, pmask, rgb), mask
        # staging buffers come from a reused ring: a fresh np.empty
        # page-faults ~3.3 MB of zero pages every tick, and those faults
        # land inside the snapshot window. The ring is sized so a buffer is
        # only reused after its frame's program MUST have consumed it
        # (bounded by the sync cadence — see _ensure_stage_ring).
        depths, colors = self._next_stage()
        t_lock = t_copy = 0.0
        for i, s in enumerate(self._slots):
            ta = time.time()
            with s.lock:
                tb = time.time()
                depths[i] = s.frame
                if colors is not None and s.rgb is not None:
                    colors[i] = s.rgb
                fresh = s.alive and s.seq >= 0 and \
                    (now - s.stamp) <= self.stale_timeout
            t_lock += tb - ta
            t_copy += time.time() - tb
            mask[i] = fresh
        if wake:
            self._wake_pulls()
        self.stages.record("snap_lock", t_lock)
        self.stages.record("snap_copy", t_copy)
        return (depths, colors), mask

    def _transfer(self, data, mask):
        """Dispatch async host→device copies of a snapshot.

        jax.device_put returns as soon as the copy is *enqueued*, so calling
        this while the previous frame's stitch program is still executing
        overlaps the PCIe/DCN transfer with device compute (SURVEY.md §2.4
        row 3: the double-buffered feed; the reference's equivalent is its
        capture-while-stitching pipeline overlap). Returns (device_data,
        device_mask, npix).
        """
        import jax

        d_mask = jax.device_put(mask)
        if self.payload == "points":
            xyz, pmask, rgb = data
            dev = (jax.device_put(xyz), jax.device_put(pmask),
                   None if rgb is None else jax.device_put(rgb))
            return dev, d_mask, xyz.shape[0] * xyz.shape[1]
        depths, colors = data
        dev = (jax.device_put(depths),
               None if colors is None else jax.device_put(colors))
        return dev, d_mask, int(np.prod(depths.shape))

    def _dispatch(self, dev, d_mask) -> StitchOutput:
        """Enqueue one stitch program on device-resident inputs (no sync)."""
        if self.payload == "points":
            d_xyz, d_pmask, d_rgb = dev
            return self.pipeline.step_points(d_xyz, d_pmask, rgb=d_rgb,
                                             cam_mask=d_mask)
        d_depths, d_colors = dev
        out = self.pipeline(d_depths, colors=d_colors, cam_mask=d_mask)
        # attach the frame's raw device inputs so on_frame consumers
        # (e.g. stitch_cli's --tsdf keyframe integrate) can run
        # depth-domain models on the exact frame the stitch saw —
        # references only, no copies, and pipelined mode pairs them
        # with the right frame (the client may already be dispatching
        # frame n+1 when on_frame(n) runs)
        return out._replace(depth=d_depths, color=d_colors,
                            cam_mask=d_mask)

    @staticmethod
    def _sync(out: StitchOutput) -> int:
        """Block until the frame's program finished (one scalar pull;
        output clouds stay on device)."""
        return int(out.metrics.points_out)

    def step(self) -> Optional[StitchOutput]:
        """One serial stitch tick over the freshest frames (snapshot → H2D →
        compute → sync). None if no camera is live. For steady-state
        streaming prefer run(), which overlaps H2D with compute."""
        t0 = time.time()
        data, mask = self._snapshot(wake=False)
        live = int(mask.sum())
        self.metrics.dropped_cameras = self.pipeline.cfg.num_cameras - live
        if live == 0:
            self._wake_pulls()
            return None
        t1 = time.time()
        dev, d_mask, npix = self._transfer(data, mask)
        t2 = time.time()
        out = self._dispatch(dev, d_mask)
        self._wake_pulls()  # ingest recv/decode rides under the sync wait
        self._sync(out)
        t3 = time.time()
        self.stages.record("snapshot", t1 - t0)
        self.stages.record("h2d", t2 - t1)
        self.stages.record("stitch", t3 - t2)
        self.metrics.record(t3 - t0, points=npix)
        return out

    def run(self, num_frames: Optional[int] = None,
            on_frame: Optional[Callable[[int, StitchOutput], None]] = None,
            overlap: bool = True, sync_every: int = 1,
            dead_timeout: Optional[float] = 30.0,
            fps: Optional[float] = None) -> FrameMetrics:
        """Streaming loop. With overlap=True (default) the loop is software-
        pipelined one frame deep: while frame N's program executes on the
        device, the host already snapshots and enqueues frame N+1's
        transfer, so the H2D copy rides under device compute instead of
        serialising with it. Frame N is only synced
        *after* N+1's transfer is in flight. on_frame(n, out) still sees
        every completed frame in order.

        sync_every: host-sync (and record a latency sample) only every K-th
        frame, letting the device pipeline run deeper. With K=1 (default)
        every frame is synced — true per-frame latency. K>1 measures
        sustainable throughput when the consumer doesn't need a host-side
        result each frame (JAX arrays handed to on_frame are async
        anyway).

        num_frames counts *stitched* frames (ticks where every camera was
        dead deliver nothing and don't count). So that a bounded run can't
        spin forever during a total outage, dead_timeout (seconds, None =
        forever) bounds how long a *bounded* run waits with zero live
        cameras and nothing in flight before returning early; any stitched
        frame resets the clock. Unbounded runs (num_frames=None — a
        long-lived streaming service) ignore it and keep waiting: the
        ingest threads' reconnect machinery exists exactly to ride out
        outages longer than any fixed timeout.

        fps paces the loop to that many stitch ticks per second (wall
        clock). The reference's client is implicitly paced by the 30 FPS
        camera cadence (src/pcs-multicamera-client.cpp blocks on fresh
        frames — SURVEY.md §3.2); this client snapshots the freshest slot
        without blocking, so unpaced it free-runs, re-stitching stale
        frames and burning host CPU the ingest threads need. Late ticks
        don't bank debt: a stall resets the schedule instead of triggering
        a catch-up burst.

        The client stays started when run() returns, so bounded runs can be
        issued repeatedly on one client (e.g. alternating sync_every modes
        against the same rig); call stop() — or use the client as a context
        manager — to tear down the ingest threads.
        """
        if num_frames is not None and num_frames <= 0:
            return self.metrics
        if not overlap:
            return self._run_serial(num_frames, on_frame, dead_timeout, fps)
        sync_every = max(int(sync_every), 1)
        self._ensure_stage_ring(sync_every + 2)
        n = 0
        last_alive = time.time()
        tick = (1.0 / fps) if fps else None
        next_t = time.time() if tick is not None else 0.0
        pending: Optional[tuple[StitchOutput, float, int]] = None
        try:
            while not self._stop.is_set():
                # don't dispatch past num_frames: with one frame in flight
                # and n delivered, dispatching here would start an (N+1)-th
                # frame that is discarded at the break below — a full wasted
                # H2D + stitch per bounded run
                in_flight = 1 if pending is not None else 0
                if num_frames is not None and n + in_flight >= num_frames:
                    nxt = None
                else:
                    if tick is not None:
                        # pace the dispatch side only — the drain below must
                        # never wait on the schedule, or the pipeline stalls
                        delay = next_t - time.time()
                        if delay > 0:
                            self._stop.wait(delay)
                        next_t = max(next_t + tick, time.time())
                    t0 = time.time()
                    data, mask = self._snapshot(wake=False)
                    live = int(mask.sum())
                    self.metrics.dropped_cameras = \
                        self.pipeline.cfg.num_cameras - live
                    t1 = time.time()
                    if live > 0:
                        dev, d_mask, npix = self._transfer(data, mask)
                        t2 = time.time()
                        out = self._dispatch(dev, d_mask)
                        self.stages.record("dispatch", time.time() - t2)
                        self._wake_pulls()  # decode rides under sync_wait
                        # latency is measured snapshot-start -> sync (true
                        # end-to-end frame latency, spans the overlap)
                        nxt = (out, t0, npix)
                    else:
                        t2, nxt = t1, None
                        self._wake_pulls()
                        if pending is None:
                            # nothing in flight and nothing to stitch: don't
                            # busy-spin while every camera is down — and give
                            # up entirely once the outage outlasts
                            # dead_timeout
                            if num_frames is not None and \
                                    dead_timeout is not None and \
                                    time.time() - last_alive > dead_timeout:
                                break
                            self._stop.wait(0.005)
                    self.stages.record("snapshot", t1 - t0)
                    # under overlap this stage is the device_put ENQUEUE,
                    # which backpressures while the previous frame's bytes
                    # still stream to the device, so it can read as the
                    # per-frame transfer time rather than host work.
                    self.stages.record("h2d", t2 - t1)
                # drain frame N while N+1 runs (its H2D is already enqueued)
                if pending is not None:
                    p_out, p_t0, p_npix = pending
                    last = num_frames is not None and n + 1 >= num_frames
                    if n % sync_every == 0 or last:
                        t_wait = time.time()
                        self._sync(p_out)
                        t3 = time.time()
                        self.stages.record("sync_wait", t3 - t_wait)
                        self.metrics.record(t3 - p_t0, points=p_npix)
                    else:
                        # unsynced frame: count it (throughput) without a
                        # latency sample — the dispatch time isn't one
                        self.metrics.record_unsynced(points=p_npix)
                    if on_frame is not None:
                        on_frame(n, p_out)
                    n += 1
                    last_alive = time.time()
                    if num_frames is not None and n >= num_frames:
                        break
                pending = nxt
            if pending is not None and not self._stop.is_set() and \
                    (num_frames is None or n < num_frames):
                p_out, p_t0, p_npix = pending
                t_wait = time.time()
                self._sync(p_out)
                # record the drain sync too (this branch serves unbounded/
                # stopped runs; bounded windows sync their last frame
                # in-loop) — the stage table should account every sync
                self.stages.record("sync_wait", time.time() - t_wait)
                self.metrics.record(time.time() - p_t0, points=p_npix)
                if on_frame is not None:
                    on_frame(n, p_out)
        except BaseException:
            # an exception escaping the loop (including KeyboardInterrupt)
            # tears the client down — the in-flight frame is unowned
            self.stop()
            raise
        return self.metrics

    def _run_serial(self, num_frames, on_frame,
                    dead_timeout: Optional[float] = 30.0,
                    fps: Optional[float] = None) -> FrameMetrics:
        """Serial loop. Only stitched frames count toward num_frames
;
        dead_timeout bounds the wait during a total outage instead."""
        n = 0
        last_alive = time.time()
        tick = (1.0 / fps) if fps else None
        next_t = time.time() if tick is not None else 0.0
        try:
            while not self._stop.is_set():
                if tick is not None:
                    delay = next_t - time.time()
                    if delay > 0:
                        self._stop.wait(delay)
                    next_t = max(next_t + tick, time.time())
                out = self.step()
                if out is None:
                    if num_frames is not None and dead_timeout is not None \
                            and time.time() - last_alive > dead_timeout:
                        break
                    self._stop.wait(0.005)  # all cameras down: no busy-spin
                    continue
                last_alive = time.time()
                if on_frame is not None:
                    on_frame(n, out)
                n += 1
                if num_frames is not None and n >= num_frames:
                    break
        except BaseException:
            self.stop()
            raise
        return self.metrics
