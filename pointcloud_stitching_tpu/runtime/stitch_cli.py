"""Multicamera stitching client CLI.

Equivalent of the reference's pcs-multicamera-client binary (reference:
src/pcs-multicamera-client.cpp main() + getopt flags — SURVEY.md §3.2).
Flag parity (reference flag → here):
  -n num cameras / IP list  → --camera host:port (repeat)
  .cal directory            → --cal-dir (reference loads one .cal per camera)
  -f fps display            → --print-every
  -t timing                 → --timing (per-stage breakdown)
  -s save                   → --save-dir (PLY snapshot per --save-every)
  -d downsample             → --leaf / config
  -v visualize              → no PCL viewer here; --save-dir is the sink

CLI:
  python -m pointcloud_stitching_tpu.runtime.stitch_cli \
      --camera 127.0.0.1:8000 --camera 127.0.0.1:8001 \
      [--cal-dir cals/] [--config cfg.json] [--frames 300] \
      [--save-dir out/ --save-every 30]
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    from ..utils.platform import setup_compilation_cache
    setup_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--camera", action="append", required=True,
                    help="host:port of a camera server (repeat per camera)")
    ap.add_argument("--cal-dir", help="directory of per-camera .cal files "
                                      "(sorted by name = camera order)")
    ap.add_argument("--intr-dir",
                    help="directory of per-camera .intr.json intrinsics "
                         "(sorted by name = camera order; default: nominal "
                         "D435 factory values — fine for fake servers, wrong "
                         "for real cameras)")
    ap.add_argument("--config", help="StitchConfig JSON path")
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--print-every", type=int, default=30)
    ap.add_argument("--timing", action="store_true")
    ap.add_argument("--save-dir")
    ap.add_argument("--save-every", type=int, default=30)
    ap.add_argument("--leaf", type=float, default=None,
                    help="override output voxel leaf (meters)")
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--no-icp", action="store_true")
    ap.add_argument("--crop", default=None, metavar="X0,Y0,Z0:X1,Y1,Z1",
                    help="world-frame crop box for the fused cloud "
                         "(meters; the pcl::CropBox role — mask-only, "
                         "applied before the output voxel grid)")
    ap.add_argument("--drop-plane", type=float, default=None, metavar="DIST",
                    help="segment the dominant plane each frame "
                         "(pcl::SACSegmentation role) and drop points "
                         "within DIST meters of it from every output — "
                         "remove the floor/wall from the stitched stream")
    ap.add_argument("--normals", action="store_true",
                    help="attach per-point surface normals to the fused "
                         "output (pcl::PointNormal role): saved .ply files "
                         "carry nx/ny/nz; the live view shows them "
                         "normal-map colored. Mutually exclusive with "
                         "--color (both ride the rgb channel)")
    ap.add_argument("--auto-leaf", action="store_true",
                    help="adapt the output grid resolution per frame: grow "
                         "the leaf when the fixed-capacity output saturates "
                         "(instead of dropping the sorted tail of voxels), "
                         "shrink back toward --leaf when the scene fits")
    ap.add_argument("--auto-leaf-max", type=float, default=None,
                    help="--auto-leaf ceiling in meters (default 8x the "
                         "base leaf)")
    ap.add_argument("--payload", choices=["depth", "points"], default="depth",
                    help="wire payload kind (points = reference legacy mode)")
    ap.add_argument("--color", action="store_true",
                    help="ingest depth-aligned RGB and stitch colored clouds")
    ap.add_argument("--color-intr-dir",
                    help="directory of per-camera color-stream .intr.json "
                         "files (sorted by name = camera order). Required "
                         "when the config sets color_height/color_width "
                         "(non-aligned color, DEPTH16_COLOR_NATIVE): color "
                         "then attaches by projecting points into the color "
                         "camera instead of assuming aligned streams")
    ap.add_argument("--color-cal-dir",
                    help="directory of per-camera depth→color extrinsic "
                         ".cal files (4x4, sorted by name = camera order); "
                         "identity per camera when omitted")
    ap.add_argument("--fps", type=float, default=None,
                    help="pace the stitch loop to this many ticks/sec (the "
                         "reference client is implicitly paced by the 30 FPS "
                         "camera cadence — SURVEY.md §3.2; unpaced, this "
                         "loop free-runs on the freshest frames)")
    ap.add_argument("--trace-dir",
                    help="capture a jax.profiler device trace to this dir")
    ap.add_argument("--record-dir",
                    help="record incoming depth streams as replayable .npy")
    ap.add_argument("--record-frames", type=int, default=300)
    ap.add_argument("--publish-port", type=int, default=None,
                    help="serve the stitched cloud stream on this TCP port")
    ap.add_argument("--view", action="store_true",
                    help="render the stitched cloud in-process (the "
                         "reference client's -v visualize flag): a cv2 "
                         "window when a GUI exists, else a rolling image "
                         "sequence in --view-dir. For a decoupled viewer "
                         "use --publish-port + pcs-view instead")
    ap.add_argument("--view-dir", default="viewer_out")
    ap.add_argument("--view-axis", default="z", choices=("x", "y", "z"))
    ap.add_argument("--view-size", type=int, default=800)
    ap.add_argument("--view-every", type=int, default=1,
                    help="render every K-th stitched frame (rendering costs "
                         "host time; raise K if it paces the loop)")
    ap.add_argument("--map-leaf", type=float, default=None,
                    help="accumulate stitched frames into a persistent "
                         "temporal voxel map at this leaf size (meters); "
                         "the denoised map saves to --map-out on exit")
    ap.add_argument("--map-capacity", type=int, default=None,
                    help="voxel-map slot capacity (occupied-voxel bound; "
                         "default 2^20). With --map-in this resizes the "
                         "loaded checkpoint (grow pads, shrink keeps the "
                         "highest-evidence voxels)")
    ap.add_argument("--map-decay", type=float, default=1.0,
                    help="per-frame map weight decay (1.0 = never forget; "
                         "0.98 at 30 FPS forgets in ~1.7 s)")
    ap.add_argument("--map-min-weight", type=float, default=0.05,
                    help="evict map voxels whose decayed weight falls below "
                         "this")
    ap.add_argument("--map-out", default="map.ply",
                    help="map path written on exit: .ply saves the denoised "
                         "centroid cloud, .npz saves the full resumable "
                         "accumulation state (see --map-in)")
    ap.add_argument("--map-in", default=None,
                    help="resume accumulation from a .npz map checkpoint "
                         "(leaf/color come from the file; --map-leaf may "
                         "be omitted)")
    ap.add_argument("--tsdf-leaf", type=float, default=None,
                    help="fuse depth keyframes into a persistent TSDF "
                         "volume at this voxel size (meters) — the "
                         "KinectFusion scene model (watertight meshes via "
                         "pcs-mesh, free-space carving); integrates every "
                         "--tsdf-every frames alongside the streaming "
                         "stitch and saves to --tsdf-out on exit")
    ap.add_argument("--tsdf-shape", default="256,256,256",
                    metavar="X,Y,Z", help="TSDF grid shape in voxels")
    ap.add_argument("--tsdf-origin", default=None, metavar="x,y,z",
                    help="world position of voxel (0,0,0)'s center "
                         "(meters; default centers the grid on XY and "
                         "starts Z at 0)")
    ap.add_argument("--tsdf-every", type=int, default=10,
                    help="integrate every K-th stitched frame (keyframe "
                         "cadence; integrate costs more than a stitch "
                         "frame, so it rides the stream at 1/K rate)")
    ap.add_argument("--tsdf-out", default="scene_tsdf.npz",
                    help="TSDF checkpoint written on exit (resumable via "
                         "--tsdf-in; pcs-mesh extracts its isosurface)")
    ap.add_argument("--tsdf-in", default=None,
                    help="resume from a --tsdf-out checkpoint "
                         "(shape/leaf/origin/color come from the file)")
    ap.add_argument("--tsdf-max-weight", type=float, default=64.0,
                    help="per-voxel evidence cap (bounds how slowly a "
                         "long-observed voxel adapts to change)")
    ap.add_argument("--tsdf-track", action="store_true",
                    help="use the TSDF volume as an ONLINE EXTRINSICS "
                         "SOURCE: every keyframe, track the anchor camera "
                         "frame-to-model against the fused scene (KinFu "
                         "projective ICP) and apply the gated rigid-rig "
                         "correction to all cameras. Recovers global rig "
                         "drift (mount slip) that per-frame ring ICP "
                         "cannot observe — ring corrections are relative "
                         "with camera 0 anchored. Requires --tsdf-leaf or "
                         "--tsdf-in; corrections also steer the integrate "
                         "pose, so the volume stays sharp under drift")
    ap.add_argument("--tsdf-track-cam", type=int, default=0,
                    help="which camera anchors the frame-to-model track "
                         "(default 0, the ring-ICP anchor)")
    args = ap.parse_args(argv)

    import dataclasses

    from ..io.calio import discover_cals, load_cals
    from ..io.plyio import save_cloud
    from ..models.stitcher import StitchingPipeline
    from ..utils.config import StitchConfig
    from ..utils.types import Intrinsics
    from .client import MulticameraClient

    addresses = []
    for cam in args.camera:
        host, port = cam.rsplit(":", 1)
        addresses.append((host, int(port)))
    ncam = len(addresses)

    cfg = StitchConfig.load(args.config) if args.config else StitchConfig()
    updates = {"num_cameras": ncam}
    if args.leaf is not None:
        updates["out_voxel_leaf"] = args.leaf
    if args.height is not None:
        updates["height"] = args.height
    if args.width is not None:
        updates["width"] = args.width
    if args.no_icp:
        updates["icp_enabled"] = False
    if args.color:
        updates["with_color"] = True
    if args.normals:
        if args.payload == "points":
            # normals come from the organized depth grid; the legacy
            # pre-deprojected points payload has none (and a later
            # decode_normals on an rgb-less cloud would crash mid-stream)
            raise SystemExit("--normals requires the depth payload "
                             "(--payload points clouds have no grid to "
                             "derive normals from)")
        updates["with_normals"] = True
    tsdf_on = args.tsdf_leaf is not None or args.tsdf_in is not None
    if tsdf_on and args.payload == "points":
        raise SystemExit("--tsdf-* integrates raw depth frames; the legacy "
                         "points payload carries none (use --payload "
                         "depth)")
    if args.tsdf_track and not tsdf_on:
        raise SystemExit("--tsdf-track corrects poses against the TSDF "
                         "volume; give it one (--tsdf-leaf or --tsdf-in)")
    if args.tsdf_track and not (0 <= args.tsdf_track_cam < ncam):
        raise SystemExit(f"--tsdf-track-cam {args.tsdf_track_cam} out of "
                         f"range for {ncam} cameras")
    tsdf_shape = tsdf_origin = None
    if tsdf_on:
        try:
            tsdf_shape = tuple(int(v) for v in args.tsdf_shape.split(","))
            if len(tsdf_shape) != 3 or any(s <= 0 for s in tsdf_shape):
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --tsdf-shape {args.tsdf_shape!r}; "
                             "want X,Y,Z positive voxel counts")
        if args.tsdf_origin is not None:
            try:
                tsdf_origin = tuple(
                    float(v) for v in args.tsdf_origin.split(","))
                if len(tsdf_origin) != 3:
                    raise ValueError
            except ValueError:
                raise SystemExit(f"bad --tsdf-origin {args.tsdf_origin!r}; "
                                 "want x,y,z meters (use --tsdf-origin=-1,"
                                 "... for negative corners)")
    if args.crop:
        try:
            lo_s, hi_s = args.crop.split(":")
            lo = tuple(float(v) for v in lo_s.split(","))
            hi = tuple(float(v) for v in hi_s.split(","))
            if len(lo) != 3 or len(hi) != 3 or any(
                    a >= b for a, b in zip(lo, hi)):
                raise ValueError
        except ValueError:
            raise SystemExit(f"bad --crop {args.crop!r}; want "
                             "X0,Y0,Z0:X1,Y1,Z1 with lo < hi per axis "
                             "(use --crop=-2,... for negative corners: "
                             "argparse needs the '=' form there)")
        updates["crop_lo"], updates["crop_hi"] = lo, hi
    if args.auto_leaf:
        updates["out_leaf_autofit"] = True
        base = updates.get("out_voxel_leaf", cfg.out_voxel_leaf)
        updates["out_leaf_max"] = (args.auto_leaf_max
                                   if args.auto_leaf_max is not None
                                   else 8.0 * base)
    cfg = dataclasses.replace(cfg, **updates)

    if args.cal_dir:
        paths = discover_cals(args.cal_dir)
        if len(paths) != ncam:
            raise SystemExit(f"{len(paths)} .cal files for {ncam} cameras")
        ext = load_cals(paths)
    else:
        ext = np.tile(np.eye(4, dtype=np.float32), (ncam, 1, 1))

    if args.intr_dir:
        from ..io.calio import discover_intrinsics, load_intrinsics_stack
        ipaths = discover_intrinsics(args.intr_dir)
        if len(ipaths) != ncam:
            raise SystemExit(f"{len(ipaths)} .intr.json files for "
                             f"{ncam} cameras")
        intr = load_intrinsics_stack(ipaths)
        if intr.width != cfg.width or intr.height != cfg.height:
            raise SystemExit(
                f"intrinsics are {intr.width}x{intr.height} but the pipeline "
                f"is configured {cfg.width}x{cfg.height}")
    else:
        i0 = Intrinsics.d435_default(width=cfg.width, height=cfg.height)
        intr = i0.stack([i0] * (ncam - 1)) if ncam > 1 else i0.stack([])

    # non-aligned color (cfg.color_height set) needs the color stream's own
    # calibration; reject up front with the fix spelled out
    color_intr = color_ext = None
    if args.color_intr_dir:
        from ..io.calio import discover_intrinsics, load_intrinsics_stack
        cpaths = discover_intrinsics(args.color_intr_dir)
        if len(cpaths) != ncam:
            raise SystemExit(f"{len(cpaths)} color .intr.json files for "
                             f"{ncam} cameras")
        color_intr = load_intrinsics_stack(cpaths)
        if args.color_cal_dir:
            ccals = discover_cals(args.color_cal_dir)
            if len(ccals) != ncam:
                raise SystemExit(f"{len(ccals)} depth→color .cal files for "
                                 f"{ncam} cameras")
            color_ext = load_cals(ccals)
    elif cfg.color_height is not None:
        raise SystemExit(
            "config sets color_height/color_width (non-aligned color) but "
            "no --color-intr-dir was given; pass the color stream's "
            "per-camera intrinsics (and optionally --color-cal-dir for "
            "depth→color extrinsics)")

    pipe = StitchingPipeline(cfg, intr, ext,
                             color_intr=color_intr, color_ext=color_ext)
    client = MulticameraClient(
        addresses, pipe, payload=args.payload,
        record_frames=args.record_frames if args.record_dir else 0).start()
    if not client.wait_for_first_frames(timeout=15):
        errs = client.camera_errors()
        raise SystemExit("no camera produced a frame within 15 s"
                         + (": " + "; ".join(errs) if errs else ""))
    print(f"streaming from {ncam} cameras...", flush=True)

    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)

    publisher = None
    if args.publish_port is not None:
        from .publisher import CloudPublisher
        publisher = CloudPublisher(port=args.publish_port).start()
        print(f"publishing stitched clouds on :{publisher.port}", flush=True)

    view = view_sink = None
    snap_idx = [0]  # --view 'p'-key snapshot counter (closure-mutable)
    if args.view:
        from .view_cli import CloudView, _directory_sink, _window_sink
        # a --normals rig shades its normals by default ('n' key toggles)
        view = CloudView(axis=args.view_axis, size=args.view_size,
                         shade_normals=cfg.with_normals)
        view_sink = _window_sink()
        if view_sink is None:
            print(f"view: no GUI, writing image sequence to {args.view_dir}",
                  flush=True)
            view_sink = _directory_sink(args.view_dir, keep=300)

    acc = None
    tsdf_state = {"vol": None, "frames": 0,
                  "track_seen": 0, "track_applied": 0, "track_last": None}

    def close_view():
        nonlocal view
        view = None
        try:
            import cv2
            cv2.destroyAllWindows()
        except Exception:
            pass

    drop_key = None
    if args.drop_plane is not None:
        import jax as _jax
        drop_key = _jax.random.key(0)

    def on_frame(i, out):
        nonlocal acc
        if drop_key is not None:
            # segment the dominant plane (floor/wall) and drop its inliers
            # from everything downstream (save/publish/view/map). Per-frame
            # and stateless — all on device, fixed key so it's deterministic
            from ..ops import extract_plane, segment_plane
            model, _, _ = segment_plane(out.cloud, args.drop_plane, drop_key)
            out = out._replace(cloud=extract_plane(out.cloud, model,
                                                   args.drop_plane))
        if args.map_leaf is not None or args.map_in is not None:
            if acc is None:
                # lazy: RGB presence must match the stitched output's
                from ..models.voxel_map import TemporalAccumulator
                if args.map_in is not None:
                    acc = TemporalAccumulator.load(
                        args.map_in, capacity=args.map_capacity,
                        decay=args.map_decay,
                        min_weight=args.map_min_weight)
                    has_rgb = acc.state.rgb_sums is not None
                    if has_rgb != (out.cloud.rgb is not None):
                        raise ValueError(
                            f"--map-in {args.map_in} was built "
                            f"{'with' if has_rgb else 'without'} color but "
                            f"this rig streams the opposite — resume with a "
                            f"matching config or start a fresh map")
                else:
                    acc = TemporalAccumulator(
                        capacity=args.map_capacity or (1 << 20),
                        leaf=args.map_leaf,
                        decay=args.map_decay, min_weight=args.map_min_weight,
                        with_rgb=out.cloud.rgb is not None)
            acc.update(out.cloud)
        if tsdf_on and i % max(args.tsdf_every, 1) == 0:
            # keyframe-cadence TSDF fusion on the exact device-resident
            # depth the stitch saw (StitchOutput.depth — no extra H2D),
            # against the frame's REFINED extrinsics. integrate donates
            # its input volume, so the state swap is allocation-free;
            # the first keyframe pays the integrate compile.
            from ..models import tsdf as tsdf_mod
            vol = tsdf_state["vol"]
            if vol is None:
                if args.tsdf_in is not None:
                    vol = tsdf_mod.load_volume(args.tsdf_in)
                    if (vol.rgb is not None) and out.color is None:
                        raise SystemExit(
                            f"--tsdf-in {args.tsdf_in} carries color but "
                            "this rig streams none — pass --color or "
                            "start a fresh volume")
                    if (vol.rgb is not None) and cfg.color_height \
                            is not None:
                        # same refusal as the fresh-volume path below: a
                        # DEPTH16_COLOR_NATIVE stream's color has its own
                        # geometry, and integrate's flat depth-grid
                        # indices would silently fuse the WRONG pixels'
                        # color (in-bounds, no error)
                        raise SystemExit(
                            f"--tsdf-in {args.tsdf_in} carries color but "
                            "this rig streams non-depth-aligned color "
                            "(config sets color_height/color_width); "
                            "TSDF color needs per-depth-pixel alignment "
                            "— start a fresh volume or use an aligned "
                            "color stream")
                else:
                    leaf = args.tsdf_leaf
                    org = tsdf_origin if tsdf_origin is not None else (
                        -tsdf_shape[0] * leaf / 2.0,
                        -tsdf_shape[1] * leaf / 2.0, 0.0)
                    # rgb only for depth-aligned color streams (the
                    # non-aligned DEPTH16_COLOR_NATIVE color image has
                    # its own geometry; TSDF color needs per-depth-pixel
                    # alignment)
                    vol = tsdf_mod.TSDFVolume.create(
                        tsdf_shape, leaf, origin=org,
                        with_rgb=(out.color is not None
                                  and cfg.color_height is None))
            color = out.color if vol.rgb is not None else None
            ext_kf = out.extrinsics
            # a dead anchor's slot keeps serving its last frame: integrate
            # drops it via cam_mask, but tracking a STALE frame against
            # the evolving volume would keep "correcting" the whole rig
            # toward an outdated pose (it matches old fused geometry
            # well, so the quality gates alone can't catch it)
            # ordering: the cam_mask read is a blocking D2H pull, so it
            # must short-circuit BEHIND the cheap host flags — an
            # untracked TSDF rig never pays it
            if args.tsdf_track and tsdf_state["frames"] > 0 \
                    and bool(np.asarray(out.cam_mask)
                             [args.tsdf_track_cam]):
                # frame-to-model BEFORE integrate: correct the rig pose
                # against the scene already fused, then integrate with the
                # corrected pose (integrating a drifted keyframe uncorrected
                # would smear the very model tracking relies on). The gated
                # world-frame correction G left-multiplies the pipeline's
                # base extrinsics too, so ring ICP keeps refining relative
                # drift on top of a tracked global pose.
                rt = tsdf_mod.rig_track(
                    vol, out.depth, intr, out.extrinsics,
                    cam=args.tsdf_track_cam, depth_scale=cfg.depth_scale,
                    t_min=max(cfg.z_min, 0.05), t_max=cfg.z_max)
                tsdf_state["track_seen"] += 1
                tsdf_state["track_last"] = rt.track
                if rt.applied:
                    tsdf_state["track_applied"] += 1
                    ext_kf = rt.extrinsics
                    from ..ops.se3 import mm as _mm
                    pipe.extrinsics = _mm(rt.G, pipe.extrinsics)
            tsdf_state["vol"] = tsdf_mod.integrate(
                vol, out.depth, intr, ext_kf,
                depth_scale=cfg.depth_scale,
                max_weight=args.tsdf_max_weight, color=color,
                cam_mask=out.cam_mask, z_min=cfg.z_min, z_max=cfg.z_max)
            tsdf_state["frames"] += 1
        if publisher is not None and publisher.num_subscribers:
            publisher.publish_cloud(out.cloud)
        if view is not None and i % max(args.view_every, 1) == 0:
            cmd = view_sink(i, view.render_cloud(out.cloud))
            if cmd == "quit":
                # the window's documented q key: close the in-process
                # viewer (stitching continues — mirrors closing the
                # reference's PCLVisualizer window, which doesn't stop
                # the client loop)
                close_view()
            elif cmd == "snap":
                # the window's documented p key (the reference's keypress
                # savePLYFile) — snapshot the cloud that produced this frame
                path = os.path.join(args.view_dir,
                                    f"snapshot_{snap_idx[0]:05d}.ply")
                os.makedirs(args.view_dir, exist_ok=True)
                save_cloud(path, out.cloud, decode_normals=cfg.with_normals)
                snap_idx[0] += 1
                print(f"saved {path}", flush=True)
            else:
                view.apply_command(cmd)
        if args.print_every and i > 0 and i % args.print_every == 0:
            line = str(client.metrics)
            if args.timing:
                line += f" stages(ms)={client.stages.summary()}"
            print(line, flush=True)
        if args.save_dir and i % args.save_every == 0:
            save_cloud(os.path.join(args.save_dir, f"cloud_{i:06d}.ply"),
                       out.cloud, decode_normals=cfg.with_normals)

    try:
        if args.trace_dir:
            from ..utils.profiling import trace
            with trace(args.trace_dir):
                metrics = client.run(num_frames=args.frames,
                                     on_frame=on_frame, fps=args.fps)
        else:
            metrics = client.run(num_frames=args.frames, on_frame=on_frame,
                                 fps=args.fps)
    except KeyboardInterrupt:
        metrics = client.metrics
    finally:
        # run() leaves the client started (so callers can issue repeated
        # bounded runs); the CLI is done with it either way
        client.stop()
    if publisher is not None:
        publisher.stop()
    if args.record_dir:
        paths = client.save_recording(args.record_dir)
        print(f"recorded {len(paths)} camera streams to {args.record_dir}")
    if acc is not None:
        if args.map_out.endswith(".npz"):
            acc.save(args.map_out)   # full resumable state
        else:
            save_cloud(args.map_out, acc.cloud())
        print(f"saved accumulated map ({int(acc.state.count())} voxels) "
              f"to {args.map_out}")
    if tsdf_state["vol"] is not None:
        from ..models.tsdf import save_volume
        save_volume(args.tsdf_out, tsdf_state["vol"])
        occ = int(np.asarray(tsdf_state["vol"].weight > 0).sum())
        line = (f"saved TSDF volume ({tsdf_state['frames']} keyframes, "
                f"{occ} observed voxels) to {args.tsdf_out}")
        if args.tsdf_track and tsdf_state["track_seen"]:
            last = tsdf_state["track_last"]
            line += (f"; tracking applied {tsdf_state['track_applied']}/"
                     f"{tsdf_state['track_seen']} corrections "
                     f"(last rms {float(last.rms) * 1e3:.1f} mm, "
                     f"{int(last.n_matched)} matched)")
        print(line)
    print(metrics)
    return metrics


if __name__ == "__main__":
    main()
