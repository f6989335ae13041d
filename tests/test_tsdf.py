"""TSDF volume: integration oracle, ray casting, tracking, extraction.

The scene renderer here is independent numpy (analytic ray/plane and
ray/sphere intersections), so every check is against geometry the TSDF
code never saw — same oracle discipline as tests/oracle.py.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from pointcloud_stitching_tpu import Intrinsics
from pointcloud_stitching_tpu.models import tsdf as M
from pointcloud_stitching_tpu.ops.se3 import se3_inverse
from pointcloud_stitching_tpu.ops.surface import soup_triangles, weld_mesh


# ---------------------------------------------------------------------------
# numpy scene renderer (analytic, independent of the jax code under test)
# ---------------------------------------------------------------------------

def _intr(w=64, h=48, f=50.0):
    return Intrinsics.create(fx=f, fy=f, ppx=w / 2.0, ppy=h / 2.0,
                             width=w, height=h)


def _ray_grid(intr):
    """Per-pixel unnormalized camera-frame directions with z = 1."""
    u, v = np.meshgrid(np.arange(intr.width, dtype=np.float64),
                       np.arange(intr.height, dtype=np.float64))
    x = (u - float(intr.ppx)) / float(intr.fx)
    y = (v - float(intr.ppy)) / float(intr.fy)
    return np.stack([x, y, np.ones_like(x)], axis=-1)  # [h, w, 3]


def render_depth(intr, T_cam_to_world, spheres=(), planes=(),
                 z_clip=(0.05, 50.0)):
    """Analytic z-depth of the nearest surface along each pixel ray.

    spheres: list of (center [3], radius); planes: list of (normal [3],
    offset) with the surface at n·p = off. Returns [h, w] float32 meters
    (0 = no hit).
    """
    T = np.asarray(T_cam_to_world, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    d = _ray_grid(intr) @ R.T                       # world dirs, z_cam = 1
    o = t
    best = np.full(d.shape[:2], np.inf)
    for c, r in spheres:
        c = np.asarray(c, np.float64)
        a = np.sum(d * d, -1)
        b = 2.0 * np.sum(d * (o - c), -1)
        cc = np.sum((o - c) ** 2) - r * r
        disc = b * b - 4 * a * cc
        ok = disc >= 0
        z = np.where(ok, (-b - np.sqrt(np.maximum(disc, 0.0))) / (2 * a),
                     np.inf)
        best = np.minimum(best, np.where(ok & (z > z_clip[0]), z, np.inf))
    for n, off in planes:
        n = np.asarray(n, np.float64)
        denom = d @ n
        z = np.where(np.abs(denom) > 1e-12, (off - o @ n) / denom, np.inf)
        best = np.minimum(best, np.where(z > z_clip[0], z, np.inf))
    best = np.where(np.isfinite(best) & (best < z_clip[1]), best, 0.0)
    return best.astype(np.float32)


def integrate_oracle(vol_shape, origin, leaf, trunc, depth, intr, T,
                     tsdf0=None, w0=None, max_weight=64.0):
    """Independent numpy Curless–Levoy update (nearest-pixel sampling)."""
    X, Y, Z = vol_shape
    gi, gj, gk = np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                             indexing="ij")
    p_w = origin + np.stack([gi, gj, gk], -1).reshape(-1, 3) * leaf
    Tinv = np.linalg.inv(np.asarray(T, np.float64))
    p_c = p_w @ Tinv[:3, :3].T + Tinv[:3, 3]
    z = p_c[:, 2]
    zs = np.where(np.abs(z) > 1e-12, z, 1.0)
    u = p_c[:, 0] / zs * float(intr.fx) + float(intr.ppx)
    v = p_c[:, 1] / zs * float(intr.fy) + float(intr.ppy)
    ui = np.round(u).astype(np.int64)
    vi = np.round(v).astype(np.int64)
    ok = (z > 1e-9) & (ui >= 0) & (ui < intr.width) & (vi >= 0) \
        & (vi < intr.height)
    d = np.zeros_like(z)
    d[ok] = depth[vi[ok], ui[ok]]
    sdf = d - z
    obs = ok & (d > 0) & (sdf > -trunc)
    t_obs = np.minimum(sdf / trunc, 1.0)
    t0 = np.ones(X * Y * Z) if tsdf0 is None else tsdf0.reshape(-1)
    w_old = np.zeros(X * Y * Z) if w0 is None else w0.reshape(-1)
    w_new = w_old + obs
    t_new = np.where(w_new > 0,
                     (t0 * w_old + np.where(obs, t_obs, 0.0))
                     / np.maximum(w_new, 1e-12), 1.0)
    return (t_new.reshape(vol_shape).astype(np.float32),
            np.minimum(w_new, max_weight).reshape(vol_shape)
            .astype(np.float32))


def _plane_vol(leaf=0.02, n=64):
    return M.TSDFVolume.create((n, n, n), leaf,
                               origin=(-n / 2 * leaf, -n / 2 * leaf, 0.0))


I4 = np.eye(4, dtype=np.float32)

# a well-conditioned tracking scene: a back wall + two spheres (breaks
# every translation/rotation degeneracy a single plane leaves open)
SCENE = dict(
    spheres=[((-0.15, 0.05, 0.55), 0.12), ((0.18, -0.08, 0.65), 0.10)],
    planes=[((0.0, 0.0, -1.0), -0.9)],     # wall at z = 0.9, facing camera
)


# ---------------------------------------------------------------------------
# integration
# ---------------------------------------------------------------------------

def test_integrate_plane_profile():
    """TSDF along the optical axis matches clip((d - z)/trunc, -1, 1) in
    the observed band and stays untouched behind it."""
    vol = _plane_vol()
    intr = _intr()
    depth = render_depth(intr, I4, planes=SCENE["planes"])  # wall at 0.9
    vol = M.integrate(vol, jnp.asarray(depth), intr, I4, depth_scale=1.0)
    tsdf = np.asarray(vol.tsdf)
    w = np.asarray(vol.weight)
    trunc = float(vol.trunc)
    # voxels straight down the optical axis: x = y = 0 -> i = j = 32
    zs = np.arange(64) * 0.02  # voxel k centers
    expect = np.clip((0.9 - zs) / trunc, -1.0, 1.0)
    # z = 0 is the camera plane itself (not in front of the pinhole); the
    # exact band edge (sdf == -trunc) is f32-rounding dependent — exclude
    # a hair around it from both sides
    seen = ((0.9 - zs) > -trunc + 1e-6) & (zs > 0)
    unseen = ((0.9 - zs) < -trunc - 1e-6) | (zs == 0)
    line = tsdf[32, 32, :]
    assert np.allclose(line[seen], expect[seen], atol=1e-5)
    assert np.all(w[32, 32, :][seen] == 1.0)
    assert np.all(w[32, 32, :][unseen] == 0.0)
    assert np.all(line[unseen] == 1.0)  # untouched initialization


def test_integrate_matches_numpy_oracle():
    """Bitwise-level agreement with an independent numpy projective
    update, from a non-trivial camera pose, two frames deep."""
    rng = np.random.default_rng(0)
    intr = _intr()
    # modest rotation + offset pose
    ang = 0.15
    Rx = np.array([[1, 0, 0],
                   [0, np.cos(ang), -np.sin(ang)],
                   [0, np.sin(ang), np.cos(ang)]])
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, :3] = Rx
    T2[:3, 3] = [0.05, -0.04, 0.02]
    vol = _plane_vol(n=48)
    shape, origin = vol.shape, np.asarray(vol.origin)
    leaf, trunc = float(vol.leaf), float(vol.trunc)

    d1 = render_depth(intr, I4, **SCENE)
    d2 = render_depth(intr, T2, **SCENE)
    vol = M.integrate(vol, jnp.asarray(d1), intr, I4, depth_scale=1.0)
    vol = M.integrate(vol, jnp.asarray(d2), intr, T2, depth_scale=1.0)

    t_ref, w_ref = integrate_oracle(shape, origin, leaf, trunc, d1, intr, I4)
    t_ref, w_ref = integrate_oracle(shape, origin, leaf, trunc, d2, intr,
                                    T2, tsdf0=t_ref, w0=w_ref)
    # nearest-pixel rounding can disagree for rays landing exactly between
    # pixels; demand exact agreement on >99.9% of voxels and close
    # weights everywhere else
    diff = np.abs(np.asarray(vol.tsdf) - t_ref)
    assert (diff < 1e-5).mean() > 0.999
    assert np.abs(np.asarray(vol.weight) - w_ref).max() <= 1.0


def test_integrate_multicamera_batch_equals_sequential():
    """One batched [ncam, H, W] integrate == sequential per-camera
    integrates (the camera loop is order-free summation)."""
    intr1 = _intr()
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [0.1, 0.0, -0.05]
    d1 = render_depth(intr1, I4, **SCENE)
    d2 = render_depth(intr1, T2, **SCENE)

    vol_a = _plane_vol(n=48)
    batched = jnp.stack([jnp.asarray(d1), jnp.asarray(d2)])
    intr_b = intr1.stack([intr1])
    ext_b = jnp.stack([jnp.asarray(I4), jnp.asarray(T2)])
    vol_a = M.integrate(vol_a, batched, intr_b, ext_b, depth_scale=1.0)

    vol_b = _plane_vol(n=48)
    vol_b = M.integrate(vol_b, jnp.asarray(d1), intr1, I4, depth_scale=1.0)
    vol_b = M.integrate(vol_b, jnp.asarray(d2), intr1, T2, depth_scale=1.0)

    assert np.allclose(np.asarray(vol_a.weight), np.asarray(vol_b.weight))
    assert np.allclose(np.asarray(vol_a.tsdf), np.asarray(vol_b.tsdf),
                       atol=1e-5)


def test_integrate_cam_mask_drops_camera():
    intr = _intr()
    d1 = render_depth(intr, I4, **SCENE)
    garbage = np.full_like(d1, 0.3)
    vol = _plane_vol(n=48)
    batched = jnp.stack([jnp.asarray(d1), jnp.asarray(garbage)])
    intr_b = intr.stack([intr])
    ext_b = jnp.stack([jnp.asarray(I4), jnp.asarray(I4)])
    vol = M.integrate(vol, batched, intr_b, ext_b, depth_scale=1.0,
                      cam_mask=jnp.asarray([True, False]))
    ref = _plane_vol(n=48)
    ref = M.integrate(ref, jnp.asarray(d1), intr, I4, depth_scale=1.0)
    assert np.allclose(np.asarray(vol.tsdf), np.asarray(ref.tsdf))
    assert np.allclose(np.asarray(vol.weight), np.asarray(ref.weight))


def test_free_space_carving():
    """Geometry that disappears is overwritten by free-space evidence —
    the capability decay-based maps fundamentally lack."""
    intr = _intr()
    vol = _plane_vol()
    near = render_depth(intr, I4, planes=[((0, 0, -1.0), -0.5)])  # z=0.5
    far = render_depth(intr, I4, planes=[((0, 0, -1.0), -0.9)])   # z=0.9
    vol = M.integrate(vol, jnp.asarray(near), intr, I4, depth_scale=1.0,
                      max_weight=8.0)
    # surface initially at 0.5 on the optical axis
    line = np.asarray(vol.tsdf)[32, 32, :]
    zs = np.arange(64) * 0.02
    z_cross = zs[np.argmax(line <= 0.0)]
    assert abs(z_cross - 0.5) < 0.03
    for _ in range(16):  # object removed; wall behind becomes visible
        vol = M.integrate(vol, jnp.asarray(far), intr, I4, depth_scale=1.0,
                          max_weight=8.0)
    line = np.asarray(vol.tsdf)[32, 32, :]
    z_cross = zs[np.argmax(line <= 0.0)]
    assert abs(z_cross - 0.9) < 0.03, "stale surface not carved away"


# ---------------------------------------------------------------------------
# ray casting
# ---------------------------------------------------------------------------

def test_raycast_matches_analytic_depth():
    intr = _intr()
    vol = _plane_vol()
    # integrate from two poses for better coverage
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [0.08, 0.0, 0.0]
    for T in (I4, T2):
        d = render_depth(intr, T, **SCENE)
        vol = M.integrate(vol, jnp.asarray(d), intr, T, depth_scale=1.0)

    view = np.eye(4, dtype=np.float32)
    view[:3, 3] = [0.03, -0.02, 0.0]
    rc = M.raycast(vol, intr, view, t_min=0.2, t_max=1.4)
    ref = render_depth(intr, view, **SCENE)
    got = np.asarray(rc.depth)
    ok = np.asarray(rc.valid) & (ref > 0)
    assert ok.mean() > 0.8  # most rays hit the integrated surfaces
    err = np.abs(got[ok] - ref[ok])
    # surface position is good to a voxel (2 cm leaf, trilinear refine)
    assert np.median(err) < 0.01
    assert np.quantile(err, 0.9) < 0.025


def test_raycast_normals_plane():
    intr = _intr()
    vol = _plane_vol()
    d = render_depth(intr, I4, planes=SCENE["planes"])
    vol = M.integrate(vol, jnp.asarray(d), intr, I4, depth_scale=1.0)
    rc = M.raycast(vol, intr, I4, t_min=0.2, t_max=1.2)
    n = np.asarray(rc.normal)[np.asarray(rc.valid)]
    assert n.shape[0] > 100
    # wall faces the camera: normals ~ (0, 0, -1) in world frame
    assert np.median(n[:, 2]) < -0.98


def test_raycast_stride_and_rgb():
    intr = _intr()
    n = 64
    leaf = 0.02
    vol = M.TSDFVolume.create((n, n, n), leaf,
                              origin=(-0.64, -0.64, 0.0), with_rgb=True)
    d = render_depth(intr, I4, planes=SCENE["planes"])
    # left half red, right half green
    color = np.zeros((*d.shape, 3), np.uint8)
    color[:, : intr.width // 2, 0] = 200
    color[:, intr.width // 2:, 1] = 180
    vol = M.integrate(vol, jnp.asarray(d), intr, I4, depth_scale=1.0,
                      color=jnp.asarray(color))
    rc = M.raycast(vol, intr, I4, t_min=0.2, t_max=1.2, stride=2)
    assert rc.depth.shape == (intr.height // 2, intr.width // 2)
    valid = np.asarray(rc.valid)
    rgb = np.asarray(rc.rgb)
    mid = intr.width // 4
    left = valid.copy()
    left[:, mid - 2:] = False
    right = valid.copy()
    right[:, : mid + 2] = False
    assert rgb[left][:, 0].mean() > 150 and rgb[left][:, 1].mean() < 30
    assert rgb[right][:, 1].mean() > 130 and rgb[right][:, 0].mean() < 30


# ---------------------------------------------------------------------------
# frame-to-model tracking
# ---------------------------------------------------------------------------

def test_track_recovers_perturbed_pose():
    intr = _intr(w=96, h=72, f=75.0)
    vol = _plane_vol(n=72, leaf=0.018)
    d0 = render_depth(intr, I4, **SCENE)
    vol = M.integrate(vol, jnp.asarray(d0), intr, I4, depth_scale=1.0)

    # true new pose: small rotation + translation off the map-build pose
    ang = 0.03
    Rz = np.array([[np.cos(ang), -np.sin(ang), 0],
                   [np.sin(ang), np.cos(ang), 0], [0, 0, 1]])
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = Rz
    T_true[:3, 3] = [0.02, -0.015, 0.01]
    d_live = render_depth(intr, T_true, **SCENE)

    res = M.track(vol, jnp.asarray(d_live), intr, jnp.asarray(I4),
                  iterations=10, depth_scale=1.0, stride=1,
                  t_min=0.2, t_max=1.4)
    T_got = np.asarray(res.T)
    dt = np.linalg.norm(T_got[:3, 3] - T_true[:3, 3])
    dR = np.degrees(np.arccos(np.clip(
        (np.trace(T_got[:3, :3].T @ T_true[:3, :3]) - 1) / 2, -1, 1)))
    assert int(res.n_matched) > 500
    assert dt < 0.01, f"translation error {dt}"
    assert dR < 0.5, f"rotation error {dR} deg"
    assert float(res.rms) < 0.01


def test_track_identity_is_stable():
    """Tracking a frame rendered at the init pose must stay at the init."""
    intr = _intr()
    vol = _plane_vol()
    d0 = render_depth(intr, I4, **SCENE)
    vol = M.integrate(vol, jnp.asarray(d0), intr, I4, depth_scale=1.0)
    res = M.track(vol, jnp.asarray(d0), intr, jnp.asarray(I4),
                  iterations=5, depth_scale=1.0, stride=1,
                  t_min=0.2, t_max=1.4)
    T = np.asarray(res.T)
    assert np.linalg.norm(T[:3, 3]) < 5e-3
    assert np.abs(T[:3, :3] - np.eye(3)).max() < 5e-3


def _global_drift(ang=0.03, t=(0.02, -0.01, 0.015)):
    """A small world-frame rig drift (yaw + translation)."""
    D = np.eye(4, dtype=np.float32)
    D[:3, :3] = [[np.cos(ang), 0, np.sin(ang)],
                 [0, 1, 0],
                 [-np.sin(ang), 0, np.cos(ang)]]
    D[:3, 3] = t
    return D


def _pose_err(T_got, T_true):
    """(translation m, rotation rad) between two camera→world poses."""
    T_got, T_true = np.asarray(T_got), np.asarray(T_true)
    dt = np.linalg.norm(T_got[:3, 3] - T_true[:3, 3])
    c = (np.trace(T_got[:3, :3].T @ T_true[:3, :3]) - 1.0) / 2.0
    return dt, np.arccos(np.clip(c, -1.0, 1.0))


def test_rig_track_lifts_correction_to_rig():
    """rig_track recovers an injected GLOBAL drift and applies the same
    world-frame correction to every camera of the rig (the rigid-rig
    lift): the anchor's pose error collapses and camera 1 moves by
    exactly the anchor's correction G."""
    intr = _intr(w=96, h=72, f=75.0)
    vol = _plane_vol(n=72, leaf=0.018)
    d0 = render_depth(intr, I4, **SCENE)
    vol = M.integrate(vol, jnp.asarray(d0), intr, I4, depth_scale=1.0)

    D = _global_drift()                       # the rig really moved by D
    # stale estimates: the calibrated poses (cam 1 offset on the mount)
    T_cal1 = np.eye(4, dtype=np.float32)
    T_cal1[:3, 3] = [0.03, 0.0, -0.02]
    ext_est = np.stack([I4, T_cal1])
    d_live = render_depth(intr, D, **SCENE)   # what the drifted anchor sees

    rt = M.rig_track(vol, jnp.asarray(np.stack([d_live, d_live])),
                     intr.stack([intr]), jnp.asarray(ext_est),
                     depth_scale=1.0, prior_window=None,
                     iterations=10, stride=1, t_min=0.2, t_max=1.4)
    assert rt.applied
    dt0_before, dr0_before = _pose_err(ext_est[0], D)
    dt0, dr0 = _pose_err(rt.extrinsics[0], D @ I4)
    assert dt0 < 0.2 * dt0_before and dt0 < 5e-3
    # rotation recovery is bounded by track()'s own accuracy on this
    # scene (test_track_recovers_perturbed_pose allows 0.5 deg)
    assert dr0 < 0.5 * dr0_before and dr0 < np.radians(0.6)
    # the rigid-rig lift: camera 1 moved by the same world correction
    np.testing.assert_allclose(np.asarray(rt.extrinsics[1]),
                               np.asarray(rt.G) @ T_cal1,
                               rtol=0, atol=1e-5)


def test_rig_track_gates_reject_unsupported_fit():
    """An evidence-free volume cannot source a correction: the gates
    reject it and the rig comes back untouched (G == I)."""
    intr = _intr()
    vol = _plane_vol()                        # never integrated: weight 0
    d = render_depth(intr, I4, **SCENE)
    ext = np.stack([I4])
    rt = M.rig_track(vol, jnp.asarray(d[None]), intr.stack([]),
                     jnp.asarray(ext), depth_scale=1.0,
                     prior_window=None, t_min=0.2, t_max=1.4)
    assert not rt.applied
    np.testing.assert_array_equal(np.asarray(rt.extrinsics),
                                  ext.astype(np.float32))
    np.testing.assert_array_equal(np.asarray(rt.G), I4)
    # unbatched convenience shape: [H, W] depth + [4, 4] extrinsics
    rt1 = M.rig_track(vol, jnp.asarray(d), intr, jnp.asarray(I4),
                      depth_scale=1.0, prior_window=None,
                      t_min=0.2, t_max=1.4)
    assert rt1.extrinsics.shape == (4, 4) and not rt1.applied


def test_rig_track_beats_ring_icp_on_global_drift():
    """The contract: on a slow-drift rig the
    frame-to-model residual is at or below ring ICP's. Ring ICP is
    relative-only (camera 0 anchors the chain), so a GLOBAL rig drift
    leaves every pairwise residual near zero while the world poses stay
    wrong by exactly the drift; rig_track observes the drift against
    the persistent volume and removes it."""
    from pointcloud_stitching_tpu.models import stitch_step
    from pointcloud_stitching_tpu.utils.config import StitchConfig

    h, w, f = 72, 96, 75.0
    intr = _intr(w=w, h=h, f=f)
    intr_b = intr.stack([intr])
    T_cal1 = np.eye(4, dtype=np.float32)
    T_cal1[:3, 3] = [0.03, 0.0, -0.02]
    ext_cal = np.stack([I4, T_cal1])

    # the model: both cameras fused at their calibrated (true, pre-drift)
    # poses — the streaming loop's earlier keyframes
    vol = _plane_vol(n=72, leaf=0.018)
    for i, T in enumerate(ext_cal):
        di = render_depth(intr, T, **SCENE)
        vol = M.integrate(vol, jnp.asarray(di), intr, T, depth_scale=1.0)

    D = _global_drift()                        # then the mount slips by D
    T_true = np.stack([D @ I4, D @ T_cal1])
    depths_u16 = np.stack([
        np.round(render_depth(intr, T, **SCENE) * 1000.0).astype(np.uint16)
        for T in T_true])

    cfg = StitchConfig(num_cameras=2, height=h, width=w,
                       cam_voxel_leaf=0.01, cam_capacity=8192,
                       out_voxel_leaf=0.01, out_capacity=16384,
                       icp_voxel_leaf=0.02, icp_capacity=4096,
                       icp_iterations=5, icp_max_corr_dist=0.2,
                       icp_query_tile=256, icp_ref_tile=512,
                       z_min=0.05, z_max=2.0)
    out = stitch_step(cfg, intr_b, jnp.asarray(ext_cal),
                      jnp.asarray(depths_u16))
    ring_dt = max(_pose_err(np.asarray(out.extrinsics)[i], T_true[i])[0]
                  for i in range(2))
    # ring ICP cannot see the global drift: its world error stays at
    # (essentially) the injected drift magnitude
    drift_dt = np.linalg.norm(D[:3, 3])
    assert ring_dt > 0.8 * drift_dt

    rt = M.rig_track(vol, jnp.asarray(depths_u16), intr_b,
                     out.extrinsics, depth_scale=0.001,
                     prior_window=None, iterations=10, stride=1,
                     t_min=0.2, t_max=1.4)
    assert rt.applied
    track_dt = max(_pose_err(np.asarray(rt.extrinsics)[i], T_true[i])[0]
                   for i in range(2))
    assert track_dt <= ring_dt            # the item-6 "done" bar
    assert track_dt < 0.25 * ring_dt      # and decisively so


# ---------------------------------------------------------------------------
# extraction + persistence
# ---------------------------------------------------------------------------

def test_extract_mesh_on_surface():
    intr = _intr()
    vol = _plane_vol()
    d = render_depth(intr, I4, planes=SCENE["planes"])
    vol = M.integrate(vol, jnp.asarray(d), intr, I4, depth_scale=1.0)
    verts, valid, n_active = M.extract_mesh(vol, cell_capacity=8192)
    assert int(n_active) > 0 and int(n_active) <= 8192
    assert verts.shape[:2] == (3, 3)  # coordinate-major SoA contract
    v = soup_triangles(verts, valid)
    assert v.shape[0] > 100
    # every vertex sits on the wall plane z = 0.9 (within interpolation)
    assert np.abs(v[..., 2] - 0.9).max() < 0.021
    # and welds into a consistent indexed mesh
    vw, faces = weld_mesh(np.asarray(verts), np.asarray(valid))
    assert faces.shape[0] > 0


def test_extract_mesh_skips_unobserved_boundary():
    """Without node_valid masking, the observed band's edge (observed
    negative tsdf meeting unobserved +1 init) would grow a fake back
    wall. All mesh vertices must lie near the real surface."""
    intr = _intr()
    vol = _plane_vol()
    d = render_depth(intr, I4, **SCENE)
    vol = M.integrate(vol, jnp.asarray(d), intr, I4, depth_scale=1.0)
    verts, valid, _ = M.extract_mesh(vol, cell_capacity=16384)
    v = soup_triangles(verts, valid).reshape(-1, 3)
    ref = np.zeros(v.shape[0])
    # distance to nearest scene surface (analytic)
    dists = [np.abs(v[:, 2] - 0.9)]
    for c, r in SCENE["spheres"]:
        dists.append(np.abs(np.linalg.norm(v - np.asarray(c), axis=1) - r))
    dmin = np.min(np.stack(dists), axis=0)
    assert np.quantile(dmin, 0.99) < 0.03, "fake walls at occlusion bounds"


def test_extract_cloud_near_surface():
    intr = _intr()
    vol = _plane_vol()
    d = render_depth(intr, I4, planes=SCENE["planes"])
    vol = M.integrate(vol, jnp.asarray(d), intr, I4, depth_scale=1.0)
    pc = M.extract_cloud(vol, capacity=16384, band=0.5)
    pts = np.asarray(pc.xyz)[np.asarray(pc.mask)]
    assert pts.shape[0] > 100
    assert np.abs(pts[:, 2] - 0.9).max() < float(vol.trunc) * 0.5 + 0.011


def test_save_load_roundtrip(tmp_path):
    intr = _intr()
    vol = _plane_vol(n=32)
    d = render_depth(intr, I4, planes=SCENE["planes"])
    vol = M.integrate(vol, jnp.asarray(d), intr, I4, depth_scale=1.0)
    p = str(tmp_path / "vol")
    M.save_volume(p, vol)
    vol2 = M.load_volume(p)
    assert np.allclose(np.asarray(vol.tsdf), np.asarray(vol2.tsdf))
    assert np.allclose(np.asarray(vol.weight), np.asarray(vol2.weight))
    assert float(vol2.leaf) == float(vol.leaf)
    assert float(vol2.trunc) == float(vol.trunc)


def test_integrate_rejects_mismatched_color():
    vol = _plane_vol(n=32)
    intr = _intr()
    d = jnp.zeros((48, 64), jnp.float32)
    with pytest.raises(ValueError):
        M.integrate(vol, d, intr, I4, color=jnp.zeros((48, 64, 3)))


# ---------------------------------------------------------------------------
# hierarchical (brick) integration
# ---------------------------------------------------------------------------

def test_integrate_brick_matches_dense_scenes():
    """Brick classification (FREE / FREE_BORDER / SKIP / REFINE) must
    reproduce the dense map exactly — conservative bounds mean every
    unproven brick runs the same per-voxel math, so differences only
    come from a misclassified brick."""
    intr = _intr()
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [0.15, -0.1, -0.1]
    d1 = render_depth(intr, I4, **SCENE)
    d2 = render_depth(intr, T2, **SCENE)
    batched = jnp.stack([jnp.asarray(d1), jnp.asarray(d2)])
    intr_b = intr.stack([intr])
    ext_b = jnp.stack([jnp.asarray(I4), jnp.asarray(T2)])
    # volume deliberately larger than the frustum (border + outside
    # bricks) and offset (near-camera bricks)
    for origin in [(-0.64, -0.64, 0.0), (-0.3, -0.2, -0.4)]:
        va = M.TSDFVolume.create((64, 64, 64), 0.02, origin=origin)
        va = M.integrate(va, batched, intr_b, ext_b, depth_scale=1.0,
                         method="dense")
        vb = M.TSDFVolume.create((64, 64, 64), 0.02, origin=origin)
        vb = M.integrate(vb, batched, intr_b, ext_b, depth_scale=1.0,
                         method="brick")
        np.testing.assert_allclose(np.asarray(va.tsdf),
                                   np.asarray(vb.tsdf), atol=1e-6)
        np.testing.assert_allclose(np.asarray(va.weight),
                                   np.asarray(vb.weight), atol=1e-6)


def test_integrate_brick_matches_dense_color_mask_gates():
    intr = _intr()
    rng = np.random.default_rng(3)
    d1 = render_depth(intr, I4, **SCENE)
    color = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    batched = jnp.stack([jnp.asarray(d1), jnp.asarray(d1) * 0.5])
    intr_b = intr.stack([intr])
    ext_b = jnp.stack([jnp.asarray(I4), jnp.asarray(I4)])
    kw = dict(depth_scale=1.0, color=jnp.asarray(color),
              cam_mask=jnp.asarray([True, True]),
              z_min=0.3, z_max=0.8, max_weight=1.5)
    va = M.TSDFVolume.create((64, 64, 64), 0.02,
                             origin=(-0.64, -0.64, 0.0), with_rgb=True)
    va = M.integrate(va, batched, intr_b, ext_b, method="dense", **kw)
    vb = M.TSDFVolume.create((64, 64, 64), 0.02,
                             origin=(-0.64, -0.64, 0.0), with_rgb=True)
    vb = M.integrate(vb, batched, intr_b, ext_b, method="brick", **kw)
    np.testing.assert_allclose(np.asarray(va.tsdf), np.asarray(vb.tsdf),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(va.weight),
                               np.asarray(vb.weight), atol=1e-6)
    np.testing.assert_allclose(np.asarray(va.rgb), np.asarray(vb.rgb),
                               atol=1e-3)


def test_integrate_brick_invalid_depth_regions():
    """Holes (d = 0) and out-of-range depth must classify conservatively:
    footprints touching them refine, entirely-invalid footprints skip."""
    intr = _intr()
    d = render_depth(intr, I4, **SCENE)
    d[10:30, 20:40] = 0.0            # a dead sensor patch
    d[:8, :] = 9.0                   # beyond z_max band
    kw = dict(depth_scale=1.0, z_max=2.0)
    va = M.TSDFVolume.create((64, 64, 64), 0.02, origin=(-0.64, -0.64, 0.0))
    va = M.integrate(va, jnp.asarray(d), intr, I4, method="dense", **kw)
    vb = M.TSDFVolume.create((64, 64, 64), 0.02, origin=(-0.64, -0.64, 0.0))
    vb = M.integrate(vb, jnp.asarray(d), intr, I4, method="brick", **kw)
    np.testing.assert_allclose(np.asarray(va.tsdf), np.asarray(vb.tsdf),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(va.weight),
                               np.asarray(vb.weight), atol=1e-6)


@pytest.mark.slow
def test_integrate_brick_overflow_falls_back_dense():
    """A noise depth frame turns most of the frustum into band/boundary
    bricks; at 128³ that overflows the per-camera refine capacity
    (NB//8) and the lax.cond fallback must keep the result exact."""
    intr = _intr()
    rng = np.random.default_rng(7)
    d = rng.uniform(0.3, 1.2, (48, 64)).astype(np.float32)
    va = M.TSDFVolume.create((128, 128, 128), 0.01,
                             origin=(-0.64, -0.64, 0.0))
    va = M.integrate(va, jnp.asarray(d), intr, I4, depth_scale=1.0,
                     method="dense")
    vb = M.TSDFVolume.create((128, 128, 128), 0.01,
                             origin=(-0.64, -0.64, 0.0))
    vb = M.integrate(vb, jnp.asarray(d), intr, I4, depth_scale=1.0,
                     method="brick")
    np.testing.assert_allclose(np.asarray(va.tsdf), np.asarray(vb.tsdf),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(va.weight),
                               np.asarray(vb.weight), atol=1e-6)


def test_integrate_method_validation():
    vol = M.TSDFVolume.create((12, 12, 12), 0.05)  # not 8-divisible
    intr = _intr()
    d = jnp.zeros((48, 64), jnp.float32)
    with pytest.raises(ValueError, match="8-divisible"):
        M.integrate(vol, d, intr, I4, method="brick")
    with pytest.raises(ValueError, match="method"):
        M.integrate(vol, d, intr, I4, method="fast")
    # mxu pads non-divisible grids internally (brick does not); fresh
    # volumes each call — integrate donates its input
    out = M.integrate(vol, d, intr, I4, method="mxu")
    assert out.tsdf.shape == (12, 12, 12)
    out = M.integrate(M.TSDFVolume.create((12, 12, 12), 0.05), d, intr,
                      I4, method="auto")
    assert out.tsdf.shape == (12, 12, 12)
    # colored volumes ride the packed one-hot gather — no raise
    color = jnp.zeros((48, 64, 3), jnp.uint8)
    volc = M.TSDFVolume.create((16, 16, 16), 0.05, with_rgb=True)
    out = M.integrate(volc, d, intr, I4, color=color, method="mxu")
    assert out.rgb is not None
    volc = M.TSDFVolume.create((16, 16, 16), 0.05, with_rgb=True)
    out = M.integrate(volc, d, intr, I4, color=color, method="auto")
    assert out.rgb is not None


# ---------------------------------------------------------------------------
# one-hot matmul integration
# ---------------------------------------------------------------------------

def _bitwise_vs_dense(va, vb):
    assert np.array_equal(np.asarray(va.tsdf), np.asarray(vb.tsdf))
    assert np.array_equal(np.asarray(va.weight), np.asarray(vb.weight))


def test_integrate_mxu_matches_dense_bitwise():
    """The one-hot depth lookup selects exactly one patch element at
    HIGHEST precision, so parity with the dense gather is BITWISE
    equality, not a tolerance (tsdf.py: _mxu_depth_lookup)."""
    intr = _intr()
    T2 = np.eye(4, dtype=np.float32)
    T2[:3, 3] = [0.15, -0.1, -0.1]
    d1 = render_depth(intr, I4, **SCENE)
    d2 = render_depth(intr, T2, **SCENE)
    d1[10:30, 20:40] = 0.0           # dead sensor patch
    batched = jnp.stack([jnp.asarray(d1), jnp.asarray(d2)])
    intr_b = intr.stack([intr])
    ext_b = jnp.stack([jnp.asarray(I4), jnp.asarray(T2)])
    # offset origins: border bricks, behind-camera bricks, and (second
    # origin) near-camera bricks that overflow the 64-pixel patch and
    # take the brick-granular gather fallback
    for origin in [(-0.64, -0.64, 0.0), (-0.3, -0.2, -0.4)]:
        va = M.TSDFVolume.create((64, 64, 64), 0.02, origin=origin)
        vb = M.TSDFVolume.create((64, 64, 64), 0.02, origin=origin)
        for _ in range(2):
            va = M.integrate(va, batched, intr_b, ext_b, depth_scale=1.0,
                             method="dense")
            vb = M.integrate(vb, batched, intr_b, ext_b, depth_scale=1.0,
                             method="mxu")
        _bitwise_vs_dense(va, vb)


def test_integrate_mxu_gates_match_dense():
    intr = _intr()
    d1 = render_depth(intr, I4, **SCENE)
    batched = jnp.stack([jnp.asarray(d1), jnp.asarray(d1) * 0.5])
    intr_b = intr.stack([intr])
    ext_b = jnp.stack([jnp.asarray(I4), jnp.asarray(I4)])
    kw = dict(depth_scale=1.0, cam_mask=jnp.asarray([True, False]),
              z_min=0.3, z_max=0.8, max_weight=1.5)
    va = M.TSDFVolume.create((64, 64, 64), 0.02, origin=(-0.64, -0.64, 0.0))
    va = M.integrate(va, batched, intr_b, ext_b, method="dense", **kw)
    vb = M.TSDFVolume.create((64, 64, 64), 0.02, origin=(-0.64, -0.64, 0.0))
    vb = M.integrate(vb, batched, intr_b, ext_b, method="mxu", **kw)
    _bitwise_vs_dense(va, vb)


def test_integrate_mxu_noise_overflows_to_full_gather():
    """A noise frame from INSIDE the volume blows past the kb
    near-camera brick cap; the per-camera lax.cond full-gather fallback
    must keep the result exact (tsdf.py: _integrate_mxu_jit)."""
    intr = _intr()
    rng = np.random.default_rng(7)
    d = rng.uniform(0.05, 0.4, (48, 64)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.32, 0.32, 0.3]     # camera inside the grid
    va = M.TSDFVolume.create((64, 64, 64), 0.01, origin=(0.0, 0.0, 0.0))
    va = M.integrate(va, jnp.asarray(d), intr, T, depth_scale=1.0,
                     method="dense")
    vb = M.TSDFVolume.create((64, 64, 64), 0.01, origin=(0.0, 0.0, 0.0))
    vb = M.integrate(vb, jnp.asarray(d), intr, T, depth_scale=1.0,
                     method="mxu")
    _bitwise_vs_dense(va, vb)


def test_integrate_mxu_color_matches_dense_bitwise():
    """uint8 color packs all three channels into ONE integer-valued f32
    one-hot gather (r + 256g + 65536b ≤ 2²⁴−1, unpacked exactly); float
    color gathers three planes — both bitwise the dense path's
    gather-then-cast (tsdf.py: _integrate_mxu_jit col_planes)."""
    intr = _intr()
    rng = np.random.default_rng(3)
    d1 = render_depth(intr, I4, **SCENE)
    d1[5:9, 11:17] = 0.0             # dead patch: refine-brick coverage
    color = rng.integers(0, 256, (2, 48, 64, 3), dtype=np.uint8)
    batched = jnp.stack([jnp.asarray(d1), jnp.asarray(d1) * 0.9])
    intr_b = intr.stack([intr])
    ext_b = jnp.stack([jnp.asarray(I4), jnp.asarray(I4)])
    for col in (jnp.asarray(color),
                jnp.asarray(color).astype(jnp.float32)):
        kw = dict(depth_scale=1.0, color=col)
        va = M.TSDFVolume.create((32, 32, 32), 0.04,
                                 origin=(-0.64, -0.64, 0.0), with_rgb=True)
        va = M.integrate(va, batched, intr_b, ext_b, method="dense", **kw)
        vb = M.TSDFVolume.create((32, 32, 32), 0.04,
                                 origin=(-0.64, -0.64, 0.0), with_rgb=True)
        vb = M.integrate(vb, batched, intr_b, ext_b, method="mxu_xla", **kw)
        _bitwise_vs_dense(va, vb)
        assert np.array_equal(np.asarray(va.rgb), np.asarray(vb.rgb))


def test_onehot_gather_chunk_padding_bitwise():
    """The XLA one-hot gather pads ragged brick counts up to full
    lax.map chunks with don't-care rows instead of degenerating to a
    gcd chunk of 1-2 (the pruned tier capacities nb//3 / nb//2 are
    rarely 1024-divisible, and gcd chunking serialized the map into
    thousands of steps). Padding must stay bitwise: drive the
    padded branch directly (K=1500 > _MXU_CHUNK, not a multiple) against
    a numpy gather."""
    from pointcloud_stitching_tpu.models.tsdf import (_BVOX, _MXU_CHUNK,
                                                      _onehot_gather)

    rng = np.random.default_rng(7)
    h, w, k = 80, 96, 1500
    assert k > _MXU_CHUNK and k % _MXU_CHUNK != 0
    img = rng.integers(0, 1 << 16, (h, w)).astype(np.float32)
    pv, pu = 64, 64   # _PATCH-clamped window at this image size
    v0 = rng.integers(0, h - pv, k, dtype=np.int32)
    u0 = rng.integers(0, w - pu, k, dtype=np.int32)
    iv = rng.integers(0, pv, (k, _BVOX), dtype=np.int32)
    iu = rng.integers(0, pu, (k, _BVOX), dtype=np.int32)
    got = np.asarray(_onehot_gather(
        jnp.asarray(img), jnp.asarray(v0), jnp.asarray(u0),
        jnp.asarray(iv), jnp.asarray(iu)))
    want = img[v0[:, None] + iv, u0[:, None] + iu]
    assert got.shape == (k, _BVOX)
    assert np.array_equal(got, want)


def test_integrate_mxu_any_shape_matches_dense_bitwise():
    """Non-8-divisible grids are padded internally to brick multiples and
    cropped after the elementwise merge — bitwise for any shape."""
    intr = _intr()
    d1 = render_depth(intr, I4, **SCENE)
    va = M.TSDFVolume.create((20, 28, 13), 0.05, origin=(-0.5, -0.7, 0.0))
    va = M.integrate(va, jnp.asarray(d1), intr, I4, depth_scale=1.0,
                     method="dense")
    vb = M.TSDFVolume.create((20, 28, 13), 0.05, origin=(-0.5, -0.7, 0.0))
    vb = M.integrate(vb, jnp.asarray(d1), intr, I4, depth_scale=1.0,
                     method="mxu_xla")
    _bitwise_vs_dense(va, vb)


# ---------------------------------------------------------------------------
# prior-windowed ray casting
# ---------------------------------------------------------------------------

def _fused_scene_vol():
    intr = _intr()
    vol = _plane_vol()
    d = render_depth(intr, I4, **SCENE)
    vol = M.integrate(vol, jnp.asarray(d), intr, I4, depth_scale=1.0)
    return vol, intr, d


def test_raycast_prior_window_matches_full():
    vol, intr, d = _fused_scene_vol()
    full = M.raycast(vol, intr, I4, t_min=0.1, t_max=2.0)
    pri = M.raycast(vol, intr, I4, t_min=0.1, t_max=2.0,
                    prior_depth=jnp.asarray(d), prior_window=0.3,
                    depth_scale=1.0)
    both = np.asarray(full.valid) & np.asarray(pri.valid)
    assert both.mean() > 0.5
    # windowed march finds the same surface where both are valid — up to
    # occlusion boundaries, where the full march may hit a grazing front
    # surface the prior window (centered on the live depth of the BACK
    # surface) legitimately skips; those edge pixels are a small fraction
    dd = np.abs(np.asarray(full.depth) - np.asarray(pri.depth))[both]
    assert np.median(dd) < 1e-3
    assert (dd > 5e-3).mean() < 0.02
    # and it must not lose hits the full march found near the prior:
    # every full-march hit within the window of the live depth is found
    lost = np.asarray(full.valid) & ~np.asarray(pri.valid) \
        & (np.abs(np.asarray(full.depth) - d) < 0.15) & (d > 0)
    assert lost.mean() < 0.02


def test_track_prior_window_matches_full_march():
    vol, intr, d = _fused_scene_vol()
    # perturb the pose, recover it two ways
    ang = 0.02
    Rp = np.array([[np.cos(ang), 0, np.sin(ang)],
                   [0, 1, 0],
                   [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, :3] = Rp
    T0[:3, 3] = [0.02, -0.015, 0.01]
    kw = dict(depth_scale=1.0, stride=1, t_min=0.1, t_max=2.0)
    full = M.track(vol, jnp.asarray(d), intr, jnp.asarray(T0),
                   prior_window=None, **kw)
    pri = M.track(vol, jnp.asarray(d), intr, jnp.asarray(T0),
                  prior_window=0.3, **kw)
    # both recover ~identity; prior-window must be as accurate
    for res in (full, pri):
        T = np.asarray(res.T)
        assert np.abs(T[:3, 3]).max() < 5e-3
        assert np.abs(T[:3, :3] - np.eye(3)).max() < 5e-3
    assert int(pri.n_matched) > 0.8 * int(full.n_matched)
