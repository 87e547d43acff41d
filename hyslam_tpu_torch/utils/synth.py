"""Synthetic worlds, poses and rendered stereo images in numpy.

A numpy twin of the JAX package's test helpers (``tests/helpers.py``:
``make_world``, ``make_trajectory``, ``observe``, ``perturb_pose``,
``pose_error``, ``render_world``), so that the port can be driven end to end
on a machine without JAX. The random draws are the helpers' draws in the same
order, so one seed gives the same world; poses are computed in float64 and
stored as float32.
"""

from __future__ import annotations

import os

import numpy as np


def _hat(w: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def se3_exp(xi) -> np.ndarray:
    """[6] (omega, upsilon) -> [4,4] float64 (left-multiplicative convention
    of the JAX package's geometry/se3.py)."""
    xi = np.asarray(xi, np.float64)
    w, v = xi[:3], xi[3:]
    th2 = float(w @ w)
    W = _hat(w)
    if th2 < 1e-12:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        th = np.sqrt(th2)
        A = np.sin(th) / th
        B = (1.0 - np.cos(th)) / th2
        C = (1.0 - A) / th2
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * W + B * (W @ W)
    T[:3, 3] = (np.eye(3) + B * W + C * (W @ W)) @ v
    return T


def se3_log(T) -> np.ndarray:
    """[4,4] -> [6] (omega, upsilon), float64, for rotations below pi."""
    T = np.asarray(T, np.float64)
    R, t = T[:3, :3], T[:3, 3]
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    vee = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    w = 0.5 * vee if th < 1e-6 else th / (2.0 * np.sin(th)) * vee
    W = _hat(w)
    if th < 1e-4:
        D = 1.0 / 12.0
    else:
        A = np.sin(th) / th
        B = (1.0 - np.cos(th)) / (th * th)
        D = (1.0 - A / (2.0 * B)) / (th * th)
    v = (np.eye(3) - 0.5 * W + D * (W @ W)) @ t
    return np.concatenate([w, v])


def pose_error(Ta, Tb):
    """(rotation deg, translation) error between two poses, as
    tests/helpers.pose_error: the norms of log(Ta Tb^-1)."""
    d = se3_log(np.asarray(Ta, np.float64) @ np.linalg.inv(np.asarray(Tb, np.float64)))
    return float(np.degrees(np.linalg.norm(d[:3]))), float(np.linalg.norm(d[3:]))


def make_world(rng, n_points=500, extent=(8.0, 6.0, 14.0), z_min=2.0):
    """Random 3D landmark cloud in front of the origin camera."""
    return np.stack(
        [
            rng.uniform(-extent[0], extent[0], n_points),
            rng.uniform(-extent[1], extent[1], n_points),
            rng.uniform(z_min, extent[2], n_points),
        ],
        axis=-1,
    ).astype(np.float32)


def make_trajectory(n_frames=20, step=0.25, yaw_rate=0.01):
    """Forward-motion trajectory with slight yaw; returns Tcw [F,4,4]."""
    delta = se3_exp([0.0, yaw_rate, 0.0, 0.0, 0.0, -step]).astype(np.float32)
    Ts = []
    T = np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        Ts.append(T.copy())
        T = (delta @ T).astype(np.float32)
    return np.stack(Ts)


def _project(cam, Tcw, pts):
    """World points -> (uv [N,2], z [N]) in float32, as geometry/camera."""
    Tcw = np.asarray(Tcw, np.float32)
    pc = pts.astype(np.float32) @ Tcw[:3, :3].T + Tcw[:3, 3]
    z = pc[:, 2]
    zs = np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    u = np.float32(cam.fx) * pc[:, 0] / zs + np.float32(cam.cx)
    v = np.float32(cam.fy) * pc[:, 1] / zs + np.float32(cam.cy)
    return np.stack([u, v], -1), z


def observe(cam, Tcw, pts, noise=0.3, rng=None, stereo_frac=1.0):
    """Project world points under a pose; returns (uv [N,2], ur [N],
    visible [N] bool, stereo [N] bool), with pixel noise."""
    if rng is None:
        rng = np.random.default_rng(0)
    uv, z = _project(cam, Tcw, pts)
    zs = np.where(np.abs(z) < 1e-9, np.float32(1e-9), z)
    ur = uv[:, 0] - np.float32(cam.bf) / zs
    vis = ((z > 0.2) & (uv[:, 0] >= 0) & (uv[:, 0] < cam.width)
           & (uv[:, 1] >= 0) & (uv[:, 1] < cam.height))
    uv = uv + rng.normal(0, noise, uv.shape)
    ur = ur + rng.normal(0, noise, ur.shape)
    stereo = vis & (rng.uniform(size=len(z)) < stereo_frac)
    return uv.astype(np.float32), ur.astype(np.float32), vis, stereo


def perturb_pose(rng, T, rot=0.02, trans=0.1):
    xi = np.concatenate(
        [rng.normal(0, rot, 3), rng.normal(0, trans, 3)]).astype(np.float32)
    return (se3_exp(xi) @ np.asarray(T, np.float64)).astype(np.float32)


def pose_problem(seed: int, outlier_frac: float, stereo_frac: float, n: int):
    """tests/test_pose_opt_pallas.py:problem at n observations, with
    tests/helpers.py's DEFAULT_CAM: (cam, T_true, the pose solver's seven
    arrays T0, X, uv, ur, inv_sigma2, valid, stereo)."""
    from hyslam_tpu_torch.geometry.camera import Camera

    cam = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                 height=480, bf=45.0)
    rng = np.random.default_rng(seed)
    pts = make_world(rng, n)
    T_true = make_trajectory(3)[2]
    uv, ur, vis, stereo = observe(cam, T_true, pts, noise=0.3, rng=rng,
                                  stereo_frac=stereo_frac)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(30, 120, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    T0 = perturb_pose(rng, T_true, rot=0.03, trans=0.15)
    return cam, T_true, (T0, pts, uv, ur, np.ones(n, np.float32), vis, stereo & vis)


def gaussian_blur(img: np.ndarray, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur with edge-replicated borders, float32, in the
    JAX package's accumulation order (ops/pyramid.py:gaussian_blur)."""
    x0 = np.arange(ksize) - (ksize - 1) / 2.0
    kk = np.exp(-0.5 * (x0 / sigma) ** 2)
    kk = (kk / kk.sum()).astype(np.float32)
    pad = ksize // 2
    H, W = img.shape
    x = np.pad(img, ((pad, pad), (0, 0)), mode="edge")
    acc = np.zeros_like(img)
    for i in range(ksize):
        acc = acc + kk[i] * x[i:i + H]
    x = np.pad(acc, ((0, 0), (pad, pad)), mode="edge")
    out = np.zeros_like(img)
    for i in range(ksize):
        out = out + kk[i] * x[:, i:i + W]
    return out


def render_world(cam, Tcw, pts, point_seed=0, bg=20.0, amp=180.0, blob_scale=1.0):
    """Render a sparse textured image: each world point splats a small
    point-unique constellation of 5 sub-blobs (distinctive, approximately
    viewpoint-stable descriptors). ``blob_scale`` widens the constellations
    and the blur (2 for a camera whose images are halved before extraction:
    they then look as a scale-1 rendering does). Returns ([H,W] f32, uv,
    visible)."""
    rng_p = np.random.default_rng(point_seed)
    n = len(pts)
    offs = rng_p.uniform(-4, 4, size=(n, 5, 2)).astype(np.float32) * np.float32(blob_scale)
    amps = rng_p.uniform(0.4, 1.0, size=(n, 5)).astype(np.float32) * amp

    uv, z = _project(cam, Tcw, pts)
    vis = (z > 0.2) & (uv[:, 0] > 8) & (uv[:, 0] < cam.width - 8) \
        & (uv[:, 1] > 8) & (uv[:, 1] < cam.height - 8)

    img = np.full((cam.height, cam.width), bg, np.float32)
    pos = (uv[:, None, :] + offs).reshape(-1, 2)
    a = (amps * vis[:, None]).reshape(-1)
    xi = np.round(pos[:, 0]).astype(int)
    yi = np.round(pos[:, 1]).astype(int)
    ok = (xi >= 0) & (xi < cam.width) & (yi >= 0) & (yi < cam.height)
    np.add.at(img, (yi[ok], xi[ok]), a[ok])
    img = gaussian_blur(img, ksize=2 * int(round(2 * blob_scale)) + 1, sigma=1.0 * blob_scale)
    return np.clip(img, 0, 255).astype(np.float32), uv, vis


def seed_landmarks(cam, Tcw, uv, depth, level, desc, valid, L: int) -> dict:
    """An L-row local map from one stereo frame's features, with the JAX
    package's formulas: X unprojected from depth and moved to the world
    (slam/initializers.py:48-59); the normal is X minus the camera centre,
    normalised; max_dist = |X - C| * 1.2^level and min_dist =
    max_dist / 1.2^8 (core/mapstate.py:553-566 for one observation); the
    descriptor is the feature's. Rows past the seeded landmarks have
    lm_valid False. Returns numpy arrays named as track_stereo_frame's
    arguments; descriptors keep the dtype they came in."""
    uv, depth, level = (np.asarray(a) for a in (uv, depth, level))
    desc = np.asarray(desc)
    create = np.nonzero(np.asarray(valid) & (depth > 0))[0][:L]
    n = len(create)
    d = depth[create].astype(np.float64)
    pc = np.stack([(uv[create, 0] - cam.cx) / cam.fx * d,
                   (uv[create, 1] - cam.cy) / cam.fy * d, d], -1)
    Twc = np.linalg.inv(np.asarray(Tcw, np.float64))
    X = pc @ Twc[:3, :3].T + Twc[:3, 3]
    po = X - Twc[:3, 3]
    dist = np.linalg.norm(po, axis=-1)
    max_dist = dist * 1.2 ** level[create].astype(np.float64)
    table = {
        "lm_pos": np.zeros((L, 3), np.float32),
        "lm_normal": np.zeros((L, 3), np.float32),
        "lm_desc": np.zeros((L, 8), desc.dtype),
        "lm_max_dist": np.zeros((L,), np.float32),
        "lm_min_dist": np.zeros((L,), np.float32),
        "lm_valid": np.arange(L) < n,
    }
    table["lm_pos"][:n] = X
    table["lm_normal"][:n] = po / np.maximum(dist[:, None], 1e-9)
    table["lm_desc"][:n] = desc[create]
    table["lm_max_dist"][:n] = max_dist
    table["lm_min_dist"][:n] = max_dist / 1.2 ** 8
    return table


def render_stereo_pair(cam, Tcw, pts) -> np.ndarray:
    """[2,H,W] left/right images of a rectified rig whose right camera sits
    one baseline along +x of the left one (the right pose is
    T(-baseline x) @ Tcw)."""
    T_r = np.eye(4, dtype=np.float32)
    T_r[0, 3] = -cam.bf / cam.fx
    left, _, _ = render_world(cam, Tcw, pts)
    right, _, _ = render_world(cam, (T_r @ np.asarray(Tcw, np.float32)).astype(np.float32), pts)
    return np.stack([left, right])


def render_depth(cam, Tcw, pts, radius: int = 3, point_seed: int = 0) -> np.ndarray:
    """Registered metric depth image [H,W] f32 for ``render_world``'s view
    (same ``point_seed``): each visible point's z over a patch of ``radius``
    around each of its 5 sub-blobs, where its features land; 0 where nothing
    is drawn (no reading). Where patches overlap a pixel takes the sub-blob
    whose centre is nearest to it, and of two equally near the nearer in z,
    so that in a dense scene a blob keeps its own depth and not a
    neighbour's."""
    n = len(pts)
    offs = np.random.default_rng(point_seed).uniform(-4, 4, size=(n, 5, 2)).astype(np.float32)
    uv, z = _project(cam, Tcw, pts)
    vis = (z > 0.2) & (uv[:, 0] > 8) & (uv[:, 0] < cam.width - 8) \
        & (uv[:, 1] > 8) & (uv[:, 1] < cam.height - 8)
    idx = np.nonzero(vis)[0]
    idx = idx[np.argsort(-z[idx], kind="stable")]       # far points first
    pos = (uv[idx, None, :] + offs[idx]).reshape(-1, 2)
    x, y = np.rint(pos[:, 0]).astype(int), np.rint(pos[:, 1]).astype(int)
    zz = np.repeat(z[idx], 5)
    depth = np.zeros((cam.height, cam.width), np.float32)
    # of several writes to one pixel the last stays: the outermost ring of
    # every patch goes first, the centres last
    offsets = sorted(((dx, dy) for dy in range(-radius, radius + 1)
                      for dx in range(-radius, radius + 1)),
                     key=lambda o: -(o[0] ** 2 + o[1] ** 2))
    for dx, dy in offsets:
        xx, yy = x + dx, y + dy
        ok = (xx >= 0) & (xx < cam.width) & (yy >= 0) & (yy < cam.height)
        depth[yy[ok], xx[ok]] = zz[ok]
    return depth


def write_pgm(path: str, img: np.ndarray, maxval: int = 255) -> None:
    """Binary PGM (P5): 8-bit for maxval < 256, else 16-bit big-endian, as
    ``io.datasets._imread_gray`` reads it. Values are rounded and clipped."""
    a = np.clip(np.rint(np.asarray(img, np.float64)), 0, maxval)
    a = a.astype(np.uint8 if maxval < 256 else ">u2")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n%d\n" % (a.shape[1], a.shape[0], maxval))
        f.write(a.tobytes())


def write_kitti_sequence(root: str, cam, pairs, times, poses=None,
                         sequence: str = "00") -> None:
    """A rendered stereo sequence in the KITTI odometry layout that
    ``io.datasets.KittiOdometry`` reads: ``sequences/NN/image_{0,1}/*.pgm``
    (8-bit), ``times.txt``, ``calib.txt`` (P0, P1 with -bf in P1[0,3]) and,
    with ``poses`` (Tcw [N,4,4]), ``poses/NN.txt`` (camera-to-world 3x4 rows).
    pairs: [N,2,H,W] grey images in [0, 255]."""
    seq = os.path.join(root, "sequences", sequence)
    for i, pair in enumerate(pairs):
        for side in (0, 1):
            write_pgm(os.path.join(seq, f"image_{side}", "%06d.pgm" % i), pair[side])
    np.savetxt(os.path.join(seq, "times.txt"), np.asarray(times, np.float64))
    P0 = np.zeros((3, 4))
    P0[0, 0], P0[1, 1], P0[2, 2] = cam.fx, cam.fy, 1.0
    P0[0, 2], P0[1, 2] = cam.cx, cam.cy
    P1 = P0.copy()
    P1[0, 3] = -cam.bf
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        for k, P in (("P0", P0), ("P1", P1)):
            f.write(k + ": " + " ".join("%.9e" % v for v in P.ravel()) + "\n")
    if poses is not None:
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        Twc = np.linalg.inv(np.asarray(poses, np.float64))
        np.savetxt(os.path.join(root, "poses", sequence + ".txt"),
                   Twc[:, :3, :].reshape(len(Twc), 12))


def _quat_from_mat(R: np.ndarray) -> np.ndarray:
    """Rotation [3,3] -> unit quaternion (w, x, y, z) with w >= 0, float64."""
    R = np.asarray(R, np.float64)
    d = np.array([1 + R[0, 0] + R[1, 1] + R[2, 2], 1 + R[0, 0] - R[1, 1] - R[2, 2],
                  1 - R[0, 0] + R[1, 1] - R[2, 2], 1 - R[0, 0] - R[1, 1] + R[2, 2]])
    cand = np.array([
        [d[0], R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]],
        [R[2, 1] - R[1, 2], d[1], R[0, 1] + R[1, 0], R[0, 2] + R[2, 0]],
        [R[0, 2] - R[2, 0], R[0, 1] + R[1, 0], d[2], R[1, 2] + R[2, 1]],
        [R[1, 0] - R[0, 1], R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], d[3]]])
    q = cand[int(np.argmax(d))]
    q = q / np.linalg.norm(q)
    return -q if q[0] < 0 else q


def write_tum_sequence(root: str, images, depths, times, poses=None,
                       depth_factor: float = 5000.0) -> None:
    """A rendered RGB-D sequence in the TUM layout that
    ``io.datasets.TumRgbd`` reads: ``rgb/*.pgm`` (8-bit grey), ``depth/*.pgm``
    (16-bit, metres * depth_factor; a depth past the 16-bit range is written
    as 0, no reading), ``rgb.txt``, ``depth.txt`` and, with ``poses`` (Tcw),
    ``groundtruth.txt`` (ts tx ty tz qx qy qz qw, camera-to-world)."""
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "rgb.txt"), "w") as fr, \
            open(os.path.join(root, "depth.txt"), "w") as fd:
        fr.write("# timestamp filename\n")
        fd.write("# timestamp filename\n")
        for i, (img, dep, ts) in enumerate(zip(images, depths, times)):
            write_pgm(os.path.join(root, "rgb", "%06d.pgm" % i), img)
            raw = np.asarray(dep, np.float64) * depth_factor
            write_pgm(os.path.join(root, "depth", "%06d.pgm" % i),
                      np.where(raw > 65535, 0, raw), maxval=65535)
            fr.write("%.6f rgb/%06d.pgm\n" % (ts, i))
            fd.write("%.6f depth/%06d.pgm\n" % (ts, i))
    if poses is not None:
        with open(os.path.join(root, "groundtruth.txt"), "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n")
            for ts, Tcw in zip(times, poses):
                Twc = np.linalg.inv(np.asarray(Tcw, np.float64))
                q = _quat_from_mat(Twc[:3, :3])
                f.write("%.6f %.9f %.9f %.9f %.9f %.9f %.9f %.9f\n" % (
                    ts, *Twc[:3, 3], q[1], q[2], q[3], q[0]))


# the GPS frame of ``render_sensors`` against the SLAM frame: yaw about z
# (rad), scale and shift (GPS = scale * Rz(yaw) * SLAM + shift)
GPS_YAW, GPS_SCALE, GPS_SHIFT = 0.7, 1.03, (120.0, -45.0, 8.0)


def render_sensors(poses, seed: int = 0, gps_sigma=(0.02, 0.02, 0.05)) -> list:
    """Per-frame sensor readings from the true poses (Tcw) and a numpy seed,
    as keyword dicts for ``SensorData(**d)`` of either package:

    - GPS fixes of the camera centre in a frame of their own, rotated by
      ``GPS_YAW`` about z, scaled by ``GPS_SCALE`` and shifted by
      ``GPS_SHIFT`` against the SLAM frame, with Gaussian noise of
      ``gps_sigma`` per axis, which is also the reported per-axis error;
    - the world-to-camera quaternion (w, x, y, z), w >= 0;
    - the pressure depth: t_z of Tcw."""
    rng = np.random.default_rng(seed)
    c, s = np.cos(GPS_YAW), np.sin(GPS_YAW)
    Rg = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    sig = np.asarray(gps_sigma, np.float64)
    out = []
    for Tcw in poses:
        T = np.asarray(Tcw, np.float64)
        centre = -T[:3, :3].T @ T[:3, 3]
        gps = GPS_SCALE * (Rg @ centre) + np.asarray(GPS_SHIFT) + rng.normal(0.0, sig)
        out.append(dict(
            gps_rel=tuple(float(x) for x in gps), gps_err=tuple(float(x) for x in sig),
            gps_valid=True, quat=tuple(float(x) for x in _quat_from_mat(T[:3, :3])),
            quat_valid=True, depth=float(T[2, 3]), depth_valid=True))
    return out


def blackout(frames, start: int, stop: int, level: float = 20.0):
    """A copy of a rendered sequence [n, ...] (numpy array or tensor) whose
    frames start..stop-1 are flat images of grey ``level`` (nothing to
    extract: tracking is lost)."""
    out = frames.clone() if hasattr(frames, "clone") else np.array(frames, copy=True)
    out[start:stop] = level
    return out
