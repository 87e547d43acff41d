"""Write a long rendered sequence to disk in the KITTI-odometry or the
TUM-RGB-D layout, for the port's dataset drivers
(examples/run_kitti_torch.py, examples/run_tum_torch.py): the twin of
tools/make_synthetic_dataset.py in numpy, with the images rendered by
``hyslam_tpu_torch/utils/synth.py``. The circuit, the world and the
cameras are that tool's (the same seeds give the same poses and points);
every image is a PGM, which the port reads in pure numpy: 8-bit grey
images, and TUM depth as 16-bit depth * 5000.

    python3 tools/make_synthetic_dataset_torch.py kitti /data/synth_kitti --frames 600
    python3 tools/make_synthetic_dataset_torch.py tum /data/synth_tum --frames 600

KITTI layout (hyslam_tpu_torch/io/datasets.py): sequences/00/{image_0,
image_1}/*.pgm, times.txt, calib.txt and poses/00.txt (3x4
camera-to-world rows), 640x360. TUM layout: rgb/*.pgm, depth/*.pgm,
rgb.txt, depth.txt, groundtruth.txt (ts tx ty tz qx qy qz qw,
camera-to-world), 640x480.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hyslam_tpu_torch.geometry.camera import Camera  # noqa: E402
from hyslam_tpu_torch.io.datasets import TumRgbd  # noqa: E402
from hyslam_tpu_torch.utils import synth  # noqa: E402


def circuit_poses(n_frames: int, radius: float, n_loops: float = 1.02) -> list:
    """Tcw of a camera riding a circle of ``radius`` and looking along its
    tangent; a full lap revisits the start."""
    out = []
    for i in range(n_frames):
        th = 2 * np.pi * n_loops * i / n_frames
        C = np.array([radius * np.sin(th), 0.0, radius * (1 - np.cos(th))], np.float32)
        fwd = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
        up = np.array([0.0, -1.0, 0.0], np.float32)
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = np.stack([np.cross(up, fwd), up, fwd], axis=1)
        Twc[:3, 3] = C
        out.append(np.linalg.inv(Twc).astype(np.float32))
    return out


def circuit_world(rng, radius: float, n_points: int, wall_min=4.0, wall_max=18.0,
                  y_range=(-4.0, 3.0)) -> np.ndarray:
    """Points in a band around the circuit (inner and outer walls), so that
    every viewpoint of the lap sees texture."""
    th = rng.uniform(0, 2 * np.pi, n_points)
    r = radius + rng.uniform(wall_min, wall_max, n_points) * rng.choice(
        [-1.0, 1.0], n_points, p=[0.35, 0.65])
    y = rng.uniform(*y_range, n_points)
    return np.stack([r * np.sin(th), y, radius - r * np.cos(th)], -1).astype(np.float32)


def render_depth(cam, Tcw, pts, radius_px: int = 5) -> np.ndarray:
    """Each visible point's z splatted over a disc of ``radius_px`` (the
    nearest z wins), as make_synthetic_dataset.py renders TUM depth."""
    uv, z = synth._project(cam, Tcw, pts)
    H, W = cam.height, cam.width
    depth = np.zeros((H, W), np.float32)
    vis = (z > 0.2) & (uv[:, 0] > -radius_px) & (uv[:, 0] < W + radius_px) \
        & (uv[:, 1] > -radius_px) & (uv[:, 1] < H + radius_px)
    order = np.argsort(-z[vis])                 # far first; near overwrites
    ui = np.round(uv[vis][order]).astype(int)
    zi = z[vis][order]
    rr = np.arange(-radius_px, radius_px + 1)
    dy, dx = np.meshgrid(rr, rr, indexing="ij")
    disc = (dx * dx + dy * dy) <= radius_px * radius_px
    px = ui[:, None, 0] + dx[disc][None, :]
    py = ui[:, None, 1] + dy[disc][None, :]
    pz = np.broadcast_to(zi[:, None], px.shape)
    ok = (px >= 0) & (px < W) & (py >= 0) & (py < H)
    depth[py[ok], px[ok]] = pz[ok]
    return depth


def write_pgm(path: str, img: np.ndarray, maxval: int = 255) -> None:
    """Binary PGM, truncated to integers as make_synthetic_dataset.py
    writes its images (8-bit) and its depth PNGs (16-bit, big-endian here)."""
    a = np.clip(img, 0, maxval).astype(np.uint8 if maxval < 256 else np.uint16)
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n%d\n" % (a.shape[1], a.shape[0], maxval))
        f.write(a.astype(">u2").tobytes() if maxval >= 256 else a.tobytes())


def kitti_camera() -> Camera:
    fx = 450.0
    baseline = 0.54                       # a KITTI-class stereo rig
    return Camera(fx=fx, fy=fx, cx=320.0, cy=180.0, width=640, height=360, bf=fx * baseline,
                  th_depth=40.0 * baseline)


def tum_camera() -> Camera:
    return Camera(fx=TumRgbd.FX, fy=TumRgbd.FY, cx=TumRgbd.CX, cy=TumRgbd.CY, width=640,
                  height=480, bf=TumRgbd.FX * 0.08)


def gen_kitti(root: str, n_frames: int, seed: int = 0, n_loops: float = 1.02) -> None:
    cam = kitti_camera()
    baseline = cam.bf / cam.fx
    rng = np.random.default_rng(seed)
    radius = 40.0
    pts = circuit_world(rng, radius, 9000)
    poses = circuit_poses(n_frames, radius, n_loops)
    seq = os.path.join(root, "sequences", "00")
    for d in ("image_0", "image_1"):
        os.makedirs(os.path.join(seq, d), exist_ok=True)
    os.makedirs(os.path.join(root, "poses"), exist_ok=True)
    with open(os.path.join(seq, "calib.txt"), "w") as f:
        f.write("P0: %g 0 %g 0 0 %g %g 0 0 0 1 0\n" % (cam.fx, cam.cx, cam.fy, cam.cy))
        f.write("P1: %g 0 %g %g 0 %g %g 0 0 0 1 0\n" % (cam.fx, cam.cx, -cam.bf, cam.fy,
                                                        cam.cy))
    with open(os.path.join(seq, "times.txt"), "w") as f:
        for i in range(n_frames):
            f.write("%.6f\n" % (0.1 * i))
    T_right = np.eye(4, dtype=np.float32)
    T_right[0, 3] = -baseline
    rows = []
    for i, Tcw in enumerate(poses):
        left, _, _ = synth.render_world(cam, Tcw, pts)
        right, _, _ = synth.render_world(cam, (T_right @ Tcw).astype(np.float32), pts)
        write_pgm(os.path.join(seq, "image_0", "%06d.pgm" % i), left)
        write_pgm(os.path.join(seq, "image_1", "%06d.pgm" % i), right)
        rows.append(np.linalg.inv(Tcw.astype(np.float64))[:3, :].reshape(-1))
        if i % 50 == 0:
            print(f"kitti frame {i}/{n_frames}", flush=True)
    np.savetxt(os.path.join(root, "poses", "00.txt"), np.stack(rows), fmt="%.9e")
    print(f"wrote {n_frames}-frame KITTI-layout sequence to {root}")


def gen_tum(root: str, n_frames: int, seed: int = 1, n_loops: float = 1.02) -> None:
    cam = tum_camera()
    rng = np.random.default_rng(seed)
    radius = 4.0      # a room-scale loop: every depth under 65535 / 5000 = 13.1 m
    pts = circuit_world(rng, radius, 6000, wall_min=1.2, wall_max=5.0, y_range=(-1.8, 1.4))
    poses = circuit_poses(n_frames, radius, n_loops)
    for d in ("rgb", "depth"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    with open(os.path.join(root, "rgb.txt"), "w") as frgb, \
            open(os.path.join(root, "depth.txt"), "w") as fdep, \
            open(os.path.join(root, "groundtruth.txt"), "w") as fgt:
        for f in (frgb, fdep, fgt):
            f.write("# synthetic TUM-layout sequence\n")
        for i, Tcw in enumerate(poses):
            t = 0.1 * i
            img, _, _ = synth.render_world(cam, Tcw, pts)
            write_pgm(os.path.join(root, "rgb", "%.6f.pgm" % t), img)
            write_pgm(os.path.join(root, "depth", "%.6f.pgm" % t),
                      render_depth(cam, Tcw, pts) * 5000.0, maxval=65535)
            frgb.write("%.6f rgb/%.6f.pgm\n" % (t, t))
            fdep.write("%.6f depth/%.6f.pgm\n" % (t, t))
            Twc = np.linalg.inv(Tcw.astype(np.float64))
            q = synth._quat_from_mat(Twc[:3, :3])            # w, x, y, z
            fgt.write("%.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n" % (
                t, Twc[0, 3], Twc[1, 3], Twc[2, 3], q[1], q[2], q[3], q[0]))
            if i % 50 == 0:
                print(f"tum frame {i}/{n_frames}", flush=True)
    print(f"wrote {n_frames}-frame TUM-layout sequence to {root}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("layout", choices=["kitti", "tum"])
    ap.add_argument("root")
    ap.add_argument("--frames", type=int, default=600)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--loops", type=float, default=1.02,
                    help="fraction of the circuit covered: the motion a frame scales "
                         "with loops/frames, so a short sequence keeps the full soak's "
                         "motion with a small value")
    args = ap.parse_args(argv)
    gen = gen_kitti if args.layout == "kitti" else gen_tum
    gen(args.root, args.frames, args.seed, args.loops)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
