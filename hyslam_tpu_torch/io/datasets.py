"""Dataset loaders and the synthetic sequence generator (counterpart of
``hyslam_tpu/io/datasets.py``).

Readers for the standard benchmarks' folder layouts (KITTI odometry
grayscale stereo, TUM RGB-D, EuRoC MAV) and the feature-renderable synthetic
world used when no dataset is on disk. Everything here is numpy: the readers
return numpy images and poses, and ``System`` moves images to its device.
``PIL`` is optional (8-bit and 16-bit PGM are read in pure numpy without
it); ``yaml`` is needed by ``EurocMav`` only and imported there.
``utils/synth.py`` writes rendered sequences in the KITTI and TUM layouts."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np


@dataclass
class StereoFrame:
    img_left: np.ndarray
    img_right: np.ndarray
    timestamp: float
    frame_id: int
    gt_Tcw: Optional[np.ndarray] = None


@dataclass
class KittiCalib:
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int
    height: int


def _imread_depth(path: str, factor: float) -> np.ndarray:
    """16-bit depth PNG -> metric meters (TUM stores depth*5000 as u16;
    PIL's convert("L") would clamp to 8 bits and destroy the readings)."""
    try:
        from PIL import Image

        im = Image.open(path)
        if im.mode not in ("I", "I;16", "F"):
            im = im.convert("I")
        return np.asarray(im, np.float32) / factor
    except ImportError:
        return _imread_gray(path) / factor


def _imread_gray(path: str) -> np.ndarray:
    """Minimal PNG/PGM reader (no cv2 dependency): PIL if present, else
    pure-numpy PGM."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.float32)
    except ImportError:
        pass
    if path.endswith((".pgm", ".PGM")):
        with open(path, "rb") as f:
            assert f.readline().strip() == b"P5"
            line = f.readline()
            while line.startswith(b"#"):
                line = f.readline()
            w, h = map(int, line.split())
            maxv = int(f.readline())
            dt = np.uint8 if maxv < 256 else ">u2"
            return np.frombuffer(f.read(), dt).reshape(h, w).astype(np.float32)
    raise RuntimeError(f"no image reader available for {path}")


def _mat_from_quat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) -> rotation matrix [3, 3], in q's dtype."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return np.asarray([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ], q.dtype)


class KittiOdometry:
    """KITTI odometry sequence reader (dataset_root/sequences/NN with
    image_0, image_1, times.txt, calib.txt; poses from poses/NN.txt)."""

    def __init__(self, root: str, sequence: str = "00"):
        self.seq_dir = os.path.join(root, "sequences", sequence)
        self.left_dir = os.path.join(self.seq_dir, "image_0")
        self.right_dir = os.path.join(self.seq_dir, "image_1")
        self.times = np.loadtxt(os.path.join(self.seq_dir, "times.txt"))
        self.calib = self._load_calib()
        pose_file = os.path.join(root, "poses", sequence + ".txt")
        self.gt = self._load_poses(pose_file) if os.path.exists(pose_file) else None
        self.files = sorted(os.listdir(self.left_dir))

    def _load_calib(self) -> KittiCalib:
        P = {}
        with open(os.path.join(self.seq_dir, "calib.txt")) as f:
            for line in f:
                k, _, v = line.partition(":")
                P[k.strip()] = np.asarray(v.split(), np.float64).reshape(3, 4)
        P0, P1 = P["P0"], P["P1"]
        fx = float(P0[0, 0])
        bf = float(-P1[0, 3])  # P1[0,3] = -fx * baseline
        sample = _imread_gray(os.path.join(self.left_dir,
                                           sorted(os.listdir(self.left_dir))[0]))
        h, w = sample.shape
        return KittiCalib(fx=fx, fy=float(P0[1, 1]), cx=float(P0[0, 2]),
                          cy=float(P0[1, 2]), bf=bf, width=w, height=h)

    @staticmethod
    def _load_poses(path: str) -> np.ndarray:
        """poses/NN.txt rows are 3x4 camera-to-world; returns Tcw [N,4,4]."""
        raw = np.loadtxt(path).reshape(-1, 3, 4)
        n = len(raw)
        Twc = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
        Twc[:, :3, :] = raw
        return np.linalg.inv(Twc).astype(np.float32)

    def __len__(self):
        return len(self.files)

    def frames(self, start=0, stop=None) -> Iterator[StereoFrame]:
        stop = stop or len(self.files)
        for i in range(start, stop):
            fn = self.files[i]
            yield StereoFrame(
                img_left=_imread_gray(os.path.join(self.left_dir, fn)),
                img_right=_imread_gray(os.path.join(self.right_dir, fn)),
                timestamp=float(self.times[i]),
                frame_id=i,
                gt_Tcw=None if self.gt is None else self.gt[i],
            )


class TumRgbd:
    """TUM RGB-D reader: rgb.txt / depth.txt associations +
    groundtruth.txt (ts tx ty tz qx qy qz qw, camera-to-world)."""

    # default freiburg1 intrinsics
    FX, FY, CX, CY = 517.3, 516.5, 318.6, 255.3
    DEPTH_FACTOR = 5000.0

    def __init__(self, root: str):
        self.root = root
        self.rgb = self._read_list(os.path.join(root, "rgb.txt"))
        self.depth = self._read_list(os.path.join(root, "depth.txt"))
        gt_path = os.path.join(root, "groundtruth.txt")
        self.gt = self._read_gt(gt_path) if os.path.exists(gt_path) else None

    @staticmethod
    def _read_list(path):
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                ts, fn = line.split()[:2]
                out.append((float(ts), fn))
        return out

    @staticmethod
    def _read_gt(path):
        rows = []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                rows.append([float(x) for x in line.split()])
        return np.asarray(rows)

    def frames(self, start=0, stop=None):
        stop = stop or len(self.rgb)
        di = 0
        for i in range(start, stop):
            ts, fn = self.rgb[i]
            while di + 1 < len(self.depth) and abs(self.depth[di + 1][0] - ts) < abs(
                    self.depth[di][0] - ts):
                di += 1
            img = _imread_gray(os.path.join(self.root, fn))
            dimg = _imread_depth(os.path.join(self.root, self.depth[di][1]),
                                 self.DEPTH_FACTOR)
            yield i, ts, img, dimg


class EurocMav:
    """EuRoC MAV reader (ASL folder layout): `mav0/cam{0,1}/data.csv`
    timestamp->filename lists, `mav0/cam{0,1}/sensor.yaml` intrinsics +
    body->camera extrinsics, `mav0/state_groundtruth_estimate0/data.csv`
    body poses. Stereo pairs are associated by nearest timestamp within
    `max_dt`. Note EuRoC raw images are unrectified; like the reference
    (Camera.h distortion comment) rectification is assumed done upstream —
    intrinsics here are the raw pinhole part."""

    def __init__(self, root: str, max_dt: float = 0.005):
        import yaml

        mav = os.path.join(root, "mav0")
        self.cam0_dir = os.path.join(mav, "cam0", "data")
        self.cam1_dir = os.path.join(mav, "cam1", "data")
        self.cam0 = self._read_csv_list(os.path.join(mav, "cam0", "data.csv"))
        self.cam1 = self._read_csv_list(os.path.join(mav, "cam1", "data.csv"))
        with open(os.path.join(mav, "cam0", "sensor.yaml")) as f:
            s0 = yaml.safe_load(f)
        with open(os.path.join(mav, "cam1", "sensor.yaml")) as f:
            s1 = yaml.safe_load(f)
        fu, fv, cu, cv = s0["intrinsics"]
        w, h = s0["resolution"]
        self.T_BS0 = np.asarray(s0["T_BS"]["data"],
                                np.float64).reshape(4, 4)
        self.T_BS1 = np.asarray(s1["T_BS"]["data"], np.float64).reshape(4, 4)
        # stereo baseline from the two rig extrinsics (T_BS maps sensor
        # coords into body coords in the ASL convention)
        baseline = float(np.linalg.norm(
            self.T_BS0[:3, 3] - self.T_BS1[:3, 3]))
        self.calib = KittiCalib(fx=float(fu), fy=float(fv), cx=float(cu),
                                cy=float(cv), bf=float(fu) * baseline,
                                width=int(w), height=int(h))
        gt_path = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
        self.gt = self._read_gt(gt_path) if os.path.exists(gt_path) else None
        # stereo association by nearest timestamp
        self.pairs = []
        t1 = np.asarray([t for t, _ in self.cam1])
        for i, (t0, _) in enumerate(self.cam0):
            j = int(np.argmin(np.abs(t1 - t0)))
            if abs(t1[j] - t0) <= max_dt:
                self.pairs.append((i, j))

    @staticmethod
    def _read_csv_list(path):
        out = []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                ts_ns, fn = line.strip().split(",")[:2]
                out.append((int(ts_ns) * 1e-9, fn.strip()))
        return out

    @staticmethod
    def _read_gt(path):
        """Returns (timestamps [N], T_WB [N,4,4]) body-to-world poses."""
        ts, poses = [], []
        with open(path) as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                v = [float(x) for x in line.split(",")[:8]]
                ts.append(v[0] * 1e-9)
                T = np.eye(4, dtype=np.float64)
                # q_RS is (w, x, y, z) in the ASL csv
                qw, qx, qy, qz = v[4], v[5], v[6], v[7]
                T[:3, :3] = _mat_from_quat(
                    np.asarray([qw, qx, qy, qz], np.float32))
                T[:3, 3] = v[1:4]
                poses.append(T)
        return np.asarray(ts), np.asarray(poses, np.float32)

    def gt_Tcw_at(self, t: float):
        """Ground-truth world->cam0 pose at time t (nearest gt sample)."""
        if self.gt is None:
            return None
        ts, T_WB = self.gt
        i = int(np.argmin(np.abs(ts - t)))
        T_WC = T_WB[i].astype(np.float64) @ self.T_BS0
        return np.linalg.inv(T_WC).astype(np.float32)

    def __len__(self):
        return len(self.pairs)

    def frames(self, start=0, stop=None) -> Iterator[StereoFrame]:
        stop = stop or len(self.pairs)
        for k in range(start, stop):
            i, j = self.pairs[k]
            t0, f0 = self.cam0[i]
            _, f1 = self.cam1[j]
            yield StereoFrame(
                img_left=_imread_gray(os.path.join(self.cam0_dir, f0)),
                img_right=_imread_gray(os.path.join(self.cam1_dir, f1)),
                timestamp=t0,
                frame_id=k,
                gt_Tcw=self.gt_Tcw_at(t0),
            )


def synthetic_stereo_sequence(rng, cam, n_frames=100, step=0.15,
                              yaw_rate=0.003, n_points=3000,
                              extent=(15.0, 8.0, 80.0)):
    """Feature-renderable synthetic stereo world (no dataset required)."""
    from hyslam_tpu_torch.utils.synth import se3_exp

    pts = np.stack(
        [rng.uniform(-extent[0], extent[0], n_points),
         rng.uniform(-extent[1], extent[1], n_points),
         rng.uniform(1.5, extent[2], n_points)], -1,
    ).astype(np.float32)
    delta = se3_exp([0, yaw_rate, 0, 0, 0, -step]).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    Ts = []
    for _ in range(n_frames):
        Ts.append(T.copy())
        T = (delta @ T).astype(np.float32)
    return pts, np.stack(Ts)
