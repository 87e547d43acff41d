"""Run the port's SLAM on a TUM RGB-D sequence (e.g. fr1/desk) and report
ATE against the ground truth (the twin of examples/run_tum.py, on the
card). Monocular by default; ``--rgbd`` feeds the registered depth through
``System.track_rgbd``.

    python3 examples/run_tum_torch.py /data/tum/rgbd_dataset_freiburg1_desk \
        --frames 300 --out out_tum/ [--rgbd] [--json soak.json] [--synthetic]

``--json`` writes the soak artifact: the JAX driver's keys, plus
``synthetic`` and the device's name.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples.torch_common import device_record, pose_np  # noqa: E402
from hyslam_tpu_torch.core.mapstate import MapCaps  # noqa: E402
from hyslam_tpu_torch.device import resolve_device  # noqa: E402
from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig  # noqa: E402
from hyslam_tpu_torch.io.datasets import TumRgbd, _mat_from_quat  # noqa: E402
from hyslam_tpu_torch.io.evaluate import ate_rmse  # noqa: E402
from hyslam_tpu_torch.slam.mapper import MapperParams  # noqa: E402
from hyslam_tpu_torch.slam.system import System  # noqa: E402


def gt_Tcw(gt: np.ndarray, t: float) -> np.ndarray:
    """The world->camera pose of the ground-truth row nearest in time to t
    (rows: ts tx ty tz qx qy qz qw, camera-to-world)."""
    tx, ty, tz, qx, qy, qz, qw = gt[int(np.argmin(np.abs(gt[:, 0] - t))), 1:8]
    Twc = np.eye(4, dtype=np.float32)
    Twc[:3, :3] = _mat_from_quat(np.asarray([qw, qx, qy, qz], np.float32))
    Twc[:3, 3] = [tx, ty, tz]
    return np.linalg.inv(Twc)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="TUM sequence dir (rgb.txt, depth.txt, ...)")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out", default="out_tum")
    ap.add_argument("--rgbd", action="store_true",
                    help="use the registered depth (System.track_rgbd); by default "
                         "the camera is monocular and the depth is not read")
    ap.add_argument("--mode", choices=["async", "pipelined", "sync"], default="sync")
    ap.add_argument("--json", default=None, help="write the soak artifact here")
    ap.add_argument("--synthetic", action="store_true",
                    help="the sequence is rendered: recorded in the artifact")
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds = TumRgbd(args.root)
    cfg = SystemConfig(caps=MapCaps(K=256, L=16384, F=1024, O=16),
                       async_tracking=args.mode == "async",
                       pipelined=args.mode == "pipelined", device=dev,
                       mapper=MapperParams(orphan_age=6))   # the long-run arena policy
    cfg.cameras["SLAM"] = CameraConfig(
        fx=ds.FX, fy=ds.FY, cx=ds.CX, cy=ds.CY, width=640, height=480, mono=not args.rgbd,
        # the virtual baseline of the synthesized stereo channel: fx * 0.08 m
        bf=ds.FX * 0.08 if args.rgbd else 0.0)
    slam = System(cfg)

    stop = args.frames or None
    est, ts = [], []
    n_fed = 0
    t0 = time.perf_counter()
    for i, t, img, depth in ds.frames(stop=stop):
        tel = slam.track_rgbd(img, depth, t) if args.rgbd else slam.track_monocular(img, t)
        n_fed = i + 1
        ts.append(t)
        if tel is None or args.mode == "async":
            continue       # async / pipelined: the trajectory at the end
        est.append(pose_np(slam.trackers["SLAM"].last_Tcw))
        if i % 50 == 0:
            print(f"frame {i}: state={tel.state} inliers={tel.n_inliers}", flush=True)
    slam.flush()
    wall = time.perf_counter() - t0
    if not est:
        tr = slam.trackers["SLAM"]
        n = int(tr.traj.size)
        est = list(pose_np(tr.traj.Tcw[:n]))
        ts = list(pose_np(tr.traj.t[:n]))

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    slam.save_map(os.path.join(args.out, "map.npz"))
    frac = len(est) / max(n_fed, 1)
    print(f"{len(est)} tracked in {wall:.1f}s -> {n_fed / wall:.2f} fps "
          f"({100.0 * frac:.1f}% tracked)")
    report = {"dataset": "tum", "mode": args.mode, "rgbd": bool(args.rgbd),
              "frames_fed": n_fed, "frames_tracked": len(est), "tracked_fraction": frac,
              "fps": n_fed / wall, "wall_s": wall, "synthetic": args.synthetic,
              **device_record(dev)}
    if ds.gt is not None and len(est) > 1:
        gts = [gt_Tcw(ds.gt, t) for t in ts]
        align = "se3" if args.rgbd else "sim3"    # a monocular map's scale is free
        a = ate_rmse(np.stack(est), np.stack(gts), align=align)
        print(f"ATE RMSE ({align}-aligned): {a:.4f} m")
        report.update(ate_rmse_m=float(a), align=align)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.json)
    slam.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
