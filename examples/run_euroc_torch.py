"""Run the port's stereo SLAM on a EuRoC MAV sequence and report ATE and
RPE (the twin of examples/run_euroc.py, on the card):

    python3 examples/run_euroc_torch.py /data/euroc/MH_01_easy --frames 500 \
        --out out_euroc/ [--device cpu]

Assumes rectified images (the reference's camera model has no distortion,
Camera.h:4-52): rectify raw EuRoC data first. Reading the sensor files
needs ``yaml``.
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
from hyslam_tpu_torch.io.datasets import EurocMav  # noqa: E402
from hyslam_tpu_torch.io.evaluate import ate_rmse, rpe  # noqa: E402
from hyslam_tpu_torch.slam.system import System  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="EuRoC sequence root (contains mav0/)")
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--out", default="out_euroc")
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds = EurocMav(args.root)
    c = ds.calib
    cfg = SystemConfig(caps=MapCaps(K=512, L=32768, F=2048, O=16),
                       run_data_dir=os.path.join(args.out, "run_data"), device=dev)
    cfg.cameras["SLAM"] = CameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width,
                                       height=c.height, bf=c.bf,
                                       th_depth=c.bf / c.fx * 40.0)
    slam = System(cfg)

    stop = args.frames or None
    est, gt = [], []
    t0 = time.perf_counter()
    for fr in ds.frames(stop=stop):
        tel = slam.track_stereo(fr.img_left, fr.img_right, fr.timestamp)
        est.append(pose_np(slam.trackers["SLAM"].last_Tcw))
        if fr.gt_Tcw is not None:
            gt.append(fr.gt_Tcw)
        if tel.frame_id % 50 == 0:
            print(f"frame {tel.frame_id}: state={tel.state} inliers={tel.n_inliers}",
                  flush=True)
    wall = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    slam.save_map(os.path.join(args.out, "map.npz"))
    slam.shutdown()
    n = len(est)
    report = {"frames": n, "fps": n / wall, **device_record(dev)}
    if len(gt) == n and n > 1:
        a = ate_rmse(np.stack(est), np.stack(gt))
        r_t, r_r = rpe(np.stack(est), np.stack(gt))
        report.update(ate_rmse_m=float(a), rpe_trans_m=float(r_t), rpe_rot_deg=float(r_r))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
