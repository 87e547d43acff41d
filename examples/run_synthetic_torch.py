"""Self-contained demo of the port (the twin of examples/run_synthetic.py):
stereo SLAM on a rendered corridor, no dataset needed. Drives the whole
System (tracking, mapping, keyframes, exports, viz) and reports ATE against
the rendered truth. The JAX demo feeds synthetic features; this one renders
the stereo images in numpy (``hyslam_tpu_torch/utils/synth.py``) and
extracts them, so that it runs without the JAX package.

    python3 examples/run_synthetic_torch.py --frames 40 --out out_synth/ [--device cpu]
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
from hyslam_tpu_torch.geometry.camera import Camera  # noqa: E402
from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig  # noqa: E402
from hyslam_tpu_torch.io.evaluate import ate_rmse  # noqa: E402
from hyslam_tpu_torch.slam.system import System  # noqa: E402
from hyslam_tpu_torch.utils import synth  # noqa: E402

CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480, bf=45.0,
             th_depth=35.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default="out_synth")
    ap.add_argument("--viz", action="store_true")
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    pts = synth.make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
    traj_gt = synth.make_trajectory(n_frames=args.frames, step=0.12, yaw_rate=0.004)
    cfg = SystemConfig(caps=MapCaps(K=64, L=8192, F=1024, O=8),
                       run_data_dir=os.path.join(args.out, "run_data"), device=dev)
    cfg.cameras["SLAM"] = CameraConfig(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy,
                                       width=CAM.width, height=CAM.height, bf=CAM.bf)
    slam = System(cfg)
    viewer = None
    if args.viz:
        from hyslam_tpu_torch.viz import Viewer

        viewer = Viewer(out_dir=os.path.join(args.out, "viz"))

    est = []
    t0 = time.perf_counter()
    for i, T in enumerate(traj_gt):
        left, right = synth.render_stereo_pair(CAM, T, pts)
        tel = slam.track_stereo(left, right, timestamp=0.1 * i, frame_id=i)
        tr = slam.trackers["SLAM"]
        est.append(pose_np(tr.last_Tcw))
        if viewer is not None:
            viewer.update(tr.ms, current_Tcw=tr.last_Tcw)
        if i % 10 == 0:
            print(f"frame {i}: state={tel.state} inliers={tel.n_inliers}", flush=True)
    wall = time.perf_counter() - t0

    os.makedirs(args.out, exist_ok=True)
    slam.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    slam.export_colmap(args.out)
    slam.save_map(os.path.join(args.out, "map.npz"))
    if viewer is not None:
        viewer.snapshot("final")
    slam.shutdown()
    a = ate_rmse(np.stack(est), np.asarray(traj_gt[:len(est)]))
    print(json.dumps({"frames": len(est), "fps": len(est) / wall, "ate_rmse_m": float(a),
                      **device_record(dev)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
