"""Run the port's stereo SLAM on a KITTI odometry sequence and report ATE
and RPE (the twin of examples/run_kitti.py, on the card):

    python3 examples/run_kitti_torch.py /data/kitti/odometry --sequence 00 \
        --frames 500 --out out_kitti/ [--json soak.json] [--synthetic]

Writes the trajectory (TUM format), the COLMAP export and the map, and
prints ATE RMSE / RPE against the ground-truth poses where there are any.
``--json`` writes the soak artifact: the JAX driver's keys, plus
``synthetic`` (``--synthetic``: the sequence is rendered, e.g. by
tools/make_synthetic_dataset_torch.py) and the device's name.
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
from hyslam_tpu_torch.io.datasets import KittiOdometry  # noqa: E402
from hyslam_tpu_torch.io.evaluate import ate_rmse, rpe  # noqa: E402
from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams  # noqa: E402
from hyslam_tpu_torch.slam.mapper import MapperParams  # noqa: E402
from hyslam_tpu_torch.slam.system import System  # noqa: E402

CAPS = MapCaps(K=512, L=32768, F=1024, O=8)


def main(argv=None, caps: MapCaps = CAPS, on_frame=None):
    """Run the driver on ``argv``; ``caps`` sizes the map's arenas and
    ``on_frame(system)``, when given, is called after every fed frame."""
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="KITTI odometry root (contains sequences/)")
    ap.add_argument("--sequence", default="00")
    ap.add_argument("--frames", type=int, default=0, help="0 = all")
    ap.add_argument("--out", default="out_kitti")
    ap.add_argument("--viz", action="store_true", help="write map snapshots")
    ap.add_argument("--mode", choices=["async", "pipelined", "sync"], default="async",
                    help="async: decisions committed commit_lag frames later; "
                         "pipelined: the reference's tracking and mapping threads; "
                         "sync: one frame at a time")
    ap.add_argument("--no-loop", action="store_true", help="loop closing off")
    ap.add_argument("--json", default=None, help="write the soak artifact here")
    ap.add_argument("--synthetic", action="store_true",
                    help="the sequence is rendered: recorded in the artifact")
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    ds = KittiOdometry(args.root, args.sequence)
    c = ds.calib
    cfg = SystemConfig(
        caps=caps,
        run_data_dir=os.path.join(args.out, "run_data"),
        pipelined=args.mode == "pipelined", async_tracking=args.mode == "async",
        enable_loop_closing=not args.no_loop, device=dev,
        # long sequences through fixed arenas: recycle the rows of landmarks
        # that lost every observation orphan_age keyframes ago
        mapper=MapperParams(orphan_age=6))
    cfg.cameras["SLAM"] = CameraConfig(
        fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height, bf=c.bf,
        th_depth=c.bf / c.fx * 40.0,
        # KITTI-scale scenes keep ~70-250 inliers: the JAX driver's 120/25
        policy=KeyFramePolicyParams(n_tracked_target=120, n_tracked_variance=25,
                                    max_kf_interval=15))
    slam = System(cfg)
    viewer = None
    if args.viz:
        from hyslam_tpu_torch.viz import Viewer

        viewer = Viewer(out_dir=os.path.join(args.out, "viz"))

    stop = args.frames or None
    est, gt, gt_times, times = [], [], [], []
    t0 = time.perf_counter()
    for fr in ds.frames(stop=stop):
        tel = slam.track_stereo(fr.img_left, fr.img_right, fr.timestamp)
        if on_frame is not None:
            on_frame(slam)
        times.append(fr.timestamp)
        if fr.gt_Tcw is not None:
            gt.append(fr.gt_Tcw)
            gt_times.append(fr.timestamp)
        if tel is None or args.mode == "async":
            # async / pipelined: poses come from the trajectory at the end
            if len(times) % 100 == 0:
                print(f"fed {len(times)} frames ({time.perf_counter() - t0:.0f}s)",
                      flush=True)
            continue
        tr = slam.trackers["SLAM"]
        est.append(pose_np(tr.last_Tcw))
        if viewer is not None:
            viewer.update(tr.ms, current_Tcw=tr.last_Tcw)
        if tel.frame_id % 50 == 0:
            print(f"frame {tel.frame_id}: state={tel.state} inliers={tel.n_inliers}",
                  flush=True)
    slam.flush()
    wall = time.perf_counter() - t0
    tr = slam.trackers["SLAM"]
    if not est:
        n = int(tr.traj.size)
        est = list(pose_np(tr.traj.Tcw[:n]))
        if viewer is not None:
            viewer.update(tr.ms, current_Tcw=tr.last_Tcw)

    os.makedirs(args.out, exist_ok=True)
    if args.mode == "async":
        # the async loop writes no TSV logs: the committed rows go here
        with open(os.path.join(args.out, "tracking_async.txt"), "w") as f:
            f.write("frame_id\tstate\tn_motion\tn_inliers\tn_local\tkf\n")
            for t in tr.telemetry:
                f.write(f"{t.frame_id}\t{t.state}\t{t.n_motion}\t{t.n_inliers}\t"
                        f"{t.n_local}\t{t.kf_inserted}\n")
    slam.save_trajectory_tum(os.path.join(args.out, "trajectory_tum.txt"))
    slam.export_colmap(args.out)
    slam.save_map(os.path.join(args.out, "map.npz"))
    if viewer is not None:
        viewer.snapshot("final")

    n, n_fed = len(est), len(times)
    frac = n / max(n_fed, 1)
    print(f"{n_fed} frames in {wall:.1f}s -> {n_fed / wall:.2f} fps "
          f"({n} tracked, {100.0 * frac:.1f}%)")
    report = {"dataset": "kitti", "sequence": args.sequence, "mode": args.mode,
              "frames_fed": n_fed, "frames_tracked": n, "tracked_fraction": frac,
              "fps": n_fed / wall, "wall_s": wall, "synthetic": args.synthetic,
              **device_record(dev)}
    if gt and n > 1:
        if len(gt) != n:
            # pair trajectory rows with ground truth by timestamp, the nearer
            # of the two bracketing ones
            tss = pose_np(tr.traj.t[:n])
            gts = np.asarray(gt_times)
            idx = np.clip(np.searchsorted(gts, tss), 0, len(gt) - 1)
            lo = np.clip(idx - 1, 0, len(gt) - 1)
            idx = np.where(np.abs(gts[lo] - tss) < np.abs(gts[idx] - tss), lo, idx)
            gt = [gt[i] for i in idx]
        a = ate_rmse(np.stack(est), np.stack(gt))
        r_t, r_r = rpe(np.stack(est), np.stack(gt))
        print(f"ATE RMSE: {a:.3f} m | RPE: {r_t:.4f} m/frame, {r_r:.4f} deg/frame")
        report.update(ate_rmse_m=float(a), rpe_trans_m=float(r_t), rpe_rot_deg=float(r_r))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.json)
    slam.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
