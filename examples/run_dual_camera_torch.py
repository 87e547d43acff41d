"""Dual-camera demo of the port (the twin of examples/run_dual_camera.py):
a stereo SLAM camera localizes while a monocular Imaging camera on the rig
maps through its own map, which the trajectory-tied imaging bundle
adjustment finalizes before the COLMAP and Agisoft exports
(System::RunImagingBundleAdjustment, System.cc:224-265). The scene is
rendered in numpy by ``hyslam_tpu_torch/utils/synth.py``.

    python3 examples/run_dual_camera_torch.py --frames 90 --out out_dual/ [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from examples.torch_common import device_record  # noqa: E402
from hyslam_tpu_torch.core.mapstate import MapCaps  # noqa: E402
from hyslam_tpu_torch.device import resolve_device  # noqa: E402
from hyslam_tpu_torch.features.extractor import ExtractorConfig  # noqa: E402
from hyslam_tpu_torch.geometry.camera import Camera  # noqa: E402
from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig  # noqa: E402
from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams  # noqa: E402
from hyslam_tpu_torch.slam.system import System  # noqa: E402
from hyslam_tpu_torch.utils import synth  # noqa: E402

CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480, bf=45.0,
             th_depth=35.0)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--out", default="out_dual")
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cam, n = CAM, args.frames
    rng = np.random.default_rng(3)
    delta = synth.se3_exp([0.0, 0.004, 0.0, 0.0, 0.0, -0.18]).astype(np.float32)
    Ts = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        Ts.append((delta @ Ts[-1]).astype(np.float32))
    Ts = np.stack(Ts)
    centers = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in Ts])
    pts = np.concatenate([c + rng.uniform([-6, -4, 2], [6, 4, 18], size=(16, 3))
                          for c in centers[::2]]).astype(np.float32)
    Tcam = synth.se3_exp([0.0, 0.06, 0.02, 0.15, -0.1, 0.0]).astype(np.float32)

    ex = ExtractorConfig(n_features=400, n_levels=4)
    geo = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
               height=cam.height, extractor=ex)
    cfg = SystemConfig(
        cameras={
            "SLAM": CameraConfig(**geo, bf=cam.bf, policy=KeyFramePolicyParams(
                max_kf_interval=5, n_tracked_target=80, n_tracked_variance=20)),
            "Imaging": CameraConfig(**geo, mono=True, Tcam=Tcam.tolist(),
                                    policy=KeyFramePolicyParams(
                                        max_kf_interval=4, n_tracked_target=70,
                                        n_tracked_variance=20)),
        },
        caps=MapCaps(K=64, L=8192, F=512, O=8), device=dev)
    sysm = System(cfg)
    T_r = np.eye(4, dtype=np.float32)
    T_r[0, 3] = -cam.bf / cam.fx

    kept = 0
    t0 = time.perf_counter()
    for i in range(n):
        left, _, _ = synth.render_world(cam, Ts[i], pts)
        right, _, _ = synth.render_world(cam, (T_r @ Ts[i]).astype(np.float32), pts)
        sysm.track_stereo(left, right, timestamp=0.1 * i, frame_id=i)
        if i % 2 == 0:
            photo = synth.render_world(cam, (Tcam @ Ts[i]).astype(np.float32), pts)[0]
            sysm.track_monocular(photo, timestamp=0.1 * i, camera="Imaging", frame_id=i)
            keep, _ = sysm.place_imaging_frame(0.1 * i)
            kept += int(bool(keep))
    sysm.flush()
    wall = time.perf_counter() - t0
    print(f"{n} stereo + {(n + 1) // 2} imaging frames in {wall:.1f}s; placer kept {kept}")
    sysm.run_imaging_bundle_adjustment()

    os.makedirs(args.out, exist_ok=True)
    sysm.export_colmap(args.out)
    sysm.save_keyframes_agisoft(os.path.join(args.out, "imaging.xml"), camera="Imaging")
    sysm.save_trajectory(os.path.join(args.out, "slam_traj.tsv"))

    # the Imaging keyframes' centres against the rendered truth
    ms = sysm.trackers["Imaging"].ms
    sel = np.nonzero((ms.kf.valid & ~ms.kf.bad).cpu().numpy())[0]
    T = ms.kf.Tcw.cpu().numpy()[sel].astype(np.float64)
    est_c = -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    idx = np.clip(np.round(ms.kf.timestamp.cpu().numpy()[sel] / 0.1).astype(int), 0, n - 1)
    gt = np.stack([(Tcam @ Ts[i]).astype(np.float64) for i in idx])
    gt_c = -np.einsum("kji,kj->ki", gt[:, :3, :3], gt[:, :3, 3])
    ate = float(np.sqrt(np.mean(np.sum((est_c - gt_c) ** 2, -1))))
    print(json.dumps({"imaging_kf_ate_m": ate, "imaging_kfs": len(sel), "fps": n / wall,
                      **device_record(dev)}))
    sysm.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
