"""Benchmark of the PyTorch port: the full SLAM system rate on one CUDA card
at the reference's SLAM-camera operating point (1280x720 stereo @ 1000 ORB
features, 8 pyramid levels x1.2 — config/sample_primary_config_file.yaml:27-41),
the twin of bench.py.

The headline metric is `system_fps`: frames/s of the full
``System.track_stereo`` path (image preprocessing, batched stereo ORB
extraction, stereo matching, the tracking state machine, keyframe insertion
and every mapper job) on a rendered sequence, in the async tracking loop
(``async_tracking=True, commit_lag=2``), with ``System.flush()`` (which
synchronises the card) before the clock stops. `frontend_fps` is the rate of
``slam.frontend.track_stereo_frame`` over a pose-chained loop (each step
starts from the previous step's pose, so no step can be skipped) ending in a
device-to-host read.

The reference publishes no fps (BASELINE.md); its real-time design rate is
60 fps, so vs_baseline = system_fps / 60.

    python3 bench_torch.py

Runs on the current CUDA card and raises where there is none. Earlier lines
give the card's name and power limit, the System run's keyframes, tracked
frames, ATE against the rendered truth and the pose kernel's launches; the
last line is one JSON object with bench.py's keys. Unlike bench.py it gates
on no best-known rate (those are a TPU's) and prints no line when a
measurement fails: the exception ends the script with a non-zero code.
"""

from __future__ import annotations

import json
import subprocess
import time
from typing import NamedTuple

import numpy as np

H, W = 720, 1280
FX, BF = 700.0, 84.0
N_POINTS = 4000
FRAME_DT = 0.05                # s between frames
N_LANDMARKS = 4096             # the front-end bench's local map
METRIC = "system_frames_per_second_1chip_1280x720_stereo_1000feat"
DESIGN_FPS = 60.0


def bench_camera():
    """The reference's SLAM camera as bench.py renders it."""
    from hyslam_tpu_torch.geometry.camera import Camera

    return Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, bf=BF,
                  th_depth=35.0)


def _render_sequence(n_total: int):
    """bench.py's sequence: a world of 4000 points from default_rng(0), the
    camera moving 0.08 m forward with 0.002 rad of yaw a frame. Returns
    (camera, stereo pairs [n,2,H,W] float32, true Tcw [n,4,4], the points)."""
    from hyslam_tpu_torch.utils import synth

    cam = bench_camera()
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-14, 14, N_POINTS), rng.uniform(-9, 9, N_POINTS),
                    rng.uniform(3, 45, N_POINTS)], -1).astype(np.float32)
    delta = synth.se3_exp([0.0, 0.002, 0.0, 0.0, 0.0, -0.08])
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n_total - 1):
        poses.append((delta @ poses[-1]).astype(np.float32))
    frames = np.stack([synth.render_stereo_pair(cam, T, pts) for T in poses])
    return cam, frames, np.stack(poses), pts


class SystemRun(NamedTuple):
    fps: float          # frames/s over the timed frames
    system: object      # the System after the run, flushed
    truth: np.ndarray   # [n,4,4] rendered Tcw of every frame fed


def bench_system_fps(n_warm: int = 24, n_timed: int = 60, device=None) -> SystemRun:
    """Frames/s of the full System.track_stereo path in the async tracking
    loop, every dispatched frame executed inside the timed window."""
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.device import resolve_device
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
    from hyslam_tpu_torch.slam.system import System

    dev = resolve_device(device)
    cam, frames, truth, _ = _render_sequence(n_warm + n_timed)
    cc = CameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                      height=cam.height, bf=cam.bf,
                      extractor=ExtractorConfig(n_features=1000, n_levels=8))
    sysm = System(SystemConfig(
        cameras={"SLAM": cc}, caps=MapCaps(K=64, L=16384, F=1024, O=8),
        enable_loop_closing=False, async_tracking=True, commit_lag=2, device=dev))
    for i in range(n_warm):
        sysm.track_stereo(*frames[i], timestamp=FRAME_DT * i, frame_id=i)
    sysm.flush()                       # the warm frames stay out of the clock
    t0 = time.perf_counter()
    for i in range(n_warm, n_warm + n_timed):
        sysm.track_stereo(*frames[i], timestamp=FRAME_DT * i, frame_id=i)
    sysm.flush()                       # every dispatched frame has executed
    return SystemRun(n_timed / (time.perf_counter() - t0), sysm, truth)


def frontend_inputs(dev):
    """bench.py's front-end inputs from default_rng(0): 4 noise stereo pairs
    [4,2,H,W] and a local map of N_LANDMARKS random landmarks, on dev."""
    import torch

    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 255, (4, 2, H, W)).astype(np.float32)
    lm_pos = np.stack([rng.uniform(-8, 8, N_LANDMARKS), rng.uniform(-5, 5, N_LANDMARKS),
                       rng.uniform(3, 30, N_LANDMARKS)], -1).astype(np.float32)
    lm_desc = rng.integers(0, 2**32, (N_LANDMARKS, 8), dtype=np.uint32)
    pos = torch.from_numpy(lm_pos).to(dev)
    dist = torch.linalg.norm(pos, dim=-1)
    return dict(imgs=torch.from_numpy(imgs).to(dev), lm_pos=pos, lm_normal=pos / dist[:, None],
                lm_desc=torch.from_numpy(lm_desc.view(np.int32)).to(dev),
                lm_max_dist=dist * 1.05, lm_min_dist=dist / 1.2**8,
                lm_valid=torch.ones(N_LANDMARKS, dtype=torch.bool, device=dev))


def bench_frontend_fps(n_timed: int = 60, device=None) -> float:
    """Frames/s of slam.frontend.track_stereo_frame (batched stereo
    extraction, stereo match, local-map projection, pose-only LM),
    pose-chained so every step must execute, ended by a device-to-host read."""
    import torch

    from hyslam_tpu_torch.device import resolve_device
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.slam.frontend import track_stereo_frame

    dev = resolve_device(device)
    cam = bench_camera()
    cfg = ExtractorConfig(n_features=1000)
    inp = frontend_inputs(dev)
    imgs = inp.pop("imgs")

    def frame_step(pair, Tcw0):
        res, _ = track_stereo_frame(cam, cfg, 1024, pair, Tcw0, th=3.0, **inp)
        return res.Tcw, res.n_inliers

    T = torch.eye(4, device=dev)
    for i in range(6):                               # warm
        T, n = frame_step(imgs[i % 4], T)
    int(n)
    T = torch.eye(4, device=dev)
    t0 = time.perf_counter()
    for i in range(n_timed):
        T, n = frame_step(imgs[i % 4], T)            # chained: no step skippable
    int(n)                                           # a real read ends the clock
    return n_timed / (time.perf_counter() - t0)


def trajectory_accuracy(system, truth: np.ndarray):
    """(trajectory poses, ATE over them in m) of the System's SLAM camera
    against the rendered truth, each pose paired with its frame by time."""
    from hyslam_tpu_torch.io.evaluate import ate_rmse

    tr = system.trackers["SLAM"]
    size = int(tr.traj.size)
    est = tr.traj.Tcw[:size].cpu().numpy()
    idx = np.rint(tr.traj.t[:size].cpu().numpy() / FRAME_DT).astype(int)
    ate = ate_rmse(est, truth[idx], align="none") if size else float("nan")
    return size, (ate if np.isfinite(est).all() else float("nan"))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def result_line(sys_fps: float, fe_fps: float) -> dict:
    """bench.py's JSON line."""
    return {
        "metric": METRIC,
        "value": round(sys_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(sys_fps / DESIGN_FPS, 3),
        "system_fps": round(sys_fps, 2),
        "system_vs_baseline": round(sys_fps / DESIGN_FPS, 3),
        "frontend_fps": round(fe_fps, 2),
    }


def main() -> int:
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda

    k1 = pose_optimization_cuda.launches
    run = bench_system_fps()
    k1_system = pose_optimization_cuda.launches - k1
    fe_fps = bench_frontend_fps()
    tr = run.system.trackers["SLAM"]
    size, ate = trajectory_accuracy(run.system, run.truth)
    print(card_line())
    print(f"system: {len(run.truth)} frames, {size} tracked, "
          f"{sum(t.kf_inserted >= 0 for t in tr.telemetry)} keyframes, "
          f"ATE {ate:.6f} m, K1 launches {k1_system}")
    print(json.dumps(result_line(run.fps, fe_fps)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
