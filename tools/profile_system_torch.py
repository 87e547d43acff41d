"""Where a tracked frame of the port's System spends its time, on the card
(the twin of tools/profile_system.py, built on ``torch.profiler``).

At bench.py's operating point (1280x720 stereo, ORB 1000 x 8,
MapCaps(K=64, L=16384, F=1024, O=8), loop closing off), rendered frames
go through ``System.track_stereo``. Reported:
- the host's wall time of each stage a frame calls (preprocess,
  extraction, stereo matching, the NORMAL tracking step, keyframe
  insertion and the mapper's integration, the trajectory append), each
  stage wrapped in a ``record_function`` range;
- from ``torch.profiler`` over the steady frames: the kernel launches a
  frame (host ``cudaLaunchKernel`` calls) and the device rows a frame
  (kernels, copies and sets), the device's busy time a frame (the union of
  its rows) and its busy share of the frames' wall time, and the launches
  inside each stage's range.

    python3 tools/profile_system_torch.py [--frames 40] [--profiled 10] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

W, H = 1280, 720


def _busy_us(rows) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in rows)
    if not spans:
        return 0.0
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    return busy + hi - lo


def main(argv=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from hyslam_tpu_torch.core import trajectory as TJ
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.device import default_device
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.geometry.camera import Camera
    from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
    from hyslam_tpu_torch.slam import system as SYSMOD
    from hyslam_tpu_torch.slam import tracker as TRKMOD
    from hyslam_tpu_torch.slam.system import System
    from hyslam_tpu_torch.utils import synth
    from tools.bench_multihost_torch import card

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--profiled", type=int, default=10,
                    help="the last frames, traced by torch.profiler")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    dev = default_device()
    cam = Camera(fx=700.0, fy=700.0, cx=W / 2, cy=H / 2, width=W, height=H, bf=84.0,
                 th_depth=35.0)
    cc = CameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=W, height=H,
                      bf=cam.bf, extractor=ExtractorConfig(n_features=1000, n_levels=8))
    sysm = System(SystemConfig(cameras={"SLAM": cc}, caps=MapCaps(K=64, L=16384, F=1024, O=8),
                               enable_loop_closing=False, device=dev))
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-14, 14, 4000), rng.uniform(-9, 9, 4000),
                    rng.uniform(3, 45, 4000)], -1).astype(np.float32)
    delta = synth.se3_exp([0.0, 0.002, 0.0, 0.0, 0.0, -0.08]).astype(np.float32)
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(args.frames - 1):
        poses.append((delta @ poses[-1]).astype(np.float32))
    print("rendering...", flush=True)
    pairs = torch.from_numpy(np.stack([synth.render_stereo_pair(cam, T, pts)
                                       for T in poses])).to(dev)

    stages = defaultdict(list)

    def wrap(orig, key):
        def run(*a, **kw):
            with record_function(f"stage:{key}"):
                t0 = time.perf_counter()
                out = orig(*a, **kw)
                stages[key].append(time.perf_counter() - t0)
            return out
        return run

    tk = sysm.trackers["SLAM"]
    SYSMOD.preprocess_image = wrap(SYSMOD.preprocess_image, "preprocess")
    SYSMOD.match_stereo_refined = wrap(SYSMOD.match_stereo_refined, "stereo_match")
    TRKMOD.track_normal_frame = wrap(TRKMOD.track_normal_frame, "track_normal_frame")
    TJ.append = wrap(TJ.append, "traj_append")
    fam = sysm._families["SLAM"]
    sysm._families["SLAM"] = fam._replace(extract_batch=wrap(fam.extract_batch, "extract"))
    for name in ("_do_normal", "_insert_keyframe"):
        setattr(tk, name, wrap(getattr(tk, name), name.lstrip("_")))
    tk.mapper.integrate_keyframe = wrap(tk.mapper.integrate_keyframe, "integrate_keyframe")

    print("tracking...", flush=True)
    n_plain = args.frames - args.profiled
    per_frame = []

    def feed(i):
        t0 = time.perf_counter()
        sysm.track_stereo(pairs[i, 0], pairs[i, 1], timestamp=0.05 * i, frame_id=i)
        torch.cuda.synchronize()
        per_frame.append(time.perf_counter() - t0)

    for i in range(n_plain):
        feed(i)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        for i in range(n_plain, args.frames):
            feed(i)
        wall_prof_us = 1e6 * (time.perf_counter() - t_prof)
    events = prof.events()
    # the device's own rows; a record_function range also puts a row on the
    # device (its annotation, spanning the range's kernels): not counted
    device_rows = [e for e in events if e.device_type == DeviceType.CUDA
                   and not e.name.startswith("stage:")]
    launches = [e for e in events if e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                                                "cudaLaunchKernelExC")]
    by_stage = {}
    for e in events:
        if e.name.startswith("stage:") and e.device_type == DeviceType.CPU:
            key = e.name[len("stage:"):]
            lo, hi = e.time_range.start, e.time_range.end
            n = sum(1 for x in launches if lo <= x.time_range.start <= hi)
            c = by_stage.setdefault(key, [0, 0])
            c[0] += 1
            c[1] += n
    n_prof = args.frames - n_plain
    steady = np.asarray(per_frame[min(10, n_plain):])
    report = {
        "card": card(), "frames": args.frames, "profiled_frames": n_prof,
        "frame_mean_ms": float(1e3 * steady.mean()),
        "frame_median_ms": float(1e3 * np.median(steady)),
        "fps": float(1.0 / steady.mean()),
        "launches_a_frame": len(launches) / n_prof,
        "device_rows_a_frame": len(device_rows) / n_prof,
        "device_busy_ms_a_frame": _busy_us(device_rows) / 1e3 / n_prof,
        "device_busy_share": _busy_us(device_rows) / wall_prof_us,
        "keyframes": sum(1 for t in tk.telemetry if t.kf_inserted >= 0),
        "stages": {},
    }
    print(f"\n{'stage':22s} {'calls':>6s} {'mean ms':>9s} {'total s':>9s} {'launches/call':>14s}")
    for k, v in sorted(stages.items(), key=lambda kv: -sum(kv[1])):
        v = np.asarray(v)
        vs = v[1:] if len(v) > 1 else v               # the first call warms up
        calls, nl = by_stage.get(k, (0, 0))
        row = {"calls": int(len(v)), "mean_ms": float(vs.mean() * 1e3),
               "total_s": float(v.sum()),
               "launches_a_call_profiled": nl / calls if calls else None}
        report["stages"][k] = row
        print(f"{k:22s} {len(v):6d} {row['mean_ms']:9.2f} {row['total_s']:9.2f} "
              f"{row['launches_a_call_profiled'] or 0:14.1f}")
    print(json.dumps({k: v for k, v in report.items() if k != "stages"}))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print("wrote", args.json)
    sysm.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
