#!/usr/bin/env python3
"""Drive the PyTorch port's stereo front end and tracker on one CUDA card.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It exits non-zero, printing no result, where CUDA is not available. Phases:

0. The card: its name and power limit, and the build of the port's CUDA
   kernels from ``hyslam_tpu_torch/csrc`` with nvcc for sm_90a.
1. Kernel K1 (the whole pose-only LM schedule, ``csrc/pose_opt.cu``)
   against its plain PyTorch version on the card, at N = 1024 observations,
   on the three problems of tests/test_pose_opt_pallas.py (stereo, 25%
   outliers, mono) with that file's bounds; then timed with CUDA events,
   100 calls a run: the kernel's wrapper alone, the solver entry point that
   calls it, and the plain version. Beyond that file's bounds the kernel's
   pose must lie within 1e-4 of the plain one, entry by entry, with at most
   one inlier of difference.
2. The slice at the reference's SLAM-camera operating point: a rendered
   1280x720 stereo sequence of 30 frames (4000 points, fx 700, bf 84, 0.08 m
   forward per frame), ORB with 1000 features over 8 levels, capacity 1024,
   a 4096-row local map seeded from frame 0's stereo features. Every later
   frame is tracked by ``slam.frontend.track_stereo_frame`` from the
   previous pose, and must keep >= 150 inliers within 0.5 deg of the
   rendered truth, and within 0.05 m (frames 1-3) or 0.08 m (every frame);
   K1 must launch once per tracked frame; three frames re-solved with the
   plain solver must agree with the kernel's poses to 1e-3 entry by entry.
   Then the time of each stage, synchronised.
3. torch.profiler over 5 tracked frames of the slice. Device time is summed
   over the device's own rows (kernels, copies, sets), never over the
   operator rows that enclose them, and the device's busy share is the
   union of those rows over the frames' wall time.
4. The tracker at the system benchmark's operating point: the same rendered
   sequence, 60 frames 0.05 s apart (phase 2 takes its first 30), each
   through extraction, stereo matching and ``slam.tracker.Tracker.track``
   with MapCaps(K=64, L=16384, F=1024, O=8) and the default policy and
   parameters: INITIALIZE -> POSTINIT -> NORMAL with the mapper
   (triangulation, fusion, local BA, keyframe culling) on every keyframe.
   Gates: every frame tracked and the tracker ends in NORMAL; ATE and the
   worst frame against the rendered truth under bounds set from readings;
   at least 5 keyframes, new triangulated landmarks, local BA with a finite
   cost on every integrated keyframe after the 3rd, a map renewed by the
   keyframes (more of its live landmarks from them than from
   initialization) that keeps at least 3/4 of what initialization seeded;
   K1 launched exactly 2 times a
   POSTINIT/NORMAL frame plus once more where the motion model failed; the
   local-map pose problems of 3 NORMAL frames re-solved by the plain solver
   on the card within max|dT| 1e-3 and one inlier of the kernel. Then the
   median ms per frame with and without a keyframe, per mapper call, and
   the peak device memory.

Prints the card line, one JSON line of kernel results, and last
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H, W = 720, 1280
FX, BF = 700.0, 84.0          # bench.py's SLAM camera: fx = fy, bf = baseline * fx
N_FRAMES = 30                 # phase 2
N_TRACK = 60                  # phase 4; phase 2 takes the first N_FRAMES
FRAME_DT = 0.05               # s between frames
TRACK_CAPS = (64, 16384, 1024, 8)   # MapCaps K, L, F, O of bench.py
CAPACITY = 1024
N_LANDMARKS = 4096
N_POINTS = 4000
N_TIMED = 100
# per-frame pose bounds against the rendered truth. The map is seeded from
# frame 0 only, so the error grows as the camera moves away from it: frames
# 1-3 are held to 0.05 m, every frame to 0.08 m; at this size the port's
# worst frame is at 0.0514 m (PERF.md).
MIN_INLIERS = 150
MAX_ROT_DEG = 0.5
MAX_T_EARLY, N_EARLY = 0.05, 3
MAX_T = 0.08
# agreement of kernel and plain solver: the bounds of
# tests/test_pose_opt_pallas.py, and then the largest entry-wise pose
# difference and inlier difference, set from the card's readings (PERF.md):
# max|dT| 2.1e-7 and equal counts in phase 1, d_t 3.2e-5 m in phase 2
MAX_D_ROT, MAX_D_T, MAX_D_INLIERS = 0.05, 0.01, 10
MAX_ABS_DT_PROBLEM, MAX_D_INLIERS_PROBLEM = 1e-4, 1
MAX_ABS_DT_SLICE = 1e-3
# phase 4: the tracker against the rendered truth, and what the mapper must
# have done. Readings (PERF.md): ATE 0.0237 m, worst frame 0.0617 m, 785 live
# landmarks of 854 seeded at the end. The ATE bound is 1.5x its reading; the
# per-frame bound stays phase 2's 0.08 m, under 1.5x the worst frame.
MAX_T_TRACK, MAX_ATE = 0.08, 0.035
MIN_KEYFRAMES = 5
MIN_LIVE_OF_SEEDED = 0.75     # live landmarks at the end / seeded at init
N_COMPARE = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean ms per call of fn over n calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase0():
    from hyslam_tpu_torch import kernels

    t0 = time.perf_counter()
    lib_path = kernels.build()
    kernels.load()
    log(f"phase 0: built {lib_path.relative_to(kernels.BUILD_ROOT.parent.parent)} "
        f"in {time.perf_counter() - t0:.2f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"  ptxas: {line.strip()}")


def pose_problem(seed: int, outlier_frac: float, stereo_frac: float, n: int):
    """tests/test_pose_opt_pallas.py:problem, in numpy, at n observations."""
    from hyslam_tpu_torch.geometry.camera import Camera
    from hyslam_tpu_torch.utils import synth

    cam = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640,
                 height=480, bf=45.0)      # tests/helpers.py DEFAULT_CAM
    rng = np.random.default_rng(seed)
    pts = synth.make_world(rng, n)
    T_true = synth.make_trajectory(3)[2]
    uv, ur, vis, stereo = synth.observe(cam, T_true, pts, noise=0.3, rng=rng,
                                        stereo_frac=stereo_frac)
    n_out = int(outlier_frac * n)
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(30, 120, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    T0 = synth.perturb_pose(rng, T_true, rot=0.03, trans=0.15)
    args = (T0, pts, uv, ur, np.ones(n, np.float32), vis, stereo & vis)
    return cam, T_true, args


def phase1(dev):
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.solver.pose_opt import pose_optimization, pose_optimization_fast
    from hyslam_tpu_torch.utils.synth import pose_error

    cases = {  # outlier_frac, stereo_frac, rot bound (deg), t bound vs truth
        "stereo": (0.0, 1.0, 0.1, 0.01),
        "outliers": (0.25, 1.0, 0.2, 0.02),
        "mono": (0.0, 0.0, 0.2, 0.05),
    }
    max_abs_err = 0.0
    timed = None
    for i, (name, (out_frac, st_frac, rot_b, t_b)) in enumerate(cases.items()):
        cam, T_true, args = pose_problem(i, out_frac, st_frac, CAPACITY)
        targs = [torch.from_numpy(np.array(a)).to(dev) for a in args]
        k = pose_optimization_fast(cam, *targs)
        p = pose_optimization(cam, *targs)
        Tk, Tp = k.Tcw.cpu().numpy(), p.Tcw.cpu().numpy()
        if not (np.isfinite(Tk).all() and Tk.shape == (4, 4)):
            raise AssertionError(f"phase 1 {name}: kernel pose not finite: {Tk}")
        rot, t = pose_error(Tk, T_true)
        d_rot, d_t = pose_error(Tk, Tp)
        d_inl = abs(int(k.num_inliers) - int(p.num_inliers))
        err = float(np.abs(Tk - Tp).max())
        max_abs_err = max(max_abs_err, err)
        log(f"phase 1 {name}: truth rot {rot:.5f} deg t {t:.6f} | vs plain "
            f"d_rot {d_rot:.6f} d_t {d_t:.7f} inliers {int(k.num_inliers)} vs "
            f"{int(p.num_inliers)} max|dT| {err:.3e}")
        if not (rot < rot_b and t < t_b):
            raise AssertionError(f"phase 1 {name}: kernel off the truth ({rot}, {t})")
        if not (d_rot < MAX_D_ROT and d_t < MAX_D_T and d_inl <= MAX_D_INLIERS
                and err < MAX_ABS_DT_PROBLEM and d_inl <= MAX_D_INLIERS_PROBLEM):
            raise AssertionError(f"phase 1 {name}: kernel and plain disagree "
                                 f"(d_rot {d_rot}, d_t {d_t}, max|dT| {err}, "
                                 f"inliers {d_inl} apart)")
        if name == "stereo":
            timed = (cam, targs)

    # kernel: the wrapper alone, on inputs already in its layout; fast: the
    # solver entry point (layout conversion + kernel + final chi2), whose
    # outputs are the plain version's
    cam, targs = timed
    kargs = [x.to(torch.float32)[None].contiguous() for x in targs]
    fns = {
        "plain": lambda: pose_optimization(cam, *targs),
        "kernel": lambda: pose_optimization_cuda(cam, *kargs),
        "fast": lambda: pose_optimization_fast(cam, *targs),
    }
    for fn in fns.values():                             # warm all three
        for _ in range(3):
            fn()
    torch.cuda.synchronize()
    runs = {k: [] for k in fns}
    for which in ("plain", "kernel", "fast", "fast", "kernel", "plain"):
        runs[which].append(cuda_ms(fns[which], N_TIMED))
    log(f"phase 1 timing, N={CAPACITY}, {N_TIMED} calls per run, ms/call: "
        + ", ".join(f"{k} {v}" for k, v in runs.items()))
    return max_abs_err, statistics.mean(runs["kernel"]), statistics.mean(runs["plain"])


def profile_frames(track, poses, dev, frame_ms: float, n: int = 5) -> None:
    """torch.profiler over n tracked frames. Only the device's own rows are
    counted (kernels, copies, sets): an operator row's device time is the
    sum of the kernels it encloses, so adding both counts them twice."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for i in range(1, n + 1):
            track(i, torch.from_numpy(poses[i - 1]).to(dev))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    rows = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not rows:
        raise AssertionError("phase 3: the profiler saw no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in rows)
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:                      # union of the device rows
        if a > hi:
            busy_us, lo, hi = busy_us + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy_us += hi - lo
    device_ms = sum(e.time_range.elapsed_us() for e in rows) / 1e3
    by_name: dict = {}
    for e in rows:
        c, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, us + e.time_range.elapsed_us())
    log("phase 3 profile: " + json.dumps({
        "frames": n,
        "device_rows_per_frame": len(rows) / n,
        "device_ms_per_frame": device_ms / n,
        "busy_union_ms_per_frame": busy_us / 1e3 / n,
        "profiled_wall_ms_per_frame": wall_ms / n,
        "busy_share_profiled": busy_us / 1e3 / wall_ms,
        "unprofiled_median_ms_per_frame": frame_ms,
        "busy_share_of_unprofiled_frame": device_ms / n / frame_ms,
    }))
    for name, (c, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]:
        log(f"  {us / 1e3 / n:8.3f} ms/frame {c // n:5d} rows/frame  {name[:90]}")


def camera_and_config():
    """The reference's SLAM camera (bench.py) and its ORB settings."""
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.geometry.camera import Camera

    cam = Camera(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W, height=H, bf=BF,
                 th_depth=35.0)
    return cam, ExtractorConfig(n_features=1000, n_levels=8)


def render_sequence(cam, dev, n: int):
    """n stereo pairs of a world of N_POINTS points from default_rng(0), the
    camera moving 0.08 m forward with 0.002 rad of yaw per frame. Returns
    (poses [n] numpy, pairs [n,2,H,W] on dev)."""
    from hyslam_tpu_torch.utils import synth

    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-14, 14, N_POINTS), rng.uniform(-9, 9, N_POINTS),
                    rng.uniform(3, 45, N_POINTS)], -1).astype(np.float32)
    delta = synth.se3_exp([0.0, 0.002, 0.0, 0.0, 0.0, -0.08])
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(n - 1):
        poses.append((delta @ poses[-1]).astype(np.float32))
    t0 = time.perf_counter()
    pairs = torch.from_numpy(np.stack(
        [synth.render_stereo_pair(cam, T, pts) for T in poses])).to(dev)
    log(f"rendered {n} stereo pairs {W}x{H} in {time.perf_counter() - t0:.1f} s")
    return poses, pairs


def phase2(dev, cam, cfg, poses, pairs):
    from hyslam_tpu_torch import interop
    from hyslam_tpu_torch.features.atlas import extract_atlas_batch
    from hyslam_tpu_torch.core.frame import feature_inv_sigma2
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam.frontend import (
        match_stereo_pair, pose_problem, track_stereo_frame)
    from hyslam_tpu_torch.solver.pose_opt import pose_optimization, pose_optimization_fast
    from hyslam_tpu_torch.utils import synth

    poses, pairs = poses[:N_FRAMES], pairs[:N_FRAMES]

    # seed the local map from frame 0's stereo features
    f0 = match_stereo_pair(cam, extract_atlas_batch(pairs[0], cfg, CAPACITY), pairs[0])
    fn = interop.features_to_numpy(f0)
    table = interop.landmarks_from_numpy(**synth.seed_landmarks(
        cam, poses[0], fn["uv"], fn["depth"], fn["level"], fn["desc"],
        fn["valid"], N_LANDMARKS), device=dev)
    n_seeded = int(table.lm_valid.sum())
    log(f"phase 2: frame 0 has {int(fn['valid'].sum())} features, "
        f"{int((fn['depth'] > 0).sum())} with stereo depth -> {n_seeded} "
        f"landmarks in a {N_LANDMARKS}-row map")
    if n_seeded < 300:
        raise AssertionError(f"phase 2: only {n_seeded} landmarks seeded")

    def track(i, T_prev):
        return track_stereo_frame(cam, cfg, CAPACITY, pairs[i], T_prev, *table)

    def pose_problem_of(fl, T_in):
        """The solver arguments track_stereo_frame builds for a frame."""
        inv_s2 = feature_inv_sigma2(fl.level, cfg.n_levels, cfg.scale_factor)
        return pose_problem(cam, fl, T_in, *table, inv_s2, n_levels=cfg.n_levels,
                            scale_factor=cfg.scale_factor)[1]

    for i in (1, 2):                                    # warm-up, not counted
        track(i, torch.from_numpy(poses[i - 1]).to(dev))
    torch.cuda.synchronize()

    # the main path: counts to 0, track every frame, read the counts
    pose_optimization_cuda.launches = 0
    T_prev = torch.eye(4, device=dev)
    results, inputs, frame_ms = [], [], []
    for i in range(1, N_FRAMES):
        t = time.perf_counter()
        res, fl = track(i, T_prev)
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t))
        if i <= 3:
            inputs.append((i, T_prev, fl, res))
        results.append(res)
        T_prev = res.Tcw
    launches = pose_optimization_cuda.launches
    n_tracked = N_FRAMES - 1
    log(f"phase 2: K1 launches {launches} for {n_tracked} tracked frames")
    log(f"phase 2: slice ms/frame (synchronised, {n_tracked} frames): median "
        f"{statistics.median(frame_ms):.3f} mean {statistics.mean(frame_ms):.3f} "
        f"min {min(frame_ms):.3f} max {max(frame_ms):.3f}")
    if launches != n_tracked:
        raise AssertionError(f"phase 2: {launches} K1 launches for {n_tracked} frames")

    worst = (np.inf, 0.0, 0.0)
    for i, res in enumerate(results, start=1):
        Tcw = res.Tcw.cpu().numpy()
        n_inl = int(res.n_inliers)
        if Tcw.shape != (4, 4) or not np.isfinite(Tcw).all():
            raise AssertionError(f"frame {i}: pose not finite: {Tcw}")
        rot, t = synth.pose_error(Tcw, poses[i])
        log(f"  frame {i}: matches {int(res.n_matches)} inliers {n_inl} "
            f"rot {rot:.5f} deg t {t:.6f} m")
        worst = (min(worst[0], n_inl), max(worst[1], rot), max(worst[2], t))
        max_t = MAX_T_EARLY if i <= N_EARLY else MAX_T
        if n_inl < MIN_INLIERS or rot >= MAX_ROT_DEG or t >= max_t:
            raise AssertionError(
                f"frame {i}: {n_inl} inliers ({int(res.n_matches)} matches), "
                f"rot {rot:.4f} deg, t {t:.4f} m")
    log(f"phase 2: {n_tracked} frames tracked; fewest inliers {worst[0]}, "
        f"worst rot {worst[1]:.5f} deg, worst t {worst[2]:.6f} m")

    # the same frames' pose problems through the plain solver on the card
    for i, T_in, fl, res in inputs:
        p = pose_optimization(*pose_problem_of(fl, T_in))
        d_rot, d_t = synth.pose_error(res.Tcw.cpu().numpy(), p.Tcw.cpu().numpy())
        d_inl = abs(int(res.n_inliers) - int(p.num_inliers))
        err = float((res.Tcw - p.Tcw).abs().max())
        log(f"phase 2 frame {i}: kernel vs plain d_rot {d_rot:.6f} d_t {d_t:.7f} "
            f"max|dT| {err:.3e} inliers {int(res.n_inliers)} vs {int(p.num_inliers)}")
        if not (d_rot < MAX_D_ROT and d_t < MAX_D_T and d_inl <= MAX_D_INLIERS
                and err < MAX_ABS_DT_SLICE):
            raise AssertionError(f"phase 2 frame {i}: kernel and plain disagree "
                                 f"(d_rot {d_rot}, d_t {d_t}, max|dT| {err}, "
                                 f"inliers {d_inl} apart)")

    # where a frame's time goes: each stage synchronised, frames 1-5
    stages = {"extract": [], "stereo": [], "match": [], "pose_opt": []}
    for i in range(1, 6):
        T_in = torch.from_numpy(poses[i - 1]).to(dev)
        t = time.perf_counter()
        f2 = extract_atlas_batch(pairs[i], cfg, CAPACITY)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fl = match_stereo_pair(cam, f2, pairs[i])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        problem = pose_problem_of(fl, T_in)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        pose_optimization_fast(*problem)
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for k, a, b in (("extract", t, t1), ("stereo", t1, t2), ("match", t2, t3),
                        ("pose_opt", t3, t4)):
            stages[k].append(1e3 * (b - a))
    log("phase 2 stage ms (median of frames 1-5, synchronised): "
        + json.dumps({k: round(statistics.median(v), 3) for k, v in stages.items()}))
    profile_frames(track, poses, dev, statistics.median(frame_ms))
    return launches


def phase4(dev, cam, cfg, poses, pairs):
    """The tracker on the whole sequence; see the module docstring."""
    from hyslam_tpu_torch.core.mapstate import MapCaps, n_live_landmarks
    from hyslam_tpu_torch.features.atlas import extract_atlas_batch
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam.frontend import match_stereo_pair
    from hyslam_tpu_torch.slam.tracker import State, Tracker
    from hyslam_tpu_torch.solver.pose_opt import pose_optimization
    from hyslam_tpu_torch.utils import synth

    tracker = Tracker(cam=cam, caps=MapCaps(*TRACK_CAPS), device=dev)
    mapper_ms = []
    integrate = tracker.mapper.integrate_keyframe

    def timed_integrate(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = integrate(*args, **kwargs)
        torch.cuda.synchronize()
        mapper_ms.append(1e3 * (time.perf_counter() - t))
        return out

    tracker.mapper.integrate_keyframe = timed_integrate
    n = len(poses)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path: counts to 0, track every frame, read the counts
    pose_optimization_cuda.launches = 0
    frame_ms, compare = [], []
    for i in range(n):
        t = time.perf_counter()
        fl = match_stereo_pair(cam, extract_atlas_batch(pairs[i], cfg, CAPACITY), pairs[i])
        tel = tracker.track(fl, FRAME_DT * i, i)
        torch.cuda.synchronize()
        frame_ms.append((1e3 * (time.perf_counter() - t), tel.kf_inserted >= 0))
        if tel.state == "NORMAL" and len(compare) < N_COMPARE:
            compare.append((i, tracker.last_result, tel.n_inliers))
    launches = pose_optimization_cuda.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    tels = tracker.telemetry
    n_min = tracker.params.motion.n_min_matches
    expected = sum(2 + (t.n_motion < n_min) for t in tels
                   if t.state in ("POSTINIT", "NORMAL"))
    est = tracker.traj.Tcw[:n].cpu().numpy()
    errs = []
    for i, t in enumerate(tels):
        rot, tr = synth.pose_error(est[i], poses[i])
        errs.append(tr)
        log(f"  frame {i}: {t.state} motion {t.n_motion} inliers {t.n_inliers} "
            f"local {t.n_local} kf {t.kf_inserted} seeded {t.n_seeded} "
            f"rot {rot:.5f} deg t {tr:.6f} m {t.mapper_stats or ''}")
    ate = float(np.sqrt(np.mean(np.square(errs))))
    worst = int(np.argmax(errs))
    kf_stats = [t.mapper_stats for t in tels if t.mapper_stats]
    n_kf = sum(t.kf_inserted >= 0 for t in tels)
    n_tri = sum(s.get("triangulated", 0) for s in kf_stats)
    live = int(n_live_landmarks(tracker.ms))
    lm = tracker.ms.lm
    live_init = int((lm.valid & ~lm.bad & (lm.first_kf == 0)).sum())
    med = {kf: statistics.median(ms) if (ms := [m for m, k in frame_ms if k == kf]) else None
           for kf in (False, True)}
    log(f"phase 4: {n} frames, ATE {ate:.6f} m, worst frame {worst} at {errs[worst]:.6f} m; "
        f"{n_kf} keyframes, {n_tri} landmarks triangulated, {live} live landmarks, "
        f"{live_init} of them from initialization (which seeded {tels[0].n_seeded}); "
        f"K1 launches {launches}, expected {expected}")
    log("phase 4 timing: " + json.dumps({
        "median_ms_frame_without_keyframe": med[False],
        "median_ms_frame_with_keyframe": med[True],
        "median_ms_integrate_keyframe": statistics.median(mapper_ms),
        "mapper_calls": len(mapper_ms),
        "peak_device_mb": peak_mb,
    }))

    # the tracker's own local-map pose problems through the plain solver
    compared = []
    for i, nf, n_inl in compare:
        p = pose_optimization(*nf.problem)
        err = float((nf.Tcw - p.Tcw).abs().max())
        compared.append((i, err, abs(n_inl - int(p.num_inliers))))
        log(f"phase 4 frame {i}: kernel vs plain max|dT| {err:.3e} inliers "
            f"{n_inl} vs {int(p.num_inliers)}")

    gates = {
        "states INITIALIZE -> POSTINIT -> NORMAL, every frame tracked":
            tels[0].state == "INITIALIZE" and tels[1].state == "POSTINIT"
            and tracker.state == State.NORMAL and len(tels) == n,
        f"trajectory of {n} finite poses":
            int(tracker.traj.size) == n and bool(np.isfinite(est).all()),
        f"ATE < {MAX_ATE} m and every frame < {MAX_T_TRACK} m":
            ate < MAX_ATE and errs[worst] < MAX_T_TRACK,
        f">= {MIN_KEYFRAMES} keyframes and landmarks triangulated":
            n_kf >= MIN_KEYFRAMES and n_tri > 0,
        "the map renewed: more live landmarks from keyframes than from initialization":
            live - live_init > live_init,
        f"at least {MIN_LIVE_OF_SEEDED} as many live landmarks as initialization seeded":
            live >= MIN_LIVE_OF_SEEDED * tels[0].n_seeded,
        "local BA with a finite cost on every integrated keyframe after the 3rd":
            all(np.isfinite(st.get("ba_cost", float("nan"))) for st in kf_stats[3:]),
        f"K1 launches {launches} == 2 a tracked frame + motion-model failures {expected}":
            launches == expected,
        f"{len(compared)} NORMAL frames: kernel and plain solver within "
        f"{MAX_ABS_DT_SLICE} and {MAX_D_INLIERS_PROBLEM} inlier":
            len(compared) == N_COMPARE and all(
                e < MAX_ABS_DT_SLICE and d <= MAX_D_INLIERS_PROBLEM for _, e, d in compared),
    }
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise AssertionError("phase 4 failed: " + "; ".join(failed))
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 1
    import hyslam_tpu_torch  # noqa: F401  (pins float32 matmuls)

    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    phase0()
    max_abs_err, k_ms, p_ms = phase1(dev)
    cam, cfg = camera_and_config()
    poses, pairs = render_sequence(cam, dev, N_TRACK)
    launches = phase2(dev, cam, cfg, poses, pairs)
    launches += phase4(dev, cam, cfg, poses, pairs)
    log(json.dumps({"kernels": [{
        "name": "pose_opt",
        "route": "cuda",
        "source": "hyslam_tpu_torch/csrc/pose_opt.cu",
        "replaces": "hyslam_tpu/ops/pose_opt_pallas.py:331",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,                       # the one card this run drives
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
