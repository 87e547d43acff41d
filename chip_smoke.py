#!/usr/bin/env python3
"""Drive the PyTorch port's stereo front end, tracker and System on one CUDA card,
through a loss of tracking, with sensor readings, with a monocular camera,
with periodic global BA, with loop closing, with a second (Imaging) camera,
with the SURF feature family and through the threaded pipeline.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

It exits non-zero, printing no result, where CUDA is not available. Phases:

0. The card: its name and power limit, and the build of the port's CUDA
   kernels from ``hyslam_tpu_torch/csrc`` with nvcc for sm_90a.
1. Kernel K1 (the whole pose-only LM schedule, ``csrc/pose_opt.cu``)
   against its plain PyTorch versions on the card, at N = 1024 observations
   and at N = 3072 (the Imaging camera's problems: rows past 1024 in shared
   memory; and N_ODD = 4093 on the outlier problem, all four chunks and the
   scalar load path), on the three problems of
   tests/test_pose_opt_pallas.py (stereo, 25%
   outliers, mono) with that file's bounds: against the two-pass solver
   ``pose_optimization`` and against ``pose_optimization_fused_schedule``,
   the plain form of the kernel's own one-pass schedule. Beyond that file's
   bounds the kernel's pose must lie within 1e-4 of each, entry by entry,
   with at most one inlier of difference; its chi2 output must be the plain
   chi2 at its pose (relative 1e-4 plus 1e-3, the 1e9 markers equal) and
   agree with its inlier mask and count. Then timed with CUDA events, 100
   calls a run (20 of the plain version), in turns: the kernel's wrapper alone, the solver entry
   point that calls it (which must stay within 0.03 ms of the wrapper and
   put exactly one row, the kernel, on the device), and the plain version;
   the wrapper at the schedules 0x0, 1x1 and 4x10 (rounds x iterations),
   which read the fixed part of a call and the time an iteration adds
   apart; and 4x10 at B = 8 and B = 132 independent problems. The same
   timings (but B) again at N = 3072. The bound beside these is computed
   from this run's shapes and counts.
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
   local-map pose problems of 3 NORMAL frames and of the frame with the
   worst error re-solved by the plain solver on the card within max|dT|
   1e-3 and one inlier of the kernel. Then the median ms per frame with and
   without a keyframe, per mapper call, and the peak device memory. Last,
   the whole sequence again with the plain solver in the kernel's place
   (no K1 launch), over the first N_PLAIN frames: its ATE and worst frame
   are printed beside the kernel run's over the same frames, with how far
   the two trajectories come apart.

5. The System, the way a user starts the port: ``slam.system.System`` built
   from a ``SystemConfig`` made in code, at phase 4's operating point.
   *sync*: ``System.track_stereo`` over the 60 frames; every pose must equal
   phase 4's ``Tracker.track`` pose bit for bit, with the same keyframes
   and the K1 launches the telemetry calls for. *async*
   (``async_tracking=True, commit_lag=2``): the 60 frames and ``flush()``,
   twice; 60 telemetry rows in frame order, state NORMAL, phase 4's accuracy
   gates by ``io.evaluate.ate_rmse``, K1 launches as the telemetry calls for,
   identical frame lines in both runs. Frames/s and ms/frame of each mode
   over the frames after the first N_WARM, the window closed by ``flush()``
   (of the first async run: the second is the one that counts).
   The synchronising calls a steady-state frame makes, with and without
   a keyframe (``torch.cuda.set_sync_debug_mode("warn")``), printed with
   their sites: of the async mode over frames N_WARM to N_SYNC_COUNT - 1 of
   the second async run, where the async loop's own code must make none; of
   the sync mode over the same frames of phase 6a's sync run, which up to
   the blackout is this phase's sync run. *RGB-D*: 30 frames through
   ``System.track_rgbd`` with depth rendered from the truth. *from disk*:
   8 frames written in the KITTI layout (8-bit PGM), read back by
   ``io.datasets.KittiOdometry`` and fed to a fresh System, whose poses must
   equal those of a System fed the same 8-bit frames from memory; then the
   TUM trajectory file, a checkpoint, its restore into a second System, and
   one more frame tracked by both to the same pose.

6. Loss recovery and sensor fusion, through ``System`` at the same
   operating point. *6a, blackout*: frames 30-33 are flat images; sync, then
   async. The tracker enters REINITIALIZE, the blank frames leave no
   sub-map behind (2 maps), the sub-map is registered and tied to the last
   reference keyframe before the loss, a row carries ``>REINIT_OK``, every
   frame from the recovery on is tracked, local BA takes the prior path on
   the keyframes after it, K1 launches as the telemetry calls for, ATE and
   worst frame over the tracked frames under bounds set from readings; the
   async run's lines up to the blackout are phase 5's. The sync run is
   also phase 7d's tiepoint run: ``optimizer.realtime=False`` with
   ``gba_interval`` GBA_EVERY_6A, so that one global BA runs a few
   keyframes after the recovery, with the sub-map's tiepoint edge; it must
   free the sub-map's origin, and it prints how far the sub-map's and the
   root map's keyframes lie from the truth before and after it. *6b, forced loss*: ``reset_interval`` 15 from the config, 50
   frames: at least 3 maps, every sub-map registered, trajectory rows for
   every tracked frame. *6c, sensors*: rendered GPS, IMU and depth readings
   on every frame with positive weights: the GPS prior becomes active with
   the 5th keyframe that carries a fix, the prior cost is finite, ATE stays
   within a margin of phase 4's run without sensors, and a checkpoint saved
   after frame 40 resumes with its sensor arena to the uninterrupted run's
   next pose. *6d*: CG against the dense solve: the pose step of the first
   linearization within 1e-3 relative; after a few robust iterations costs
   within 1e-4 relative and poses within 1e-3, on the problem the
   system produces: the local BA of 6c's last keyframe with its GPS, IMU
   and depth priors, 5 robust iterations (local BA's phase 1), then the
   whole two-phase schedule by each solver with the time of each, where
   CG's cost must end no more than 1% above the dense solve's (over 15 LM
   iterations two correct solvers part at an accept-or-reject decision, so
   their difference is printed, not bounded). (A tiepoint edge never lies
   in a local-BA window: global BA carries it, in 6a's sync run.) Printed: ms per
   ``integrate_keyframe`` with and without priors, ms of
   ``build_pose_priors``, the synchronising calls of a keyframe frame on the
   prior path.

7. The monocular camera and global BA. *7a*: the left images of the first
   N_MONO frames, frames DARK_MONO flat, through ``System.track_monocular``
   of a monocular camera (the two-view initializer with the init extractor,
   INITIALIZE -> POSTINIT -> NORMAL, on the loss RELOCALIZE: ranked
   keyframes, PnP, the pose-only LM, the local map). Gates: initialized
   before the blackout, keyframes, one ``>RELOC_OK`` within 3 frames of
   the blackout's end and every later frame tracked, ATE and worst frame
   after a sim3 alignment under bounds set from readings, K1 launches as
   the telemetry and the relocalization log call for. *7b*: the same frames
   with ``async_tracking=True``: the loss at commit time (``NORMAL>LOST``),
   then the same gates. *7c*: K1 against the plain solver on the card on
   two problems of 7a: its last frame's local-map solve (``stereo`` all
   False) and its last PnP refinement, with phase 1's bounds, both timed.
   *7d*: a short stereo sync run at MapCaps(K=K_BIG) with
   ``optimizer.realtime=False``, whose global BA ``solver="auto"`` sends to
   the CG solve (N_ITERS_BIG LM iterations); on its map the dense global
   BA over as many iterations, timed beside it: the first linearization's
   pose steps within 1e-3 relative, CG's final cost no more than 1% above
   dense's; and the mapper's ms a keyframe at K_BIG.

8. Loop closing through ``System`` with the config's defaults (loop
   closing on, the shipped ``Vocabulary/synthetic_orb.npz``), at phase 4's
   operating point with MapCaps(K=K8): a rendered circuit of N_CIRCLE frames
   around a circle and N_REVISIT more over its start (the recipe of
   tests/test_async_tracking.py's loop test, scaled to this camera), frames
   DARK8 flat, and after ``>REINIT_OK`` the registered sub-map moved by the
   JAX tests' bad placement PERTURB8. *8a*, sync. Gates: REINITIALIZE, 2
   maps, the sub-map registered; a loop closes, none before the revisit
   (the first frame whose camera is back within MAX_LOOP_GAP_M of the
   start's in the truth: the circle's last frames already run over it);
   the first loop's keyframe and candidate in different maps and within
   MAX_LOOP_GAP_M in the truth; the first closure at least halves the mean
   translation error of the sub-map's keyframes; ATE under MAX_ATE_LOOP;
   K1 launches as the telemetry calls for. *8b*, async (commit_lag 2): the
   same gates. Printed: the closures' stages and the sub-map's errors
   before and after, the synchronising calls of a keyframe's loop
   maintenance with their sites, and a ``phase 8 timing:`` line (median
   ms of a keyframe's loop maintenance that closes nothing; ms of
   ``compute_sim3``, of ``correct`` with the essential graph and of the
   post-loop global BA; frames/s of 8a and 8b; the card).

9. The dual camera and the SURF family. *9a*: a ``System`` with the SLAM
   camera of phases 2-8 and the reference's Imaging camera (native
   2704x2028, fx = fy = 1829, ``scale`` 0.5: 1352x1014 working, monocular,
   ORB 3000 x 8, the rig of tests/test_dual_camera.py), both in
   MapCaps(K=64, L=16384, F=3072, O=8), loop closing on (the config's
   default): phase 4's 60 frames, an Imaging frame rendered at the native
   size every IMG_EVERY-th frame, the frames DARK flat in both cameras,
   ``place_imaging_frame`` on every Imaging frame while SLAM tracks, then
   ``run_imaging_bundle_adjustment`` (timed apart from its sparsification)
   and the exports. Gates (tests/test_dual_camera.py's): SLAM ends NORMAL
   within phase 5's ATE bound before the blackout and 6a's over the run;
   >= 6 Imaging keyframes; the Imaging camera NULL while SLAM is lost and
   POSTINIT or NORMAL at the end; >= 2 Imaging sub-maps, all registered
   after imaging BA; the placer keeps some frames and skips some; the
   Imaging keyframes' ATE against the rendered truth < 0.35 m after
   finalization; the export files; K1's launches equal what both trackers'
   telemetry calls for. *9b*: the same, async (commit_lag 2), over N_ASYNC9
   frames. *9c*: a stereo System with ``family: SURF`` at phase 5's
   operating point over N_SURF frames (every frame after the first tracked,
   ATE < 0.08 m, K1 as the telemetry calls for), the card's SURF
   extraction against the CPU's on SURF_CHECK frames (equal keypoints and
   levels, < 0.5% descriptor bits apart), and SURF's ms at 1280x720 and at
   the Imaging camera's 1352x1014 with 3000 features. Printed: the ms of a
   frame of each camera, of a placer call, of imaging BA and of
   sparsification (and what it culled), the synchronising calls of a
   steady Imaging frame, peak device memory (a ``phase 9 timing:`` line).

10. The threaded pipeline: ``System(pipelined=True)`` (the reference's
   tracking and mapping threads over the native queues of
   ``runtime/native.py``) at phase 5's operating point, built with no
   device given. *10a*: the 60 frames through ``track_stereo`` with
   ``run_data_dir`` set, loop closing off. Gates: 60 rows in frame order
   ending NORMAL; every keyframe after the first integrated by the mapping
   thread; K1 launches as the telemetry calls for; ATE and worst frame
   within phase 5's async bounds, keyframes from phase 5's async count
   less 5 to its sync count; one keyframe decision a frame after POSTINIT,
   every keyframe taken at one that read the mapping stage idle (the
   policy's optional keyframes need it); the replay, a synchronous System whose
   tracker replays 10a's schedule (``ReplaySchedule``: its idle reads, and
   the frames where its tracker took the mapper's map), gives 10a's
   telemetry rows and poses bit for bit; the frame dumps of frames 0, 20
   and 40 decode to the annotated image's size; the TSV logs' rows; a
   ``viz.Viewer`` snapshot of the final map. Printed beside phase 5's sync
   and async frames/s: frames/s (the same clock), keyframes, the tracking
   thread's waits in ``drain_mapping``, the mapping thread's busy share,
   the median mapper job and tracking frame, and the replay's, alone (a
   ``phase 10 timing:`` line).
   *10b*: 6a's blackout over the first N_BLACKOUT10 frames through a
   pipelined System with loop closing on and a global BA every
   GBA_EVERY_10B keyframes: REINITIALIZE, ``>REINIT_OK`` and 2 maps, every
   global BA on the mapping thread, 6a's ATE and worst-frame bounds, K1 as
   the telemetry calls for; then ``shutdown()`` (``track_features``
   refused), ``reset()`` and N_AFTER_RESET frames tracked to NORMAL. A
   thread's exception reaches the script through ``flush`` or
   ``shutdown`` and fails it.

Prints the card line, one JSON line of kernel results (with the kernel's
time: its bound and what sets it, its fixed part and its time an
iteration), and last
``{"ok": true, "device": {...}}``. Any failure raises.
"""

from __future__ import annotations

import json
import os
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
IMG_CAPS = (64, 16384, 3072, 8)    # phase 9's shared arena: F for 3000 features
N_LANDMARKS = 4096
N_POINTS = 4000
N_TIMED = 100
N_TIMED_PLAIN = 10            # calls a run of the plain solver (160 ms a call)
N_ODD = 4093                  # phase 1: a problem of four chunks, N % 4 != 0
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
# the kernel's chi2 output against the plain evaluation at the same pose:
# relative 1e-4, plus 1e-3 absolute because a residual is a difference of
# pixel coordinates of a few hundred, whose float32 rounding (fused
# multiply-adds in the kernel, none in the plain version) is absolute
CHI2_RTOL, CHI2_ATOL = 1e-4, 1e-3
# the solver entry point against the wrapper it calls, ms per call
MAX_FAST_OVER_KERNEL_MS = 0.03
# phase 4: the tracker against the rendered truth, and what the mapper must
# have done. Readings when the bounds were set (PERF.md): ATE 0.0237 m, worst
# frame 0.0617 m, 785 live landmarks of 854 seeded at the end. The ATE bound
# is 1.5x its reading; the per-frame bound is phase 2's 0.08 m. A change of
# summation order in the solver moves the worst frame between 0.04 and
# 0.074 m (PERF.md), so phase 4 also prints the run with the plain solver.
MAX_T_TRACK, MAX_ATE = 0.08, 0.035
MIN_KEYFRAMES = 5
MIN_LIVE_OF_SEEDED = 0.75     # live landmarks at the end / seeded at init
N_COMPARE = 3
# phase 5: frames before the timed window, frames of the RGB-D and disk
# runs and of the runs that count synchronising calls
N_WARM, N_RGBD, N_DISK, N_SYNC_COUNT = 10, 30, 8, 24
MIN_SEEDED_RGBD = 100
N_PLAIN = 20                  # phase 4: frames of the run with the plain solver
# phase 6: the blackout (frames DARK[0]..DARK[1]-1 are flat), the forced
# loss, the sensors' weights and noise, the checkpoint's frame. The bounds
# are 1.5x the sync run's readings on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md): after 4 blank frames the sub-map is placed by a 5-frame
# extrapolation of the motion model, 0.089 m off in the sync run, and
# nothing in local BA pulls it back (ATE 0.059558 m, worst frame 0.097339 m;
# async 0.045802 and 0.070978 m)
DARK = (30, 34)
MAX_ATE_BLACKOUT, MAX_T_BLACKOUT = 0.09, 0.15
RESET_INTERVAL, N_FORCED = 15, 50
SENSOR_WEIGHTS = dict(gps_info=10.0, imu_info=1.0, depth_info=10.0)
GPS_SIGMA = (0.01, 0.01, 0.02)
MAX_ATE_OVER_NO_SENSORS = 0.01    # m, 6c's ATE above the run without sensors
CHECKPOINT_FRAME = 40
N_PRIOR_SYNC_COUNT = 12       # last frames of 6a's sync run, counted
# CG against dense, held where the comparison is well defined (readings on an
# NVIDIA H100 80GB HBM3 at 700 W, PERF.md): the pose step of one
# linearization (1.4e-4 relative seen), and a few robust iterations (cost
# 1.2e-7 relative, poses 2.7e-5 on 6c's window). Over the whole schedule of
# local BA two correct solvers part: in the
# non-robust phase, at a damping of ~1e-6, a step with a far landmark in it
# is accepted by one solver and rejected by the other (its cost 38469
# against 428), and from there on they follow different paths to costs 7e-4
# and poses 7e-3 apart, neither converged after 10 iterations. There the
# gate is one-sided: CG must end no more than 1% above the dense solve (and
# so in 7d, over global BA's N_ITERS_BIG robust iterations at K_BIG).
CG_STEP_RTOL, CG_COST_RTOL, CG_POSE_ATOL, CG_WHOLE_COST_RTOL = 1e-3, 1e-4, 1e-3, 1e-2
N_SHORT_ITERS = 5             # robust iterations of 6d's short solve (local BA's phase 1)
# 6a's sync run with periodic global BA: its keyframes are frames 0-29 and
# one a frame from the recovery (34) on, so the 36th keyframe, which runs
# the one global BA of the run, is frame 39's: five keyframes after the
# recovery, with the sub-map registered and its tiepoint edge active
GBA_EVERY_6A = 36
# phase 7: the monocular run (the left images of the first N_MONO frames,
# frames DARK_MONO[0]..DARK_MONO[1]-1 flat) and the K_BIG run (N_BIG stereo
# frames, one global BA at the last keyframe)
N_MONO, DARK_MONO = 36, (20, 23)
MAX_RELOC_DELAY = 3           # frames from the blackout's end to >RELOC_OK
# bounds after a sim3 alignment, 1.5x the first readings on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md): ATE 0.085417 m sync, 0.069289 m async; the
# worst frame is the initialization's second frame, 0.183642 m
MAX_ATE_MONO, MAX_T_MONO = 0.13, 0.28
K_BIG, N_BIG = 512, 10
N_ITERS_BIG = 5               # LM iterations of 7d's global BA, CG and dense alike
# phase 8: loop closing through the System on tests/test_async_tracking.py's
# circuit scaled to this camera: N_CIRCLE frames around a circle (0.5 m and
# 2 pi / N_CIRCLE of yaw a frame), N_REVISIT more over its start, N_CIRCLE x
# POINTS_PER_CENTRE points from default_rng(8) in a 12 x 8 x 12 m box around
# each of the circle's camera centres, frames
# DARK8 flat; after >REINIT_OK the sub-map is moved by PERTURB8 (the JAX
# tests' bad placement). K8 keyframe slots: one keyframe a frame.
N_CIRCLE, N_REVISIT, STEP8 = 72, 18, 0.5
POINTS_PER_CENTRE = 55
DARK8 = (25, 29)
PERTURB8 = (0.0, 0.05, 0.0, 0.35, 0.0, 0.35)
K8 = 128
# ATE after the closure: 1.5x the larger reading of 8a (0.0381 m) and 8b
# (0.0566 m) on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md), under the
# 0.40 m of tests/test_async_tracking.py's loop test
MAX_ATE_LOOP = 0.085
MAX_LOOP_GAP_M = 1.0          # closing keyframe to candidate, in the rendered truth
# phase 9: the reference's Imaging camera (SURVEY.md, BASELINE.md: a GoPro at
# 2704x2028, fx = fy = 1829, scale 0.5, ORB 3000 x 8 x 1.2) on the rig of
# tests/test_dual_camera.py, one frame every IMG_EVERY SLAM frames, both
# cameras in the IMG_CAPS arena; a keyframe at least every 2nd Imaging frame,
# as that test's policy. The SLAM frames DARK are flat, and so are the
# Imaging frames among them. Gates of tests/test_dual_camera.py.
IMG_NATIVE = dict(fx=1829.0, fy=1829.0, cx=1352.0, cy=1014.0, width=2704, height=2028)
IMG_SCALE, IMG_FEATURES, IMG_EVERY = 0.5, 3000, 2
IMG_TCAM = (0.0, 0.06, 0.02, 0.15, -0.1, 0.0)
MIN_IMG_KEYFRAMES, MAX_ATE_IMAGING = 6, 0.35
N_ASYNC9 = 60                 # frames of 9b
# 9c: a stereo System with family SURF at phase 5's operating point
N_SURF, SURF_CHECK = 20, (0, 10, 19)
MAX_SURF_BIT_FRACTION = 0.005
# phase 10: the pipelined System (the reference's tracking and mapping
# threads) at phase 5's operating point. The keyframe policy's mapping-idle
# gate reads the real mapping queue here. 10a is held to phase 5's async
# bounds and keyframes from phase 5's async count less 5 to its sync count;
# besides, the policy must read the stage (after POSTINIT every keyframe is
# taken at a decision that found it idle), and
# the threads must compute what a synchronous System computes on the same
# schedule (the replay: ReplaySchedule), bit for bit, as phase 5 holds its
# sync run to phase 4's.
DUMP_FRAMES = (0, 20, 40)
N_BLACKOUT10, GBA_EVERY_10B, N_AFTER_RESET = 40, 8, 10


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


def k1_bound(n_obs: int, n_valid: int, n_inliers: int, n_rounds: int, iters: int):
    """The least time (ms) one H100 could take for one K1 problem, and what
    sets it. Bytes: every input read once, every output written once, over
    3.35 TB/s. Operations, counted from csrc/pose_opt.cu with a multiply-add
    as two: FLOP_SYSTEM an active observation for a pass that sums H, g and
    the cost (40 for the residual and chi2, 31 for the weight and the three
    Jacobian rows, 112 + 36 + 7 for the sums with the identically zero
    products left out), FLOP_RESIDUAL an observation for a reclassification
    or final pass, FLOP_STEP for a damped 6x6 Cholesky solve, SE3 exp and
    compose; over 67 TFLOP/s float32. A schedule makes n_rounds * (iters + 1)
    system passes (round 0 over the valid observations, later rounds over
    about the final inliers), n_rounds + 1 residual passes over all n_obs,
    and n_rounds * iters steps."""
    FLOP_SYSTEM, FLOP_RESIDUAL, FLOP_STEP = 226, 40, 330
    read = 64 + n_obs * (12 + 8 + 4 + 4 + 1 + 1)
    written = 64 + n_obs * (1 + 4) + 4
    active = (n_valid + (n_rounds - 1) * n_inliers) if n_rounds else 0
    flop = (active * (iters + 1) * FLOP_SYSTEM + (n_rounds + 1) * n_obs * FLOP_RESIDUAL
            + n_rounds * iters * FLOP_STEP)
    by_bytes, by_ops = 1e3 * (read + written) / 3.35e12, 1e3 * flop / 67e12
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "bytes": read + written, "flop": flop}


def device_rows(fn, n: int = 1) -> list[tuple[str, float]]:
    """(name, us on the device) of every row that n calls of fn put on the
    device (kernels, copies, sets), by torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def phase1(dev):
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.solver.pose_opt import (
        _final_chi2, pose_optimization, pose_optimization_fast,
        pose_optimization_fused_schedule)
    from hyslam_tpu_torch.utils.synth import pose_error, pose_problem

    cases = {  # outlier_frac, stereo_frac, rot bound (deg), t bound vs truth
        "stereo": (0.0, 1.0, 0.1, 0.01),
        "outliers": (0.25, 1.0, 0.2, 0.02),
        "mono": (0.0, 0.0, 0.2, 0.05),
    }

    def check(n_obs: int, names=tuple(cases)):
        """The kernel against both plain solvers on the cases at n_obs
        observations. Returns (max|dT|, the stereo case for timing)."""
        max_abs_err, timed = 0.0, None
        for i, (name, (out_frac, st_frac, rot_b, t_b)) in enumerate(cases.items()):
            if name not in names:
                continue
            tag = f"phase 1 N={n_obs} {name}"
            cam, T_true, args = pose_problem(i, out_frac, st_frac, n_obs)
            targs = [torch.from_numpy(np.array(a)).to(dev) for a in args]
            k = pose_optimization_fast(cam, *targs)
            Tk = k.Tcw.cpu().numpy()
            if not (np.isfinite(Tk).all() and Tk.shape == (4, 4)):
                raise AssertionError(f"{tag}: kernel pose not finite: {Tk}")
            rot, t = pose_error(Tk, T_true)
            if not (rot < rot_b and t < t_b):
                raise AssertionError(f"{tag}: kernel off the truth ({rot}, {t})")
            # against the two-pass plain solver and the plain form of its own
            # one-pass schedule
            fused, accepts = pose_optimization_fused_schedule(cam, *targs)
            for other, p in (("plain", pose_optimization(cam, *targs)),
                             ("fused plain", fused)):
                Tp = p.Tcw.cpu().numpy()
                d_rot, d_t = pose_error(Tk, Tp)
                d_inl = abs(int(k.num_inliers) - int(p.num_inliers))
                err = float(np.abs(Tk - Tp).max())
                max_abs_err = max(max_abs_err, err)
                log(f"{tag}: truth rot {rot:.5f} deg t {t:.6f} | vs {other} "
                    f"d_rot {d_rot:.6f} d_t {d_t:.7f} inliers {int(k.num_inliers)} vs "
                    f"{int(p.num_inliers)} max|dT| {err:.3e}")
                if not (d_rot < MAX_D_ROT and d_t < MAX_D_T and d_inl <= MAX_D_INLIERS
                        and err < MAX_ABS_DT_PROBLEM and d_inl <= MAX_D_INLIERS_PROBLEM):
                    raise AssertionError(f"{tag}: kernel and {other} disagree "
                                         f"(d_rot {d_rot}, d_t {d_t}, max|dT| {err}, "
                                         f"inliers {d_inl} apart)")
            log(f"{tag}: fused plain schedule accepted {int(accepts.sum())} of "
                f"{accepts.numel()} steps")
            # the kernel's chi2 against the plain evaluation at the kernel's pose
            _, X, uv, ur, inv_s2, valid, stereo = targs
            want = _final_chi2(cam, k.Tcw, X, uv, ur, inv_s2, stereo)
            marker = want == 1e9
            diff = (k.chi2 - want).abs()
            chi2_ok = (torch.equal(k.chi2 == 1e9, marker)
                       and bool((diff <= CHI2_RTOL * want.abs() + CHI2_ATOL)[~marker].all()))
            rel = float((diff / want.abs().clamp_min(1.0))[~marker].max())
            log(f"{tag}: kernel chi2 vs plain at the kernel's pose: max "
                f"|d| / max(chi2, 1) {rel:.3e}, {int(marker.sum())} behind-camera markers")
            if not (chi2_ok and k.chi2.shape == want.shape
                    and torch.equal(k.inliers,
                                    valid & (k.chi2 <= torch.where(stereo, 7.815, 5.991)))
                    and int(k.num_inliers) == int(k.inliers.sum())):
                raise AssertionError(f"{tag}: the kernel's chi2, inlier mask and "
                                     "count do not agree")
            if name == "stereo":
                timed = (cam, targs, int(valid.sum()), int(k.num_inliers), k.Tcw)
        return max_abs_err, timed

    def schedules(cam, kargs, n_obs):
        """The chain: the fixed part of a problem (load, final pass) and the
        time an iteration adds, from three schedules in turns. Read from the
        kernel's own duration on the device (the profiler's rows): between
        CUDA events a call shorter than the host's pace of launching shows
        that pace, which is printed beside it."""
        sched = {s: ([], []) for s in ((0, 0), (1, 1), (4, 10))}
        for s in (*sched, *reversed(sched)):
            fn = lambda: pose_optimization_cuda(cam, *kargs, n_rounds=s[0],
                                                iters_per_round=s[1])
            fn()
            sched[s][0].append(cuda_ms(fn, N_TIMED))
            us = [us for _, us in device_rows(fn, N_TIMED)]  # the profiler may drop a row
            if not 0.9 * N_TIMED <= len(us) <= N_TIMED:
                raise AssertionError(f"phase 1: {len(us)} device rows for {N_TIMED} launches")
            sched[s][1].append(statistics.mean(us) / 1e3)
        fixed_ms = statistics.mean(sched[(0, 0)][1])
        per_iter_us = 1e3 * (statistics.mean(sched[(4, 10)][1]) - fixed_ms) / 40
        log(f"phase 1 schedules at N={n_obs} B=1 (rounds x iterations), ms between events "
            "a call: " + ", ".join(f"{r}x{i} {v[0]}" for (r, i), v in sched.items()))
        log(f"phase 1 schedules at N={n_obs} B=1, ms on the device a call: "
            + ", ".join(f"{r}x{i} {v[1]}" for (r, i), v in sched.items())
            + f" -> fixed {fixed_ms:.5f} ms, {per_iter_us:.3f} us an iteration")
        return fixed_ms, per_iter_us

    def timings(cam, targs, n_obs, n_plain):
        """kernel: the wrapper alone, on inputs already in its layout; fast:
        the solver entry point, which hands the wrapper views of its
        arguments; plain: the two-pass plain solver. In turns."""
        kargs = [x[None] for x in targs]
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
            runs[which].append(cuda_ms(fns[which], n_plain if which == "plain" else N_TIMED))
        log(f"phase 1 timing, N={n_obs}, {N_TIMED} calls per run ({n_plain} of the "
            f"plain solver), ms/call: " + ", ".join(f"{k} {v}" for k, v in runs.items()))
        return fns, kargs, runs

    max_abs_err, (cam, targs, n_valid, n_inl, T_one) = check(CAPACITY)
    fns, kargs, runs = timings(cam, targs, CAPACITY, N_TIMED_PLAIN)
    k_ms, fast_ms = statistics.mean(runs["kernel"]), statistics.mean(runs["fast"])
    rows = [name for name, _ in device_rows(fns["fast"])]
    log(f"phase 1: one pose_optimization_fast call put on the device: {rows}")
    if len(rows) != 1 or abs(fast_ms - k_ms) >= MAX_FAST_OVER_KERNEL_MS:
        raise AssertionError(f"phase 1: fast {fast_ms} ms vs kernel {k_ms} ms, "
                             f"{len(rows)} device rows a call")
    fixed_ms, per_iter_us = schedules(cam, kargs, CAPACITY)
    for B in (8, 132):
        rows = [pose_problem(seed, 0.0, 1.0, CAPACITY)[2] for seed in range(B)]
        bargs = [torch.from_numpy(np.stack([np.asarray(r[j]) for r in rows])).to(dev)
                 for j in range(7)]
        fn = lambda: pose_optimization_cuda(cam, *bargs)
        T, _, ninl, _ = fn()
        # problem 0 is the timed one: in a batch it must give the same bits
        if not (torch.isfinite(T).all() and torch.equal(T[0], T_one)
                and int(ninl.min()) >= MIN_INLIERS):
            raise AssertionError(f"phase 1 B={B}: batched problems failed")
        log(f"phase 1 B={B} independent problems, 4x10, ms/call: "
            f"{[cuda_ms(fn, N_TIMED) for _ in range(2)]}")
    bound = k1_bound(CAPACITY, n_valid, n_inl, 4, 10)
    log(f"phase 1 bound for one 4x10 problem at N={CAPACITY}: {bound}")

    # the Imaging camera's problems (phase 9): one row a feature slot of
    # F = IMG_CAPS[2]; the kernel's shared-memory chunks. N_ODD takes the
    # scalar load path (N % 4 != 0) over all four chunks.
    err_big, (cam3, targs3, n_valid3, n_inl3, _) = check(IMG_CAPS[2])
    err_odd, _ = check(N_ODD, names=("outliers",))
    max_abs_err = max(max_abs_err, err_big, err_odd)
    _, kargs3, runs3 = timings(cam3, targs3, IMG_CAPS[2], N_TIMED_PLAIN // 2)
    fixed3, per_iter3 = schedules(cam3, kargs3, IMG_CAPS[2])
    bound3 = k1_bound(IMG_CAPS[2], n_valid3, n_inl3, 4, 10)
    log(f"phase 1 bound for one 4x10 problem at N={IMG_CAPS[2]}: {bound3}")
    return {"max_abs_err": max_abs_err, "ms": k_ms, "plain_ms": statistics.mean(runs["plain"]),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "fixed_ms": fixed_ms, "per_iter_us": per_iter_us, "library_ms": None,
            f"n{IMG_CAPS[2]}": {
                "ms": statistics.mean(runs3["kernel"]),
                "plain_ms": statistics.mean(runs3["plain"]),
                "bound_ms": bound3["bound_ms"], "bound_by": bound3["bound_by"],
                "fixed_ms": fixed3, "per_iter_us": per_iter3}}


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
    (poses [n] numpy, pairs [n,2,H,W] on dev, the world's points)."""
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
    return poses, pairs, pts


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
    from hyslam_tpu_torch.io.evaluate import ate_rmse
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam.frontend import match_stereo_pair
    from hyslam_tpu_torch.slam.tracker import State, Tracker
    from hyslam_tpu_torch.solver.pose_opt import pose_optimization, pose_optimization_fast
    from hyslam_tpu_torch.utils import synth

    def track_all(tracker, count):
        """count frames through extraction, stereo matching and track():
        ([(ms, made a keyframe)], {frame: its NORMAL-state result})."""
        frame_ms, normal = [], {}
        for i in range(count):
            t = time.perf_counter()
            fl = match_stereo_pair(cam, extract_atlas_batch(pairs[i], cfg, CAPACITY), pairs[i])
            tel = tracker.track(fl, FRAME_DT * i, i)
            torch.cuda.synchronize()
            frame_ms.append((1e3 * (time.perf_counter() - t), tel.kf_inserted >= 0))
            if tel.state == "NORMAL":
                normal[i] = (tracker.last_result, tel.n_inliers)
        return frame_ms, normal

    def errors(tracker, count):
        est = tracker.traj.Tcw[:count].cpu().numpy()
        return est, [synth.pose_error(est[i], poses[i]) for i in range(count)]

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
    frame_ms, normal = track_all(tracker, n)
    launches = pose_optimization_cuda.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    tels = tracker.telemetry
    n_min = tracker.params.motion.n_min_matches
    expected = sum(2 + (t.n_motion < n_min) for t in tels
                   if t.state in ("POSTINIT", "NORMAL"))
    est, rot_t = errors(tracker, n)
    errs = [tr for _, tr in rot_t]
    for i, t in enumerate(tels):
        rot, tr = rot_t[i]
        log(f"  frame {i}: {t.state} motion {t.n_motion} inliers {t.n_inliers} "
            f"local {t.n_local} kf {t.kf_inserted} seeded {t.n_seeded} "
            f"rot {rot:.5f} deg t {tr:.6f} m {t.mapper_stats or ''}")
    ate = ate_rmse(est, np.stack(poses), align="none")
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

    # the tracker's own local-map pose problems through the plain solver:
    # the first N_COMPARE NORMAL frames and the frame with the worst error
    compared = []
    for i in dict.fromkeys([*sorted(normal)[:N_COMPARE], *([worst] if worst in normal else [])]):
        nf, n_inl = normal[i]
        p = pose_optimization(*nf.problem)
        err = float((nf.Tcw - p.Tcw).abs().max())
        compared.append((i, err, abs(n_inl - int(p.num_inliers))))
        log(f"phase 4 frame {i}: kernel vs plain max|dT| {err:.3e} inliers "
            f"{n_inl} vs {int(p.num_inliers)}")

    # The same sequence with the plain solver in the kernel's place. The
    # mapper feeds every pose back into the map, so late digits of a solve
    # grow along the sequence: this run says how far two correct solvers
    # come apart, beside the kernel's distance from the truth.
    from hyslam_tpu_torch.slam import strategies

    plain_tracker = Tracker(cam=cam, caps=MapCaps(*TRACK_CAPS), device=dev)
    pose_optimization_cuda.launches = 0
    strategies.pose_optimization_fast = pose_optimization
    try:
        track_all(plain_tracker, N_PLAIN)
    finally:
        strategies.pose_optimization_fast = pose_optimization_fast
    plain_launches = pose_optimization_cuda.launches
    est_p, rot_t_p = errors(plain_tracker, N_PLAIN)
    errs_p = [tr for _, tr in rot_t_p]
    ate_p = ate_rmse(est_p, np.stack(poses[:N_PLAIN]), align="none")
    ate_k = ate_rmse(est[:N_PLAIN], np.stack(poses[:N_PLAIN]), align="none")
    worst_p, worst_k = int(np.argmax(errs_p)), int(np.argmax(errs[:N_PLAIN]))
    apart = np.linalg.norm(est[:N_PLAIN, :3, 3] - est_p[:, :3, 3], axis=-1)
    first_apart = int(np.argmax(apart > 1e-3)) if (apart > 1e-3).any() else -1
    log(f"phase 4 with the plain solver in K1's place, frames 0-{N_PLAIN - 1}: ATE "
        f"{ate_p:.6f} m, worst frame {worst_p} at {errs_p[worst_p]:.6f} m (the kernel run "
        f"over the same frames: ATE {ate_k:.6f} m, worst frame {worst_k} at "
        f"{errs[worst_k]:.6f} m); kernel and plain trajectories at most {apart.max():.6f} m "
        f"apart (frame {int(apart.argmax())}), first over 0.001 m at frame {first_apart}; "
        f"K1 launches {plain_launches}")

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
        f"{len(compared)} NORMAL frames, the worst among them: kernel and plain solver "
        f"within {MAX_ABS_DT_SLICE} and {MAX_D_INLIERS_PROBLEM} inlier":
            len(compared) >= N_COMPARE and worst in normal and all(
                e < MAX_ABS_DT_SLICE and d <= MAX_D_INLIERS_PROBLEM for _, e, d in compared),
        "the run with the plain solver: every frame tracked, finite poses, no K1 launch":
            plain_tracker.state == State.NORMAL and len(plain_tracker.telemetry) == N_PLAIN
            and int(plain_tracker.traj.size) == N_PLAIN
            and bool(np.isfinite(est_p).all()) and plain_launches == 0,
    }
    failed = [g for g, ok in gates.items() if not ok]
    if failed:
        raise AssertionError("phase 4 failed: " + "; ".join(failed))
    return {"launches": launches, "Tcw": tracker.traj.Tcw[:n].clone(),
            "keyframes": [t.kf_inserted for t in tels], "ate": ate}


def sync_sites(fn):
    """Run fn with the synchronising-call warnings on: {"file:line": count}
    of the calls that made the host wait for the card (reads of a device
    value, copies between pageable host memory and the card)."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites: dict = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            parts = os.path.normpath(w.filename).split(os.sep)[-2:]
            site = f"{'/'.join(parts)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def log_sync_calls(phase: str, mode: str, per_frame) -> None:
    """Print the synchronising calls of the counted frames [(made a
    keyframe, {site: count})], those with and those without a keyframe."""
    for made_kf in (False, True):
        rows = [s for k, s in per_frame if k == made_kf]
        what = (f"{phase} synchronising calls {'an' if mode[0] in 'aeiou' else 'a'} {mode} frame "
                f"{'with' if made_kf else 'without'} a keyframe")
        if rows:
            rep = max(rows, key=lambda s: sum(s.values()))
            log(f"{what}: " + json.dumps({
                "frames": len(rows),
                "median": statistics.median(sum(s.values()) for s in rows),
                "max": sum(rep.values()), "sites_of_the_max": rep}))
        else:
            log(f"{what}: no such frame among frames {N_WARM}-{N_SYNC_COUNT - 1}")


def make_system(cam, cfg, camera_kw=None, caps=TRACK_CAPS, **kw):
    """A System at the operating point of phases 4-7, built the way a user
    builds one: from a SystemConfig made in code, with no device given, so
    that it takes the card. camera_kw override the camera's settings."""
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
    from hyslam_tpu_torch.slam.system import System

    cc = CameraConfig(**{**dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                                height=cam.height, bf=cam.bf, th_depth=cam.th_depth,
                                extractor=cfg), **(camera_kw or {})})
    return System(SystemConfig(cameras={"SLAM": cc}, caps=MapCaps(*caps),
                               **{"enable_loop_closing": False, **kw}))


def tracked_row(t) -> bool:
    """Whether a telemetry row's frame went through the NORMAL-state
    tracking step (a forced loss returns before it)."""
    return t.state.split(">")[0] in ("POSTINIT", "NORMAL") and "FORCED_LOSS" not in t.state


def expected_launches(tracker) -> int:
    """The K1 launches the telemetry and the relocalization log call for: 2
    a frame through the NORMAL-state step, 3 where its motion model failed;
    in RELOCALIZE one a PnP refinement and one a local-map solve."""
    n_min = tracker.params.motion.n_min_matches
    return (sum(2 + (t.n_motion < n_min) for t in tracker.telemetry if tracked_row(t))
            + sum(r["pnp_solves"] + r["local_solves"] for r in tracker.reloc_log))


def time_integrate(tracker):
    """Wrap the tracker's integrate_keyframe with a synchronised clock:
    returns the list it fills with (keyframe id, ms, took the prior path)."""
    integrate, rows = tracker.mapper.integrate_keyframe, []

    def timed_integrate(ms, kf_id, **kw):
        before = tracker.mapper.n_prior_ba
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = integrate(ms, kf_id, **kw)
        torch.cuda.synchronize()
        rows.append((int(kf_id), 1e3 * (time.perf_counter() - t),
                     tracker.mapper.n_prior_ba > before))
        return out

    tracker.mapper.integrate_keyframe = timed_integrate
    return rows


def first_step_apart(prob, chunk: int = 256):
    """One linearization of a BA problem at its start, the pose step by each
    solver: (max|d_cg - d_dense|, max|d_dense|)."""
    from hyslam_tpu_torch.solver import ba, priors

    lam = torch.full((), 1e-4, device=prob.kf_Tcw.device)
    K = prob.kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, _, _, _, kf_idx = ba._linearize_factors(
        prob, prob.kf_Tcw, prob.lm_pos, lam, prob.obs.valid, True)
    S_red, b_red = ba._schur_reduce_dense(Y, y, kf_idx, K, chunk)
    Hab = None
    if prob.priors is not None:
        Hd, b_pr, Hab = priors.linearize_priors_blocks(prob.kf_Tcw, prob.priors)
        Hpp, b_pose = Hpp + Hd, b_pose + b_pr
        S_red = S_red - priors.tie_offdiag_dense(prob.priors, Hab, K, Hpp.dtype)
    dense = ba._solve_poses(Hpp, b_pose, S_red, b_red, prob.kf_fixed, lam)
    cg = ba._solve_poses_cg(Hpp, b_pose, ba._reduced_rhs(Y, y, kf_idx, K), Y, kf_idx,
                            prob.kf_fixed, lam, priors=prob.priors, Hab=Hab)
    return float((cg - dense).abs().max()), float(dense.abs().max())


def frame_lines(tracker):
    """(one line a telemetry row, one line a trajectory pose)."""
    return ([f"{t.frame_id} {t.state} {t.n_motion} {t.n_inliers} {t.n_local} "
             f"{t.kf_inserted}" for t in tracker.telemetry],
            [" ".join(f"{v:.9g}" for v in row)
             for row in tracker.traj.Tcw[:int(tracker.traj.size)].reshape(-1, 16).tolist()])


def trajectory_errors(tracker, poses):
    """(frame index of each trajectory row, ATE, per-row translation error)
    against the rendered truth."""
    from hyslam_tpu_torch.io.evaluate import ate_rmse
    from hyslam_tpu_torch.utils import synth

    size = int(tracker.traj.size)
    est = tracker.traj.Tcw[:size].cpu().numpy()
    idx = np.rint(tracker.traj.t[:size].cpu().numpy() / FRAME_DT).astype(int)
    errs = [synth.pose_error(est[k], poses[i])[1] for k, i in enumerate(idx)]
    ate = ate_rmse(est, np.stack(poses)[idx], align="none")
    return idx, (ate if np.isfinite(est).all() else float("nan")), errs


def phase5(cam, cfg, poses, pairs, pts, tracked):
    """The System on the whole sequence; see the module docstring. Returns
    the K1 launches of its gated runs, the async run's frame lines and the
    timing line's numbers."""
    import tempfile

    from hyslam_tpu_torch.io.datasets import KittiOdometry
    from hyslam_tpu_torch.io.evaluate import ate_rmse
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam.tracker import State
    from hyslam_tpu_torch.utils import synth

    n = len(poses)
    truth = np.stack(poses)

    def system(**kw):
        return make_system(cam, cfg, **kw)

    def drive(sysm, feed, count):
        """count frames through feed(sysm, i, timestamp), the clock started
        (after a flush) at frame N_WARM and stopped after the last flush:
        (K1 launches, frames/s, ms/frame)."""
        pose_optimization_cuda.launches = 0
        t = None
        for i in range(count):
            if i == N_WARM:
                sysm.flush()
                t = time.perf_counter()
            feed(sysm, i, FRAME_DT * i)
        sysm.flush()
        dt = time.perf_counter() - t
        return pose_optimization_cuda.launches, (count - N_WARM) / dt, 1e3 * dt / (count - N_WARM)

    def stereo(sysm, i, ts):
        sysm.track_stereo(pairs[i, 0], pairs[i, 1], ts, frame_id=i)

    expected = expected_launches
    failed = []

    def gate(name, ok):
        log(f"phase 5 gate {'ok' if ok else 'FAILED'}: {name}")
        if not ok:
            failed.append(name)

    total = 0

    # -- sync: System.track_stereo against phase 4's Tracker.track
    sysm = system()
    launches, fps_sync, ms_sync = drive(sysm, stereo, n)
    tr = sysm.trackers["SLAM"]
    total += launches
    gate("sync: the System took the card", sysm.device.type == "cuda")
    gate(f"sync: {n} poses equal to phase 4's Tracker.track, bit for bit",
         int(tr.traj.size) == n and torch.equal(tr.traj.Tcw[:n], tracked["Tcw"]))
    gate("sync: the same keyframes as phase 4",
         [t.kf_inserted for t in tr.telemetry] == tracked["keyframes"])
    gate(f"sync: K1 launches {launches} == {expected(tr)} from the telemetry",
         launches == expected(tr))

    # -- async, twice; the second run counts the synchronising calls of
    # frames N_WARM to N_SYNC_COUNT - 1, so only the first is timed
    per_frame = []

    def counting(sysm, i, ts):
        if not N_WARM <= i < N_SYNC_COUNT:
            return stereo(sysm, i, ts)
        rows = sysm.trackers["SLAM"].telemetry
        before = len(rows)
        sites = sync_sites(lambda: stereo(sysm, i, ts))
        per_frame.append((any(t.kf_inserted >= 0 for t in rows[before:]), sites))

    runs = []
    for feed in (stereo, counting):
        sysm = system(async_tracking=True, commit_lag=2)
        runs.append((sysm.trackers["SLAM"], *drive(sysm, feed, n)))
    tr, launches, fps_async, ms_async = runs[0]
    async_lines = frame_lines(tr)
    total += launches
    tels = tr.telemetry
    size = int(tr.traj.size)
    idx, ate, errs = trajectory_errors(tr, poses)
    n_kf = sum(t.kf_inserted >= 0 for t in tels)
    log(f"phase 5 async: {len(tels)} rows, {size} trajectory poses, {n_kf} keyframes at frames "
        f"{[t.frame_id for t in tels if t.kf_inserted >= 0]}, ATE {ate:.6f} m, worst frame "
        f"{int(idx[int(np.argmax(errs))])} at {max(errs):.6f} m, K1 launches {launches}")
    gate(f"async: {n} telemetry rows in frame order, none lost, every frame in the trajectory",
         [t.frame_id for t in tels] == list(range(n)) and size == n
         and list(idx) == list(range(n)))
    gate("async: state NORMAL, nothing in flight after flush",
         tr.state == State.NORMAL and not tr._pending)
    gate(f"async: ATE < {MAX_ATE} m and every frame < {MAX_T_TRACK} m",
         ate < MAX_ATE and max(errs) < MAX_T_TRACK)
    gate(f"async: K1 launches {launches} == {expected(tr)} from the telemetry",
         launches == expected(tr))
    gate("async: two runs print identical frame lines",
         async_lines == frame_lines(runs[1][0]) and runs[1][1] == launches)
    timing = {
        "frames_timed": n - N_WARM,
        "sync_frames_per_s": fps_sync, "sync_ms_per_frame": ms_sync,
        "async_frames_per_s": fps_async, "async_ms_per_frame": ms_async,
        "keyframes_sync": sum(k >= 0 for k in tracked["keyframes"]), "keyframes_async": n_kf,
    }
    log("phase 5 timing: " + json.dumps(timing))

    # -- the synchronising calls of a steady-state async frame
    own = sorted({site for _, sites in per_frame for site in sites
                  if site.startswith("slam/tracker.py")})
    gate(f"async: the loop makes no synchronising call of its own in a steady-state "
         f"frame (sites in slam/tracker.py: {own})", len(per_frame) > 0 and not own)
    log_sync_calls("phase 5", "async", per_frame)

    # -- RGB-D: depth rendered from the truth
    t0 = time.perf_counter()
    depths = [synth.render_depth(cam, poses[i], pts) for i in range(N_RGBD)]
    log(f"rendered {N_RGBD} depth images in {time.perf_counter() - t0:.1f} s")

    def rgbd(sysm, i, ts):
        sysm.track_rgbd(pairs[i, 0], depths[i], ts, frame_id=i)

    sysm = system()
    launches, fps, ms = drive(sysm, rgbd, N_RGBD)
    tr = sysm.trackers["SLAM"]
    total += launches
    est = tr.traj.Tcw[:int(tr.traj.size)].cpu().numpy()
    ate = ate_rmse(est, truth[:len(est)], align="se3") if len(est) == N_RGBD else float("nan")
    log(f"phase 5 RGB-D: {len(tr.telemetry)} frames, state {tr.state.name}, "
        f"{tr.telemetry[0].n_seeded} landmarks seeded, "
        f"{sum(t.kf_inserted >= 0 for t in tr.telemetry)} keyframes, ATE (se3) {ate:.6f} m, "
        f"{fps:.3f} frames/s, K1 launches {launches}")
    gate(f"RGB-D: NORMAL after {N_RGBD} frames, > {MIN_SEEDED_RGBD} landmarks seeded, "
         f"ATE (se3) < {MAX_ATE} m",
         tr.state == State.NORMAL and tr.telemetry[0].n_seeded > MIN_SEEDED_RGBD
         and ate < MAX_ATE)
    gate(f"RGB-D: K1 launches {launches} == {expected(tr)} from the telemetry",
         launches == expected(tr))

    # -- from disk: KITTI layout, 8-bit PGM, against the same 8-bit frames
    # from memory; then the trajectory file, checkpoint and resume
    n8 = N_DISK + 1
    pairs8 = np.clip(np.rint(pairs[:n8].cpu().numpy()), 0, 255).astype(np.float32)
    with tempfile.TemporaryDirectory() as root:
        synth.write_kitti_sequence(root, cam, pairs8[:N_DISK], FRAME_DT * np.arange(N_DISK),
                                   poses=truth[:N_DISK])
        ds = KittiOdometry(root, "00")
        calib = (ds.calib.fx, ds.calib.fy, ds.calib.cx, ds.calib.cy, ds.calib.bf,
                 ds.calib.width, ds.calib.height)
        disk, mem = system(), system()
        pose_optimization_cuda.launches = 0
        n_read = 0
        for f in ds.frames():
            disk.track_stereo(f.img_left, f.img_right, f.timestamp, frame_id=f.frame_id)
            n_read += 1
        disk.flush()
        total += pose_optimization_cuda.launches
        for i in range(N_DISK):
            mem.track_stereo(pairs8[i, 0], pairs8[i, 1], FRAME_DT * i, frame_id=i)
        d, m = disk.trackers["SLAM"], mem.trackers["SLAM"]
        gate(f"disk: {N_DISK} frames read back with the camera's calibration",
             n_read == N_DISK and np.allclose(
                 calib, (cam.fx, cam.fy, cam.cx, cam.cy, cam.bf, cam.width, cam.height)))
        gate("disk: poses equal to the in-memory run on the same 8-bit frames, bit for bit",
             int(d.traj.size) == N_DISK and torch.equal(d.traj.Tcw[:N_DISK], m.traj.Tcw[:N_DISK])
             and d.state == State.NORMAL)
        tum = os.path.join(root, "trajectory_tum.txt")
        ck = os.path.join(root, "checkpoint.npz")
        disk.save_trajectory_tum(tum)
        disk.save_checkpoint(ck)
        rows = np.loadtxt(tum)
        gate(f"disk: the TUM file holds {N_DISK} rows of unit quaternions",
             rows.shape == (N_DISK, 8)
             and bool(np.allclose(np.linalg.norm(rows[:, 4:], axis=1), 1.0, atol=1e-5)))
        resumed = system()
        resumed.load_checkpoint(ck)
    a = resumed.track_stereo(pairs8[N_DISK, 0], pairs8[N_DISK, 1], FRAME_DT * N_DISK)
    b = disk.track_stereo(pairs8[N_DISK, 0], pairs8[N_DISK, 1], FRAME_DT * N_DISK)
    gate("disk: a System restored from the checkpoint tracks the next frame to the same "
         "row and pose", a == b and a.frame_id == N_DISK
         and torch.equal(resumed.trackers["SLAM"].last_Tcw, d.last_Tcw))
    gate("disk: the restored System's state lives on the card",
         resumed.trackers["SLAM"].ms.lm.pos.device.type == "cuda")
    if failed:
        raise AssertionError("phase 5 failed: " + "; ".join(failed))
    return total, async_lines, timing


def phase6(cam, cfg, poses, pairs, tracked, async_lines5):
    """Loss recovery and sensor fusion through the System; see the module
    docstring. Returns the K1 launches of its gated runs."""
    import tempfile

    from hyslam_tpu_torch.core.sensordata import SensorData
    from hyslam_tpu_torch.io.config import OptimizerInfo
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam import global_ba
    from hyslam_tpu_torch.slam import mapper as mapper_mod
    from hyslam_tpu_torch.slam import sensor_fusion
    from hyslam_tpu_torch.slam import system as system_mod
    from hyslam_tpu_torch.slam.tracker import State
    from hyslam_tpu_torch.slam.tracking_params import NormalStateParams, TrackingParams
    from hyslam_tpu_torch.solver import ba, priors
    from hyslam_tpu_torch.utils import synth

    n = len(poses)
    failed = []
    total = 0

    def gate(name, ok):
        log(f"phase 6 gate {'ok' if ok else 'FAILED'}: {name}")
        if not ok:
            failed.append(name)

    def run(sysm, frames, count, sensors=None, each=None, flush_at=None):
        """count frames through track_stereo and a flush (and one before
        frame flush_at, where phase 5's clock starts): the K1 launches."""
        pose_optimization_cuda.launches = 0
        for i in range(count):
            if i == flush_at:
                sysm.flush()
            sd = None if sensors is None else SensorData(**sensors[i])
            tel = sysm.track_stereo(frames[i, 0], frames[i, 1], FRAME_DT * i, frame_id=i,
                                    sensor_data=sd)
            if each is not None:
                each(i, tel)
        sysm.flush()
        return pose_optimization_cuda.launches

    def log_rows(name, tr, idx, errs):
        err_of = dict(zip(idx.tolist(), errs))
        for t in tr.telemetry:
            e = err_of.get(t.frame_id)
            log(f"  {name} frame {t.frame_id}: {t.state} motion {t.n_motion} inliers "
                f"{t.n_inliers} kf {t.kf_inserted} seeded {t.n_seeded} "
                f"t {'-' if e is None else format(e, '.6f')} m "
                f"{ {k: v for k, v in t.mapper_stats.items() if k != 'counters'} or ''}")

    # ---- 6a: a blackout, sync then async twice
    dark = synth.blackout(pairs, *DARK)
    recovery = DARK[1]                  # the first rendered frame after it

    def check_blackout(name, tr, launches):
        tels = tr.telemetry
        states = [t.state for t in tels]
        maps = tr.ms.maps
        n_maps = int(maps.n_maps)
        idx, ate, errs = trajectory_errors(tr, poses)
        log_rows(name, tr, idx, errs)
        before = idx < DARK[0]
        ref_before = int(tr.traj.ref_kf[int(before.sum()) - 1])
        kf_after = [t for t in tels if t.frame_id > recovery and t.kf_inserted >= 0]
        worst = int(np.argmax(errs))
        log(f"phase 6a {name}: {len(tels)} rows, {len(idx)} trajectory poses, n_maps {n_maps}, "
            f"sub-map registered {bool(maps.registered[1])} tie_kf {int(maps.tie_kf[1])} "
            f"(last reference keyframe before the loss {ref_before}), "
            f"{sum(t.kf_inserted >= 0 for t in tels)} keyframes, {len(kf_after)} after the "
            f"recovery, local BA on the prior path {tr.mapper.n_prior_ba} times, ATE "
            f"{ate:.6f} m, worst frame {int(idx[worst])} at {errs[worst]:.6f} m, K1 launches "
            f"{launches}, expected {expected_launches(tr)}")
        gate(f"6a {name}: REINITIALIZE entered, a row carries >REINIT_OK at frame {recovery}",
             any(s.startswith("REINITIALIZE") for s in states)
             and states[recovery] == "REINITIALIZE>REINIT_OK"
             and sum(">REINIT_OK" in s for s in states) == 1)
        gate(f"6a {name}: no sub-map left over from the blank frames (n_maps == 2)",
             n_maps == 2)
        gate(f"6a {name}: the sub-map is registered, tie_kf is the last reference keyframe "
             "before the loss", bool(maps.registered[1]) and int(maps.parent[1]) == 0
             and int(maps.tie_kf[1]) == ref_before >= 0)
        gate(f"6a {name}: {len(tels)} rows in frame order; every frame from {recovery} to "
             f"{n - 1} tracked, state NORMAL",
             [t.frame_id for t in tels] == list(range(n)) and tr.state == State.NORMAL
             and all(tracked_row(t) for t in tels[recovery + 1:])
             and list(idx) == [i for i in range(n) if not DARK[0] <= i < DARK[1]])
        gate(f"6a {name}: local BA took the prior path on each of the {len(kf_after)} "
             "keyframes after the recovery, on none before",
             tr.mapper.n_prior_ba == len(kf_after) > 0 and tr._has_priors)
        gate(f"6a {name}: K1 launches {launches} == {expected_launches(tr)} from the telemetry",
             launches == expected_launches(tr))
        gate(f"6a {name}: ATE < {MAX_ATE_BLACKOUT} m and every tracked frame < "
             f"{MAX_T_BLACKOUT} m", ate < MAX_ATE_BLACKOUT and max(errs) < MAX_T_BLACKOUT)

    slot_priors = mapper_mod._slot_priors

    def spying_on_slot_priors(seen, keep_first):
        """mapper._slot_priors recording, per call, whether a tiepoint edge
        lies in the window, and holding one call's inputs (the first or the
        last) as a BA problem for 6d."""
        def spy(ms, sensors, opt_info, kf_of_slot, slot_used):
            pr = slot_priors(ms, sensors, opt_info, kf_of_slot, slot_used)
            seen["tie"].append(pr is not None and bool(pr.tie_valid.any()))
            if not (keep_first and "ms" in seen):
                seen.update(ms=ms, kf_id=int(ms.next_kf) - 1, sensors=sensors,
                            opt_info=opt_info)
            return pr
        return spy

    def kf_errors(ms, map_id):
        """Translation error against the truth of each live keyframe of a map."""
        ks = torch.nonzero(ms.kf.valid & ~ms.kf.bad & (ms.kf.map_id == map_id))[:, 0]
        T, fids = ms.kf.Tcw[ks].cpu().numpy(), ms.kf.frame_id[ks].tolist()
        return [synth.pose_error(T[j], poses[f])[1] for j, f in enumerate(fids)]

    # the sync run is 7d's tiepoint run: periodic global BA, spied on
    gba_log = []

    def spied_build(ms, cam_, tie_active=False, **kw):
        prob = build_global_problem(ms, cam_, tie_active=tie_active, **kw)
        gba_log[-1].update(tie_active=tie_active, free_origins=torch.nonzero(
            ms.kf.origin & ms.kf.valid & ~prob.kf_fixed)[:, 0].tolist())
        return prob

    def spied_run(ms, *a, **kw):
        gba_log.append({"before": ms})
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run_global_ba(ms, *a, **kw)
        torch.cuda.synchronize()
        gba_log[-1].update(after=out[0], cost=out[1], ms=1e3 * (time.perf_counter() - t))
        return out

    sysm = make_system(cam, cfg, optimizer=OptimizerInfo(realtime=False,
                                                         gba_interval=GBA_EVERY_6A))
    tr = sysm.trackers["SLAM"]
    counted, counted_plain = [], []
    held = {"tie": []}
    mapper_ms_a = time_integrate(tr)
    mapper_mod._slot_priors = spying_on_slot_priors(held, keep_first=True)
    build_global_problem, run_global_ba = global_ba.build_global_problem, system_mod.run_global_ba
    global_ba.build_global_problem, system_mod.run_global_ba = spied_build, spied_run
    try:
        pose_optimization_cuda.launches = 0
        for i in range(n):
            tels = []
            feed = lambda: tels.append(
                sysm.track_stereo(dark[i, 0], dark[i, 1], FRAME_DT * i, frame_id=i))
            if N_WARM <= i < N_SYNC_COUNT:       # before the blackout: no priors
                sites = sync_sites(feed)
                counted_plain.append((tels[0].kf_inserted >= 0, sites))
            elif i >= n - N_PRIOR_SYNC_COUNT:
                counted.append(sync_sites(feed))
            else:
                feed()
        sysm.flush()
        launches = pose_optimization_cuda.launches
    finally:
        mapper_mod._slot_priors = slot_priors
        global_ba.build_global_problem, system_mod.run_global_ba = build_global_problem, \
            run_global_ba
    total += launches
    check_blackout("sync", tr, launches)
    log(f"phase 6a sync: the tiepoint edge lay in local BA's window on {sum(held['tie'])} of "
        f"{len(held['tie'])} prior-path jobs")
    gate("6a sync: every prior-path job asked for the window's priors",
         len(held["tie"]) == tr.mapper.n_prior_ba)
    log_sync_calls("phase 6a (before the blackout, no priors)", "sync", counted_plain)

    # ---- 7d, the tiepoint run: 6a's sync run with periodic global BA
    origin1 = [k for k in torch.nonzero(tr.ms.kf.origin & tr.ms.kf.valid)[:, 0].tolist()
               if int(tr.ms.kf.map_id[k]) == 1]
    tied = []
    for g in gba_log:
        b, a = g["before"], g["after"]
        moved = (float((a.kf.Tcw[origin1[0]] - b.kf.Tcw[origin1[0]]).abs().max())
                 if origin1 else 0.0)
        e = {m: (kf_errors(b, m), kf_errors(a, m)) for m in (0, 1)}
        log(f"phase 7d tiepoint run: global BA with {int(b.next_kf)} keyframes, tiepoint "
            f"priors active {g['tie_active']}, free origins {g['free_origins']}, cost "
            f"{g['cost']:.4f}, {g['ms']:.1f} ms; the sub-map's origin (keyframe "
            f"{origin1[0] if origin1 else None}) moved by max|dT| {moved:.3e}; keyframe "
            "translation errors against the truth, mean / max m, before -> after: " + "; ".join(
                f"map {m}: {np.mean(x):.6f} / {max(x):.6f} -> {np.mean(y):.6f} / {max(y):.6f}"
                for m, (x, y) in e.items() if x))
        if g["tie_active"] and origin1 and origin1[0] in g["free_origins"] and moved > 0:
            tied.append(g)
    gate(f"7d tiepoint run: {len(gba_log)} global BA (every {GBA_EVERY_6A} keyframes), "
         f"{len(tied)} with the tiepoint edge active, the sub-map's origin free and moved, "
         "a finite cost", len(tied) >= 1 and all(np.isfinite(g["cost"]) for g in gba_log))

    sysm = make_system(cam, cfg, async_tracking=True, commit_lag=2)
    launches = run(sysm, dark, n, flush_at=N_WARM)
    tr = sysm.trackers["SLAM"]
    total += launches
    check_blackout("async", tr, launches)
    lines = frame_lines(tr)
    gate("6a async: the loss shows at commit time (NORMAL>LOST on the first blank frame)",
         tr.telemetry[DARK[0]].state == "NORMAL>LOST")
    first_diff = [next((i for i, (a, b) in enumerate(zip(mine, theirs)) if a != b), None)
                  for mine, theirs in zip(lines, async_lines5)]
    log(f"phase 6a async against phase 5's async run: first differing row {first_diff[0]}, "
        f"first differing pose {first_diff[1]}"
        + "".join(f"\n  {x}" for k in (0, 1) if first_diff[k] is not None
                  for x in (lines[k][first_diff[k]], async_lines5[k][first_diff[k]])))
    gate(f"6a async: up to the blackout the lines are phase 5's async run's ({DARK[0]} rows "
         "and poses)", lines[0][:DARK[0]] == async_lines5[0][:DARK[0]]
         and lines[1][:DARK[0]] == async_lines5[1][:DARK[0]])

    # ---- 6b: forced loss every RESET_INTERVAL frames, from the config
    sysm = make_system(cam, cfg, camera_kw=dict(tracking=TrackingParams(
        normal=NormalStateParams(reset_interval=RESET_INTERVAL))))
    launches = run(sysm, pairs, N_FORCED)
    total += launches
    tr = sysm.trackers["SLAM"]
    idx, ate, errs = trajectory_errors(tr, poses)
    log_rows("6b", tr, idx, errs)
    n_maps = int(tr.ms.maps.n_maps)
    forced = [t.frame_id for t in tr.telemetry if "FORCED_LOSS" in t.state]
    in_traj = [t.frame_id for t in tr.telemetry
               if tracked_row(t) or t.state in ("INITIALIZE", "REINITIALIZE>REINIT_OK")]
    log(f"phase 6b: reset_interval {tr.reset_interval}, forced losses at frames {forced}, "
        f"n_maps {n_maps}, registered {tr.ms.maps.registered[:n_maps].tolist()}, tie_kf "
        f"{tr.ms.maps.tie_kf[:n_maps].tolist()}, state {tr.state.name}, {len(idx)} trajectory "
        f"poses, ATE {ate:.6f} m, worst {max(errs):.6f} m, local BA on the prior path "
        f"{tr.mapper.n_prior_ba} times, K1 launches {launches}")
    gate(f"6b: reset_interval {RESET_INTERVAL} from the config forces a loss every "
         f"{RESET_INTERVAL} frames", tr.reset_interval == RESET_INTERVAL
         and forced == list(range(RESET_INTERVAL - 1, N_FORCED, RESET_INTERVAL)))
    gate("6b: at least 3 maps, every sub-map registered with a tiepoint",
         n_maps >= 3 and bool(tr.ms.maps.registered[1:n_maps].all())
         and bool((tr.ms.maps.tie_kf[1:n_maps] >= 0).all()))
    gate("6b: final state NORMAL or POSTINIT", tr.state in (State.NORMAL, State.POSTINIT))
    gate("6b: a trajectory row for every tracked frame, all finite",
         list(idx) == in_traj and len(idx) == N_FORCED - len(forced) and np.isfinite(ate))
    gate(f"6b: K1 launches {launches} == {expected_launches(tr)} from the telemetry",
         launches == expected_launches(tr))

    # ---- 6c: sensor readings on every frame
    opt = OptimizerInfo(**SENSOR_WEIGHTS)
    sensors = synth.render_sensors(poses, seed=0, gps_sigma=GPS_SIGMA)
    sysm = make_system(cam, cfg, optimizer=opt)
    tr = sysm.trackers["SLAM"]
    active_from, resume = {}, {}
    mapper_ms_c = time_integrate(tr)

    def each(i, tel):
        n_fix = int(tr.sensors.gps_valid.sum())
        if n_fix <= sensor_fusion.MIN_GPS_FIXES + 1 and n_fix not in active_from:
            pr = sensor_fusion.build_pose_priors(tr.ms, tr.sensors, opt)
            active_from[n_fix] = 0 if pr is None else int(pr.gps_valid.sum())
        if i == CHECKPOINT_FRAME:
            resume.update(path=os.path.join(tmp, "sensors.npz"),
                          sensors=[t.clone() for t in tr.sensors])
            sysm.save_checkpoint(resume["path"])
        if i == CHECKPOINT_FRAME + 1:
            resume.update(tel=tel, Tcw=tr.last_Tcw.clone())

    held_c = {"tie": []}
    mapper_mod._slot_priors = spying_on_slot_priors(held_c, keep_first=False)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            launches = run(sysm, pairs, n, sensors, each)
            resumed = make_system(cam, cfg, optimizer=opt)
            resumed.load_checkpoint(resume["path"])
    finally:
        mapper_mod._slot_priors = slot_priors
    total += launches
    rt = resumed.trackers["SLAM"]
    arena_ok = all(torch.equal(a, b) for a, b in zip(rt.sensors, resume["sensors"]))
    i = CHECKPOINT_FRAME + 1
    again = resumed.track_stereo(pairs[i, 0], pairs[i, 1], FRAME_DT * i,
                                 sensor_data=SensorData(**sensors[i]))
    idx, ate, errs = trajectory_errors(tr, poses)
    log_rows("6c", tr, idx, errs)
    pr = sensor_fusion.build_pose_priors(tr.ms, tr.sensors, opt)
    cost = float(priors.prior_cost(tr.ms.kf.Tcw, pr))
    n_kf = sum(t.kf_inserted >= 0 for t in tr.telemetry)
    log(f"phase 6c: weights {SENSOR_WEIGHTS}, GPS sigma {GPS_SIGMA}: {n_kf} keyframes, "
        f"{int(tr.sensors.gps_valid.sum())} with a fix; GPS priors by fixes in the arena "
        f"{active_from}; prior cost over the arena {cost:.6f} (GPS rows "
        f"{int(pr.gps_valid.sum())}, IMU {int(pr.imu_valid.sum())}, depth "
        f"{int(pr.depth_valid.sum())}); ATE {ate:.6f} m, worst {max(errs):.6f} m; without "
        f"sensors (phase 4) ATE {tracked['ate']:.6f} m; local BA on the prior path "
        f"{tr.mapper.n_prior_ba} times; K1 launches {launches}")
    gate(f"6c: every frame tracked, state NORMAL, a reading on each of the {n_kf} keyframes",
         tr.state == State.NORMAL and list(idx) == list(range(n))
         and int(tr.sensors.gps_valid.sum()) == int(tr.sensors.depth_valid.sum()) == n_kf)
    gate(f"6c: the GPS prior is active from {sensor_fusion.MIN_GPS_FIXES} keyframes with a "
         "fix on, not before",
         all((k >= sensor_fusion.MIN_GPS_FIXES) == (v > 0) for k, v in active_from.items())
         and max(active_from) > sensor_fusion.MIN_GPS_FIXES > min(active_from))
    gate("6c: the prior cost is finite and every local BA took the prior path",
         np.isfinite(cost) and tr.mapper.n_prior_ba == sum(
             "ba_cost" in t.mapper_stats for t in tr.telemetry) > 0)
    gate(f"6c: ATE {ate:.6f} m no more than {MAX_ATE_OVER_NO_SENSORS} m above the run "
         f"without sensors ({tracked['ate']:.6f} m), every frame < {MAX_T_TRACK} m",
         ate < tracked["ate"] + MAX_ATE_OVER_NO_SENSORS and max(errs) < MAX_T_TRACK)
    gate(f"6c: K1 launches {launches} == {expected_launches(tr)} from the telemetry",
         launches == expected_launches(tr))
    gate(f"6c: the checkpoint of frame {CHECKPOINT_FRAME} resumes with its sensor arena to "
         "the uninterrupted run's next row and pose",
         arena_ok and rt._has_priors and again == resume["tel"]
         and torch.equal(rt.last_Tcw, resume["Tcw"]))

    # ms of build_pose_priors (host code over fetched arrays)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        sensor_fusion.build_pose_priors(tr.ms, tr.sensors, opt)
    torch.cuda.synchronize()
    build_ms = 1e2 * (time.perf_counter() - t)

    # ---- 6d: CG against dense on the window the system built for 6c's last
    # keyframe: the first step, N_SHORT_ITERS robust iterations, then the
    # whole two-phase schedule
    def solve(prob, solver, n_iters=None):
        """n_iters robust iterations, or the whole two-phase schedule."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        if n_iters is None:
            res = ba.local_ba_two_phase(prob, chunk=256, solver=solver)
        else:
            res = ba.bundle_adjustment(prob, n_iters=n_iters, huber=True, chunk=256,
                                       solver=solver)
        torch.cuda.synchronize()
        return res, 1e3 * (time.perf_counter() - t)

    def apart(cg, dense):
        return (abs(float(cg.cost) - float(dense.cost)) / float(dense.cost),
                float((cg.kf_Tcw - dense.kf_Tcw).abs().max()))

    h = held_c
    prob = pr = None
    if "ms" in h:
        prob, kf_of_slot, slot_used, *_ = mapper_mod._gather_local_ba(
            h["ms"], h["kf_id"], cam, 16, 2048, cfg.n_levels, cfg.scale_factor)
        pr = slot_priors(h["ms"], h["sensors"], h["opt_info"], kf_of_slot, slot_used)
        prob = prob._replace(priors=pr)
    gate("6d: a local-BA problem with active GPS, IMU and depth priors was taken from 6c's "
         "map", pr is not None and bool(pr.gps_valid.any() and pr.imu_valid.any()
                                        and pr.depth_valid.any()))
    if pr is not None:
        log(f"phase 6d sensors: local BA of keyframe {h['kf_id']} ({int(slot_used.sum())} "
            f"slots, {int((~prob.kf_fixed).sum())} free, {int(prob.lm_valid.sum())} landmarks; "
            f"prior rows: tie {int(pr.tie_valid.sum())} GPS {int(pr.gps_valid.sum())} IMU "
            f"{int(pr.imu_valid.sum())} depth {int(pr.depth_valid.sum())}, prior cost at the "
            f"start {float(priors.prior_cost(prob.kf_Tcw, pr)):.6f})")
        d_step, step = first_step_apart(prob)
        log(f"phase 6d sensors: the first linearization's pose step: max|d_cg - d_dense| "
            f"{d_step:.3e} of max|d_dense| {step:.3e}")
        gate(f"6d: the CG pose step within {CG_STEP_RTOL} relative of the dense one",
             step > 0 and d_step < CG_STEP_RTOL * step)
        (dense, ms_d), (cg, ms_c) = solve(prob, "dense", N_SHORT_ITERS), solve(
            prob, "cg", N_SHORT_ITERS)
        d_cost, d_pose = apart(cg, dense)
        log(f"phase 6d sensors: {N_SHORT_ITERS} robust iterations: cost dense "
            f"{float(dense.cost):.4f} cg {float(cg.cost):.4f} (relative {d_cost:.3e}), max|dT| cg "
            f"vs dense {d_pose:.3e} (dense moved the poses by up to "
            f"{float((dense.kf_Tcw - prob.kf_Tcw).abs().max()):.3e}); ms a solve: "
            + json.dumps({"dense": ms_d, "cg": ms_c}))
        gate(f"6d: after {N_SHORT_ITERS} robust iterations CG and dense agree: cost "
             f"within {CG_COST_RTOL} relative, poses within {CG_POSE_ATOL}",
             d_cost < CG_COST_RTOL and d_pose < CG_POSE_ATOL
             and bool(torch.isfinite(cg.kf_Tcw).all()))
        (dense, ms_d), (cg, ms_c) = solve(prob, "dense"), solve(prob, "cg")
        d_cost, d_pose = apart(cg, dense)
        log(f"phase 6d sensors: the whole two-phase schedule: cost dense "
            f"{float(dense.cost):.4f} cg {float(cg.cost):.4f} (relative {d_cost:.3e}), max|dT| "
            f"cg vs dense {d_pose:.3e}, max|dX| {float((cg.lm_pos - dense.lm_pos).abs().max()):.3e}"
            f" (dense moved the poses by up to "
            f"{float((dense.kf_Tcw - prob.kf_Tcw).abs().max()):.3e}); ms a "
            "two-phase solve: " + json.dumps({"dense": ms_d, "cg": ms_c}))
        gate(f"6d: after the whole schedule CG's cost is finite and no more than "
             f"{CG_WHOLE_COST_RTOL} relative above the dense solve's",
             bool(torch.isfinite(cg.kf_Tcw).all()) and np.isfinite(float(cg.cost))
             and float(cg.cost) < float(dense.cost) * (1 + CG_WHOLE_COST_RTOL))

    # ---- printed, not gated: what the prior path costs. A mapper call grows
    # dearer as the map fills, so the two kinds are read over the same
    # keyframes: 6a's sync run before the blackout (no priors) against 6c's
    # (sensor priors on every local BA), both from the 4th mapper call on
    def med(rows, lo, hi, prior):
        v = [ms for k, ms, p in rows if lo <= k < hi and p == prior]
        return (statistics.median(v) if v else None), len(v)

    log("phase 6 timing: " + json.dumps({
        f"median_ms_integrate_keyframes_4_to_{DARK[0] - 1}_without_priors_6a":
            med(mapper_ms_a, 4, DARK[0], False),
        f"median_ms_integrate_keyframes_4_to_{DARK[0] - 1}_with_sensor_priors_6c":
            med(mapper_ms_c, 4, DARK[0], True),
        "median_ms_integrate_after_the_recovery_prior_path_no_active_prior_6a":
            med(mapper_ms_a, DARK[0], n, True),
        f"median_ms_integrate_keyframes_{DARK[0]}_on_with_sensor_priors_6c":
            med(mapper_ms_c, DARK[0], n, True),
        "ms_build_pose_priors": build_ms,
    }))
    rows = counted
    rep = max(rows, key=lambda s: sum(s.values()))
    log(f"phase 6 synchronising calls a sync keyframe frame on the prior path (6a, the last "
        f"{len(rows)} frames): " + json.dumps({
            "median": statistics.median(sum(s.values()) for s in rows),
            "max": sum(rep.values()),
            "sites_new_with_priors": {k: v for k, v in rep.items() if k.startswith(
                ("slam/sensor_fusion.py", "solver/priors.py", "core/sensordata.py"))
                or k.startswith("slam/mapper.py")},
        }))
    if failed:
        raise AssertionError("phase 6 failed: " + "; ".join(failed))
    return total


def sim3_errors(est, truth):
    """Per-row camera-centre error after a sim3 alignment of est to truth:
    (ATE, errors)."""
    from hyslam_tpu_torch.geometry import sim3
    from hyslam_tpu_torch.geometry.horn import horn_sim3
    from hyslam_tpu_torch.io.evaluate import ate_rmse, camera_centers

    pe = torch.from_numpy(camera_centers(est).astype(np.float64))
    pg = camera_centers(truth).astype(np.float64)
    d = np.linalg.norm(sim3.apply(horn_sim3(pe, torch.from_numpy(pg)), pe).numpy() - pg,
                       axis=-1)
    return ate_rmse(est, truth, align="sim3"), d


def phase7(cam, cfg, poses, pairs):
    """The monocular camera and global BA at K_BIG; see the module
    docstring. Returns the K1 launches of its gated runs."""
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.estimators import pnp
    from hyslam_tpu_torch.io.config import OptimizerInfo
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam import global_ba
    from hyslam_tpu_torch.slam import system as system_mod
    from hyslam_tpu_torch.slam.tracker import State
    from hyslam_tpu_torch.solver import ba
    from hyslam_tpu_torch.solver.pose_opt import pose_optimization, pose_optimization_fast
    from hyslam_tpu_torch.utils import synth

    failed = []
    total = 0

    def gate(name, ok):
        log(f"phase 7 gate {'ok' if ok else 'FAILED'}: {name}")
        if not ok:
            failed.append(name)

    # ---- 7a / 7b: the left images through a monocular System, sync and async
    mono = synth.blackout(pairs[:N_MONO, 0], *DARK_MONO)
    held = {}

    def holding_refinement(*args):
        held["pnp"] = args
        return pose_optimization_fast(*args)

    def run_mono(name, **kw):
        sysm = make_system(cam, cfg, camera_kw=dict(mono=True, bf=0.0), **kw)
        tr = sysm.trackers["SLAM"]
        pnp.pose_optimization_fast = holding_refinement
        try:
            t = time.perf_counter()
            pose_optimization_cuda.launches = 0
            for i in range(N_MONO):
                sysm.track_monocular(mono[i], FRAME_DT * i, frame_id=i)
            sysm.flush()
            launches = pose_optimization_cuda.launches
            secs = time.perf_counter() - t
        finally:
            pnp.pose_optimization_fast = pose_optimization_fast
        tels = tr.telemetry
        states = [t.state for t in tels]
        size = int(tr.traj.size)
        est = tr.traj.Tcw[:size].cpu().numpy()
        idx = np.rint(tr.traj.t[:size].cpu().numpy() / FRAME_DT).astype(int)
        ate, errs = sim3_errors(est, np.stack(poses)[idx]) if size > 2 else (float("nan"), [0])
        init = next((t.frame_id for t in tels if t.state == "INITIALIZE" and t.kf_inserted >= 0),
                    None)
        reloc = [t.frame_id for t in tels if ">RELOC_OK" in t.state]
        lost = [i for i in range(init or 0, N_MONO) if i not in set(idx.tolist())]
        n_kf = sum(t.kf_inserted >= 0 for t in tels)
        worst = int(np.argmax(errs))
        for t in tels:
            log(f"  7{name} frame {t.frame_id}: {t.state} motion {t.n_motion} inliers "
                f"{t.n_inliers} local {t.n_local} kf {t.kf_inserted}")
        log(f"phase 7{name} monocular {'async' if name == 'b' else 'sync'}: initialized at frame "
            f"{init}, {n_kf} keyframes, {size} trajectory poses, frames without a pose after "
            f"the initialization {lost}, >RELOC_OK at frames {reloc}, relocalization log "
            f"{tr.reloc_log}, ATE (sim3) {ate:.6f} m, worst frame {int(idx[worst])} at "
            f"{errs[worst]:.6f} m, K1 launches {launches}, expected {expected_launches(tr)}, "
            f"{secs:.1f} s")
        after = [t for t in tels if t.frame_id > (reloc[0] if reloc else N_MONO)]
        gate(f"7{name}: initialized before the blackout, at least {MIN_KEYFRAMES} keyframes",
             init is not None and init < DARK_MONO[0] and n_kf >= MIN_KEYFRAMES)
        gate(f"7{name}: {N_MONO} rows in frame order, one >RELOC_OK within {MAX_RELOC_DELAY} "
             "frames of the blackout's end, every later frame tracked, state NORMAL",
             [t.frame_id for t in tels] == list(range(N_MONO)) and len(reloc) == 1
             and DARK_MONO[1] <= reloc[0] < DARK_MONO[1] + MAX_RELOC_DELAY
             and all(tracked_row(t) for t in after) and tr.state == State.NORMAL)
        gate(f"7{name}: ATE (sim3) < {MAX_ATE_MONO} m and every frame < {MAX_T_MONO} m",
             ate < MAX_ATE_MONO and max(errs) < MAX_T_MONO)
        gate(f"7{name}: K1 launches {launches} == {expected_launches(tr)} from the telemetry and "
             "the relocalization log", launches == expected_launches(tr) and launches > 0)
        return sysm, tr, launches, states

    sysm_a, tr_a, launches, _ = run_mono("a")
    total += launches
    problems = {"mono tracking (7a's last frame, its local-map solve)": tr_a.last_result.problem,
                "relocalization PnP refinement (7a)": held.get("pnp")}
    _, tr_b, launches, states_b = run_mono("b", async_tracking=True, commit_lag=2)
    total += launches
    gate("7b: the loss shows at commit time (NORMAL>LOST on the first blank frame)",
         states_b[DARK_MONO[0]] == "NORMAL>LOST")

    # ---- 7c: K1 against the plain solver on 7a's problems
    for name, prob in problems.items():
        if prob is None:
            gate(f"7c {name}: the problem was held", False)
            continue
        stereo = prob[-1]
        k, q = pose_optimization_fast(*prob), pose_optimization(*prob)
        err = float((k.Tcw - q.Tcw).abs().max())
        d_inl = abs(int(k.num_inliers) - int(q.num_inliers))
        ms_k = cuda_ms(lambda: pose_optimization_fast(*prob), N_TIMED)
        ms_q = cuda_ms(lambda: pose_optimization(*prob), 5)
        log(f"phase 7c {name}: {int(prob[-2].sum())} valid of {prob[-2].shape[0]} "
            f"observations, stereo {int(stereo.sum())}; kernel vs plain max|dT| {err:.3e}, "
            f"inliers {int(k.num_inliers)} vs {int(q.num_inliers)}; ms a call "
            + json.dumps({"kernel": ms_k, "plain": ms_q}))
        gate(f"7c {name}: no stereo observation, kernel within {MAX_ABS_DT_PROBLEM} and "
             f"{MAX_D_INLIERS_PROBLEM} inlier of the plain solver",
             not bool(stereo.any()) and err < MAX_ABS_DT_PROBLEM
             and d_inl <= MAX_D_INLIERS_PROBLEM)

    # ---- 7d: global BA at K_BIG through the System: solver="auto" is CG
    solves = {"cg": 0, "dense": 0}
    real = {"cg": ba._solve_poses_cg, "dense": ba._solve_poses}
    gba = []

    def counting(kind):
        def solve(*a, **kw):
            solves[kind] += 1
            return real[kind](*a, **kw)
        return solve

    run_global_ba = system_mod.run_global_ba

    def spied_run(ms, *a, **kw):
        kw = {**kw, "n_iters": N_ITERS_BIG}
        ba._solve_poses_cg, ba._solve_poses = counting("cg"), counting("dense")
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            out = run_global_ba(ms, *a, **kw)
            torch.cuda.synchronize()
        finally:
            ba._solve_poses_cg, ba._solve_poses = real["cg"], real["dense"]
        gba.append(dict(ms=ms, args=a, kw=kw, cost=out[1],
                        t=1e3 * (time.perf_counter() - t), solves=dict(solves)))
        return out

    caps = (K_BIG,) + TRACK_CAPS[1:]
    sysm = make_system(cam, cfg, caps=caps, optimizer=OptimizerInfo(realtime=False,
                                                                    gba_interval=N_BIG))
    tr = sysm.trackers["SLAM"]
    mapper_ms = time_integrate(tr)
    system_mod.run_global_ba = spied_run
    try:
        pose_optimization_cuda.launches = 0
        for i in range(N_BIG):
            sysm.track_stereo(pairs[i, 0], pairs[i, 1], FRAME_DT * i, frame_id=i)
        sysm.flush()
        launches = pose_optimization_cuda.launches
    finally:
        system_mod.run_global_ba = run_global_ba
    total += launches
    n_kf = sum(t.kf_inserted >= 0 for t in tr.telemetry)
    gate(f"7d K={K_BIG}: {N_BIG} frames tracked, K1 launches as the telemetry calls for, one "
         "global BA, by CG solves only",
         tr.state == State.NORMAL and launches == expected_launches(tr) and len(gba) == 1
         and gba[0]["solves"]["cg"] > 0 and gba[0]["solves"]["dense"] == 0)
    if gba:
        g = gba[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, cost_dense = global_ba.run_global_ba(g["ms"], *g["args"], solver="dense", **g["kw"])
        torch.cuda.synchronize()
        ms_dense = 1e3 * (time.perf_counter() - t)
        prob = global_ba.build_global_problem(g["ms"], sysm.cameras["SLAM"],
                                              n_levels=cfg.n_levels,
                                              scale_factor=cfg.scale_factor)
        d_step, step = first_step_apart(prob, chunk=512)
        ms_int = [m for _, m, _ in mapper_ms[3:]]
        log(f"phase 7d K={K_BIG}: global BA over {n_kf} keyframes, "
            f"{int(prob.lm_valid.sum())} landmarks, {int((~prob.kf_fixed).sum())} free poses: "
            f"the first linearization's pose step max|d_cg - d_dense| {d_step:.3e} of "
            f"max|d_dense| {step:.3e}; cost cg {g['cost']:.4f} dense {cost_dense:.4f} (relative "
            f"{(g['cost'] - cost_dense) / cost_dense:.3e}); {g['solves']['cg']} CG solves")
        log("phase 7d timing: " + json.dumps({
            "ms_global_ba_cg": g["t"], "ms_global_ba_dense": ms_dense,
            f"median_ms_integrate_keyframe_K{K_BIG}": statistics.median(ms_int) if ms_int
            else None, "mapper_calls_timed": len(ms_int)}))
        gate(f"7d K={K_BIG}: the CG pose step within {CG_STEP_RTOL} relative of the dense one",
             step > 0 and d_step < CG_STEP_RTOL * step)
        gate(f"7d K={K_BIG}: after the whole schedule CG's cost is finite and no more than "
             f"{CG_WHOLE_COST_RTOL} relative above the dense global BA's",
             np.isfinite(g["cost"]) and g["cost"] < cost_dense * (1 + CG_WHOLE_COST_RTOL))
    if failed:
        raise AssertionError("phase 7 failed: " + "; ".join(failed))
    return total


def loop_circuit(cam, dev):
    """Phase 8's circuit: (poses [n] numpy, stereo pairs [n,2,H,W] on dev
    with frames DARK8 flat)."""
    from hyslam_tpu_torch.utils import synth

    delta = synth.se3_exp([0.0, 2 * np.pi / N_CIRCLE, 0.0, 0.0, 0.0, -STEP8])
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(N_CIRCLE + N_REVISIT - 1):
        poses.append((delta @ poses[-1]).astype(np.float32))
    rng = np.random.default_rng(8)
    centres = [-(T[:3, :3].T @ T[:3, 3]) for T in poses[:N_CIRCLE]]
    pts = np.concatenate([c + rng.uniform([-6, -4, -6], [6, 4, 6], (POINTS_PER_CENTRE, 3))
                          for c in centres]).astype(np.float32)
    t0 = time.perf_counter()
    pairs = synth.blackout(np.stack([synth.render_stereo_pair(cam, T, pts) for T in poses]),
                           *DARK8)
    log(f"phase 8: rendered {len(poses)} stereo pairs of the circuit ({len(pts)} points) in "
        f"{time.perf_counter() - t0:.1f} s")
    return poses, torch.from_numpy(pairs).to(dev)


def phase8(cam, cfg, dev):
    """Loop closing through the System; see the module docstring. Returns
    the K1 launches of its gated runs."""
    from hyslam_tpu_torch.core import mapstate as M
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam import loop_closing
    from hyslam_tpu_torch.utils import synth

    poses, pairs = loop_circuit(cam, dev)
    n = len(poses)
    # the revisit begins where the camera comes back within MAX_LOOP_GAP_M
    # of the circuit's start (the circle's last frames run over it)
    centres = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in poses])
    revisit = next(i for i in range(N_CIRCLE // 2, n)
                   if np.linalg.norm(centres[i] - centres[0]) <= MAX_LOOP_GAP_M)
    caps = (K8,) + TRACK_CAPS[1:]
    failed = []
    total = 0

    def gate(name, ok):
        log(f"phase 8 gate {'ok' if ok else 'FAILED'}: {name}")
        if not ok:
            failed.append(name)

    def kf_errors(ms, map_id):
        ks = torch.nonzero(ms.kf.valid & ~ms.kf.bad & (ms.kf.map_id == map_id))[:, 0]
        T, fids = ms.kf.Tcw[ks].cpu().numpy(), ms.kf.frame_id[ks].tolist()
        return [synth.pose_error(T[j], poses[f])[1] for j, f in enumerate(fids)]

    def run(name, **kw):
        """The circuit through a System with loop closing on (the config's
        default) and the shipped vocabulary (the default); every keyframe's
        loop maintenance timed, the closures' stages timed, the sub-map's
        keyframe errors read before and after each closure."""
        cc_kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                     height=cam.height, bf=cam.bf, th_depth=cam.th_depth, extractor=cfg)
        from hyslam_tpu_torch.core.mapstate import MapCaps
        from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
        from hyslam_tpu_torch.slam.system import System

        sysm = System(SystemConfig(cameras={"SLAM": CameraConfig(**cc_kw)},
                                   caps=MapCaps(*caps), **kw))
        tr = sysm.trackers["SLAM"]
        rec = dict(maint=[], closures=[], stages=[], sync=[], built=None)
        close_loop, get_closer = sysm._close_loop, sysm._get_loop_closer
        real = {k: getattr(loop_closing.LoopCloser, k) for k in ("compute_sim3", "correct")}
        frame = {"i": 0}

        def timed(fn, *a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t)

        def stage(key):
            def wrapped(self, *a, **k):
                out, ms_ = timed(real[key], self, *a, **k)
                rec["stages"].append((key, ms_, out[0] if key == "compute_sim3" else out[1]))
                if key == "compute_sim3" and out[0]:
                    rec["stages"].append(("g_cl", [round(x, 5) for x in out[1].tolist()], True))
                if key == "correct":    # the sub-map keyframes' mean error after it
                    rec["stages"].append(("sub-map error after correct, m",
                                          float(np.mean(kf_errors(out[0], 1) or [0])), True))
                return out
            return wrapped

        def spied_close(camera, closer, ms, kf_id, live, sensors=None):
            before = {m: kf_errors(ms, m) for m in (0, 1)}
            rec["stages"] = []
            counted = N_WARM <= frame["i"] < N_SYNC_COUNT + 10
            sites = {}
            if counted:
                def go():
                    sites["out"] = timed(close_loop, camera, closer, ms, kf_id, live, sensors)
                rec["sync"].append(sync_sites(go))
                (out, closed), ms_ = sites["out"]
            else:
                (out, closed), ms_ = timed(close_loop, camera, closer, ms, kf_id, live, sensors)
            if closed:
                rec["closures"].append(dict(
                    kf=kf_id, frame=int(out.kf.frame_id[kf_id]), ms=ms_,
                    stages=list(rec["stages"]),
                    before=before, after={m: kf_errors(out, m) for m in (0, 1)}))
            else:
                rec["maint"].append(ms_)
            return out, closed

        def spied_get(camera, ms):
            if camera in sysm.loop_closers:
                return get_closer(camera, ms)
            out, ms_ = timed(get_closer, camera, ms)
            if out is not None:
                rec["built"] = (frame["i"], ms_)
            return out

        global_ba = sysm._global_ba

        def spied_gba(camera, ms, *a, **k):
            out, ms_ = timed(global_ba, camera, ms, *a, **k)
            rec["stages"].append(("global_ba", ms_, True))
            return out

        sysm._close_loop, sysm._get_loop_closer = spied_close, spied_get
        sysm._global_ba = spied_gba
        loop_closing.LoopCloser.compute_sim3 = stage("compute_sim3")
        loop_closing.LoopCloser.correct = stage("correct")
        T_pert = torch.from_numpy(synth.se3_exp(PERTURB8).astype(np.float32)).to(dev)
        nudged = None
        try:
            pose_optimization_cuda.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(n):
                frame["i"] = i
                tel = sysm.track_stereo(pairs[i, 0], pairs[i, 1], FRAME_DT * i, frame_id=i)
                state = tel.state if tel is not None else (
                    tr.telemetry[-1].state if tr.telemetry else "")
                if nudged is None and ">REINIT_OK" in state:
                    tr.drain_pending()
                    tr._sync_dev_to_host()
                    tr.ms = M.refresh_tiepoints(M.apply_transform_to_map(
                        tr.ms, int(tr.ms.maps.active), T_pert))
                    # the rows tracked in the sub-map follow it, as a bad
                    # placement would have left them
                    sysm._refresh_trajectory("SLAM")
                    nudged = i
            sysm.flush()
            secs = time.perf_counter() - t0
            launches = pose_optimization_cuda.launches
        finally:
            for k, fn in real.items():
                setattr(loop_closing.LoopCloser, k, fn)
        return sysm, tr, rec, launches, secs, nudged

    def check(name, sysm, tr, rec, launches, secs, nudged):
        tels = tr.telemetry
        states = [t.state for t in tels]
        idx, ate, errs = trajectory_errors(tr, poses)
        closer = sysm.loop_closers.get("SLAM")
        ms = tr.ms
        edges = closer.loop_edges if closer is not None else []
        n_kf = sum(t.kf_inserted >= 0 for t in tels)
        worst = int(np.argmax(errs))
        for t in tels:
            log(f"  8{name} frame {t.frame_id}: {t.state} motion {t.n_motion} inliers "
                f"{t.n_inliers} kf {t.kf_inserted}")
        log(f"phase 8{name}: {len(tels)} rows, {len(idx)} trajectory poses, {n_kf} keyframes, "
            f"n_maps {int(ms.maps.n_maps)}, sub-map moved at frame {nudged}, loop closer built "
            f"at frame {rec['built'][0] if rec['built'] else None} "
            f"({rec['built'][1] if rec['built'] else 0:.1f} ms), {closer.n_closed if closer else 0}"
            f" closures {[e[:2] for e in edges]}, ATE {ate:.6f} m, worst frame {int(idx[worst])} "
            f"at {errs[worst]:.6f} m, K1 launches {launches}, expected {expected_launches(tr)}, "
            f"{secs:.1f} s, {n / secs:.4f} frames/s")
        for c in rec["closures"]:
            log(f"phase 8{name} closure of keyframe {c['kf']} (frame {c['frame']}): {c['ms']:.1f} ms "
                f"stages {[(k, round(v, 4) if isinstance(v, float) else v, ok) for k, v, ok in c['stages']]}; keyframe "
                "translation errors against the truth, mean / max m, before -> after: " + "; ".join(
                    f"map {m}: {np.mean(x):.6f} / {max(x):.6f} -> {np.mean(y):.6f} / {max(y):.6f}"
                    for m, (x, y) in ((m, (c['before'][m], c['after'][m])) for m in (0, 1))
                    if x and y) + " (6a's sub-map, no loop: 0.0895 m)")
        gate(f"8{name}: REINITIALIZE entered, 2 maps, the sub-map registered and moved",
             any(s_.startswith("REINITIALIZE") for s_ in states) and int(ms.maps.n_maps) == 2
             and bool(ms.maps.registered[1]) and nudged is not None)
        gate(f"8{name}: {n} rows in frame order, state NORMAL",
             [t.frame_id for t in tels] == list(range(n)) and states[-1].startswith("NORMAL"))
        first = rec["closures"][0] if rec["closures"] else None
        gate(f"8{name}: a loop closed, none before the revisit's first frame ({revisit}, the "
             f"first within {MAX_LOOP_GAP_M} m of the start in the truth)",
             first is not None and all(c["frame"] >= revisit for c in rec["closures"]))
        if edges:
            kf, cand = edges[0][:2]
            fk, fc = int(ms.kf.frame_id[kf]), int(ms.kf.frame_id[cand])
            gap = float(np.linalg.norm(centres[fk] - centres[fc]))
            log(f"phase 8{name}: the first loop joins keyframe {kf} (frame {fk}, map "
                f"{int(ms.kf.map_id[kf])}) to keyframe {cand} (frame {fc}, map "
                f"{int(ms.kf.map_id[cand])}), {gap:.3f} m apart in the truth")
            gate(f"8{name}: the loop crosses the sub-map border, its keyframes within "
                 f"{MAX_LOOP_GAP_M} m in the truth",
                 int(ms.kf.map_id[kf]) != int(ms.kf.map_id[cand]) and gap < MAX_LOOP_GAP_M)
        if first is not None and first["before"][1] and first["after"][1]:
            b, a = np.mean(first["before"][1]), np.mean(first["after"][1])
            gate(f"8{name}: the first closure at least halves the sub-map keyframes' mean error "
                 f"({b:.6f} -> {a:.6f} m)", a <= 0.5 * b)
        gate(f"8{name}: ATE < {MAX_ATE_LOOP} m", ate < MAX_ATE_LOOP)
        gate(f"8{name}: K1 launches {launches} == {expected_launches(tr)} from the telemetry",
             launches == expected_launches(tr) and launches > 0)
        return ate

    out_a = run("a", enable_loop_closing=True)
    sysm_a, tr_a, rec_a, launches, secs_a, _ = out_a
    total += launches
    check("a", *out_a)
    if rec_a["sync"]:
        rep = max(rec_a["sync"], key=lambda s_: sum(s_.values()))
        log("phase 8a synchronising calls of a keyframe's loop maintenance: " + json.dumps({
            "keyframes": len(rec_a["sync"]),
            "median": statistics.median(sum(s_.values()) for s_ in rec_a["sync"]),
            "max": sum(rep.values()), "sites_of_the_max": rep}))
    out_b = run("b", enable_loop_closing=True, async_tracking=True, commit_lag=2)
    total += out_b[3]
    check("b", *out_b)
    closure = rec_a["closures"][0] if rec_a["closures"] else None

    def stage_ms(key):
        return [v for k, v, _ in closure["stages"] if k == key] if closure else []

    log("phase 8 timing: " + json.dumps({
        "card": card_line(),
        "median_ms_loop_maintenance_no_closure": statistics.median(rec_a["maint"])
        if rec_a["maint"] else None,
        "keyframes_without_closure": len(rec_a["maint"]),
        "ms_build_loop_closer": rec_a["built"][1] if rec_a["built"] else None,
        "ms_compute_sim3": stage_ms("compute_sim3"),
        "ms_correct_with_essential_graph": stage_ms("correct"),
        "ms_closure_total": closure["ms"] if closure else None,
        "ms_post_loop_global_ba": stage_ms("global_ba"),
        "frames_per_s_8a": n / secs_a, "frames_per_s_8b": n / out_b[4]}))
    if failed:
        raise AssertionError("phase 8 failed: " + "; ".join(failed))
    return total


def phase9(cam, cfg, poses, pairs, pts):
    """The dual camera at the reference's settings, and the SURF family;
    see the module docstring. Returns the K1 launches of its gated runs."""
    import tempfile

    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.features.factory import extract_hessian
    from hyslam_tpu_torch.geometry.camera import Camera
    from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
    from hyslam_tpu_torch.io.evaluate import camera_centers
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.ops.pyramid import preprocess_image
    from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
    from hyslam_tpu_torch.slam.sparsify import sparsify_map
    from hyslam_tpu_torch.slam.system import System
    from hyslam_tpu_torch.slam.tracker import State
    from hyslam_tpu_torch.utils import synth

    failed = []
    total = 0

    def gate(name, ok):
        log(f"phase 9 gate {'ok' if ok else 'FAILED'}: {name}")
        if not ok:
            failed.append(name)

    dev = pairs.device
    n = len(poses)
    Tcam = synth.se3_exp(IMG_TCAM).astype(np.float32)
    native = Camera(bf=0.0, **IMG_NATIVE)
    t0 = time.perf_counter()
    imgs = {}
    for i in range(0, n, IMG_EVERY):
        if DARK[0] <= i < DARK[1]:
            imgs[i] = torch.full((native.height, native.width), 20.0, device=dev)
        else:
            imgs[i] = torch.from_numpy(synth.render_world(
                native, (Tcam @ poses[i]).astype(np.float32), pts,
                blob_scale=1.0 / IMG_SCALE)[0]).to(dev)
    log(f"rendered {len(imgs)} Imaging frames {native.width}x{native.height} in "
        f"{time.perf_counter() - t0:.1f} s")
    dark_pairs = synth.blackout(pairs, *DARK)
    truth = np.stack(poses)

    def config(**kw):
        slam = CameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                            height=cam.height, bf=cam.bf, th_depth=cam.th_depth,
                            extractor=cfg)
        img = CameraConfig(name="Imaging", scale=IMG_SCALE, mono=True, Tcam=Tcam.tolist(),
                           extractor=ExtractorConfig(n_features=IMG_FEATURES, n_levels=8),
                           policy=KeyFramePolicyParams(max_kf_interval=2 * IMG_EVERY),
                           **IMG_NATIVE)
        return SystemConfig(cameras={"SLAM": slam, "Imaging": img}, caps=MapCaps(*IMG_CAPS),
                            **kw)

    def run(name, n_frames, **kw):
        """One dual-camera run; returns its timing record."""
        sysm = System(config(**kw))
        slam_tr, img_tr = sysm.trackers["SLAM"], sysm.trackers["Imaging"]
        rec = dict(slam_ms=[], img_ms=[], place_ms=[], keeps=[], pairs=[], sync=[])
        torch.cuda.reset_peak_memory_stats()
        pose_optimization_cuda.launches = 0
        t_run = time.perf_counter()
        for i in range(n_frames):
            torch.cuda.synchronize()
            t = time.perf_counter()
            sysm.track_stereo(dark_pairs[i, 0], dark_pairs[i, 1], FRAME_DT * i, frame_id=i)
            torch.cuda.synchronize()
            rec["slam_ms"].append((i, 1e3 * (time.perf_counter() - t)))
            if i % IMG_EVERY:
                continue
            img_frame = lambda: sysm.track_monocular(imgs[i], FRAME_DT * i, camera="Imaging",
                                                     frame_id=i)
            t = time.perf_counter()
            if name == "a" and N_WARM <= i < DARK[0] and img_tr.state == State.NORMAL:
                rec["sync"].append(sync_sites(img_frame))
            else:
                img_frame()
            torch.cuda.synchronize()
            rec["img_ms"].append((i, 1e3 * (time.perf_counter() - t)))
            rec["pairs"].append((i, slam_tr.state, img_tr.state))
            if slam_tr.state in (State.NORMAL, State.POSTINIT):
                t = time.perf_counter()
                keep, _ = sysm.place_imaging_frame(FRAME_DT * i)
                rec["place_ms"].append(1e3 * (time.perf_counter() - t))
                rec["keeps"].append(bool(keep))
        sysm.flush()
        secs = time.perf_counter() - t_run
        launches = pose_optimization_cuda.launches
        expected = expected_launches(slam_tr) + expected_launches(img_tr)
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        for t in img_tr.telemetry:
            log(f"  9{name} Imaging frame {t.frame_id}: {t.state} motion {t.n_motion} inliers "
                f"{t.n_inliers} local {t.n_local} kf {t.kf_inserted}")
        idx, ate, errs = trajectory_errors(slam_tr, poses)
        before = idx < DARK[0]
        ate_before = float(np.sqrt(np.mean(np.square(np.asarray(errs)[before]))))
        n_img_kf = int(img_tr.ms.next_kf)
        n_maps = int(img_tr.ms.maps.n_maps)

        torch.cuda.synchronize()
        t = time.perf_counter()
        sysm.run_imaging_bundle_adjustment(sparsify_overlap=None)
        torch.cuda.synchronize()
        ba_ms = 1e3 * (time.perf_counter() - t)
        t = time.perf_counter()
        img_tr.ms, n_culled = sparsify_map(img_tr.ms, sysm.cameras["Imaging"], 0.98)
        torch.cuda.synchronize()
        sparsify_ms = 1e3 * (time.perf_counter() - t)
        registered = img_tr.ms.maps.registered[:n_maps].cpu().numpy()
        kf_ok = (img_tr.ms.kf.valid & ~img_tr.ms.kf.bad).cpu().numpy()
        sel = np.nonzero(kf_ok)[0]
        est = img_tr.ms.kf.Tcw.cpu().numpy()[sel]
        frames = np.rint(img_tr.ms.kf.timestamp.cpu().numpy()[sel] / FRAME_DT).astype(int)
        gt = np.stack([Tcam @ truth[f] for f in frames])
        img_err = np.linalg.norm(camera_centers(est) - camera_centers(gt), axis=-1)
        img_ate = float(np.sqrt(np.mean(img_err ** 2)))
        with tempfile.TemporaryDirectory() as d:
            sysm.export_colmap(d)
            sysm.save_keyframes_agisoft(os.path.join(d, "imaging.xml"), camera="Imaging")
            sysm.save_trajectory(os.path.join(d, "slam_traj.tsv"))
            files = [os.path.join(d, "SLAM", "images.txt"),
                     os.path.join(d, "Imaging", "images.txt"),
                     os.path.join(d, "imaging.xml"), os.path.join(d, "slam_traj.tsv")]
            sizes = [os.path.getsize(f) if os.path.exists(f) else 0 for f in files]

        null_while_lost = [img for _, slam, img in rec["pairs"] if slam == State.REINITIALIZE]
        log(f"phase 9{name} dual camera {'async' if kw.get('async_tracking') else 'sync'}: "
            f"SLAM {slam_tr.state.name}, ATE {ate:.6f} m ({ate_before:.6f} m before the "
            f"blackout), worst frame {max(errs):.6f} m; Imaging {img_tr.state.name}, "
            f"{n_img_kf} keyframes in {n_maps} sub-maps, registered {registered.tolist()}, "
            f"states while SLAM was lost {[s.name for s in null_while_lost]}, placer kept "
            f"{sum(rec['keeps'])} of {len(rec['keeps'])}; imaging BA {ba_ms:.1f} ms, "
            f"sparsification {sparsify_ms:.1f} ms culled {n_culled}, Imaging keyframe ATE "
            f"{img_ate:.6f} m over {len(sel)} (worst {img_err.max():.6f} m); exports "
            f"{sizes} bytes; K1 launches {launches}, expected {expected}; {secs:.1f} s")
        gate(f"9{name}: SLAM ends in NORMAL, ATE < {MAX_ATE} m before the blackout (phase 5's "
             f"bound) and < {MAX_ATE_BLACKOUT} m over the run (6a's)",
             slam_tr.state == State.NORMAL and ate_before < MAX_ATE and ate < MAX_ATE_BLACKOUT)
        gate(f"9{name}: the Imaging camera makes >= {MIN_IMG_KEYFRAMES} keyframes",
             n_img_kf >= MIN_IMG_KEYFRAMES)
        gate(f"9{name}: the Imaging camera is NULL while SLAM is lost and ends in POSTINIT or "
             "NORMAL", bool(null_while_lost) and all(s == State.NULL for s in null_while_lost)
             and img_tr.state in (State.POSTINIT, State.NORMAL))
        gate(f"9{name}: >= 2 Imaging sub-maps, every one registered after imaging BA",
             n_maps >= 2 and bool(registered.all()))
        gate(f"9{name}: the placer keeps some frames and skips some",
             any(rec["keeps"]) and not all(rec["keeps"]))
        gate(f"9{name}: Imaging keyframe ATE {img_ate:.4f} < {MAX_ATE_IMAGING} m after "
             "finalization", img_ate < MAX_ATE_IMAGING)
        gate(f"9{name}: the exports exist and are not empty", all(x > 0 for x in sizes))
        gate(f"9{name}: K1 launches {launches} == {expected} from both trackers' telemetry",
             launches == expected and launches > 0)
        steady = lambda rows: statistics.median(ms for i, ms in rows if N_WARM <= i < DARK[0])
        rec.update(launches=launches, secs=secs, peak_mb=peak_mb, ba_ms=ba_ms,
                   sparsify_ms=sparsify_ms, n_culled=n_culled,
                   slam_frame_ms=steady(rec["slam_ms"]), img_frame_ms=steady(rec["img_ms"]),
                   place_ms=statistics.median(rec["place_ms"]) if rec["place_ms"] else None)
        return rec

    rec_a = run("a", n)
    total += rec_a["launches"]
    per_frame = rec_a["sync"]
    if per_frame:
        rep = max(per_frame, key=lambda s_: sum(s_.values()))
        log("phase 9a synchronising calls a steady sync Imaging frame (NORMAL, frames "
            f"{N_WARM}-{DARK[0] - 1}): " + json.dumps({
                "frames": len(per_frame),
                "median": statistics.median(sum(s_.values()) for s_ in per_frame),
                "max": sum(rep.values()), "sites_of_the_max": rep}))
    rec_b = run("b", N_ASYNC9, async_tracking=True, commit_lag=2)
    total += rec_b["launches"]

    # ---- 9c: SURF
    surf = ExtractorConfig(n_features=cfg.n_features, n_levels=cfg.n_levels, family="SURF")
    sysm = make_system(cam, surf)
    tr = sysm.trackers["SLAM"]
    pose_optimization_cuda.launches = 0
    t = time.perf_counter()
    for i in range(N_SURF):
        sysm.track_stereo(pairs[i, 0], pairs[i, 1], FRAME_DT * i, frame_id=i)
    sysm.flush()
    secs_c = time.perf_counter() - t
    launches = pose_optimization_cuda.launches
    total += launches
    idx, ate_c, errs_c = trajectory_errors(tr, poses)
    tels = tr.telemetry
    log(f"phase 9c SURF stereo: {[t.state for t in tels]}, inliers "
        f"{[t.n_inliers for t in tels]}, ATE {ate_c:.6f} m, worst frame {max(errs_c):.6f} m, "
        f"{sum(t.kf_inserted >= 0 for t in tels)} keyframes, K1 launches {launches}, "
        f"expected {expected_launches(tr)}, {secs_c:.1f} s")
    gate(f"9c: every SURF frame after the first tracked, ATE < {MAX_T} m",
         len(tels) == N_SURF and all(tracked_row(t) for t in tels[1:]) and ate_c < MAX_T)
    gate(f"9c: K1 launches {launches} == {expected_launches(tr)} from the telemetry",
         launches == expected_launches(tr) and launches > 0)
    worst_bits = 0.0
    for i in SURF_CHECK:
        g = preprocess_image(pairs[i, 0], 1.0)
        a = extract_hessian(g, surf, CAPACITY)
        b = extract_hessian(g.cpu(), surf, CAPACITY)
        same = all(torch.equal(getattr(a, k).cpu(), getattr(b, k)) for k in ("uv", "level", "valid"))
        ba_ = (a.desc.cpu() ^ b.desc).view(torch.uint8).numpy()
        frac = float(np.unpackbits(ba_).mean())
        worst_bits = max(worst_bits, frac)
        log(f"phase 9c frame {i}: SURF on the card vs the CPU: equal keypoints and levels "
            f"{same}, {int(a.valid.sum())} valid, descriptor bits differing {frac:.6f}")
        gate(f"9c frame {i}: the card's SURF keypoints equal the CPU's, descriptor bits "
             f"differ in < {MAX_SURF_BIT_FRACTION}", same and frac < MAX_SURF_BIT_FRACTION)
    g720 = preprocess_image(pairs[0, 0], 1.0)
    g_img = preprocess_image(imgs[0], IMG_SCALE)
    img_surf = ExtractorConfig(n_features=IMG_FEATURES, n_levels=8, family="SURF")
    size = f"{g720.shape[1]}x{g720.shape[0]}"
    surf_ms = {
        f"{size}_one_image": cuda_ms(lambda: extract_hessian(g720, surf, CAPACITY), 10),
        f"{size}_stereo_pair": cuda_ms(lambda: extract_hessian(pairs[0], surf, CAPACITY), 10),
        f"{g_img.shape[1]}x{g_img.shape[0]}_{IMG_FEATURES}_features":
            cuda_ms(lambda: extract_hessian(g_img, img_surf, IMG_CAPS[2]), 10),
    }
    log("phase 9 timing: " + json.dumps({
        "card": card_line(),
        "9a_slam_frame_ms_median": rec_a["slam_frame_ms"],
        "9a_imaging_frame_ms_median": rec_a["img_frame_ms"],
        "9a_placer_call_ms_median": rec_a["place_ms"],
        "9a_imaging_ba_ms": rec_a["ba_ms"], "9a_sparsify_ms": rec_a["sparsify_ms"],
        "9a_sparsify_culled": rec_a["n_culled"], "9a_peak_device_mb": rec_a["peak_mb"],
        "9a_s": rec_a["secs"],
        "9b_slam_frame_ms_median": rec_b["slam_frame_ms"],
        "9b_imaging_frame_ms_median": rec_b["img_frame_ms"],
        "9b_imaging_ba_ms": rec_b["ba_ms"], "9b_s": rec_b["secs"],
        "9b_peak_device_mb": rec_b["peak_mb"],
        "9c_surf_s": secs_c, "surf_extraction_ms": surf_ms,
        "surf_worst_bit_fraction": worst_bits}))
    if failed:
        raise AssertionError("phase 9 failed: " + "; ".join(failed))
    return total


def png_shape(path: str):
    """(width, height) of an 8-bit RGB PNG whose pixel data decodes to
    exactly its rows (one filter byte and 3 bytes a pixel each); raises
    otherwise."""
    import struct
    import zlib

    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    idat, pos = b"", 8
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    if len(zlib.decompress(idat)) != h * (1 + 3 * w):
        raise ValueError(f"{path}: pixel data is not {w}x{h} RGB")
    return w, h


def busy_share(spans, t0: float, t1: float) -> float:
    """The share of [t0, t1] covered by the union of (start, end) spans."""
    covered, last = 0.0, t0
    for a, b in sorted(spans):
        a, b = max(a, last), min(b, t1)
        if b > a:
            covered += b - a
            last = b
    return covered / (t1 - t0)


class ReplaySchedule:
    """A tracker's ``mapping_status`` that replays a pipelined run's schedule
    (``_Stages.idle_reads`` and ``adoptions``) synchronously: the mapping
    stage reads idle where the run's decision did and busy (one job)
    elsewhere; a keyframe's mapper jobs run at once on the refreshed map,
    as the mapping thread ran them, and their output is handed to the
    tracker where the run's tracker took it. The caller calls ``begin``
    before each frame. A synchronous System whose tracker holds it computes
    what the pipelined System computed, without the threads."""

    def __init__(self, tracker, idle_reads, adoptions):
        self.tracker, self.frame_id, self._out = tracker, -1, None
        self._idle = {f for _, f, idle in idle_reads if idle}
        self._adopt = {(f, where) for _, f, where in adoptions}

    def begin(self, frame_id: int) -> None:
        self.frame_id = frame_id
        if (frame_id, "before") in self._adopt:
            self._take()

    def _take(self):
        if self._out is not None:
            self.tracker.ms, self._out = self._out, None

    def idle(self) -> bool:
        return self.frame_id in self._idle

    def queue_len(self) -> int:
        return 0 if self.idle() else 1

    def sync(self, tracker) -> None:
        if (self.frame_id, "in") in self._adopt:
            self._take()

    def defer(self, ms, kf_id, maintenance_sensors, **kw):
        from hyslam_tpu_torch.runtime.pipeline import _mandatory_refresh

        ms = _mandatory_refresh(ms)
        self._out, _ = self.tracker.mapper.integrate_keyframe(ms, kf_id, **kw)
        return ms, {"deferred": True}


def phase10(cam, cfg, poses, pairs, timing5=None):
    """The pipelined System; see the module docstring. ``timing5``: phase
    5's timing numbers, printed beside 10a's (alone, without them, the sync
    count is taken as one keyframe a frame). Returns the K1 launches of its
    runs."""
    import tempfile
    import threading

    from hyslam_tpu_torch.io.config import OptimizerInfo
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.slam import system as system_mod
    from hyslam_tpu_torch.slam.tracker import POSTINIT_FRAMES, State
    from hyslam_tpu_torch.utils import synth
    from hyslam_tpu_torch.viz import Viewer
    from hyslam_tpu_torch.viz.frame_drawer import BAR_H

    n = len(poses)
    failed = []
    total = 0

    def gate(name, ok):
        log(f"phase 10 gate {'ok' if ok else 'FAILED'}: {name}")
        if not ok:
            failed.append(name)

    # ---- 10a: the 60 frames through System(pipelined=True), with the logs
    # and frame dumps of run_data_dir
    with tempfile.TemporaryDirectory() as run_dir:
        sysm = make_system(cam, cfg, pipelined=True, run_data_dir=run_dir)
        pipe, tr = sysm._pipe, sysm.trackers["SLAM"]
        gate("10a: the System took the card and built its pipeline",
             sysm.device.type == "cuda" and pipe is not None and tr.mapping_status is not None)
        pose_optimization_cuda.launches = 0
        t0 = None
        for i in range(n):
            if i == N_WARM:
                sysm.flush()
                t0 = time.perf_counter()
            out = sysm.track_stereo(pairs[i, 0], pairs[i, 1], FRAME_DT * i, frame_id=i)
            assert out is None, "a pipelined track_stereo returns None"
        sysm.flush()
        t1 = time.perf_counter()
        launches = pose_optimization_cuda.launches
        total += launches
        tels = pipe.telemetry
        kf_rows = [t for t in tels if t.kf_inserted >= 0]
        idx, ate, errs = trajectory_errors(tr, poses)
        for t in tels:
            log(f"  10a frame {t.frame_id}: {t.state} motion {t.n_motion} inliers {t.n_inliers} "
                f"kf {t.kf_inserted} {t.mapper_stats or ''}")
        fps = (n - N_WARM) / (t1 - t0)
        timing5 = timing5 or dict(keyframes_sync=n, keyframes_async=None,
                                  sync_frames_per_s=None, async_frames_per_s=None)
        kf_sync, kf_async = timing5["keyframes_sync"], timing5["keyframes_async"]
        log(f"phase 10a pipelined: {len(tels)} rows, {len(kf_rows)} keyframes at frames "
            f"{[t.frame_id for t in kf_rows]}, ATE {ate:.6f} m, worst frame "
            f"{int(idx[int(np.argmax(errs))])} at {max(errs):.6f} m, K1 launches {launches}, "
            f"expected {expected_launches(tr)}")
        gate(f"10a: {n} telemetry rows in frame order, ending NORMAL",
             [t.frame_id for t in tels] == list(range(n)) and tels[-1].state == "NORMAL"
             and tr.state == State.NORMAL and tr.telemetry == tels)
        gate("10a: every keyframe after the first integrated by the mapping thread",
             len(kf_rows) > 1 and all(t.mapper_stats == {"deferred": True} for t in kf_rows[1:])
             and len(pipe.mapping_spans) == len(kf_rows) - 1)
        gate(f"10a: K1 launches {launches} == {expected_launches(tr)} from the telemetry",
             launches == expected_launches(tr))
        kf_frames = [t.frame_id for t in kf_rows]
        decisions = [(f, idle) for _, f, idle in pipe.idle_reads if f > POSTINIT_FRAMES]
        n_idle = sum(idle for _, idle in decisions)
        gate(f"10a: one keyframe decision a frame after POSTINIT, {n_idle} of "
             f"{len(decisions)} reading the mapping stage idle; every keyframe taken at one",
             [f for f, _ in decisions] == list(range(POSTINIT_FRAMES + 1, n))
             and all(idle for f, idle in decisions if f in kf_frames))
        dumps = sorted(f for f in os.listdir(run_dir) if f.endswith(".png"))
        want = [f"features_SLAM_{i:06d}.png" for i in DUMP_FRAMES]
        shapes = [png_shape(os.path.join(run_dir, f)) for f in dumps]
        gate(f"10a: the frame dumps {want} decode to {W}x{H + BAR_H}",
             dumps == want and shapes == [(W, H + BAR_H)] * len(want))
        sysm.shutdown()
        logs = {f: open(os.path.join(run_dir, f)).read().splitlines()
                for f in ("tracking_data.txt", "localmapping_data.txt")}
        gate(f"10a: the TSV logs hold {n} tracking rows and {len(kf_rows) - 1} mapping rows",
             len(logs["tracking_data.txt"]) == n + 1
             and len(logs["localmapping_data.txt"]) == len(kf_rows))
        viewer = Viewer(out_dir=os.path.join(run_dir, "viz"))
        centres = -torch.einsum("kji,kj->ki", tr.traj.Tcw[:, :3, :3],
                                tr.traj.Tcw[:, :3, 3])[:int(tr.traj.size)]
        viewer.update(tr.ms, current_Tcw=tr.last_Tcw, trajectory_centers=centres)
        snap = viewer.snapshot()
        gate("10a: Viewer.snapshot of the final map decodes to its 960x720",
             len(snap) == 1 and png_shape(snap[0]) == (960, 720))

    # the replay: a synchronous System on 10a's schedule; its tracking
    # frames and mapper jobs are timed alone
    rsys = make_system(cam, cfg)
    rtr = rsys.trackers["SLAM"]
    replay = ReplaySchedule(rtr, pipe.idle_reads, pipe.adoptions)
    rtr.mapping_status = replay
    job_rows, alone_ms, track = time_integrate(rtr), [], rtr.track

    def timed_track(*a, **kw):
        n_jobs = len(job_rows)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tel = track(*a, **kw)
        torch.cuda.synchronize()
        alone_ms.append(1e3 * (time.perf_counter() - t)
                        - sum(ms for _, ms, _ in job_rows[n_jobs:]))   # less its mapper job
        return tel

    rtr.track = timed_track
    pose_optimization_cuda.launches = 0
    for i in range(n):
        replay.begin(i)
        rsys.track_stereo(pairs[i, 0], pairs[i, 1], FRAME_DT * i, frame_id=i)
    rsys.flush()
    launches = pose_optimization_cuda.launches
    total += launches
    r_lines, lines = frame_lines(rtr), frame_lines(tr)
    r_ate = trajectory_errors(rtr, poses)[1]
    d_pose = float((rtr.traj.Tcw[:n] - tr.traj.Tcw[:n]).abs().max())
    log(f"phase 10a replay: {sum(t.kf_inserted >= 0 for t in rtr.telemetry)} keyframes, ATE "
        f"{r_ate:.6f} m, max|dT| against 10a {d_pose:.3g}, {len(pipe.adoptions)} adoptions "
        f"{[(f, w) for _, f, w in pipe.adoptions]}, K1 launches {launches}, expected "
        f"{expected_launches(rtr)}")
    gate("10a: the synchronous replay of its schedule gives 10a's telemetry rows and poses, "
         "bit for bit, K1 as its telemetry calls for",
         r_lines == lines and int(rtr.traj.size) == n and launches == expected_launches(rtr))
    gate(f"10a: ATE < {MAX_ATE} m and every frame < {MAX_T_TRACK} m (phase 5's async bounds)",
         ate < MAX_ATE and max(errs) < MAX_T_TRACK and list(idx) == list(range(n)))
    low = kf_async - 5 if kf_async is not None else 0     # alone: phase 5 not run
    gate(f"10a: keyframes {len(kf_rows)} between phase 5's async count less 5 ({low}) and its "
         f"sync count ({kf_sync})", low <= len(kf_rows) <= kf_sync)

    waits = [1e3 * w for w in pipe.drain_waits]
    frames = [(1e3 * (b - a), 1e3 * cpu) for (a, b, cpu), t
              in zip(pipe.frame_spans, tels) if t.frame_id >= N_WARM]
    jobs = [1e3 * (b - a) for a, b, _ in pipe.mapping_spans if a >= t0]
    med = lambda xs: statistics.median(xs) if xs else float("nan")  # noqa: E731
    timing = {
        "card": card_line(), "frames_timed": n - N_WARM,
        "pipelined_frames_per_s": fps, "pipelined_ms_per_frame": 1e3 / fps,
        "sync_frames_per_s": timing5["sync_frames_per_s"],
        "async_frames_per_s": timing5["async_frames_per_s"],
        "keyframes_pipelined": len(kf_rows), "keyframes_sync": kf_sync,
        "keyframes_async": kf_async,
        "drain_wait_ms_median_a_keyframe": med(waits), "drain_wait_ms_max": max(waits),
        "drains": len(waits),
        "mapping_thread_busy_share": busy_share([(a, b) for a, b, _ in pipe.mapping_spans],
                                                t0, t1),
        "mapping_job_ms_median_max": [med(jobs), max(jobs, default=float("nan"))],
        "mapping_job_ms_median_alone_replay": med(
            [ms for kf, ms, _ in job_rows if kf > POSTINIT_FRAMES]),
        "tracking_frame_ms_median": med([f for f, _ in frames]),
        "tracking_frame_cpu_ms_median": med([c for _, c in frames]),
        "tracking_frame_ms_median_alone_replay": med(alone_ms[N_WARM:]),
    }
    log("phase 10 timing: " + json.dumps(timing))

    # ---- 10b: 6a's blackout, loop closing on, periodic global BA on the
    # mapping thread; then shutdown, refusal, reset and more frames
    dark = synth.blackout(pairs, *DARK)
    gba_threads = []
    run_global_ba = system_mod.run_global_ba

    def spied_run(*a, **kw):
        gba_threads.append(threading.current_thread().name)
        return run_global_ba(*a, **kw)

    system_mod.run_global_ba = spied_run
    try:
        sysm = make_system(cam, cfg, pipelined=True, enable_loop_closing=True,
                           optimizer=OptimizerInfo(realtime=False, gba_interval=GBA_EVERY_10B))
        tr = sysm.trackers["SLAM"]
        pose_optimization_cuda.launches = 0
        for i in range(N_BLACKOUT10):
            sysm.track_stereo(dark[i, 0], dark[i, 1], FRAME_DT * i, frame_id=i)
        sysm.flush()
    finally:
        system_mod.run_global_ba = run_global_ba
    launches = pose_optimization_cuda.launches
    total += launches
    states = [t.state for t in tr.telemetry]
    idx, ate, errs = trajectory_errors(tr, poses)
    n_maps = int(tr.ms.maps.n_maps)
    closer = sysm.loop_closers.get("SLAM")
    log(f"phase 10b pipelined blackout: states {states}, n_maps {n_maps}, "
        f"{sum(t.kf_inserted >= 0 for t in tr.telemetry)} keyframes, global BA on threads "
        f"{gba_threads}, loop closer built {closer is not None} (closed "
        f"{closer.n_closed if closer else 0}), ATE {ate:.6f} m, worst frame "
        f"{int(idx[int(np.argmax(errs))])} at {max(errs):.6f} m, K1 launches {launches}, "
        f"expected {expected_launches(tr)}")
    gate(f"10b: REINITIALIZE ... REINIT_OK at frame {DARK[1]}, n_maps 2",
         any(s.startswith("REINITIALIZE") for s in states)
         and states[DARK[1]] == "REINITIALIZE>REINIT_OK"
         and sum(">REINIT_OK" in s for s in states) == 1 and n_maps == 2)
    gate("10b: at least one global BA, every one on the mapping thread",
         len(gba_threads) >= 1 and set(gba_threads) == {"hyslam-mapping"})
    gate(f"10b: ATE < {MAX_ATE_BLACKOUT} m and every tracked frame < {MAX_T_BLACKOUT} m",
         ate < MAX_ATE_BLACKOUT and max(errs) < MAX_T_BLACKOUT)
    gate(f"10b: K1 launches {launches} == {expected_launches(tr)} from the telemetry",
         launches == expected_launches(tr))
    old_pipe = sysm._pipe
    sysm.shutdown()
    try:
        sysm.track_features(tr.last_feats, 99.0)
        refused = False
    except RuntimeError:
        refused = True
    gate("10b: shutdown joins both threads, then track_features raises RuntimeError",
         refused and not any(t.is_alive() for t in old_pipe._threads))
    sysm.reset()
    tr = sysm.trackers["SLAM"]
    pose_optimization_cuda.launches = 0
    for i in range(N_AFTER_RESET):
        sysm.track_stereo(pairs[i, 0], pairs[i, 1], FRAME_DT * i, frame_id=i)
    sysm.flush()
    launches = pose_optimization_cuda.launches
    total += launches
    rows = [t.state for t in sysm._pipe.telemetry]
    log(f"phase 10b after reset: {rows}, K1 launches {launches}, expected "
        f"{expected_launches(tr)}")
    gate(f"10b: reset() gives a new pipeline that tracks {N_AFTER_RESET} more frames to NORMAL",
         sysm._pipe is not old_pipe and len(rows) == N_AFTER_RESET
         and [t.frame_id for t in tr.telemetry] == list(range(N_AFTER_RESET))
         and tr.state == State.NORMAL and launches == expected_launches(tr))
    sysm.shutdown()
    if failed:
        raise AssertionError("phase 10 failed: " + "; ".join(failed))
    return total


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
    took = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        took[name] = round(time.perf_counter() - t, 1)
        return out

    timed("0", phase0)
    k1 = timed("1", phase1, dev)
    cam, cfg = camera_and_config()
    poses, pairs, pts = timed("render", render_sequence, cam, dev, N_TRACK)
    launches = timed("2-3", phase2, dev, cam, cfg, poses, pairs)
    tracked = timed("4", phase4, dev, cam, cfg, poses, pairs)
    launches5, async_lines, timing5 = timed("5", phase5, cam, cfg, poses, pairs, pts, tracked)
    launches += tracked["launches"] + launches5
    launches += timed("6", phase6, cam, cfg, poses, pairs, tracked, async_lines)
    launches += timed("7", phase7, cam, cfg, poses, pairs)
    launches += timed("8", phase8, cam, cfg, dev)
    launches += timed("9", phase9, cam, cfg, poses, pairs, pts)
    launches += timed("10", phase10, cam, cfg, poses, pairs, timing5)
    log(f"seconds a phase: {json.dumps(took)}")
    log(json.dumps({"kernels": [{
        "name": "pose_opt",
        "route": "cuda",
        "source": "hyslam_tpu_torch/csrc/pose_opt.cu",
        "replaces": "hyslam_tpu/ops/pose_opt_pallas.py:331",
        "launches": launches,
        **k1,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": 1,                       # the one card this run drives
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
