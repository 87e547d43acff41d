#!/usr/bin/env python3
"""Where the threads of ``System(pipelined=True)`` lose their time, on one
CUDA card: ``chip_smoke.py``'s phase 10a operating point (the 60 rendered
1280x720 stereo frames, ORB 1000 x 8, MapCaps(64, 16384, 1024, 8), loop
closing off), run once per variant, each in a fresh process:

    sync          the synchronous System (the mapper runs inline, alone)
    pipelined     System(pipelined=True) as it ships
    blocking      the same, with the CUDA context's scheduling set to
                  blocking sync (a read sleeps instead of spinning)
    features      the same as ``pipelined``, with every frame's features
                  extracted before the clock starts (no extraction beside the
                  two threads; frames fed through track_features)
    mapstream     the same as ``pipelined``, with the mapping thread on a
                  stream of its own (hand-offs synchronised at both ends)
    noturns       the same as ``pipelined``, with its threads not taking
                  turns (``runtime.pipeline.Turns`` made a no-op): each
                  runs whenever the GIL lets it
    switch=S      the same as ``pipelined``, with the interpreter's thread
                  switch interval set to S seconds (its default is 5e-3)

A variant name may join several with '+', as ``features+blocking``.

Every read of a CUDA tensor to the host (``item``, ``tolist``, ``cpu``,
``__bool__``, ``__int__``, ``__float__``, ``__index__``) is timed on the
thread that makes it: first a CUDA event recorded at that point of the
thread's stream is waited for (``queue``: the wait for the work queued
before the read, with its wall and its thread CPU time; with the default
scheduling a spinning wait is CPU time, a wait for the GIL after it is not),
then the read itself (``read``). Reads inside a mapper job count to the
mapper whichever thread runs it. Reads made inside PyTorch's C++ (a boolean
mask's ``nonzero``) are not seen.

Printed: the card (name, power limit) and one JSON line per variant:
frames/s over frames 10-59 (phase 10's clock), keyframes, ATE and worst
frame, the wall and thread CPU ms of each mapper job, the medians of a
tracking frame without a keyframe and of one with a keyframe (its wait in
the drain before the insertion included), and the reads' totals a job and
a frame of either kind.

    python3 tools/pipeline_probe.py                       # every variant
    python3 tools/pipeline_probe.py --variants sync pipelined blocking
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from collections import defaultdict

sys.path.insert(0, os.getcwd())

VARIANTS = ("sync", "pipelined", "noturns", "features", "blocking", "mapstream", "switch=1e-4")
CU_CTX_SCHED_BLOCKING_SYNC = 0x04
READS = ("item", "tolist", "cpu", "__bool__", "__int__", "__float__", "__index__")


def set_blocking_sync() -> int:
    """Ask for blocking sync on device 0's primary context, before PyTorch
    creates it. Returns the driver's status (0: done)."""
    cu = ctypes.CDLL("libcuda.so.1")
    rc = cu.cuInit(0)
    dev = ctypes.c_int()
    rc = rc or cu.cuDeviceGet(ctypes.byref(dev), 0)
    return rc or cu.cuDevicePrimaryCtxSetFlags_v2(dev, CU_CTX_SCHED_BLOCKING_SYNC)


def context_sched_flags() -> int:
    """The scheduling bits of device 0's primary context."""
    cu = ctypes.CDLL("libcuda.so.1")
    dev, flags, active = ctypes.c_int(), ctypes.c_uint(), ctypes.c_int()
    cu.cuDeviceGet(ctypes.byref(dev), 0)
    cu.cuDevicePrimaryCtxGetState(dev, ctypes.byref(flags), ctypes.byref(active))
    return flags.value & 0x7


class ReadClock:
    """Times every read of a CUDA tensor to the host; see the docstring."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = defaultdict(list)   # label -> [(queue wall, queue cpu, read wall, read cpu)]
        self.mapper_depth = threading.local()
        for name in READS:
            setattr(torch.Tensor, name, self._wrap(getattr(torch.Tensor, name)))

    def label(self) -> str:
        if getattr(self.mapper_depth, "n", 0):
            return "mapper"
        return threading.current_thread().name

    def _wrap(self, orig):
        torch = self.torch

        def timed(t, *a, **kw):
            if not t.is_cuda:
                return orig(t, *a, **kw)
            t0, c0 = time.perf_counter(), time.thread_time()
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()
            t1, c1 = time.perf_counter(), time.thread_time()
            out = orig(t, *a, **kw)
            self.rows[self.label()].append(
                (t1 - t0, c1 - c0, time.perf_counter() - t1, time.thread_time() - c1))
            return out

        return timed

    def mark(self):
        return {k: len(v) for k, v in self.rows.items()}

    def since(self, label: str, mark: dict) -> list:
        return self.rows[label][mark.get(label, 0):]


def totals(rows) -> dict:
    """ms summed over the reads of one job or frame."""
    return {"reads": len(rows),
            "queue_wall_ms": 1e3 * sum(r[0] for r in rows),
            "queue_cpu_ms": 1e3 * sum(r[1] for r in rows),
            "read_wall_ms": 1e3 * sum(r[2] for r in rows),
            "read_cpu_ms": 1e3 * sum(r[3] for r in rows)}


def median_totals(groups) -> dict:
    if not groups:
        return {}
    keys = groups[0].keys()
    return {k: statistics.median(g[k] for g in groups) for k in keys}


def run_one(variant: str) -> dict:
    parts = dict((p.split("=") + [None])[:2] for p in variant.split("+"))
    blocking_rc = set_blocking_sync() if "blocking" in parts else None
    import torch

    import chip_smoke as c
    import hyslam_tpu_torch  # noqa: F401
    from hyslam_tpu_torch.runtime import pipeline as P

    torch.zeros(1, device="cuda")
    sched = context_sched_flags()
    c.phase0()
    cam, cfg = c.camera_and_config()
    poses, pairs, _ = c.render_sequence(cam, torch.device("cuda", 0), c.N_TRACK)
    clock = ReadClock(torch)
    pipelined = "sync" not in parts
    if "mapstream" in parts:
        _patch_mapping_stream(P, torch)
    if "switch" in parts:
        sys.setswitchinterval(float(parts["switch"]))
    if "noturns" in parts:
        P.Turns.hold = P.Turns.given_up = lambda self: contextlib.nullcontext()
    sysm = c.make_system(cam, cfg, pipelined=pipelined)
    tr = sysm.trackers["SLAM"]
    jobs, frames = [], []            # (wall, cpu, reads) a job; (wall, cpu, reads, kf) a frame

    # the mapper's jobs: integrate_keyframe (+ maintenance on the mapping thread)
    def timed_job(fn):
        def run(*a, **kw):
            mark = clock.mark()
            clock.mapper_depth.n = getattr(clock.mapper_depth, "n", 0) + 1
            t0, c0 = time.perf_counter(), time.thread_time()
            try:
                return fn(*a, **kw)
            finally:
                clock.mapper_depth.n -= 1
                jobs.append((time.perf_counter() - t0, time.thread_time() - c0,
                             totals(clock.since("mapper", mark)), t0))
        return run

    tr.mapper.integrate_keyframe = timed_job(tr.mapper.integrate_keyframe)
    track = tr.track

    def timed_track(*a, **kw):
        mark, n_jobs = clock.mark(), len(jobs)
        t0, c0 = time.perf_counter(), time.thread_time()
        tel = track(*a, **kw)
        wall, cpu = time.perf_counter() - t0, time.thread_time() - c0
        if not pipelined and len(jobs) > n_jobs:      # the inline mapper's share
            wall, cpu = wall - jobs[-1][0], cpu - jobs[-1][1]
        label = threading.current_thread().name
        frames.append((wall, cpu, totals(clock.since(label, mark)), tel.kf_inserted >= 0))
        return tel

    tr.track = timed_track
    feats = None
    if "features" in parts:
        feats = [extract_features(sysm, pairs[i, 0], pairs[i, 1]) for i in range(len(poses))]
        torch.cuda.synchronize()
    t0 = None
    for i in range(len(poses)):
        if i == c.N_WARM:
            sysm.flush()
            t0 = time.perf_counter()
        if feats is None:
            sysm.track_stereo(pairs[i, 0], pairs[i, 1], c.FRAME_DT * i, frame_id=i)
        else:
            sysm.track_features(feats[i], c.FRAME_DT * i, frame_id=i)
    sysm.flush()
    t1 = time.perf_counter()
    idx, ate, errs = c.trajectory_errors(tr, poses)
    kf_frames = [t.frame_id for t in tr.telemetry if t.kf_inserted >= 0]
    sysm.shutdown()
    late_jobs = [j for j in jobs if j[3] >= t0]
    late_frames = frames[c.N_WARM:]
    plain = [f for f in late_frames if not f[3]]
    with_kf = [f for f in late_frames if f[3]]
    out = {
        "variant": variant, "sched_flags": sched, "blocking_rc": blocking_rc,
        "frames_per_s": (len(poses) - c.N_WARM) / (t1 - t0),
        "keyframes": len(kf_frames), "keyframe_frames": kf_frames,
        "ate_m": float(ate), "worst_m": float(max(errs)),
        "jobs_after_warm_wall_cpu_ms": [[round(1e3 * w, 1), round(1e3 * cp, 1)]
                                        for w, cp, _, _ in late_jobs],
        "job_median_wall_ms": statistics.median(1e3 * j[0] for j in late_jobs) if late_jobs else None,
        "job_median_cpu_ms": statistics.median(1e3 * j[1] for j in late_jobs) if late_jobs else None,
        "job_reads_median": median_totals([j[2] for j in late_jobs]),
        "frame_median_wall_ms": statistics.median(1e3 * f[0] for f in plain) if plain else None,
        "frame_median_cpu_ms": statistics.median(1e3 * f[1] for f in plain) if plain else None,
        "frame_reads_median": median_totals([f[2] for f in plain]),
        "frames_without_keyframe": len(plain),
        "kf_frame_median_wall_ms": statistics.median(1e3 * f[0] for f in with_kf) if with_kf else None,
        "kf_frame_median_cpu_ms": statistics.median(1e3 * f[1] for f in with_kf) if with_kf else None,
        "kf_frame_reads_median": median_totals([f[2] for f in with_kf]),
        "frames_with_keyframe": len(with_kf),
    }
    return out


def extract_features(sysm, left, right):
    """System.track_stereo's extraction of one stereo pair, untracked."""
    import torch

    from hyslam_tpu_torch.core.frame import FrameFeatures
    from hyslam_tpu_torch.ops.stereo import match_stereo_refined

    cc, cam = sysm.config.cameras["SLAM"], sysm.cameras["SLAM"]
    il, ir = sysm._image(left, cam.scale), sysm._image(right, cam.scale)
    feats2 = sysm._families["SLAM"].extract_batch(torch.stack([il, ir]),
                                                  capacity=sysm._capacity(cc))
    fl = FrameFeatures(*(x[0] for x in feats2))
    fr = FrameFeatures(*(x[1] for x in feats2))
    return match_stereo_refined(fl, fr, il, ir, bf=cam.bf)


def _patch_mapping_stream(P, torch):
    """The mapping thread on a stream of its own: the tracking thread's
    stream is synchronised before a job is queued, the mapping thread's
    before its output is handed back."""
    guarded, push = P._Stages._guarded, P._Stages._push_job

    def own_stream_guarded(self, fn):
        if threading.current_thread().name != "hyslam-mapping" or self._stream is None:
            return guarded(self, fn)

        def body():
            with torch.cuda.stream(torch.cuda.Stream(self._device)):
                fn()
        return guarded(self, body)

    def synced_push(self, item):
        torch.cuda.current_stream().synchronize()
        return push(self, item)

    run_job = P.SystemPipeline._run_job

    def synced_run_job(self, job):
        out = run_job(self, job)
        torch.cuda.current_stream().synchronize()
        return out

    P._Stages._guarded = own_stream_guarded
    P._Stages._push_job = synced_push
    P.SystemPipeline._run_job = synced_run_job


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS))
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("PROBE " + json.dumps(run_one(args.one)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("pipeline_probe: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    rc = 0
    for v in args.variants:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", v],
                           capture_output=True, text=True)
        lines = [ln[6:] for ln in p.stdout.splitlines() if ln.startswith("PROBE ")]
        if p.returncode or not lines:
            print(f"{v}: failed rc {p.returncode}\n{p.stdout[-3000:]}\n{p.stderr[-3000:]}",
                  flush=True)
            rc = 1
            continue
        print(json.dumps({"card": card, **json.loads(lines[0])}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
