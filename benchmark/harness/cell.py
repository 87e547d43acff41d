"""One run of one cell: set-up, the measured window, the per-layer readings
of a traced run, the correctness check, and the result line.

The loop is closed: a recorded stereo sequence replayed by one caller, the
next frame fed when ``System.track_stereo`` returns (the async tracking
loop, ``commit_lag`` 2, loop closing off), for ``seconds``, then one
``System.flush()``, which commits every frame in flight, runs the map work
they made and waits for the device.

- ``fps``: frames fed in the window over the time from the first call to
  the return of the closing ``flush()``.
- ``frame_ms_p90``: the 90th percentile of the wall time of every call in
  the window, the last call's including the ``flush()``.
- ``setup_s``: process start to the first timed call: imports, the kernel
  build or its cached library, rendering, the System and its warm frames.

A traced run (``trace``) wraps the program's layers from outside
(``probes.Probes``) and records a bounded slice of the window with
``torch.profiler`` (``trace.py``); its result line carries the per-layer
metrics, each read by ``metrics/<name>.py``.
"""

from __future__ import annotations

import statistics
import sys
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, sequence, trace
from benchmark.harness.probes import Probes

OK_STATES = ("NORMAL", "POSTINIT")
SLICE_AT = 0.3          # the traced slice starts at this share of the window
SLICE_FRAMES = (4, 10)  # ... and holds at least 4 frames and two keyframe
                        # integrations, or 10 frames


class SequenceExhausted(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_system(cfg: dict, device):
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
    from hyslam_tpu_torch.slam.system import System

    c = cfg["camera"]
    cc = CameraConfig(fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"], width=c["width"],
                      height=c["height"], bf=c["bf"], th_depth=c["th_depth"],
                      fps=1.0 / cfg["frame_dt"], extractor=ExtractorConfig(**cfg["extractor"]))
    return System(SystemConfig(cameras={"SLAM": cc}, caps=MapCaps(**cfg["caps"]),
                               device=device, **cfg["system"]))


def _states(tracker) -> dict:
    """frame id -> the state of its last telemetry row, and the frames
    whose commit inserted a keyframe."""
    states, kf_frames = {}, set()
    for t in tracker.telemetry:
        states[t.frame_id] = t.state
        if t.kf_inserted >= 0:
            kf_frames.add(t.frame_id)
    return states, kf_frames


def run_cell(bench, name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, control: bool = False, records: list | None = None) -> dict:
    """One run; returns the result line's dict. Raises where the run
    cannot measure (a sequence too short, an arena too small). ``records``,
    where given, receives what the metric readers read."""
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    parts = {}
    t = time.perf_counter()
    import hyslam_tpu_torch  # noqa: F401  (numeric settings: TF32 off, deterministic)
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    if device.type == "cuda":
        from hyslam_tpu_torch import kernels
        kernels.load()
    parts["import_and_build"] = time.perf_counter() - t

    t = time.perf_counter()
    c = cfg["camera"]
    cam = sequence.Camera(c["fx"], c["fy"], c["cx"], c["cy"], c["width"], c["height"], c["bf"])
    seq = sequence.build(cam, traffic, cfg["frame_dt"], seed, seconds, device)
    _sync(device)
    parts["render"] = time.perf_counter() - t

    t = time.perf_counter()
    system = make_system(cfg, device)
    probes = Probes(system, spans=traced).install()
    dt = seq.frame_dt
    pairs = seq.pairs
    for i in range(seq.warm):
        probes.frame = i
        system.track_stereo(pairs[i, 0], pairs[i, 1], timestamp=dt * i, frame_id=i)
    system.flush()
    parts["system_and_warm"] = time.perf_counter() - t
    for store in (probes.extracted, probes.matched, probes.spans):
        store.clear()
    probes.solves.clear()
    probes.local_ba.clear()
    if control:
        check._tf32(True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    k1_at = pose_optimization_cuda.launches

    # ---------------------------------------------------------------- window
    times, raised = [], []
    prof = sl = None
    n = len(pairs)
    i = seq.warm
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    while time.perf_counter() - t0 < seconds:
        if i >= n:
            raise SequenceExhausted(
                f"the sequence's {n} frames ran out {time.perf_counter() - t0:.1f} s into "
                f"a {seconds} s window: raise max_fps in traffic/{cell['traffic']}.json")
        if traced and prof is None and time.perf_counter() - t0 >= SLICE_AT * seconds:
            from torch.profiler import ProfilerActivity, profile
            _sync(device)
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                           if device.type == "cuda" else [ProfilerActivity.CPU])
            prof.start()
            sl = SimpleNamespace(t0=time.perf_counter(), frames=0,
                                 solve0=len(probes.solves), kf0=len(probes.spans["mapper"]))
        probes.frame = i
        a = time.perf_counter()
        try:
            system.track_stereo(pairs[i, 0], pairs[i, 1], timestamp=dt * i, frame_id=i)
        except Exception:          # a frame whose call raised counts as failed
            traceback.print_exc()
            raised.append(i)
        times.append(time.perf_counter() - a)
        i += 1
        if sl is not None and not hasattr(sl, "wall"):
            sl.frames += 1
            kfs = len(probes.spans["mapper"]) - sl.kf0
            if sl.frames >= SLICE_FRAMES[1] or (sl.frames >= SLICE_FRAMES[0] and kfs >= 2):
                _sync(device)
                sl.wall = time.perf_counter() - sl.t0
                sl.solve1 = len(probes.solves)
                prof.stop()
    if sl is not None and not hasattr(sl, "wall"):
        prof.stop()            # the window closed inside the slice: nothing to read
        sl = None
    a = time.perf_counter()
    system.flush()
    t_end = time.perf_counter()
    times[-1] += t_end - a
    window = range(seq.warm, i)
    fps = len(window) / (t_end - t0)

    # ----------------------------------------------------------- after it
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tk = system.trackers["SLAM"]
    states, kf_frames = _states(tk)
    failed = sorted(set(raised) | {f for f in window if states.get(f) not in OK_STATES})
    n_kf = sum(1 for f in window if f in kf_frames)
    k1_launches = pose_optimization_cuda.launches - k1_at
    ms = tk.ms
    next_kf, next_lm = (int(x) for x in torch.stack([ms.next_kf, ms.next_lm]).tolist())
    caps = cfg["caps"]
    size = int(tk.traj.size)
    fid = np.rint(tk.traj.t[:size].cpu().numpy() / dt).astype(int)
    Tcw = tk.traj.Tcw[:size].cpu().numpy()
    in_win = (fid >= seq.warm) & (fid < i)
    kvalid = (ms.kf.valid & ~ms.kf.bad).cpu().numpy()
    kfid = ms.kf.frame_id.cpu().numpy()
    kin = kvalid & (kfid >= seq.warm) & (kfid < i)
    poses = {"rpe_m": (fid[in_win], Tcw[in_win]),
             "kf_rpe_m": (kfid[kin], ms.kf.Tcw.cpu().numpy()[kin])}
    nonkf = [x for f, x in zip(window, times) if f not in kf_frames]
    log(f"window: {len(window)} frames of {n} in the sequence, {n_kf} keyframes, "
        f"{len(failed)} failed, K1 launches {k1_launches} (solves seen {len(probes.solves)}), "
        f"median frame {1e3 * statistics.median(times):.3f} ms, median non-keyframe frame "
        f"{1e3 * statistics.median(nonkf or times):.3f} ms")
    log(f"arenas: keyframes {next_kf} of K={caps['K']}, landmark rows allocated {next_lm} of "
        f"L={caps['L']}")
    log("setup parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))
    if next_lm > caps["L"]:
        raise RuntimeError(f"landmark rows recycled ({next_lm} allocations > L): raise L in "
                           f"{cell['config']}'s file")
    if next_kf >= caps["K"]:
        raise RuntimeError(f"the keyframe arena filled ({next_kf} of K): raise K")

    record = SimpleNamespace(frames=len(window), window_s=t_end - t0, call_s=times,
                             setup_s=setup_s, keyframes=n_kf, spans=dict(probes.spans),
                             slice=None, solves=[])
    if records is not None:
        records.append(record)
    if sl is not None and hasattr(sl, "wall"):
        t = time.perf_counter()
        record.slice = trace.reduce(trace.events(prof), sl.wall, sl.frames,
                                    (sl.solve0, sl.solve1))
        record.solves = [(int(args[2].shape[0]), int(args[6].sum()), int(res[2]))
                         for _, args, res in probes.solves[sl.solve0:sl.solve1]]
        log(f"trace slice: {sl.frames} frames, {sl.wall:.3f} s, {len(record.slice.rows)} device "
            f"rows, {len(record.solves)} solves, reduced in {time.perf_counter() - t:.1f} s")
        del prof

    # the program's state goes before the reference runs, in blocks of frames
    probes.uninstall()
    system.shutdown()
    del system, tk, ms
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    checks, info = check.run(rng, set(window), probes, seq, cfg, poses, limits, control)
    record.check = info
    log(f"check: {info}, {time.perf_counter() - t:.1f} s")
    correct = bool(checks) and not raised and all(v <= lim for _, v, lim in checks)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in bench.metrics(name, kind):
        value = bench.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": len(window), "failed": len(failed),
            "metrics": metrics, "device": dev}
    if record.slice is not None:
        dev["busy_s"] = record.slice.busy_s
        dev["window_s"] = record.slice.wall_s
        line["breakdown"] = trace.breakdown(record.slice)
    for k, v, lim in checks:
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return line
