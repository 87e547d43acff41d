"""One run of one cell: set-up, the measured window, the per-layer readings
of a traced run, the correctness check, and the result line.

The loop is closed: a recorded sequence replayed by one caller (the async
tracking loop, ``commit_lag`` 2, loop closing off in the present cells),
one *step* after another for ``seconds``, then one ``System.flush()``,
which commits every frame in flight, runs the map work they made and
waits for the device. A step is one SLAM frame (``track_stereo``) and the
frames of the rig's other cameras that are due with it (``Feeder``); in a
one-camera cell, one call. A configuration may name a finalization call,
``finalize``: ``{"call": <a System method, such as
run_imaging_bundle_adjustment>, "kwargs": {...}}``, which runs after the
flush, outside the timed metrics, timed on its own.

- ``fps``: steps in the window over the time from the first call to the
  return of the closing ``flush()``.
- ``frame_ms_p90``: the 90th percentile of the wall time of every step in
  the window, the last one's including the ``flush()``.
- ``setup_s``: process start to the first timed call: imports, the kernel
  build or its cached library, rendering, the System and its warm steps.

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
from collections import defaultdict
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import check, sequence, trace
from benchmark.harness.probes import Probes

OK_STATES = ("NORMAL", "POSTINIT")
SLICE_AT = 0.3          # the traced slice starts at this share of the window
SLICE_FRAMES = (4, 10)  # ... and holds at least 4 steps and two keyframe
                        # integrations, or 10 steps


class SequenceExhausted(RuntimeError):
    pass


def log(*a):
    print(*a, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


FEED_KEYS = ("every", "frame_dt", "place")   # a camera block's feed, not CameraConfig's


def rig_blocks(cfg: dict) -> dict:
    """camera name -> its block, the SLAM camera first: ``camera`` (with
    the top-level ``extractor``) is the SLAM camera, and ``cameras`` adds
    blocks of ``io/config.py:CameraConfig``'s own fields (intrinsics at
    native size, ``bf``, ``scale``, ``mono``, ``Tcam``, ``extractor``, ...)
    and the feed: ``every`` (one frame each n SLAM frames) or ``frame_dt``,
    and ``place`` (each frame goes to ``place_imaging_frame``)."""
    rig = {"SLAM": dict(cfg["camera"], extractor=cfg["extractor"])} if "camera" in cfg else {}
    for name, block in cfg.get("cameras", {}).items():
        if name in rig:
            raise ValueError(f"camera {name!r} is given twice")
        rig[name] = block
    if next(iter(rig), None) != "SLAM":
        raise ValueError("a rig needs a SLAM camera, first")
    return rig


def rig_cameras(cfg: dict) -> dict:
    """camera name -> sequence.Camera, at native size."""
    cams = {}
    for name, b in rig_blocks(cfg).items():
        cams[name] = sequence.Camera(
            b["fx"], b["fy"], b["cx"], b["cy"], b["width"], b["height"],
            0.0 if b.get("mono") else b.get("bf", 0.0), scale=b.get("scale", 1.0),
            Tcam=b.get("Tcam"), every=b.get("every", 1), frame_dt=b.get("frame_dt"))
    return cams


def make_system(cfg: dict, device):
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
    from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
    from hyslam_tpu_torch.slam.system import System

    cameras = {}
    for name, b in rig_blocks(cfg).items():
        fields = {k: v for k, v in b.items() if k not in FEED_KEYS}
        fields["extractor"] = ExtractorConfig(**fields.get("extractor", {}))
        if "policy" in fields:
            fields["policy"] = KeyFramePolicyParams(**fields["policy"])
        fields.setdefault("fps", 1.0 / b.get("frame_dt", cfg["frame_dt"] * b.get("every", 1)))
        cameras[name] = CameraConfig(name=name, **fields)
    return System(SystemConfig(cameras=cameras, caps=MapCaps(**cfg["caps"]),
                               device=device, **cfg["system"]))


class Feeder:
    """Feeds one step through the System's own entries: the SLAM frame
    (``track_stereo``), then each other camera's frames due before the next
    SLAM frame, in timestamp order (a stereo camera's by ``track_stereo``,
    a monocular one's by ``track_monocular(camera=name)``, then
    ``place_imaging_frame`` where its block sets ``place``)."""

    def __init__(self, system, seq, cfg: dict, probes):
        self.system, self.seq, self.probes = system, seq, probes
        blocks = rig_blocks(cfg)
        self.stereo = {n: b.get("bf", 0.0) > 0 and not b.get("mono") for n, b in blocks.items()}
        self.place = {n: bool(b.get("place")) for n, b in blocks.items()}
        self.placed = defaultdict(dict)      # camera -> frame -> kept by the placer
        self.due = defaultdict(list)         # step -> [(time, camera, frame)]
        for name, feed in seq.feeds.items():
            for k, (t, step) in enumerate(zip(feed.times.tolist(), feed.steps.tolist())):
                self.due[step].append((t, list(blocks).index(name), name, k))
        for due in self.due.values():
            due.sort()

    def __call__(self, i: int):
        s, p, seq = self.system, self.probes, self.seq
        p.camera, p.frame = "SLAM", i
        s.track_stereo(seq.pairs[i, 0], seq.pairs[i, 1], timestamp=seq.frame_dt * i, frame_id=i)
        for t, _, name, k in self.due.get(i, ()):
            p.camera, p.frame = name, k
            img = seq.feeds[name].images[k]
            if self.stereo[name]:
                s.track_stereo(img[0], img[1], timestamp=t, camera=name, frame_id=k)
            else:
                s.track_monocular(img, timestamp=t, camera=name, frame_id=k)
            if self.place[name]:
                self.placed[name][k] = s.place_imaging_frame(t, imaging_camera=name)[0]


class CheckRun(SimpleNamespace):
    """What a run keeps for the correctness check, read by harness/check.py
    and by ``checks/<number>.py``: ``seed``, ``control``, ``cfg``, ``rig``
    (rig_blocks), ``seq`` (the rendered sequence with its truth),
    ``steps`` (the window's SLAM frames), ``cameras`` (name -> CameraRun),
    ``solves`` [(camera, frame, args, result)] and ``local_ba`` [(camera,
    frame, problem, result)] of the window, ``calls`` ((module, attribute)
    -> [probes.Call]) of the window and the finalization, and
    ``finalize`` (None, or its ``call``, ``result`` and ``seconds``)."""


class CameraRun(SimpleNamespace):
    """One camera's part of a CheckRun: ``frames`` (its window frames: the
    SLAM camera's steps, another camera's own frame indices), ``features``
    (frame -> extracted features), ``matched`` (frame -> left features
    after stereo), ``placed`` (frame -> the placer's keep), ``states``
    (frame -> its last telemetry state), and ``traj`` and ``kfs``: (frame
    ids, Tcw [n, 4, 4], true Tcw [n, 4, 4]) of the window's tracked frames
    and of its keyframes as the map holds them at the end (after the
    finalization)."""


def _camera_run(tk, frames, truth: np.ndarray, cam_dt: float, probes, placed,
                name: str) -> CameraRun:
    states, _ = _states(tk)
    ms = tk.ms
    size = int(tk.traj.size)
    fid = np.rint(tk.traj.t[:size].cpu().numpy() / cam_dt).astype(int)
    Tcw = tk.traj.Tcw[:size].cpu().numpy()
    in_win = np.isin(fid, frames)
    kvalid = (ms.kf.valid & ~ms.kf.bad).cpu().numpy()
    kfid = ms.kf.frame_id.cpu().numpy()
    kin = kvalid & np.isin(kfid, frames)
    return CameraRun(frames=list(frames), features=dict(probes.extracted[name]),
                     matched=dict(probes.matched[name]), placed=dict(placed), states=states,
                     traj=(fid[in_win], Tcw[in_win], truth[fid[in_win]]),
                     kfs=(kfid[kin], ms.kf.Tcw.cpu().numpy()[kin], truth[kfid[kin]]))


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
    cannot measure (a sequence too short, an arena too small, a compared
    number that no file reads). ``records``, where given, receives what
    the metric readers read."""
    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    checks = {k: bench.check(k) for k in check.numbers_named(limits)}
    wraps = sorted({tuple(w) for mod in checks.values() for w in getattr(mod, "WRAPS", ())})
    parts = {}
    t = time.perf_counter()
    import hyslam_tpu_torch  # noqa: F401  (numeric settings: TF32 off, deterministic)
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    if device.type == "cuda":
        from hyslam_tpu_torch import kernels
        kernels.load()
    parts["import_and_build"] = time.perf_counter() - t

    t = time.perf_counter()
    rig = rig_cameras(cfg)
    seq = sequence.build(rig, traffic, cfg["frame_dt"], seed, seconds, device)
    _sync(device)
    parts["render"] = time.perf_counter() - t

    t = time.perf_counter()
    system = make_system(cfg, device)
    probes = Probes(system, spans=traced, wraps=wraps).install()
    feed = Feeder(system, seq, cfg, probes)
    pairs = seq.pairs
    for i in range(seq.warm):
        feed(i)
    system.flush()
    parts["system_and_warm"] = time.perf_counter() - t
    probes.clear()
    feed.placed.clear()
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
        a = time.perf_counter()
        try:
            feed(i)
        except Exception:          # a step whose call raised counts as failed
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

    # ----------------------------------------------------------- after it
    finalize = None
    if cfg.get("finalize"):
        call, kw = cfg["finalize"]["call"], cfg["finalize"].get("kwargs", {})
        probes.camera, probes.frame = "SLAM", None
        t = time.perf_counter()
        result = getattr(system, call)(**kw)
        _sync(device)
        finalize = SimpleNamespace(call=call, result=result, seconds=time.perf_counter() - t)
        log(f"finalization {call}: {finalize.seconds:.3f} s")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    tk = system.trackers["SLAM"]
    states, kf_frames = _states(tk)
    failed = sorted(set(raised) | {f for f in window if states.get(f) not in OK_STATES})
    n_kf = sum(1 for f in window if f in kf_frames)
    k1_launches = pose_optimization_cuda.launches - k1_at
    caps = cfg["caps"]
    nonkf = [x for f, x in zip(window, times) if f not in kf_frames]
    log(f"window: {len(window)} steps of {n} in the sequence, {n_kf} keyframes, "
        f"{len(failed)} failed, K1 launches {k1_launches} (solves seen {len(probes.solves)}), "
        f"median step {1e3 * statistics.median(times):.3f} ms, median non-keyframe step "
        f"{1e3 * statistics.median(nonkf or times):.3f} ms")
    cameras = {"SLAM": _camera_run(tk, window, seq.poses, seq.frame_dt, probes,
                                   feed.placed["SLAM"], "SLAM")}
    for cam, fd in seq.feeds.items():
        frames = [k for k, st in enumerate(fd.steps.tolist()) if seq.warm <= st < i]
        cam_dt = rig[cam].frame_dt or rig[cam].every * seq.frame_dt
        cameras[cam] = _camera_run(system.trackers[cam], frames, fd.poses, cam_dt, probes,
                                   feed.placed[cam], cam)
        log(f"camera {cam}: {len(frames)} window frames, {len(cameras[cam].traj[0])} "
            f"tracked, {len(cameras[cam].kfs[0])} keyframes, placer kept "
            f"{sum(bool(x) for x in feed.placed[cam].values())} of {len(feed.placed[cam])}")
    for cam, t_ in system.trackers.items():
        next_kf, next_lm = (int(x) for x in torch.stack([t_.ms.next_kf, t_.ms.next_lm]).tolist())
        log(f"arenas{'' if cam == 'SLAM' else ' of ' + cam}: keyframes {next_kf} of "
            f"K={caps['K']}, landmark rows allocated {next_lm} of L={caps['L']}")
        if next_lm > caps["L"]:
            raise RuntimeError(f"landmark rows recycled ({next_lm} allocations > L): raise L "
                               f"in {cell['config']}'s file")
        if next_kf >= caps["K"]:
            raise RuntimeError(f"the keyframe arena filled ({next_kf} of K): raise K")
    log("setup parts (s): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items()))

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
                         for _, _, args, res in probes.solves[sl.solve0:sl.solve1]]
        log(f"trace slice: {sl.frames} steps, {sl.wall:.3f} s, {len(record.slice.rows)} device "
            f"rows, {len(record.solves)} solves, reduced in {time.perf_counter() - t:.1f} s")
        del prof

    # the program's state goes before the reference runs, in blocks of frames
    run = CheckRun(seed=seed, control=control, cfg=cfg, rig=rig_blocks(cfg), seq=seq,
                   steps=list(window), cameras=cameras,
                   solves=list(probes.solves), local_ba=list(probes.local_ba),
                   calls=probes.calls, finalize=finalize)
    probes.uninstall()
    system.shutdown()
    del system, tk, feed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    checks_read, info = check.run(rng, run, limits, checks, control)
    record.check = info
    log(f"check: {info}, {time.perf_counter() - t:.1f} s")
    correct = bool(checks_read) and not raised and all(v <= lim for _, v, lim in checks_read)

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
    for k, v, lim in checks_read:
        print(f"check {k}: {v!r} limit {lim!r}", file=sys.stderr, flush=True)
    line["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks_read}
    return line
