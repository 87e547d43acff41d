"""The port's tracer (``utils/telemetry.py:StageTimer``) inside the System,
on the CPU: an async stereo System over a short rendered sequence with
tracing off and on, the last frames under ``torch.profiler``, and the
threaded pipeline with tracing on.

Off, the run keeps no span and puts no ``hyslam:`` range in the profiler's
trace. On, its rows, keyframes and poses are the same bits; the spans nest
inside their parents on their own thread, count what the telemetry counts,
and start on the profiler's clock."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.utils import synth
from hyslam_tpu_torch.utils.telemetry import OFF, StageTimer

from port_helpers import one_thread  # noqa: F401  (one CPU thread: equal bits)

CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=180.0, width=640, height=360, bf=45.0)
N = 10             # frames fed
PROFILED = 2       # the last frames, under the profiler
JOBS = ("mapper.refresh", "mapper.cull_lm", "mapper.triangulate", "mapper.fuse",
        "mapper.local_ba", "mapper.cull_kf")


@pytest.fixture(scope="module")
def pairs():
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-10, 10, 2000), rng.uniform(-6, 6, 2000),
                    rng.uniform(3, 30, 2000)], -1).astype(np.float32)
    Ts = synth.make_trajectory(N, step=0.1, yaw_rate=0.003)
    return np.stack([synth.render_stereo_pair(CAM, T, pts) for T in Ts])


def config(**kw) -> SystemConfig:
    cc = CameraConfig(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy, width=CAM.width,
                      height=CAM.height, bf=CAM.bf,
                      extractor=ExtractorConfig(n_features=300, n_levels=4))
    return SystemConfig(cameras={"SLAM": cc}, caps=MapCaps(K=32, L=4096, F=512, O=8),
                        enable_loop_closing=False, device="cpu", **kw)


def drive(pairs, trace: bool):
    """The async System over the sequence, the last PROFILED frames under a
    CPU profiler, then the flush; returns (System, [(name, start ns)] of the
    profiler's events, read raw: ``prof.events()`` takes seconds a frame)."""
    s = System(config(async_tracking=True), trace=trace)
    for i in range(N - PROFILED):
        s.track_stereo(pairs[i, 0], pairs[i, 1], 0.1 * i, frame_id=i)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(N - PROFILED, N):
            s.track_stereo(pairs[i, 0], pairs[i, 1], 0.1 * i, frame_id=i)
    s.flush()
    return s, [(e.name(), e.start_ns()) for e in prof.profiler.kineto_results.events()]


def rows(tracker):
    """The telemetry rows, the mapper's counters (a tensor in async mode)
    as lists."""
    return [dict(vars(t), mapper_stats={k: v.tolist() for k, v in t.mapper_stats.items()})
            for t in tracker.telemetry]


@pytest.fixture(scope="module")
def runs(pairs):
    return {"off": drive(pairs, False), "on": drive(pairs, True)}


def by_id(spans):
    return {s.id: s for s in spans}


def assert_nested(spans):
    """Every span closed, inside its parent, on its parent's thread."""
    ids = by_id(spans)
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = ids[s.parent]
            assert p.thread == s.thread, (p.name, s.name)
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (p.name, s.name)


def test_tracing_off_records_nothing(runs):
    s, events = runs["off"]
    assert len(s.timer.spans) == 0 and s.timer.dropped == 0
    assert s.timer.span("frame") is OFF
    assert not [name for name, _ in events if name.startswith("hyslam:")]
    assert any(t.kf_inserted >= 0 for t in s.trackers["SLAM"].telemetry[1:])


def test_tracing_on_changes_no_result(runs):
    (off, _), (on, _) = runs["off"], runs["on"]
    a, b = off.trackers["SLAM"], on.trackers["SLAM"]
    assert rows(a) == rows(b)
    n = int(a.traj.size)
    assert n == int(b.traj.size) == N
    assert torch.equal(a.traj.Tcw[:n], b.traj.Tcw[:n])
    assert torch.equal(a.ms.kf.frame_id, b.ms.kf.frame_id)
    assert torch.equal(a.ms.kf.Tcw, b.ms.kf.Tcw) and torch.equal(a.ms.lm.pos, b.ms.lm.pos)


def test_spans_nest(runs):
    s, _ = runs["on"]
    spans = list(s.timer.spans)
    assert_nested(spans)
    ids = by_id(spans)
    parent = {x.id: ids[x.parent].name if x.parent >= 0 else None for x in spans}
    want = {"frame": {None}, "frontend": {"frame"}, "frontend.extract": {"frontend"},
            "frontend.stereo": {"frontend"}, "track": {"frame"},
            "commit": {"frame", None}, "commit.wait": {"commit"},
            "kf_insert": {"commit"}, "mapper": {"commit"}}
    want.update({j: {"mapper"} for j in JOBS})
    for x in spans:
        assert parent[x.id] in want[x.name], (x.name, parent[x.id])
        if parent[x.id] == "frame":
            assert x.frame == ids[x.parent].frame


def test_span_counts_match_the_telemetry(runs):
    s, _ = runs["on"]
    spans = list(s.timer.spans)
    tel = s.trackers["SLAM"].telemetry
    named = {n: [x for x in spans if x.name == n] for n in {x.name for x in spans}}
    assert [x.frame for x in named["frame"]] == list(range(N))
    assert len(named["frontend.extract"]) == len(named["frontend.stereo"]) == N
    committed = [t for t in tel if t.state != "INITIALIZE"]     # frame 0 is tracked inline
    assert len(named["commit"]) == len(named["commit.wait"]) == len(committed)
    kfs = [t.kf_inserted for t in committed if t.kf_inserted >= 0]
    assert len(named["kf_insert"]) == len(named["mapper"]) == len(kfs)
    assert all(x.counters is None for x in named["kf_insert"] + named["mapper"])
    for job in ("mapper.refresh", "mapper.cull_lm", "mapper.triangulate", "mapper.fuse"):
        assert len(named[job]) == len(kfs)
    assert len(named["mapper.local_ba"]) == len(named["mapper.cull_kf"]) == len(kfs) - 3
    assert all(x.counters == {"prior": False} for x in named["mapper.local_ba"])
    assert all(x.counters["pairs"] >= 0 for x in named["mapper.triangulate"])
    assert sum(x.counters["fuse_calls"] for x in named["mapper.fuse"]) > 0


def test_spans_start_on_the_profilers_clock(runs):
    s, events = runs["on"]
    ranges = sorted((t, name[len("hyslam:"):]) for name, t in events
                    if name.startswith("hyslam:"))
    first = next(x for x in s.timer.spans if x.name == "frame" and x.frame == N - PROFILED)
    last = next(x for x in s.timer.spans if x.name == "frame" and x.frame == N - 1)
    spans = sorted((x.start_ns, x.name) for x in s.timer.spans
                   if first.start_ns <= x.start_ns <= last.end_ns)
    assert [n for _, n in ranges] == [n for _, n in spans]
    offsets = [1e-3 * (ns - t) for (ns, _), (t, _) in zip(spans, ranges)]   # us
    assert len(offsets) > 20 and max(offsets) - min(offsets) <= 200.0


def test_the_buffer_keeps_the_newest_spans():
    t = StageTimer(enabled=True, max_spans=5)
    for i in range(4):
        with t.span("frame", i):
            with t.span("track"):
                pass
    assert t.dropped == 3 and [x.id for x in t.spans] == [3, 4, 5, 6, 7]
    assert [(x.name, x.frame) for x in t.spans][-2:] == [("frame", 3), ("track", 3)]


def test_pipelined_threads_nest_apart(pairs):
    s = System(config(pipelined=True), trace=True)
    try:
        for i in range(8):
            s.track_stereo(pairs[i, 0], pairs[i, 1], 0.1 * i, frame_id=i)
        s.flush()
    finally:
        s.shutdown()
    spans = list(s.timer.spans)
    assert_nested(spans)
    thread = {n: {x.thread for x in spans if x.name == n} for n in ("frame", "track", "mapper")}
    assert all(len(v) == 1 for v in thread.values())
    assert len(set.union(*thread.values())) == 3     # caller, tracking, mapping
    track = [x for x in spans if x.name == "track"]
    assert [x.frame for x in track] == list(range(8)) and {x.parent for x in track} == {-1}
    ids = by_id(spans)
    assert all(ids[x.parent].name == "mapper" for x in spans if x.name in JOBS)
