"""The readings of the program's own spans (``harness/program_trace.py``,
the five readers over it, ``spans.py``), on built records and slices and
on one traced run of the tiny cell on the CPU."""

from types import SimpleNamespace

import pytest

from benchmark.harness import program_trace, trace
from benchmark.harness.spec import Bench

# test_bench_harness.py:test_idle_union_and_gaps's slice
BENCH_EVENTS = [
    ("bench:mapper", False, 0.0, 100.0), ("bench:track", False, 100.0, 50.0),
    ("cudaLaunchKernel", False, 10.0, 1.0), ("cudaLaunchKernel", False, 20.0, 1.0),
    ("cudaLaunchKernel", False, 120.0, 1.0),
    ("k1", True, 10.0, 20.0), ("k2", True, 25.0, 10.0),
    ("k3", True, 60.0, 10.0),                    # gap 35-60
    ("k1", True, 130.0, 5.0),                    # gap 70-130
    ("k3", True, 140.0, 2.0),                    # gap 135-140
    ("bench:track", True, 100.0, 50.0)]
# the program's ranges over it: bench:mapper nests inside hyslam:mapper
PROGRAM_EVENTS = [
    ("hyslam:mapper", False, -1.0, 102.0), ("hyslam:mapper.fuse", False, 5.0, 60.0),
    ("hyslam:mapper.local_ba", False, 65.0, 34.0),
    ("cudaStreamSynchronize", False, 36.0, 4.0),     # in fuse, before gap 35-60 ends
    ("cudaEventSynchronize", False, 71.0, 2.0),      # in local_ba
    ("cudaStreamSynchronize", False, 125.0, 1.0),    # outside every hyslam: range
    ("hyslam:mapper", True, 10.0, 60.0)]             # a range's own device row


def span(i, name, start_ms, dur_ms, parent=-1, frame=0, **counters):
    return SimpleNamespace(id=i, name=name, start_ns=int(start_ms * 1e6),
                           end_ns=int((start_ms + dur_ms) * 1e6), parent=parent,
                           frame=frame, counters=counters or None)


def test_gaps_take_the_innermost_program_range():
    pt = program_trace.reduce(BENCH_EVENTS + PROGRAM_EVENTS)
    assert [(n, s) for n, s, _ in pt.gaps] == [
        ("mapper.local_ba", pytest.approx(60e-6)), ("mapper.fuse", pytest.approx(25e-6)),
        ("track", pytest.approx(5e-6))]
    fuse, = pt.spans["mapper.fuse"]
    assert (fuse.launches, fuse.blocking, fuse.blocking_us) == (2, 1, 4.0)
    mapper, = pt.spans["mapper"]
    assert (mapper.launches, mapper.blocking, mapper.blocking_us) == (2, 2, 6.0)
    assert mapper.self_us == pytest.approx(102.0 - 60.0 - 34.0)
    row = program_trace.table(pt)["mapper.local_ba"]
    assert row == {"calls": 1, "host_ms": 0.034, "self_ms": 0.034, "launches": 0,
                   "blocking": 1, "blocking_ms": 0.002}
    plain = program_trace.reduce(BENCH_EVENTS)        # no program range: the bench names
    assert [n for n, _, _ in plain.gaps] == [n for n, _ in trace.reduce(
        BENCH_EVENTS, wall_s=150e-6, frames=1, solves=(0, 0)).gaps]


def test_the_benchmarks_reduction_is_unchanged_without_the_program_rows():
    ev = [e for e in BENCH_EVENTS + PROGRAM_EVENTS
          if not (e[1] and e[0].startswith("hyslam:"))]
    a = trace.reduce(ev, wall_s=150e-6, frames=1, solves=(0, 0))
    b = trace.reduce(BENCH_EVENTS, wall_s=150e-6, frames=1, solves=(0, 0))
    assert (a.ranges, a.busy_s, a.gaps, a.rows) == (b.ranges, b.busy_s, b.gaps, b.rows)


def test_program_readers():
    b = Bench()
    spans = [span(0, "mapper", 0, 600), span(1, "mapper.fuse", 10, 200, 0),
             span(2, "mapper.triangulate", 5, 4, 0), span(3, "mapper.local_ba", 300, 250, 0),
             span(4, "mapper", 1000, 400), span(5, "mapper.fuse", 1010, 100, 4),
             span(6, "mapper.triangulate", 1005, 2, 4),
             span(7, "commit.wait", 1500, 3), span(8, "commit.wait", 1600, 5)]
    run = SimpleNamespace(frames=4, program_spans=spans,
                          program_trace=program_trace.reduce(BENCH_EVENTS + PROGRAM_EVENTS))
    assert b.reader("fuse_ms_per_kf")(run) == pytest.approx(150.0)
    assert b.reader("triangulate_ms_per_kf")(run) == pytest.approx(3.0)
    assert b.reader("local_ba_ms_per_kf")(run) == pytest.approx(125.0)
    assert b.reader("commit_wait_ms")(run) == pytest.approx(2.0)
    assert b.reader("mapper_syncs_per_kf")(run) == 2.0
    parent = SimpleNamespace(frames=4, slice=None)      # a run with no program spans
    bare = SimpleNamespace(frames=4, program_spans=[span(0, "frame", 0, 10)],
                           program_trace=program_trace.reduce(BENCH_EVENTS))
    for name in ("fuse_ms_per_kf", "triangulate_ms_per_kf", "local_ba_ms_per_kf",
                 "commit_wait_ms", "mapper_syncs_per_kf"):
        assert b.reader(name)(parent) is None and b.reader(name)(bare) is None


def test_a_traced_tiny_run_with_the_tracer_on(tiny):
    import torch

    from benchmark import spans as tool

    torch.set_num_threads(4)
    out = tool.spans_run(Bench(tiny), "tiny.explore", 11, 8.0, True, True, torch.device("cpu"))
    assert out["correct"] and out["tracer"]["dropped"] == 0
    got = out["program_metrics"]
    assert all(got[m] > 0 for m in ("fuse_ms_per_kf", "triangulate_ms_per_kf",
                                    "local_ba_ms_per_kf", "commit_wait_ms"))
    # the CPU has no blocking runtime call; the slice may hold no keyframe
    assert got["mapper_syncs_per_kf"] == (0.0 if "mapper" in out["slice"] else None)
    assert out["coverage"]["mapper"][0] > 0.9 and out["coverage"]["frame"][0] > 0.9
    for name, (program, wrapped) in out["against_wrappers"].items():
        assert program == pytest.approx(wrapped, rel=0.1), name
    assert out["slice"]["frame"]["calls"] >= 4
    assert {"mapper_ms_per_kf", "frontend_ms", "track_ms"} <= set(out["metrics"])
    assert out["per_count"]["mapper.fuse.ms_per_fuse_calls"][0] > 0
    assert out["per_count"]["mapper.local_ba.plain"][0] > 0
    assert out["slow_frames"]["frames"] >= 1 and out["slow_frames"]["ms_a_frame"]["frame"] > 0


def test_counters_and_frame_ids_are_read():
    from benchmark import spans as tool

    spans = [span(0, "mapper.triangulate", 0, 6, pairs=3),
             span(1, "mapper.triangulate", 10, 2, pairs=1),
             span(2, "mapper.fuse", 20, 30, fuse_calls=6),
             span(3, "mapper.local_ba", 60, 40, prior=False),
             span(4, "mapper.local_ba", 100, 20, prior=True),
             span(5, "mapper.local_ba", 120, 30, prior=False)]
    assert tool._per_count(spans) == {
        "mapper.triangulate.ms_per_pairs": [4, pytest.approx(2.0)],
        "mapper.fuse.ms_per_fuse_calls": [6, pytest.approx(5.0)],
        "mapper.local_ba.prior": [1, pytest.approx(20.0)],
        "mapper.local_ba.plain": [2, pytest.approx(35.0)]}
    frames = [span(10 + f, "frame", 100 * f, 10 + 90 * (f == 7), frame=f) for f in range(10)]
    inner = [span(30, "track", 700, 5, 17, frame=7), span(31, "mapper", 706, 80, 17, frame=7),
             span(32, "track", 0, 4, 10, frame=0)]
    slow = tool._slow_frames(frames + inner)
    assert slow["frames"] == 1 and slow["shortest_ms"] == pytest.approx(100.0)
    assert slow["ms_a_frame"] == {"frame": pytest.approx(100.0), "mapper": pytest.approx(80.0),
                                  "track": pytest.approx(5.0)}
    assert tool._slow_frames(frames[:1]) is None
