"""Readings of the program's own spans in one cell, for the tracer's
metrics and its cost: runs of the cell with the System's tracer
(``hyslam_tpu_torch/utils/telemetry.py:StageTimer``) on or off, in one
process. Not a benchmark run: the benchmark measures with the tracer off.
It prints one ``SPANS {json}`` line a run.

    python3 benchmark/spans.py --workload <cell> --seconds <s> --trace <0|1> \\
        --plan on:1,off:1,off:2,on:2 [--out build/spans.jsonl]

An ``on`` run turns the tracer on at the first frame of the window, so its
spans are the window's, and reads the metrics of the program's spans
(``metrics/{fuse,triangulate,local_ba}_ms_per_kf.py``, ``commit_wait_ms.py``
and, with ``--trace 1``, ``mapper_syncs_per_kf.py``); each span name's
calls, host and self ms; how much of each ``mapper`` and ``frame`` span its
children cover; the jobs' cost per unit of their counters (ms a
triangulation pair, a fusion call, a local BA on each path); what the
slowest tenth of the frames is made of, by the spans' frame id; and, traced, the program's ``frontend``, ``track`` and
``mapper`` beside the benchmark's wrappers' ``frontend_ms``, ``track_ms``
and ``mapper_ms_per_kf``, the slice's table of ``hyslam:`` ranges and its
longest idle gaps named by them (``harness/program_trace.py``). The
benchmark's own reduction of the slice is handed the events without the
``hyslam:`` ranges' device rows, so its numbers are read as the benchmark
reads them. An ``off`` run is the benchmark's run with the tracer off.
"""

import argparse
import bisect
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM_METRICS = ("fuse_ms_per_kf", "triangulate_ms_per_kf", "local_ba_ms_per_kf",
                   "mapper_syncs_per_kf", "commit_wait_ms")
WRAPPED = {"frontend": "frontend_ms", "track": "track_ms", "mapper": "mapper_ms_per_kf"}


def _children_ns(spans) -> dict:
    """span id -> the time of its child spans, ns."""
    child = defaultdict(int)
    for s in spans:
        if s.parent >= 0:
            child[s.parent] += s.end_ns - s.start_ns
    return child


def _coverage(spans, name):
    """For each span ``name``: the share of it that its children cover."""
    child = _children_ns(spans)
    return [child[s.id] / (s.end_ns - s.start_ns) for s in spans
            if s.name == name and s.end_ns > s.start_ns]


def _by_name(spans, frames):
    """calls, host ms and self ms (less the children) of each span name,
    and host ms a window frame."""
    child = _children_ns(spans)
    out = {}
    for s in spans:
        row = out.setdefault(s.name, {"calls": 0, "host_ms": 0.0, "self_ms": 0.0})
        row["calls"] += 1
        row["host_ms"] += 1e-6 * (s.end_ns - s.start_ns)
        row["self_ms"] += 1e-6 * (s.end_ns - s.start_ns - child[s.id])
    for row in out.values():
        row["ms_a_frame"] = row["host_ms"] / frames if frames else None
    return out


def _per_count(spans) -> dict:
    """The jobs' host ms per unit of their counters: triangulation per
    neighbour pair tried, fusion per ``_fuse_into_kf`` call ([units, ms a
    unit]); local BA's calls and ms a call on the prior path and on the
    plain one."""
    out = {}
    for name, key in (("mapper.triangulate", "pairs"), ("mapper.fuse", "fuse_calls")):
        done = [s for s in spans if s.name == name and s.counters]
        n = sum(s.counters[key] for s in done)
        ms = sum(1e-6 * (s.end_ns - s.start_ns) for s in done)
        out[f"{name}.ms_per_{key}"] = [n, ms / n if n else None]
    for path, prior in (("prior", True), ("plain", False)):
        ms = [1e-6 * (s.end_ns - s.start_ns) for s in spans
              if s.name == "mapper.local_ba" and s.counters["prior"] is prior]
        out["mapper.local_ba." + path] = [len(ms), sum(ms) / len(ms) if ms else None]
    return out


def _slow_frames(spans):
    """What the slowest tenth of the window's frames is made of (at least
    one frame; by their ``frame`` spans): how many, the shortest of them,
    and the host ms a frame of each span name among them, joined by the
    spans' frame id."""
    frames = sorted(((s.end_ns - s.start_ns, s.frame) for s in spans if s.name == "frame"),
                    reverse=True)
    if len(frames) < 2:
        return None
    top = frames[:max(1, len(frames) // 10)]
    slow = {f for _, f in top}
    ms = defaultdict(float)
    for s in spans:
        if s.frame in slow:
            ms[s.name] += 1e-6 * (s.end_ns - s.start_ns)
    return {"frames": len(slow), "shortest_ms": 1e-6 * top[-1][0],
            "ms_a_frame": {n: v / len(slow) for n, v in sorted(ms.items())}}


def _in_gap(events, start_us: float, end_us: float, n: int = 4):
    """The host calls that cover most of an idle gap, innermost first among
    equals: [name, ms of the gap they cover]."""
    over = [(min(s + d, end_us) - max(s, start_us), s, name) for name, dev, s, d in events
            if not dev and s < end_us and s + d > start_us
            and not name.startswith(("hyslam:", "bench:"))]
    over.sort(key=lambda o: (-round(o[0], 1), -o[1]))
    return [[name, 1e-3 * o] for o, _, name in over[:n]]


def _sync_sites(events) -> dict:
    """Blocking host calls counted by the innermost program span and the
    outermost operator open around each: {span: {op: count}}."""
    from benchmark.harness.program_trace import BLOCKING, PREFIX, innermost

    calls = sorted(s for name, dev, s, _ in events if not dev and name in BLOCKING)
    prog, ops = [], []
    for name, dev, s, d in events:
        if not dev and name.startswith(PREFIX):
            prog.append((s, s + d, name[len(PREFIX):]))
        elif not dev and name.startswith("aten::"):
            ops.append((s, s + d, name))
    ops.sort(key=lambda r: (r[0], -r[1]))
    outer, i, top = [], 0, None          # the outermost op open at each call
    for t in calls:
        while i < len(ops) and ops[i][0] <= t:
            if top is None or ops[i][0] > top[1]:
                top = ops[i]             # not inside the last outermost op
            i += 1
        outer.append(top[2] if top is not None and top[1] >= t else "(none)")
    sites = defaultdict(lambda: defaultdict(int))
    for span, op in zip(innermost(prog, calls), outer):
        sites[span or "(none)"][op] += 1
    return {k: dict(v) for k, v in sites.items()}


def _quartiles(xs):
    if len(xs) < 2:
        return xs
    q = statistics.quantiles(xs, n=4)
    return [min(xs), q[0], q[1], q[2], max(xs)]


def spans_run(bench, workload: str, seed: int, seconds: float, traced: bool, on: bool,
              device) -> dict:
    """One run of the cell, the tracer on or off; returns what it read."""
    from benchmark.harness import cell, program_trace, trace

    warm = int(bench.traffic(bench.cell(workload)["traffic"])["warm_frames"])
    systems, captured = [], []
    make, reduce = cell.make_system, trace.reduce

    def make_system(cfg, dev):
        s = make(cfg, dev)
        systems.append(s)
        if on:
            feed = s.track_stereo

            def track_stereo(*a, **kw):
                if kw.get("frame_id") == warm:
                    s.timer.enabled = True
                return feed(*a, **kw)
            s.track_stereo = track_stereo
        return s

    def reduce_without_program_rows(events, *a):
        captured.append(events)
        return reduce([e for e in events if not (e[1] and e[0].startswith("hyslam:"))], *a)

    cell.make_system, trace.reduce = make_system, reduce_without_program_rows
    records = []
    try:
        line = cell.run_cell(bench, workload, seed, seconds, traced, device,
                             time.perf_counter(), records=records)
    finally:
        cell.make_system, trace.reduce = make, reduce
    run = records[0]
    out = {"cell": workload, "mode": "on" if on else "off", "seed": seed, "traced": traced,
           "correct": line["correct"], "attempted": line["attempted"],
           "failed": line["failed"], "device": line["device"],
           "metrics": {k: v["value"] for k, v in line["metrics"].items()}}
    if not on:
        return out
    timer = systems[0].timer
    run.program_spans = spans = list(timer.spans)
    if captured:
        run.program_trace = program_trace.reduce(captured[0])
    out["tracer"] = {"spans": len(spans), "dropped": timer.dropped}
    out["program_metrics"] = {m: bench.reader(m)(run) for m in PROGRAM_METRICS}
    out["spans"] = _by_name(spans, run.frames)
    out["coverage"] = {n: _quartiles(_coverage(spans, n)) for n in ("mapper", "frame")}
    out["per_count"] = _per_count(spans)
    out["slow_frames"] = _slow_frames(spans)
    if traced:
        names = {"frontend": run.frames, "track": run.frames,
                 "mapper": sum(1 for s in spans if s.name == "mapper")}
        out["against_wrappers"] = {
            n: [out["spans"].get(n, {}).get("host_ms", 0.0) / max(k, 1),
                out["metrics"].get(WRAPPED[n])] for n, k in names.items()}
        out["breakdown"] = line.get("breakdown")
    pt = getattr(run, "program_trace", None)
    if pt is not None:
        out["slice"] = program_trace.table(pt)
        ends = [s + d for s, d in pt.blocking]      # one thread: in order
        gaps = []
        for name, sec, start in pt.gaps[:10]:
            i = bisect.bisect_right(ends, start + 1.0) - 1
            gaps.append([name, sec] + ([1e-3 * (start - ends[i]), 1e-3 * pt.blocking[i][1]]
                                       if i >= 0 else [None, None])
                        + [_in_gap(captured[0], start, start + 1e6 * sec)])
        # [name, s, ms since the last blocking call ended, its ms, the host
        # calls that cover the gap]
        out["gaps"] = gaps
        out["sync_sites"] = _sync_sites(captured[0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--plan", required=True, help="on:seed,off:seed,... in the order run")
    ap.add_argument("--out", default=None, help="a JSONL file each line is appended to")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, ROOT)
    from benchmark.harness.spec import Bench

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = Bench()
    for part in args.plan.split(","):
        mode, seed = part.split(":")
        out = spans_run(bench, args.workload, int(seed), args.seconds, bool(args.trace),
                        mode == "on", device)
        text = json.dumps(out)
        print("SPANS " + text, flush=True)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
