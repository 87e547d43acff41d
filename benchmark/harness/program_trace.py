"""The program's own spans in a traced run: the tracer's records
(``hyslam_tpu_torch/utils/telemetry.py:StageTimer``, off unless a run turns
it on) and their ``hyslam:<name>`` ranges in the profiler's slice.

``reduce`` keeps, for each ``hyslam:`` range of the slice, its kernel
launches and its blocking host calls (the runtime's synchronisations) with
their time, and names each idle gap of the device by the innermost
``hyslam:`` range open on the host when the gap began, else by the
innermost ``bench:`` range (``trace.reduce``'s names), else ``host``. The
ranges nest by time: one thread launches (the async loop).

``per_mapper_call`` and ``per_frame`` are the readers' arithmetic over the
tracer's records, which a run keeps as ``run.program_spans``.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from itertools import accumulate
from typing import NamedTuple

from benchmark.harness.trace import LAUNCHES, union

PREFIX = "hyslam:"
BLOCKING = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize")


class Range(NamedTuple):
    start_us: float
    end_us: float
    self_us: float                 # the range less its child ranges
    launches: int
    blocking: int                  # blocking host calls that start inside it
    blocking_us: float             # ... and their time


class ProgramTrace(NamedTuple):
    spans: dict                    # span name -> [Range]
    gaps: list                     # [(name, seconds, start_us)] idle gaps, longest first
    blocking: list                 # [(start_us, dur_us)] every blocking call, by start


def innermost(ranges, times):
    """For each time of ``times`` (ascending): the name of the latest
    starting range [(start, end, name)] still open at it, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()          # closed before the next one opened
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def reduce(events) -> ProgramTrace:
    """``events``: (name, on_device, start_us, dur_us), as ``trace.events``."""
    rows, prog, bench, launches, blocking = [], [], [], [], []
    for name, on_dev, start, dur in events:
        if on_dev:
            if not name.startswith(("bench:", PREFIX)):   # a range's own device row
                rows.append((start, start + dur))
        elif name.startswith(PREFIX):
            prog.append((start, start + dur, name[len(PREFIX):]))
        elif name.startswith("bench:"):
            bench.append((start, start + dur, name[len("bench:"):]))
        elif name in LAUNCHES:
            launches.append(start)
        elif name in BLOCKING:
            blocking.append((start, dur))
    launches.sort()
    blocking.sort()
    b_start = [s for s, _ in blocking]
    b_cum = [0.0, *accumulate(d for _, d in blocking)]

    prog.sort(key=lambda r: (r[0], -r[1]))
    child_us = [0.0] * len(prog)
    stack = []
    for i, (a, b, _) in enumerate(prog):
        while stack and prog[stack[-1]][1] <= a:
            stack.pop()
        if stack:
            child_us[stack[-1]] += b - a
        stack.append(i)
    spans = defaultdict(list)
    for (a, b, name), child in zip(prog, child_us):
        lo, hi = bisect.bisect_left(b_start, a), bisect.bisect_right(b_start, b)
        spans[name].append(Range(
            a, b, b - a - child,
            bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a),
            hi - lo, b_cum[hi] - b_cum[lo]))

    merged = union(rows)
    idle = [(end, start) for (_, end), (start, _) in zip(merged, merged[1:])]
    at = [end for end, _ in idle]
    names = [p or b or "host" for p, b in zip(innermost(prog, at), innermost(bench, at))]
    gaps = sorted(((n, (start - end) * 1e-6, end) for n, (end, start) in zip(names, idle)),
                  key=lambda g: -g[1])
    return ProgramTrace(spans=dict(spans), gaps=gaps, blocking=blocking)


def table(pt: ProgramTrace) -> dict:
    """One row per span name: calls, host ms, self ms, launches, blocking
    calls and their ms, each summed over the slice."""
    return {name: {"calls": len(rs),
                   "host_ms": 1e-3 * sum(r.end_us - r.start_us for r in rs),
                   "self_ms": 1e-3 * sum(r.self_us for r in rs),
                   "launches": sum(r.launches for r in rs),
                   "blocking": sum(r.blocking for r in rs),
                   "blocking_ms": 1e-3 * sum(r.blocking_us for r in rs)}
            for name, rs in sorted(pt.spans.items())}


def _ms(spans, name):
    return [1e-6 * (s.end_ns - s.start_ns) for s in spans
            if s.name == name and s.end_ns is not None]


def per_mapper_call(run, name: str):
    """Host ms of the spans ``name`` over the window's ``mapper`` spans, or
    None where the run kept no such spans."""
    spans = getattr(run, "program_spans", None)
    if not spans:
        return None
    job, calls = _ms(spans, name), _ms(spans, "mapper")
    return sum(job) / len(calls) if job and calls else None


def per_frame(run, name: str):
    """Host ms of the spans ``name`` over the window's frames, or None."""
    spans = getattr(run, "program_spans", None)
    ms = _ms(spans, name) if spans else []
    return sum(ms) / run.frames if ms and run.frames else None
