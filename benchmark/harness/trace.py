"""The device trace of the traced run's slice, reduced in memory.

``torch.profiler`` records the slice's host calls, its kernel launches and
its device rows (kernels, copies, sets). Nothing is written to disk. The
reduction keeps: the device rows (name, start, duration), the launches
inside each ``bench:<layer>`` range, the union of the device rows (the busy
time) and the gaps between them, each named by the innermost layer range
that was open on the host when the gap began.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


class Slice(NamedTuple):
    wall_s: float                  # host seconds from the slice's start to its end
    frames: int                    # frames fed in the slice
    rows: list                     # [(name, start_us, dur_us)] device rows
    ranges: dict                   # layer -> [(start_us, end_us, launches)]
    busy_s: float                  # union of the device rows
    gaps: list                     # [(layer, seconds)] idle gaps, longest first
    solves: tuple                  # (first, last + 1) solve indices in the slice


def events(prof):
    """(name, on_device, start_us, dur_us) of every event the profiler kept."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        out.append((e.name, e.device_type == DeviceType.CUDA,
                    float(e.time_range.start), float(e.time_range.elapsed_us())))
    return out


def union(spans):
    """Merged (start, end) intervals of spans [(start, end)], sorted."""
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def reduce(events, wall_s: float, frames: int, solves: tuple) -> Slice:
    """``events``: (name, on_device, start_us, dur_us) tuples."""
    rows, host_ranges, launches = [], defaultdict(list), []
    for name, on_dev, start, dur in events:
        if on_dev:
            if not name.startswith("bench:"):   # a range's own device row
                rows.append((name, start, dur))
        elif name.startswith("bench:"):
            host_ranges[name[len("bench:"):]].append((start, start + dur))
        elif name in LAUNCHES:
            launches.append(start)
    launches.sort()
    ranges = {}
    for layer, spans in host_ranges.items():
        ranges[layer] = [(a, b, bisect.bisect_right(launches, b) - bisect.bisect_left(launches, a))
                         for a, b in spans]
    merged = union((s, s + d) for _, s, d in rows)
    busy_us = sum(b - a for a, b in merged)
    gaps = []
    flat = sorted((a, b, layer) for layer, spans in host_ranges.items() for a, b in spans)
    for (_, end), (start, _) in zip(merged, merged[1:]):
        # innermost open range: the latest-starting one that still holds `end`
        layer = "host"
        for a, b, name in flat:
            if a > end:
                break
            if b >= end:
                layer = name
        gaps.append((layer, (start - end) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    return Slice(wall_s=wall_s, frames=frames, rows=rows, ranges=ranges,
                 busy_s=busy_us * 1e-6, gaps=gaps, solves=solves)


def breakdown(sl: Slice) -> dict:
    """The ten device operations that took most time and the ten longest
    idle gaps, each [name, seconds]."""
    by_name = defaultdict(float)
    for name, _, dur in sl.rows:
        by_name[name[:160]] += dur * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in sl.gaps[:10]]}
