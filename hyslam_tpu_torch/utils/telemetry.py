"""Structured run telemetry: TSV logs and the program's tracer (counterpart
of ``hyslam_tpu/utils/telemetry.py``, same TSV columns).

- ``tracking_data.txt``: one row per frame (camera, frame id, state,
  inlier and match counts, map sizes, the keyframe-insertion outcome).
- ``localmapping_data.txt``: per-keyframe job counters (triangulated and
  fused landmark counts, BA cost, culled keyframes).
- ``StageTimer``: the tracer. Spans of the System's layers and the
  mapper's jobs, kept in memory with their nesting, frame id and counters;
  each is also a ``torch.profiler`` range ``hyslam:<name>``, on the clock
  of the device trace.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import IO

from torch.autograd.profiler import record_function

TRACKING_COLUMNS = [
    "camera", "frame_id", "timestamp", "state", "n_motion", "n_inliers",
    "n_local", "kf_inserted", "n_seeded", "n_kfs", "n_landmarks",
]

MAPPING_COLUMNS = [
    "camera", "kf_id", "culled", "triangulated", "fused", "fuse_added",
    "ba_cost", "kf_culled",
]


class _TSVLog:
    def __init__(self, path: str, columns: list[str]):
        self.path = path
        self.columns = columns
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f: IO = open(path, "w")
        self._f.write("\t".join(columns) + "\n")

    def write_row(self, **values) -> None:
        row = [str(values.get(c, "")) for c in self.columns]
        self._f.write("\t".join(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class TrackingLog(_TSVLog):
    """``run_data/tracking_data.txt`` analog."""

    def __init__(self, path: str = "run_data/tracking_data.txt"):
        super().__init__(path, TRACKING_COLUMNS)

    def log(self, camera: str, tel, timestamp: float = 0.0,
            n_kfs: int = 0, n_landmarks: int = 0) -> None:
        """tel: slam.tracker.TrackerTelemetry."""
        self.write_row(
            camera=camera, frame_id=tel.frame_id, timestamp=timestamp,
            state=tel.state, n_motion=tel.n_motion, n_inliers=tel.n_inliers,
            n_local=tel.n_local, kf_inserted=tel.kf_inserted,
            n_seeded=tel.n_seeded, n_kfs=n_kfs, n_landmarks=n_landmarks,
        )


class MappingLog(_TSVLog):
    """``run_data/localmapping_data.txt`` analog."""

    def __init__(self, path: str = "run_data/localmapping_data.txt"):
        super().__init__(path, MAPPING_COLUMNS)

    def log(self, camera: str, kf_id: int, stats: dict) -> None:
        """stats: the dict returned by Mapper.integrate_keyframe."""
        self.write_row(camera=camera, kf_id=kf_id, **{
            k: stats.get(k, "") for k in MAPPING_COLUMNS[2:]
        })




class _Off:
    """The span of a tracer that is off: enters, exits and notes nothing.
    It is also a tracer that is always off (``span`` returns itself), the
    default of a ``Mapper`` or ``Tracker`` built without one: it holds no
    state, so nothing it is shared by can turn it on."""

    __slots__ = ()

    def span(self, name, frame=None):
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def note(self, key, value) -> None:
        pass


OFF = _Off()


class Span:
    """One span's record: ``name``; ``start_ns`` and ``end_ns`` from
    ``time.perf_counter_ns`` (``end_ns`` None while open); ``id``, the
    tracer's running count; ``parent``, the id of the span open around it on
    the same thread (-1: none); ``frame``, the frame id it belongs to (its
    own where given, else its parent's, else -1); ``thread``, the thread's
    ident; ``counters``, host-known counts noted on it (None: none). While
    open it is also a ``torch.profiler`` range ``hyslam:<name>``, so a
    profiler's trace holds it and puts it on the device trace's clock."""

    __slots__ = ("id", "name", "start_ns", "end_ns", "parent", "frame", "thread",
                 "counters", "_stack", "_range")

    def __init__(self, span_id: int, name: str, parent, frame, stack: list):
        self.id = span_id
        self.name = name
        self.parent = -1 if parent is None else parent.id
        self.frame = frame if frame is not None else (-1 if parent is None else parent.frame)
        self.thread = threading.get_ident()
        self.counters = None
        self.start_ns = self.end_ns = None
        self._stack = stack
        self._range = None

    def note(self, key: str, value) -> None:
        """Attach a host-known count to the span."""
        if self.counters is None:
            self.counters = {}
        self.counters[key] = value

    def __enter__(self):
        self._stack.append(self)
        self._range = record_function("hyslam:" + self.name)
        self.start_ns = time.perf_counter_ns()
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        self.end_ns = time.perf_counter_ns()
        self._stack.pop()
        self._range = self._stack = None
        return None


class StageTimer:
    """The program's tracer: spans at the System's layer boundaries and
    around each of the mapper's jobs, kept in memory.

        with timer.span("mapper.fuse") as sp:   # also a profiler range
            ...
            sp.note("fuse_calls", n)

    Off (the default) ``span`` returns ``OFF`` after one attribute check: no
    clock read, no profiler range, no allocation. On (``enabled = True``) it
    keeps a ``Span`` record of every span in ``spans``, the newest
    ``max_spans``; ``dropped`` counts the older ones let go. Spans nest per
    thread, so threads that trace at once keep apart trees."""

    MAX_SPANS = 65536

    def __init__(self, enabled: bool = False, max_spans: int = MAX_SPANS):
        self.enabled = enabled
        self.spans: deque = deque(maxlen=max_spans)
        self._started = 0
        self._lock = threading.Lock()
        self._local = threading.local()

    def span(self, name: str, frame: int | None = None):
        """A span ``name`` over a ``with`` block; ``frame``: the frame id it
        belongs to (default: the enclosing span's)."""
        if not self.enabled:
            return OFF
        stack = self._local.__dict__.setdefault("stack", [])
        with self._lock:
            sp = Span(self._started, name, stack[-1] if stack else None, frame, stack)
            self._started += 1
            self.spans.append(sp)
        return sp

    @property
    def dropped(self) -> int:
        """Spans recorded and let go for the bound."""
        return self._started - len(self.spans)
