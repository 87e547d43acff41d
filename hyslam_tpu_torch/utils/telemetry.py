"""Structured run telemetry: TSV logs, stage timing and device profiling
(counterpart of ``hyslam_tpu/utils/telemetry.py``, same TSV columns).

- ``tracking_data.txt``: one row per frame (camera, frame id, state,
  inlier and match counts, map sizes, the keyframe-insertion outcome).
- ``localmapping_data.txt``: per-keyframe job counters (triangulated and
  fused landmark counts, BA cost, culled keyframes).
- ``StageTimer``: accumulating wall-clock spans per pipeline stage; a span
  is also a ``torch.profiler.record_function`` range, so it shows up in a
  trace taken with ``device_trace``.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import IO

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


@dataclass
class StageTimer:
    """Accumulating wall-clock spans per pipeline stage.

    with timer.span("extract"): ...   # also a torch.profiler range
    """

    totals: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        from torch.profiler import record_function

        t0 = time.perf_counter()
        with record_function(name):
            yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        n = self.counts.get(name, 0)
        return 1e3 * self.totals.get(name, 0.0) / max(n, 1)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            lines.append(
                f"{name}: n={self.counts[name]} total={self.totals[name]:.3f}s "
                f"mean={self.mean_ms(name):.2f}ms"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace (host ranges, and the card's kernels
    and copies where there is one) around a block, and write it as a Chrome
    trace, ``log_dir/trace.json`` (open in chrome://tracing or Perfetto)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
