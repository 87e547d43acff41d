"""track_ms: host ms a window frame spends in the tracker's dispatched
step (slam/strategies.py:track_normal_step over slam/localmap.py and
features/matcher.py, the pose-only solves included), from the traced
run's wrappers."""


def read(run):
    spans = run.spans.get("track")
    return 1e3 * sum(spans) / run.frames if spans and run.frames else None
