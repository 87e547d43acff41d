"""keyframe_share: keyframes the policy inserted for window frames over
the frames fed in the window (slam/tracker.py telemetry rows)."""


def read(run):
    return run.keyframes / run.frames if run.frames else None
