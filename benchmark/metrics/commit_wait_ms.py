"""commit_wait_ms: host ms a window frame the async loop waits on the
device for a committed frame's counters (the program's span commit.wait in
slam/tracker.py:Tracker._read), from the program's own tracer in the
traced run."""

from benchmark.harness.program_trace import per_frame


def read(run):
    return per_frame(run, "commit.wait")
