"""k1_roofline: the pose kernel K1's share of its roofline, %: the mean
least time of the slice's solves (harness/roofline.py:k1_bound, from each
launch's observations, valid observations and returned inliers) over the
mean device time of the slice's K1 rows (csrc/pose_opt.cu's
pose_opt_kernel). Means, not sums: the profiler may drop a row."""

from benchmark.harness.roofline import k1_bound

KERNEL = "pose_opt_kernel"


def read(run):
    sl = run.slice
    if sl is None or not run.solves:
        return None
    rows = [dur for name, _, dur in sl.rows if KERNEL in name]
    if not rows:
        return None
    bound_ms = sum(k1_bound(n, v, i)["bound_ms"] for n, v, i in run.solves) / len(run.solves)
    return 100.0 * bound_ms / (1e-3 * sum(rows) / len(rows))
