"""frame_ms_p90: the 90th percentile of the wall time of every
track_stereo call in the window, the last one's including the closing
flush() (host clock), ms."""

import statistics


def read(run):
    if len(run.call_s) < 2:
        return None
    return 1e3 * statistics.quantiles(run.call_s, n=10)[-1]
