"""mapper_launches_per_kf: kernel launches (cudaLaunchKernel calls on the
host) inside each Mapper.integrate_keyframe range of the traced slice,
averaged over the slice's calls."""


def read(run):
    sl = run.slice
    if sl is None or not sl.ranges.get("mapper"):
        return None
    calls = sl.ranges["mapper"]
    return sum(n for _, _, n in calls) / len(calls)
