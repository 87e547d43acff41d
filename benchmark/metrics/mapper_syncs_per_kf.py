"""mapper_syncs_per_kf: blocking host calls (cudaStreamSynchronize,
cudaEventSynchronize, cudaDeviceSynchronize) inside each hyslam:mapper
range of the traced slice (the program's span of one
Mapper.integrate_keyframe call), averaged over the slice's calls."""


def read(run):
    pt = getattr(run, "program_trace", None)
    calls = pt.spans.get("mapper") if pt is not None else None
    return sum(r.blocking for r in calls) / len(calls) if calls else None
