"""local_ba_ms_per_kf: host ms of the mapper's local BA job (the program's
span mapper.local_ba: gather, two-phase solve and scatter, the prior or the
plain path) over the window's mapper calls, from the program's own tracer
in the traced run."""

from benchmark.harness.program_trace import per_mapper_call


def read(run):
    return per_mapper_call(run, "mapper.local_ba")
