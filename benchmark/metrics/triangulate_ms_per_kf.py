"""triangulate_ms_per_kf: host ms of the mapper's triangulation job (the
program's span mapper.triangulate: slam/mapper.py:triangulate_new_landmarks
over the covisible neighbours) over the window's mapper calls, from the
program's own tracer in the traced run."""

from benchmark.harness.program_trace import per_mapper_call


def read(run):
    return per_mapper_call(run, "mapper.triangulate")
