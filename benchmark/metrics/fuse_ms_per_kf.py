"""fuse_ms_per_kf: host ms of the mapper's fusion job (the program's span
mapper.fuse: slam/mapper.py:fuse_landmarks, both passes over the targets)
over the window's Mapper.integrate_keyframe calls (spans mapper), from the
program's own tracer in the traced run."""

from benchmark.harness.program_trace import per_mapper_call


def read(run):
    return per_mapper_call(run, "mapper.fuse")
