"""mapper_ms_per_kf: host ms of one Mapper.integrate_keyframe call
(slam/mapper.py over solver/ba.py), averaged over the window's calls,
from the traced run's wrappers."""


def read(run):
    spans = run.spans.get("mapper")
    return 1e3 * sum(spans) / len(spans) if spans else None
