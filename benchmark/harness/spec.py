"""Where the benchmark's data lives, found by the names in BENCHMARK.json.

Under the benchmark's folder, everything of one configuration, one traffic
mix, one per-layer metric or one cell's correctness limits sits in a file
of its own:

    configs/<config>.json     the camera rig, extractor, arenas and loop
    traffic/<traffic>.json    the motion and world the generator reads
    metrics/<metric>.py       a reader: read(run) -> float or None
    limits/<cell>.json        each compared number's limit and readings
    checks/<number>.py        a compared number that harness/check.py does
                              not compute: read(run) -> float, and WRAPS,
                              the program's calls whose records it reads

so a later change adds a configuration (a rig of cameras among it), a mix,
a metric, a compared number or a cell as new files and new entries, and
edits none.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


class Bench:
    """BENCHMARK.json of a checkout and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return json.loads((self.dir / "traffic" / f"{name}.json").read_text())

    def limits(self, cell: str) -> dict:
        return json.loads((self.dir / "limits" / f"{cell}.json").read_text())

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries that a cell reports:
        those without a ``workloads`` key and those that list it."""
        return [m for m in self.spec[kind] if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The ``read(run)`` of metrics/<metric>.py."""
        return _load(self.dir / "metrics" / f"{metric}.py", f"_bench_metric_{metric}").read

    def check(self, number: str):
        """The module checks/<number>.py: ``read(run) -> float`` and
        ``WRAPS``. Raises FileNotFoundError, naming the file, where there
        is none."""
        path = self.dir / "checks" / f"{number}.py"
        if not path.is_file():
            raise FileNotFoundError(f"{path}: the limits name {number!r}, which "
                                    f"harness/check.py does not compute and no file reads")
        return _load(path, f"_bench_check_{number}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
