"""Tests of the benchmark's harness, on the CPU at a small size. The
``card`` tests run on a CUDA card and skip elsewhere; they decide inside
the test, never while the module is imported."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


TINY_CAMERA = {"fx": 210.0, "fy": 210.0, "cx": 192.0, "cy": 120.0, "width": 384,
               "height": 240, "bf": 25.2, "th_depth": 35.0}


def make_tiny(root: Path, limits: dict | None = None, traffic: dict | None = None,
              config: dict | None = None, checks: dict | None = None) -> Path:
    """A throwaway benchmark in ``root``: this checkout's metric readers
    and one small cell ``tiny.explore`` (384x240, 400 features, by default
    the explore motion), made from the files alone. ``traffic`` replaces
    the mix, ``config`` adds keys to the configuration (``cameras``,
    ``finalize``), ``checks`` maps a number to the source of its
    checks/<number>.py."""
    bench = root / "benchmark"
    for d in ("configs", "traffic", "limits", "checks"):
        (bench / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(ROOT / "benchmark" / "metrics", bench / "metrics",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "benchmark/configs/hyslam-zedmini-720p.json").read_text())
    cfg.update(name="tiny", camera=TINY_CAMERA,
               extractor=dict(cfg["extractor"], n_features=400),
               caps={"K": 64, "L": 8192, "F": 512, "O": 8}, **(config or {}))
    (bench / "configs/tiny.json").write_text(json.dumps(cfg))
    tr = traffic or json.loads((ROOT / "benchmark/traffic/explore.json").read_text())
    tr.update(warm_frames=8, max_fps=4)
    (bench / "traffic/tiny_explore.json").write_text(json.dumps(tr))
    for name, source in (checks or {}).items():
        (bench / "checks" / f"{name}.py").write_text(source)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["configs"] = [{"name": "tiny", "source": "a test", "file": "benchmark/configs/tiny.json",
                        "reduced": [], "why": "a test"}]
    spec["workloads"] = [{"name": "tiny.explore", "config": "tiny", "traffic": "tiny_explore",
                          "chips": 1, "why": "a test"}]
    for m in spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["tiny.explore"]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    lim = {k: {"limit": v["limit"]} for k, v in json.loads(
        (ROOT / "benchmark/limits/zedmini.explore.json").read_text()).items()
        if isinstance(v, dict) and "limit" in v}
    lim.pop("kf_rpe_m", None)    # a tiny window holds no two keyframes RPE_GAP frames apart
    lim["k1_cost_gap_2nd"] = {"limit": 2e-3}   # the tiny camera's pose solves are weaker
    lim.update(limits or {})
    (bench / "limits/tiny.explore.json").write_text(json.dumps(lim))
    return root


@pytest.fixture
def tiny(tmp_path):
    return make_tiny(tmp_path)


def run_tiny(root: Path, seed: int = 7, seconds: float = 8.0, traced: bool = False,
             records: list | None = None):
    """One run of the tiny cell on the CPU, the harness's look for a card
    skipped; returns the result line."""
    import time

    import torch

    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import Bench

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    return run_cell(Bench(root), "tiny.explore", seed, seconds, traced, torch.device("cpu"),
                    time.perf_counter(), records=records)
