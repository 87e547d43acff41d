"""On a CUDA card: one short run of each cell through the command as the
benchmark runs it, and the correctness control, which has to come out
not correct. Skipped where there is no card (decided inside each test).

    python3 -m pytest benchmark/tests/test_bench_card.py -q     # on the card
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]


def _run(cell, seed, *extra, seconds=12):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload", cell,
                          "--seed", str(seed), "--seconds", str(seconds), *extra],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["zedmini.explore", "kitti.drive"])
def test_cell_runs_and_is_correct(cell):
    line = _run(cell, 2**31 + 17, "--trace", "0")
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert {"fps", "frame_ms_p90", "setup_s"} <= set(line["metrics"])


@pytest.mark.card
@pytest.mark.parametrize("cell", ["zedmini.explore", "kitti.drive"])
def test_control_is_not_correct(cell):
    """Lower precision in place of float32: the front end in bfloat16, the
    pose-only solve and the local BA with TF32 on."""
    line = _run(cell, 2**31 + 19, "--trace", "0", "--control")
    assert not line["correct"], line["checks"]
