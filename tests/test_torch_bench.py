"""bench_torch.py against bench.py on the CPU:

- ``_render_sequence(3)``: the stereo pairs of bench.py's sequence, grey
  levels equal at >= 99.9% of pixels and within 1 grey level everywhere (the
  two renderers agree within 1e-3 before rounding: tests/test_torch_tools.py),
  and the true poses within 1e-6 of bench.py's chained ``se3.exp``;
- the front-end bench's inputs: bench.py's noise pairs, landmarks and
  descriptors bit for bit, its distance bounds and normals within 1e-6
  relative;
- the JSON line has bench.py's keys, with vs_baseline = system_fps / 60;
- a failing measurement ends ``main`` with a non-zero code and no JSON
  line, and with no card the script raises: it never falls back;
- importing bench_torch leaves JAX out.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import bench_torch  # noqa: E402

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "system_fps",
              "system_vs_baseline", "frontend_fps"}


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_render_sequence_matches_bench():
    from hyslam_tpu.geometry import se3

    cam_j, frames_j = bench._render_sequence(3)
    cam_t, frames_t, truth, pts = bench_torch._render_sequence(3)
    assert cam_t._asdict() == {**cam_j._asdict(), "Tcam": None}
    assert frames_t.shape == (3, 2, 720, 1280) and pts.shape == (4000, 3)
    d = np.abs(frames_t - np.stack([np.stack(p) for p in frames_j]))
    print(f"pixels apart {(d > 0).mean():.2e}, largest {d.max():.2e}")
    assert (np.rint(frames_t) == np.rint(np.stack([np.stack(p) for p in frames_j]))).mean() \
        >= 0.999
    assert d.max() <= 1.0
    delta = np.asarray(se3.exp(jnp.asarray([0, 0.002, 0, 0, 0, -0.08], dtype=jnp.float32)))
    T = np.eye(4, dtype=np.float32)
    for i in range(3):
        np.testing.assert_allclose(truth[i], T, atol=1e-6)
        T = (delta @ T).astype(np.float32)


def test_frontend_inputs_match_bench(monkeypatch):
    import hyslam_tpu.slam.frontend as jfrontend

    seen = {}

    class Captured(Exception):
        pass

    def capture(cam, cfg, capacity, pair, Tcw0, lm_pos, lm_normal, lm_desc, lm_max, lm_min,
                lm_valid, th):
        seen.update(cam=cam, cfg=cfg, capacity=capacity, pair=np.asarray(pair),
                    lm_pos=np.asarray(lm_pos), lm_normal=np.asarray(lm_normal),
                    lm_desc=np.asarray(lm_desc), lm_max_dist=np.asarray(lm_max),
                    lm_min_dist=np.asarray(lm_min), lm_valid=np.asarray(lm_valid), th=th)
        raise Captured

    monkeypatch.setattr(jfrontend, "track_stereo_frame", capture)
    with pytest.raises(Captured):
        bench.bench_frontend_fps()
    got = bench_torch.frontend_inputs("cpu")
    assert got["imgs"][0].numpy().tobytes() == seen["pair"].tobytes()
    assert got["lm_pos"].numpy().tobytes() == seen["lm_pos"].tobytes()
    assert got["lm_desc"].numpy().view(np.uint32).tobytes() == seen["lm_desc"].tobytes()
    assert got["lm_valid"].numpy().all() and seen["lm_valid"].all()
    for key in ("lm_normal", "lm_max_dist", "lm_min_dist"):
        np.testing.assert_allclose(got[key].numpy(), seen[key], rtol=1e-6, atol=0)
    cam = bench_torch.bench_camera()
    assert cam._asdict() == {**seen["cam"]._asdict(), "Tcam": None}
    assert seen["capacity"] == 1024 and seen["th"] == 3.0 and seen["cfg"].n_features == 1000


def test_result_line_has_bench_keys():
    line = bench_torch.result_line(7.5, 30.0)
    assert set(line) == BENCH_KEYS
    assert line["metric"] == "system_frames_per_second_1chip_1280x720_stereo_1000feat"
    assert line["vs_baseline"] == line["system_vs_baseline"] == round(7.5 / 60, 3)
    assert line["value"] == line["system_fps"] == 7.5 and line["unit"] == "frames/s"


def test_a_failing_measurement_exits_non_zero():
    code = ("import sys\n"
            "import bench_torch\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'hyslam_tpu.')) or m == 'hyslam_tpu']\n"
            "assert not bad, bad\n"
            "def boom(*a, **k):\n"
            "    raise RuntimeError('measurement failed')\n"
            "bench_torch.bench_system_fps = boom\n"
            "sys.exit(bench_torch.main())\n")
    proc = _run(code)
    assert proc.returncode != 0 and "measurement failed" in proc.stderr, proc.stderr
    assert '"metric"' not in proc.stdout, proc.stdout


def test_without_a_card_the_script_raises():
    proc = _run("import runpy; runpy.run_path('bench_torch.py', run_name='__main__')")
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr, proc.stderr
    assert '"metric"' not in proc.stdout, proc.stdout
