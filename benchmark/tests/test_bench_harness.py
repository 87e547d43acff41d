"""The harness's parts, each on its own: discovery from files, the
trace's union of device rows, the kernel's yardstick, the renderer, the
metric readers, and what a run may import."""

import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.harness import sequence, trace
from benchmark.harness.roofline import k1_bound
from benchmark.harness.spec import Bench

ROOT = Path(__file__).resolve().parents[2]


def test_a_cell_from_new_files_alone(tiny):
    """A new configuration, traffic mix, metric and cell: files and entries
    added, no file of the harness edited."""
    (tiny / "benchmark/metrics/frames_seen.py").write_text(
        "def read(run):\n    return run.frames\n")
    spec = json.loads((tiny / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "frames_seen", "unit": "frames", "better": "higher",
                              "source": "program_counter", "layer": "front end",
                              "moves": "fps", "workloads": ["tiny.explore"]})
    (tiny / "BENCHMARK.json").write_text(json.dumps(spec))
    b = Bench(tiny)
    cell = b.cell("tiny.explore")
    assert b.config(cell["config"])["camera"]["width"] == 384
    assert b.traffic(cell["traffic"])["warm_frames"] == 8
    names = [m["name"] for m in b.metrics("tiny.explore", "per_layer")]
    assert "frames_seen" in names and "mapper_ms_per_kf" in names
    assert b.reader("frames_seen")(SimpleNamespace(frames=3)) == 3
    assert [m["name"] for m in b.metrics("tiny.explore", "end_to_end")] == [
        "fps", "frame_ms_p90", "setup_s"]
    with pytest.raises(KeyError):
        b.cell("no.such.cell")


def test_checkout_cells_resolve():
    b = Bench()
    for w in b.spec["workloads"]:
        cfg = b.config(w["config"])
        assert cfg["name"] == w["config"]
        assert b.traffic(w["traffic"])["max_fps"] > 0
        for kind in ("end_to_end", "per_layer"):
            for m in b.metrics(w["name"], kind):
                assert callable(b.reader(m["name"]))
        limits = b.limits(w["name"])
        compared = [k for k, v in limits.items() if "limit" in v]
        assert compared and all(limits[k]["lower"] < limits[k]["limit"] < limits[k]["upper"]
                                for k in compared)


def test_idle_union_and_gaps():
    ev = [("bench:mapper", False, 0.0, 100.0), ("bench:track", False, 100.0, 50.0),
          ("cudaLaunchKernel", False, 10.0, 1.0), ("cudaLaunchKernel", False, 20.0, 1.0),
          ("cudaLaunchKernel", False, 120.0, 1.0),
          ("k1", True, 10.0, 20.0), ("k2", True, 25.0, 10.0),     # overlap: 10-35
          ("k3", True, 60.0, 10.0),                               # gap 35-60 in mapper
          ("k1", True, 130.0, 5.0),                               # gap 70-130 from mapper
          ("k3", True, 140.0, 2.0),                               # gap 135-140 in track
          ("bench:track", True, 100.0, 50.0)]                     # a range's device row
    sl = trace.reduce(ev, wall_s=150e-6, frames=1, solves=(0, 0))
    assert sl.busy_s == pytest.approx(42e-6)
    assert len(sl.rows) == 5
    assert sl.gaps == [("mapper", pytest.approx(60e-6)), ("mapper", pytest.approx(25e-6)),
                       ("track", pytest.approx(5e-6))]
    assert sl.ranges["mapper"] == [(0.0, 100.0, 2)]
    assert sl.ranges["track"] == [(100.0, 150.0, 1)]
    b = trace.breakdown(sl)
    assert b["device_ops"][0] == ["k1", pytest.approx(25e-6)]
    assert trace.union([(3, 4), (0, 2), (1, 3)]) == [[0, 4]]


@pytest.mark.parametrize("n_obs,n_valid,n_inl,rounds,iters", [
    (1024, 1024, 1000, 4, 10), (1024, 700, 420, 4, 10), (2048, 1800, 1500, 4, 10),
    (3072, 3000, 2900, 2, 5), (64, 10, 0, 4, 10), (5, 5, 5, 0, 10)])
def test_k1_bound_is_chip_smokes(n_obs, n_valid, n_inl, rounds, iters):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    assert k1_bound(n_obs, n_valid, n_inl, rounds, iters) == chip_smoke.k1_bound(
        n_obs, n_valid, n_inl, rounds, iters)


def test_renderer_same_bits_for_a_seed():
    cam = {"SLAM": sequence.Camera(210.0, 210.0, 192.0, 120.0, 384, 240, 25.2)}
    tr = json.loads((ROOT / "benchmark/traffic/explore.json").read_text())
    tr.update(warm_frames=2, max_fps=2)
    a = sequence.build(cam, tr, 0.05, 2**40 + 9, 1.0, "cpu")
    b = sequence.build(cam, tr, 0.05, 2**40 + 9, 1.0, "cpu")
    c = sequence.build(cam, tr, 0.05, 2**40 + 10, 1.0, "cpu")
    assert a.pairs.dtype == torch.uint8 and a.pairs.shape == (4, 2, 240, 384)
    assert torch.equal(a.pairs, b.pairs) and torch.equal(a.points, b.points)
    assert not torch.equal(a.pairs, c.pairs)
    np.testing.assert_array_equal(a.poses, c.poses)        # the seed moves the world only
    assert a.pairs.float().std() > 5                       # texture, not a blank frame


def test_sequence_lengths_and_paths():
    tr = json.loads((ROOT / "benchmark/traffic/explore.json").read_text())
    assert sequence.n_frames(tr, 45) == 24 + 20 * 45
    poses = sequence.path_poses(tr["motion"], 3)
    C = -np.einsum("nji,nj->ni", poses[:, :3, :3], poses[:, :3, 3])
    assert np.linalg.norm(C[1] - C[0]) == pytest.approx(0.08)


def test_world_is_stratified():
    """Every seed puts the same number of points in each stretch of path
    and each cell of the section: only where within them differs."""
    tr = json.loads((ROOT / "benchmark/traffic/drive.json").read_text())
    tr1 = dict(tr, motion={"step_m": 0.8}, world=[tr["world"][1]])   # straight, a facade
    poses = sequence.path_poses(tr1["motion"], 50)
    g = sequence.SECTION_GRID
    layer = tr1["world"][0]
    counts = []
    for seed in (3, 2**33 + 1):
        gen = torch.Generator().manual_seed(seed)
        p = sequence.world_points(tr1, poses, gen, "cpu").double().numpy()
        Twc = np.linalg.inv(poses[0])
        local = (p - Twc[:3, 3]) @ Twc[:3, :3]    # in the first camera's frame
        near = local[(local[:, 2] >= 0) & (local[:, 2] < 9 * g * g / layer["per_m"])]
        lx = np.floor((near[:, 0] - layer["lateral_m"][0])
                      / (layer["lateral_m"][1] - layer["lateral_m"][0]) * g)
        ly = np.floor((near[:, 1] - layer["vertical_m"][0])
                      / (layer["vertical_m"][1] - layer["vertical_m"][0]) * g)
        counts.append(np.histogram2d(lx, ly, bins=g, range=[[0, g], [0, g]])[0])
    np.testing.assert_array_equal(counts[0], counts[1])
    assert (counts[0] == 9).all()


def test_relative_errors_against_the_truth():
    from benchmark.harness import check

    tr = json.loads((ROOT / "benchmark/traffic/explore.json").read_text())
    truth = sequence.path_poses(tr["motion"], 30)
    ids = np.arange(30)
    assert np.abs(check.relative_errors(ids, truth, truth)).max() < 1e-12
    est = truth.copy()
    est[15:, 0, 3] += 0.05          # a 5 cm step in the camera's x from frame 15 on
    err = check.relative_errors(ids, est, truth)
    assert len(err) == 20           # pairs RPE_GAP apart
    np.testing.assert_allclose(err[5:15], 0.05, rtol=1e-6)    # pairs across the step
    assert err[:5].max() < 1e-12 and err[15:].max() < 2e-3    # the yaw between alone


def test_readers():
    b = Bench()
    run = SimpleNamespace(frames=4, window_s=2.0, call_s=[0.1, 0.2, 0.3, 1.4], setup_s=9.0,
                          keyframes=2, spans={"frontend": [0.01] * 8, "track": [0.02] * 4,
                                              "mapper": [0.5, 0.7]}, slice=None, solves=[])
    assert b.reader("fps")(run) == 2.0
    assert b.reader("frame_ms_p90")(run) == pytest.approx(
        1e3 * __import__("statistics").quantiles(run.call_s, n=10)[-1])
    assert b.reader("frontend_ms")(run) == pytest.approx(20.0)
    assert b.reader("track_ms")(run) == pytest.approx(20.0)
    assert b.reader("mapper_ms_per_kf")(run) == pytest.approx(600.0)
    assert b.reader("keyframe_share")(run) == 0.5
    for name in ("k1_roofline", "device_idle_share", "mapper_launches_per_kf"):
        assert b.reader(name)(run) is None                   # nothing traced: nothing read
    rows = [("pose_opt_kernel(...)", 0.0, 100.0), ("pose_opt_kernel(...)", 200.0, 100.0),
            ("other", 100.0, 50.0)]
    run.slice = trace.Slice(wall_s=1e-3, frames=1, rows=rows, ranges={}, busy_s=250e-6,
                            gaps=[], solves=(0, 2))
    run.solves = [(1024, 1024, 1000), (1024, 1024, 1000)]
    expect = 100 * k1_bound(1024, 1024, 1000)["bound_ms"] / 0.1
    assert b.reader("k1_roofline")(run) == pytest.approx(expect)
    assert b.reader("device_idle_share")(run) == pytest.approx(0.75)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for f in (ROOT / "benchmark/reference").glob("*.py"):
        assert not _imports(f) & {"hyslam_tpu_torch", "hyslam_tpu", "jax"}, f
    out = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, sys.argv[1]); "
         "import benchmark.reference.frontend, benchmark.reference.pose_opt; "
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'hyslam_tpu_torch', 'hyslam_tpu', 'jax'}))", str(ROOT)],
        capture_output=True, text=True, check=True).stdout
    assert out.strip() == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny):
    """A whole run of the tiny cell in a fresh process, then the names that
    run.py refuses, compared whole: hyslam_tpu_torch is the port and passes."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); sys.path.insert(0, sys.argv[2]); "
            "import conftest, benchmark.run as r; from pathlib import Path; "
            "line = conftest.run_tiny(Path(sys.argv[3]), seconds=3.0); "
            "print(r.forbidden_modules(), 'hyslam_tpu_torch' in sys.modules, line['attempted'])")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT), str(ROOT / "benchmark/tests"),
                          str(tiny)], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    bad, port, attempted = out.stdout.strip().splitlines()[-1].rsplit(" ", 2)
    assert bad == "[]" and port == "True" and int(attempted) > 0


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    import benchmark.run as r

    monkeypatch.setitem(sys.modules, "hyslam_tpu_torch_extra", object())
    assert r.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert r.forbidden_modules() == ["jaxlib"]


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for a machine without one")
    out = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"), "--workload",
                          "zedmini.explore", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
