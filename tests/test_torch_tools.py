"""The port's dataset tool, drivers and tools on the CPU:

- tools/make_synthetic_dataset_torch.py against tools/make_synthetic_dataset.py
  on a few frames, read back as arrays by the port's readers: calib.txt
  and times.txt the same text, poses within 1e-6 (TUM's quaternions: the
  rotation matrices within 1e-5), images within 1 grey level (the two
  renderers agree within 1e-3 before the 8-bit truncation) with at most
  0.1% of pixels apart, TUM depth equal on at least 99.9% of pixels and
  within 1 mm (of the 16-bit depth * 5000) elsewhere where both have one;
- examples/run_kitti_torch.py on a short rendered KITTI-layout sequence
  (async, the CPU): its JSON has the JAX driver's keys and more;
- tools/kitti_soak_probe_torch.py's records of a small map state and path;
- the tools and drivers import neither JAX nor the JAX package;
- (slow) the 80-frame soak of tests/test_soak.py through the port's driver,
  with its bounds.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hyslam_tpu_torch.io.datasets import KittiOdometry, TumRgbd

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

NEW_MODULES = ["tools.make_synthetic_dataset_torch", "tools.bench_multihost_torch",
               "tools.bench_ba_torch", "tools.eval_loop_pr_torch",
               "tools.profile_system_torch", "tools.repeat_phase8_torch",
               "examples.torch_common",
               "examples.run_kitti_torch", "examples.run_tum_torch",
               "examples.run_synthetic_torch", "examples.run_euroc_torch",
               "examples.run_dual_camera_torch", "tools.kitti_soak_probe_torch",
               "tools.train_synthetic_vocab_torch"]
JAX_KITTI_KEYS = {"dataset", "sequence", "mode", "frames_fed", "frames_tracked",
                  "tracked_fraction", "fps", "wall_s", "ate_rmse_m", "rpe_trans_m",
                  "rpe_rot_deg"}


def _images_close(a: np.ndarray, b: np.ndarray):
    assert a.shape == b.shape
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    assert d.max() <= 1.0 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


def test_kitti_layout_matches_the_jax_tool(tmp_path):
    from tools import make_synthetic_dataset as jtool
    from tools import make_synthetic_dataset_torch as ttool

    jroot, troot = tmp_path / "j", tmp_path / "t"
    jtool.gen_kitti(str(jroot), 3, seed=0, n_loops=0.02)
    ttool.gen_kitti(str(troot), 3, seed=0, n_loops=0.02)
    seq = Path("sequences") / "00"
    for name in ("calib.txt", "times.txt"):
        assert (jroot / seq / name).read_text() == (troot / seq / name).read_text()
    np.testing.assert_allclose(np.loadtxt(troot / "poses" / "00.txt"),
                               np.loadtxt(jroot / "poses" / "00.txt"), atol=1e-6)
    dj, dt = KittiOdometry(str(jroot)), KittiOdometry(str(troot))
    assert dt.calib == dj.calib and len(dt) == len(dj) == 3
    for fj, ft in zip(dj.frames(), dt.frames()):
        _images_close(ft.img_left, fj.img_left)
        _images_close(ft.img_right, fj.img_right)
        np.testing.assert_allclose(ft.gt_Tcw, fj.gt_Tcw, atol=1e-5)


def test_tum_layout_matches_the_jax_tool(tmp_path, monkeypatch):
    from tools import make_synthetic_dataset as jtool
    from tools import make_synthetic_dataset_torch as ttool

    jroot, troot = tmp_path / "j", tmp_path / "t"
    jtool.gen_tum(str(jroot), 2, seed=0, n_loops=0.02)
    ttool.gen_tum(str(troot), 2, seed=0, n_loops=0.02)
    assert (troot / "rgb" / "0.000000.pgm").exists()
    dj, dt = TumRgbd(str(jroot)), TumRgbd(str(troot))
    assert [t for t, _ in dt.rgb] == [t for t, _ in dj.rgb]
    for (_, _, ij, zj), (_, _, it, zt) in zip(dj.frames(), dt.frames()):
        _images_close(it, ij)
        same = zt == zj
        both = (zt > 0) & (zj > 0)
        assert same.mean() >= 0.999, same.mean()
        assert np.abs(zt - zj)[both & ~same].max(initial=0.0) <= 1e-3
    # where PIL is absent (the card's machine) the pure-numpy reader gives
    # the PIL reader's images and 16-bit depth
    with_pil = next(dt.frames())
    monkeypatch.setitem(sys.modules, "PIL", None)
    without = next(dt.frames())
    np.testing.assert_array_equal(without[2], with_pil[2])
    np.testing.assert_array_equal(without[3], with_pil[3])
    gj, gt = dj.gt, dt.gt
    np.testing.assert_allclose(gt[:, :4], gj[:, :4], atol=1e-6)
    from hyslam_tpu_torch.io.datasets import _mat_from_quat

    for rj, rt in zip(gj, gt):
        np.testing.assert_allclose(_mat_from_quat(rt[[7, 4, 5, 6]]),
                                   _mat_from_quat(rj[[7, 4, 5, 6]]), atol=1e-5)


def test_run_kitti_torch_writes_its_soak_json(tmp_path):
    """6 frames with the full soak's motion a frame (80 frames over 0.14 of
    the circuit in tests/test_soak.py), async, on the CPU."""
    from examples.run_kitti_torch import main as kitti_main
    from tools.make_synthetic_dataset_torch import main as gen_main

    root = tmp_path / "kitti"
    assert gen_main(["kitti", str(root), "--frames", "6", "--loops", "0.0105"]) == 0
    art = tmp_path / "soak.json"
    assert kitti_main([str(root), "--out", str(tmp_path / "out"), "--mode", "async",
                       "--json", str(art), "--synthetic", "--device", "cpu"]) == 0
    rep = json.loads(art.read_text())
    assert JAX_KITTI_KEYS <= set(rep) and rep["synthetic"] is True and rep["device"] == "cpu"
    assert rep["frames_fed"] == 6 and rep["tracked_fraction"] >= 0.9, rep
    assert rep["ate_rmse_m"] < 0.1, rep
    assert (tmp_path / "out" / "tracking_async.txt").read_text().count("\n") == 7
    assert (tmp_path / "out" / "map.npz").exists()


def test_kitti_soak_probe_writes_its_rows(tmp_path):
    """tools/kitti_soak_probe_torch.py's records, without a run: the arena's
    counts of a small map state (a bad landmark named by a keyframe),
    the trajectory's record of a path with one frame 1 m off, and both
    written and read back."""
    import torch

    from hyslam_tpu_torch.core import mapstate
    from hyslam_tpu_torch.core.frame import FrameFeatures
    from hyslam_tpu_torch.geometry import se3
    from tools.kitti_soak_probe_torch import COLUMNS, arena_row, trajectory_record, write_records

    rng = np.random.default_rng(0)
    F = 32

    def feats(n):
        return FrameFeatures(
            uv=torch.from_numpy(rng.uniform(0, 640, (F, 2)).astype(np.float32)),
            ur=torch.full((F,), -1.0), depth=torch.full((F,), -1.0),
            level=torch.zeros(F, dtype=torch.int32), angle=torch.zeros(F),
            desc=torch.from_numpy(rng.integers(0, 2**31, (F, 8), dtype=np.int32)),
            valid=torch.arange(F) < n)

    ms = mapstate.empty_map_state(mapstate.MapCaps(8, 64, F, 4))
    f0 = feats(20)
    none = torch.full((F,), -1, dtype=torch.int32)
    ms, k0 = mapstate.add_keyframe(ms, f0, se3.identity(), 0.0, 0, 0, none, origin=True)
    ms, lm = mapstate.add_landmarks(ms, torch.tile(torch.tensor([0.0, 0.0, 5.0]), (F, 1)),
                                    f0.desc, k0, torch.arange(F, dtype=torch.int32),
                                    torch.arange(F) < 15)
    ms = mapstate.set_landmarks_bad(ms, torch.arange(64) == int(lm[0]))
    assoc = torch.where(torch.arange(F) < 5, lm, -1).to(torch.int32)   # lm[0] held
    ms, _ = mapstate.add_keyframe(ms, feats(10), se3.identity(), 1.0, 1, 0, assoc)
    virgin, live, recyclable, bad_names, not_held, younger = arena_row(ms)
    assert (virgin, live, bad_names, not_held, younger) == (49, 14, 1, 0, 0)
    assert recyclable in (0, 1)

    frame = np.arange(150)
    gt = np.tile(np.eye(4), (150, 1, 1))
    gt[:, 2, 3] = -0.8 * frame
    est = gt.copy()
    est[120, 0, 3] += 1.0
    rec = trajectory_record(est, gt, frame)
    assert [f for f, _ in rec["steps_off"]] == [120, 121]
    assert abs(rec["steps_off"][0][1] - 1.0) < 1e-9
    assert list(rec["segment_ate_se3"]) == ["0-99", "100-199"]
    assert rec["segment_ate_se3"]["0-99"] < 1e-3 < rec["segment_ate_se3"]["100-199"]

    write_records(str(tmp_path), [(0,) + arena_row(ms)], rec)
    rows = np.loadtxt(tmp_path / "probe.tsv", skiprows=1, ndmin=2).astype(int)
    assert rows.shape == (1, len(COLUMNS)) and rows[0, 1] == 49
    assert json.loads((tmp_path / "probe.json").read_text())["steps_off"][0][0] == 120


def test_tools_and_drivers_import_without_jax():
    code = ("import importlib, sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            f"for m in {NEW_MODULES!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'hyslam_tpu.')) or m == 'hyslam_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_repeat_phase8_reads_rows_and_summaries():
    from tools.repeat_phase8_torch import rows_and_summary

    text = ("  8a frame 0: INITIALIZE motion 0 inliers 0 kf 0\n"
            "phase 8a: 90 rows, 86 trajectory poses, 86 keyframes, n_maps 2, sub-map moved "
            "at frame 29, ATE 0.042637 m, worst frame 43\n"
            "phase 8a: the first loop joins keyframe 68\n"
            "  8b frame 0: INITIALIZE motion 0 inliers 0 kf 0\n"
            "  8b frame 1: POSTINIT motion 0 inliers 393 kf 1\n"
            "phase 8b: 90 rows, 83 trajectory poses, 57 keyframes, n_maps 3, ATE 0.458232 m\n")
    got = rows_and_summary(text)
    assert got["a"] == {"rows": ["  8a frame 0: INITIALIZE motion 0 inliers 0 kf 0"],
                        "ate": 0.042637, "n_maps": 2}
    assert len(got["b"]["rows"]) == 2 and got["b"]["ate"] == 0.458232
    assert got["b"]["n_maps"] == 3


@pytest.mark.slow
def test_kitti_layout_soak_bounds(tmp_path):
    """tests/test_soak.py through the port: 80 frames over 0.14 of the
    circuit, async, at least 90% tracked and ATE under 2 m."""
    from examples.run_kitti_torch import main as kitti_main
    from tools.make_synthetic_dataset_torch import main as gen_main

    root = tmp_path / "kitti"
    assert gen_main(["kitti", str(root), "--frames", "80", "--loops", "0.14"]) == 0
    art = tmp_path / "soak.json"
    assert kitti_main([str(root), "--out", str(tmp_path / "out"), "--mode", "async",
                       "--json", str(art), "--synthetic", "--device", "cpu"]) == 0
    rep = json.loads(art.read_text())
    assert rep["frames_fed"] == 80
    assert rep["tracked_fraction"] >= 0.90, rep
    assert rep["ate_rmse_m"] < 2.0, rep
