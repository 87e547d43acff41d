"""Rigs, path forms and compared numbers as files: a one-camera cell
renders the bits it rendered before rigs were data, the hold-and-sway path
does what its file says, a two-camera cell runs from files alone, and a
number that ``checks/<number>.py`` reads decides ``correct``. Each run is
of a tiny cell on the CPU, the harness's look for a card skipped."""

import copy
import hashlib
import math

import numpy as np
import pytest
import torch

from benchmark.harness import faults, sequence
from benchmark.harness.cell import rig_cameras
from benchmark.harness.spec import Bench
from conftest import make_tiny, run_tiny

# sha256 of the tiny cell's pairs (seed 2**40 + 9, 2 s: 16 pairs), rendered
# on the CPU by the harness before a configuration could hold a rig
ONE_CAMERA_PAIRS_SHA256 = "7f57b1b505f0eb858df91a110d2902e709ceaa0fe73d99aebe70b8fb35cadf54"

# a hold-and-sway mix: explore's pace and world for 24 frames, then a hold
# swaying 0.03 m across, 0.02 m up and down and 0.01 rad of yaw, period 40
HOVER = {"motion": {"travel": {"step_m": 0.08, "yaw_rad": 0.002}, "hold_after_frames": 24,
                    "sway_m": [0.03, 0.02], "sway_yaw_rad": 0.01, "sway_period_frames": 40},
         "world": [{"per_m": 95.238, "start_m": 3.0, "ahead_m": 45.0,
                    "lateral_m": [-14.0, 14.0], "vertical_m": [-9.0, 9.0]}],
         "warm_frames": 24, "max_fps": 40}

IMAGING = {"fx": 420.0, "fy": 420.0, "cx": 384.0, "cy": 240.0, "width": 768, "height": 480,
           "scale": 0.5, "mono": True, "every": 2, "place": True,
           "Tcam": sequence.se3_exp((0.0, 0.06, 0.02, 0.15, -0.1, 0.0)).tolist(),
           "extractor": {"n_features": 400, "n_levels": 8, "scale_factor": 1.2,
                         "fast_threshold": 7.0, "cell_size": 32, "border": 19},
           "policy": {"max_kf_interval": 4}}

IMAGING_ATE = '''"""imaging_ate_m: RMS distance (m) of the Imaging keyframes' centres
after imaging BA from the rendered truth's."""
import numpy as np

from benchmark.harness.check import centre_errors


def read(run):
    ids, Tcw, truth = run.cameras["Imaging"].kfs
    return float(np.sqrt(np.mean(centre_errors(Tcw, truth) ** 2))) if len(ids) else float("inf")
'''

FEED_ORDER = '''"""feed_order: System calls fed out of timestamp order, plus the Imaging
frames of the window that were not fed."""
WRAPS = [("hyslam_tpu_torch.slam.system", "System._track_features")]


def read(run):
    calls = run.calls[tuple(WRAPS[0])]
    ts = [c.args[2] for c in calls]
    fed = [c.args[4] for c in calls if c.args[3] == "Imaging"]
    return float(sum(b < a for a, b in zip(ts, ts[1:]))
                 + len(set(run.cameras["Imaging"].frames) - set(fed)))
'''

K1_RECORDED = '''"""k1_recorded: the largest share by which a recorded pose solve's
truncated cost exceeds the float64 reference's, over the window's first
four solves of the SLAM camera with 100 observations or more."""
from benchmark.harness.check import pose_readings

WRAPS = [("hyslam_tpu_torch.slam.strategies", "pose_optimization_fast")]


def read(run):
    calls = [c for c in run.calls[tuple(WRAPS[0])]
             if c.camera == "SLAM" and int(c.args[6].sum()) >= 100][:4]
    return max(pose_readings([(c.args, c.result) for c in calls], run.control)["cost"],
               default=float("inf"))
'''


def _sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()


def test_one_camera_cell_renders_the_bits_it_did(tiny):
    b = Bench(tiny)
    cfg = b.config("tiny")
    rig = rig_cameras(cfg)
    assert list(rig) == ["SLAM"]
    seq = sequence.build(rig, b.traffic("tiny_explore"), cfg["frame_dt"], 2**40 + 9, 2.0, "cpu")
    assert seq.pairs.shape == (16, 2, 240, 384) and seq.feeds == {}
    assert _sha(seq.pairs) == ONE_CAMERA_PAIRS_SHA256


def _centres(T):
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def test_hover_holds_and_sways():
    tr = copy.deepcopy(HOVER)
    m = tr["motion"]
    assert "step_m" not in m      # a harness that reads no hold raises on it
    h, period = m["hold_after_frames"], m["sway_period_frames"]
    poses = sequence.path_poses(m, h + 2 * period + 1)
    C = _centres(poses)
    np.testing.assert_allclose(np.linalg.norm(np.diff(C[:h + 1], axis=0), axis=1),
                               m["travel"]["step_m"], rtol=1e-6)   # a chord of the turn
    held = poses[h]
    i = np.arange(h, len(poses))
    phi = 2 * math.pi * (i - h) / period
    local = (C[h:] - C[h]) @ np.linalg.inv(held)[:3, :3]      # in the held camera's axes
    np.testing.assert_allclose(local[:, 0], m["sway_m"][0] * np.sin(phi), atol=1e-12)
    np.testing.assert_allclose(local[:, 1], m["sway_m"][1] * np.sin(2 * phi), atol=1e-12)
    np.testing.assert_allclose(local[:, 2], 0.0, atol=1e-12)
    R = poses[h:, :3, :3] @ held[:3, :3].T                   # the turn from the held pose
    yaw = np.arctan2(R[:, 2, 0], R[:, 0, 0])
    np.testing.assert_allclose(yaw, m["sway_yaw_rad"] * np.sin(phi), atol=1e-12)
    np.testing.assert_allclose(poses[h + period], held, atol=1e-12)   # one period on: back
    # the world lies along the travel alone, however long the hold
    gen = torch.Generator().manual_seed(5)
    pts = sequence.world_points(tr, sequence.path_poses(m, 1000), gen, "cpu")
    layer = tr["world"][0]
    travelled = m["travel"]["step_m"] * h
    assert len(pts) == round(layer["per_m"] * (travelled + layer["ahead_m"] - layer["start_m"]))


def test_tiny_hover_cell_runs(tmp_path):
    tr = copy.deepcopy(HOVER)
    tr["motion"]["hold_after_frames"] = 8          # the tiny cell's warm frames
    root = make_tiny(tmp_path, traffic=tr)
    line = run_tiny(root, seed=2**35 + 3, seconds=5.0)
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    seq = sequence.build(rig_cameras(Bench(root).config("tiny")), Bench(root).traffic(
        "tiny_explore"), 0.05, 2**35 + 3, 5.0, "cpu")
    C = _centres(seq.poses)
    assert np.abs(C[8:] - C[8]).max() < 0.031            # the window holds station


def test_two_camera_cell_from_files_alone(tmp_path):
    """A stereo SLAM camera and a monocular camera at scale 0.5 on a rig
    transform, every 2nd frame placed, imaging BA as the finalization, and
    two compared numbers that files read: nothing of the harness edited."""
    root = make_tiny(tmp_path, config={
        "cameras": {"Imaging": IMAGING},
        "finalize": {"call": "run_imaging_bundle_adjustment",
                     "kwargs": {"sparsify_overlap": None}}},
        checks={"imaging_ate_m": IMAGING_ATE, "feed_order": FEED_ORDER},
        limits={"imaging_ate_m": {"limit": 0.35}, "feed_order": {"limit": 0}})
    b = Bench(root)
    cfg = b.config("tiny")
    seq = sequence.build(rig_cameras(cfg), b.traffic("tiny_explore"), cfg["frame_dt"], 7, 2.0,
                         "cpu")
    feed = seq.feeds["Imaging"]
    assert feed.images.shape == (8, 480, 768) and feed.images.dtype == torch.uint8
    np.testing.assert_array_equal(feed.steps, np.arange(0, 16, 2))
    np.testing.assert_allclose(feed.poses, np.asarray(IMAGING["Tcam"]) @ seq.poses[::2])
    assert feed.images.float().std() > 5
    records = []
    line = run_tiny(root, seed=7, seconds=8.0, records=records)
    assert line["correct"], line["checks"]
    assert set(line["checks"]) == {"fe_mismatch", "k1_cost_gap_2nd", "ba_cost_gap",
                                   "imaging_ate_m", "feed_order"}
    assert line["checks"]["feed_order"]["value"] == 0
    assert line["attempted"] == records[0].frames == len(records[0].call_s)


@pytest.mark.parametrize("fault", [None, "pose_altered"])
def test_a_check_file_decides_correct(tmp_path, monkeypatch, fault):
    root = make_tiny(tmp_path, checks={"k1_recorded": K1_RECORDED},
                     limits={"k1_recorded": {"limit": 1e-3},
                             "k1_cost_gap_2nd": {"limit": 1.0}})   # the file's number decides
    if fault:
        faults.plant(fault, monkeypatch.setattr)
    line = run_tiny(root, seed=24)
    number = line["checks"]["k1_recorded"]
    assert line["correct"] == (fault is None), line["checks"]
    assert (number["value"] > number["limit"]) == (fault is not None)


def test_a_number_no_file_reads_raises(tmp_path):
    root = make_tiny(tmp_path, limits={"no_such_number": {"limit": 1.0}})
    with pytest.raises(FileNotFoundError, match="checks/no_such_number.py"):
        run_tiny(root)
