"""The port's two-camera ``System`` (a stereo SLAM camera and a monocular
Imaging camera on a rig) against the JAX package's on the CPU, synchronous:
features of port_helpers.dual_camera_scene (14 frames, frames 6-8 without
features in either camera), both cameras fed every frame, the frame placer
asked on every frame SLAM tracks, then ``run_imaging_bundle_adjustment``
and the exports. Both packages draw the same RANSAC sample sets.

Tolerances: states of both cameras after every frame, telemetry rows,
placer decisions, sub-maps, registration and the keyframes sparsification
culls equal; the Imaging keyframe poses within 1e-3 before and after
imaging BA (the monocular map's float32 solves in two reduction orders,
as tests/test_torch_mono.py; 3e-4 seen after BA); their centres within
0.2 m of the rendered truth after BA (the sub-map made after the loss
sits 0.1 m off, as the JAX package leaves it)."""

import os

import numpy as np
import pytest

from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu_torch.slam.system import System

from port_helpers import (DUAL_DT, DUAL_TCAM, dual_camera_scene, dual_system_configs,
                          feats_to_torch, one_thread, run_dual, use_jax_samples)  # noqa: F401

POSE_ATOL = 1e-3
MAX_CENTRE_ERR = 0.2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    use_jax_samples(mp)
    try:
        Ts, slam, img = dual_camera_scene()
        jcfg, tcfg = dual_system_configs()
        j = run_dual(JSystem(jcfg), slam, img)
        tmp = tmp_path_factory.mktemp("dual_exports")
        t = run_dual(System(tcfg), slam, img, feats_to_torch, tmp=tmp)
    finally:
        mp.undo()
    return Ts, j, t, tmp


def test_states_and_null_coupling_equal_jax(runs):
    _, j, t, _ = runs
    assert t["states"] == j["states"]
    assert t["rows"] == j["rows"] and t["slam_rows"] == j["slam_rows"]
    lost = [i for i, (s, _) in enumerate(t["states"]) if s == "REINITIALIZE"]
    assert lost, t["states"]
    assert all(t["states"][i][1] == "NULL" for i in lost)       # held while SLAM is lost
    assert t["states"][lost[-1] + 1][1] == "INITIALIZE"          # re-enters after
    assert t["states"][-1] == ("POSTINIT", "POSTINIT") or t["states"][-1][1] == "NORMAL"


def test_placer_decisions_equal_jax(runs):
    _, j, t, _ = runs
    assert t["keeps"] == j["keeps"]
    assert any(t["keeps"]) and not all(t["keeps"])


def test_submaps_registered_and_keyframes_equal_jax(runs):
    _, j, t, _ = runs
    assert (t["n_kf"], t["n_maps"]) == (j["n_kf"], j["n_maps"])
    assert t["n_kf"] >= 6 and t["n_maps"] >= 2
    np.testing.assert_array_equal(t["map_id"], j["map_id"])
    np.testing.assert_array_equal(t["ts"], j["ts"])
    assert t["registered"].all() and j["registered"].all()
    np.testing.assert_allclose(t["before"], j["before"], atol=POSE_ATOL)


def test_imaging_ba_equals_jax_and_the_truth(runs):
    Ts, j, t, _ = runs
    np.testing.assert_allclose(t["after"], j["after"], atol=POSE_ATOL)
    np.testing.assert_array_equal(t["bad"], j["bad"])
    idx = np.rint(t["ts"] / DUAL_DT).astype(int)
    gt = np.stack([DUAL_TCAM @ Ts[i] for i in idx])
    centre = lambda T: -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    err = np.linalg.norm(centre(t["after"]) - centre(gt), axis=-1)
    assert err.max() < MAX_CENTRE_ERR, err


def test_exports_of_both_cameras(runs):
    *_, tmp = runs
    for cam in ("SLAM", "Imaging"):
        assert os.path.getsize(os.path.join(tmp, cam, "images.txt")) > 0
    assert os.path.getsize(os.path.join(tmp, "imaging.xml")) > 0
    assert os.path.getsize(os.path.join(tmp, "slam_traj.tsv")) > 0
