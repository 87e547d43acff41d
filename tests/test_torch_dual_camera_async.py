"""The port's two-camera ``System`` against the JAX package's on the CPU in
async mode (``commit_lag=2``), on tests/test_torch_dual_camera.py's scene
and with its tolerances.

One row may differ, by design: when SLAM's loss is committed, the Imaging
camera is sent to NULL. The port first commits the Imaging frames in
flight and leaves async mode; the JAX package leaves them in flight, and
their commit at the next Imaging frame (a loss of its own in the blackout)
turns NULL back into RELOCALIZE for that frame. The states after every
frame are equal."""

import numpy as np
import pytest

from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu_torch.slam.system import System

from port_helpers import (DUAL_DT, DUAL_TCAM, dual_camera_scene, dual_system_configs,
                          feats_to_torch, one_thread, run_dual, use_jax_samples)  # noqa: F401

POSE_ATOL = 1e-3
MAX_CENTRE_ERR = 0.2


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    use_jax_samples(mp)
    try:
        Ts, slam, img = dual_camera_scene()
        jcfg, tcfg = dual_system_configs(async_tracking=True)
        j = run_dual(JSystem(jcfg), slam, img)
        t = run_dual(System(tcfg), slam, img, feats_to_torch)
    finally:
        mp.undo()
    return Ts, j, t


def test_states_and_null_coupling_equal_jax(runs):
    _, j, t = runs
    assert t["states"] == j["states"]
    assert t["slam_rows"] == j["slam_rows"]
    assert any(">LOST" in r for r in t["slam_rows"])
    differ = [k for k, (a, b) in enumerate(zip(t["rows"], j["rows"])) if a != b]
    assert len(t["rows"]) == len(j["rows"])
    assert all((t["rows"][k], j["rows"][k]) == ("NULL", "RELOCALIZE") for k in differ)
    assert len(differ) <= 1
    lost = [i for i, (s, _) in enumerate(t["states"]) if s == "REINITIALIZE"]
    assert lost and all(t["states"][i][1] == "NULL" for i in lost)
    assert t["states"][lost[-1] + 1][1] == "INITIALIZE"


def test_placer_decisions_equal_jax(runs):
    _, j, t = runs
    assert t["keeps"] == j["keeps"]
    assert any(t["keeps"]) and not all(t["keeps"])


def test_submaps_registered_and_keyframes_equal_jax(runs):
    _, j, t = runs
    assert (t["n_kf"], t["n_maps"]) == (j["n_kf"], j["n_maps"])
    assert t["n_kf"] >= 6 and t["n_maps"] >= 2
    np.testing.assert_array_equal(t["map_id"], j["map_id"])
    assert t["registered"].all() and j["registered"].all()
    np.testing.assert_allclose(t["before"], j["before"], atol=POSE_ATOL)


def test_imaging_ba_equals_jax_and_the_truth(runs):
    Ts, j, t = runs
    np.testing.assert_allclose(t["after"], j["after"], atol=POSE_ATOL)
    np.testing.assert_array_equal(t["bad"], j["bad"])
    idx = np.rint(t["ts"] / DUAL_DT).astype(int)
    gt = np.stack([DUAL_TCAM @ Ts[i] for i in idx])
    centre = lambda T: -np.einsum("kji,kj->ki", T[:, :3, :3], T[:, :3, 3])
    err = np.linalg.norm(centre(t["after"]) - centre(gt), axis=-1)
    assert err.max() < MAX_CENTRE_ERR, err
