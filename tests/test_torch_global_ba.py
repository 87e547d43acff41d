"""Global BA of the port (``hyslam_tpu_torch/slam/global_ba.py``) against
the JAX package's, on the CPU.

- ``build_global_problem`` on one map carried between the packages: every
  field equal (floats within 1e-6), with and without active tiepoints;
  tests/test_advice_fixes.py's ``TestUntiedOriginFixedInGBA`` cases on the
  port's own maps.
- ``run_global_ba`` on one map with a registered sub-map and GPS / IMU /
  depth readings, through both packages. LM keeps a step only where it
  lowers the cost, and two correct solvers can part at one such decision
  (ROADMAP queue 3), and this map is near its minimum: the cost falls by
  2e-5 relative over 3 iterations while the poses drift 1e-3 along
  directions the cost hardly sees. So the first iteration is held pose by
  pose (within 2e-5) and by cost (1e-5 relative), the default 20 by cost
  (1e-3).
- The periodic global BA of ``System``: tests/test_torch_global_ba_system.py.
"""

import numpy as np
import jax
import pytest
import torch

from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
from hyslam_tpu.core.sensordata import SensorData as JSensorData
from hyslam_tpu.io.config import OptimizerInfo as JOptimizerInfo
from hyslam_tpu.slam import global_ba as jgba
from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams as JPolicy
from hyslam_tpu.slam.tracker import Tracker as JTracker
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.io.config import OptimizerInfo
from hyslam_tpu_torch.slam import global_ba as gba
from hyslam_tpu_torch.slam.tracker import State, Tracker
from hyslam_tpu_torch.utils import synth

from helpers import DEFAULT_CAM, make_world, synth_frame_features
from port_helpers import assert_tree_close, feats_to_torch, ms_to_torch, one_thread, tree_np
from test_torch_tracker import CAPS, sequence

CAM = interop.camera_from(DEFAULT_CAM)
OPT = dict(gps_info=10.0, imu_info=1.0, depth_info=10.0)
N_MAP, RESET = 20, 10


@pytest.fixture(scope="module")
def map_with_submap():
    """A JAX-package map with a registered, tied sub-map (a forced loss at
    frame 9) and readings on every keyframe, and the same map in the port."""
    Ts, feats = sequence(n_frames=N_MAP)
    readings = synth.render_sensors(Ts, seed=2)
    jt = JTracker(cam=DEFAULT_CAM, caps=JMapCaps(*CAPS), policy=JPolicy(max_kf_interval=10),
                  reset_interval=RESET)
    for i, f in enumerate(feats):
        jt.track(f, timestamp=0.1 * i, frame_id=i, sensor_data=JSensorData(**readings[i]))
    assert int(np.asarray(jt.ms.maps.n_maps)) == 2 and bool(jt.ms.maps.registered[1])
    sensors = interop.sensor_arena_from_numpy(jax.tree.map(np.asarray, jt.sensors))
    return jt.ms, ms_to_torch(jt.ms), jt.sensors, sensors


@pytest.mark.parametrize("tie_active", [False, True])
def test_build_global_problem_matches_jax(map_with_submap, tie_active):
    ms_j, ms_t, _, _ = map_with_submap
    want = jgba.build_global_problem(ms_j, DEFAULT_CAM, tie_active=tie_active)
    got = gba.build_global_problem(ms_t, CAM, tie_active=tie_active)
    assert_tree_close(tree_np(got), tree_np(want), atol=1e-6)
    origin = int(np.nonzero(np.asarray(ms_j.kf.origin & ms_j.kf.valid))[0][1])
    assert bool(got.kf_fixed[0]) and bool(got.kf_fixed[origin]) != tie_active


@pytest.mark.parametrize("n_iters,cost_rtol,pose_atol", [(1, 1e-5, 2e-5), (20, 1e-3, None)])
def test_run_global_ba_matches_jax(map_with_submap, n_iters, cost_rtol, pose_atol):
    """With the sensor priors and the tiepoint edge: the sub-map's origin is
    free and moves in both packages; the fixed root origin does not."""
    ms_j, ms_t, sens_j, sens_t = map_with_submap
    ms2_j, cost_j = jgba.run_global_ba(ms_j, DEFAULT_CAM, n_iters=n_iters, sensors=sens_j,
                                       opt_info=JOptimizerInfo(**OPT))
    ms2_t, cost_t = gba.run_global_ba(ms_t, CAM, n_iters=n_iters, sensors=sens_t,
                                      opt_info=OptimizerInfo(**OPT))
    assert np.isfinite(cost_t) and abs(cost_t - cost_j) <= cost_rtol * cost_j
    T_j, T_t, T0 = np.asarray(ms2_j.kf.Tcw), ms2_t.kf.Tcw.numpy(), ms_t.kf.Tcw.numpy()
    origin = int(np.nonzero(np.asarray(ms_j.kf.origin & ms_j.kf.valid))[0][1])
    assert np.array_equal(T_t[0], T0[0]) and np.abs(T_t[origin] - T0[origin]).max() > 1e-6
    if pose_atol is not None:
        np.testing.assert_allclose(T_t, T_j, atol=pose_atol)
        # the landmarks in image space, as tests/test_torch_mapper.py holds them
        lm = np.asarray(ms2_j.lm.valid & ~ms2_j.lm.bad)
        P = M.camera_centers(ms2_t).numpy()[:1]
        dj = np.linalg.norm(np.asarray(ms2_j.lm.pos)[lm] - P, axis=-1)
        dt = np.linalg.norm(ms2_t.lm.pos.numpy()[lm] - P, axis=-1)
        assert np.median(np.abs(dt - dj) / dj) < 1e-4
    np.testing.assert_array_equal(tree_np(ms2_t.lm.n_obs), np.asarray(ms2_j.lm.n_obs))


def test_run_global_ba_with_a_mesh_raises(map_with_submap):
    with pytest.raises(NotImplementedError, match="step 20"):
        gba.run_global_ba(map_with_submap[1], CAM, mesh=object())


# ---------------------------------------------------------------------------
# tests/test_advice_fixes.py:TestUntiedOriginFixedInGBA on the port's maps
# ---------------------------------------------------------------------------

def _two_map_state():
    rng = np.random.default_rng(0)
    pts = make_world(rng, 800, extent=(10.0, 7.0, 60.0))
    descs = rng.integers(0, 2**32, (800, 8), dtype=np.uint32)
    tr = Tracker(cam=CAM, caps=MapCaps(K=32, L=4096, F=256, O=8), device="cpu")
    tr.track(feats_to_torch(synth_frame_features(DEFAULT_CAM, np.eye(4, dtype=np.float32),
                                                 pts, descs, rng, F=256)[0]), 0.0, 0)
    tr.state = State.NULL
    tr.reenter_initialize()
    T2 = np.eye(4, dtype=np.float32)
    T2[2, 3] = -0.5
    tr.track(feats_to_torch(synth_frame_features(DEFAULT_CAM, T2, pts, descs, rng, F=256)[0]),
             1.0, 1)
    ms = tr.ms
    active = int(ms.maps.active)
    origins = torch.nonzero(ms.kf.origin & ms.kf.valid)[:, 0].tolist()
    return ms, active, [k for k in origins if int(ms.kf.map_id[k]) == active][0]


def test_untied_registered_origin_stays_fixed():
    ms, active, o1 = _two_map_state()
    ms = M.register_submap(ms, active)     # registered without a tiepoint
    prob = gba.build_global_problem(ms, CAM, tie_active=True)
    assert bool(prob.kf_fixed[o1]) and bool(prob.kf_fixed[0])


def test_tied_origin_is_free_when_priors_active():
    ms, active, o1 = _two_map_state()
    ms = M.register_submap(ms, active, Tse3_parent=torch.eye(4), tie_kf=0)
    assert not bool(gba.build_global_problem(ms, CAM, tie_active=True).kf_fixed[o1])
    assert bool(gba.build_global_problem(ms, CAM, tie_active=False).kf_fixed[o1])


def test_gba_preserves_untied_submap_placement():
    ms, active, o1 = _two_map_state()
    ms = M.register_submap(ms, active)
    T_before = ms.kf.Tcw[o1].clone()
    ms2, cost = gba.run_global_ba(ms, CAM, n_iters=5)
    torch.testing.assert_close(ms2.kf.Tcw[o1], T_before, atol=1e-6, rtol=0)
    assert np.isfinite(cost)
