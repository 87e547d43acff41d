"""The slice: the port's ``Tracker.track`` against the JAX package's on the
CPU, over 16 frames of tests/test_tracking.py:run_sequence (identical
``synth_frame_features`` inputs, MapCaps(K=64, L=8192, F=512, O=8),
max_kf_interval 10). Both go INITIALIZE -> POSTINIT -> NORMAL with the
mapper (triangulation, fusion, local BA, keyframe culling) running on every
keyframe."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams as JPolicy
from hyslam_tpu.slam.tracker import Tracker as JTracker
from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
from hyslam_tpu_torch.slam.tracker import State, Tracker

from helpers import DEFAULT_CAM, make_world, pose_error, synth_frame_features
from port_helpers import feats_to_torch, tree_np

torch.set_num_threads(2)

N_FRAMES = 16
CAPS = (64, 8192, 512, 8)


def sequence(seed=0, n_frames=N_FRAMES, step=0.12, yaw_rate=0.004):
    """tests/test_tracking.py:run_sequence's world, poses and features."""
    rng = np.random.default_rng(seed)
    pts = make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    delta = np.asarray(j_se3.exp(jnp.asarray([0, yaw_rate, 0, 0, 0, -step], jnp.float32)))
    Ts, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n_frames):
        Ts.append(T.copy())
        T = (delta @ T).astype(np.float32)
    feats = [synth_frame_features(DEFAULT_CAM, Ts[i], pts, descs, rng, F=512)[0]
             for i in range(n_frames)]
    return np.stack(Ts), feats


@pytest.fixture(scope="module")
def runs():
    Ts, feats = sequence()
    jt = JTracker(cam=DEFAULT_CAM, caps=JMapCaps(*CAPS),
                  policy=JPolicy(max_kf_interval=10))
    tt = Tracker(cam=camera_from(DEFAULT_CAM), caps=MapCaps(*CAPS),
                 policy=KeyFramePolicyParams(max_kf_interval=10), device="cpu")
    for i, f in enumerate(feats):
        jt.track(f, timestamp=0.1 * i, frame_id=i)
        tt.track(feats_to_torch(f), timestamp=0.1 * i, frame_id=i)
    return Ts, jt, tt


def test_states_and_keyframes_match_jax(runs):
    _, jt, tt = runs
    assert [t.state for t in tt.telemetry] == [t.state for t in jt.telemetry]
    assert [t.kf_inserted for t in tt.telemetry] == [t.kf_inserted for t in jt.telemetry]
    assert tt.state == State.NORMAL and jt.state.name == "NORMAL"
    assert int(tt.ms.next_kf) == int(np.asarray(jt.ms.next_kf))
    assert sum(t.kf_inserted >= 0 for t in tt.telemetry) >= 5


def test_inliers_within_two_percent_of_jax(runs):
    _, jt, tt = runs
    for a, b in zip(tt.telemetry, jt.telemetry):
        assert abs(a.n_inliers - b.n_inliers) <= 0.02 * b.n_inliers, (a, b)
        assert abs(a.n_motion - b.n_motion) <= 0.02 * b.n_motion, (a, b)


def test_trajectory_matches_jax_and_truth(runs):
    Ts, jt, tt = runs
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size)) == N_FRAMES
    est = tt.traj.Tcw[:n].numpy()
    np.testing.assert_allclose(est, np.asarray(jt.traj.Tcw[:n]), atol=1e-3)
    errs = [pose_error(est[i], Ts[i])[1] for i in range(n)]
    assert np.sqrt(np.mean(np.square(errs))) < 0.05


def test_mapper_ran_and_matches_jax(runs):
    _, jt, tt = runs
    kfs = [(a.mapper_stats, b.mapper_stats) for a, b in zip(tt.telemetry, jt.telemetry)
           if a.kf_inserted > 0]
    assert kfs and any("ba_cost" in a for a, _ in kfs)
    for a, b in kfs:
        assert set(a) == set(b)
        for k in ("triangulated", "fused", "fuse_added", "kf_culled"):
            assert a.get(k) == b.get(k), (k, a, b)
        if "ba_cost" in b:
            assert np.isfinite(a["ba_cost"])
            assert abs(a["ba_cost"] - b["ba_cost"]) <= 1e-4 * b["ba_cost"]
    live_t = int((tt.ms.lm.valid & ~tt.ms.lm.bad).sum())
    live_j = int(np.asarray((jt.ms.lm.valid & ~jt.ms.lm.bad).sum()))
    assert abs(live_t - live_j) <= 0.02 * live_j
    kf = tree_np(tt.ms.kf)
    np.testing.assert_array_equal(kf["valid"], np.asarray(jt.ms.kf.valid))
    np.testing.assert_array_equal(kf["bad"], np.asarray(jt.ms.kf.bad))
