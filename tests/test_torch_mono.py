"""The port's monocular camera against the JAX package's, on the CPU: the
two-frame initializer (``slam/mono_init.py``), ``Tracker(is_mono=True)``
with ``Mapper(is_mono=True)``, and ``System.track_monocular``, sync and
async. Both packages are fed the same features or images and the same RANSAC
sample sets (drawn with ``jax.random``, as the JAX package draws them).

Tolerances. The two-view motion and the median-depth scale are taken on
the same inliers: keyframe poses within 1e-4, landmarks within 1e-3
relative at the median and 1e-2 at the worst (a two-view DLT point of small
parallax is fixed poorly along its ray, as tests/test_torch_mapper.py
finds). Over a sequence the states and keyframes are equal and every
count within 2% (the monocular map is held by fewer points than a stereo
one, so one float32 rounding moves a count by one or two where the stereo
tests see none); trajectories within 1e-3, in the map's own gauge (median
depth 1), which both packages take the same way.
"""

import numpy as np
import pytest
import torch

from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
from hyslam_tpu.core.mapstate import empty_map_state as j_empty_map_state
from hyslam_tpu.slam.mono_init import MonoInitializer as JMonoInitializer
from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu.slam.tracker import Tracker as JTracker
from hyslam_tpu_torch.core.mapstate import MapCaps, empty_map_state
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.slam.mono_init import MonoInitializer
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.slam.tracker import State, Tracker
from hyslam_tpu_torch.utils import synth

from helpers import DEFAULT_CAM, make_world, synth_frame_features
from port_helpers import (SYS_DT, feats_to_torch, mono_images, mono_sequence,
                          mono_system_configs, one_thread, use_jax_samples)

CAM = camera_from(DEFAULT_CAM)
CAPS = (32, 8192, 512, 8)
N_TRACK, N_SYS = 10, 12


def assert_rows_close(got, want):
    """States and keyframes equal, counts within 2%."""
    assert [(t.frame_id, t.state, t.kf_inserted) for t in got] == [
        (t.frame_id, t.state, t.kf_inserted) for t in want]
    for a, b in zip(got, want):
        for k in ("n_motion", "n_inliers", "n_local"):
            x, y = getattr(a, k), getattr(b, k)
            assert abs(x - y) <= max(0.02 * y, 1), (k, a, b)


def test_mono_initializer_feed_matches_jax(monkeypatch):
    """The reference frame, then the two keyframes and their landmarks."""
    _, feats = mono_sequence(2)
    use_jax_samples(monkeypatch)
    ji, ti = JMonoInitializer(DEFAULT_CAM), MonoInitializer(CAM)
    jms, tms = j_empty_map_state(JMapCaps(*CAPS)), empty_map_state(MapCaps(*CAPS))
    assert ti.feed(tms, feats_to_torch(feats[0]), 0.0, 0, 0)[::2] == (False, [])
    assert ji.feed(jms, feats[0], 0.0, 0, 0)[::2] == (False, [])
    done_j, jms, kf_j = ji.feed(jms, feats[1], 0.1, 1, 0)
    done_t, tms, kf_t = ti.feed(tms, feats_to_torch(feats[1]), 0.1, 1, 0)
    assert done_j and done_t and kf_t == kf_j == [0, 1] and ti.ref is None
    np.testing.assert_allclose(tms.kf.Tcw[:2].numpy(), np.asarray(jms.kf.Tcw[:2]), atol=1e-4)
    assert bool(tms.kf.origin[0]) and not bool(tms.kf.origin[1])
    n = int(tms.next_lm)
    assert n == int(np.asarray(jms.next_lm)) > 100
    np.testing.assert_array_equal(tms.kf.lm_id[:2].numpy(), np.asarray(jms.kf.lm_id[:2]))
    X_t, X_j = tms.lm.pos[:n].numpy(), np.asarray(jms.lm.pos[:n])
    rel = np.linalg.norm(X_t - X_j, axis=-1) / np.linalg.norm(X_j, axis=-1)
    assert np.median(rel) < 1e-3 and rel.max() < 1e-2
    # the scale gauge: median depth 1 in the first keyframe
    assert abs(float(np.median(X_t[:, 2])) - 1.0) < 0.05


def test_mono_tracker_initializes_on_plane():
    """tests/test_tracking.py::test_mono_tracker_initializes_on_plane: the
    homography branch initializes a planar scene."""
    rng = np.random.default_rng(0)
    xy = rng.uniform(-6, 6, (1200, 2)).astype(np.float32)
    pts = np.concatenate([xy, (6.0 + 0.25 * xy[:, 0])[:, None]], -1).astype(np.float32)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    tr = Tracker(cam=CAM, caps=MapCaps(*CAPS), is_mono=True, device="cpu")
    T1 = synth.se3_exp([0.0, 0.0, 0.0, -0.8, 0.0, 0.0]).astype(np.float32)
    for i, T in enumerate((np.eye(4, dtype=np.float32), T1)):
        f, _ = synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=512)
        f = feats_to_torch(f._replace(ur=f.ur * 0 - 1.0, depth=f.depth * 0 - 1.0))
        tr.track(f, 0.1 * i, i)
        assert tr.state == (State.INITIALIZE, State.POSTINIT)[i]
    assert int(tr.ms.next_lm) > 100 and int(tr.ms.next_kf) == 2


def test_mono_reenter_creates_private_submap():
    """tests/test_advice_fixes.py::test_mono_reenter_creates_private_submap:
    a monocular tracker re-entering INITIALIZE makes its second map in a
    private sub-map, with an origin of its own."""
    rng = np.random.default_rng(0)
    pts = make_world(rng, 1200, extent=(8.0, 6.0, 20.0), z_min=2.0)
    descs = rng.integers(0, 2**32, (1200, 8), dtype=np.uint32)
    tr = Tracker(cam=CAM, caps=MapCaps(*CAPS), is_mono=True, device="cpu")

    def init_pair(t0):
        T1 = np.eye(4, dtype=np.float32)
        T1[0, 3] = -0.8
        for k, T in enumerate((np.eye(4, dtype=np.float32), T1)):
            f, _ = synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=512)
            tr.track(feats_to_torch(f), t0 + 0.1 * k, int(t0 * 10) + k)

    init_pair(0.0)
    assert tr.state == State.POSTINIT
    tr.state = State.NULL
    tr.reenter_initialize()
    assert tr._mono_init.ref is None
    init_pair(1.0)
    assert tr.state == State.POSTINIT
    origins = (tr.ms.kf.origin & tr.ms.kf.valid).numpy()
    map_ids = tr.ms.kf.map_id.numpy()
    assert origins.sum() == 2 and len(set(map_ids[origins])) == 2
    assert (map_ids[origins] == 0).sum() == 1


@pytest.fixture(scope="module")
def tracker_runs():
    Ts, feats = mono_sequence(N_TRACK)
    jt = JTracker(cam=DEFAULT_CAM, caps=JMapCaps(*CAPS), is_mono=True)
    tt = Tracker(cam=CAM, caps=MapCaps(*CAPS), is_mono=True, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        use_jax_samples(mp)
        for i, f in enumerate(feats):
            jt.track(f, 0.1 * i, i)
            tt.track(feats_to_torch(f), 0.1 * i, i)
    return Ts, jt, tt


def test_mono_tracker_matches_jax(tracker_runs):
    """INITIALIZE (two frames) -> POSTINIT -> NORMAL, the mapper's
    monocular jobs on every keyframe: no close-point seeding, new landmarks
    by triangulation, no keyframe cull."""
    Ts, jt, tt = tracker_runs
    assert_rows_close(tt.telemetry, jt.telemetry)
    assert tt.state == State.NORMAL and jt.state.name == "NORMAL"
    assert tt.mapper.is_mono
    kfs = [(a.mapper_stats, b.mapper_stats) for a, b in zip(tt.telemetry, jt.telemetry)
           if a.mapper_stats]
    assert len(kfs) >= 4 and all(t.n_seeded == 0 for t in tt.telemetry)
    for a, b in kfs:
        assert set(a) == set(b) and not a.get("kf_culled")
        assert abs(a["triangulated"] - b["triangulated"]) <= max(0.02 * b["triangulated"], 1)
    assert sum(a["triangulated"] for a, _ in kfs) > 0
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size)) == N_TRACK - 1
    np.testing.assert_allclose(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]), atol=1e-3)


@pytest.fixture(scope="module")
def system_runs():
    Ts, imgs = mono_images(N_SYS)
    jcfg, tcfg = mono_system_configs()
    js, ts = JSystem(jcfg), System(tcfg)
    with pytest.MonkeyPatch.context() as mp:
        use_jax_samples(mp)
        for i in range(N_SYS):
            js.track_monocular(imgs[i], SYS_DT * i, frame_id=i)
            ts.track_monocular(imgs[i], SYS_DT * i, frame_id=i)
    return Ts, js, ts


def assert_init_extractor_used(js, ts):
    """The two initial keyframes come from the init extractor
    (init_feature_factor times the features, capped at F): they hold more
    features than the tracking budget, as many as the JAX package's."""
    tt, jt = ts.trackers["SLAM"], js.trackers["SLAM"]
    n_feat = tt.ms.kf.kp_valid.sum(-1).tolist()
    assert n_feat[:2] == np.asarray(jt.ms.kf.kp_valid.sum(-1)).tolist()[:2]
    assert min(n_feat[:2]) > ts.config.cameras["SLAM"].extractor.n_features >= max(
        n_feat[2:int(tt.ms.next_kf)])


def ate_sim3(tr, Ts):
    """ATE after a sim3 alignment (the monocular map has its own scale)."""
    from hyslam_tpu_torch.io.evaluate import ate_rmse

    n = int(np.asarray(tr.traj.size))
    t = np.asarray(tr.traj.t[:n])
    return ate_rmse(np.asarray(tr.traj.Tcw[:n]), Ts[np.rint(t / SYS_DT).astype(int)],
                    align="sim3")


def test_track_monocular_matches_jax(system_runs):
    """System.track_monocular, sync: the init extractor while initializing,
    then the same rows, keyframes and trajectory; ATE (sim3) within 0.01 m
    of the JAX package's."""
    Ts, js, ts = system_runs
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    assert_rows_close(tt.telemetry, jt.telemetry)
    assert [t.frame_id for t in tt.telemetry] == list(range(N_SYS))
    assert tt.state == State.NORMAL and tt.is_mono
    assert_init_extractor_used(js, ts)
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size)) >= N_SYS - 5
    np.testing.assert_allclose(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]), atol=1e-3)
    ate_t, ate_j = ate_sim3(tt, Ts), ate_sim3(jt, Ts)
    assert ate_t < 0.1 and abs(ate_t - ate_j) < 0.01
