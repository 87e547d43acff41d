"""Loss recovery of the port against the JAX package's, on the CPU, as a
whole slice: forced losses through both ``Tracker``s (35 frames of
tests/test_tracking.py:run_sequence with ``reset_interval=15``),
``reenter_initialize``, a blackout through both ``System``s (the small
system of tests/port_helpers.py), synchronous with sensor readings on every
frame and async without, and a checkpoint with sensors and a registered
sub-map carried between the packages.

Tolerances: states, telemetry rows, keyframes, the map table's integers
equal; rotation entries within 5e-5 and translations within 5e-4 m
(tests/test_torch_system.py says why). ``Tse3_parent`` within 1e-5 through
the ``Tracker``s; through the ``System``s it is a product of two tracked
poses and is held to the poses' bounds (4.3e-4 m seen). Over 35 frames of
noisy synthetic features a borderline match falls either way: the match,
inlier and mapper counts of the ``Tracker`` runs agree within 2% (+1)."""

import numpy as np
import pytest
import torch

from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
from hyslam_tpu.core.sensordata import SensorData as JSensorData
from hyslam_tpu.io.config import OptimizerInfo as JOptimizerInfo
from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams as JPolicy
from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu.slam.tracker import State as JState
from hyslam_tpu.slam.tracker import Tracker as JTracker
from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.core.sensordata import SensorData
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.io.evaluate import ate_rmse
from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.slam.tracker import State, Tracker
from hyslam_tpu_torch.utils import synth

from helpers import DEFAULT_CAM
from port_helpers import (SYS_DT, assert_tree_close, feats_to_torch, system_configs,
                          system_sequence, tree_np)
from test_torch_system import assert_poses_close, rows
from test_torch_tracker import CAPS, sequence

torch.set_num_threads(2)

N_FORCED = 35
RESET = 15


# ---------------------------------------------------------------------------
# forced loss through both Trackers
# ---------------------------------------------------------------------------

def _trackers(**kw):
    jt = JTracker(cam=DEFAULT_CAM, caps=JMapCaps(*CAPS), policy=JPolicy(max_kf_interval=10), **kw)
    tt = Tracker(cam=camera_from(DEFAULT_CAM), caps=MapCaps(*CAPS),
                 policy=KeyFramePolicyParams(max_kf_interval=10), device="cpu", **kw)
    return jt, tt


@pytest.fixture(scope="module")
def forced():
    Ts, feats = sequence(n_frames=N_FORCED)
    jt, tt = _trackers(reset_interval=RESET)
    for i, f in enumerate(feats):
        jt.track(f, timestamp=0.1 * i, frame_id=i)
        tt.track(feats_to_torch(f), timestamp=0.1 * i, frame_id=i)
    return Ts, jt, tt


def assert_rows_agree(got, want):
    """Frame ids, states and keyframe ids equal row for row; the match and
    inlier counts within 2% (tests/test_torch_tracker.py's bound: on these
    noisy synthetic features a borderline inlier falls either way)."""
    assert [(t.frame_id, t.state, t.kf_inserted) for t in got] == [
        (t.frame_id, t.state, t.kf_inserted) for t in want]
    for a, b in zip(got, want):
        for k in ("n_motion", "n_inliers", "n_local", "n_seeded"):
            assert abs(getattr(a, k) - getattr(b, k)) <= 0.02 * getattr(b, k), (k, a, b)


def test_forced_loss_states_and_keyframes_equal_jax(forced):
    """Losses fire at frames 14 and 29 (n_frames 15 and 30); each is
    followed by REINITIALIZE>REINIT_OK on the next frame."""
    _, jt, tt = forced
    assert_rows_agree(tt.telemetry, jt.telemetry)
    states = [t.state for t in tt.telemetry]
    assert states[RESET - 1] == states[2 * RESET - 1] == "NORMAL>FORCED_LOSS"
    assert states[RESET] == states[2 * RESET] == "REINITIALIZE>REINIT_OK"
    assert tt.state in (State.NORMAL, State.POSTINIT) and tt.state.name == jt.state.name
    assert int(tt.ms.next_kf) == int(np.asarray(jt.ms.next_kf)) >= 12


def test_forced_loss_submaps_registered_with_tiepoints(forced):
    _, jt, tt = forced
    maps, jmaps = tree_np(tt.ms.maps), tree_np(jt.ms.maps)
    n_maps = int(maps["n_maps"])
    assert n_maps == int(jmaps["n_maps"]) == 3
    for k in ("parent", "registered", "active", "tie_kf"):
        np.testing.assert_array_equal(maps[k], jmaps[k], err_msg=k)
    assert maps["registered"][1:n_maps].all() and not maps["registered"][0]
    assert (maps["tie_kf"][1:n_maps] >= 0).all() and int(maps["active"]) == 2
    np.testing.assert_allclose(maps["Tse3_parent"], jmaps["Tse3_parent"], atol=1e-5)
    np.testing.assert_array_equal(tree_np(tt.ms.kf.origin), np.asarray(jt.ms.kf.origin))
    np.testing.assert_array_equal(tree_np(tt.ms.kf.map_id), np.asarray(jt.ms.kf.map_id))
    assert tt._has_priors and jt._has_priors


def test_forced_loss_trajectory_matches_jax_and_truth(forced):
    """Trajectory rows for every tracked frame: all but the two frames of
    each forced loss. Each sub-map is placed by the motion model, so the
    run stays near the truth."""
    Ts, jt, tt = forced
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size)) == N_FORCED - 2
    assert_poses_close(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]))
    t = np.round(tt.traj.t[:n].numpy() / 0.1).astype(int)
    assert sorted(set(range(N_FORCED)) - set(t.tolist())) == [RESET - 1, 2 * RESET - 1]
    assert ate_rmse(tt.traj.Tcw[:n].numpy(), Ts[t]) < 0.05


def test_local_ba_takes_the_prior_path_after_a_submap(forced):
    """From the first registered sub-map on, every local BA carries the
    tiepoint prior; its cost agrees with the JAX package's."""
    _, jt, tt = forced
    kf_rows = [(a, b) for a, b in zip(tt.telemetry, jt.telemetry) if "ba_cost" in b.mapper_stats]
    after = [a for a, _ in kf_rows if a.frame_id > RESET]
    assert tt.mapper.n_prior_ba == len(after) >= 8
    for a, b in kf_rows:
        assert a.mapper_stats["ba_cost"] == pytest.approx(b.mapper_stats["ba_cost"], rel=5e-4)
        for k in ("triangulated", "fused", "fuse_added", "kf_culled"):
            x, y = a.mapper_stats.get(k), b.mapper_stats.get(k)
            assert abs(x - y) <= 1 + 0.02 * y, (a.frame_id, k)


def test_blank_frames_in_reinitialize_leak_no_submap():
    """A lost tracker fed featureless frames stays in REINITIALIZE and the
    map table stays as it was, frame after frame, in both packages."""
    from hyslam_tpu.core.frame import empty_features as j_empty

    _, feats = sequence(n_frames=3)
    jt, tt = _trackers()
    for i, f in enumerate(feats):
        jt.track(f, 0.1 * i, i)
        tt.track(feats_to_torch(f), 0.1 * i, i)
    before = tree_np(tt.ms.maps)
    jt._lose_tracking()
    tt._lose_tracking()
    for i in range(3, 6):
        jt.track(j_empty(512), 0.1 * i, i)
        tel = tt.track(feats_to_torch(j_empty(512)), 0.1 * i, i)
        assert tel.state == "REINITIALIZE" and tel.kf_inserted == -1
    assert tt.state == State.REINITIALIZE and jt.state == JState.REINITIALIZE
    assert_tree_close(tree_np(tt.ms.maps), before, atol=0.0)
    assert_tree_close(tree_np(tt.ms.maps), tree_np(jt.ms.maps), atol=0.0)
    assert not tt._has_priors
    assert rows(tt.telemetry) == rows(jt.telemetry)


def test_submap_table_full_reinitializes_in_the_active_map():
    """At MAX_MAPS the re-initialization stays in the active map instead of
    writing past the table."""
    from hyslam_tpu_torch.core.mapstate import MAX_MAPS

    _, feats = sequence(n_frames=2)
    jt, tt = _trackers()
    jt.track(feats[0], 0.0, 0)
    tt.track(feats_to_torch(feats[0]), 0.0, 0)
    import jax.numpy as jnp
    jt.ms = jt.ms._replace(maps=jt.ms.maps._replace(n_maps=jnp.asarray(MAX_MAPS, jnp.int32)))
    tt.ms = tt.ms._replace(maps=tt.ms.maps._replace(
        n_maps=torch.tensor(MAX_MAPS, dtype=torch.int32)))
    jt._lose_tracking()
    tt._lose_tracking()
    jt.track(feats[1], 0.1, 1)
    tel = tt.track(feats_to_torch(feats[1]), 0.1, 1)
    assert tel.state == "REINITIALIZE>REINIT_OK" and rows(tt.telemetry) == rows(jt.telemetry)
    assert int(tt.ms.maps.n_maps) == MAX_MAPS and int(tt.ms.maps.active) == 0
    assert_tree_close(tree_np(tt.ms.maps), tree_np(jt.ms.maps), atol=1e-6)
    assert int(tt.ms.kf.map_id[1]) == 0 and not tt._has_priors


def test_reenter_initialize_opens_a_private_submap():
    """``reenter_initialize`` on a stereo tracker with a map opens a private
    (unregistered) sub-map, reuses it while it is empty, and opens none when
    the map is empty; the next initialization lands in it as a second
    origin."""
    _, feats = sequence(n_frames=2)
    jt, tt = _trackers()
    for t in (jt, tt):
        t.reenter_initialize()            # nothing in the map yet
    assert int(tt.ms.maps.n_maps) == int(np.asarray(jt.ms.maps.n_maps)) == 1
    assert tt.state == State.INITIALIZE
    jt.track(feats[0], 0.0, 0)
    tt.track(feats_to_torch(feats[0]), 0.0, 0)
    for _ in range(2):                    # the second re-entry allocates nothing
        for t, null in ((jt, JState.NULL), (tt, State.NULL)):
            t.state = null
            t.reenter_initialize()
        assert_tree_close(tree_np(tt.ms.maps), tree_np(jt.ms.maps), atol=0.0)
        assert int(tt.ms.maps.n_maps) == 2 and int(tt.ms.maps.active) == 1
        assert not bool(tt.ms.maps.registered[1]) and tt.state == State.INITIALIZE
    jt.track(feats[1], 0.1, 1)
    tt.track(feats_to_torch(feats[1]), 0.1, 1)
    assert rows(tt.telemetry) == rows(jt.telemetry) and tt.state == State.POSTINIT
    origins = (tt.ms.kf.origin & tt.ms.kf.valid).numpy()
    assert origins.sum() == 2 and tt.ms.kf.map_id.numpy()[origins].tolist() == [0, 1]
    np.testing.assert_array_equal(tree_np(tt.ms.kf.map_id), np.asarray(jt.ms.kf.map_id))
    assert not tt._has_priors      # unregistered: no tiepoint edge yet


# ---------------------------------------------------------------------------
# a blackout through both Systems
# ---------------------------------------------------------------------------

N_SYS = 21            # frames rendered; the runs take 20, the resume one more
DARK = (10, 13)       # frames 10-12 are flat images
OPT = dict(gps_info=1.0, imu_info=0.5, depth_info=5.0)


@pytest.fixture(scope="module")
def sys_sequence():
    Ts, _, pairs = system_sequence(N_SYS)
    return Ts, synth.blackout(pairs, *DARK), synth.render_sensors(Ts, seed=6)


def _run(js, ts, pairs, sensors, frames):
    out = []
    for i in frames:
        sd_j = sd_t = None
        if sensors is not None:
            sd_j, sd_t = JSensorData(**sensors[i]), SensorData(**sensors[i])
        js.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i, sensor_data=sd_j)
        out.append(ts.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i,
                                   sensor_data=sd_t))
    js.flush()
    ts.flush()
    return out


@pytest.fixture(scope="module")
def sync_blackout(sys_sequence, tmp_path_factory):
    """Both synchronous Systems over 20 frames with the blackout and a
    sensor reading on every frame; a checkpoint of each at the end, then
    frame 20 through both."""
    _, pairs, sensors = sys_sequence
    jcfg, tcfg = system_configs(optimizer=JOptimizerInfo(**OPT))
    js, ts = JSystem(jcfg), System(tcfg)
    _run(js, ts, pairs, sensors, range(N_SYS - 1))
    d = tmp_path_factory.mktemp("ck")
    js.save_checkpoint(str(d / "j.npz"))
    ts.save_checkpoint(str(d / "t.npz"))
    tt = ts.trackers["SLAM"]
    n = int(tt.traj.size)
    end = dict(rows=rows(tt.telemetry), n=n, est=tt.traj.Tcw[:n].numpy().copy(),
               t=tt.traj.t[:n].numpy().copy(), maps=tree_np(tt.ms.maps),
               sensors=tree_np(tt.sensors), n_prior_ba=tt.mapper.n_prior_ba,
               jrows=rows(js.trackers["SLAM"].telemetry),
               jest=np.asarray(js.trackers["SLAM"].traj.Tcw[:n]),
               jmaps=tree_np(js.trackers["SLAM"].ms.maps),
               jsensors=tree_np(js.trackers["SLAM"].sensors))
    _run(js, ts, pairs, sensors, [N_SYS - 1])
    return js, ts, d, end


def test_sync_blackout_rows_equal_jax(sync_blackout):
    """The same telemetry rows, the failed initializations on the blank
    frames and >REINIT_OK included."""
    *_, end = sync_blackout
    assert end["rows"] == end["jrows"] and len(end["rows"]) == N_SYS - 1
    states = [r[1] for r in end["rows"]]
    assert states[DARK[0]] == "NORMAL"                       # the frame that lost
    assert states[DARK[0] + 1:DARK[1]] == ["REINITIALIZE"] * 2    # failed inits
    assert states[DARK[1]] == "REINITIALIZE>REINIT_OK"
    assert states[DARK[1] + 1:DARK[1] + 6] == ["POSTINIT"] * 5
    assert states[-1] == "NORMAL"


def test_sync_blackout_submap_and_trajectory_match_jax(sync_blackout, sys_sequence):
    Ts, _, _ = sys_sequence
    *_, end = sync_blackout
    maps, jmaps = end["maps"], end["jmaps"]
    assert int(maps["n_maps"]) == 2          # none left over from the blank frames
    for k in ("parent", "registered", "active", "tie_kf", "n_maps"):
        np.testing.assert_array_equal(maps[k], jmaps[k], err_msg=k)
    assert bool(maps["registered"][1]) and int(maps["tie_kf"][1]) >= 0
    assert_poses_close(maps["Tse3_parent"], jmaps["Tse3_parent"])
    assert end["n"] == N_SYS - 1 - (DARK[1] - DARK[0])
    assert_poses_close(end["est"], end["jest"])
    t = np.round(end["t"] / SYS_DT).astype(int)
    assert ate_rmse(end["est"], Ts[t]) < 0.05
    assert end["n_prior_ba"] >= N_SYS - 1 - DARK[1] - 1


def test_sensor_arena_equals_jax_and_feeds_local_ba(sync_blackout):
    """The readings ride each frame to its keyframe: the arenas are equal,
    one row a keyframe; with readings present local BA takes the prior path
    from its first run on."""
    js, ts, _, end = sync_blackout
    assert_tree_close(end["sensors"], end["jsensors"], atol=0.0)
    kfs = [r[5] for r in end["rows"] if r[5] >= 0]
    assert end["sensors"]["gps_valid"].nonzero()[0].tolist() == kfs
    assert end["sensors"]["depth_valid"].sum() == len(kfs) >= 10
    n_ba = sum("ba_cost" in t.mapper_stats
               for t in ts.trackers["SLAM"].telemetry[:N_SYS - 1])
    assert end["n_prior_ba"] == n_ba
    for a, b in zip(ts.trackers["SLAM"].telemetry, js.trackers["SLAM"].telemetry):
        assert set(a.mapper_stats) == set(b.mapper_stats)
        if "ba_cost" in b.mapper_stats:
            assert a.mapper_stats["ba_cost"] == pytest.approx(b.mapper_stats["ba_cost"],
                                                              rel=5e-4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_with_sensors_and_submap_crosses_packages(sync_blackout, sys_sequence,
                                                             writer):
    """A checkpoint written by either package, holding sensor readings and a
    registered sub-map, loads in the other, which tracks the next frame as
    the uninterrupted run did."""
    _, pairs, sensors = sys_sequence
    js, ts, d, end = sync_blackout
    i = N_SYS - 1
    jcfg, tcfg = system_configs(optimizer=JOptimizerInfo(**OPT))
    if writer == "jax":
        other = System(tcfg)
        other.load_checkpoint(str(d / "j.npz"))
        assert_tree_close(tree_np(other.trackers["SLAM"].sensors), end["jsensors"], atol=0.0)
        assert_tree_close(tree_np(other.trackers["SLAM"].ms.maps), end["jmaps"], atol=0.0)
        assert other.trackers["SLAM"]._has_priors
        tel = other.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i,
                                 sensor_data=SensorData(**sensors[i]))
        ref, ref_T = js.trackers["SLAM"].telemetry[-1], js.trackers["SLAM"].last_Tcw
        got_T = other.trackers["SLAM"].last_Tcw.numpy()
    else:
        other = JSystem(jcfg)
        other.load_checkpoint(str(d / "t.npz"))
        assert_tree_close(tree_np(other.trackers["SLAM"].sensors), end["sensors"], atol=0.0)
        tel = other.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i,
                                 sensor_data=JSensorData(**sensors[i]))
        ref, ref_T = ts.trackers["SLAM"].telemetry[-1], ts.trackers["SLAM"].last_Tcw.numpy()
        got_T = np.asarray(other.trackers["SLAM"].last_Tcw)
    assert tel.frame_id == ref.frame_id == i
    assert rows([tel]) == rows([ref])
    assert_poses_close(np.asarray(got_T)[None], np.asarray(ref_T)[None])


@pytest.fixture(scope="module")
def async_blackout(sys_sequence):
    """Both async Systems (commit_lag 2) over the same 20 frames, without
    sensors."""
    _, pairs, _ = sys_sequence
    jcfg, tcfg = system_configs(True)
    js, ts = JSystem(jcfg), System(tcfg)
    returned = _run(js, ts, pairs, None, range(N_SYS - 1))
    return js.trackers["SLAM"], ts.trackers["SLAM"], returned


def test_async_blackout_rows_equal_jax(async_blackout):
    """The loss is seen when frame 10 is committed, as frame 12 is
    dispatched; frames 11 and 12 tracked against the frozen state and
    failed too. REINITIALIZE then runs synchronously and recovers on the
    first rendered frame."""
    jt, tt, returned = async_blackout
    got = rows(tt.telemetry)
    assert got == rows(jt.telemetry) and [r[0] for r in got] == list(range(N_SYS - 1))
    states = [r[1] for r in got]
    assert states[DARK[0]:DARK[1]] == ["NORMAL>LOST", "NORMAL", "NORMAL"]
    assert states[DARK[1]] == "REINITIALIZE>REINIT_OK"
    # a row carries the state its frame was dispatched in, two commits late
    assert states[DARK[1] + 1:DARK[1] + 6] == ["POSTINIT"] * 5
    # only the cold states return their row
    assert [r is not None for r in returned] == [
        i in (0, DARK[1]) for i in range(N_SYS - 1)]
    assert tt.state == State.NORMAL and jt.state == JState.NORMAL


def test_async_blackout_recovers_with_the_keyframe_cursor_reread(async_blackout, sys_sequence):
    Ts, _, _ = sys_sequence
    jt, tt, _ = async_blackout
    assert int(tt.ms.maps.n_maps) == int(np.asarray(jt.ms.maps.n_maps)) == 2
    assert bool(tt.ms.maps.registered[1])
    assert int(tt.ms.maps.tie_kf[1]) == int(np.asarray(jt.ms.maps.tie_kf[1])) >= 0
    assert_poses_close(tt.ms.maps.Tse3_parent.numpy(), np.asarray(jt.ms.maps.Tse3_parent))
    # the host mirror was read again when the loop went back to tensors
    kfs = [r[5] for r in rows(tt.telemetry) if r[5] >= 0]
    assert kfs == list(range(len(kfs)))
    assert tt._kf_mirror == int(tt.ms.next_kf) == int(np.asarray(jt.ms.next_kf)) == len(kfs)
    assert tt._has_priors and tt.mapper.n_prior_ba >= 4
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size)) == N_SYS - 1 - (DARK[1] - DARK[0])
    assert_poses_close(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]))
    t = np.round(tt.traj.t[:n].numpy() / SYS_DT).astype(int)
    assert ate_rmse(tt.traj.Tcw[:n].numpy(), Ts[t]) < 0.05


def test_async_forced_loss_takes_the_synchronous_path(sys_sequence):
    """``reset_interval`` from the params tree in async mode: the frame of
    the forced loss drains the window, writes its row and is not tracked."""
    from hyslam_tpu.slam.tracking_params import NormalStateParams as JNormal
    from hyslam_tpu.slam.tracking_params import TrackingParams as JParams

    _, pairs, _ = sys_sequence
    jcfg, _ = system_configs(True)
    jcfg.cameras["SLAM"].tracking = JParams(normal=JNormal(reset_interval=9))
    from hyslam_tpu_torch import interop
    tcfg = interop.system_config_from(jcfg, device="cpu")
    assert tcfg.cameras["SLAM"].tracking.normal.reset_interval == 9
    js, ts = JSystem(jcfg), System(tcfg)
    _run(js, ts, pairs, None, range(DARK[0]))
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    assert tt.reset_interval == 9
    got = rows(tt.telemetry)
    assert got == rows(jt.telemetry)
    assert [r[1] for r in got][8:10] == ["NORMAL>FORCED_LOSS", "REINITIALIZE>REINIT_OK"]
    assert int(tt.ms.maps.n_maps) == 2 and tt.state == State.POSTINIT
