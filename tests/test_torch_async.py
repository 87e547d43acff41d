"""The async tracking loop of the port against the JAX package's on the CPU
(the small system of tests/port_helpers.py): ``track_normal_step`` on one
frame, tracked and failed, and the async ``System`` (``commit_lag`` 2) over
16 rendered frames, then a blackout frame that the tail heals, then a
blackout that it does not and that ends in REINITIALIZE (the recovery is
tests/test_torch_reinit.py's).

Tolerances: telemetry rows, keyframe frame ids and every counter equal;
rotation entries within 5e-5 and translations within 5e-4 m (as in
tests/test_torch_system.py, which says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.slam import strategies as j_strategies
from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.ops.pyramid import preprocess_image
from hyslam_tpu_torch.ops.stereo import match_stereo_refined
from hyslam_tpu_torch.slam import strategies
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.slam.tracker import State

from port_helpers import (SYS_CAM, SYS_DT, feats_to_jax, ms_to_torch, system_configs,
                          system_sequence, traj_to_torch, tree_np)
from test_torch_system import assert_poses_close, rows

torch.set_num_threads(2)

N = 16            # frames of the plain async run
HEALED = 16       # a flat frame here, frames 17-19 rendered: the tail heals it
LOST = 20         # flat frames 20-22: nothing heals it
FLAT = np.full((SYS_CAM.height, SYS_CAM.width), 20.0, np.float32)


@pytest.fixture(scope="module")
def sequence():
    return system_sequence(LOST)


def _frame(pairs, i):
    return (FLAT, FLAT) if i == HEALED or i >= LOST else (pairs[i, 0], pairs[i, 1])


@pytest.fixture(scope="module")
def async_runs(sequence):
    """Both async Systems through the three stretches; what each stretch
    left behind is recorded, since the Systems run on."""
    _, _, pairs = sequence
    jcfg, tcfg = system_configs(True)
    js, ts = JSystem(jcfg), System(tcfg)
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    rec = {}

    def snapshot(name):
        js.flush()
        ts.flush()
        n = int(tt.traj.size)
        rec[name] = dict(
            rows=rows(tt.telemetry), jrows=rows(jt.telemetry), n=n,
            jn=int(np.asarray(jt.traj.size)), est=tt.traj.Tcw[:n].numpy().copy(),
            jest=np.asarray(jt.traj.Tcw[:n]), t=tt.traj.t[:n].numpy().copy(),
            state=tt.state, jstate=jt.state.name, pending=len(tt._pending),
            next_kf=int(tt.ms.next_kf), jnext_kf=int(np.asarray(jt.ms.next_kf)),
            kf_mirror=tt._kf_mirror)

    returned = []
    for i in range(N):
        js.track_stereo(*_frame(pairs, i), SYS_DT * i, frame_id=i)
        returned.append(ts.track_stereo(*_frame(pairs, i), SYS_DT * i, frame_id=i))
    rec["in_flight"] = len(tt._pending)
    rec["returned"] = returned
    snapshot("plain")
    for i in range(HEALED, LOST):
        js.track_stereo(*_frame(pairs, i), SYS_DT * i, frame_id=i)
        ts.track_stereo(*_frame(pairs, i), SYS_DT * i, frame_id=i)
    snapshot("healed")
    states = {}
    for i in range(LOST, LOST + 3):
        js.track_stereo(*_frame(pairs, i), SYS_DT * i, frame_id=i)
        ts.track_stereo(*_frame(pairs, i), SYS_DT * i, frame_id=i)
        states[i] = (tt.state, jt.state.name)
    rec["states"] = states
    rec["lost"] = dict(rows=rows(tt.telemetry), jrows=rows(jt.telemetry), state=tt.state,
                       jstate=jt.state.name, n=int(tt.traj.size), dev=tt._dev)
    return rec


def test_async_rows_and_keyframes_equal_jax(async_runs):
    """Every frame's row, in frame order, none lost; the keyframes come at
    the same frames with the same ids; only INITIALIZE returns its row."""
    r = async_runs["plain"]
    assert r["rows"] == r["jrows"]
    assert [x[0] for x in r["rows"]] == list(range(N))
    kfs = [(x[0], x[5]) for x in r["rows"] if x[5] >= 0]
    assert len(kfs) >= 8 and [k for _, k in kfs] == list(range(len(kfs)))
    assert r["next_kf"] == r["jnext_kf"] == r["kf_mirror"] == len(kfs)
    assert r["state"] == State.NORMAL and r["jstate"] == "NORMAL"
    assert async_runs["in_flight"] == 2 and r["pending"] == 0
    ret = async_runs["returned"]
    assert ret[0].state == "INITIALIZE" and all(x is None for x in ret[1:])


def test_async_trajectory_matches_jax(async_runs, sequence):
    from hyslam_tpu_torch.io.evaluate import ate_rmse

    Ts, _, _ = sequence
    r = async_runs["plain"]
    assert r["n"] == r["jn"] == N
    assert_poses_close(r["est"], r["jest"])
    assert ate_rmse(r["est"], Ts[:N]) < 0.05


def test_blackout_healed_by_the_tail(async_runs):
    """A flat frame whose two followers track: both packages stay NORMAL,
    the failed frame has its row and no trajectory entry."""
    r = async_runs["healed"]
    assert r["rows"] == r["jrows"] and len(r["rows"]) == LOST
    assert r["state"] == State.NORMAL and r["jstate"] == "NORMAL"
    failed = r["rows"][HEALED]
    assert failed[0] == HEALED and failed[1] == "NORMAL" and failed[3] < 15
    assert r["n"] == r["jn"] == LOST - 1
    assert not np.any(np.abs(r["t"] - SYS_DT * HEALED) < 1e-4)
    assert_poses_close(r["est"], r["jest"])


def test_blackout_not_healed_raises_at_commit(async_runs):
    """Three flat frames: the loss shows when the first of them is
    committed, two frames later; there both packages enter REINITIALIZE (the
    port used to raise there), with the rows of the three frames written
    and the tensor state handed back."""
    assert async_runs["states"] == {
        LOST: (State.NORMAL, "NORMAL"), LOST + 1: (State.NORMAL, "NORMAL"),
        LOST + 2: (State.REINITIALIZE, "REINITIALIZE")}
    r = async_runs["lost"]
    assert r["jstate"] == "REINITIALIZE"
    assert r["state"] == State.REINITIALIZE and r["dev"] is None
    assert [x[:2] for x in r["rows"][LOST:]] == [
        (LOST, "NORMAL>LOST"), (LOST + 1, "NORMAL"), (LOST + 2, "NORMAL")]
    assert [x[:5] for x in r["rows"]] == [x[:5] for x in r["jrows"][:LOST + 3]]
    assert r["n"] == LOST - 1


@pytest.fixture(scope="module")
def normal_state(sequence):
    """A JAX sync System after 8 frames (NORMAL), its state lifted into the
    async loop's tensors and carried across; frame 8's features from the
    port's front end, for both."""
    _, _, pairs = sequence
    jcfg, tcfg = system_configs()
    js = JSystem(jcfg)
    for i in range(8):
        js.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i)
    jt = js.trackers["SLAM"]
    assert jt.state.name == "NORMAL"
    jt._ensure_dev()
    ts = System(tcfg)
    il, ir = (preprocess_image(torch.from_numpy(x), 1.0) for x in pairs[8])
    f2 = ts._families["SLAM"].extract_batch(torch.stack([il, ir]), capacity=512)
    feats = match_stereo_refined(FrameFeatures(*(x[0] for x in f2)),
                                 FrameFeatures(*(x[1] for x in f2)), il, ir, bf=SYS_CAM.bf)
    dev = interop.dev_track_state_from_numpy(jax.tree.map(np.asarray, jt._dev), "cpu")
    return jt, js.cameras["SLAM"], ts, feats, dev


@pytest.mark.parametrize("tracked", [True, False])
def test_track_normal_step_matches_jax(normal_state, tracked):
    """One frame through both ``track_normal_step``: the counters equal;
    tracked, the pose and the rolled-over state within the tolerances and
    one trajectory row more; failed (no features), the state frozen bit for
    bit and the trajectory as it was."""
    jt, jcam, ts, feats, dev = normal_state
    if not tracked:
        feats = feats._replace(valid=torch.zeros_like(feats.valid))
    ms, traj = ms_to_torch(jt.ms), traj_to_torch(jt.traj)
    tt = ts.trackers["SLAM"]
    out = strategies.track_normal_step(
        ts.cameras["SLAM"], feats, 0.8, traj, dev, ms, 30, n_levels=tt.n_levels,
        scale_factor=tt.scale_factor, params=tt.params)
    want = j_strategies.track_normal_step(
        jcam, feats_to_jax(feats), jnp.asarray(0.8, jnp.float32), jt.traj, jt._dev, jt.ms,
        jnp.asarray(30, jnp.int32), n_levels=jt.n_levels, scale_factor=jt.scale_factor,
        params=jt.params)
    assert out.scalars.tolist() == np.asarray(want.scalars).tolist()
    assert bool(out.scalars[6]) == tracked
    assert int(out.traj.size) == int(np.asarray(want.traj.size)) == 8 + int(tracked)
    got, ref = interop.dev_track_state_to_numpy(out.dev), tree_np(want.dev)
    assert int(got["ref_kf"]) == int(ref["ref_kf"])
    assert int(got["last_ref_kf"]) == int(ref["last_ref_kf"])
    if tracked:
        assert_poses_close(out.Tcw[None].numpy(), np.asarray(want.Tcw)[None])
        assert_poses_close(got["last_Tcw"][None], ref["last_Tcw"][None])
        assert_poses_close(got["last_Tcr"][None], ref["last_Tcr"][None])
        np.testing.assert_array_equal(got["last_lm_id"], ref["last_lm_id"])
        np.testing.assert_array_equal(out.lm_id.numpy(), np.asarray(want.lm_id))
        assert torch.equal(out.dev.last_feats.uv, feats.uv)
        assert_poses_close(out.traj.Tcw[8:9].numpy(), np.asarray(want.traj.Tcw[8:9]))
    else:
        before = interop.dev_track_state_to_numpy(dev)
        for k in ("last_Tcw", "last_Tcr", "last_ref_kf", "ref_kf", "last_lm_id"):
            assert got[k].tobytes() == before[k].tobytes() == ref[k].tobytes(), k
        for k, v in before["last_feats"].items():
            assert got["last_feats"][k].tobytes() == v.tobytes(), k
        # the slot past ``size`` is written but not committed
        assert torch.equal(out.traj.Tcw[:8], traj.Tcw[:8])
        assert not bool(out.traj.valid[8])
