"""The periodic global BA of the port's ``System`` against the JAX
package's, on the CPU: 640x360 rendered stereo frames, 300 features over 4
levels, MapCaps(K=32, L=4096, F=512, O=8), ``optimizer.realtime=False``.

- Synchronous, ``gba_interval`` 3 over 12 frames, through both packages: the
  same rows, keyframes and global BA calls (on the same keyframes), their
  costs within 1e-3 relative, the trajectories (each refreshed from the
  optimized keyframes) within the poses' bounds of
  tests/test_torch_system.py; after each global BA every trajectory row is
  its live reference keyframe's pose composed with the row's relative pose.
- Async: the JAX package's async mode never reaches its map maintenance
  (ROADMAP queue 3, a reference fault). The port's does: it runs a global
  BA every ``gba_interval`` keyframes, between frames, after the frames in
  flight are committed; asserted as the fixed behaviour.
"""

import numpy as np
import pytest
import torch

from hyslam_tpu.io.config import OptimizerInfo as JOptimizerInfo
from hyslam_tpu.slam import system as jsystem_mod
from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu.slam.tracker import State as JState
from hyslam_tpu_torch.slam import system as system_mod
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.slam.tracker import State

from port_helpers import SYS_DT, one_thread, system_configs, system_sequence
from test_torch_system import assert_poses_close, rows

N_SYS, GBA_EVERY = 12, 3


def _spy(monkeypatch, module, log):
    """Record (cost, keyframes valid) of every run_global_ba the System makes."""
    real = module.run_global_ba

    def spy(ms, *a, **kw):
        out = real(ms, *a, **kw)
        log.append((out[1], int(np.asarray(ms.next_kf))))
        return out

    monkeypatch.setattr(module, "run_global_ba", spy)


@pytest.fixture(scope="module")
def offline_runs():
    _, _, pairs = system_sequence(N_SYS)
    jcfg, tcfg = system_configs(optimizer=JOptimizerInfo(realtime=False,
                                                         gba_interval=GBA_EVERY))
    js, ts = JSystem(jcfg), System(tcfg)
    log_j, log_t, refreshed = [], [], []
    refresh = ts._refresh_trajectory

    def recording_refresh(camera):
        refresh(camera)
        t = ts.trackers[camera]
        refreshed.append((t.traj, t.ms.kf.Tcw.clone(), t.ms.kf.bad.clone()))

    ts._refresh_trajectory = recording_refresh
    with pytest.MonkeyPatch.context() as mp:
        _spy(mp, jsystem_mod, log_j)
        _spy(mp, system_mod, log_t)
        for i in range(N_SYS):
            js.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i)
            ts.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i)
    return js, ts, log_j, log_t, refreshed


def test_offline_system_runs_global_ba_as_jax(offline_runs):
    js, ts, log_j, log_t, _ = offline_runs
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    assert rows(tt.telemetry) == rows(jt.telemetry)
    n_kf = sum(t.kf_inserted >= 0 for t in tt.telemetry)
    assert len(log_t) == len(log_j) == n_kf // GBA_EVERY >= 2
    assert [k for _, k in log_t] == [k for _, k in log_j]
    for (c_t, _), (c_j, _) in zip(log_t, log_j):
        assert abs(c_t - c_j) <= 1e-3 * c_j
    assert ts._kfs_since_gba == js._kfs_since_gba == n_kf % GBA_EVERY
    n = int(tt.traj.size)
    assert_poses_close(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]))


def test_offline_system_trajectory_refreshed_from_keyframes(offline_runs):
    """After each global BA every trajectory row whose reference keyframe
    is live is that keyframe's optimized pose composed with the row's
    relative pose."""
    _, ts, _, log_t, refreshed = offline_runs
    assert len(refreshed) == len(log_t) >= 2
    for traj, kf_Tcw, kf_bad in refreshed:
        n = int(traj.size)
        ref = traj.ref_kf[:n].long()
        live = ~kf_bad[ref]
        assert bool(live.any())
        want = traj.Tcr[:n] @ kf_Tcw[ref]
        torch.testing.assert_close(traj.Tcw[:n][live], want[live], atol=1e-6, rtol=0)


def test_async_system_runs_global_ba_every_interval(monkeypatch):
    """The fixed behaviour: the async System reaches its map maintenance
    from the deferred keyframes and from the cold states' (initialization)
    and runs a global BA every gba_interval keyframes; the JAX package's
    async System runs none."""
    _, _, pairs = system_sequence(N_SYS)
    jcfg, tcfg = system_configs(async_tracking=True, optimizer=JOptimizerInfo(
        realtime=False, gba_interval=GBA_EVERY))
    js, ts = JSystem(jcfg), System(tcfg)
    log_j, log_t = [], []
    _spy(monkeypatch, jsystem_mod, log_j)
    _spy(monkeypatch, system_mod, log_t)
    for i in range(N_SYS):
        js.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i)
        ts.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i)
    js.flush()
    ts.flush()
    tt = ts.trackers["SLAM"]
    n_kf = sum(t.kf_inserted >= 0 for t in tt.telemetry)
    assert log_j == [] and js._kfs_since_gba == 0
    assert len(log_t) == n_kf // GBA_EVERY >= 1 and ts._kfs_since_gba == n_kf % GBA_EVERY
    assert all(np.isfinite(c) for c, _ in log_t) and not tt._pending
    assert tt.state == State.NORMAL and js.trackers["SLAM"].state == JState.NORMAL
    assert [t.frame_id for t in tt.telemetry] == list(range(N_SYS))
