"""The port's async ``System.track_monocular`` against the JAX package's on
the CPU, through a loss of tracking: 640x360 rendered frames, 300 features
over 4 levels, capacity 512, frames 12-15 flat.

What a monocular loss does in async mode is kept as the JAX package does it
(ROADMAP queue 3, kept for parity): the loss shows at the failed frame's
commit, ``commit_lag`` frames late (``NORMAL>LOST``); the frames still in
flight are drained without the keyframe policy, and the last of them decides
whether the blip heals; here it failed too, so the tracker goes to
RELOCALIZE, a cold state that runs synchronously, relocalizes on the first
rendered frame and goes on dispatching. States and keyframes equal the JAX
package's on every frame; counts within 2% up to the loss. After the
relocalization the PnP winners may differ (the port keeps the DLT solutions
that the JAX package's eigenvector sign loses, tests/test_torch_reloc.py),
so the poses there are held to the truth after a sim3 alignment."""

import pytest
import torch

from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.slam.tracker import State

from port_helpers import SYS_DT, mono_images, mono_system_configs, one_thread, use_jax_samples
from test_torch_mono import assert_init_extractor_used, assert_rows_close, ate_sim3

N_ASYNC, DARK = 20, (12, 16)


@pytest.fixture(scope="module")
def async_runs():
    Ts, imgs = mono_images(N_ASYNC, dark=DARK)
    jcfg, tcfg = mono_system_configs(async_tracking=True)
    js, ts = JSystem(jcfg), System(tcfg)
    with pytest.MonkeyPatch.context() as mp:
        use_jax_samples(mp)
        for i in range(N_ASYNC):
            js.track_monocular(imgs[i], SYS_DT * i, frame_id=i)
            ts.track_monocular(imgs[i], SYS_DT * i, frame_id=i)
        js.flush()
        ts.flush()
    return Ts, js, ts


def test_async_track_monocular_matches_jax(async_runs):
    Ts, js, ts = async_runs
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    assert [t.frame_id for t in tt.telemetry] == list(range(N_ASYNC))
    assert [(t.state, t.kf_inserted) for t in tt.telemetry] == [
        (t.state, t.kf_inserted) for t in jt.telemetry]
    assert_rows_close(tt.telemetry[:DARK[0]], jt.telemetry[:DARK[0]])
    assert_init_extractor_used(js, ts)
    assert tt.state == State.NORMAL and not tt._pending
    assert ate_sim3(tt, Ts) < 0.1 and abs(ate_sim3(tt, Ts) - ate_sim3(jt, Ts)) < 0.01


def test_async_mono_loss_goes_to_relocalize(async_runs):
    _, _, ts = async_runs
    tt = ts.trackers["SLAM"]
    states = [t.state for t in tt.telemetry]
    lag = tt.commit_lag
    assert states[DARK[0]] == "NORMAL>LOST"
    assert states[DARK[0] + 1:DARK[0] + 1 + lag] == ["NORMAL"] * lag     # drained
    assert all(t.kf_inserted < 0 for t in tt.telemetry[DARK[0]:DARK[1] + 1])
    assert states[DARK[0] + 1 + lag:DARK[1]] == ["RELOCALIZE"] * (DARK[1] - DARK[0] - 1 - lag)
    assert states[DARK[1]] == "RELOCALIZE>RELOC_OK"
    assert [r["ok"] for r in tt.reloc_log] == [False] * (DARK[1] - DARK[0] - 1 - lag) + [True]
    # the frames after the relocalization are dispatched again, and tracked
    assert all(s.split(">")[0] in ("NORMAL", "POSTINIT") for s in states[DARK[1] + 1:])
