"""A monocular loss through the port's ``Tracker`` and the JAX package's, on
the CPU, to ``RELOCALIZE>RELOC_OK``: the features of tests/port_helpers.py's
mono_sequence (a plane and a cloud, sideways motion), frames 10-11 without
features, the same RANSAC sample sets in both. States and keyframes equal,
counts within 2%, trajectories within 1e-3 (tests/test_torch_mono.py's
bounds)."""

import numpy as np
import pytest

from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
from hyslam_tpu.slam.tracker import Tracker as JTracker
from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.slam.tracker import State, Tracker

from helpers import DEFAULT_CAM
from port_helpers import feats_to_torch, mono_sequence, one_thread, use_jax_samples
from test_torch_mono import CAPS as MONO_CAPS
from test_torch_mono import assert_rows_close

CAM = camera_from(DEFAULT_CAM)

N_LOSS, DARK = 15, (10, 12)


@pytest.fixture(scope="module")
def mono_loss_runs():
    Ts, feats = mono_sequence(N_LOSS, dark=DARK)
    jt = JTracker(cam=DEFAULT_CAM, caps=JMapCaps(*MONO_CAPS), is_mono=True)
    tt = Tracker(cam=CAM, caps=MapCaps(*MONO_CAPS), is_mono=True, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        use_jax_samples(mp)
        for i, f in enumerate(feats):
            jt.track(f, 0.1 * i, i)
            tt.track(feats_to_torch(f), 0.1 * i, i)
    return Ts, jt, tt


def test_mono_loss_relocalizes_as_jax(mono_loss_runs):
    """NORMAL -> (loss) RELOCALIZE -> RELOCALIZE>RELOC_OK -> NORMAL in both
    Trackers, on the same frames; the port's relocalization log counts the
    candidates and the pose-only solves."""
    Ts, jt, tt = mono_loss_runs
    states = [t.state for t in tt.telemetry]
    assert states[DARK[0]] == "NORMAL" and states[DARK[0] + 1] == "RELOCALIZE"
    assert states[DARK[1]] == "RELOCALIZE>RELOC_OK" and tt.state == State.NORMAL
    assert_rows_close(tt.telemetry, jt.telemetry)
    assert [(r["frame_id"], r["ok"]) for r in tt.reloc_log] == [
        (i, i == DARK[1]) for i in range(DARK[0] + 1, DARK[1] + 1)]
    last = tt.reloc_log[-1]
    assert last["candidates"] >= last["pnp_solves"] >= last["local_solves"] >= 1
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size)) == N_LOSS - 1 - (DARK[1] - DARK[0]) - 1
    np.testing.assert_allclose(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]), atol=1e-3)

