"""Loop closing through the port's synchronous ``System`` against the JAX
package's on the CPU: ``System.track_features`` over a feature-level circuit
(tests/port_helpers.py:loop_circuit: 24 frames around a circle, then 4 over
its start; frames 6-7 without features), loop closing on as the config's
default, the vocabulary trained on the world's descriptors and read from an
npz file. After the row that carries ``>REINIT_OK`` the registered sub-map
is moved by tests/test_longrun.py's perturbation (3 deg, 0.35 m, 0.35 m)
with its tiepoint re-measured, in both packages; the revisit then closes a
loop across the sub-map border.

Bounds: rows (states, counts, keyframes) equal; the same keyframe closes
with the same candidate; every trajectory pose and keyframe pose within
1e-3 of the JAX package's, entry by entry. Also: the default config builds
and tracks, and a map loaded from a file drops the loop closer, which the
next keyframe rebuilds from the loaded map."""

import numpy as np
import pytest
import torch

from hyslam_tpu.core import mapstate as JM
from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.frame import empty_features
from hyslam_tpu_torch.features.bow import train_vocabulary
from hyslam_tpu_torch.features.vocab_io import save_vocabulary
from hyslam_tpu_torch.io.config import SystemConfig
from hyslam_tpu_torch.io.evaluate import ate_rmse
from hyslam_tpu_torch.slam.system import System

from port_helpers import (LOOP_DT, feats_to_torch, loop_circuit, loop_system_configs,
                          one_thread, run_loop_circuit)  # noqa: F401
from test_torch_system import rows

POSE_ATOL = 1e-3


@pytest.fixture(scope="module")
def circuit(tmp_path_factory):
    Ts, feats, descs = loop_circuit()
    path = str(tmp_path_factory.mktemp("vocab") / "circuit.npz")
    save_vocabulary(path, train_vocabulary(descs, k=10, depth=3, device="cpu"))
    return Ts, feats, path


def _perturb_jax(tracker, T):
    import jax.numpy as jnp

    active = int(np.asarray(tracker.ms.maps.active))
    tracker.ms = JM.refresh_tiepoints(JM.apply_transform_to_map(tracker.ms, active,
                                                                jnp.asarray(T)))


def perturb_port(tracker, T):
    """Move the active sub-map (async: after committing the frames in
    flight, the tracker's tensor state then re-read from the map)."""
    tracker.drain_pending()
    tracker._sync_dev_to_host()
    active = int(tracker.ms.maps.active)
    tracker.ms = M.refresh_tiepoints(M.apply_transform_to_map(
        tracker.ms, active, torch.from_numpy(T).to(tracker.device)))


@pytest.fixture(scope="module")
def runs(circuit):
    Ts, feats, path = circuit
    jcfg, tcfg = loop_system_configs(path)
    js, ts = JSystem(jcfg), System(tcfg)
    assert tcfg.enable_loop_closing and SystemConfig().enable_loop_closing
    jrows, j_nudged = run_loop_circuit(js, feats, lambda f: f, _perturb_jax, lambda: None)
    trows, t_nudged = run_loop_circuit(ts, feats, feats_to_torch, perturb_port, ts.flush)
    return js, ts, jrows, trows, j_nudged, t_nudged


def test_sync_rows_and_loop_equal_jax(runs, circuit):
    js, ts, jrows, trows, j_nudged, t_nudged = runs
    Ts = circuit[0]
    assert t_nudged == j_nudged is not None
    assert rows(trows) == rows(jrows)
    jc, tc = js.loop_closers["SLAM"], ts.loop_closers["SLAM"]
    assert tc.n_closed == jc.n_closed >= 1
    assert [e[:2] for e in tc.loop_edges] == [e[:2] for e in jc.loop_edges]
    kf, cand = tc.loop_edges[0][:2]
    ms = ts.trackers["SLAM"].ms
    # across the border: the closing keyframe in the sub-map, its candidate
    # in the root map, and the closure on the revisit
    assert int(ms.kf.map_id[kf]) == 1 and int(ms.kf.map_id[cand]) == 0
    assert int(ms.maps.n_maps) == 2 and bool(ms.maps.registered[1])
    assert int(ms.kf.frame_id[kf]) >= 20
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size))
    np.testing.assert_allclose(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]),
                               rtol=0, atol=POSE_ATOL)
    K = int(ms.next_kf)
    np.testing.assert_allclose(ms.kf.Tcw[:K].numpy(), np.asarray(jt.ms.kf.Tcw[:K]),
                               rtol=0, atol=POSE_ATOL)
    idx = np.rint(tt.traj.t[:n].numpy() / LOOP_DT).astype(int)
    assert ate_rmse(tt.traj.Tcw[:n].numpy(), Ts[idx]) < 0.05


def test_default_config_builds_and_tracks():
    s = System(SystemConfig(device="cpu"))
    assert s.config.enable_loop_closing
    tel = s.track_features(empty_features(s.config.caps.F), 0.0)
    assert tel.state == "INITIALIZE" and s.loop_closers == {}


def test_loaded_map_drops_the_loop_closer(runs, circuit, tmp_path):
    """Map and checkpoint files carry no BoW rows: after load_map the loop
    closer and the tracker's recognizer are gone, and the next keyframe
    rebuilds them, back-filled with every keyframe of the loaded map; so
    after load_checkpoint."""
    _, ts, _, _, _, _ = runs
    Ts, feats, _ = circuit
    ts.save_map(str(tmp_path / "map.npz"))
    ts.load_map(str(tmp_path / "map.npz"))
    tracker = ts.trackers["SLAM"]
    assert ts.loop_closers == {} and tracker.recognizer is None
    n_kf = int(tracker.ms.next_kf)
    tel = ts.track_features(feats_to_torch(feats[-1]), LOOP_DT * len(Ts), frame_id=len(Ts))
    assert tel.kf_inserted == n_kf
    closer = ts.loop_closers["SLAM"]
    assert tracker.recognizer is closer.recognizer and closer.loop_edges == []
    assert closer.recognizer.present[:n_kf + 1].all()
    ts.save_checkpoint(str(tmp_path / "ckpt.npz"))
    ts.load_checkpoint(str(tmp_path / "ckpt.npz"))
    assert ts.loop_closers == {} and tracker.recognizer is None
