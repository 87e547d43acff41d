"""Loop closing through the port's async ``System`` (``async_tracking=True,
commit_lag=2``) on the CPU, the port alone (the JAX package runs its
detection on a worker thread whose shedding depends on timing; the port has
no thread), over tests/port_helpers.py:corridor_circuit: 12 frames forward
along a corridor, a 4-frame blackout (longer than the commit lag, so that
the loss is not healed), a re-initialized sub-map moved by
tests/test_longrun.py's perturbation, then back over the start. (The sync
test's circle turns 15 degrees a frame: the async loop's keyframes, made
at commit, trail such a turn and lose it.)

Asserted: every keyframe the commits make, from the one that builds the
loop closer on, goes through detection once and in keyframe order; a loop
closes across the sub-map border, verified twice (once on the map of its
keyframe's commit, once more after the frames in flight are committed);
rows arrive for every frame in order; the ATE bound of
tests/test_async_tracking.py's async loop-closing test (0.40 m) holds."""

import numpy as np

from hyslam_tpu_torch.features.bow import train_vocabulary
from hyslam_tpu_torch.features.vocab_io import save_vocabulary
from hyslam_tpu_torch.io.evaluate import ate_rmse
from hyslam_tpu_torch.slam import loop_closing
from hyslam_tpu_torch.slam.system import System

from port_helpers import (LOOP_DT, corridor_circuit, feats_to_torch, loop_system_configs,
                          one_thread, run_loop_circuit)  # noqa: F401
from test_torch_loop_system import perturb_port


def test_async_system_closes_the_loop(tmp_path, monkeypatch):
    Ts, feats, descs = corridor_circuit()
    path = str(tmp_path / "circuit.npz")
    save_vocabulary(path, train_vocabulary(descs, k=10, depth=3, device="cpu"))
    _, cfg = loop_system_configs(path, async_tracking=True)
    assert cfg.commit_lag == 2
    sysm = System(cfg)
    detected, verified = [], []
    real_dv, real_sim3 = (loop_closing.LoopCloser.detect_and_verify,
                          loop_closing.LoopCloser.compute_sim3)

    def dv(self, ms, kf_id):
        detected.append(kf_id)
        return real_dv(self, ms, kf_id)

    def sim3(self, ms, kf_id, cand):
        out = real_sim3(self, ms, kf_id, cand)
        verified.append((kf_id, cand, out[0]))
        return out

    monkeypatch.setattr(loop_closing.LoopCloser, "detect_and_verify", dv)
    monkeypatch.setattr(loop_closing.LoopCloser, "compute_sim3", sim3)
    returned, nudged = run_loop_circuit(sysm, feats, feats_to_torch, perturb_port, sysm.flush)
    tr = sysm.trackers["SLAM"]
    assert nudged is not None
    assert [t.frame_id for t in tr.telemetry] == list(range(len(Ts)))
    kfs = [t.kf_inserted for t in tr.telemetry if t.kf_inserted >= 0]
    assert detected == kfs[kfs.index(detected[0]):] and detected[0] <= 4
    closer = sysm.loop_closers["SLAM"]
    assert closer.n_closed >= 1
    kf, cand = closer.loop_edges[0][:2]
    assert [v for v in verified if v[2]][:2] == [(kf, cand, True)] * 2
    ms = tr.ms
    assert int(ms.kf.map_id[kf]) == 1 and int(ms.kf.map_id[cand]) == 0
    n = int(tr.traj.size)
    idx = np.rint(tr.traj.t[:n].numpy() / LOOP_DT).astype(int)
    ate = ate_rmse(tr.traj.Tcw[:n].numpy(), Ts[idx])
    assert ate < 0.40, ate
