"""The port's LoopCloser (``hyslam_tpu_torch/slam/loop_closing.py``) against
the JAX package's on the CPU, over tests/test_loopclosing.py's drifted
circle (24 keyframes, drift 0.01 m a keyframe, the revisit creating
duplicate landmarks), with the same vocabulary and the JAX package's Sim3
RANSAC draws.

Bounds: the same keyframe closes with the same candidate, once; Sim3
inliers within 2; every keyframe pose within 1e-3 m and 0.05 deg of the JAX
package's after the correction and the essential graph, with fixed and with
free scale; landmarks held in image space (their projections into their
first keyframe within 0.05 px; positions along a viewing ray are not
determined to that). The JAX test's accuracy gates hold for the port (the
last keyframe's error halved, a mid-chain keyframe's cut by a quarter). A
state handed over mid-run (``interop.loop_closer_from``) closes the same
loop. A straight line closes nothing. ``correct`` refuses a culled keyframe
or candidate."""

import numpy as np
import pytest
import torch

from hyslam_tpu.core import mapstate as JM
from hyslam_tpu.features.bow import PlaceRecognizer as JPlaceRecognizer
from hyslam_tpu.features.bow import train_vocabulary as j_train
from hyslam_tpu.slam.loop_closing import LoopCloser as JLoopCloser
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.features.bow import PlaceRecognizer
from hyslam_tpu_torch.slam.loop_closing import LoopCloser

from helpers import pose_error
from port_helpers import ms_to_torch, one_thread, use_jax_samples  # noqa: F401
from test_loopclosing import CAM as JCAM
from test_loopclosing import CAPS, build_drifted_loop

CAM = interop.camera_from(JCAM)
HANDOFF = 15      # keyframes the JAX closer processes before the handover


def _closers(vocab_j, fix_scale):
    jc = JLoopCloser(cam=JCAM, recognizer=JPlaceRecognizer(vocab_j, K=CAPS.K),
                     fix_scale=fix_scale)
    tc = LoopCloser(cam=CAM, recognizer=PlaceRecognizer(
        interop.vocabulary_from_numpy(vocab_j, "cpu"), K=CAPS.K), fix_scale=fix_scale)
    return jc, tc


def _run(closer, ms, ks):
    closed = []
    for k in ks:
        ms, ok, info = closer.process_keyframe(ms, k)
        if ok:
            closed.append((k, info["loop_kf"], info["sim3_inliers"]))
    return ms, closed


@pytest.fixture(scope="module", params=[True, False], ids=["fixed_scale", "free_scale"])
def runs(request):
    """Both packages' closers over the drifted loop: (JAX map, JAX
    closures, port map, port closures, the scene, the JAX state after
    HANDOFF keyframes as the port's)."""
    fix = request.param
    mp = pytest.MonkeyPatch()
    use_jax_samples(mp)
    try:
        ms_j0, descs, T_true, T_drift, n_kf = build_drifted_loop(np.random.default_rng(0))
        vocab_j = j_train(descs, k=8, depth=3)
        jc, tc = _closers(vocab_j, fix)
        ms_t, closed_t = _run(tc, ms_to_torch(ms_j0), range(n_kf))
        ms_j, closed_j = _run(jc, ms_j0, range(HANDOFF))
        handed = (interop.loop_closer_from(jc, "cpu"), ms_to_torch(ms_j))
        ms_j, more = _run(jc, ms_j, range(HANDOFF, n_kf))
        yield dict(ms_j=ms_j, closed_j=closed_j + more, ms_t=ms_t, closed_t=closed_t,
                   T_true=T_true, T_drift=T_drift, n_kf=n_kf, handed=handed, jc=jc, tc=tc,
                   fix=fix)
    finally:
        mp.undo()


def _project(T, X):
    pc = X @ T[:3, :3].T + T[:3, 3]
    return np.stack([JCAM.fx * pc[:, 0] / pc[:, 2] + JCAM.cx,
                     JCAM.fy * pc[:, 1] / pc[:, 2] + JCAM.cy], -1)


def test_same_loop_closes_with_the_same_correction(runs):
    cj, ct = runs["closed_j"], runs["closed_t"]
    assert len(cj) == len(ct) == 1
    assert ct[0][:2] == cj[0][:2], (ct, cj)
    assert abs(ct[0][2] - cj[0][2]) <= 2
    assert runs["tc"].n_closed == runs["jc"].n_closed == 1
    assert runs["tc"].last_loop_kf == runs["jc"].last_loop_kf == cj[0][0]
    n_kf = runs["n_kf"]
    Tj = np.asarray(runs["ms_j"].kf.Tcw[:n_kf])
    Tt = runs["ms_t"].kf.Tcw[:n_kf].numpy()
    errs = [pose_error(Tt[k], Tj[k]) for k in range(n_kf)]
    assert max(e[1] for e in errs) < 1e-3 and max(e[0] for e in errs) < 0.05, errs
    # landmarks in image space: each live one in its first keyframe
    lm_j, lm_t = runs["ms_j"].lm, runs["ms_t"].lm
    live = np.asarray(lm_j.valid & ~lm_j.bad)
    assert (live == (lm_t.valid & ~lm_t.bad).numpy()).all()
    first = np.asarray(lm_j.first_kf)
    for k in range(n_kf):
        sel = live & (first == k)
        if sel.any():
            d = (_project(Tt[k], lm_t.pos.numpy()[sel])
                 - _project(Tj[k], np.asarray(lm_j.pos)[sel]))
            assert np.abs(d).max() < 0.05, (k, np.abs(d).max())


def test_port_closure_cuts_the_drift(runs):
    """tests/test_loopclosing.py's gates, on the port's map."""
    n_kf, T_true, T_drift = runs["n_kf"], runs["T_true"], runs["T_drift"]
    Tt = runs["ms_t"].kf.Tcw.numpy()
    last, mid = n_kf - 1, (2 * n_kf) // 3
    assert pose_error(Tt[last], T_true[last])[1] < 0.5 * pose_error(T_drift[last],
                                                                     T_true[last])[1]
    assert pose_error(Tt[mid], T_true[mid])[1] < 0.75 * pose_error(T_drift[mid],
                                                                   T_true[mid])[1]


def test_state_handed_over_mid_run_closes_the_same_loop(runs, monkeypatch):
    use_jax_samples(monkeypatch)
    tc, ms = runs["handed"]
    assert tc.fix_scale == runs["fix"] and tc.n_closed == 0
    ms, closed = _run(tc, ms, range(HANDOFF, runs["n_kf"]))
    assert [c[:2] for c in closed] == [c[:2] for c in runs["closed_j"]]
    back = interop.loop_closer_from(interop.loop_closer_to_numpy(tc), "cpu")
    assert back.loop_edges[0][:2] == tc.loop_edges[0][:2]
    assert np.array_equal(back.loop_edges[0][2], tc.loop_edges[0][2])
    assert torch.equal(back.recognizer.kf_bow, tc.recognizer.kf_bow)
    assert back.consistency == tc.consistency and back.last_loop_kf == tc.last_loop_kf


def test_correct_refuses_a_culled_keyframe_or_candidate(monkeypatch):
    """A loop verified on a map whose keyframe or candidate is culled by the
    time the correction runs changes nothing."""
    use_jax_samples(monkeypatch)
    ms_j, descs, _, _, n_kf = build_drifted_loop(np.random.default_rng(0))
    _, tc = _closers(j_train(descs, k=8, depth=3), True)
    ms = ms_to_torch(ms_j)
    for k in range(16):
        tc.recognizer.add_keyframe(k, ms.kf.desc[k], ms.kf.kp_valid[k])
    ok, g, n = tc.compute_sim3(ms, 16, 0)
    assert ok and n >= 40
    # the keyframe culled by the mapper; the candidate (keyframe 0, an
    # origin, which the mapper never culls) flagged bad directly
    for bad in (M.set_keyframes_bad(ms, torch.arange(ms.K) == 16),
                ms._replace(kf=ms.kf._replace(bad=ms.kf.bad | (torch.arange(ms.K) == 0)))):
        out, applied = tc.correct(bad, 16, 0, g)
        assert not applied and out is bad
        assert tc.loop_edges == [] and tc.last_loop_kf < 0
    out, applied = tc.correct(ms, 16, 0, g)
    assert applied and tc.last_loop_kf == 16 and len(tc.loop_edges) == 1


def test_no_loop_on_a_straight_line(rng):
    """tests/test_loopclosing.py's straight line (8 keyframes 0.4 m apart)
    through both packages' closers: neither closes."""
    from hyslam_tpu.geometry import se3 as jse3
    import jax.numpy as jnp

    from helpers import make_world, synth_frame_features

    F = CAPS.F
    ms = JM.empty_map_state(CAPS)
    pts = make_world(rng, 600, extent=(10, 6, 60), z_min=2.0)
    descs = rng.integers(0, 2**32, (600, 8), dtype=np.uint32)
    jc, tc = _closers(j_train(descs, k=8, depth=3), True)
    T = np.eye(4, dtype=np.float32)
    created = np.full(600, -1, np.int32)
    for k in range(8):
        feats, gt = synth_frame_features(JCAM, T, pts, descs, rng, F=F)
        assoc = np.full(F, -1, np.int32)
        sel = gt >= 0
        assoc[sel] = created[gt[sel]]
        ms, kf = JM.add_keyframe(ms, feats, jnp.asarray(T), 0.1 * k, k, 0, jnp.asarray(assoc),
                                 origin=(k == 0))
        new = sel & (assoc < 0)
        X = jse3.apply(jse3.inverse(jnp.asarray(T)), jnp.stack(
            [(feats.uv[:, 0] - JCAM.cx) / JCAM.fx * feats.depth,
             (feats.uv[:, 1] - JCAM.cy) / JCAM.fy * feats.depth, feats.depth], -1))
        ms, lm_idx = JM.add_landmarks(ms, X, feats.desc, kf, jnp.arange(F, dtype=jnp.int32),
                                      jnp.asarray(new))
        lm_idx = np.asarray(lm_idx)
        created[gt[new]] = lm_idx[new]
        T = jse3.exp(jnp.asarray([0, 0, 0, 0, 0, -0.4], jnp.float32)) @ T
        T = np.asarray(T)
        ms = JM.refresh_covisibility(ms)
        ms_t, ok_t, _ = tc.process_keyframe(ms_to_torch(ms), int(kf))
        ms, ok_j, _ = jc.process_keyframe(ms, int(kf))
        assert not ok_t and not ok_j
        assert tc.consistency == jc.consistency
