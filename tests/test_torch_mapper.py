"""The port's bundle adjustment and mapper jobs against the JAX package's,
on the CPU: the dense BA cases of tests/test_solver.py, and each mapper job
run on a map state the JAX tracker built (the input of its 4th mapper call,
the first that runs local BA). Counts and integer arenas must be equal,
poses and other floats within 1e-4.

Landmark positions are held where they are determined. A DLT point of small
parallax, or a far point in BA, is fixed well across its viewing ray and
poorly along it: its normal matrix has condition numbers up to ~2e4, so
float32 rounding in another summation order moves it along the ray (up to
20 m at 40 m for the DLT, 2.4e-3 relative after 12 BA iterations; both
packages land within their own rounding of the same cost). Such a point is
compared where it is used, in every image that observes it: the projections
must agree within PX_DLT or PX_BA pixels. Every other landmark, and every
landmark's normal and distance bounds, within 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.slam import mapper as j_mapper
from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams as JPolicy
from hyslam_tpu.slam.tracker import Tracker as JTracker
from hyslam_tpu.solver import ba as j_ba
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.slam import mapper
from hyslam_tpu_torch.solver import ba

import test_solver
from helpers import DEFAULT_CAM, make_world, synth_frame_features
from port_helpers import assert_tree_close, ms_to_torch, tree_np

torch.set_num_threads(2)
CAM = camera_from(DEFAULT_CAM)
ATOL = 1e-4
PX_DLT = 0.5     # px; measured 0.40 px worst, 2.8e-4 px at the 99th percentile
PX_BA = 0.05     # px; measured 0.023 px worst


def _project(pos, Tcw, kf, fx):
    """Pixels (without the principal point) of landmarks pos [N,3] in the
    keyframes kf [N] of poses Tcw [K,4,4]."""
    T = Tcw[kf]
    pc = np.einsum("nij,nj->ni", T[:, :3, :3], pos) + T[:, :3, 3]
    return pc[:, :2] / pc[:, 2:] * fx


def assert_points_close(pos_t, pos_j, Tcw_t, Tcw_j, obs_kf, obs_valid, px):
    """Landmarks (rows of pos) agree within 1e-4, or else project within px
    pixels of each other into every keyframe that observes them. Returns
    the mask of landmarks that agree within 1e-4."""
    l_idx, o_idx = np.nonzero(obs_valid)
    kf = obs_kf[l_idx, o_idx]
    d_px = np.linalg.norm(_project(pos_t[l_idx], Tcw_t, kf, DEFAULT_CAM.fx)
                          - _project(pos_j[l_idx], Tcw_j, kf, DEFAULT_CAM.fx), axis=1)
    close = np.abs(pos_t - pos_j).max(-1) <= ATOL
    assert (close[l_idx] | (d_px <= px)).all(), d_px.max()
    return close


def assert_map_close(got, want, px):
    """Integer and bool arenas equal; poses and other floats within 1e-4
    (and 1e-5 relative, for distances of tens of metres summed over up to
    8 moved cameras); landmark positions as assert_points_close, and the
    normals and distance bounds of the landmarks whose positions agree
    within 1e-4."""
    g, w = tree_np(got), tree_np(want)
    close = assert_points_close(g["lm"]["pos"], w["lm"]["pos"], g["kf"]["Tcw"],
                                w["kf"]["Tcw"], w["lm"]["obs_kf"], w["lm"]["obs_valid"], px)
    for k in ("pos", "normal", "min_dist", "max_dist"):
        g["lm"][k], w["lm"][k] = g["lm"][k][close], w["lm"][k][close]
    assert_tree_close(g, w, atol=ATOL, rtol=1e-5)


def ba_to_torch(p) -> ba.BAProblem:
    d = jax.tree.map(np.asarray, p)
    return ba.BAProblem(
        kf_Tcw=torch.from_numpy(np.array(d.kf_Tcw)), kf_fixed=torch.from_numpy(np.array(d.kf_fixed)),
        cams=ba.CamArrays(*(torch.from_numpy(np.array(a, np.float32)) for a in d.cams)),
        lm_pos=torch.from_numpy(np.array(d.lm_pos)), lm_valid=torch.from_numpy(np.array(d.lm_valid)),
        obs=ba.BAObservations(*(torch.from_numpy(np.array(a)) for a in d.obs)))


def assert_ba_close(got, want, prob):
    """Poses within 1e-4, points as assert_points_close, inlier masks
    equal, costs within 1e-4 relative."""
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(want.kf_Tcw), atol=ATOL)
    assert_points_close(got.lm_pos.numpy(), np.asarray(want.lm_pos), got.kf_Tcw.numpy(),
                        np.asarray(want.kf_Tcw), np.asarray(prob.obs.kf),
                        np.asarray(prob.obs.valid), PX_BA)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(want.obs_inlier))
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-4)


def _corrupted(rng, prob):
    uv = np.array(prob.obs.uv)
    flat = np.nonzero(np.asarray(prob.obs.valid).reshape(-1))[0]
    bad = rng.choice(flat, max(1, len(flat) // 20), replace=False)
    uv.reshape(-1, 2)[bad] += 60.0
    return prob._replace(obs=prob.obs._replace(uv=jnp.asarray(uv)))


BA_CASES = {   # name -> (problem builder, runs with the solver's keywords)
    "reduces_to_truth": (lambda rng: test_solver.build_ba_problem(rng)[0],
                         [dict(n_iters=12, chunk=64)]),
    "cost_decreases": (lambda rng: test_solver.build_ba_problem(rng)[0],
                       [dict(n_iters=1, chunk=64), dict(n_iters=8, chunk=64)]),
    "fixed_kfs_unmoved": (lambda rng: test_solver.build_ba_problem(rng)[0],
                          [dict(n_iters=8, chunk=64)]),
    "two_phase_rejects_outlier_obs": (
        lambda rng: _corrupted(rng, test_solver.build_ba_problem(rng)[0]), [None]),
    "chunk_invariance": (lambda rng: test_solver.build_ba_problem(rng, n_lm=100)[0],
                         [dict(n_iters=3, chunk=32), dict(n_iters=3, chunk=100)]),
}


@pytest.mark.parametrize("name", list(BA_CASES))
def test_bundle_adjustment_matches_jax(name, rng):
    build, runs = BA_CASES[name]
    prob = build(rng)
    tprob = ba_to_torch(prob)
    for kw in runs:
        if kw is None:
            want = j_ba.local_ba_two_phase(prob, chunk=64)
            got = ba.local_ba_two_phase(tprob, chunk=64)
        else:
            want = j_ba.bundle_adjustment(prob, **kw)
            got = ba.bundle_adjustment(tprob, **kw)
        assert_ba_close(got, want, prob)
    np.testing.assert_array_equal(got.kf_Tcw[:2].numpy(), tprob.kf_Tcw[:2].numpy())


def test_singular_reduced_system_gives_a_zero_step():
    """A reduced system that is not positive definite: cholesky_ex reports
    it through info, and the pose step is zero, as the JAX package's NaN -> 0
    gives it."""
    K = 3
    Hpp = torch.zeros(K, 6, 6)
    Hpp[:, range(6), range(6)] = 1.0
    S_red = torch.eye(6 * K) * 5.0          # S = Hpp_d - S_red is indefinite
    delta = ba._solve_poses(Hpp, torch.ones(K, 6), S_red, torch.zeros(K, 6),
                            torch.zeros(K, dtype=torch.bool), torch.tensor(1e-4))
    want = j_ba._solve_poses(jnp.asarray(Hpp.numpy()), jnp.ones((K, 6)),
                             jnp.asarray(S_red.numpy()), jnp.zeros((K, 6)),
                             jnp.zeros(K, bool), 1e-4)
    np.testing.assert_array_equal(delta.numpy(), np.zeros((K, 6), np.float32))
    np.testing.assert_array_equal(np.asarray(want), np.zeros((K, 6), np.float32))


# ---------------------------------------------------------------------------
# mapper jobs on a JAX-built state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mapper_input():
    """The (map state, keyframe id) of the JAX tracker's 4th mapper call
    over tests/test_tracking.py:run_sequence (frame 4), in both packages."""
    rng = np.random.default_rng(0)
    pts = make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    delta = np.asarray(j_se3.exp(jnp.asarray([0, 0.004, 0, 0, 0, -0.12], jnp.float32)))
    tr = JTracker(cam=DEFAULT_CAM, caps=JMapCaps(K=64, L=8192, F=512, O=8),
                  policy=JPolicy(max_kf_interval=10))
    calls = []
    integrate = tr.mapper.integrate_keyframe

    def spy(ms, kf_id, **kw):
        calls.append((ms, int(kf_id)))
        return integrate(ms, kf_id, **kw)

    tr.mapper.integrate_keyframe = spy
    T = np.eye(4, dtype=np.float32)
    for i in range(5):
        tr.track(synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=512)[0],
                 timestamp=0.1 * i, frame_id=i)
        T = (delta @ T).astype(np.float32)
    ms_j, kf_id = calls[3]
    return ms_j, ms_to_torch(ms_j), kf_id


def _core(ms_j, ms_t, kf_id):
    """Both packages' mandatory + optional jobs (the state local BA sees)."""
    p_j, p_t = j_mapper.MapperParams(), mapper.MapperParams()
    out_j = j_mapper._integrate_core(ms_j, kf_id, p_j, DEFAULT_CAM, False, True)
    out_t = mapper._integrate_core(ms_t, kf_id, p_t, CAM, False, True)
    return out_j, out_t


JOBS = {
    "cull_landmarks": lambda M, ms, k, cam, p: (M.cull_landmarks(ms, k, p), ()),
    "triangulate_new_landmarks": lambda M, ms, k, cam, p: M.triangulate_new_landmarks(
        M.cull_landmarks(ms, k, p), k, cam, p),
    "fuse_landmarks": lambda M, ms, k, cam, p: (
        lambda r: (r[0], r[1:]))(M.fuse_landmarks(ms, k, cam, p)),
    "cull_keyframes": lambda M, ms, k, cam, p: M.cull_keyframes(ms, k, cam, p),
    "kf_redundancy": lambda M, ms, k, cam, p: (ms, M._kf_redundancy(ms, cam, p)),
}


def _refreshed(pkg, ms):
    """The mandatory refreshes every job runs after (covisibility, spanning
    tree, landmark statistics), in the package's own code."""
    S = pkg.M
    return S.update_landmark_stats(S.compute_spanning_parents(S.refresh_covisibility(ms)))


@pytest.mark.parametrize("job", list(JOBS))
def test_mapper_job_matches_jax(mapper_input, job):
    ms_j, ms_t, kf_id = mapper_input
    out_j = JOBS[job](j_mapper, _refreshed(j_mapper, ms_j), kf_id, DEFAULT_CAM,
                      j_mapper.MapperParams())
    out_t = JOBS[job](mapper, _refreshed(mapper, ms_t), kf_id, CAM, mapper.MapperParams())
    assert_map_close(out_t[0], out_j[0], PX_DLT)
    assert_tree_close(tree_np(out_t[1]), tree_np(out_j[1]), atol=ATOL)


def test_integrate_core_matches_jax(mapper_input):
    ms_j, ms_t, kf_id = mapper_input
    (m_j, c_j), (m_t, c_t) = _core(ms_j, ms_t, kf_id)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    assert int(c_t[0]) > 0
    assert_map_close(m_t, m_j, PX_DLT)


def test_local_ba_matches_jax(mapper_input):
    """The whole local-BA job (gather, two-phase BA, scatter, outlier
    erasure, stats) from the state the JAX package's mandatory and optional
    jobs leave, in both packages."""
    ms_j, ms_t, kf_id = mapper_input
    (m_j, _), _ = _core(ms_j, ms_t, kf_id)
    m_t = ms_to_torch(m_j)
    prob_j = j_mapper._gather_local_ba(m_j, kf_id, DEFAULT_CAM, 16, 2048)
    prob_t = mapper._gather_local_ba(m_t, kf_id, CAM, 16, 2048)
    assert_tree_close(tree_np(prob_t), tree_np(prob_j), atol=ATOL)
    out_j, cost_j = j_mapper._local_ba_noprior(m_j, kf_id, DEFAULT_CAM, 16, 2048, 8, 1.2)
    out_t, cost_t = mapper._local_ba_noprior(m_t, kf_id, CAM, 16, 2048, 8, 1.2)
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-4)
    assert_map_close(out_t, out_j, PX_BA)


def test_integrate_keyframe_matches_jax(mapper_input):
    ms_j, ms_t, kf_id = mapper_input
    mj, mt = j_mapper.Mapper(DEFAULT_CAM), mapper.Mapper(CAM)
    mj.kf_count = mt.kf_count = 3
    out_j, st_j = mj.integrate_keyframe(ms_j, kf_id)
    out_t, st_t = mt.integrate_keyframe(ms_t, kf_id)
    assert set(st_t) == set(st_j)
    assert {k: v for k, v in st_t.items() if k != "ba_cost"} == \
        {k: v for k, v in st_j.items() if k != "ba_cost"}
    np.testing.assert_allclose(st_t["ba_cost"], st_j["ba_cost"], rtol=1e-4)
    assert_map_close(out_t, out_j, PX_DLT)
