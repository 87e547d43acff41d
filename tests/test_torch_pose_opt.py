"""The PyTorch port's pose solver against the JAX package: the plain
``pose_optimization`` in torch is held against JAX ``pose_optimization``
and against ``pose_optimization_pallas`` (interpret mode on the CPU), on the
three problems of tests/test_pose_opt_pallas.py and with its bounds. The
one-evaluation schedule of the CUDA kernel, in its plain form
(``pose_optimization_fused_schedule``), is held against the two-pass
schedule step by step, and against the same JAX references."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.ops.pose_opt_pallas import pose_optimization_pallas
from hyslam_tpu.solver import residuals as j_residuals
from hyslam_tpu.solver.pose_opt import pose_optimization as j_pose_optimization
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.solver import residuals
from hyslam_tpu_torch.solver import pose_opt
from hyslam_tpu_torch.solver.pose_opt import (
    pose_optimization,
    pose_optimization_fast,
    pose_optimization_fused_schedule,
)

from helpers import DEFAULT_CAM, perturb_pose, pose_error
from test_pose_opt_pallas import problem

torch.set_num_threads(2)

CAM = Camera(**DEFAULT_CAM._asdict())

# (outlier_frac, stereo_frac, rotation bound deg, translation bound) of the
# three tests of tests/test_pose_opt_pallas.py
CASES = {
    "stereo": (0.0, 1.0, 0.1, 0.01),
    "outliers": (0.25, 1.0, 0.2, 0.02),
    "mono": (0.0, 0.0, 0.2, 0.05),
}


# a fourth problem for the schedules: outliers, half the rows stereo, and a
# start 0.4 rad and 1.5 m off, far enough that steps are rejected on the way
FAR = (0.25, 0.5, 0.2, 0.02)
FAR_START = dict(rot=0.4, trans=1.5)
SCHEDULE_CASES = [*CASES, "far_start"]


def _inputs(case):
    outlier_frac, stereo_frac, _, _ = FAR if case == "far_start" else CASES[case]
    rng = np.random.default_rng(0)
    _, T_true, T0, pts, uv, ur, vis, stereo, out_idx = problem(
        rng, outlier_frac=outlier_frac, stereo_frac=stereo_frac)
    if case == "far_start":
        T0 = perturb_pose(np.random.default_rng(5), T_true, **FAR_START)
    args = (T0, pts, uv, ur, np.ones(len(pts), np.float32), vis, stereo & vis)
    return T_true, args, out_idx


@pytest.mark.parametrize("case", list(CASES))
def test_plain_solver_matches_jax_and_pallas(case):
    """Against the truth: the case's bounds. Against JAX pose_optimization
    and the Pallas kernel: d_rot < 0.05 deg, d_t < 0.01 and at most 10
    inliers apart (float32 reductions in another order)."""
    _, _, rot_bound, t_bound = CASES[case]
    T_true, args, out_idx = _inputs(case)
    res = pose_optimization(CAM, *(torch.from_numpy(np.array(a)) for a in args))
    T = res.Tcw.numpy()
    rot_err, t_err = pose_error(T, T_true)
    assert rot_err < rot_bound and t_err < t_bound, (rot_err, t_err)

    jargs = tuple(jnp.asarray(a) for a in args)
    ref = j_pose_optimization(DEFAULT_CAM, *jargs)
    Tk, _, ninl_k = pose_optimization_pallas(DEFAULT_CAM, *jargs)
    for T_ref, n_ref in ((ref.Tcw, ref.num_inliers), (Tk, ninl_k)):
        d_rot, d_t = pose_error(T, np.asarray(T_ref))
        assert d_rot < 0.05 and d_t < 0.01, (d_rot, d_t)
        assert abs(int(res.num_inliers) - int(n_ref)) <= 10
    if case == "outliers":
        inl = res.inliers.numpy()
        vis = args[5]
        assert (~inl[out_idx] | ~vis[out_idx]).mean() > 0.95
    np.testing.assert_allclose(res.chi2.numpy()[args[5]],
                               np.asarray(ref.chi2)[args[5]], rtol=0.05, atol=0.05)


def test_fast_on_cpu_is_the_plain_version():
    T_true, args, _ = _inputs("stereo")
    targs = [torch.from_numpy(np.array(a)) for a in args]
    a = pose_optimization(CAM, *targs)
    b = pose_optimization_fast(CAM, *targs)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_fused_schedule_takes_the_two_pass_steps(case):
    """The one-evaluation schedule accepts and rejects the steps the
    two-pass schedule does, in the same order, and lands on its pose
    (within 1e-6: the same operations on the CPU) with the same inlier
    mask; against the truth it meets the case's bounds, against JAX
    pose_optimization and the Pallas kernel the bounds of
    test_plain_solver_matches_jax_and_pallas."""
    _, _, rot_bound, t_bound = FAR if case == "far_start" else CASES[case]
    T_true, args, _ = _inputs(case)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    plain = pose_optimization(CAM, *targs)
    # the two-pass schedule with its steps recorded is pose_optimization
    # bit for bit, so these are the steps pose_optimization took
    recorded, two_pass = pose_optimization_fused_schedule(CAM, *targs, reuse_sums=False)
    for x, y in zip(recorded, plain):
        assert torch.equal(x, y)
    res, accepts = pose_optimization_fused_schedule(CAM, *targs)
    assert accepts.shape == (40,) and accepts.dtype == torch.bool
    assert accepts.tolist() == two_pass.tolist()
    assert accepts.any() and not accepts.all()
    if case == "far_start":      # rejected before the first round has converged
        assert not accepts[:10].all()
    np.testing.assert_allclose(res.Tcw.numpy(), plain.Tcw.numpy(), atol=1e-6)
    assert torch.equal(res.inliers, plain.inliers)
    assert int(res.num_inliers) == int(plain.num_inliers)
    assert res.num_inliers.dtype == torch.int32 and res.chi2.shape == plain.chi2.shape

    T = res.Tcw.numpy()
    rot_err, t_err = pose_error(T, T_true)
    assert rot_err < rot_bound and t_err < t_bound, (rot_err, t_err)
    jargs = tuple(jnp.asarray(a) for a in args)
    ref = j_pose_optimization(DEFAULT_CAM, *jargs)
    Tk, _, ninl_k = pose_optimization_pallas(DEFAULT_CAM, *jargs)
    for T_ref, n_ref in ((ref.Tcw, ref.num_inliers), (Tk, ninl_k)):
        d_rot, d_t = pose_error(T, np.asarray(T_ref))
        assert d_rot < 0.05 and d_t < 0.01, (d_rot, d_t)
        assert abs(int(res.num_inliers) - int(n_ref)) <= 10


@pytest.mark.parametrize("schedule", ["two_pass", "fused"])
@pytest.mark.parametrize("case", SCHEDULE_CASES)
def test_result_chi2_is_the_final_chi2(case, schedule):
    """PoseOptResult.chi2 of the CPU path is _final_chi2 at the result's
    pose, bit for bit: what the kernel's fourth output is held against on
    the card."""
    _, args, _ = _inputs(case)
    targs = [torch.from_numpy(np.array(a)) for a in args]
    res = (pose_optimization_fast(CAM, *targs) if schedule == "two_pass"
           else pose_optimization_fused_schedule(CAM, *targs)[0])
    _, X, uv, ur, inv_s2, _, stereo = targs
    want = pose_opt._final_chi2(CAM, res.Tcw, X, uv, ur, inv_s2, stereo)
    assert torch.equal(res.chi2, want)
    assert torch.equal(res.inliers, targs[5] & (res.chi2 <= torch.where(
        stereo, 7.815, 5.991)))


def test_fused_schedule_with_no_iterations_classifies_the_start():
    _, args, _ = _inputs("stereo")
    targs = [torch.from_numpy(np.array(a)) for a in args]
    res, accepts = pose_optimization_fused_schedule(CAM, *targs, n_rounds=0)
    ref = pose_optimization(CAM, *targs, n_rounds=0)
    assert accepts.shape == (0,) and torch.equal(res.Tcw, targs[0])
    assert torch.equal(res.inliers, ref.inliers) and torch.equal(res.chi2, ref.chi2)


def test_residuals_and_jacobians_match_jax():
    """Residuals within 1e-3 px and Jacobians within 1e-3 relative
    (float32, the same formulas)."""
    rng = np.random.default_rng(6)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.1, -0.2, 0.3]
    X = np.stack([rng.uniform(-3, 3, 64), rng.uniform(-2, 2, 64),
                  rng.uniform(2, 12, 64)], -1).astype(np.float32)
    uv = rng.uniform(0, 600, (64, 2)).astype(np.float32)
    ur = (uv[:, 0] - 20).astype(np.float32)
    st = rng.uniform(size=64) < 0.6
    pc = residuals.camera_point(torch.from_numpy(T), torch.from_numpy(X))
    pcj = j_residuals.camera_point(jnp.asarray(T), jnp.asarray(X))
    np.testing.assert_allclose(pc.numpy(), np.asarray(pcj), atol=1e-5)
    r = residuals.reproj_residual(CAM, pc, torch.from_numpy(uv),
                                  torch.from_numpy(ur), torch.from_numpy(st))
    rj = j_residuals.reproj_residual(DEFAULT_CAM, pcj, jnp.asarray(uv),
                                     jnp.asarray(ur), jnp.asarray(st))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-3)
    w = rng.uniform(0.3, 1.0, 64).astype(np.float32)
    np.testing.assert_allclose(
        residuals.chi2(r, torch.from_numpy(w), torch.from_numpy(st)).numpy(),
        np.asarray(j_residuals.chi2(rj, jnp.asarray(w), jnp.asarray(st))),
        rtol=1e-4, atol=1e-3)
    Jp, Jx = residuals.reproj_jacobians(CAM, torch.from_numpy(T), pc,
                                        torch.from_numpy(st))
    Jpj, Jxj = j_residuals.reproj_jacobians(DEFAULT_CAM, jnp.asarray(T), pcj,
                                            jnp.asarray(st))
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jpj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(Jx.numpy(), np.asarray(Jxj), rtol=1e-3, atol=1e-3)
