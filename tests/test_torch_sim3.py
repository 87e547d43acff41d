"""The port's Sim(3) group (``hyslam_tpu_torch/geometry/sim3.py``), Sim3
RANSAC (``estimators/sim3_solver.py``) and refinement (``solver/
sim3_opt.py``), and the written-out Jacobians of the refinement and of the
essential graph (``solver/pose_graph.py``), against the JAX package's on the
CPU, fed the same inputs and the JAX package's RANSAC draws.

Bounds: the group operations within 1e-5 relative (plus 1e-6 absolute for
entries near zero), on random tangents and on tangents with |sigma| and
theta near 0; RANSAC the same inlier mask and g within 1e-4; the refinement
g within 1e-4 and inlier counts within 1; the Jacobians within 1e-5
relative to their largest entry (plus 2e-6 absolute), at a random state and
at zero residual. The scenes are tests/test_loopparts.py's: a known Sim3
with 20% mismatches, a fixed scale, 512 padded slots with 30 valid pairs
and 40% of them mismatched, a perturbed start with pixel noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.estimators.sim3_solver import sim3_ransac as j_ransac
from hyslam_tpu.geometry import sim3 as jsim3
from hyslam_tpu.geometry import so3 as jso3
from hyslam_tpu.geometry.camera import project as jproject
from hyslam_tpu.solver import pose_graph as jpg
from hyslam_tpu.solver.sim3_opt import optimize_sim3 as j_opt
from hyslam_tpu_torch.estimators import sim3_solver
from hyslam_tpu_torch.geometry import sim3
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.solver import pose_graph, sim3_opt

from helpers import DEFAULT_CAM, make_world
from port_helpers import jax_sim3_samples, one_thread  # noqa: F401

CAM = camera_from(DEFAULT_CAM)
RTOL, ATOL = 1e-5, 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def tangents(seed=0, n=64):
    """Random tangents; rows 0-7 with |sigma| near 0, rows 8-15 with theta
    near 0, rows 16-19 both, rows 20-23 exactly zero."""
    xi = np.random.default_rng(seed).normal(0, 0.6, (n, 7)).astype(np.float32)
    xi[:8, 0] *= 1e-5
    xi[8:16, 1:4] *= 1e-5
    xi[16:20, :4] *= 1e-6
    xi[20:24] = 0.0
    return xi


def test_exp_log_compose_inverse_match_jax():
    xi = tangents()
    gj, gt = jax.jit(jsim3.exp)(jnp.asarray(xi)), sim3.exp(t(xi))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sim3.log(gt).numpy(), np.asarray(jsim3.log(gj)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sim3.log(gt).numpy(), xi, rtol=1e-4, atol=2e-6)
    a, b = gt[:32], gt[32:]
    np.testing.assert_allclose(sim3.compose(a, b).numpy(),
                               np.asarray(jsim3.compose(gj[:32], gj[32:])), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sim3.inverse(gt).numpy(), np.asarray(jsim3.inverse(gj)),
                               rtol=RTOL, atol=ATOL)
    T = np.asarray(jax.vmap(jsim3.to_se3_scaled)(gj))
    np.testing.assert_allclose(sim3.to_se3_scaled(gt).numpy(), T, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(sim3.from_se3(t(T)).numpy(),
                               np.asarray(jax.vmap(jsim3.from_se3)(jnp.asarray(T))),
                               rtol=RTOL, atol=ATOL)
    assert sim3.identity((2,)).tolist() == np.asarray(jsim3.identity((2,))).tolist()


# -- tests/test_loopparts.py's scenes ---------------------------------------

def scene_known(rng):
    """test_recovers_known_sim3: 100 points, s 1.3, 20 mismatches."""
    N = 100
    X1 = jnp.asarray(make_world(rng, N, extent=(4.0, 3.0, 10.0), z_min=3.0))
    g_true = jsim3.pack(jnp.asarray(1.3), jso3.exp(jnp.asarray([0.05, -0.1, 0.03])),
                        jnp.asarray([0.4, -0.2, 0.5]))
    X2 = jsim3.apply(jsim3.inverse(g_true), X1)
    uv1, _ = jproject(DEFAULT_CAM, X1)
    uv2, _ = jproject(DEFAULT_CAM, X2)
    bad = rng.choice(N, 20, replace=False)
    X2n = np.array(X2)
    X2n[bad] += rng.uniform(1, 3, (20, 3))
    return (X1, jnp.asarray(X2n), uv1, uv2, jnp.ones(N), jnp.ones(N),
            jnp.ones(N, bool)), 0, False


def scene_fixed(rng):
    """test_fix_scale: 60 points, s 1, no mismatch."""
    N = 60
    X1 = jnp.asarray(make_world(rng, N, extent=(4.0, 3.0, 10.0), z_min=3.0))
    g_true = jsim3.pack(jnp.asarray(1.0), jso3.exp(jnp.asarray([0.02, -0.04, 0.01])),
                        jnp.asarray([0.2, 0.1, -0.3]))
    X2 = jsim3.apply(jsim3.inverse(g_true), X1)
    uv1, _ = jproject(DEFAULT_CAM, X1)
    uv2, _ = jproject(DEFAULT_CAM, X2)
    return (X1, X2, uv1, uv2, jnp.ones(N), jnp.ones(N), jnp.ones(N, bool)), 1, True


def scene_padded(rng):
    """test_padded_sparse_matches: 512 slots, 30 valid pairs, 12 mismatched."""
    F, n_pairs, n_bad = 512, 30, 12
    X1 = jnp.asarray(make_world(rng, F, extent=(4.0, 3.0, 10.0), z_min=3.0))
    g_true = jsim3.pack(jnp.asarray(1.0), jso3.exp(jnp.asarray([0.02, -0.05, 0.01])),
                        jnp.asarray([0.35, 0.0, 0.35]))
    X2 = np.array(jsim3.apply(jsim3.inverse(g_true), X1))
    bad = rng.choice(n_pairs, n_bad, replace=False)
    X2[bad] = X2[rng.permutation(bad)] + rng.uniform(0.5, 1.5, (n_bad, 3))
    uv1, _ = jproject(DEFAULT_CAM, X1)
    uv2, _ = jproject(DEFAULT_CAM, jnp.asarray(X2))
    valid = np.zeros(F, bool)
    valid[:n_pairs] = True
    return (X1, jnp.asarray(X2), uv1, uv2, jnp.ones(F), jnp.ones(F),
            jnp.asarray(valid)), 3, True


SCENES = {"known": scene_known, "fixed": scene_fixed, "padded": scene_padded}


@pytest.mark.parametrize("name", list(SCENES))
def test_sim3_ransac_and_refinement_match_jax(name):
    args, seed, fix = SCENES[name](np.random.default_rng(0))
    g_j, inl_j, n_j = j_ransac(DEFAULT_CAM, DEFAULT_CAM, *args, jax.random.PRNGKey(seed),
                               fix_scale=fix)
    targs = tuple(t(a) for a in args)
    idx = jax_sim3_samples(args[-1], seed)
    g_t, inl_t, n_t = sim3_solver.sim3_ransac(CAM, CAM, *targs, idx, fix_scale=fix)
    assert inl_t.tolist() == np.asarray(inl_j).tolist() and int(n_t) == int(n_j)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)
    assert int(n_t) >= 15

    g2_j, inl2_j, n2_j = j_opt(DEFAULT_CAM, DEFAULT_CAM, g_j, *args, fix_scale=fix,
                               seed_inliers=inl_j)
    g2_t, inl2_t, n2_t = sim3_opt.optimize_sim3(CAM, CAM, g_t, *targs, fix_scale=fix,
                                                seed_inliers=inl_t)
    np.testing.assert_allclose(g2_t.numpy(), np.asarray(g2_j), atol=1e-4)
    assert abs(int(n2_t) - int(n2_j)) <= 1
    assert int((inl2_t.numpy() != np.asarray(inl2_j)).sum()) <= 1


@pytest.mark.parametrize("fix", [False, True])
def test_optimize_sim3_from_a_perturbed_start_matches_jax(fix):
    """test_refines_perturbed: 80 points with 0.3 px noise, the start
    perturbed by a Sim3 tangent; scale free and fixed."""
    rng = np.random.default_rng(0)
    N = 80
    X1 = jnp.asarray(make_world(rng, N, extent=(4.0, 3.0, 10.0), z_min=3.0))
    g_true = jsim3.pack(jnp.asarray(0.8), jso3.exp(jnp.asarray([0.03, 0.06, -0.02])),
                        jnp.asarray([0.3, -0.1, 0.2]))
    X2 = jsim3.apply(jsim3.inverse(g_true), X1)
    uv1, _ = jproject(DEFAULT_CAM, X1)
    uv2, _ = jproject(DEFAULT_CAM, X2)
    uv1 = uv1 + jnp.asarray(rng.normal(0, 0.3, (N, 2)).astype(np.float32))
    g0 = jsim3.compose(jsim3.exp(jnp.asarray([0.02, 0.01, -0.01, 0.01, 0.05, -0.03, 0.02])),
                       g_true)
    args = (X1, X2, uv1, uv2, jnp.ones(N), jnp.ones(N), jnp.ones(N, bool))
    g_j, _, n_j = j_opt(DEFAULT_CAM, DEFAULT_CAM, g0, *args, fix_scale=fix)
    g_t, _, n_t = sim3_opt.optimize_sim3(CAM, CAM, t(g0), *(t(a) for a in args),
                                         fix_scale=fix)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), atol=1e-4)
    assert abs(int(n_t) - int(n_j)) <= 1
    if not fix:
        assert int(n_t) > 70


def _close(got, want):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale + 2e-6)


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("at_zero", [False, True])
def test_sim3_opt_jacobians_match_jacfwd(fix, at_zero):
    """The refinement's [N, 2, 7] Jacobians against jax.jacfwd through
    sim3.exp, at a random g and at the g that makes the residuals zero."""
    rng = np.random.default_rng(5)
    N = 40
    X1 = make_world(rng, N, extent=(4.0, 3.0, 10.0), z_min=3.0)
    g = jsim3.exp(jnp.asarray(rng.normal(0, 0.2, 7).astype(np.float32)))
    X2 = np.asarray(jsim3.apply(jsim3.inverse(g), jnp.asarray(X1)))
    if not at_zero:
        X2 = X2 + rng.normal(0, 0.05, X2.shape).astype(np.float32)
    uv1, _ = jproject(DEFAULT_CAM, jnp.asarray(X1))
    uv2, _ = jproject(DEFAULT_CAM, jnp.asarray(X2))
    cam = DEFAULT_CAM

    def res(xi):
        if fix:
            xi = xi.at[0].set(0.0)
        gg = jsim3.compose(jsim3.exp(xi), g)
        p1 = jsim3.apply(gg, jnp.asarray(X2))
        p2 = jsim3.apply(jsim3.inverse(gg), jnp.asarray(X1))
        z1, z2 = jnp.maximum(p1[:, 2], 1e-6), jnp.maximum(p2[:, 2], 1e-6)
        r1 = jnp.stack([cam.fx * p1[:, 0] / z1 + cam.cx, cam.fy * p1[:, 1] / z1 + cam.cy],
                       -1) - uv1
        r2 = jnp.stack([cam.fx * p2[:, 0] / z2 + cam.cx, cam.fy * p2[:, 1] / z2 + cam.cy],
                       -1) - uv2
        return r1, r2

    Jj1, Jj2 = jax.jit(jax.jacfwd(res))(jnp.zeros(7))
    J1, J2 = sim3_opt.jacobians(CAM, CAM, t(g), t(X1), t(X2), fix_scale=fix)
    _close(J1.numpy(), np.asarray(Jj1))
    _close(J2.numpy(), np.asarray(Jj2))
    r1, r2 = sim3_opt.residuals(CAM, CAM, t(g), t(X1), t(X2), t(uv1), t(uv2))
    rj1, rj2 = res(jnp.zeros(7))
    np.testing.assert_allclose(r1.numpy(), np.asarray(rj1), atol=2e-3)
    np.testing.assert_allclose(r2.numpy(), np.asarray(rj2), atol=2e-3)


@pytest.mark.parametrize("fix", [False, True])
@pytest.mark.parametrize("at_zero", [False, True])
def test_pose_graph_jacobians_match_jacfwd(fix, at_zero):
    """The essential graph's [E, 7, 14] edge Jacobians (Jl^-1 Ad, written
    out) against jax.jacfwd through the edge residual."""
    rng = np.random.default_rng(6)
    E = 24

    def draw(s):
        return jsim3.exp(jnp.asarray(rng.normal(0, s, (E, 7)).astype(np.float32)))

    gi, gj = draw(0.4), draw(0.4)
    meas = (jsim3.compose(gj, jsim3.inverse(gi)) if at_zero else
            jsim3.compose(draw(0.15), jsim3.compose(gj, jsim3.inverse(gi))))

    def res(xi2, a, b, m):
        di, dj = xi2[:7], xi2[7:]
        if fix:
            di, dj = di.at[0].set(0.0), dj.at[0].set(0.0)
        return jpg._edge_residual(jsim3.compose(jsim3.exp(di), a),
                                  jsim3.compose(jsim3.exp(dj), b), m)

    Jj = jax.jit(jax.vmap(lambda a, b, m: jax.jacfwd(res)(jnp.zeros(14), a, b, m)))(gi, gj, meas)
    r, J = pose_graph.edge_jacobians(t(gi), t(gj), t(meas), fix_scale=fix)
    _close(J.numpy(), np.asarray(Jj))
    rj = jax.vmap(jpg._edge_residual)(gi, gj, meas)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=RTOL, atol=2e-6)
