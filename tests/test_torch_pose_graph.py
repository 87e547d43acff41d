"""The port's essential-graph solver (``hyslam_tpu_torch/solver/
pose_graph.py``) against the JAX package's on the CPU, on
tests/test_pose_graph_scale.py's drifting circle (a chain of odometry edges
and one loop edge, the first pose fixed).

Bounds: the dense solve at K = 96 gives the JAX package's poses within 1e-4
(entry by entry of the packed Sim3s), with free and with fixed scale; at
K = 512, where ``auto`` takes CG, the port's CG within 1e-3 of the JAX
package's CG and of its own dense solve, over 4 LM iterations (a CG solve
stops at ||r|| <= 1e-6 ||b|| or 4K iterations; the port's reads its
stopping test every ``CG_CHECK_EVERY`` iterations)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.solver.pose_graph import optimize_pose_graph as j_optimize
from hyslam_tpu_torch.solver import pose_graph

from port_helpers import one_thread  # noqa: F401
from test_pose_graph_scale import center_err, drifting_circle


def _torch(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("fix_scale", [True, False])
def test_dense_matches_jax_at_k96(fix_scale):
    g0, ggt, fixed, ei, ej, meas = drifting_circle(96, drift=0.002)
    valid = jnp.ones(len(ei), bool)
    want = j_optimize(g0, fixed, ei, ej, meas, valid, solver="dense", fix_scale=fix_scale)
    got = pose_graph.optimize_pose_graph(*_torch(g0, fixed, ei, ej, meas, valid),
                                         solver="dense", fix_scale=fix_scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
    assert center_err(jnp.asarray(got.numpy()), ggt) < 0.02


def test_cg_matches_jax_cg_and_dense_at_k512():
    K, n_iters = 512, 4
    g0, ggt, fixed, ei, ej, meas = drifting_circle(K, drift=0.0005)
    valid = jnp.ones(len(ei), bool)
    want = np.asarray(j_optimize(g0, fixed, ei, ej, meas, valid, n_iters=n_iters,
                                 fix_scale=True, solver="auto"))
    args = _torch(g0, fixed, ei, ej, meas, valid)
    cg = pose_graph.optimize_pose_graph(*args, n_iters=n_iters, fix_scale=True, solver="auto")
    dense = pose_graph.optimize_pose_graph(*args, n_iters=n_iters, fix_scale=True,
                                           solver="dense")
    np.testing.assert_allclose(cg.numpy(), want, rtol=0, atol=1e-3)
    np.testing.assert_allclose(cg.numpy(), dense.numpy(), rtol=0, atol=1e-3)
    assert center_err(jnp.asarray(cg.numpy()), ggt) < center_err(g0, ggt)
