"""The PyTorch port's per-frame stereo front end against the JAX package's,
on the CPU at the small sizes of tests/test_frontend.py: a local map seeded
from frame 0's stereo features, then frame 1 tracked from the frame-0 pose
by both ``track_stereo_frame`` functions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.features.atlas import extract_atlas_batch as j_extract_atlas_batch
from hyslam_tpu.ops.stereo import match_stereo_refined as j_match_stereo_refined
from hyslam_tpu.slam import frontend as j_frontend
from hyslam_tpu_torch.core.frame import feature_inv_sigma2
from hyslam_tpu_torch.slam import frontend

from helpers import pose_error
from port_helpers import (
    CFG, F_CAP, J_CFG, J_SMALL_CAM, SMALL_CAM, feats_to_torch, map_args_jax,
    map_args_torch, seeded_map, small_world, stereo_pair,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tracked():
    """Map from frame 0 (JAX features), and frame 1 (0.1 m forward, a
    little yaw) tracked by the JAX package and by the port."""
    pts = small_world()
    p0 = stereo_pair(np.eye(4, dtype=np.float32), pts)
    f2 = j_extract_atlas_batch(jnp.asarray(p0), J_CFG, capacity=F_CAP)
    f0 = j_match_stereo_refined(
        jax.tree.map(lambda x: x[0], f2), jax.tree.map(lambda x: x[1], f2),
        jnp.asarray(p0[0]), jnp.asarray(p0[1]), bf=SMALL_CAM.bf)
    table = seeded_map(jax.tree.map(np.asarray, f0)._asdict())

    c, s = np.cos(0.01), np.sin(0.01)
    T1 = np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, -0.1], [0, 0, 0, 1]],
                  np.float32)
    p1 = stereo_pair(T1, pts)
    res_j, fl_j = j_frontend.track_stereo_frame(
        J_SMALL_CAM, J_CFG, F_CAP, jnp.asarray(p1), jnp.eye(4),
        *map_args_jax(table))
    res_t, fl_t = frontend.track_stereo_frame(
        SMALL_CAM, CFG, F_CAP, torch.from_numpy(p1), torch.eye(4),
        *map_args_torch(table))
    return table, T1, p1, (res_j, fl_j), (res_t, fl_t)


def test_track_stereo_frame_matches_jax(tracked):
    """Tcw within 1e-4 of the JAX pose; match and inlier counts within 2%
    (keypoints and bits may differ at the ~1e-3 level, tests/test_torch_ops)."""
    _, T1, _, (res_j, _), (res_t, _) = tracked
    np.testing.assert_allclose(res_t.Tcw.numpy(), np.asarray(res_j.Tcw), atol=1e-4)
    for a, b in ((res_t.n_matches, res_j.n_matches),
                 (res_t.n_inliers, res_j.n_inliers)):
        assert abs(int(a) - int(b)) <= 0.02 * int(b)
    assert int(res_t.n_inliers) > 50
    rot, t = pose_error(res_t.Tcw.numpy(), T1)
    assert rot < 0.5 and t < 0.05, (rot, t)


def test_project_and_optimize_matches_jax(tracked):
    """The match + LM pair alone, on the JAX package's own stereo features
    (and the default 8-level scale model): the same match count, inliers
    within 2%, Tcw within 1e-4."""
    table, _, _, (_, fl_j), _ = tracked
    inv_j = j_frontend.feature_inv_sigma2(fl_j.level, J_CFG.n_levels,
                                          J_CFG.scale_factor)
    ref = j_frontend.project_and_optimize(
        J_SMALL_CAM, fl_j, jnp.eye(4), *map_args_jax(table), inv_j)
    fl = feats_to_torch(fl_j)
    out = frontend.project_and_optimize(
        SMALL_CAM, fl, torch.eye(4), *map_args_torch(table),
        feature_inv_sigma2(fl.level, CFG.n_levels, CFG.scale_factor))
    assert int(out.n_matches) == int(ref.n_matches)
    assert abs(int(out.n_inliers) - int(ref.n_inliers)) <= 0.02 * int(ref.n_inliers)
    np.testing.assert_allclose(out.Tcw.numpy(), np.asarray(ref.Tcw), atol=1e-4)
    lm = out.lm_id.numpy()
    assert ((lm >= -1) & (lm < table["lm_pos"].shape[0])).all()
