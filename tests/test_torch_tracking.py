"""The port's tracking pieces against the JAX package's, on the CPU: the
geometry the tracker adds (SO3/SE3 log, interpolation, DLT), the matchers on
the inputs of tests/test_matcher.py, the local map, the keyframe policy,
stereo initialization and close-point seeding, and the NORMAL-state frame on
the state of 8 JAX tracker frames (as tests/test_tracking.py:92-146)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.features import matcher as j_matcher
from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.geometry import so3 as j_so3
from hyslam_tpu.geometry import triangulation as j_tri
from hyslam_tpu.ops import hamming as j_hamming
from hyslam_tpu.slam import initializers as j_init
from hyslam_tpu.slam import keyframe_policy as j_policy
from hyslam_tpu.slam import localmap as j_localmap
from hyslam_tpu.slam import strategies as j_strat
from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
from hyslam_tpu.core.mapstate import empty_map_state as j_empty_map_state
from hyslam_tpu.core import trajectory as j_traj
from hyslam_tpu.slam.tracker import Tracker as JTracker
from hyslam_tpu_torch.core.mapstate import MapCaps, empty_map_state
from hyslam_tpu_torch.features import matcher
from hyslam_tpu_torch.geometry import se3, so3, triangulation
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.ops import hamming
from hyslam_tpu_torch.slam import initializers, keyframe_policy, localmap, strategies

from helpers import DEFAULT_CAM, make_world, perturb_pose, synth_frame_features
from port_helpers import (
    assert_tree_close, feats_to_torch, ms_to_torch, to_torch, traj_to_torch, tree_np)
from test_matcher import corrupt, frame_from, random_descs

torch.set_num_threads(2)
CAM = camera_from(DEFAULT_CAM)


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

def _rotations(rng, n=64):
    """Random rotations plus each of Shepperd's four branches (a half turn
    about x, y and z, the identity) and angles near pi."""
    xi = rng.normal(0, 1.0, (n, 3))
    xi[:4] = [[0, 0, 0], [np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi]]
    xi[4] = [3.1, 0.2, -0.1]
    return np.array(j_so3.exp(jnp.asarray(xi, jnp.float32)))   # writable copy


def test_so3_log_and_quaternion_match_jax(rng):
    R = _rotations(rng)
    np.testing.assert_allclose(so3.quat_from_mat(torch.from_numpy(R)).numpy(),
                               np.asarray(j_so3.quat_from_mat(jnp.asarray(R))), atol=1e-6)
    np.testing.assert_allclose(so3.log(torch.from_numpy(R)).numpy(),
                               np.asarray(j_so3.log(jnp.asarray(R))), atol=1e-5)
    w = rng.normal(0, 0.6, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(so3.left_jacobian_inv(torch.from_numpy(w)).numpy(),
                               np.asarray(j_so3.left_jacobian_inv(jnp.asarray(w))), atol=1e-6)


def test_se3_log_and_interpolate_match_jax(rng):
    xi = np.concatenate([rng.normal(0, 0.8, (32, 3)), rng.normal(0, 2.0, (32, 3))], -1)
    T = np.array(j_se3.exp(jnp.asarray(xi, jnp.float32)))   # writable copy
    np.testing.assert_allclose(se3.log(torch.from_numpy(T)).numpy(),
                               np.asarray(j_se3.log(jnp.asarray(T))), atol=1e-5)
    T0, T1, a = T[:16], T[16:], rng.uniform(0, 1, 16).astype(np.float32)
    np.testing.assert_allclose(
        se3.interpolate(torch.from_numpy(T0), torch.from_numpy(T1), torch.from_numpy(a)).numpy(),
        np.asarray(j_se3.interpolate(jnp.asarray(T0), jnp.asarray(T1), jnp.asarray(a))),
        atol=1e-5)


def test_triangulate_dlt_matches_jax(rng):
    pts = make_world(rng, 200, extent=(6.0, 4.0, 20.0), z_min=3.0)
    T2 = np.asarray(j_se3.exp(jnp.asarray([0.0, 0.02, 0.0, 0.4, 0.0, 0.0], jnp.float32)))
    K = DEFAULT_CAM.K()
    P1 = j_tri.projection_matrix(K, jnp.eye(4))
    P2 = j_tri.projection_matrix(K, jnp.asarray(T2))
    uv1 = np.asarray(P1[:, :3] @ pts.T).T
    uv2 = np.asarray(P2[:, :3] @ pts.T + P2[:, 3:]).T
    uv1 = (uv1[:, :2] / uv1[:, 2:]).astype(np.float32) + rng.normal(0, 0.3, (200, 2)).astype(np.float32)
    uv2 = (uv2[:, :2] / uv2[:, 2:]).astype(np.float32)
    want = np.asarray(j_tri.triangulate_dlt(jnp.broadcast_to(P1, (200, 3, 4)),
                                            jnp.broadcast_to(P2, (200, 3, 4)),
                                            jnp.asarray(uv1), jnp.asarray(uv2)))
    tP1 = triangulation.projection_matrix(CAM.K(), torch.eye(4))
    tP2 = triangulation.projection_matrix(CAM.K(), torch.from_numpy(T2))
    got = triangulation.triangulate_dlt(tP1.expand(200, 3, 4), tP2.expand(200, 3, 4),
                                        torch.from_numpy(uv1), torch.from_numpy(uv2)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tP2.numpy(), np.asarray(P2), atol=1e-4)


def test_hamming_pairwise_matches_jax(rng):
    a = rng.integers(0, 2**32, (50, 4, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (50, 1, 8), dtype=np.uint32)
    a[0, 0] = 0xFFFFFFFF
    np.testing.assert_array_equal(
        hamming.hamming_pairwise(to_torch(a), to_torch(b)).numpy(),
        np.asarray(j_hamming.hamming_pairwise(jnp.asarray(a), jnp.asarray(b))))


# ---------------------------------------------------------------------------
# matchers, on the inputs of tests/test_matcher.py
# ---------------------------------------------------------------------------

def test_match_descriptors_matches_jax(rng):
    d = random_descs(rng, 100)
    fa = frame_from(np.zeros((100, 2), np.float32), corrupt(rng, d, 3),
                    angle=rng.uniform(-0.2, 0.2, 100).astype(np.float32))
    fb = frame_from(np.zeros((100, 2), np.float32), corrupt(rng, d, 3)[rng.permutation(100)])
    want = j_matcher.match_descriptors(fa.desc, fa.valid, fa.angle, fb.desc, fb.valid, fb.angle)
    ta, tb = feats_to_torch(fa), feats_to_torch(fb)
    got = matcher.match_descriptors(ta.desc, ta.valid, ta.angle, tb.desc, tb.valid, tb.angle)
    assert_tree_close(tree_np(got), tree_np(want))
    assert int(got[1]) > 90


def test_rotation_consistency_matches_jax(rng):
    n = 200
    delta = np.full(n, 0.3, np.float32)
    bad = rng.choice(n, 30, replace=False)
    delta[bad] = rng.uniform(-6.0, 6.0, 30)
    delta[:3] = [0.0, -2 * np.pi, 2 * np.pi]     # both ends of the wrap
    matched = rng.uniform(size=n) < 0.9
    want = j_matcher.rotation_consistency(jnp.asarray(delta), jnp.asarray(matched))
    got = matcher.rotation_consistency(torch.from_numpy(delta), torch.from_numpy(matched))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _projection_setup(rng):
    pts = make_world(rng, 200, extent=(6.0, 4.0, 12.0), z_min=3.0)
    descs = random_descs(rng, 200)
    uv = np.asarray(j_se3.apply(jnp.eye(4), jnp.asarray(pts)))
    uv = uv[:, :2] / uv[:, 2:] * DEFAULT_CAM.fx + [DEFAULT_CAM.cx, DEFAULT_CAM.cy]
    vis = ((uv[:, 0] >= 5) & (uv[:, 0] < DEFAULT_CAM.width - 5)
           & (uv[:, 1] >= 5) & (uv[:, 1] < DEFAULT_CAM.height - 5))
    return pts, descs, uv.astype(np.float32), vis


def test_search_by_projection_frame_matches_jax(rng):
    pts, descs, uv, vis = _projection_setup(rng)
    T2 = perturb_pose(rng, np.eye(4, dtype=np.float32), rot=0.005, trans=0.05)
    uv2 = np.asarray(j_se3.apply(jnp.asarray(T2), jnp.asarray(pts)))
    uv2 = (uv2[:, :2] / uv2[:, 2:] * DEFAULT_CAM.fx + [DEFAULT_CAM.cx, DEFAULT_CAM.cy]
           ).astype(np.float32)
    vis2 = vis & (uv2 >= 0).all(-1) & (uv2 < [DEFAULT_CAM.width, DEFAULT_CAM.height]).all(-1)
    lv = rng.integers(0, 3, vis.sum()).astype(np.int32)
    last = frame_from(uv[vis], corrupt(rng, descs[vis], 3), level=lv, F=512)
    cur = frame_from(uv2[vis2], corrupt(rng, descs[vis2], 3),
                     level=rng.integers(0, 3, vis2.sum()).astype(np.int32),
                     angle=rng.normal(0, 0.05, vis2.sum()).astype(np.float32), F=512)
    last_lm_id = np.full(512, -1, np.int32)
    last_lm_id[:vis.sum()] = np.nonzero(vis)[0]
    last_pos = np.zeros((512, 3), np.float32)
    last_pos[:vis.sum()] = pts[vis]
    for th in (3.0, 7.0):
        want = j_matcher.search_by_projection_frame(
            DEFAULT_CAM, cur, jnp.asarray(T2), last, jnp.asarray(last_lm_id),
            jnp.asarray(last_pos), th=th)
        got = matcher.search_by_projection_frame(
            CAM, feats_to_torch(cur), torch.from_numpy(T2), feats_to_torch(last),
            torch.from_numpy(last_lm_id), torch.from_numpy(last_pos), th=th)
        assert_tree_close(tree_np(got), tree_np(want))
    assert int(got[1]) > 0.7 * vis2.sum()


def test_search_for_triangulation_matches_jax(rng):
    pts = make_world(rng, 150, extent=(6.0, 4.0, 12.0), z_min=3.0)
    descs = random_descs(rng, 150)
    T2 = np.asarray(j_se3.exp(jnp.asarray([0.0, 0.02, 0.0, 0.4, 0.0, 0.0], jnp.float32)))

    def proj(T):
        pc = np.asarray(j_se3.apply(jnp.asarray(T), jnp.asarray(pts)))
        return (pc[:, :2] / pc[:, 2:] * DEFAULT_CAM.fx + [DEFAULT_CAM.cx, DEFAULT_CAM.cy]
                ).astype(np.float32)

    uv1, uv2 = proj(np.eye(4)), proj(T2)
    vis = ((uv1 >= 0).all(-1) & (uv1 < [640, 480]).all(-1)
           & (uv2 >= 0).all(-1) & (uv2 < [640, 480]).all(-1))
    f1 = frame_from(uv1[vis], corrupt(rng, descs[vis], 3), F=256)
    f2 = frame_from(uv2[vis], corrupt(rng, descs[vis], 3), F=256)
    un = rng.uniform(size=256) < 0.9
    F12_j = j_matcher.fundamental_from_poses(DEFAULT_CAM, jnp.eye(4), DEFAULT_CAM, jnp.asarray(T2))
    F12_t = matcher.fundamental_from_poses(CAM, torch.eye(4), CAM, torch.from_numpy(T2))
    np.testing.assert_allclose(F12_t.numpy(), np.asarray(F12_j), rtol=1e-5, atol=1e-9)
    want = j_matcher.search_for_triangulation(DEFAULT_CAM, f1, f2, jnp.asarray(un),
                                              jnp.ones(256, bool), F12_j)
    got = matcher.search_for_triangulation(CAM, feats_to_torch(f1), feats_to_torch(f2),
                                           torch.from_numpy(un), torch.ones(256, dtype=torch.bool),
                                           F12_t)
    assert_tree_close(tree_np(got), tree_np(want))
    assert int(got[1]) > 0.7 * vis.sum()


# ---------------------------------------------------------------------------
# keyframe policy, stereo initialization, seeding
# ---------------------------------------------------------------------------

def test_need_new_keyframe_decides_as_jax():
    p_j, p_t = j_policy.KeyFramePolicyParams(max_kf_interval=10), \
        keyframe_policy.KeyFramePolicyParams(max_kf_interval=10)
    grid = itertools.product([40, 110, 130, 200], [5, 12], [60, 120], [50, 80],
                             [True, False], [0, 3], [True, False], [True, False])
    n = 0
    for inl, fid, tc, ntc, idle, qlen, force, stopped in grid:
        kw = dict(n_inliers=inl, frame_id=fid, last_kf_frame_id=2, n_kfs_in_map=4,
                  n_tracked_close=tc, n_nontracked_close=ntc, mapping_idle=idle,
                  mapping_queue_len=qlen, is_mono=False, force=force,
                  mapping_stopped=stopped)
        want = j_policy.need_new_keyframe(j_policy.KFDecisionInputs(**kw), p_j)
        assert keyframe_policy.need_new_keyframe(
            keyframe_policy.KFDecisionInputs(**kw), p_t) == want, kw
        n += want
    assert 0 < n < 512


def _frame0(seed=0, F=512):
    rng = np.random.default_rng(seed)
    pts = make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    return synth_frame_features(DEFAULT_CAM, np.eye(4, dtype=np.float32), pts, descs, rng, F=F)[0]


def test_stereo_initialize_and_seeding_match_jax():
    f = _frame0()
    caps = (16, 2048, 512, 8)
    ms_j, k_j, n_j = j_init.stereo_initialize(j_empty_map_state(JMapCaps(*caps)), f,
                                              DEFAULT_CAM, 0.0, 0)
    ms_t, k_t, n_t = initializers.stereo_initialize(empty_map_state(MapCaps(*caps)),
                                                    feats_to_torch(f), CAM, 0.0, 0)
    assert (k_t, n_t) == (k_j, n_j) and n_t > 300
    # floats within 1e-5, and within one float32 ulp (rtol 1e-6) for the
    # distance bounds of the far points (depth up to bf / 1e-3 = 45 km)
    assert_tree_close(tree_np(ms_t), tree_np(ms_j), atol=1e-5, rtol=1e-6)
    # a second keyframe from the same frame with half its features bound:
    # seeding covers the rest by depth
    assoc = np.where(np.arange(512) % 2 == 0, np.asarray(ms_j.kf.lm_id[0]), -1).astype(np.int32)
    from hyslam_tpu.core import mapstate as JM
    from hyslam_tpu_torch.core import mapstate as M
    T = np.asarray(j_se3.exp(jnp.asarray([0, 0, 0, 0.1, 0, -0.2], jnp.float32)))
    ms_j, _ = JM.add_keyframe(ms_j, f, jnp.asarray(T), 0.1, 1, 0, jnp.asarray(assoc))
    ms_t, _ = M.add_keyframe(ms_t, feats_to_torch(f), torch.from_numpy(T), 0.1, 1, 0,
                             torch.from_numpy(assoc))
    ms_j, s_j = j_policy.seed_close_landmarks(ms_j, 1, DEFAULT_CAM)
    ms_t, s_t = keyframe_policy.seed_close_landmarks(ms_t, 1, CAM)
    assert int(s_t) == int(s_j) > 0
    assert_tree_close(tree_np(ms_t), tree_np(ms_j), atol=1e-5, rtol=1e-6)


def test_stereo_initialize_refuses_without_depth():
    f = feats_to_torch(_frame0())
    f = f._replace(depth=torch.full_like(f.depth, -1.0))
    ms0 = empty_map_state(MapCaps(4, 64, 512, 4))
    ms, k, n = initializers.stereo_initialize(ms0, f, CAM, 0.0, 0)
    assert (k, n) == (-1, 0) and ms is ms0


# ---------------------------------------------------------------------------
# the NORMAL-state frame on a JAX tracker's state
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tracked8():
    """8 frames of tests/test_tracking.py:run_sequence in the JAX tracker,
    and a 9th frame continuing the motion."""
    from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams as JPolicy

    rng = np.random.default_rng(0)
    pts = make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    delta = np.asarray(j_se3.exp(jnp.asarray([0, 0.004, 0, 0, 0, -0.12], jnp.float32)))
    tr = JTracker(cam=DEFAULT_CAM, caps=JMapCaps(K=64, L=8192, F=512, O=8),
                  policy=JPolicy(max_kf_interval=10))
    T = np.eye(4, dtype=np.float32)
    for i in range(8):
        tr.track(synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=512)[0],
                 timestamp=0.1 * i, frame_id=i)
        T = (delta @ T).astype(np.float32)
    feats = synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=512)[0]
    return tr, feats, ms_to_torch(tr.ms)


def test_track_normal_frame_matches_jax(tracked8):
    tr, feats, ms = tracked8
    want = j_strat.track_normal_frame(
        DEFAULT_CAM, feats, 0.8, tr.traj, jnp.asarray(tr.last_Tcw), tr.last_feats,
        tr.last_lm_id, tr.ref_kf, tr.ms, jnp.asarray(30, jnp.int32))
    got = strategies.track_normal_frame(
        CAM, feats_to_torch(feats), 0.8, traj_to_torch(tr.traj),
        torch.from_numpy(np.asarray(tr.last_Tcw)), feats_to_torch(tr.last_feats),
        to_torch(tr.last_lm_id), tr.ref_kf, ms, 30)
    np.testing.assert_array_equal(got.lm_id.numpy(), np.asarray(want.lm_id))
    np.testing.assert_array_equal(got.scalars.numpy(), np.asarray(want.scalars))
    assert int(got.local_ref_kf) == int(want.local_ref_kf)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(want.Tcw), atol=1e-4)
    assert int(got.scalars[6]) == 1 and int(got.scalars[2]) > 200


def test_reference_keyframe_fallback_matches_jax(tracked8):
    """The fallback a failed motion model takes, from the last pose."""
    tr, feats, ms = tracked8
    want = j_strat.track_reference_keyframe(DEFAULT_CAM, feats, jnp.asarray(tr.last_Tcw),
                                            tr.ms, tr.ref_kf)
    got = strategies.track_reference_keyframe(CAM, feats_to_torch(feats),
                                              torch.from_numpy(np.asarray(tr.last_Tcw)),
                                              ms, tr.ref_kf)
    np.testing.assert_array_equal(got.lm_id.numpy(), np.asarray(want.lm_id))
    assert int(got.n_inliers) == int(want.n_inliers) and bool(got.ok) == bool(want.ok)
    np.testing.assert_allclose(got.Tcw.numpy(), np.asarray(want.Tcw), atol=1e-4)


def test_build_local_map_matches_jax(tracked8):
    """The harvested rows in the same order, and the same voted keyframes."""
    tr, _, ms = tracked8
    for cap in (4096, 256):
        want = j_localmap.build_local_map(tr.ms, tr.last_lm_id, capacity=cap)
        got = localmap.build_local_map(ms, to_torch(tr.last_lm_id), capacity=cap)
        assert_tree_close(tree_np(got), tree_np(want), atol=0.0)
    assert int(got.lm_valid.sum()) == 256


def test_motion_model_and_local_map_match_jax(tracked8):
    tr, feats, ms = tracked8
    Tp_j = j_traj.predict_pose(tr.traj, jnp.asarray(0.8))
    Tp_t = strategies.TJ.predict_pose(traj_to_torch(tr.traj), 0.8)
    np.testing.assert_allclose(Tp_t.numpy(), np.asarray(Tp_j), atol=1e-5)
    mm_j = j_strat.track_motion_model(DEFAULT_CAM, feats, Tp_j, tr.last_feats,
                                      tr.last_lm_id, tr.ms)
    mm_t = strategies.track_motion_model(CAM, feats_to_torch(feats), Tp_t,
                                         feats_to_torch(tr.last_feats),
                                         to_torch(tr.last_lm_id), ms)
    np.testing.assert_array_equal(mm_t.lm_id.numpy(), np.asarray(mm_j.lm_id))
    lm_j = j_strat.track_local_map(DEFAULT_CAM, feats, mm_j.Tcw, mm_j.lm_id, tr.ms)
    lm_t = strategies.track_local_map(CAM, feats_to_torch(feats), mm_t.Tcw, mm_t.lm_id, ms)
    np.testing.assert_array_equal(lm_t.track.lm_id.numpy(), np.asarray(lm_j.track.lm_id))
    assert int(lm_t.n_local_matches) == int(lm_j.n_local_matches)
    np.testing.assert_allclose(lm_t.track.Tcw.numpy(), np.asarray(lm_j.track.Tcw), atol=1e-4)
