"""The port's map state and trajectory against the JAX package's, on the
CPU: each case of tests/test_mapstate.py (sub-maps aside) and of
tests/test_trajectory.py runs the same numpy inputs through both packages,
and the whole state must agree: integer and bool arrays equal, floats within
1e-5."""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.core import mapstate as j_mapstate
from hyslam_tpu.core import trajectory as j_traj
from hyslam_tpu.core.frame import FrameFeatures as JFrameFeatures
from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.slam import mapper as j_mapper
from hyslam_tpu_torch.core import mapstate, trajectory
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.slam import mapper

from port_helpers import assert_tree_close, to_torch, tree_np

torch.set_num_threads(2)

JAX = SimpleNamespace(M=j_mapstate, se3=j_se3, TJ=j_traj, arr=jnp.asarray,
                      FF=JFrameFeatures, mapper=j_mapper)
TORCH = SimpleNamespace(M=mapstate, se3=se3, TJ=trajectory, arr=to_torch,
                        FF=FrameFeatures, mapper=mapper)
CAPS = (8, 64, 32, 4)   # K, L, F, O of tests/test_mapstate.py
ATOL = 1e-5


def feats_np(n, F=32, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        uv=rng.uniform(0, 640, (F, 2)).astype(np.float32),
        ur=np.full(F, -1.0, np.float32), depth=np.full(F, -1.0, np.float32),
        level=np.zeros(F, np.int32), angle=np.zeros(F, np.float32),
        desc=rng.integers(0, 2**32, (F, 8), dtype=np.uint32),
        valid=np.arange(F) < n,
    )


def feats(api, n, seed):
    return api.FF(**{k: api.arr(v) for k, v in feats_np(n, seed=seed).items()})


def ivec(api, a):
    return api.arr(np.asarray(a, np.int32))


def bvec(api, a):
    return api.arr(np.asarray(a, bool))


def two_kfs(api, n_shared=10):
    """tests/test_mapstate.py:ms_with_two_kfs in either package."""
    M = api.M
    ms = M.empty_map_state(M.MapCaps(*CAPS))
    f0 = feats(api, 20, 1)
    ms, k0 = M.add_keyframe(ms, f0, api.se3.identity(), 0.0, 0, 0,
                            ivec(api, np.full(32, -1)), origin=True)
    pos = np.tile([0.0, 0.0, 5.0], (32, 1)).astype(np.float32)
    ms, lm_idx = M.add_landmarks(ms, api.arr(pos), f0.desc, k0,
                                 ivec(api, np.arange(32)), bvec(api, np.arange(32) < 15))
    assoc = np.full(32, -1, np.int32)
    assoc[:n_shared] = np.asarray(lm_idx)[:n_shared]
    T1 = api.se3.exp(api.arr(np.asarray([0, 0, 0, 0.3, 0, 0], np.float32)))
    ms, k1 = M.add_keyframe(ms, feats(api, 20, 2), T1, 1.0, 1, 0, ivec(api, assoc))
    return ms, k0, k1, np.asarray(lm_idx)


def with_third_kf(api, T2=None):
    ms, k0, k1, lm_idx = two_kfs(api)
    assoc = np.full(32, -1, np.int32)
    assoc[:5] = lm_idx[:5]
    T2 = api.se3.identity() if T2 is None else api.arr(T2)
    ms, _ = api.M.add_keyframe(ms, feats(api, 5, 3), T2, 2.0, 2, 0, ivec(api, assoc))
    ms = api.M.compute_spanning_parents(api.M.refresh_covisibility(ms))
    return ms, lm_idx


def case_add_keyframe(api):
    return two_kfs(api)[0], ()


def case_add_landmarks_allocates_and_binds(api):
    ms, _, _, lm_idx = two_kfs(api)
    return ms, (lm_idx,)


def case_two_sided_consistency(api):
    return two_kfs(api, n_shared=7)[0], ()


def case_erase_association(api):
    ms, _, k1, _ = two_kfs(api)
    return api.M.erase_associations(ms, k1, ivec(api, np.arange(32)),
                                    bvec(api, np.arange(32) < 5)), ()


def case_weights(api):
    return api.M.refresh_covisibility(two_kfs(api)[0]), ()


def case_neighbors_thresholded(api):
    ms = api.M.refresh_covisibility(two_kfs(api)[0])
    return ms, (api.M.covis_neighbors(ms, 0, n_best=4, min_weight=15)
                + api.M.covis_neighbors(ms, 0, n_best=4, min_weight=5))


def case_spanning_parent(api):
    M = api.M
    return M.compute_spanning_parents(M.refresh_covisibility(two_kfs(api)[0])), ()


def case_normals_point_at_cameras(api):
    return api.M.update_landmark_stats(two_kfs(api)[0]), ()


def case_distance_range(api):
    # every observation of the shared landmarks on a finer level
    ms, _, _, _ = two_kfs(api)
    ms = ms._replace(kf=ms.kf._replace(level=ms.kf.level + 2))
    return api.M.update_landmark_stats(ms), ()


def case_best_descriptor_is_an_observed_one(api):
    return api.M.update_landmark_stats(two_kfs(api, n_shared=15)[0]), ()


def case_set_landmarks_bad_detaches(api):
    ms, _, _, lm_idx = two_kfs(api)
    bad = np.zeros(64, bool)
    bad[lm_idx[:3]] = True
    return api.M.set_landmarks_bad(ms, bvec(api, bad)), ()


def case_replace_rewrites_references(api):
    ms, _, _, lm_idx = two_kfs(api)
    ms = api.M.replace_landmarks(ms, ivec(api, lm_idx[[0, 2]]),
                                 ivec(api, lm_idx[[1, 3]]), bvec(api, [True, True]))
    return ms, (api.M.resolve_landmarks(ms, ivec(api, lm_idx[:4])),)


def case_cull_keyframe_reparents(api):
    ms, _ = with_third_kf(api)
    bad = np.zeros(8, bool)
    bad[1] = True
    return api.M.set_keyframes_bad(ms, bvec(api, bad)), ()


def case_spanning_recompute_preserves_culled_anchors(api):
    T2 = np.eye(4, dtype=np.float32)
    T2[0, 3] = 0.7
    ms, _ = with_third_kf(api, T2)
    traj = api.TJ.append(api.TJ.empty_trajectory(16), 1.0, ms.kf.Tcw[1], 1,
                         ms.kf.Tcw[1], True)
    bad = np.zeros(8, bool)
    bad[1] = True
    M = api.M
    ms = M.compute_spanning_parents(M.refresh_covisibility(
        M.set_keyframes_bad(ms, bvec(api, bad))))
    dT = np.eye(4, dtype=np.float32)
    dT[1, 3] = 2.5
    ms = ms._replace(kf=ms.kf._replace(Tcw=api.arr(dT) @ ms.kf.Tcw))
    traj = api.TJ.refresh(traj, ms.kf.Tcw, ms.kf.bad, ms.kf.span_parent, ms.kf.Tcp)
    return ms, (traj.Tcw,)


def case_landmark_slots_recycle(api):
    M = api.M
    ms, k0, _, lm_idx = two_kfs(api)
    f = feats(api, 32, 7)
    pos = np.tile([0.0, 0.0, 6.0], (32, 1)).astype(np.float32)
    outs = []
    for _ in range(2):   # 15 + 2 x 32 > 64: the arena fills up
        ms, idx = M.add_landmarks(ms, api.arr(pos), f.desc, k0, ivec(api, np.arange(32)),
                                  bvec(api, np.ones(32)), protection=0)
        outs.append(idx)
    bad = np.zeros(64, bool)
    bad[lm_idx[:6]] = True
    ms = M.set_landmarks_bad(ms, bvec(api, bad))
    ms, idx = M.add_landmarks(ms, api.arr(pos[:4]), f.desc[:4], k0,
                              ivec(api, np.arange(4)), bvec(api, np.ones(4)))
    outs.append(idx)
    lm = ms.lm
    prot = np.asarray(tree_np(lm.protection))
    prot = np.where(np.asarray(tree_np(lm.bad)), np.maximum(prot - M.RECYCLE_DELAY, 0), prot)
    ms = ms._replace(lm=lm._replace(protection=ivec(api, prot)))
    ms, idx = M.add_landmarks(ms, api.arr(pos[:4]), f.desc[:4], k0,
                              ivec(api, np.arange(4)), bvec(api, np.ones(4)))
    return ms, tuple(outs) + (idx,)


def case_origin_not_erasable(api):
    ms, _, _, _ = two_kfs(api)
    return api.M.set_keyframes_bad(ms, bvec(api, np.ones(8, bool))), ()


def case_duplicate_targets(api):
    """Two features of one keyframe bound to one landmark (a fused pair), and
    a replacement naming one source twice: XLA's CPU scatter keeps the last
    row, and so must the port, whose card scatter would promise nothing."""
    M = api.M
    ms, _, _, lm_idx = two_kfs(api)
    assoc = np.full(32, -1, np.int32)
    assoc[[0, 4, 9]] = lm_idx[2]
    assoc[[1, 7]] = lm_idx[3]
    ms, k2 = M.add_keyframe(ms, feats(api, 12, 4), api.se3.identity(), 2.0, 2, 0,
                            ivec(api, assoc))
    ms = M.add_associations(ms, k2, ivec(api, [20, 21, 20]), ivec(api, lm_idx[[5, 6, 7]]),
                            bvec(api, [True, True, True]))
    ms = M.replace_landmarks(ms, ivec(api, lm_idx[[8, 8, 9]]), ivec(api, lm_idx[[10, 11, 12]]),
                             bvec(api, [True, True, True]))
    return ms, ()


# planted states for the map refresh (refresh_covisibility,
# update_landmark_stats): the plain versions, which the card's kernels K2 and
# K3 are held to (chip_smoke.py phase 14), against the JAX package

def case_covis_counts_a_repeated_name_once(api):
    """A keyframe that names one landmark from several features shares it
    once with each other keyframe."""
    M = api.M
    ms, _, _, lm_idx = two_kfs(api)
    assoc = np.full(32, -1, np.int32)
    assoc[[0, 4, 9]] = lm_idx[2]
    assoc[[1, 7]] = lm_idx[3]
    assoc[2] = lm_idx[5]
    ms, _ = M.add_keyframe(ms, feats(api, 12, 4), api.se3.identity(), 2.0, 2, 0,
                           ivec(api, assoc))
    return M.refresh_covisibility(ms), ()


def case_covis_skips_a_bad_keyframe(api):
    """Names held by a keyframe marked bad, left in place, share nothing."""
    ms, _ = with_third_kf(api)
    bad = np.zeros(CAPS[0], bool)
    bad[2] = True
    ms = ms._replace(kf=ms.kf._replace(bad=bvec(api, bad)))
    M = api.M
    return M.compute_spanning_parents(M.refresh_covisibility(ms)), ()


def case_covis_skips_a_bad_landmark(api):
    """Names of landmarks marked bad, left in place, share nothing."""
    ms, lm_idx = with_third_kf(api)
    bad = np.zeros(CAPS[1], bool)
    bad[lm_idx[[0, 3, 7]]] = True
    ms = ms._replace(lm=ms.lm._replace(bad=bvec(api, bad)))
    return api.M.refresh_covisibility(ms), ()


def more_observers_than_o(api):
    """Seven keyframes name the first six landmarks, whose lists hold O = 4
    observations; levels 0-7 and poses that differ, for the statistics."""
    M = api.M
    ms, _, _, lm_idx = two_kfs(api)
    assoc = np.full(32, -1, np.int32)
    assoc[:6] = lm_idx[:6]
    for i in range(5):
        T = api.se3.exp(api.arr(np.asarray([0.01 * i, 0.02, 0, 0.1 * i, -0.05 * i, 0.2],
                                           np.float32)))
        ms, _ = M.add_keyframe(ms, feats(api, 8, 10 + i), T, 2.0 + i, 2 + i, 0,
                               ivec(api, assoc))
    levels = np.random.default_rng(5).integers(0, 8, (CAPS[0], CAPS[2]), dtype=np.int32)
    return ms._replace(kf=ms.kf._replace(level=api.arr(levels)))


def case_covis_counts_more_observers_than_o(api):
    return api.M.refresh_covisibility(more_observers_than_o(api)), ()


def case_stats_over_the_first_o_observers(api):
    return api.M.update_landmark_stats(more_observers_than_o(api)), ()


def case_stats_keep_rows_without_observations(api):
    """Rows whose observations are all gone keep the values of the refresh
    before, virgin rows theirs (normal 0, range [0, inf)), and the rest are
    recomputed from what is left."""
    M = api.M
    ms, _, _, _ = two_kfs(api, n_shared=15)
    ms = M.update_landmark_stats(ms)
    bad = np.zeros(CAPS[0], bool)
    bad[1] = True
    ms = M.set_keyframes_bad(ms, bvec(api, bad))
    ms = M.erase_associations(ms, 0, ivec(api, np.arange(32)), bvec(api, np.arange(32) < 4))
    return M.update_landmark_stats(ms), ()


CASES = [
    case_add_keyframe, case_add_landmarks_allocates_and_binds,
    case_two_sided_consistency, case_erase_association, case_weights,
    case_neighbors_thresholded, case_spanning_parent,
    case_normals_point_at_cameras, case_distance_range,
    case_best_descriptor_is_an_observed_one, case_set_landmarks_bad_detaches,
    case_replace_rewrites_references, case_cull_keyframe_reparents,
    case_spanning_recompute_preserves_culled_anchors, case_landmark_slots_recycle,
    case_origin_not_erasable, case_duplicate_targets,
    case_covis_counts_a_repeated_name_once, case_covis_skips_a_bad_keyframe,
    case_covis_skips_a_bad_landmark, case_covis_counts_more_observers_than_o,
    case_stats_over_the_first_o_observers, case_stats_keep_rows_without_observations,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_map_state_matches_jax(case):
    ms_j, out_j = case(JAX)
    ms_t, out_t = case(TORCH)
    assert_tree_close(tree_np(ms_t), tree_np(ms_j), atol=ATOL)
    assert_tree_close(tree_np(out_t), tree_np(out_j), atol=ATOL)


def test_duplicate_targets_keep_the_last_row():
    """The duplicate case's outcome, read directly: the landmark bound twice
    by one keyframe holds the last feature, counted once per row."""
    ms, _ = case_duplicate_targets(TORCH)
    lm_idx = two_kfs(TORCH)[3]
    lm = ms.lm
    l2 = int(lm_idx[2])
    slots = lm.obs_valid[l2] & (lm.obs_kf[l2] == 2)
    assert int(slots.sum()) == 1 and int(lm.obs_feat[l2][slots]) == 9
    assert int(lm.n_obs[l2]) == 2 + 3
    assert int(lm.replaced_by[int(lm_idx[8])]) == int(lm_idx[11])


def test_planted_states_hold_what_they_plant():
    """The planted cases reach the edges they name: a name counted once,
    the bad keyframe's and bad landmarks' names left out, more names than
    observation slots, rows that keep their values."""
    ms, _ = case_covis_counts_a_repeated_name_once(TORCH)
    lm_idx = two_kfs(TORCH)[3]
    assert int(ms.covis[2, 0]) == 3 and int(ms.covis[2, 1]) == 3   # lm 2, 3, 5
    ms, _ = case_covis_skips_a_bad_keyframe(TORCH)
    assert int(ms.covis[2].abs().sum()) == 0 and int(ms.covis[0, 1]) == 10
    ms, _ = case_covis_skips_a_bad_landmark(TORCH)
    assert int(ms.covis[0, 1]) == 7 and int(ms.covis[0, 2]) == 3
    ms = more_observers_than_o(TORCH)
    l0 = int(lm_idx[0])
    assert int((ms.kf.lm_id == l0).sum()) == 7 and bool(ms.lm.obs_valid[l0].all())
    assert int(mapstate.refresh_covisibility(ms).covis[6, 0]) == 6
    before = mapstate.update_landmark_stats(two_kfs(TORCH, n_shared=15)[0]).lm
    after = case_stats_keep_rows_without_observations(TORCH)[0].lm
    kept = torch.as_tensor(lm_idx[:4]).long()
    assert not bool(after.obs_valid[kept].any())
    for name in ("normal", "desc", "min_dist", "max_dist"):
        assert torch.equal(getattr(after, name)[kept], getattr(before, name)[kept])


def test_cpu_tensors_take_the_plain_versions(monkeypatch):
    """On the CPU refresh_covisibility and update_landmark_stats are their
    plain versions, bit for bit, and build and launch neither kernel."""
    from hyslam_tpu_torch import kernels
    from hyslam_tpu_torch.ops import map_refresh_cuda as R

    def no_build(*a, **k):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "load", no_build)
    ms = more_observers_than_o(TORCH)
    got = mapstate.update_landmark_stats(mapstate.refresh_covisibility(ms))
    want = mapstate.update_landmark_stats_plain(mapstate.refresh_covisibility_plain(ms))
    assert_tree_close(tree_np(got), tree_np(want), atol=0.0)
    assert R.covisibility_cuda.launches == R.landmark_stats_cuda.launches == 0


@pytest.mark.parametrize("fn", ["refresh_covisibility", "update_landmark_stats"])
def test_other_devices_take_the_kernels_or_raise(fn):
    """A state on any device but the CPU goes to the kernel, which raises
    where the device is not CUDA: nothing falls back to the plain version."""
    ms = mapstate.empty_map_state(mapstate.MapCaps(*CAPS), device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        getattr(mapstate, fn)(ms)


def test_functions_leave_their_input_unchanged():
    ms, k0, _, lm_idx = two_kfs(TORCH)
    before = tree_np(ms)
    mapstate.add_landmarks(ms, torch.zeros(4, 3), ms.kf.desc[0, :4], k0,
                           torch.arange(4, dtype=torch.int32), torch.ones(4, dtype=torch.bool))
    mapstate.set_keyframes_bad(ms, torch.ones(8, dtype=torch.bool))
    mapstate.replace_landmarks(ms, to_torch(lm_idx[:1]), to_torch(lm_idx[1:2]),
                               torch.ones(1, dtype=torch.bool))
    mapstate.erase_associations(ms, 1, torch.arange(32, dtype=torch.int32),
                                torch.ones(32, dtype=torch.bool))
    assert_tree_close(tree_np(ms), before, atol=0.0)


# ---------------------------------------------------------------------------
# trajectory: the cases of tests/test_trajectory.py
# ---------------------------------------------------------------------------

def straight(api, n=10, dt=0.5):
    traj = api.TJ.empty_trajectory(64)
    v = np.asarray([0.0, 0.0, 0.0, 1.0, 0.0, 0.0], np.float32)
    for i in range(n):
        traj = api.TJ.append(traj, i * dt, api.se3.exp(api.arr(v * (i * dt))), 0,
                             api.se3.identity(), True)
    return traj


def anchored(api, bad, parent, shift_xi, n=5):
    kf_Tcw = api.arr(np.tile(np.eye(4, dtype=np.float32), (4, 1, 1)))
    traj = api.TJ.empty_trajectory(16)
    ref = 1 if bad[1] else 0
    for i in range(n):
        T = api.se3.exp(api.arr(np.asarray([0, 0, 0, 0.1 * i, 0, 0], np.float32)))
        traj = api.TJ.append(traj, float(i), T, ref, kf_Tcw[ref], True)
    shift = np.asarray(api.se3.exp(api.arr(np.asarray(shift_xi, np.float32))))
    kf_new = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    kf_new[0] = shift
    return api.TJ.refresh(traj, api.arr(kf_new), bvec(api, bad), ivec(api, parent))


TRAJ_CASES = {
    "velocity_recovered": lambda api: straight(api).vel,
    "size": lambda api: straight(api, 7).size,
    "pose_on_grid": lambda api: api.TJ.pose_at_time(straight(api), api.arr(np.float32([1.0]))),
    "off_grid_interpolation": lambda api: api.TJ.pose_at_time(
        straight(api), api.arr(np.float32([1.25, 3.75]))),
    "out_of_range_flagged": lambda api: api.TJ.pose_at_time(
        straight(api), api.arr(np.float32([100.0]))),
    "velocity_at_time": lambda api: api.TJ.velocity_at_time(
        straight(api), api.arr(np.float32([2.2]))),
    "integrate_velocity": lambda api: (
        api.TJ.integrate_velocity(straight(api), api.arr(np.float32(1.0)), api.arr(np.float32(3.0))),
        api.TJ.integrate_velocity(straight(api), api.arr(np.float32(1.25)),
                                  api.arr(np.float32(1.75)))),
    "reanchoring_follows_optimized_kf": lambda api: anchored(
        api, [False] * 4, [-1] * 4, [0, 0, 0, 0, 0.7, 0]),
    "bad_ref_walks_to_parent": lambda api: anchored(
        api, [False, True, False, False], [-1, 0, 1, 2], [0, 0, 0, 0.5, 0, 0], n=1),
    "constant_velocity_extrapolation": lambda api: api.TJ.predict_pose(
        straight(api), api.arr(np.float32(5.0))),
}


@pytest.mark.parametrize("name", list(TRAJ_CASES))
def test_trajectory_matches_jax(name):
    assert_tree_close(tree_np(TRAJ_CASES[name](TORCH)),
                      tree_np(TRAJ_CASES[name](JAX)), atol=ATOL)


def test_recycled_row_drops_stale_names_of_other_maps():
    """A keyframe can name a landmark that is already bad (a frame's
    association kept past its culling). When the row is recycled, the JAX
    package leaves that name in place, so the keyframe names the new,
    unrelated landmark. Across maps the alias forges a covisibility (on the
    card it joined a re-initialized sub-map's keyframes to the root map's
    start and hid the loop between them from detection), so the port clears
    names held by keyframes of another map than the active one; within the
    active map the alias stays, as in the JAX package."""
    out = {}
    for name, api in (("jax", JAX), ("torch", TORCH)):
        M = api.M
        ms, k0, k1, lm_idx = two_kfs(api)
        bad = np.zeros(CAPS[1], bool)
        bad[lm_idx[:2]] = True
        ms = M.set_landmarks_bad(ms, bvec(api, bad))
        assoc = np.full(32, -1, np.int32)
        assoc[3] = lm_idx[0]                        # stale names
        assoc[4] = lm_idx[1]
        assoc[5] = lm_idx[2]
        ms, k2 = M.add_keyframe(ms, feats(api, 6, 3), api.se3.identity(), 2.0, 2, 0,
                                ivec(api, assoc))
        # keyframes 0-2 stay in map 0; a sub-map becomes active, every
        # virgin row is taken and the freed rows' countdowns run out, so the
        # sub-map's next landmarks recycle the two bad rows
        ms, _ = M.create_submap(ms)
        virgin = ~np.asarray(ms.lm.valid)
        n = int(virgin.sum()) + 2
        ms = ms._replace(lm=ms.lm._replace(protection=ms.lm.protection * 0))
        ms, got = M.add_landmarks(ms, api.arr(np.zeros((n, 3), np.float32)),
                                  api.arr(np.asarray(ms.kf.desc)[0, :1].repeat(n, 0)), k1,
                                  ivec(api, np.full(n, 20)), bvec(api, np.ones(n, bool)))
        assert sorted(np.asarray(got)[-2:].tolist()) == sorted(lm_idx[:2].tolist())
        out[name] = np.asarray(ms.kf.lm_id[2]) if name == "jax" else ms.kf.lm_id[2].numpy()
    assert out["jax"][3] == lm_idx[0] and out["jax"][4] == lm_idx[1]      # aliases
    assert out["torch"][3] == out["torch"][4] == -1
    assert out["jax"][5] == out["torch"][5] == lm_idx[2]


def test_recycled_row_leaves_no_alias():
    """The mechanism behind the KITTI-layout soak's fall, at small L; the
    port keeps the JAX package's behaviour, so within the active map the
    recycled row does leave aliases, and both packages are held to the same
    ones. Landmark A is fused into B, B is culled, and two mapper passes run
    out B's RECYCLE_DELAY. A frame's association to B is held past the
    culling and becomes a keyframe's name (the async loop inserts a keyframe
    commit_lag frames after its frame was tracked, with that frame's
    associations). Once every virgin row is taken, the next landmark C
    recycles B's row: A (through its replaced_by), the keyframe's name and
    a raw row index held outside the map then all resolve to C, an unrelated
    landmark. A repair that cleared these names tracked the soak further but
    less accurately (ROADMAP queue 3)."""
    out = {}
    for name, api in (("jax", JAX), ("torch", TORCH)):
        M = api.M
        ms, _, k1, lm_idx = two_kfs(api)
        a, b = int(lm_idx[3]), int(lm_idx[2])
        ms = M.replace_landmarks(ms, ivec(api, [a]), ivec(api, [b]), bvec(api, [True]))
        ms = M.set_landmarks_bad(ms, bvec(api, np.arange(CAPS[1]) == b))
        assoc = np.full(32, -1, np.int32)
        assoc[7] = b                                   # the held association
        ms, _ = M.add_keyframe(ms, feats(api, 8, 4), api.se3.identity(), 2.0, 2, 0,
                               ivec(api, assoc))
        for _ in range(2):                             # RECYCLE_DELAY mapper passes
            ms = api.mapper.cull_landmarks(ms, 100, api.mapper.MapperParams())
        n = int((~np.asarray(ms.lm.valid)).sum()) + 1
        ms, got = M.add_landmarks(ms, api.arr(np.zeros((n, 3), np.float32)),
                                  api.arr(np.asarray(ms.kf.desc)[0, :1].repeat(n, 0)), k1,
                                  ivec(api, np.full(n, 20)), bvec(api, np.ones(n, bool)))
        c = int(np.asarray(got)[-1])
        out[name] = dict(b=b, c=c, a=int(np.asarray(M.resolve_landmarks(ms, ivec(api, [a])))[0]),
                         held=int(np.asarray(M.resolve_landmarks(ms, ivec(api, [b])))[0]),
                         kf_name=int(np.asarray(ms.kf.lm_id)[2, 7]))
    j, t = out["jax"], out["torch"]
    assert j["c"] == j["b"]                                   # C took B's row
    assert j["a"] == j["kf_name"] == j["held"] == j["c"]      # the aliases
    assert t == j


def test_recycled_row_takes_a_virgin_rows_geometry():
    """The other half of the mechanism: a recycled row keeps the dead
    landmark's viewing direction and scale range until the next
    update_landmark_stats, in both packages, while a virgin row has normal
    0 and range [0, inf) (the view gate passes nothing with them). The
    mapper's fusion projects a landmark in the pass that triangulated it, so
    there the dead landmark's geometry sets the new one's view gate,
    predicted level and search window. A repair that gave a recycled row a
    virgin row's values took the soak's fall away on the CPU replay but
    left the soak less accurate on the card (ROADMAP queue 3); the port
    keeps the reference's values."""
    out = {}
    for name, api in (("jax", JAX), ("torch", TORCH)):
        M = api.M
        ms, _, k1, lm_idx = two_kfs(api)
        ms = M.update_landmark_stats(ms)
        dead = int(lm_idx[0])
        ms = M.set_landmarks_bad(ms, bvec(api, np.arange(CAPS[1]) == dead))
        ms = ms._replace(lm=ms.lm._replace(protection=ms.lm.protection * 0))
        n = int((~np.asarray(ms.lm.valid)).sum()) + 1
        ms, got = M.add_landmarks(ms, api.arr(np.zeros((n, 3), np.float32)),
                                  api.arr(np.asarray(ms.kf.desc)[0, :1].repeat(n, 0)), k1,
                                  ivec(api, np.full(n, 20)), bvec(api, np.ones(n, bool)))
        got = np.asarray(got)
        geo = [np.asarray(x) for x in (ms.lm.normal, ms.lm.min_dist, ms.lm.max_dist)]
        out[name] = dict(dead=dead, recycled=int(got[-1]), virgin=int(got[0]),
                         rec=[g[got[-1]] for g in geo], vir=[g[got[0]] for g in geo])
    j, t = out["jax"], out["torch"]
    assert j["recycled"] == t["recycled"] == j["dead"] == t["dead"]
    assert j["virgin"] == t["virgin"]
    for side in (j, t):
        assert side["rec"][0][2] > 0.99                                  # the dead one's
        assert 0 < side["rec"][1] < side["rec"][2] < np.inf
        np.testing.assert_array_equal(side["vir"][0], [0.0, 0.0, 0.0])   # a virgin row's
        assert side["vir"][1] == 0.0 and side["vir"][2] == np.inf
    for g_j, g_t in zip(j["rec"], t["rec"]):
        np.testing.assert_allclose(g_t, g_j, atol=ATOL)
