"""The sub-map tree of the port's map state against the JAX package's, on
the CPU: the cases of tests/test_mapstate.py's TestSubMaps and the other
sub-map functions run the same numpy inputs through both packages. After
create / register / set-active / apply-transform / refresh-tiepoints the
arenas and the map table must be equal (integers and bools exactly, floats
within 1e-5), and so must the scope they give: ``visible_scope``,
``map_root``, ``resolve_landmarks`` and the local map, with a private and
with a registered sub-map."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hyslam_tpu.slam import localmap as j_localmap
from hyslam_tpu_torch.core import mapstate
from hyslam_tpu_torch.slam import localmap

from port_helpers import assert_tree_close, tree_np
from test_torch_mapstate import ATOL, JAX as _JAX, TORCH as _TORCH, feats, ivec, two_kfs

torch.set_num_threads(2)

JAX = SimpleNamespace(**vars(_JAX), LM=j_localmap)
TORCH = SimpleNamespace(**vars(_TORCH), LM=localmap)


def _pose(api, tx):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = tx
    return api.arr(T)


def child_with_kf(api, register=False, tie=False):
    """Two keyframes in map 0, then a sub-map holding a third keyframe that
    sees 5 landmarks of its own."""
    M = api.M
    ms, k0, k1, lm_idx = two_kfs(api)
    ms, child = M.create_submap(ms)
    f = feats(api, 5, 9)
    ms, k2 = M.add_keyframe(ms, f, _pose(api, -0.4), 3.0, 3, 0,
                            ivec(api, np.full(32, -1)), origin=True)
    pos = np.tile([0.2, 0.0, 4.0], (32, 1)).astype(np.float32)
    ms, sub_lm = M.add_landmarks(ms, api.arr(pos), f.desc, k2, ivec(api, np.arange(32)),
                                 api.arr(np.arange(32) < 5))
    if register:
        if tie:
            M_meas = np.eye(4, dtype=np.float32)
            M_meas[0, 3] = -0.7
            ms = M.register_submap(ms, child, Tse3_parent=api.arr(M_meas), tie_kf=1)
        else:
            ms = M.register_submap(ms, child)
    ms = M.refresh_covisibility(ms)
    return ms, child, lm_idx, np.asarray(tree_np(sub_lm))


def scope_outputs(api, ms, lm_idx, sub_lm):
    """Everything the tracker's queries see of this map state."""
    M = api.M
    kf_ok, lm_ok = M.visible_scope(ms)
    roots = M.map_root(ms.maps, ivec(api, np.arange(4)))
    query = np.concatenate([lm_idx[:6], sub_lm[:5], [-1]]).astype(np.int32)
    frame_lm = np.full(32, -1, np.int32)
    frame_lm[:6] = lm_idx[:6]
    frame_lm[6:9] = sub_lm[:3]
    loc = api.LM.build_local_map(ms, ivec(api, frame_lm), capacity=48)
    return (kf_ok, lm_ok, roots, M.resolve_landmarks(ms, ivec(api, query)), loc)


def case_create_and_scope(api):
    ms, _, lm_idx, sub_lm = child_with_kf(api)
    return ms, scope_outputs(api, ms, lm_idx, sub_lm)


def case_create_without_activating(api):
    ms, _, _, lm_idx = two_kfs(api)
    ms, child = api.M.create_submap(ms, set_active=False)
    return ms, (child,) + scope_outputs(api, ms, lm_idx, lm_idx)


def case_register_merges_scope(api):
    ms, _, lm_idx, sub_lm = child_with_kf(api, register=True)
    ms = api.M.set_active_map(ms, 0)
    return ms, scope_outputs(api, ms, lm_idx, sub_lm)


def case_registered_child_active(api):
    ms, _, lm_idx, sub_lm = child_with_kf(api, register=True, tie=True)
    return ms, scope_outputs(api, ms, lm_idx, sub_lm)


def case_private_submap_hidden_from_parent(api):
    ms, _, lm_idx, sub_lm = child_with_kf(api)
    ms = api.M.set_active_map(ms, 0)
    return ms, scope_outputs(api, ms, lm_idx, sub_lm)


def case_registered_and_private_side_by_side(api):
    """A registered sub-map and, opened from it, an unregistered one."""
    M = api.M
    ms, _, lm_idx, sub_lm = child_with_kf(api, register=True, tie=True)
    ms, second = M.create_submap(ms)
    ms, _ = M.add_keyframe(ms, feats(api, 4, 12), _pose(api, -0.9), 4.0, 4, 0,
                           ivec(api, np.full(32, -1)), origin=True)
    outs = scope_outputs(api, ms, lm_idx, sub_lm)
    back = M.set_active_map(ms, 1)
    return ms, outs + scope_outputs(api, back, lm_idx, sub_lm) + (second,)


def case_apply_transform_to_map(api):
    ms, child, lm_idx, sub_lm = child_with_kf(api, register=True)
    T = np.asarray(tree_np(api.se3.exp(api.arr(
        np.asarray([0.02, -0.1, 0.05, 0.3, -0.2, 0.1], np.float32)))))
    ms = api.M.apply_transform_to_map(ms, child, api.arr(T))
    return ms, ()


def case_refresh_tiepoints(api):
    M = api.M
    ms, _, _, _ = child_with_kf(api, register=True, tie=True)
    # move the sub-map's origin: the tiepoint is re-measured from the poses
    ms = ms._replace(kf=ms.kf._replace(Tcw=api.arr(np.asarray(tree_np(api.se3.exp(api.arr(
        np.asarray([0, 0.05, 0, 0.1, 0, 0.2], np.float32)))))) @ ms.kf.Tcw))
    return M.refresh_tiepoints(ms), ()


CASES = [
    case_create_and_scope, case_create_without_activating, case_register_merges_scope,
    case_registered_child_active, case_private_submap_hidden_from_parent,
    case_registered_and_private_side_by_side, case_apply_transform_to_map,
    case_refresh_tiepoints,
]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__[5:] for c in CASES])
def test_submap_state_and_scope_match_jax(case):
    ms_j, out_j = case(JAX)
    ms_t, out_t = case(TORCH)
    assert_tree_close(tree_np(ms_t), tree_np(ms_j), atol=ATOL)
    assert_tree_close(tree_np(out_t), tree_np(out_j), atol=ATOL)


def test_scope_of_private_and_registered_submaps():
    """The outcomes read directly (tests/test_mapstate.py's assertions): an
    unregistered active child hides the parent, a registered one joins it,
    and from the parent a private child stays hidden."""
    ms, child, _, _ = child_with_kf(TORCH)
    assert int(ms.maps.active) == int(child) == 1 and int(ms.kf.map_id[2]) == 1
    kf_ok, _ = mapstate.visible_scope(ms)
    assert kf_ok.tolist()[:3] == [False, False, True]
    kf_ok, _ = mapstate.visible_scope(mapstate.set_active_map(ms, 0))
    assert kf_ok.tolist()[:3] == [True, True, False]
    ms = mapstate.set_active_map(mapstate.register_submap(ms, child), 0)
    kf_ok, _ = mapstate.visible_scope(ms)
    assert kf_ok.tolist()[:3] == [True, True, True]
    assert int(mapstate.map_root(ms.maps, torch.tensor(1))) == 0
    assert int(ms.maps.tie_kf[1]) == -1


def test_submap_functions_leave_their_input_unchanged():
    ms, child, _, _ = child_with_kf(TORCH)
    before = tree_np(ms)
    mapstate.create_submap(ms)
    mapstate.register_submap(ms, child, Tse3_parent=torch.eye(4) * 2, tie_kf=1)
    mapstate.set_active_map(ms, 0)
    mapstate.apply_transform_to_map(ms, child, torch.eye(4))
    mapstate.refresh_tiepoints(mapstate.register_submap(ms, child, torch.eye(4), 1))
    assert_tree_close(tree_np(ms), before, atol=0.0)
