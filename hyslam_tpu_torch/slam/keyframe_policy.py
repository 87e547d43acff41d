"""Keyframe insertion policy and new-keyframe landmark seeding (counterpart
of ``hyslam_tpu/slam/keyframe_policy.py``). The decision runs on host
scalars, since it gates host control flow; the seeding is tensor code that
reads nothing back."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera, backproject
from hyslam_tpu_torch.ops import indexing as ix


class KeyFramePolicyParams(NamedTuple):
    """Defaults: slam_tracking_config.yaml SLAM/NORMAL block."""

    n_tracked_target: int = 150
    n_tracked_variance: int = 25
    min_kf_interval: int = 0
    max_kf_interval: int = 60
    min_n_tracked_close: int = 100
    thresh_n_nontracked_close: int = 70
    min_frac_ref_kf_mono: float = 0.9
    min_frac_ref_kf_stereo: float = 0.5


class KFDecisionInputs(NamedTuple):
    n_inliers: int
    frame_id: int
    last_kf_frame_id: int
    n_kfs_in_map: int
    n_tracked_close: int
    n_nontracked_close: int
    mapping_idle: bool
    mapping_queue_len: int
    is_mono: bool
    force: bool = False
    mapping_stopped: bool = False


def need_new_keyframe(inp: KFDecisionInputs, p: KeyFramePolicyParams) -> bool:
    """The decision tree of TrackingStateNormal.cpp:87-170."""
    if not inp.force and inp.mapping_stopped:
        return False
    need_close = (
        not inp.is_mono
        and inp.n_tracked_close < p.min_n_tracked_close
        and inp.n_nontracked_close > p.thresh_n_nontracked_close
    )
    max_interval = inp.frame_id >= inp.last_kf_frame_id + p.max_kf_interval
    min_interval = inp.frame_id >= inp.last_kf_frame_id + p.min_kf_interval
    weak = inp.n_inliers < p.n_tracked_target - p.n_tracked_variance
    dire = inp.n_inliers < p.n_tracked_target - 2 * p.n_tracked_variance

    definite = inp.force or max_interval or dire
    optional = min_interval and (weak or need_close)
    if not (definite or (optional and inp.mapping_idle)):
        return False
    if inp.mapping_idle or inp.force:
        return True
    return inp.mapping_queue_len < 3


def seed_close_landmarks(ms: MapState, kf_id, cam: Camera,
                         n_close_target: int = 100):
    """Create landmarks from the new keyframe's close stereo depths: sorted
    by depth (stable, as ``jnp.argsort``), every unassociated feature gets a
    landmark while depth < thDepth * baseline or fewer than n_close_target
    points are covered (TrackingState.cpp:39-86). Returns (ms, n_created)."""
    F = ms.F
    depth = ix.take(ms.kf.depth, kf_id)
    has_assoc = ix.take(ms.kf.lm_id, kf_id) >= 0
    valid_pt = ix.take(ms.kf.kp_valid, kf_id) & (depth > 0)

    order = torch.argsort(torch.where(valid_pt, depth, float("inf")), stable=True)
    v_sorted = valid_pt[order]
    cum = torch.cumsum(v_sorted.to(torch.int32), 0)
    stop = (depth[order] > cam.close_depth) & (cum > n_close_target)
    stopped = torch.cumsum(stop.to(torch.int32), 0) > 0
    create_sorted = v_sorted & ~has_assoc[order] & ~stopped
    create = torch.zeros((F,), dtype=torch.bool, device=depth.device
                         ).index_put((order,), create_sorted)

    Tcw = ix.take(ms.kf.Tcw, kf_id)
    X = se3.apply(se3.inverse(Tcw), backproject(cam, ix.take(ms.kf.uv, kf_id), depth))
    k = kf_id.clamp(0, ms.K - 1) if isinstance(kf_id, torch.Tensor) else kf_id
    ms, idx = M.add_landmarks(
        ms, X, ix.take(ms.kf.desc, kf_id), k,
        torch.arange(F, dtype=torch.int32, device=depth.device), create,
        protection=3)
    return ms, torch.sum(idx >= 0, dtype=torch.int32)
