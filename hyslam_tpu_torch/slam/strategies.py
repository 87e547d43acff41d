"""Tracking strategies: motion model, reference keyframe, local map
(counterpart of ``hyslam_tpu/slam/strategies.py``), and the async tracking
loop's per-frame step ``track_normal_step`` over ``DevTrackState``.

Each strategy is a match, a pose-only LM and outlier pruning. The pose
solve is ``pose_optimization_fast``: kernel K1 on a CUDA tensor, the plain
solver on a CPU tensor. A NORMAL frame calls it twice (motion model and
local map), three times when the motion model fails and the reference
keyframe is tried; the three calls depend on each other, each starting from
the pose the previous one found. Nothing here reads a value back to the
host except ``track_normal_frame``'s branch on the motion model's success.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.core import trajectory as TJ
from hyslam_tpu_torch.core.frame import FrameFeatures, feature_inv_sigma2
from hyslam_tpu_torch.core.mapstate import MapState, resolve_landmarks
from hyslam_tpu_torch.features.matcher import (
    match_descriptors,
    search_by_projection_frame,
    search_by_projection_landmarks,
)
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.ops import indexing as ix
from hyslam_tpu_torch.slam.localmap import LocalMap, build_local_map
from hyslam_tpu_torch.slam.tracking_params import (
    LocalMapParams,
    MotionModelParams,
    ReferenceKFParams,
    TrackingParams,
)
from hyslam_tpu_torch.solver.pose_opt import pose_optimization_fast


class TrackResult(NamedTuple):
    Tcw: torch.Tensor
    lm_id: torch.Tensor       # [F] associations after pruning
    n_inliers: torch.Tensor
    ok: torch.Tensor          # success flag


def frame_pose_problem(cam: Camera, feats: FrameFeatures, lm_id: torch.Tensor,
                       ms: MapState, Tcw0: torch.Tensor, n_levels: int = 8,
                       scale_factor: float = 1.2) -> tuple:
    """The pose solver's arguments for a frame and its associations [F]
    (the landmarks' world positions gathered per feature): what
    ``_optimize_frame_pose`` solves, so a caller can solve the same problem
    another way (the results carry the local-map problem as ``problem``)."""
    has = lm_id >= 0
    inv_s2 = feature_inv_sigma2(feats.level, n_levels, scale_factor)
    X = ms.lm.pos[lm_id.clamp(0, ms.L - 1).long()]
    return (cam, Tcw0, X, feats.uv, feats.ur, inv_s2, has, has & (feats.ur > 0))


def _optimize_frame_pose(problem: tuple, lm_id: torch.Tensor,
                         min_inliers: int) -> TrackResult:
    """Shared tail: pose-only LM on the associations' problem + outlier
    pruning (TrackMotionModel.cpp:45-80)."""
    res = pose_optimization_fast(*problem)
    return TrackResult(Tcw=res.Tcw, lm_id=torch.where(res.inliers, lm_id, -1),
                       n_inliers=res.num_inliers,
                       ok=res.num_inliers >= min_inliers)


def track_motion_model(cam: Camera, cur_feats, Tcw_pred: torch.Tensor,
                       last_feats, last_lm_id: torch.Tensor, ms: MapState,
                       min_inliers: int = 20, n_levels: int = 8,
                       scale_factor: float = 1.2,
                       p: MotionModelParams = MotionModelParams()) -> TrackResult:
    """TrackMotionModel::track: constant-velocity predicted pose ->
    projection match against the last frame -> pose optimization. The
    narrow and the widened window both run, and the wide result is taken
    when the narrow one has fewer than n_min_matches."""
    last_lm_id = resolve_landmarks(ms, last_lm_id)
    last_pos = ms.lm.pos[last_lm_id.clamp(0, ms.L - 1).long()]
    lm_n, n_n = search_by_projection_frame(
        cam, cur_feats, Tcw_pred, last_feats, last_lm_id, last_pos,
        th=p.match_radius, n_levels=n_levels, scale_factor=scale_factor)
    lm_w, _ = search_by_projection_frame(
        cam, cur_feats, Tcw_pred, last_feats, last_lm_id, last_pos,
        th=p.inflation_factor * p.match_radius, n_levels=n_levels,
        scale_factor=scale_factor)
    lm_id = torch.where(n_n >= p.n_min_matches, lm_n, lm_w)
    return _optimize_frame_pose(
        frame_pose_problem(cam, cur_feats, lm_id, ms, Tcw_pred, n_levels, scale_factor),
        lm_id, min_inliers)


def track_reference_keyframe(cam: Camera, cur_feats, Tcw0: torch.Tensor,
                             ms: MapState, ref_kf, min_inliers: int = 10,
                             n_levels: int = 8, scale_factor: float = 1.2,
                             p: ReferenceKFParams = ReferenceKFParams()
                             ) -> TrackResult:
    """TrackReferenceKeyFrame::track: descriptor-match the frame against the
    reference keyframe's landmark-bearing features (at least
    n_min_matches_bow), then optimize from the last pose."""
    kf_lm = resolve_landmarks(ms, ix.take(ms.kf.lm_id, ref_kf))
    idx_b, n = match_descriptors(
        cur_feats.desc, cur_feats.valid, cur_feats.angle,
        ix.take(ms.kf.desc, ref_kf), ix.take(ms.kf.kp_valid, ref_kf) & (kf_lm >= 0),
        ix.take(ms.kf.angle, ref_kf),
        max_dist=p.max_descriptor_dist, ratio=p.match_nnratio)
    lm_id = torch.where(idx_b >= 0, kf_lm[idx_b.clamp(0, ms.F - 1).long()], -1)
    lm_id = torch.where(n >= p.n_min_matches_bow, lm_id, -1)
    return _optimize_frame_pose(
        frame_pose_problem(cam, cur_feats, lm_id, ms, Tcw0, n_levels, scale_factor),
        lm_id, min_inliers)


class LocalMapResult(NamedTuple):
    track: TrackResult
    local: LocalMap
    n_local_matches: torch.Tensor
    problem: tuple             # the pose solver's arguments it solved


class NormalFrameResult(NamedTuple):
    """What the host state machine needs from one NORMAL-state frame;
    ``scalars`` packs the decision counters into one small transfer."""

    Tcw: torch.Tensor          # [4,4] optimized pose
    lm_id: torch.Tensor        # [F] pruned associations
    local_ref_kf: torch.Tensor  # [] best-supported local keyframe
    scalars: torch.Tensor      # int32 [8]: n_motion, init_ok, n_inliers,
                               #   n_local, n_tracked_close,
                               #   n_nontracked_close, ok, n_kfs_in_map
    problem: tuple             # the local-map pose problem behind Tcw


def track_local_map(cam: Camera, cur_feats, Tcw0: torch.Tensor,
                    cur_lm_id: torch.Tensor, ms: MapState, min_inliers: int = 30,
                    n_levels: int = 8, scale_factor: float = 1.2,
                    p: LocalMapParams = LocalMapParams()) -> LocalMapResult:
    """TrackLocalMap::track: build the local map from the frame's matches,
    projection-match its landmarks against the still-unmatched features,
    then optimize the pose against the enlarged association set."""
    L = ms.L
    local = build_local_map(ms, cur_lm_id, capacity=p.local_capacity)
    already = cur_lm_id >= 0
    cur_set = torch.zeros(L + 1, dtype=torch.bool, device=cur_lm_id.device).index_put(
        (torch.where(already, cur_lm_id.clamp(0, L - 1).long(), L),),
        torch.ones((), dtype=torch.bool, device=cur_lm_id.device))
    fresh = local.lm_valid & ~cur_set[local.lm_idx.clamp(0, L - 1).long()]
    res = search_by_projection_landmarks(
        cam, cur_feats, Tcw0, local.lm_pos, local.lm_normal, local.lm_desc,
        local.lm_max_dist, local.lm_min_dist, fresh, already_matched=already,
        th=p.match_radius, ratio=p.match_nnratio, n_levels=n_levels,
        scale_factor=scale_factor)
    Lloc = local.lm_idx.shape[0]
    new_lm = torch.where(res.lm_for_feature >= 0,
                         local.lm_idx[res.lm_for_feature.clamp(0, Lloc - 1).long()], -1)
    lm_id = torch.where(already, cur_lm_id, new_lm)
    problem = frame_pose_problem(cam, cur_feats, lm_id, ms, Tcw0, n_levels, scale_factor)
    return LocalMapResult(track=_optimize_frame_pose(problem, lm_id, min_inliers),
                          local=local, n_local_matches=res.n_matches, problem=problem)


def track_normal_frame(cam: Camera, cur_feats, timestamp, traj,
                       last_Tcw: torch.Tensor, last_feats,
                       last_lm_id: torch.Tensor, ref_kf, ms: MapState,
                       min_inliers, n_levels: int = 8, scale_factor: float = 1.2,
                       params: TrackingParams = TrackingParams()
                       ) -> NormalFrameResult:
    """The whole NORMAL-state frame (Tracking::_Track_): constant-velocity
    prediction -> motion-model track -> reference-keyframe fallback, taken
    on the host only when the motion model failed (one read of its flag) ->
    local-map refinement -> keyframe-decision counters."""
    Tcw_pred = TJ.predict_pose(traj, timestamp)
    mm = track_motion_model(
        cam, cur_feats, Tcw_pred, last_feats, last_lm_id, ms,
        min_inliers=params.motion.n_min_matches, n_levels=n_levels,
        scale_factor=scale_factor, p=params.motion)
    init = mm if bool(mm.ok) else track_reference_keyframe(
        cam, cur_feats, last_Tcw, ms, ref_kf, n_levels=n_levels,
        scale_factor=scale_factor, p=params.ref_kf)

    lres = track_local_map(cam, cur_feats, init.Tcw, init.lm_id, ms,
                           n_levels=n_levels, scale_factor=scale_factor,
                           p=params.local_map)
    tr = lres.track
    ok = init.ok & (tr.n_inliers >= min_inliers)
    depth = cur_feats.depth
    has = tr.lm_id >= 0
    close = (depth > 0) & (depth < cam.close_depth)
    i32 = torch.int32
    scalars = torch.stack([
        mm.n_inliers.to(i32), init.ok.to(i32),
        torch.where(init.ok, tr.n_inliers, 0).to(i32),
        torch.where(init.ok, lres.n_local_matches, 0).to(i32),
        torch.sum(close & has).to(i32), torch.sum(close & ~has).to(i32),
        ok.to(i32), ms.next_kf.to(i32),
    ])
    return NormalFrameResult(Tcw=tr.Tcw, lm_id=tr.lm_id,
                             local_ref_kf=lres.local.ref_kf, scalars=scalars,
                             problem=lres.problem)


class DevTrackState(NamedTuple):
    """The tracker's per-frame state for the async tracking loop, held as
    tensors on the tracker's device: everything ``Tracker._do_normal`` keeps
    in host fields (last pose, its pose relative to the reference keyframe,
    the reference ids, the last frame's features and associations),
    updated by ``track_normal_step`` without the host reading any of it.
    The host state machine consumes the packed decision counters
    ``commit_lag`` frames later."""

    last_Tcw: torch.Tensor     # [4,4] last successfully tracked pose
    last_Tcr: torch.Tensor     # [4,4] last pose relative to its ref KF
    last_ref_kf: torch.Tensor  # [] int32
    ref_kf: torch.Tensor       # [] int32 current reference keyframe
    last_lm_id: torch.Tensor   # [F] last frame's associations
    last_feats: FrameFeatures  # features of the last good frame


class AsyncStepOut(NamedTuple):
    dev: DevTrackState
    traj: TJ.Trajectory        # after the (conditional) append
    scalars: torch.Tensor      # NormalFrameResult.scalars (int32 [8])
    Tcw: torch.Tensor          # this frame's optimized pose (garbage if !ok)
    lm_id: torch.Tensor        # [F] this frame's pruned associations


def track_normal_step(cam: Camera, cur_feats, timestamp, traj,
                      dev: DevTrackState, ms: MapState, min_inliers,
                      n_levels: int = 8, scale_factor: float = 1.2,
                      params: TrackingParams = TrackingParams()) -> AsyncStepOut:
    """One NORMAL-state frame with the whole state update in tensors:
    UpdateLastFrame re-anchoring (Tracking.cpp:249), ``track_normal_frame``,
    the trajectory append and the roll-over of the last-frame state, all
    gated on the frame's success flag, so that a lost frame freezes the state
    at the last good frame (the host learns of the loss from the fetched
    counters and transitions the state machine then)."""
    # UpdateLastFrame: re-derive the last pose from the (re-optimized) ref KF
    last_Tcw = torch.where(dev.last_ref_kf >= 0,
                           dev.last_Tcr @ ix.take(ms.kf.Tcw, dev.last_ref_kf),
                           dev.last_Tcw)
    nf = track_normal_frame(
        cam, cur_feats, timestamp, traj, last_Tcw, dev.last_feats,
        dev.last_lm_id, dev.ref_kf, ms, min_inliers, n_levels=n_levels,
        scale_factor=scale_factor, params=params)
    ok = nf.scalars[6] > 0

    ref_new = torch.where(ok, nf.local_ref_kf.to(dev.ref_kf.dtype), dev.ref_kf)
    ref_pose = ix.take(ms.kf.Tcw, ref_new)
    Tcr = nf.Tcw @ se3.inverse(ref_pose)
    traj = TJ.append(traj, timestamp, nf.Tcw, ref_new, ref_pose, ok, commit=ok)

    dev2 = DevTrackState(
        last_Tcw=torch.where(ok, nf.Tcw, dev.last_Tcw),
        last_Tcr=torch.where(ok, Tcr, dev.last_Tcr),
        last_ref_kf=torch.where(ok, ref_new, dev.last_ref_kf),
        ref_kf=ref_new,
        last_lm_id=torch.where(ok, nf.lm_id, dev.last_lm_id),
        last_feats=FrameFeatures(*(torch.where(ok, a, b)
                                   for a, b in zip(cur_feats, dev.last_feats))),
    )
    return AsyncStepOut(dev=dev2, traj=traj, scalars=nf.scalars, Tcw=nf.Tcw,
                        lm_id=nf.lm_id)
