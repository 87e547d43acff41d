"""The per-frame stereo front end (counterpart of
``hyslam_tpu/slam/frontend.py``): batched ORB extraction of both images ->
stereo match + sub-pixel refinement -> local-map projection matching ->
pose-only LM, every stage on the device of the input tensors.

Nothing here reads a value back to the host: a caller on a card gets
tensors and decides when to synchronise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.core.frame import FrameFeatures, feature_inv_sigma2
from hyslam_tpu_torch.features.atlas import extract_atlas_batch
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.features.matcher import search_by_projection_landmarks
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.ops.stereo import match_stereo_refined
from hyslam_tpu_torch.solver.pose_opt import pose_optimization_fast


class FrontendResult(NamedTuple):
    Tcw: torch.Tensor          # [4,4] optimized pose
    lm_id: torch.Tensor        # [F] landmark row per feature (-1 = none),
                               # outliers pruned
    n_matches: torch.Tensor    # matches found by projection search
    n_inliers: torch.Tensor    # inliers after pose optimization


def pose_problem(
    cam: Camera,
    feats: FrameFeatures,
    Tcw0: torch.Tensor,
    lm_pos: torch.Tensor,       # [L,3] landmark positions
    lm_normal: torch.Tensor,    # [L,3] viewing normals
    lm_desc: torch.Tensor,      # [L,8] int32 descriptors
    lm_max_dist: torch.Tensor,  # [L] scale-invariance distance bounds
    lm_min_dist: torch.Tensor,
    lm_valid: torch.Tensor,     # [L]
    inv_sigma2: torch.Tensor,   # [F] per-feature information
    th: float = 3.0,
    ratio: float = 0.8,
    n_levels: int = 8,
    scale_factor: float = 1.2,
):
    """Projection-match the landmark table against the frame and build the
    pose solver's problem from the matches. Returns (the search result, the
    argument tuple of ``pose_optimization`` / ``pose_optimization_fast``)."""
    F = feats.uv.shape[0]
    L = lm_pos.shape[0]
    res = search_by_projection_landmarks(
        cam, feats, Tcw0, lm_pos, lm_normal, lm_desc, lm_max_dist,
        lm_min_dist, lm_valid,
        torch.zeros((F,), dtype=torch.bool, device=feats.uv.device),
        th=th, ratio=ratio, n_levels=n_levels, scale_factor=scale_factor,
    )
    lm_id = res.lm_for_feature
    X = lm_pos[lm_id.clamp(0, L - 1).long()]
    has = lm_id >= 0
    return res, (cam, Tcw0, X, feats.uv, feats.ur, inv_sigma2, has,
                 has & (feats.ur > 0))


def project_and_optimize(
    cam: Camera,
    feats: FrameFeatures,
    Tcw0: torch.Tensor,
    lm_pos: torch.Tensor,       # [L,3] landmark positions
    lm_normal: torch.Tensor,    # [L,3] viewing normals
    lm_desc: torch.Tensor,      # [L,8] int32 descriptors
    lm_max_dist: torch.Tensor,  # [L] scale-invariance distance bounds
    lm_min_dist: torch.Tensor,
    lm_valid: torch.Tensor,     # [L]
    inv_sigma2: torch.Tensor,   # [F] per-feature information
    th: float = 3.0,
    ratio: float = 0.8,
    n_levels: int = 8,
    scale_factor: float = 1.2,
) -> FrontendResult:
    """Projection-match the landmark table against the frame, then optimize
    the frame pose on the matched set: the TrackLocalMap hot pair
    (FeatureMatcher.cc:123 + Optimizer.cc:48)."""
    res, problem = pose_problem(
        cam, feats, Tcw0, lm_pos, lm_normal, lm_desc, lm_max_dist,
        lm_min_dist, lm_valid, inv_sigma2, th=th, ratio=ratio,
        n_levels=n_levels, scale_factor=scale_factor,
    )
    opt = pose_optimization_fast(*problem)
    return FrontendResult(
        Tcw=opt.Tcw,
        lm_id=torch.where(opt.inliers, res.lm_for_feature, -1),
        n_matches=res.n_matches,
        n_inliers=opt.num_inliers,
    )


def match_stereo_pair(cam: Camera, feats2: FrameFeatures,
                      pair: torch.Tensor) -> FrameFeatures:
    """The left image's features of a batched pair extraction, stereo
    matched against the right image's and refined to sub-pixel ur/depth."""
    fl = FrameFeatures(*(x[0] for x in feats2))
    fr = FrameFeatures(*(x[1] for x in feats2))
    return match_stereo_refined(fl, fr, pair[0], pair[1], bf=cam.bf)


def track_stereo_frame(
    cam: Camera,
    cfg: ExtractorConfig,
    capacity: int,
    pair: torch.Tensor,         # [2,H,W] grayscale stereo pair
    Tcw0: torch.Tensor,         # [4,4] pose prediction
    lm_pos: torch.Tensor,       # [L,3] local-map landmark positions
    lm_normal: torch.Tensor,    # [L,3] viewing normals
    lm_desc: torch.Tensor,      # [L,8] int32 descriptors
    lm_max_dist: torch.Tensor,  # [L] scale-invariance bounds
    lm_min_dist: torch.Tensor,
    lm_valid: torch.Tensor,     # [L]
    th: float = 3.0,
    ratio: float = 0.8,
):
    """The whole per-frame stereo front end: batched ORB extraction of both
    images (ImageProcessing::ProcessStereoImage) -> stereo match + sub-pixel
    refinement (Stereomatcher.cpp:36) -> local-map projection matching
    (FeatureMatcher.cc:123) -> pose-only LM (Optimizer.cc:48).
    Returns (FrontendResult, matched left features)."""
    fl = match_stereo_pair(cam, extract_atlas_batch(pair, cfg, capacity=capacity),
                           pair)
    inv_s2 = feature_inv_sigma2(fl.level, cfg.n_levels, cfg.scale_factor)
    res = project_and_optimize(
        cam, fl, Tcw0, lm_pos, lm_normal, lm_desc, lm_max_dist, lm_min_dist,
        lm_valid, inv_s2, th=th, ratio=ratio,
        n_levels=cfg.n_levels, scale_factor=cfg.scale_factor,
    )
    return res, fl
