"""Per-state and per-strategy tracking parameter sets (counterpart of
``hyslam_tpu/slam/tracking_params.py``: the NamedTuples with their
defaults; the YAML resolver ``resolve_tracking_params`` comes with the
config loaders, ROADMAP step 11)."""

from __future__ import annotations

from typing import NamedTuple

from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams


class MotionModelParams(NamedTuple):
    """TrackMotionModel (reference: radius 15 stereo / 7 other, inflation
    2.0, min 20 matches, nnratio 0.9)."""

    n_min_matches: int = 20
    match_nnratio: float = 0.9
    match_radius: float = 7.0        # the matcher's th is a per-level window
    inflation_factor: float = 2.0    # widened retry window multiplier


class ReferenceKFParams(NamedTuple):
    """TrackReferenceKeyFrame (reference: nnratio 0.7, >= 15 BoW matches)."""

    match_nnratio: float = 0.7
    n_min_matches_bow: int = 15
    max_descriptor_dist: int = 50    # TH_LOW


class LocalMapParams(NamedTuple):
    """TrackLocalMap; match_radius multiplies the per-level search window of
    search_by_projection_landmarks."""

    match_nnratio: float = 0.9
    match_radius: float = 1.0
    local_capacity: int = 4096       # landmark harvest arena


class PlaceRecognitionParams(NamedTuple):
    """TrackPlaceRecognition staged relocalization."""

    match_nnratio_1: float = 0.75
    n_min_matches_bow: int = 15
    n_min_matches_pnp: int = 10
    n_min_matches_success: int = 50
    max_descriptor_dist: int = 50
    n_candidates: int = 5


class NormalStateParams(NamedTuple):
    """TrackingStateNormal thresholds."""

    thresh_init: int = 10            # min inliers after initial pose estimate
    thresh_refine: int = 30          # min inliers after TrackLocalMap
    thresh_refine_postreloc: int = 50  # stricter within 30 frames of reloc
    reset_interval: int = -1         # forced-loss fault injection; -1 = off


class RelocalizeStateParams(NamedTuple):
    """TrackingStateRelocalize."""

    thresh_init: int = 50
    thresh_refine: int = 35


class TrackingParams(NamedTuple):
    """The resolved per-camera bundle: one parameter set per state and
    strategy."""

    normal: NormalStateParams = NormalStateParams()
    relocalize: RelocalizeStateParams = RelocalizeStateParams()
    motion: MotionModelParams = MotionModelParams()
    ref_kf: ReferenceKFParams = ReferenceKFParams()
    local_map: LocalMapParams = LocalMapParams()
    place_rec: PlaceRecognitionParams = PlaceRecognitionParams()
    policy: KeyFramePolicyParams = KeyFramePolicyParams()
