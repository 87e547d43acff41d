"""Per-state and per-strategy tracking parameter sets and the camera x state
-> named-parameter-set indirection (counterpart of
``hyslam_tpu/slam/tracking_params.py``).

The YAML layout ``resolve_tracking_params`` reads:

    Cameras:    <camera>: {Normal: <set>, Relocalize: <set>, ...}
    States:     <set>:    {thresh_refine: ..., Strategies: {...}}
    Strategies: <set>:    {match_nnratio: ..., ...}

Field names follow the reference YAML keys, whose spellings are accepted."""

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


_STATE_FIELDS = {
    "Normal": ("normal", NormalStateParams),
    "Relocalize": ("relocalize", RelocalizeStateParams),
}
_STRATEGY_FIELDS = {
    "TrackMotionModel": ("motion", MotionModelParams),
    "TrackReferenceKeyFrame": ("ref_kf", ReferenceKFParams),
    "TrackLocalMap": ("local_map", LocalMapParams),
    "TrackPlaceRecognition": ("place_rec", PlaceRecognitionParams),
}

# reference YAML key -> field name, for keys whose spelling differs
_KEY_ALIASES = {
    "N_min_matches": "n_min_matches",
    "N_min_matches_BoW": "n_min_matches_bow",
    "N_min_matches_PoseOpt": "n_min_matches_pnp",
    "N_min_matches_success": "n_min_matches_success",
    # match_radius_threshold / match_radius_threshold_other are resolved by
    # the camera's mono flag in _build (not plain aliases — a stereo camera
    # takes the first, any other camera the "_other" variant; the reference
    # reads both fields per strategy, Tracking_datastructs.h)
    "match_theshold_inflation_factor": "inflation_factor",  # sic (reference)
    "match_threshold_inflation_factor": "inflation_factor",
    "match_nnratio_1": "match_nnratio_1",
    "ORBdist_1": "max_descriptor_dist",
    # N_max_local_keyframes has no analog: the local map is a fixed-capacity
    # landmark arena (local_capacity), not a bounded keyframe list
    # keyframe-policy fields of the Normal state block
    # (slam_tracking_config.yaml Normal_*)
    "N_tracked_target": "n_tracked_target",
    "N_tracked_variance": "n_tracked_variance",
    "min_KF_interval": "min_kf_interval",
    "max_KF_interval": "max_kf_interval",
    "min_N_tracked_close": "min_n_tracked_close",
    "thresh_N_nontracked_close": "thresh_n_nontracked_close",
    "min_frac_refKF_mono": "min_frac_ref_kf_mono",
    "min_frac_refKF_stereo": "min_frac_ref_kf_stereo",
}


def _build(cls, d: dict, is_mono: bool = False):
    d = dict(d or {})
    # the radius pair is camera-kind-resolved, not a plain alias: a stereo
    # camera uses match_radius_threshold (ref default 15), any other camera
    # match_radius_threshold_other (ref default 7) — deterministic
    # regardless of YAML key order
    primary = d.pop("match_radius_threshold", None)
    other = d.pop("match_radius_threshold_other", None)
    pick = other if is_mono else primary
    if pick is None:
        pick = primary if primary is not None else other
    if pick is not None and "match_radius" in cls._fields:
        d["match_radius"] = pick
    out = {}
    for k, v in d.items():
        name = _KEY_ALIASES.get(k, k)
        if name in cls._fields:
            # cast to the declared default's type (int thresholds stay int)
            default = getattr(cls(), name)
            out[name] = type(default)(v)
    return cls(**out)


def resolve_tracking_params(raw: dict, camera: str,
                            is_mono: bool = False) -> TrackingParams:
    """Resolve the Cameras/States/Strategies indirection for one camera
    (the reference's loadStateOptions): look up the camera's named state
    sets, then each state's named strategy sets. Unknown cameras fall back
    to the 'SLAM' row, then to defaults. is_mono picks the stereo/other
    variant of paired radius keys."""
    cams = raw.get("Cameras") or raw.get("cameras") or {}
    states = raw.get("States") or raw.get("states") or {}
    strategies = raw.get("Strategies") or raw.get("strategies") or {}
    cam_row = cams.get(camera) or cams.get("SLAM") or {}

    fields = {}
    for state_name, (field, cls) in _STATE_FIELDS.items():
        set_name = cam_row.get(state_name)
        block = states.get(set_name, {}) if set_name else {}
        fields[field] = _build(cls, block, is_mono)
        if state_name == "Normal":
            # the reference keeps the keyframe-insertion policy fields in
            # the same Normal block (TrackingStateNormal.cpp:87-170)
            fields["policy"] = _build(KeyFramePolicyParams, block)
        for strat_name, strat_set in (block.get("Strategies") or {}).items():
            if strat_name not in _STRATEGY_FIELDS:
                continue
            sfield, scls = _STRATEGY_FIELDS[strat_name]
            fields[sfield] = _build(scls, strategies.get(strat_set, {}),
                                     is_mono)
    return TrackingParams(**fields)
