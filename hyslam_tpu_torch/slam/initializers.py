"""Map initializers (counterpart of ``hyslam_tpu/slam/initializers.py``;
the stereo initializer; the monocular one is ``slam/mono_init.py``)."""

from __future__ import annotations

import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera, backproject

MIN_STEREO_POINTS = 50  # minimum valid-depth features to initialize


def stereo_initialize(ms: MapState, feats: FrameFeatures, cam: Camera,
                      timestamp: float, frame_id: int, cam_id: int = 0,
                      Tcw0: torch.Tensor | None = None):
    """Initialize a map from one stereo frame: a keyframe at Tcw0 (default
    the origin) and a landmark for every valid-depth feature, protected
    from culling for 5 keyframes (StereoInitializer). Reads two counts back
    to the host. Returns (ms, kf_id, n_landmarks), or (ms, -1, 0) when too
    few features have depth."""
    dev = feats.uv.device
    if int(torch.sum((feats.depth > 0) & feats.valid)) < MIN_STEREO_POINTS:
        return ms, -1, 0
    if Tcw0 is None:
        Tcw0 = se3.identity(device=dev)
    F = feats.capacity
    ms, kf_id = M.add_keyframe(
        ms, feats, Tcw0, timestamp, frame_id, cam_id,
        torch.full((F,), -1, dtype=torch.int32, device=dev), origin=True)
    X = se3.apply(se3.inverse(Tcw0), backproject(cam, feats.uv, feats.depth))
    ms, idx = M.add_landmarks(
        ms, X, feats.desc, kf_id, torch.arange(F, dtype=torch.int32, device=dev),
        feats.valid & (feats.depth > 0), protection=5)
    ms = M.refresh_covisibility(ms)
    ms = M.update_landmark_stats(ms)
    return ms, int(kf_id), int(torch.sum(idx >= 0))
