"""Monocular two-frame initializer (counterpart of
``hyslam_tpu/slam/mono_init.py``): the two-view estimator of
``estimators.two_view`` adapted to the map state."""

from __future__ import annotations

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.estimators.two_view import two_view_reconstruct
from hyslam_tpu_torch.features.matcher import match_descriptors
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.ops import indexing as ix

MIN_MATCHES = 100  # matches to the reference frame before a two-view attempt


class MonoInitializer:
    """Two-frame protocol: hold a reference frame and try each new frame
    against it; on success make the two keyframes and the triangulated
    landmarks, scaled so that their median depth is 1."""

    def __init__(self, cam: Camera):
        self.cam = cam
        self.ref: FrameFeatures | None = None
        self.ref_ts = 0.0
        self.ref_frame_id = -1

    def _hold(self, feats, timestamp, frame_id):
        self.ref, self.ref_ts, self.ref_frame_id = feats, timestamp, frame_id

    def feed(self, ms, feats, timestamp, frame_id, cam_id):
        """Returns (done, ms, [kf0, kf1] or [])."""
        if self.ref is None:
            self._hold(feats, timestamp, frame_id)
            return False, ms, []
        ref = self.ref
        idx, n = match_descriptors(ref.desc, ref.valid, ref.angle, feats.desc,
                                   feats.valid, feats.angle, max_dist=50, ratio=0.9)
        if int(n) < MIN_MATCHES:
            self._hold(feats, timestamp, frame_id)   # slide the reference forward
            return False, ms, []

        ok, T21, X, inliers = two_view_reconstruct(self.cam, ref.uv, feats.uv, idx)
        if not ok:
            return False, ms, []

        # the monocular scale gauge: median depth 1, taken on the host as the
        # JAX package takes it, so that both maps share it
        Xn, inl_n, T21 = (t.cpu().numpy() for t in (X, inliers, T21))
        z = Xn[inl_n][:, 2]
        med = float(np.median(z[z > 0])) if (z > 0).any() else 1.0
        scale = 1.0 / max(med, 1e-6)
        X = X * scale
        T21 = T21.copy()
        T21[:3, 3] *= scale

        dev = feats.uv.device
        F = feats.uv.shape[0]
        none = torch.full((F,), -1, dtype=torch.int32, device=dev)
        ms, kf0 = M.add_keyframe(ms, ref, se3.identity(device=dev), self.ref_ts,
                                 self.ref_frame_id, cam_id, none, origin=True)
        ms, lm_idx = M.add_landmarks(ms, X, ref.desc, kf0,
                                     torch.arange(F, dtype=torch.int32, device=dev),
                                     inliers, protection=5)
        # the reference frame's slots map to the current frame's through idx
        src_ok = inliers & (idx >= 0)
        tgt = (idx.clamp(0, F - 1).long(),)
        assoc_cur = ix.put(none, ix.route(F, tgt, ix.last_writer((F,), tgt, src_ok)), lm_idx)
        ms, kf1 = M.add_keyframe(ms, feats, torch.from_numpy(T21).to(dev), timestamp,
                                 frame_id, cam_id, assoc_cur)
        ms = M.refresh_covisibility(ms)
        ms = M.update_landmark_stats(ms)
        self.ref = None
        return True, ms, torch.stack([kf0, kf1]).tolist()
