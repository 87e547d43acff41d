"""Annotated current-frame rendering (src/viz/FrameDrawer.{h,cc} parity;
counterpart of ``hyslam_tpu/viz/frame_drawer.py``, numpy on the host).

The reference FrameDrawer keeps a copy of the latest tracked frame and
draws, per feature: a green box+dot for features matched to a map landmark,
blue for features tracked against the visual-odometry points, nothing for
unmatched features; during initialization it draws match lines; a status
text bar at the bottom reports state, keyframe/landmark counts and match
count (FrameDrawer.h:25-78). Same artifact here, as a numpy RGB image.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from hyslam_tpu_torch.viz import draw2d

GREEN = (64, 220, 64)
BLUE = (80, 120, 255)
GRAY = (128, 128, 128)
WHITE = (235, 235, 235)
BAR_H = 22


def draw_frame(
    img,
    uv,
    feat_valid,
    lm_id=None,
    state: str = "",
    n_kfs: int = 0,
    n_landmarks: int = 0,
    init_uv_ref=None,
    init_matches=None,
) -> np.ndarray:
    """Render one annotated frame.

    img: [H,W] grayscale (float or uint8) or [H,W,3]
    uv: [F,2] feature pixel positions; feat_valid: [F] bool
    lm_id: [F] matched landmark row per feature (-1 = unmatched) or None
    init_uv_ref / init_matches: during initialization, the reference
      frame's keypoints and the per-feature match index (-1 = none) —
      drawn as match lines like FrameDrawer::DrawFrame's INITIALIZATION
      branch.
    Returns [H+BAR_H, W, 3] uint8.
    """
    img = draw2d.to_numpy(img)
    if img.ndim == 3 and img.shape[-1] == 3:
        rgb = img.astype(np.uint8)
    else:
        g = img.astype(np.float32)
        if g.max() <= 1.5:
            g = g * 255.0
        rgb = np.repeat(g.astype(np.uint8)[..., None], 3, axis=-1)
    h, w = rgb.shape[:2]
    out = draw2d.blank(h + BAR_H, w, (25, 25, 25))
    out[:h] = rgb

    uv = draw2d.to_numpy(uv)
    valid = draw2d.to_numpy(feat_valid).astype(bool)
    n_matches = 0
    if init_uv_ref is not None and init_matches is not None:
        ref = draw2d.to_numpy(init_uv_ref)
        m = draw2d.to_numpy(init_matches)
        ok = valid & (m >= 0)
        draw2d.draw_segments(out, ref[np.clip(m, 0, len(ref) - 1)], uv,
                             GREEN, mask=ok)
        draw2d.draw_points(out, uv, GREEN, radius=1, mask=ok)
        n_matches = int(ok.sum())
    elif lm_id is not None:
        lm = draw2d.to_numpy(lm_id)
        matched = valid & (lm >= 0)
        unmatched = valid & (lm < 0)
        draw2d.draw_points(out, uv, GRAY, radius=0, mask=unmatched)
        draw2d.draw_points(out, uv, GREEN, radius=1, mask=matched)
        n_matches = int(matched.sum())
    else:
        draw2d.draw_points(out, uv, BLUE, radius=1, mask=valid)

    txt = (f"{state or 'SLAM'} | KFS: {n_kfs}  MPS: {n_landmarks}  "
           f"MATCHES: {n_matches}")
    draw2d.draw_text(out, txt, 6, h + 7, WHITE)
    return out


@dataclass
class FrameDrawer:
    """Stateful per-camera drawer mirroring the reference's update/draw
    split (Tracking thread updates it, Viewer thread draws it)."""

    name: str = "SLAM"
    _last: dict = field(default_factory=dict)

    def update(self, img, uv, feat_valid, lm_id, state: str,
               n_kfs: int, n_landmarks: int) -> None:
        self._last = dict(
            img=draw2d.to_numpy(img), uv=draw2d.to_numpy(uv),
            feat_valid=draw2d.to_numpy(feat_valid), lm_id=draw2d.to_numpy(lm_id),
            state=state, n_kfs=n_kfs, n_landmarks=n_landmarks,
        )

    def draw(self) -> np.ndarray | None:
        if not self._last:
            return None
        return draw_frame(**self._last)
