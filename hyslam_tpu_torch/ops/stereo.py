"""Rectified stereo feature matching with SAD sub-pixel refinement
(counterpart of ``hyslam_tpu/ops/stereo.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.ops.hamming import hamming_matrix

TH_HIGH = 100  # descriptor distance gate, copied from hyslam_tpu/ops/stereo.py


def match_stereo(
    left: FrameFeatures,
    right: FrameFeatures,
    bf: float,
    min_z: float = 0.1,
    max_disp_slack: float = 2.0,
) -> FrameFeatures:
    """Returns `left` with ur/depth filled for matched features.

    Gates per candidate pair (l, r): rectified row band
    |v_l - v_r| <= 2 * scale(level_l), 0.3 <= disparity <= bf/min_z,
    |level_l - level_r| <= 1, Hamming distance <= TH_HIGH and the best over
    candidates (first index on ties, like ``jnp.argmin``)."""
    d = hamming_matrix(left.desc, right.desc)              # [FL, FR]
    scale_l = 1.2 ** left.level.to(torch.float32)
    row_tol = max_disp_slack * scale_l[:, None]
    dv = torch.abs(left.uv[:, 1:2] - right.uv[None, :, 1])
    disp = left.uv[:, 0:1] - right.uv[None, :, 0]
    max_disp = bf / min_z
    lvl_ok = torch.abs(left.level[:, None] - right.level[None, :]) <= 1
    ok = (
        (dv <= row_tol)
        & (disp >= 0.3)
        & (disp <= max_disp)
        & lvl_ok
        & left.valid[:, None]
        & right.valid[None, :]
    )
    d = torch.where(ok, d, 1 << 16)
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    matched = best_d <= TH_HIGH
    ur = torch.where(matched, right.uv[best, 0], -1.0)
    disp_best = torch.clamp_min(left.uv[:, 0] - ur, 1e-3)
    depth = torch.where(matched, bf / disp_best, -1.0)
    return left._replace(ur=torch.where(matched, ur, -1.0), depth=depth)


_SAD_R = 5      # 11x11 correlation window (reference W=5)
_SEARCH = 4     # +/- shift range around the descriptor match (reference L=5)


def _windows(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor,
             h: int, w: int) -> torch.Tensor:
    """[N, h, w] windows of img [H', W'] with top-left corners (y, x)."""
    W_ = img.shape[1]
    lin = ((y[:, None] + torch.arange(h, device=img.device))[:, :, None] * W_
           + (x[:, None] + torch.arange(w, device=img.device))[:, None, :])
    return img.reshape(-1)[lin]


def refine_subpixel(
    matched: FrameFeatures,
    img_l: torch.Tensor,
    img_r: torch.Tensor,
    bf: float,
) -> FrameFeatures:
    """Sub-pixel disparity refinement by SAD correlation + parabola fit
    (the reference's ComputeStereoMatches sliding-window stage)."""
    uv = matched.uv
    ur0 = matched.ur
    ok = matched.valid & (ur0 > 0)
    x0 = torch.round(uv[:, 0]).to(torch.int64)
    y0 = torch.round(uv[:, 1]).to(torch.int64)
    xr0 = torch.round(ur0).to(torch.int64)

    h, W_ = img_l.shape
    side = 2 * _SAD_R + 1                                # 11
    wide = side + 2 * _SEARCH                            # 19: all 9 shifts

    # edge-pad by the window radius so no window start is clamped (the JAX
    # dynamic_slice starts never clamp either)
    pad_y, pad_xl, pad_xr = _SAD_R, _SAD_R, _SAD_R + _SEARCH
    il_p = F.pad(img_l[None, None], (pad_xl, pad_xl, pad_y, pad_y),
                 mode="replicate")[0, 0]
    ir_p = F.pad(img_r[None, None], (pad_xr, pad_xr, pad_y, pad_y),
                 mode="replicate")[0, 0]

    yc = y0.clamp(0, h - 1)
    patch_l = _windows(il_p, yc, x0.clamp(0, W_ - 1), side, side)  # [N,11,11]
    win_r = _windows(ir_p, yc, xr0.clamp(0, W_ - 1), side, wide)   # [N,11,19]
    # normalize by centre intensity like the reference (IL - IL(centre))
    patch_l = patch_l - patch_l[:, _SAD_R:_SAD_R + 1, _SAD_R:_SAD_R + 1]

    n_sh = 2 * _SEARCH + 1
    # shift s covers columns [s : s+11] of the right window
    patch_r = torch.stack(
        [win_r[:, :, s:s + side] for s in range(n_sh)], dim=1
    )                                                    # [N,9,11,11]
    patch_r = patch_r - patch_r[:, :, _SAD_R:_SAD_R + 1, _SAD_R:_SAD_R + 1]

    sad = torch.sum(torch.abs(patch_r - patch_l[:, None]), dim=(-1, -2))  # [N,9]
    bi = torch.argmin(sad, dim=-1)
    bic = bi.clamp(1, sad.shape[1] - 2)
    c0 = torch.gather(sad, 1, bic[:, None] - 1)[:, 0]
    c1 = torch.gather(sad, 1, bic[:, None])[:, 0]
    c2 = torch.gather(sad, 1, bic[:, None] + 1)[:, 0]
    denom = torch.clamp_min(c0 + c2 - 2.0 * c1, 1e-6)
    delta = torch.clamp(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    ur_ref = xr0.to(torch.float32) + (bic - _SEARCH).to(torch.float32) + delta
    # keep fractional part of the left keypoint column as well
    ur_ref = ur_ref + (uv[:, 0] - x0.to(torch.float32))
    disp = torch.clamp_min(uv[:, 0] - ur_ref, 1e-3)
    good = ok & (disp > 0.2)
    depth = torch.where(good, bf / disp, -1.0)
    return matched._replace(ur=torch.where(good, ur_ref, -1.0), depth=depth)


def match_stereo_refined(left, right, img_l, img_r, bf, min_z=0.1):
    """Descriptor matching + SAD sub-pixel refinement (the full reference
    stereo path)."""
    m = match_stereo(left, right, bf=bf, min_z=min_z)
    return refine_subpixel(m, img_l, img_r, bf=bf)
