"""FAST-9/16 corner scores and 3x3 non-max suppression (counterpart of
``hyslam_tpu/ops/fast.py``; the test-only ``select_keypoints`` is not
ported — the atlas extractor selects per level)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle radius 3 (dy, dx), standard FAST-16 order (clockwise),
# copied from hyslam_tpu/ops/fast.py.
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9  # contiguous run length for FAST-9/16


def _has_run(m: torch.Tensor) -> torch.Tensor:
    """m: int64 with 16 circle flags in bits 0..15. Duplicate for circular
    runs, then AND-shift ARC_LEN-1 times: nonzero iff some 9-run is set.
    int64 keeps the shifts logical (the JAX package uses uint32)."""
    x = m | (m << 16)
    y = x
    for i in range(1, ARC_LEN):
        y = y & (x >> i)
    return y != 0


def fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Per-pixel FAST-9/16 corner score [..., H, W] f32 (0 = not a corner):
    max(total bright excess, total dark excess) over the 16 circle pixels,
    gated by the 9-contiguous-run test. Circle pixels come from wrapping
    rolls, like ``jnp.roll``; the wrapped 3-px border is zeroed."""
    c = img
    excess_b = torch.zeros_like(img)
    excess_d = torch.zeros_like(img)
    m_b = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    m_d = torch.zeros_like(m_b)
    for i, (dy, dx) in enumerate(CIRCLE):
        p = torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(-2, -1))
        db = p - c - threshold
        dd = c - p - threshold
        m_b = m_b | ((db > 0).to(torch.int64) << i)
        m_d = m_d | ((dd > 0).to(torch.int64) << i)
        excess_b = excess_b + torch.clamp_min(db, 0.0)
        excess_d = excess_d + torch.clamp_min(dd, 0.0)

    score = torch.maximum(
        torch.where(_has_run(m_b), excess_b, 0.0),
        torch.where(_has_run(m_d), excess_d, 0.0),
    )
    h, w = img.shape[-2:]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(interior, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep strict local maxima over 3x3 neighbourhoods [..., H, W]; the
    pooling pads with -inf, like ``reduce_window`` with init -inf."""
    s = score.reshape((-1, 1) + tuple(score.shape[-2:]))
    m = F.max_pool2d(s, kernel_size=3, stride=1, padding=1).reshape(score.shape)
    return torch.where(score >= m, score, 0.0)
