"""FAST-9/16 corner scores, 3x3 non-max suppression and grid-distributed
keypoint selection (counterpart of ``hyslam_tpu/ops/fast.py``; the atlas
extractor selects per level itself, the SURF family through
``select_keypoints``)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hyslam_tpu_torch.ops import indexing as ix

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


def select_keypoints(score: torch.Tensor, n_keypoints: int, cell: int = 32,
                     border: int = 16):
    """Grid-distributed top-N selection from a score map [..., H, W]: a
    per-cell quota by top k inside each ``cell`` x ``cell`` tile, then the
    top N of the pooled candidates; ties go to the lower index, as
    ``lax.top_k``. Returns (uv [..., N, 2] f32 (x, y), kp_score [..., N],
    valid [..., N])."""
    h, w = score.shape[-2:]
    lead = tuple(score.shape[:-2])
    dev = score.device
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    ok = (yy >= border) & (yy < h - border) & (xx >= border) & (xx < w - border)
    s = torch.where(ok, score, 0.0)

    ncy = (h + cell - 1) // cell
    ncx = (w + cell - 1) // cell
    sp = F.pad(s, (0, ncx * cell - w, 0, ncy * cell - h))
    tiles = sp.reshape(lead + (ncy, cell, ncx, cell)).transpose(-3, -2).reshape(
        lead + (ncy * ncx, cell * cell))
    quota = max(1, min(cell * cell, -(-n_keypoints // (ncy * ncx)) + 2))
    top_s, top_i = ix.top_k(tiles, quota)                       # [..., C, q]
    cidx = torch.arange(ncy * ncx, device=dev)
    py = ((cidx // ncx) * cell)[:, None] + top_i // cell
    px = ((cidx % ncx) * cell)[:, None] + top_i % cell

    pool_s = top_s.flatten(-2)
    n_take = min(n_keypoints, pool_s.shape[-1])
    best_s, best_i = ix.top_k(pool_s, n_take)
    uv = torch.stack([torch.gather(px.flatten(-2), -1, best_i).to(torch.float32),
                      torch.gather(py.flatten(-2), -1, best_i).to(torch.float32)], dim=-1)
    valid = best_s > 0
    if n_take < n_keypoints:
        pad = n_keypoints - n_take
        uv = F.pad(uv, (0, 0, 0, pad))
        best_s = F.pad(best_s, (0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, best_s, valid
