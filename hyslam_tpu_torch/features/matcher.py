"""Local-map projection matching as dense masked score matrices (counterpart
of ``hyslam_tpu/features/matcher.py``; only the TrackLocalMap path and its
helpers are ported). -1 marks "no match"."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.ops.hamming import hamming_matrix

# copied from hyslam_tpu/features/matcher.py
TH_HIGH = 100
N_LEVELS = 8        # defaults only; per-camera values flow in from
SCALE = 1.2         # ExtractorConfig via the n_levels/scale_factor args
BIG = 1 << 16


def predict_level(dist: torch.Tensor, max_dist: torch.Tensor,
                  n_levels: int = N_LEVELS, scale_factor: float = SCALE):
    """Scale level a landmark would appear at, from its distance and
    max-distance invariance bound (MapPoint::PredictScale analog)."""
    ratio = torch.clamp_min(max_dist / torch.clamp_min(dist, 1e-6), 1e-6)
    # log of the float32 factor, as jnp.log(scale_factor) takes it: a
    # float64 log could move ceil() at a level boundary
    log_s = torch.log(torch.tensor(scale_factor, dtype=torch.float32,
                                   device=dist.device))
    lv = torch.ceil(torch.log(ratio) / log_s)
    return lv.clamp(0, n_levels - 1).to(torch.int32)


def _dedup_feature_side(dist_qf: torch.Tensor, match_q: torch.Tensor,
                        ok_q: torch.Tensor):
    """Resolve feature conflicts: if several queries matched the same
    feature, keep the smallest distance, and on exact ties the first query
    (one landmark per feature). Returns updated ok_q."""
    Q, F = dist_qf.shape
    dev = dist_qf.device
    q_dist = torch.where(
        ok_q, torch.gather(dist_qf, 1, match_q.clamp(0, F - 1)[:, None].long())[:, 0],
        BIG,
    ).long()
    tgt = torch.where(ok_q, match_q, F).long()
    best_per_f = torch.full((F + 1,), BIG, dtype=torch.int64, device=dev
                            ).scatter_reduce(0, tgt, q_dist, "amin")
    keep = ok_q & (q_dist <= best_per_f[tgt])
    qidx = torch.arange(Q, dtype=torch.int64, device=dev)
    first_q = torch.full((F + 1,), Q, dtype=torch.int64, device=dev
                         ).scatter_reduce(0, torch.where(keep, tgt, F), qidx, "amin")
    return keep & (first_q[tgt] == qidx)


class ProjMatchResult(NamedTuple):
    lm_for_feature: torch.Tensor   # [F] int32 landmark-row index (-1 = none)
    n_matches: torch.Tensor        # int32 scalar


def search_by_projection_landmarks(
    cam: Camera,
    frame: FrameFeatures,
    Tcw: torch.Tensor,
    lm_pos: torch.Tensor,       # [Q, 3]
    lm_normal: torch.Tensor,    # [Q, 3]
    lm_desc: torch.Tensor,      # [Q, 8] int32
    lm_max_dist: torch.Tensor,  # [Q]
    lm_min_dist: torch.Tensor,  # [Q]
    lm_valid: torch.Tensor,     # [Q]
    already_matched: torch.Tensor,  # [F] features to skip (have a landmark)
    th: float = 1.0,
    ratio: float = 0.9,
    n_levels: int = N_LEVELS,
    scale_factor: float = SCALE,
) -> ProjMatchResult:
    """Track-local-map matching (_SearchByProjection_ vs a landmark set,
    FeatureMatcher.cc:123 path). Returns the per-feature landmark row.

    Criteria: in-image projection, depth > 0, distance within
    [0.8 min, 1.2 max], viewing angle cos > 0.5, predicted-level window
    radius (2.5 or 4.0) * th * scale(level), level in [pred-1, pred+1],
    best-vs-second ratio on the same level, TH_HIGH gate."""
    pc = se3.apply(Tcw, lm_pos)                                 # [Q, 3]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height) & (z > 0)

    cam_center = se3.translation(se3.inverse(Tcw))
    po = lm_pos - cam_center
    dist = torch.linalg.norm(po, dim=-1)
    dist_ok = (dist >= 0.8 * lm_min_dist) & (dist <= 1.2 * lm_max_dist)
    ncos = torch.sum(po * lm_normal, dim=-1) / torch.clamp_min(
        dist * torch.linalg.norm(lm_normal, dim=-1), 1e-9
    )
    view_ok = ncos > 0.5
    lv = predict_level(dist, lm_max_dist, n_levels, scale_factor)
    r_base = torch.where(ncos > 0.998, 2.5, 4.0)
    radius = r_base * th * scale_factor ** lv.to(torch.float32)  # [Q]

    q_ok = lm_valid & in_img & dist_ok & view_ok

    duv = torch.stack([u, v], -1)[:, None, :] - frame.uv[None, :, :]
    within = torch.sum(duv * duv, dim=-1) <= (radius[:, None] ** 2)
    lvl_ok = (frame.level[None, :] >= lv[:, None] - 1) & (
        frame.level[None, :] <= lv[:, None] + 1
    )
    fmask = frame.valid[None, :] & ~already_matched[None, :]
    ok_qf = q_ok[:, None] & within & lvl_ok & fmask

    # best + second-best via two argmin passes (first index on ties)
    d = torch.where(ok_qf, hamming_matrix(lm_desc, frame.desc), BIG)
    best_i = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_i[:, None])[:, 0]
    Q = d.shape[0]
    qidx = torch.arange(Q, device=d.device)
    d2 = d.clone()
    d2[qidx, best_i] = BIG
    second_i = torch.argmin(d2, dim=1)
    second_d = torch.gather(d2, 1, second_i[:, None])[:, 0]
    best_lv = frame.level[best_i]
    second_lv = frame.level[second_i]
    ratio_ok = (best_lv != second_lv) | (
        best_d.to(torch.float32) <= ratio * second_d.to(torch.float32)
    )
    ok_q = q_ok & (best_d <= TH_HIGH) & ratio_ok
    keep = _dedup_feature_side(d, best_i, ok_q)

    # kept queries own distinct features; the rest write into slot F, which
    # is cut off (the JAX package's .at[].set on an F+1 buffer)
    F_ = frame.capacity
    tgt = torch.where(keep, best_i, F_)
    lm_for_feature = torch.full((F_ + 1,), -1, dtype=torch.int32, device=d.device)
    lm_for_feature[tgt] = qidx.to(torch.int32)
    lm_for_feature = lm_for_feature[:F_]
    return ProjMatchResult(
        lm_for_feature=lm_for_feature,
        n_matches=torch.sum(lm_for_feature >= 0, dtype=torch.int32),
    )
