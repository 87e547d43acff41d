"""The matching engine as dense masked score matrices (counterpart of
``hyslam_tpu/features/matcher.py``): projection search against a landmark
set or the last frame, descriptor matching, and the epipolar search for
triangulation. -1 marks "no match"; ties go to the first index everywhere,
as ``jnp.argmin`` and ``lax.top_k`` break them."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.geometry import se3, so3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.ops.hamming import hamming_matrix
from hyslam_tpu_torch.ops.indexing import top_k

# copied from hyslam_tpu/features/matcher.py
TH_HIGH = 100
TH_LOW = 50
HISTO_BINS = 30
# 2 pi as the float32 the JAX package's weak-typed constant becomes, and its
# float32 reciprocal: XLA turns a division by a constant into this product
_TWO_PI = float(np.float32(2.0 * np.pi))
_INV_TWO_PI = float(np.float32(1.0) / np.float32(2.0 * np.pi))
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


def rotation_consistency(delta_angle: torch.Tensor, matched: torch.Tensor):
    """Keep only matches whose orientation change falls in the 3 dominant
    bins of a 30-bin histogram (2nd and 3rd dropped below 10% of the 1st).
    The angle is wrapped as ``jnp.mod`` does: an exact fmod, then + 2 pi
    where negative; the bin is taken from the same float32 product XLA
    computes, so no match changes bin at a boundary."""
    r = torch.fmod(delta_angle, _TWO_PI)
    frac = torch.where(r < 0, r + _TWO_PI, r) * _INV_TWO_PI
    bins = (frac * HISTO_BINS).to(torch.int32).clamp(0, HISTO_BINS - 1).long()
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=bins.device
                       ).index_add(0, bins, matched.to(torch.int32))
    top3_v, top3_i = top_k(hist, 3)
    keep_k = top3_v.to(torch.float32) >= 0.1 * top3_v[0].to(torch.float32)
    good_bins = torch.zeros(HISTO_BINS, dtype=torch.bool, device=bins.device
                            ).index_put((top3_i,), keep_k & (top3_v > 0))
    return matched & good_bins[bins]


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


def search_by_projection_frame(
    cam: Camera,
    cur: FrameFeatures,
    Tcw_pred: torch.Tensor,
    last: FrameFeatures,
    last_lm_id: torch.Tensor,     # [F] landmark ids of the last frame
    last_lm_pos: torch.Tensor,    # [F, 3] world positions for those ids
    th: float = 1.0,
    n_levels: int = N_LEVELS,
    scale_factor: float = SCALE,
):
    """Motion-model matching against the last frame (FeatureMatcher.cc:145
    path): project the last frame's landmarks with the predicted pose,
    window-search by level, rotation-consistency filter. Returns ([F_cur]
    landmark ids, count)."""
    del n_levels
    has_lm = (last_lm_id >= 0) & last.valid
    pc = se3.apply(Tcw_pred, last_lm_pos)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height) & (z > 0)
    q_ok = has_lm & in_img

    lv = last.level
    radius = th * scale_factor ** lv.to(torch.float32)
    duv = torch.stack([u, v], -1)[:, None, :] - cur.uv[None, :, :]
    within = torch.sum(duv * duv, dim=-1) <= (radius[:, None] ** 2)
    lvl_ok = (cur.level[None, :] >= lv[:, None] - 1) & (cur.level[None, :] <= lv[:, None] + 1)
    ok_qf = q_ok[:, None] & within & lvl_ok & cur.valid[None, :]

    d = torch.where(ok_qf, hamming_matrix(last.desc, cur.desc), BIG)
    best_i = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_i[:, None])[:, 0]
    ok_q = q_ok & (best_d <= TH_HIGH)
    ok_q = rotation_consistency(cur.angle[best_i] - last.angle, ok_q)
    keep = _dedup_feature_side(d, best_i, ok_q)

    F_ = cur.capacity
    lm_ids = torch.full((F_ + 1,), -1, dtype=torch.int32, device=d.device)
    lm_ids[torch.where(keep, best_i, F_)] = last_lm_id.to(torch.int32)
    lm_ids = lm_ids[:F_]
    return lm_ids, torch.sum(lm_ids >= 0, dtype=torch.int32)


def match_descriptors(
    desc_a: torch.Tensor, valid_a: torch.Tensor, angle_a: torch.Tensor,
    desc_b: torch.Tensor, valid_b: torch.Tensor, angle_b: torch.Tensor,
    max_dist: int = TH_LOW, ratio: float = 0.75, check_rotation: bool = True,
):
    """Descriptor matching A -> B with ratio and rotation tests (the
    SearchByBoW analog, dense). Returns ([A] index into B or -1, count)."""
    ok_ab = valid_a[:, None] & valid_b[None, :]
    d = torch.where(ok_ab, hamming_matrix(desc_a, desc_b), BIG)
    best_i = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_i[:, None])[:, 0]
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), best_i] = BIG
    second_d = torch.amin(d2, dim=1)
    ok = valid_a & (best_d <= max_dist) & (
        best_d.to(torch.float32) <= ratio * second_d.to(torch.float32))
    if check_rotation:
        ok = rotation_consistency(angle_b[best_i] - angle_a, ok)
    keep = _dedup_feature_side(d, best_i, ok)
    out = torch.where(keep, best_i, -1).to(torch.int32)
    return out, torch.sum(out >= 0, dtype=torch.int32)


def fundamental_from_poses(cam1: Camera, Tcw1: torch.Tensor,
                           cam2: Camera, Tcw2: torch.Tensor) -> torch.Tensor:
    """Fundamental matrix mapping image-1 points to image-2 epilines,
    F = K2^-T [t21]x R21 K1^-1 with (R21, t21) = Tcw2 @ Tcw1^-1; the
    intrinsics are inverted in closed form."""
    T21 = Tcw2 @ se3.inverse(Tcw1)
    dev = Tcw1.device
    K1i = cam1.K_inv(device=dev)
    K2i = cam2.K_inv(device=dev)
    return K2i.T @ so3.hat(T21[:3, 3]) @ T21[:3, :3] @ K1i


def search_for_triangulation(
    cam: Camera,
    f1: FrameFeatures,
    f2: FrameFeatures,
    unmatched1: torch.Tensor,   # [F] bool: feature has no landmark yet
    unmatched2: torch.Tensor,
    F12: torch.Tensor,          # [3, 3] fundamental matrix kf1 -> kf2
    epi_sigma: float = 1.0,
    scale_factor: float = SCALE,
):
    """Epipolar-constrained matching of unmatched features between two
    keyframes (SearchForTriangulation, FeatureMatcher.cc:373): Hamming
    TH_LOW, point-to-epiline chi2 gate (3.84 sigma^2 at the candidate's
    level) and rotation consistency. Returns ([F1] index into f2, count)."""
    del cam
    dev = f1.uv.device
    x1 = torch.cat([f1.uv, torch.ones((f1.capacity, 1), device=dev)], dim=-1)
    l2 = x1 @ F12.T
    x2 = torch.cat([f2.uv, torch.ones((f2.capacity, 1), device=dev)], dim=-1)
    num = torch.abs(l2 @ x2.T)
    den = torch.sqrt(l2[:, 0] ** 2 + l2[:, 1] ** 2)[:, None]
    epi_d2 = (num / torch.clamp_min(den, 1e-9)) ** 2
    sigma2 = epi_sigma * scale_factor ** (2.0 * f2.level.to(torch.float32))
    epi_ok = epi_d2 < 3.84 * sigma2[None, :]
    ok_ab = (f1.valid & unmatched1)[:, None] & (f2.valid & unmatched2)[None, :] & epi_ok
    d = torch.where(ok_ab, hamming_matrix(f1.desc, f2.desc), BIG)
    best_i = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best_i[:, None])[:, 0]
    ok = (f1.valid & unmatched1) & (best_d <= TH_LOW)
    ok = rotation_consistency(f2.angle[best_i] - f1.angle, ok)
    keep = _dedup_feature_side(d, best_i, ok)
    out = torch.where(keep, best_i, -1).to(torch.int32)
    return out, torch.sum(out >= 0, dtype=torch.int32)
