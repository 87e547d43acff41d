"""Mapping jobs: new-keyframe integration, landmark culling, triangulation,
fusion, local BA, keyframe culling (counterpart of
``hyslam_tpu/slam/mapper.py``, without the pose-prior path of local BA,
which is ROADMAP step 16).

Each job is a batched pass over the map arenas; ``Mapper.integrate_keyframe``
sequences them as the reference's SetupMandatoryJobs -> SetupOptionalJobs.
The JAX package runs triangulation over the neighbours and fusion over the
targets as ``lax.scan``s; here they are Python loops, sequential because
each step reads the map the step before wrote. A masked-off neighbour or
target is a no-op in the scan, and is skipped here: the mask is read to the
host once per job, which the mapper (unlike the strategies) may do.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.frame import feature_inv_sigma2
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.features.matcher import (
    fundamental_from_poses,
    search_by_projection_landmarks,
    search_for_triangulation,
)
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera, backproject
from hyslam_tpu_torch.geometry.triangulation import projection_matrix, triangulate_dlt
from hyslam_tpu_torch.ops import indexing as ix
from hyslam_tpu_torch.solver.ba import BAObservations, BAProblem, CamArrays, local_ba_two_phase


class MapperParams(NamedTuple):
    """Defaults = config/slam_mapping_config.yaml values."""

    min_lm_obs_mono: int = 2
    min_lm_obs_stereo: int = 3
    kf_grace_period: int = 3
    orphan_age: int = 0   # >0: cull landmarks that lost all observations
                          # once older than this many keyframes
    triang_nn_stereo: int = 10
    triang_nn_mono: int = 15
    triang_ratio_factor: float = 1.8
    triang_min_baseline_depth_ratio: float = 0.010
    triang_err_mono: float = 5.5
    triang_err_stereo: float = 7.8
    fuse_nn: int = 10
    fuse_second_nn: int = 5
    kfcull_obs_thresh: int = 3
    kfcull_frac_redundant: float = 0.85


# ---------------------------------------------------------------------------
# LandMarkCuller (mandatory job)
# ---------------------------------------------------------------------------

def cull_landmarks(ms: MapState, cur_kf_id, params: MapperParams,
                   is_mono: bool = False) -> MapState:
    """LandMarkCuller::run: recent landmarks lose one protection tick per
    keyframe; once unprotected, those still under-observed after the grace
    period are erased. Freed rows tick toward recycling."""
    thresh = params.min_lm_obs_mono if is_mono else params.min_lm_obs_stereo
    lm = ms.lm
    recent = lm.valid & ~lm.bad & (lm.first_kf >= 0)
    age = cur_kf_id - lm.first_kf
    in_review = recent & (age <= params.kf_grace_period + 1)
    prot = torch.where(in_review & (lm.protection > 0), lm.protection - 1, lm.protection)
    prot = torch.where(lm.bad & (lm.protection > 0), lm.protection - 1, prot)
    cull = (recent & (prot == 0) & (age >= params.kf_grace_period)
            & (age <= params.kf_grace_period + 1) & (lm.n_obs <= thresh))
    orphan = (lm.valid & ~lm.bad & (lm.n_obs == 0) & (age > params.orphan_age)
              & (params.orphan_age > 0))
    ms = ms._replace(lm=lm._replace(protection=prot))
    return M.set_landmarks_bad(ms, cull | orphan)


# ---------------------------------------------------------------------------
# LandMarkTriangulator (optional job)
# ---------------------------------------------------------------------------

def _scene_median_depth(ms: MapState, k, cam: Camera):
    """Median depth of keyframe k's landmarks (monocular baseline gate)."""
    lm_id = ix.take(ms.kf.lm_id, k)
    z = se3.apply(ix.take(ms.kf.Tcw, k), ms.lm.pos[lm_id.clamp(0, ms.L - 1).long()])[..., 2]
    return torch.nanmedian(torch.where(lm_id >= 0, z, float("nan")))


def _triangulate_pair(ms: MapState, k1, k2, cam: Camera, cam2: Camera,
                      params: MapperParams, scale_factor: float = 1.2):
    """Triangulate new landmarks between keyframes k1 (new) and k2
    (covisible neighbour): epipolar match of unmatched features, parallax
    arbitration between DLT and stereo unprojection, depth / reprojection /
    scale gates (LandMarkTriangulator.cpp:17-201). Returns (ms, n_new)."""
    F = ms.F
    dev = ms.kf.Tcw.device
    f1 = M.kf_features(ms, k1)
    f2 = M.kf_features(ms, k2)
    T1 = ix.take(ms.kf.Tcw, k1)
    T2 = ix.take(ms.kf.Tcw, k2)
    F12 = fundamental_from_poses(cam, T1, cam2, T2)
    un1 = ix.take(ms.kf.lm_id, k1) < 0
    un2 = ix.take(ms.kf.lm_id, k2) < 0
    idx2, _ = search_for_triangulation(cam, f1, f2, un1, un2, F12,
                                       scale_factor=scale_factor)
    ok = idx2 >= 0
    i2 = idx2.clamp(0, F - 1).long()

    C1 = -torch.einsum("ji,j->i", T1[:3, :3], T1[:3, 3])
    C2 = -torch.einsum("ji,j->i", T2[:3, :3], T2[:3, 3])
    bl = torch.linalg.norm(C2 - C1)

    def backproject_ray(T, camx, uv):
        d = torch.stack([(uv[:, 0] - camx.cx) / camx.fx, (uv[:, 1] - camx.cy) / camx.fy,
                         torch.ones(uv.shape[0], device=dev)], dim=-1)
        return torch.einsum("ji,nj->ni", T[:3, :3], d)

    uv2, ur2, depth2, level2 = f2.uv[i2], f2.ur[i2], f2.depth[i2], f2.level[i2]
    ray1 = backproject_ray(T1, cam, f1.uv)
    ray2 = backproject_ray(T2, cam2, uv2)
    cos_par = torch.sum(ray1 * ray2, -1) / torch.clamp_min(
        torch.linalg.norm(ray1, dim=-1) * torch.linalg.norm(ray2, dim=-1), 1e-9)
    st1 = f1.ur > 0
    st2 = ur2 > 0
    cos_st1 = torch.where(st1, torch.cos(2.0 * torch.atan2(
        torch.full_like(f1.depth, cam.baseline / 2.0), torch.clamp_min(f1.depth, 1e-6))),
        cos_par + 1.0)
    cos_st2 = torch.where(st2, torch.cos(2.0 * torch.atan2(
        torch.full_like(depth2, cam2.baseline / 2.0), torch.clamp_min(depth2, 1e-6))),
        cos_par + 1.0)
    cos_stereo = torch.minimum(cos_st1, cos_st2)

    P1 = projection_matrix(cam.K(device=dev), T1)
    P2 = projection_matrix(cam2.K(device=dev), T2)
    X_dlt = triangulate_dlt(P1.expand(F, 3, 4), P2.expand(F, 3, 4), f1.uv, uv2)
    X_st1 = se3.apply(se3.inverse(T1), backproject(cam, f1.uv, f1.depth))
    X_st2 = se3.apply(se3.inverse(T2), backproject(cam2, uv2, depth2))

    use_dlt = (cos_par < cos_stereo) & (cos_par > 0) & (st1 | st2 | (cos_par < 0.9998))
    use_st1 = ~use_dlt & st1 & (cos_st1 < cos_st2)
    use_st2 = ~use_dlt & st2 & ~use_st1
    X = torch.where(use_dlt[:, None], X_dlt, torch.where(use_st1[:, None], X_st1, X_st2))
    ok = ok & (use_dlt | use_st1 | use_st2)

    pc1 = se3.apply(T1, X)
    pc2 = se3.apply(T2, X)
    ok = ok & (pc1[:, 2] > 0) & (pc2[:, 2] > 0)

    def reproj_err2(camx, pc, uv):
        zs = torch.clamp_min(pc[:, 2], 1e-9)
        u = camx.fx * pc[:, 0] / zs + camx.cx
        v = camx.fy * pc[:, 1] / zs + camx.cy
        return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

    sig1 = scale_factor ** (2.0 * f1.level.to(torch.float32))
    sig2 = scale_factor ** (2.0 * level2.to(torch.float32))
    th1 = torch.where(st1, params.triang_err_stereo, params.triang_err_mono) * sig1
    th2 = torch.where(st2, params.triang_err_stereo, params.triang_err_mono) * sig2
    ok = ok & (reproj_err2(cam, pc1, f1.uv) <= th1) & (reproj_err2(cam2, pc2, uv2) <= th2)

    d1 = torch.linalg.norm(X - C1, dim=-1)
    d2 = torch.linalg.norm(X - C2, dim=-1)
    ratio_dist = d2 / torch.clamp_min(d1, 1e-9)
    ratio_size = scale_factor ** (f1.level - level2).to(torch.float32)
    rf = params.triang_ratio_factor
    ok = ok & (ratio_dist * rf >= ratio_size) & (ratio_dist <= ratio_size * rf)
    ok = ok & (d1 > 1e-6) & (d2 > 1e-6) & (bl > 1e-9)

    ms, new_idx = M.add_landmarks(ms, X, f1.desc, k1,
                                  torch.arange(F, dtype=torch.int32, device=dev), ok,
                                  protection=3)
    ms = M.add_associations(ms, k2, i2.to(torch.int32), new_idx, ok)
    return ms, torch.sum(ok, dtype=torch.int32)


def triangulate_new_landmarks(ms: MapState, kf_id: int, cam: Camera,
                              params: MapperParams, is_mono: bool = False,
                              scale_factor: float = 1.2):
    """Triangulate against the best covisible neighbours with enough
    baseline, one neighbour after another. Returns (ms, n_new)."""
    nn = params.triang_nn_mono if is_mono else params.triang_nn_stereo
    ids, _ = M.covis_neighbors(ms, kf_id, nn, min_weight=1)
    centers = M.camera_centers(ms)
    idc = ids.clamp(0, ms.K - 1)
    baseline = torch.linalg.norm(centers[idc] - ix.take(centers, kf_id), dim=-1)
    if is_mono:
        meds = torch.stack([_scene_median_depth(ms, k2, cam) for k2 in idc])
        gate = torch.isfinite(meds) & (
            baseline / torch.clamp_min(meds, 1e-9) >= params.triang_min_baseline_depth_ratio)
    else:
        gate = baseline >= cam.baseline
    n_total = torch.zeros((), dtype=torch.int32, device=ids.device)
    for k2 in idc[(ids >= 0) & gate].tolist():
        ms, n = _triangulate_pair(ms, kf_id, k2, cam, cam, params,
                                  scale_factor=scale_factor)
        n_total = n_total + n
    return ms, n_total


# ---------------------------------------------------------------------------
# LandMarkFuser (optional job)
# ---------------------------------------------------------------------------

def _fuse_into_kf(ms: MapState, k: int, lm_rows: torch.Tensor, cam: Camera,
                  th: float = 3.0, n_levels: int = 8, scale_factor: float = 1.2):
    """Project candidate landmarks [N] into keyframe k; a matched feature
    either gains an association or makes the worse-observed of two
    landmarks replaced by the better one (FeatureMatcher::Fuse +
    Map::replaceMapPoint). Returns (ms, n_replaced, n_added)."""
    f = M.kf_features(ms, k)
    N = lm_rows.shape[0]
    L = ms.L
    lmc = lm_rows.clamp(0, L - 1).long()
    valid = (lm_rows >= 0) & ms.lm.valid[lmc] & ~ms.lm.bad[lmc]
    res = search_by_projection_landmarks(
        cam, f, ix.take(ms.kf.Tcw, k), ms.lm.pos[lmc], ms.lm.normal[lmc],
        ms.lm.desc[lmc], ms.lm.max_dist[lmc], ms.lm.min_dist[lmc], valid,
        already_matched=torch.zeros(ms.F, dtype=torch.bool, device=lmc.device),
        th=th, ratio=1.0, n_levels=n_levels, scale_factor=scale_factor)
    feat_rows = res.lm_for_feature
    cand = torch.where(feat_rows >= 0, lm_rows[feat_rows.clamp(0, N - 1).long()], -1)
    existing = ix.take(ms.kf.lm_id, k)
    both = (cand >= 0) & (existing >= 0) & (cand != existing)
    add_new = (cand >= 0) & (existing < 0)
    n_cand = ms.lm.n_obs[cand.clamp(0, L - 1).long()]
    n_exist = ms.lm.n_obs[existing.clamp(0, L - 1).long()]
    src = torch.where(n_cand > n_exist, existing, cand)
    dst = torch.where(n_cand > n_exist, cand, existing)
    ms = M.replace_landmarks(ms, src, dst, both)
    ms = M.add_associations(ms, k, torch.arange(ms.F, dtype=torch.int32, device=lmc.device),
                            cand, add_new)
    return ms, torch.sum(both, dtype=torch.int32), torch.sum(add_new, dtype=torch.int32)


MAX_FUSE_TARGETS = 16   # cap on the deduped 1st+2nd-degree target set


def fuse_landmarks(ms: MapState, kf_id: int, cam: Camera, params: MapperParams,
                   n_levels: int = 8, scale_factor: float = 1.2):
    """LandMarkFuser::run: fuse this keyframe's landmarks into its 1st+2nd
    degree covisibility neighbourhood (at most MAX_FUSE_TARGETS targets,
    ordered by covisibility weight) and the 1st-degree neighbours'
    landmarks into it. Returns (ms, n_replaced, n_added)."""
    K = ms.K
    dev = ms.covis.device
    ids, _ = M.covis_neighbors(ms, kf_id, params.fuse_nn, min_weight=1)
    ok1 = ids >= 0
    idc = ids.clamp(0, K - 1)
    kf_ok = ms.kf.valid & ~ms.kf.bad
    w2 = torch.where(kf_ok[None, :], ms.covis[idc], 0) * ok1[:, None]
    top_w2, sec = ix.top_k(w2, params.fuse_second_nn)          # [n1, n2]
    sec_ok = (top_w2 > 0) & (sec != kf_id)
    true = torch.ones((), dtype=torch.bool, device=dev)
    tmask = torch.zeros(K + 1, dtype=torch.bool, device=dev)
    tmask = tmask.index_put((torch.where(ok1, idc, K),), true)
    tmask = tmask.index_put((torch.where(sec_ok, sec, K).reshape(-1),), true)[:K].clone()
    tmask[kf_id] = False
    prio = torch.where(tmask, ix.take(ms.covis, kf_id) + 1, 0)
    prio_w, targets = ix.top_k(prio, min(MAX_FUSE_TARGETS, K))
    first_deg = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_put(
        (torch.where(ok1, idc, K),), true)[:K]
    t_ok = (prio_w > 0).tolist()
    t_first = first_deg[targets].tolist()
    targets = targets.tolist()

    own = ix.take(ms.kf.lm_id, kf_id)
    n_rep = torch.zeros((), dtype=torch.int32, device=dev)
    n_add = n_rep
    for t, en in zip(targets, t_ok):
        if en:
            ms, r, a = _fuse_into_kf(ms, t, own, cam, n_levels=n_levels,
                                     scale_factor=scale_factor)
            n_rep, n_add = n_rep + r, n_add + a
    for t, en, first in zip(targets, t_ok, t_first):
        if en and first:
            ms, r, a = _fuse_into_kf(ms, kf_id, ms.kf.lm_id[t], cam, n_levels=n_levels,
                                     scale_factor=scale_factor)
            n_rep, n_add = n_rep + r, n_add + a
    ms = M.update_landmark_stats(ms)
    ms = M.refresh_covisibility(ms)
    return ms, n_rep, n_add


# ---------------------------------------------------------------------------
# LocalBundleAdjustmentJob (optional)
# ---------------------------------------------------------------------------

def _gather_local_ba(ms: MapState, kf_id: int, cam: Camera, max_local_kf: int = 32,
                     max_lm: int = 4096, n_levels: int = 8, scale_factor: float = 1.2):
    """Assemble a BAProblem for the covisibility neighbourhood of kf_id:
    local keyframes (1-hop covisible + self, self first), their landmarks,
    and their other observers as fixed keyframes. Returns (problem,
    kf_of_slot, slot_used, slot_movable, lm_rows, lm_ok)."""
    K, L, F = ms.K, ms.L, ms.F
    dev = ms.covis.device
    true = torch.ones((), dtype=torch.bool, device=dev)
    w = ms.covis[kf_id] * (ms.kf.valid & ~ms.kf.bad).to(torch.int32)
    w[kf_id] = 1 << 20                      # self first (w is a new tensor)
    top_w, local_ids = ix.top_k(w, max_local_kf)
    local_ok = top_w > 0
    is_local = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_put(
        (torch.where(local_ok, local_ids, K),), true)[:K]

    src = torch.where(is_local[:, None] & (ms.kf.lm_id >= 0),
                      ms.kf.lm_id.clamp(0, L - 1).long(), L)
    lm_hit = torch.zeros(L + 1, dtype=torch.bool, device=dev).index_put(
        (src.reshape(-1),), true)[:L] & ms.lm.valid & ~ms.lm.bad
    _, lm_rows = ix.top_k(lm_hit.to(torch.int32), max_lm)
    lm_ok = lm_hit[lm_rows]

    obs_kfc = ms.lm.obs_kf[lm_rows].clamp(0, K - 1).long()     # [max_lm, O]
    obs_ok = ms.lm.obs_valid[lm_rows] & lm_ok[:, None]
    observer = torch.zeros(K + 1, dtype=torch.bool, device=dev).index_put(
        (torch.where(obs_ok, obs_kfc, K).reshape(-1),), true)[:K]
    fixed_global = observer & ~is_local & ms.kf.valid & ~ms.kf.bad

    # local keyframes take slots [0, max_local_kf), fixed observers follow
    slot_of = torch.full((K + 1,), -1, dtype=torch.int32, device=dev).index_put(
        (torch.where(local_ok, local_ids, K),),
        torch.arange(max_local_kf, dtype=torch.int32, device=dev))[:K]
    n_fix_cap = max_local_kf
    fix_rank = torch.cumsum(fixed_global.to(torch.int32), 0) - 1
    fix_slot = torch.where(fixed_global & (fix_rank < n_fix_cap), max_local_kf + fix_rank, -1)
    slot_of = torch.where(fix_slot >= 0, fix_slot, slot_of)

    KL = max_local_kf + n_fix_cap
    kf_of_slot = torch.zeros(KL + 1, dtype=torch.int32, device=dev)
    kf_of_slot[:max_local_kf] = local_ids.clamp(0, K - 1).to(torch.int32)
    kf_of_slot = kf_of_slot.index_put(
        (torch.where(fix_slot >= 0, fix_slot, KL).long(),),
        torch.arange(K, dtype=torch.int32, device=dev))[:KL]
    slot_idx = torch.arange(KL, device=dev)
    slot_used = torch.zeros(KL + 1, dtype=torch.bool, device=dev).index_put(
        (torch.where(local_ok, slot_idx[:max_local_kf], KL),), true)
    slot_used = slot_used.index_put((torch.where(fix_slot >= 0, fix_slot, KL).long(),),
                                    true)[:KL]
    slot_fixed = (slot_idx >= max_local_kf) | ms.kf.origin[kf_of_slot.long()]

    obs_slot_kf = torch.where(obs_ok, slot_of[obs_kfc], -1)
    obs_feat = ms.lm.obs_feat[lm_rows].clamp(0, F - 1).long()
    obs_valid = obs_ok & (obs_slot_kf >= 0)
    uv = ms.kf.uv[obs_kfc, obs_feat]
    ur = ms.kf.ur[obs_kfc, obs_feat]
    inv_s2 = feature_inv_sigma2(ms.kf.level[obs_kfc, obs_feat], n_levels, scale_factor)

    def per_slot(v):
        return torch.full((KL,), v, dtype=torch.float32, device=dev)

    prob = BAProblem(
        kf_Tcw=ms.kf.Tcw[kf_of_slot.long()],
        kf_fixed=slot_fixed | ~slot_used,
        cams=CamArrays(fx=per_slot(cam.fx), fy=per_slot(cam.fy), cx=per_slot(cam.cx),
                       cy=per_slot(cam.cy), bf=per_slot(cam.bf)),
        lm_pos=ms.lm.pos[lm_rows],
        lm_valid=lm_ok,
        obs=BAObservations(
            kf=obs_slot_kf.clamp(0, KL - 1), uv=uv, ur=torch.where(ur > 0, ur, 0.0),
            inv_sigma2=inv_s2, stereo=(ur > 0) & obs_valid, valid=obs_valid),
    )
    return prob, kf_of_slot, slot_used, slot_used & ~slot_fixed, lm_rows, lm_ok


def _scatter_ba_results(ms: MapState, kf_of_slot, slot_movable, lm_rows, lm_ok,
                        kf_Tcw_new, lm_pos_new) -> MapState:
    """Write the movable slots' poses and the valid landmarks back."""
    K, L = ms.K, ms.L
    Tcw = ix.put(ms.kf.Tcw, ix.route(K, (kf_of_slot.clamp(0, K - 1),), slot_movable),
                 kf_Tcw_new)
    pos = ix.put(ms.lm.pos, ix.route(L, (lm_rows.clamp(0, L - 1),), lm_ok), lm_pos_new)
    return ms._replace(kf=ms.kf._replace(Tcw=Tcw), lm=ms.lm._replace(pos=pos))


def _local_ba_noprior(ms: MapState, kf_id: int, cam: Camera, max_local_kf: int,
                      max_lm: int, n_levels: int, scale_factor: float):
    """The whole local-BA job without pose priors: gather, two-phase BA,
    scatter, outlier erasure and stats. Returns (ms, cost)."""
    prob, kf_of_slot, _, slot_movable, lm_rows, lm_ok = _gather_local_ba(
        ms, kf_id, cam, max_local_kf, max_lm, n_levels, scale_factor)
    res = local_ba_two_phase(prob, chunk=256)
    ms = _scatter_ba_results(ms, kf_of_slot, slot_movable, lm_rows, lm_ok,
                             res.kf_Tcw, res.lm_pos)
    out = prob.obs.valid & ~res.obs_inlier                    # [max_lm, O]
    slots = torch.arange(ms.O, device=out.device)[None, :].expand(out.shape)
    ms = M.erase_observations(ms, lm_rows[:, None].expand(out.shape).reshape(-1),
                              slots.reshape(-1), out.reshape(-1))
    return M.update_landmark_stats(ms), res.cost


# ---------------------------------------------------------------------------
# KeyFrameCuller (optional job)
# ---------------------------------------------------------------------------

def _kf_redundancy(ms: MapState, cam: Camera, params: MapperParams,
                   kf_rows: torch.Tensor | None = None):
    """Fraction of each keyframe's close landmarks observed by at least
    kfcull_obs_thresh other keyframes at the same or a finer scale
    (KeyFrameCuller.cpp), for kf_rows [N] or every keyframe."""
    K, L, F = ms.K, ms.L, ms.F
    if kf_rows is None:
        kf_rows = torch.arange(K, device=ms.covis.device)
    rows = kf_rows.clamp(0, K - 1).long()
    lm_id = ms.kf.lm_id[rows]                                  # [N, F]
    lmc = lm_id.clamp(0, L - 1).long()
    depth = ms.kf.depth[rows]
    close = (lm_id >= 0) & (depth > 0) & (depth < cam.close_depth)
    obs_kf = ms.lm.obs_kf[lmc]                                 # [N, F, O]
    obs_feat = ms.lm.obs_feat[lmc].clamp(0, F - 1).long()
    obs_lvl = ms.kf.level[obs_kf.clamp(0, K - 1).long(), obs_feat]
    own_lvl = ms.kf.level[rows][:, :, None]
    other = ms.lm.obs_valid[lmc] & (obs_kf != rows[:, None, None]) & (obs_lvl <= own_lvl + 1)
    n_other = torch.sum(other, dim=-1)
    redundant = close & (n_other >= params.kfcull_obs_thresh)
    n_close = torch.sum(close, dim=-1)
    frac = torch.sum(redundant, dim=-1) / torch.clamp_min(n_close, 1)
    return torch.where(n_close > 0, frac, 0.0)


def cull_keyframes(ms: MapState, kf_id: int, cam: Camera, params: MapperParams):
    """KeyFrameCuller::run: mark covisible neighbours of the new keyframe bad
    when more than kfcull_frac_redundant of their close landmarks are
    redundant (origin keyframes excepted). Returns (ms, n_culled)."""
    K = ms.K
    ids, _ = M.covis_neighbors(ms, kf_id, 10, min_weight=1)
    idc = torch.where(ids >= 0, ids.clamp(0, K - 1), 0)
    frac_n = _kf_redundancy(ms, cam, params, kf_rows=idc)
    cull = torch.zeros(K + 1, dtype=torch.bool, device=ids.device).index_put(
        (torch.where((ids >= 0) & (frac_n > params.kfcull_frac_redundant), idc, K),),
        torch.ones((), dtype=torch.bool, device=ids.device))[:K] & ~ms.kf.origin
    ms = M.set_keyframes_bad(ms, cull)
    ms = M.refresh_covisibility(ms)
    ms = M.compute_spanning_parents(ms)
    return ms, torch.sum(cull, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Mapper: the job sequencer
# ---------------------------------------------------------------------------

def _integrate_core(ms: MapState, kf_id: int, params: MapperParams, cam: Camera,
                    is_mono: bool, do_optional: bool, n_levels: int = 8,
                    scale_factor: float = 1.2):
    """Mandatory jobs (covisibility / spanning / stats refresh + landmark
    culling) and the optional triangulate and fuse jobs. Returns (ms,
    stats [3] int32: triangulated, fused, fuse_added)."""
    ms = M.refresh_covisibility(ms)
    ms = M.compute_spanning_parents(ms)
    ms = M.update_landmark_stats(ms)
    ms = cull_landmarks(ms, kf_id, params, is_mono)
    z = torch.zeros((), dtype=torch.int32, device=ms.covis.device)
    n_tri, n_rep, n_add = z, z, z
    if do_optional:
        ms, n_tri = triangulate_new_landmarks(ms, kf_id, cam, params, is_mono,
                                              scale_factor)
        ms, n_rep, n_add = fuse_landmarks(ms, kf_id, cam, params, n_levels,
                                          scale_factor)
    return ms, torch.stack([n_tri, n_rep, n_add])


def _has_priors(ms: MapState, sensors) -> bool:
    """Whether local BA would need pose priors: a registered sub-map or a
    sensor reading (one host read)."""
    flags = [ms.maps.registered.any()]
    if sensors is not None:
        flags += [sensors.gps_valid.any(), sensors.quat_valid.any(),
                  sensors.depth_valid.any()]
    return bool(torch.stack(flags).any())


class Mapper:
    """Sequences the jobs per keyframe: the mandatory refreshes and landmark
    culling, triangulation and fusion, then (from the 4th integrated
    keyframe) local BA and keyframe culling. The reference's budget levels,
    which a backed-up mapping queue lowers, come with the threaded pipeline
    (ROADMAP step 19)."""

    def __init__(self, cam: Camera, params: MapperParams | None = None,
                 is_mono: bool = False, n_levels: int = 8,
                 scale_factor: float = 1.2):
        self.cam = cam
        self.params = params or MapperParams()
        self.is_mono = is_mono
        self.n_levels = n_levels
        self.scale_factor = scale_factor
        self.kf_count = 0

    def integrate_keyframe(self, ms: MapState, kf_id: int, sensors=None):
        """Run the jobs for keyframe kf_id. Returns (ms, stats): the job
        counters read back in one transfer, and ba_cost when local BA ran.
        Raises NotImplementedError where local BA would need pose priors
        (sensor readings or registered sub-maps: ROADMAP step 16)."""
        kf_id = int(kf_id)
        stats = {}
        p = self.params
        ms, counters = _integrate_core(ms, kf_id, p, self.cam, self.is_mono, True,
                                       self.n_levels, self.scale_factor)
        if self.kf_count > 2:
            if _has_priors(ms, sensors):
                raise NotImplementedError(
                    "local BA with sensor / sub-map pose priors is ROADMAP "
                    "step 16, not ported")
            # 16 local keyframes / 2048 landmarks, as the JAX package's caps
            ms, cost = _local_ba_noprior(ms, kf_id, self.cam, 16, 2048,
                                         self.n_levels, self.scale_factor)
            if not self.is_mono:
                ms, n_cull = cull_keyframes(ms, kf_id, self.cam, p)
                counters = torch.cat([counters, n_cull[None]])
            stats["ba_cost"] = cost
        self.kf_count += 1
        c = counters.tolist()
        stats["triangulated"], stats["fused"], stats["fuse_added"] = c[:3]
        if len(c) > 3:
            stats["kf_culled"] = c[3]
        if "ba_cost" in stats:
            stats["ba_cost"] = float(stats["ba_cost"])
        return ms, stats
