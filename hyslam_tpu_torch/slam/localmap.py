"""Local-map construction for TrackLocalMap (counterpart of
``hyslam_tpu/slam/localmap.py``): keyframes are voted by the frame's
matched landmarks, the top voters' covisibility neighbours join (cap 80
keyframes), and the landmarks of the local keyframes are harvested into a
fixed-capacity table. The harvest is a stable top k of a 0/1 score, so the
rows come in ascending arena order, as ``lax.top_k`` gives them."""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.core.mapstate import MapState, visible_scope
from hyslam_tpu_torch.ops.indexing import top_k

MAX_LOCAL_KFS = 80  # reference cap (TrackLocalMap.cpp: 80)


class LocalMap(NamedTuple):
    lm_idx: torch.Tensor       # [Lloc] landmark arena ids (-1 pad)
    lm_pos: torch.Tensor       # [Lloc, 3]
    lm_normal: torch.Tensor    # [Lloc, 3]
    lm_desc: torch.Tensor      # [Lloc, 8]
    lm_max_dist: torch.Tensor  # [Lloc]
    lm_min_dist: torch.Tensor  # [Lloc]
    lm_valid: torch.Tensor     # [Lloc]
    kf_mask: torch.Tensor      # [K] local keyframe set
    ref_kf: torch.Tensor       # [] best-voted keyframe


def build_local_map(ms: MapState, frame_lm_id: torch.Tensor,
                    capacity: int = 4096) -> LocalMap:
    """frame_lm_id: [F] current frame's landmark associations (-1 none)."""
    K, L = ms.K, ms.L
    dev = frame_lm_id.device
    kf_scope, lm_scope = visible_scope(ms)

    has = frame_lm_id >= 0
    lmc = frame_lm_id.clamp(0, L - 1).long()
    obs_ok = ms.lm.obs_valid[lmc] & has[:, None]                 # [F, O]
    tgt = torch.where(obs_ok, ms.lm.obs_kf[lmc].clamp(0, K - 1).long(), K)
    votes = torch.zeros(K + 1, dtype=torch.int32, device=dev).index_add(
        0, tgt.reshape(-1), obs_ok.reshape(-1).to(torch.int32))[:K]
    votes = torch.where(kf_scope, votes, 0)
    ref_kf = torch.argmax(votes)

    top_v, top_i = top_k(votes, min(MAX_LOCAL_KFS, K))
    kf_mask = torch.zeros(K, dtype=torch.bool, device=dev).index_put(
        (top_i,), top_v > 0)
    covis_from_voters = torch.amax(torch.where(kf_mask[:, None], ms.covis, 0), dim=0)
    kf_mask = (kf_mask | (covis_from_voters >= 15)) & kf_scope

    src = torch.where(kf_mask[:, None] & (ms.kf.lm_id >= 0),
                      ms.kf.lm_id.clamp(0, L - 1).long(), L)
    lm_hit = torch.zeros(L + 1, dtype=torch.bool, device=dev).index_put(
        (src.reshape(-1),), torch.ones((), dtype=torch.bool, device=dev))[:L]
    lm_hit = lm_hit & lm_scope

    _, sel = top_k(lm_hit.to(torch.int32), capacity)
    sel_ok = lm_hit[sel]
    return LocalMap(
        lm_idx=torch.where(sel_ok, sel, -1).to(torch.int32),
        lm_pos=ms.lm.pos[sel], lm_normal=ms.lm.normal[sel],
        lm_desc=ms.lm.desc[sel], lm_max_dist=ms.lm.max_dist[sel],
        lm_min_dist=ms.lm.min_dist[sel], lm_valid=sel_ok,
        kf_mask=kf_mask, ref_kf=ref_kf.to(torch.int32),
    )
