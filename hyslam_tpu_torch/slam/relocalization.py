"""Relocalization: recover tracking after a loss (counterpart of
``hyslam_tpu/slam/relocalization.py``).

Candidate keyframes are ranked by the BoW place recognizer where the
System has built one (loop closing on), else by dense descriptor-set
similarity; each candidate in turn is descriptor-matched against the
keyframe's landmarks (>= 15), solved by PnP-RANSAC with the pose-only LM,
and, with >= 10 inliers, re-matched against the local map to >= 50 inliers.

Each candidate that passes the match gate costs one pose-only LM (the PnP
refinement), each that passes the PnP gate one more (the local map's); on a
card each is one launch of kernel K1. ``try_relocalize`` counts them in its
``stats``.
"""

from __future__ import annotations

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.frame import feature_inv_sigma2
from hyslam_tpu_torch.core.mapstate import MapState, visible_scope
from hyslam_tpu_torch.estimators.pnp import pnp_ransac_refined
from hyslam_tpu_torch.features.matcher import match_descriptors
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.ops.hamming import hamming_matrix
from hyslam_tpu_torch.slam.strategies import track_local_map
from hyslam_tpu_torch.slam.tracking_params import PlaceRecognitionParams


def rank_candidates(frame_desc, frame_valid, ms: MapState, n_candidates: int = 5,
                    recognizer=None) -> list:
    """Candidate keyframes. With a recognizer (``features.bow.
    PlaceRecognizer``): its relocalization candidates over the whole
    covisibility matrix, as in the JAX package. Without: those of the active
    map's scope by the share of the frame's features whose nearest keyframe
    descriptor lies under 50 bits, best first (numpy's sort of the same
    float32 scores as the JAX package's), those over 0.05; one read of the
    scope and one of the counts."""
    if recognizer is not None:
        return recognizer.detect_relocalization_candidates(
            frame_desc, frame_valid, ms.covis, n_max=n_candidates)
    kf_ok, _ = visible_scope(ms)
    ks = torch.nonzero(kf_ok)[:, 0].tolist()
    scores = np.zeros(ms.K, np.float32)
    if ks:
        counts = []
        for k in ks:
            d = hamming_matrix(frame_desc, ms.kf.desc[k])
            dm = torch.where(frame_valid[:, None] & ms.kf.kp_valid[k][None, :], d, 1 << 16)
            best = torch.amin(dm, dim=1)
            counts.append(torch.sum((best < 50) & frame_valid, dtype=torch.int32))
        scores[ks] = np.asarray(torch.stack(counts).tolist(), np.float32) / np.float32(
            frame_valid.shape[0])
    order = np.argsort(-scores)
    return [int(k) for k in order[:n_candidates] if scores[k] > 0.05]


def try_relocalize(cam: Camera, feats, ms: MapState, recognizer=None,
                   n_levels: int = 8, scale_factor: float = 1.2,
                   p: PlaceRecognitionParams = PlaceRecognitionParams(),
                   stats: dict | None = None):
    """Returns (ok, Tcw, lm_id, n_inliers). ``stats``, where given, gains
    the counts of this call: ``candidates`` tried, ``pnp_solves`` and
    ``local_solves`` (the pose-only LM calls). Candidate k's minimal sets
    come from a generator seeded with k."""
    stats = {} if stats is None else stats
    for key in ("candidates", "pnp_solves", "local_solves"):
        stats.setdefault(key, 0)
    cands = rank_candidates(feats.desc, feats.valid, ms, n_candidates=p.n_candidates,
                            recognizer=recognizer)
    F, L = ms.F, ms.L
    inv_s2 = feature_inv_sigma2(feats.level, n_levels, scale_factor)
    for k in cands:
        stats["candidates"] += 1
        kf_lm = M.resolve_landmarks(ms, ms.kf.lm_id[k])
        idx, n = match_descriptors(
            feats.desc, feats.valid, feats.angle, ms.kf.desc[k],
            ms.kf.kp_valid[k] & (kf_lm >= 0), ms.kf.angle[k],
            max_dist=p.max_descriptor_dist, ratio=p.match_nnratio_1)
        if int(n) < p.n_min_matches_bow:
            continue
        lm = torch.where(idx >= 0, kf_lm[idx.clamp(0, F - 1).long()], -1)
        pair_ok = lm >= 0
        X = ms.lm.pos[lm.clamp(0, L - 1).long()]
        stats["pnp_solves"] += 1
        T, inl, n_pnp = pnp_ransac_refined(cam, X, feats.uv, inv_s2, pair_ok, seed=k)
        if int(n_pnp) < p.n_min_matches_pnp:
            continue
        stats["local_solves"] += 1
        lres = track_local_map(cam, feats, T, torch.where(inl, lm, -1), ms)
        n_inl = int(lres.track.n_inliers)
        if n_inl >= p.n_min_matches_success:
            return True, lres.track.Tcw, lres.track.lm_id, n_inl
    return False, None, None, 0
