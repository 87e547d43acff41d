"""Loop closing: detection, Sim3 computation, loop correction (counterpart
of ``hyslam_tpu/slam/loop_closing.py``).

- ``detect``: BoW candidates scoring at least the least score among the
  keyframe's covisible neighbours, not covisible with it, that stay
  covisibility-consistent over 3 consecutive keyframes; strongest first.
- ``compute_sim3``: descriptor matching (>= 20), Sim3 RANSAC and its
  refinement (>= 20 inliers each), then a guided projection harvest of the
  loop side's landmarks (>= 40 matches in all).
- ``correct``: the corrected Sim3 propagated through the covisibility
  group (a loop within one map) or the whole sub-map (a loop across maps),
  their landmarks corrected through their first owner in the group, the
  loop side fused into the nearest keyframes, the tiepoints re-measured, and
  the essential graph optimized with the loop edge (measurements from the
  poses before the correction; new loop connections from the corrected
  poses).

Host numpy decides what the JAX package decides on the host (candidate
lists, groups, edge assembly); every pose and landmark update is a batched
tensor program on the map's device. ``correct`` refuses a keyframe or a
candidate that is culled by the time it runs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.estimators import sim3_solver
from hyslam_tpu_torch.features.bow import PlaceRecognizer
from hyslam_tpu_torch.features.matcher import match_descriptors, search_by_projection_landmarks
from hyslam_tpu_torch.geometry import se3, sim3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.slam.mapper import _fuse_into_kf
from hyslam_tpu_torch.solver.pose_graph import optimize_pose_graph
from hyslam_tpu_torch.solver.sim3_opt import optimize_sim3

MIN_MATCHES_BOW = 20
MIN_INLIERS_SIM3 = 20
MIN_MATCHES_TOTAL = 40
CONSISTENCY_THRESHOLD = 3   # consecutive consistent detections
COVIS_ESSENTIAL = 100       # covisibility weight of an essential-graph edge
KF_GAP = 10                 # least keyframes between loop closures


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


@dataclass
class LoopCloser:
    """Loop detection, Sim3 verification and correction over one map state.
    ``recognizer`` holds the keyframes' BoW vectors; ``loop_edges`` the
    closed loops (i, j, S_ji measured from the corrected poses)."""

    cam: Camera
    recognizer: PlaceRecognizer
    fix_scale: bool = True   # stereo / RGB-D: the scale is observable
    consistency: list = field(default_factory=list)  # [(group set, count)]
    loop_edges: list = field(default_factory=list)   # [(i, j, meas S_ji [8])]
    last_loop_kf: int = -(10**6)
    n_closed: int = 0        # closures performed

    # -- detection ----------------------------------------------------------

    def detect(self, ms: MapState, kf_id: int) -> list:
        """The consistent loop candidates of keyframe kf_id, strongest BoW
        score first (possibly none)."""
        if kf_id - self.last_loop_kf < KF_GAP:
            return []
        desc, valid = ms.kf.desc[kf_id], ms.kf.kp_valid[kf_id]
        my_row = _np(ms.covis[kf_id])
        nbrs = np.nonzero(my_row >= 15)[0]
        if len(nbrs) == 0:
            return []
        scores = self.recognizer.scores(desc, valid)
        min_score = max(float(scores[nbrs].min()), 0.01)
        cands = self.recognizer.detect_loop_candidates(desc, valid, my_row, kf_id, min_score)
        if not cands:
            self.consistency = []
            return []
        # covisibility consistency: a candidate's group must meet a group
        # seen at the keyframe before, CONSISTENCY_THRESHOLD times in a row
        cand_rows = _np(ms.covis[torch.as_tensor(cands, device=ms.covis.device)])
        new_consistency, enough = [], []
        for c, row in zip(cands, cand_rows):
            group = set(np.nonzero(row >= 15)[0].tolist()) | {c}
            best_count = 0
            for prev_group, count in self.consistency:
                if group & prev_group:
                    best_count = max(best_count, count + 1)
            new_consistency.append((group, best_count))
            if best_count + 1 >= CONSISTENCY_THRESHOLD:
                enough.append(c)
        self.consistency = new_consistency
        enough.sort(key=lambda c: -float(scores[c]))
        return enough

    # -- Sim3 ---------------------------------------------------------------

    def compute_sim3(self, ms: MapState, kf_id: int, cand: int):
        """(ok, g_cl packed Sim3 candidate camera -> current camera, count)."""
        F, L = ms.F, ms.L
        kf = ms.kf
        idx, n = match_descriptors(
            kf.desc[kf_id], kf.kp_valid[kf_id] & (kf.lm_id[kf_id] >= 0), kf.angle[kf_id],
            kf.desc[cand], kf.kp_valid[cand] & (kf.lm_id[cand] >= 0), kf.angle[cand],
            max_dist=50, ratio=0.75)
        if int(n) < MIN_MATCHES_BOW:
            return False, None, 0
        ic = idx.clamp(0, F - 1).long()
        lm_c = M.resolve_landmarks(ms, kf.lm_id[kf_id])
        lm_l = M.resolve_landmarks(ms, kf.lm_id[cand][ic])
        pair_ok = (idx >= 0) & (lm_c >= 0) & (lm_l >= 0)
        X1 = se3.apply(kf.Tcw[kf_id], ms.lm.pos[lm_c.clamp(0, L - 1).long()])
        X2 = se3.apply(kf.Tcw[cand], ms.lm.pos[lm_l.clamp(0, L - 1).long()])
        uv1, uv2 = kf.uv[kf_id], kf.uv[cand][ic]
        is2_1 = 1.0 / torch.pow(1.2, 2.0 * kf.level[kf_id].to(torch.float32))
        is2_2 = 1.0 / torch.pow(1.2, 2.0 * kf.level[cand][ic].to(torch.float32))
        g, inl, n_inl = sim3_solver.sim3_ransac(
            self.cam, self.cam, X1, X2, uv1, uv2, is2_1, is2_2, pair_ok,
            sim3_solver.sample_sets(pair_ok, seed=kf_id), fix_scale=self.fix_scale)
        if int(n_inl) < MIN_INLIERS_SIM3:
            return False, None, int(n_inl)
        g, inl, n_inl = optimize_sim3(self.cam, self.cam, g, X1, X2, uv1, uv2, is2_1, is2_2,
                                      pair_ok, fix_scale=self.fix_scale, seed_inliers=inl)
        if int(n_inl) < MIN_INLIERS_SIM3:
            return False, None, int(n_inl)
        n_total = int(n_inl) + self._guided_harvest(ms, kf_id, cand, g)
        if n_total < MIN_MATCHES_TOTAL:
            return False, None, n_total
        return True, g, n_total

    def _guided_harvest(self, ms: MapState, kf_id: int, cand: int, g_cl) -> int:
        """The loop side's landmarks (the candidate and up to 10 covisible
        neighbours) projected through the corrected pose into the current
        keyframe: the count of further matches."""
        F, L = ms.F, ms.L
        dev = ms.covis.device
        cand_row = _np(ms.covis[cand])
        loop_kfs = np.concatenate([[cand], np.nonzero(cand_row >= 15)[0][:10]]).astype(np.int64)
        kf_lm = _np(M.resolve_landmarks(ms, ms.kf.lm_id[torch.from_numpy(loop_kfs).to(dev)]))
        rows = np.unique(kf_lm[kf_lm >= 0])[:F]
        padded = np.full(F, -1, np.int32)
        padded[: len(rows)] = rows
        rowst = torch.from_numpy(padded).to(dev)
        rc = rowst.clamp(0, L - 1).long()
        row_ok = (rowst >= 0) & ms.lm.valid[rc] & ~ms.lm.bad[rc]
        T_scw = sim3.to_se3_scaled(sim3.compose(g_cl, sim3.from_se3(ms.kf.Tcw[cand])))
        res = search_by_projection_landmarks(
            self.cam, M.kf_features(ms, kf_id), T_scw, ms.lm.pos[rc], ms.lm.normal[rc],
            ms.lm.desc[rc], ms.lm.max_dist[rc], ms.lm.min_dist[rc], row_ok,
            already_matched=ms.kf.lm_id[kf_id] >= 0, th=7.5)
        return int(res.n_matches)

    # -- correction ---------------------------------------------------------

    def correct(self, ms: MapState, kf_id: int, cand: int, g_cl):
        """CorrectLoop. Returns (ms, applied): a keyframe or candidate that
        is culled (or not allocated) by now is refused, the map unchanged."""
        K, dev = ms.K, ms.covis.device
        kf_ok = _np(ms.kf.valid & ~ms.kf.bad)
        if not (kf_ok[kf_id] and kf_ok[cand]):
            return ms, False
        S_cw_corr = sim3.compose(g_cl, sim3.from_se3(ms.kf.Tcw[cand]))

        # propagation set: the covisibility group for a loop within one map,
        # the current keyframe's whole sub-map for a loop across maps (a
        # re-initialized sub-map carries one rigid placement error)
        my_row = _np(ms.covis[kf_id])
        kf_map = _np(ms.kf.map_id)
        covis_group = np.nonzero(((my_row >= 15) | (np.arange(K) == kf_id)) & kf_ok)[0]
        if kf_map[kf_id] != kf_map[cand]:
            group = np.nonzero(kf_ok & (kf_map == kf_map[kf_id]))[0]
        else:
            group = covis_group
        groupt = torch.from_numpy(group).to(dev)
        Tcw_before = ms.kf.Tcw     # the essential graph's measurements
        T_kc = ms.kf.Tcw[groupt] @ se3.inverse(ms.kf.Tcw[kf_id])
        corrected = sim3.compose(sim3.from_se3(T_kc), S_cw_corr)           # [G, 8]

        # each landmark of the group corrected once, through the first group
        # member that sees it: X' = S_new^-1 S_old X
        G = len(group)
        kf_lm = _np(ms.kf.lm_id)
        rows = kf_lm[group]
        slot = np.repeat(np.arange(G), rows.shape[1])
        flat = rows.ravel()
        ok = flat >= 0
        owner = np.full(ms.L, G, np.int64)
        np.minimum.at(owner, flat[ok], slot[ok])
        hit = owner < G
        owner_c = torch.from_numpy(np.where(hit, owner, 0)).to(dev)
        S_old_g = sim3.from_se3(ms.kf.Tcw[groupt])
        S_new_inv_g = sim3.inverse(corrected)
        Xc = sim3.apply(S_new_inv_g[owner_c], sim3.apply(S_old_g[owner_c], ms.lm.pos))
        new_pos = torch.where(torch.from_numpy(hit).to(dev)[:, None], Xc, ms.lm.pos)
        Tcw_new = ms.kf.Tcw.clone()
        Tcw_new[groupt] = sim3.to_se3_scaled(corrected)
        ms = ms._replace(lm=ms.lm._replace(pos=new_pos), kf=ms.kf._replace(Tcw=Tcw_new))

        # covisibility before the fuse: pairs that first become covisible
        # through it are the new loop connections
        covis_prev = _np(ms.covis)

        # fuse the loop side's landmarks into the keyframes nearest the loop
        cand_row = covis_prev[cand]
        loop_kfs = np.concatenate([[cand], np.nonzero(cand_row >= 15)[0][:5]]).astype(np.int64)
        loop_lm = kf_lm[loop_kfs]
        loop_rows = np.unique(loop_lm[loop_lm >= 0])[: ms.F]
        lm_rows = np.full(ms.F, -1, np.int32)
        lm_rows[: len(loop_rows)] = loop_rows
        lm_rows = torch.from_numpy(lm_rows).to(dev)
        for k in [kf_id] + [int(k) for k in covis_group if k != kf_id][:4]:
            ms, _, _ = _fuse_into_kf(ms, int(k), lm_rows, self.cam, th=4.0)
        ms = M.update_landmark_stats(M.refresh_covisibility(ms))

        # the loop edge, measured from the corrected poses
        meas = sim3.compose(sim3.from_se3(ms.kf.Tcw[cand]),
                            sim3.inverse(sim3.from_se3(ms.kf.Tcw[kf_id])))
        self.loop_edges.append((int(kf_id), int(cand), _np(meas)))

        # the loop supersedes the re-initialization's placement: re-measure
        # the tiepoints before the essential graph
        ms = M.refresh_tiepoints(ms)
        ms = self.optimize_essential_graph(ms, fixed_kf=cand, Tcw_meas=Tcw_before,
                                           covis_prev=covis_prev)
        self.last_loop_kf = kf_id
        return ms, True

    def optimize_essential_graph(self, ms: MapState, fixed_kf: int,
                                 Tcw_meas: torch.Tensor | None = None,
                                 covis_prev: np.ndarray | None = None) -> MapState:
        """The Sim3 pose graph over spanning-tree edges, covisibility edges
        (>= 100), registered sub-maps' tiepoints (weight 0.01) and the loop
        edges (weight 2); optimized, then poses and landmarks (through their
        first keyframe) written back.

        Tcw_meas: the poses the spanning and covisibility edges are measured
        from (default: the current ones). covis_prev: the covisibility before
        the loop fuse; covisibility edges of pairs under 15 there are new
        loop connections, measured from the current poses."""
        K, dev = ms.K, ms.covis.device
        kf_ok = _np(ms.kf.valid & ~ms.kf.bad)
        g0 = sim3.from_se3(ms.kf.Tcw)
        if Tcw_meas is None:
            Tcw_meas = ms.kf.Tcw
        covis = _np(ms.covis)
        parents = _np(ms.kf.span_parent)

        ks = np.nonzero(kf_ok)[0]
        p = parents[ks]
        sp_ok = (p >= 0) & kf_ok[np.clip(p, 0, K - 1)]
        sp_i, sp_j = p[sp_ok].astype(np.int64), ks[sp_ok].astype(np.int64)

        ci, cj = np.nonzero(np.triu(covis >= COVIS_ESSENTIAL, 1))
        c_ok = kf_ok[ci] & kf_ok[cj]
        ci, cj = ci[c_ok], cj[c_ok]
        # covisibility edges that duplicate spanning edges are dropped
        span_code = np.minimum(sp_i, sp_j) * K + np.maximum(sp_i, sp_j)
        covis_code = np.minimum(ci, cj) * K + np.maximum(ci, cj)
        keep = ~np.isin(covis_code, span_code)
        ci, cj = ci[keep], cj[keep]

        ei = np.concatenate([sp_i, ci]).astype(np.int32)
        ej = np.concatenate([sp_j, cj]).astype(np.int32)
        wts = np.ones(len(ei), np.float32)

        # registered sub-maps' tiepoint edges: pose_child = Tse3_parent pose_tie
        reg = _np(ms.maps.registered)
        tie_kf = _np(ms.maps.tie_kf)
        tie_T = ms.maps.Tse3_parent
        kf_map = _np(ms.kf.map_id)
        origin = _np(ms.kf.origin)
        tie_i, tie_j, tie_m = [], [], []
        for m in np.nonzero(reg)[0]:
            if tie_kf[m] < 0 or not kf_ok[tie_kf[m]]:
                continue
            child = np.nonzero(origin & (kf_map == m) & kf_ok)[0]
            if len(child) == 0:
                continue
            tie_i.append(int(tie_kf[m]))
            tie_j.append(int(child[0]))
            tie_m.append(int(m))
        if len(ei):
            g_all = sim3.from_se3(Tcw_meas)
            eit, ejt = torch.from_numpy(ei).long().to(dev), torch.from_numpy(ej).long().to(dev)
            meas = _np(sim3.compose(g_all[ejt], sim3.inverse(g_all[eit])))
            if covis_prev is not None:
                is_new = covis_prev[ei, ej] < 15
                is_new[: len(sp_i)] = False
                if np.any(is_new):
                    meas_cur = _np(sim3.compose(g0[ejt], sim3.inverse(g0[eit])))
                    meas = np.where(is_new[:, None], meas_cur, meas)
        else:
            meas = np.zeros((0, 8), np.float32)
        if tie_i:
            ei = np.concatenate([ei, np.asarray(tie_i, np.int32)])
            ej = np.concatenate([ej, np.asarray(tie_j, np.int32)])
            meas = np.concatenate([meas, _np(sim3.from_se3(
                tie_T[torch.as_tensor(tie_m, device=dev)]))])
            wts = np.concatenate([wts, np.full(len(tie_i), 0.01, np.float32)])
        if self.loop_edges:
            li = np.asarray([j for (i, j, m) in self.loop_edges], np.int32)
            lj = np.asarray([i for (i, j, m) in self.loop_edges], np.int32)
            lm_meas = _np(sim3.inverse(torch.from_numpy(
                np.stack([m for (i, j, m) in self.loop_edges])).to(dev)))
            ei = np.concatenate([ei, li])
            ej = np.concatenate([ej, lj])
            meas = np.concatenate([meas, lm_meas])
            wts = np.concatenate([wts, np.full(len(li), 2.0, np.float32)])
        if len(ei) == 0:
            return ms

        fixed = np.zeros(K, bool)
        fixed[fixed_kf] = True
        fixed |= ~kf_ok
        # gauge: the origins of maps with no pose relation to a parent are
        # fixed; a registered sub-map's origin stays free (its tiepoint holds it)
        fixed |= origin & ~reg[np.clip(kf_map, 0, len(reg) - 1)]

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        g_opt = optimize_pose_graph(
            g0, t(fixed), t(ei), t(ej), t(meas.astype(np.float32)),
            torch.ones(len(ei), dtype=torch.bool, device=dev), t(wts),
            fix_scale=self.fix_scale)
        # poses written back; each landmark corrected through its first keyframe
        ref = _np(ms.lm.first_kf)
        refc = t(np.clip(ref, 0, K - 1)).long()
        lm_ok = _np(ms.lm.valid & ~ms.lm.bad) & (ref >= 0)
        X = ms.lm.pos
        Xc = sim3.apply(sim3.inverse(g_opt[refc]), sim3.apply(g0[refc], X))
        pos_new = torch.where(t(lm_ok)[:, None], Xc, X)
        ms = ms._replace(kf=ms.kf._replace(Tcw=sim3.to_se3_scaled(g_opt)),
                         lm=ms.lm._replace(pos=pos_new))
        return M.update_landmark_stats(ms)

    # -- per keyframe -------------------------------------------------------

    def detect_and_verify(self, ms: MapState, kf_id: int):
        """Index the keyframe, detect, and verify up to 3 candidates, without
        changing the map: (found, cand, g_cl, count)."""
        self.recognizer.add_keyframe(kf_id, ms.kf.desc[kf_id], ms.kf.kp_valid[kf_id])
        n_last = 0
        for cand in self.detect(ms, kf_id)[:3]:
            ok, g_cl, n = self.compute_sim3(ms, kf_id, cand)
            if ok:
                return True, cand, g_cl, n
            n_last = n
        return False, -1, None, n_last

    def process_keyframe(self, ms: MapState, kf_id: int):
        """One LoopClosing step for one keyframe: (ms, closed, info)."""
        found, cand, g_cl, n = self.detect_and_verify(ms, kf_id)
        if found:
            ms, applied = self.correct(ms, kf_id, cand, g_cl)
            if applied:
                self.n_closed += 1
                return ms, True, {"loop_kf": cand, "sim3_inliers": n}
        return ms, False, ({"sim3_inliers": n} if n else {})
