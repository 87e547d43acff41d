"""The dual-camera imaging pipeline: frame placement and imaging bundle
adjustment (counterpart of ``hyslam_tpu/slam/imaging.py``).

- ``ImagingFramePlacer`` (util/ImagingFramePlacer in the reference): an
  imaging frame is posed from the SLAM trajectory and the rig transform
  Tcam, and kept when its landmark overlap with the last kept frame drops
  below a threshold (0.8) and enough landmarks are visible (20).
- ``run_imaging_ba`` (ImagingBundleAdjustment): each imaging sub-map is
  aligned by a Horn Sim3 of its keyframe centres to the centres the
  trajectory predicts, and registered; then rounds of (a) a bundle
  adjustment over poses and landmarks in which every keyframe pose is tied
  by a unary SE3 anchor to Tcam o T_traj(t_k), assembled into the reduced
  camera system, and (b) a refit of the times t_k and of Tcam by gradient
  descent through the SE3-interpolated trajectory.

The refit's gradient is taken with ``torch.autograd`` (the JAX package's
``jax.grad``); it is the only part of the port that runs under autograd.
At a residual rotation of exactly zero the JAX package's gradient of
``se3.log`` is NaN (the gradient of its vector norm at 0) and its refit
returns NaN times and rig, so that its next round changes nothing; the
port's is finite there (``torch.linalg.norm``'s gradient at 0 is 0, and the
small-angle branch of ``so3.quat_log`` is exact), and elsewhere the same,
bounds included (``so3.clip``).
"""

from __future__ import annotations

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core import trajectory as TJ
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.geometry import se3, sim3, so3
from hyslam_tpu_torch.geometry.camera import Camera, in_image, project
from hyslam_tpu_torch.geometry.horn import horn_sim3
from hyslam_tpu_torch.slam.global_ba import build_global_problem
from hyslam_tpu_torch.solver.ba import _backsub, _linearize, _robust_cost, _solve_poses


def _as_pose(Tcam, device) -> torch.Tensor | None:
    """A rig transform (a 4x4 list of the config, numpy or tensor) as a
    float32 tensor on ``device``, or None."""
    if Tcam is None:
        return None
    return torch.as_tensor(np.array(Tcam, np.float32) if not isinstance(Tcam, torch.Tensor)
                           else Tcam, dtype=torch.float32).to(device)


# ---------------------------------------------------------------------------
# ImagingFramePlacer
# ---------------------------------------------------------------------------

class ImagingFramePlacer:
    """Online imaging-frame selection: place by the SLAM trajectory and the
    rig transform, keep where the overlap with the last kept frame is below
    ``overlap_threshold`` and at least ``min_visible`` landmarks are
    visible."""

    def __init__(self, cam: Camera, overlap_threshold: float = 0.8,
                 min_visible: int = 20):
        self.cam = cam
        self.overlap_threshold = overlap_threshold
        self.min_visible = min_visible
        self._last_visible_set: set[int] | None = None

    def place(self, slam_traj, timestamp: float, Tcam):
        """Pose the imaging frame: Tcw = Tcam o T_slam(t). Returns (Tcw,
        whether the time lies in the trajectory's range)."""
        dev = slam_traj.t.device
        T, ok = TJ.pose_at_time(slam_traj, torch.tensor([timestamp], dtype=torch.float32,
                                                         device=dev))
        Tcam = _as_pose(Tcam, dev)
        Tcw = (Tcam @ T[0]) if Tcam is not None else T[0]
        return Tcw, bool(ok[0])

    def visible_landmarks(self, ms: MapState, Tcw) -> np.ndarray:
        """The landmark rows visible from Tcw (in the image, in front of the
        camera, and within the matcher's distance bounds [0.8 min, 1.2
        max]), as a numpy index array: one read of the mask."""
        lm_ok = ms.lm.valid & ~ms.lm.bad
        uv, z = project(self.cam, se3.apply(Tcw, ms.lm.pos))
        d = ms.lm.pos - se3.translation(se3.inverse(Tcw))
        dist = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
        vis = (in_image(self.cam, uv) & (z > 0.2) & lm_ok
               & (dist >= 0.8 * ms.lm.min_dist) & (dist <= 1.2 * ms.lm.max_dist))
        return np.nonzero(vis.cpu().numpy())[0]

    def should_keep(self, ms: MapState, slam_traj, timestamp: float,
                    Tcam) -> tuple[bool, torch.Tensor]:
        Tcw, ok = self.place(slam_traj, timestamp, Tcam)
        if not ok:
            return False, Tcw
        vis = self.visible_landmarks(ms, Tcw)
        if len(vis) < self.min_visible:
            return False, Tcw
        seen = set(vis.tolist())
        if self._last_visible_set is None:
            self._last_visible_set = seen
            return True, Tcw
        overlap = len(self._last_visible_set & seen) / max(len(vis), 1)
        if overlap < self.overlap_threshold:
            self._last_visible_set = seen
            return True, Tcw
        return False, Tcw


# ---------------------------------------------------------------------------
# similarity pre-alignment
# ---------------------------------------------------------------------------

def align_submaps_to_trajectory(ms: MapState, cam: Camera, slam_traj, Tcam) -> MapState:
    """Per sub-map: a Horn Sim3 of the imaging keyframe centres onto the
    centres the trajectory (and the rig) predicts at their times, applied
    (the scale to positions and translations, then the rigid part) and the
    sub-map registered. Sub-maps with fewer than 3 keyframes, or fewer than
    3 inside the trajectory's time range, are left as they are. Where the
    centres lie on a line, the rotation about it is the one the keyframes'
    orientations call for (the JAX package's is what its eigensolver
    returns: on tests/test_imaging.py's straight survey it happens to be
    near the truth, the port's solver returned a half turn)."""
    dev = ms.kf.Tcw.device
    Tcam = _as_pose(Tcam, dev)
    n_maps = int(ms.maps.n_maps)
    kf_ok = ms.kf.valid & ~ms.kf.bad
    kf_ok_np = kf_ok.cpu().numpy()
    map_ids = ms.kf.map_id.cpu().numpy()
    centers = M.camera_centers(ms)
    for mid in range(n_maps):
        sel = np.nonzero(kf_ok_np & (map_ids == mid))[0]
        if len(sel) < 3:
            continue
        sel_t = torch.from_numpy(sel).to(dev)
        T_pred, ok = TJ.pose_at_time(slam_traj, ms.kf.timestamp[sel_t])
        if Tcam is not None:
            T_pred = Tcam @ T_pred
        ok_np = ok.cpu().numpy()
        if ok_np.sum() < 3:
            continue
        ok_t = torch.from_numpy(ok_np).to(dev)
        use = sel_t[ok_t]
        T_pred = T_pred[ok_t]
        # the keyframes' orientations settle the rotation about the line of
        # a straight trajectory, which the centres leave free: the mean of
        # R_pred^T R_est, which maps the sub-map's orientations onto the
        # predicted ones
        q_rel = so3.quat_from_mat(se3.rotation(T_pred).transpose(-1, -2)
                                  @ se3.rotation(ms.kf.Tcw[use]))
        q_prior = torch.sum(q_rel, dim=0)
        g = horn_sim3(centers[use], se3.translation(se3.inverse(T_pred)),
                      q_prior=q_prior / torch.linalg.norm(q_prior))
        s, R, t = sim3.unpack(g)
        in_kf = kf_ok & (ms.kf.map_id == mid)
        in_lm = ms.lm.valid & (ms.lm.map_id == mid)
        pos = torch.where(in_lm[:, None], ms.lm.pos * s, ms.lm.pos)
        Tcw = ms.kf.Tcw.clone()
        Tcw[:, :3, 3] = Tcw[:, :3, 3] * torch.where(in_kf, s, 1.0)[:, None]
        ms = ms._replace(kf=ms.kf._replace(Tcw=Tcw), lm=ms.lm._replace(pos=pos))
        ms = M.apply_transform_to_map(ms, mid, se3.from_Rt(R, t))
        ms = M.register_submap(ms, mid)
    return ms


# ---------------------------------------------------------------------------
# trajectory-tied bundle adjustment
# ---------------------------------------------------------------------------

def _anchor_residuals(kf_Tcw: torch.Tensor, anchors: torch.Tensor) -> torch.Tensor:
    """r = log(T_anchor T^-1) a keyframe [K, 6]."""
    return se3.log(anchors @ se3.inverse(kf_Tcw))


def _anchor_blocks(kf_Tcw, anchors, weight, movable):
    """The unary SE3 anchor r = log(T_anchor T^-1) of each keyframe: w J^T J
    to Hpp and w J^T r to b, J taken as -I in the left tangent (exact at
    r = 0, the usual weak-prior linearization). Returns (Hpp_extra [K,6,6],
    b_extra [K,6], r)."""
    r = _anchor_residuals(kf_Tcw, anchors)
    w = weight * movable.to(kf_Tcw.dtype)
    eye6 = torch.eye(6, dtype=kf_Tcw.dtype, device=kf_Tcw.device)
    return w[:, None, None] * eye6, w[:, None] * r, r


def _trajectory_tied_ba(prob, anchors, anchor_w, n_iters: int = 10,
                        chunk: int = 256, lam0: float = 1e-4):
    """LM over (poses, landmarks) with the robust reprojection cost plus
    sum_k w_k |log(anchor_k T_k^-1)|^2 over the movable keyframes; the
    anchors' blocks join Hpp and b before the dense Schur solve. Returns
    (kf_Tcw, lm_pos, cost)."""
    movable = ~prob.kf_fixed

    def total_cost(kf_Tcw, lm_pos):
        r = _anchor_residuals(kf_Tcw, anchors)
        return (_robust_cost(prob, kf_Tcw, lm_pos, True)
                + torch.sum(anchor_w * movable * torch.sum(r * r, -1)))

    kf_Tcw, lm_pos = prob.kf_Tcw, prob.lm_pos
    lam = torch.full((), lam0, dtype=kf_Tcw.dtype, device=kf_Tcw.device)
    cost = total_cost(kf_Tcw, lm_pos)
    for _ in range(n_iters):
        Hpp, b_pose, S_red, b_red, Vinv, Wlo, b_lm, kf_idx = _linearize(
            prob, kf_Tcw, lm_pos, lam, prob.obs.valid, True, chunk)
        Ha, ba, _ = _anchor_blocks(kf_Tcw, anchors, anchor_w, movable)
        dp = _solve_poses(Hpp + Ha, b_pose + ba, S_red, b_red, prob.kf_fixed, lam)
        dl = _backsub(Vinv, Wlo, b_lm, kf_idx, dp, prob.lm_valid)
        kf_new = torch.where(prob.kf_fixed[:, None, None], kf_Tcw, se3.exp(dp) @ kf_Tcw)
        lm_new = lm_pos + dl
        new_cost = total_cost(kf_new, lm_new)
        accept = new_cost < cost
        kf_Tcw = torch.where(accept, kf_new, kf_Tcw)
        lm_pos = torch.where(accept, lm_new, lm_pos)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        cost = torch.minimum(new_cost, cost)
    return kf_Tcw, lm_pos, cost


def _refit_times_and_rig(traj, kf_Tcw, kf_ts, kf_ok, Tcam0, n_iters: int = 20):
    """The per-keyframe times and the shared rig transform that best explain
    the current imaging poses,
        min sum_k |log((Tcam o T_traj(t_k + dt_k)) Tcw_k^-1)|^2,
    by n_iters plain gradient steps (learning rates 1e-3 for the times,
    1e-2 for the rig's tangent) through the SE3-interpolated trajectory.
    Returns (dt [K], Tcam [4,4], the final loss)."""
    w = kf_ok.to(torch.float32)
    Tinv = se3.inverse(kf_Tcw)

    def loss(dt, xi_cam):
        Tq, _ = TJ.pose_at_time(traj, kf_ts + dt)
        r = se3.log((se3.exp(xi_cam) @ Tcam0) @ Tq @ Tinv)
        return torch.sum(w[:, None] * r * r)

    lr_t, lr_c = 1e-3, 1e-2
    dt = torch.zeros_like(kf_ts)
    xi = torch.zeros(6, dtype=torch.float32, device=kf_Tcw.device)
    with torch.enable_grad():
        for _ in range(n_iters):
            dt_v = dt.detach().requires_grad_(True)
            xi_v = xi.detach().requires_grad_(True)
            g_dt, g_xi = torch.autograd.grad(loss(dt_v, xi_v), (dt_v, xi_v))
            dt = dt - lr_t * g_dt
            xi = xi - lr_c * g_xi
    with torch.no_grad():
        return dt, se3.exp(xi) @ Tcam0, loss(dt, xi)


def run_imaging_ba(ms: MapState, cam: Camera, slam_traj, Tcam,
                   anchor_weight: float = 1.0e4, rounds: int = 2) -> MapState:
    """The imaging finalization (System::RunImagingBundleAdjustment): align
    and register the sub-maps, then ``rounds`` of the trajectory-tied BA
    (every live keyframe free: the gauge comes from the anchors) and the
    refit of the times and the rig. Landmark statistics are recomputed at
    the end."""
    dev = ms.kf.Tcw.device
    Tcam0 = _as_pose(Tcam, dev)
    if Tcam0 is None:
        Tcam0 = torch.eye(4, dtype=torch.float32, device=dev)
    ms = align_submaps_to_trajectory(ms, cam, slam_traj, Tcam0)

    kf_ok = ms.kf.valid & ~ms.kf.bad
    kf_ts = ms.kf.timestamp
    dt = torch.zeros_like(kf_ts)
    Tcam_cur = Tcam0
    for _ in range(rounds):
        Tq, okq = TJ.pose_at_time(slam_traj, kf_ts + dt)
        anchors = Tcam_cur @ Tq
        prob = build_global_problem(ms, cam)
        prob = prob._replace(kf_fixed=~kf_ok)
        anchor_w = anchor_weight * (kf_ok & okq).to(torch.float32)
        kf_Tcw, lm_pos, _ = _trajectory_tied_ba(prob, anchors, anchor_w)
        ms = ms._replace(
            kf=ms.kf._replace(Tcw=torch.where(kf_ok[:, None, None], kf_Tcw, ms.kf.Tcw)),
            lm=ms.lm._replace(pos=torch.where(prob.lm_valid[:, None], lm_pos, ms.lm.pos)))
        dt, Tcam_cur, _ = _refit_times_and_rig(slam_traj, ms.kf.Tcw, kf_ts, kf_ok, Tcam_cur)
    return M.update_landmark_stats(ms)
