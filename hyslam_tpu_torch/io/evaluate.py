"""Trajectory evaluation: ATE / RPE in the TUM-benchmark sense (counterpart
of ``hyslam_tpu/io/evaluate.py``).

ATE: Horn-align (SE3, or Sim3 for mono) estimated camera centres to ground
truth, RMSE of the residual translations. RPE: per-delta relative pose error.
numpy in, floats out; the Horn fit runs on the CPU in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from hyslam_tpu_torch.geometry import sim3
from hyslam_tpu_torch.geometry.horn import horn_se3, horn_sim3


def camera_centers(Tcw: np.ndarray) -> np.ndarray:
    """[N,4,4] world->cam -> [N,3] camera centres."""
    R = Tcw[:, :3, :3]
    t = Tcw[:, :3, 3]
    return -np.einsum("nji,nj->ni", R, t)


def ate_rmse(est_Tcw: np.ndarray, gt_Tcw: np.ndarray, align: str = "se3") -> float:
    """Absolute trajectory error after alignment ('none'|'se3'|'sim3')."""
    pe = camera_centers(np.asarray(est_Tcw))
    pg = camera_centers(np.asarray(gt_Tcw))
    te = torch.from_numpy(np.asarray(pe, np.float64))
    tg = torch.from_numpy(np.asarray(pg, np.float64))
    if align == "se3":
        T = horn_se3(te, tg).numpy()
        pe = pe @ T[:3, :3].T + T[:3, 3]
    elif align == "sim3":
        pe = sim3.apply(horn_sim3(te, tg), te).numpy()
    d = pe - pg
    return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))


def rpe(est_Tcw: np.ndarray, gt_Tcw: np.ndarray, delta: int = 1):
    """Relative pose error over a fixed frame delta: returns
    (trans RMSE, rot RMSE deg)."""
    est = np.asarray(est_Tcw)
    gt = np.asarray(gt_Tcw)
    n = len(est) - delta
    terr, rerr = [], []
    for i in range(n):
        de = est[i + delta] @ np.linalg.inv(est[i])
        dg = gt[i + delta] @ np.linalg.inv(gt[i])
        e = de @ np.linalg.inv(dg)
        terr.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerr.append(np.degrees(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(terr)))), float(
        np.sqrt(np.mean(np.square(rerr))))
