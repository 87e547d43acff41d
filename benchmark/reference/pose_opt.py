"""Plain reference of the pose-only solve (ORB-SLAM2's
Optimizer::PoseOptimization): 4 rounds of 10 Levenberg-Marquardt
iterations on the left-multiplied SE(3) tangent, Huber at sqrt(5.991) mono
and sqrt(7.815) stereo in the first two rounds, outliers reclassified by
chi2 between rounds, points at or behind z = 0.05 hard outliers.

A frozen copy of the port's plain PyTorch solver as the benchmark was
defined, written out in one file so that it imports nothing of the program.
The benchmark solves the pose kernel's own problems with it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class Intrinsics(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], dim=-1),
                        torch.stack([wz, z, -wx], dim=-1),
                        torch.stack([-wy, wx, z], dim=-1)], dim=-2)


def _sinc_coeffs(theta2: torch.Tensor):
    small = theta2 < 0.25
    st2 = torch.where(small, 1.0, theta2)
    t = torch.sqrt(st2)
    t4 = theta2 * theta2
    t6 = t4 * theta2
    A = torch.where(small, 1.0 - theta2 / 6.0 + t4 / 120.0 - t6 / 5040.0, torch.sin(t) / t)
    sh = torch.sin(0.5 * t)
    B = torch.where(small, 0.5 - theta2 / 24.0 + t4 / 720.0 - t6 / 40320.0,
                    2.0 * sh * sh / st2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0 - t6 / 362880.0,
                    (1.0 - A) / st2)
    return A, B, C


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """[6] (omega, upsilon) -> [4, 4]."""
    w, v = xi[..., :3], xi[..., 3:]
    A, B, C = _sinc_coeffs(torch.sum(w * w, dim=-1))
    W = hat(w)
    eye = torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * (W @ W)
    V = eye + B[..., None, None] * W + C[..., None, None] * (W @ W)
    t = torch.einsum("...ij,...j->...i", V, v)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def _camera_point(T, X):
    return torch.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]


def _residual(cam: Intrinsics, pc, uv, ur, stereo):
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    r3 = torch.where(stereo, u - cam.bf / zs - ur, 0.0)
    return torch.stack([u - uv[..., 0], v - uv[..., 1], r3], dim=-1)


def _jacobian(cam: Intrinsics, pc, stereo):
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    Ju = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    Jv = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    Jur = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], dim=-1)
    Jur = torch.where(stereo[..., None], Jur, 0.0)
    Jproj = torch.stack([Ju, Jv, Jur], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    return Jproj @ torch.cat([-hat(pc), eye], dim=-1)


def pose_optimization(cam: Intrinsics, Tcw0, X, uv, ur, inv_sigma2, valid, stereo,
                      n_rounds: int = 4, iters_per_round: int = 10):
    """One problem: Tcw0 [4,4], X [N,3], uv [N,2], ur [N], inv_sigma2 [N]
    in one float dtype, valid and stereo [N] bool. Returns (Tcw [4,4],
    inliers [N] bool, num_inliers int32, chi2 [N])."""
    chi2_th = torch.where(stereo, CHI2_STEREO, CHI2_MONO)

    def residual_chi2(T):
        pc = _camera_point(T, X)
        r = _residual(cam, pc, uv, ur, stereo)
        c2 = inv_sigma2 * torch.sum(r * r, dim=-1)
        return pc, r, torch.where(pc[..., 2] > 0.05, c2, 1e9)

    def weights(c2, use_huber, active):
        if use_huber:
            safe = torch.clamp_min(c2, 1e-12)
            w_h = torch.where(c2 <= chi2_th, 1.0, torch.sqrt(chi2_th / safe))
        else:
            w_h = 1.0
        return inv_sigma2 * w_h * active.to(X.dtype)

    T = Tcw0
    active = valid
    for round_idx in range(n_rounds):
        use_huber = round_idx < 2
        lam = torch.tensor(1e-3, dtype=T.dtype, device=T.device)
        for _ in range(iters_per_round):
            pc, r, c2 = residual_chi2(T)
            w = weights(c2, use_huber, active)
            Jp = _jacobian(cam, pc, stereo)
            H = torch.einsum("n,nri,nrj->ij", w, Jp, Jp)
            g = -torch.einsum("n,nri,nr->i", w, Jp, r)
            cost = torch.sum(w * torch.sum(r * r, dim=-1))
            D = torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))
            delta = torch.linalg.solve_ex(H + lam * D, g).result
            T_new = se3_exp(delta) @ T
            _, r2, c2_2 = residual_chi2(T_new)
            w2 = weights(c2_2, use_huber, active)
            new_cost = torch.sum(w2 * torch.sum(r2 * r2, dim=-1))
            accept = (new_cost < cost) & torch.all(torch.isfinite(delta))
            T = torch.where(accept, T_new, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e6)
        _, _, c2 = residual_chi2(T)
        active = valid & (c2 <= chi2_th)
    _, _, c2 = residual_chi2(T)
    inliers = valid & (c2 <= chi2_th)
    return T, inliers, torch.sum(inliers, dtype=torch.int32), c2


def truncated_cost(cam: Intrinsics, Tcw, X, uv, ur, inv_sigma2, valid, stereo):
    """The robust cost of a pose: over the valid observations, each one's
    chi2 truncated at its outlier threshold (a point at or behind z = 0.05
    counts the threshold). Continuous in the pose, so a solve that stops
    apart along a weakly determined direction reads nearly the same, and
    an observation that crosses the threshold changes nothing by a jump."""
    chi2_th = torch.where(stereo, CHI2_STEREO, CHI2_MONO).to(X.dtype)
    pc = _camera_point(Tcw, X)
    r = _residual(cam, pc, uv, ur, stereo)
    c2 = inv_sigma2 * torch.sum(r * r, dim=-1)
    c2 = torch.where(pc[..., 2] > 0.05, torch.minimum(c2, chi2_th), chi2_th)
    return torch.sum(torch.where(valid, c2, 0.0))
