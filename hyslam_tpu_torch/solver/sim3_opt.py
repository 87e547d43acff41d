"""Sim3 refinement between two keyframes (counterpart of
``hyslam_tpu/solver/sim3_opt.py``): the relative Sim3 g12 under forward
(X2 -> image 1) and inverse (X1 -> image 2) reprojection residuals, Huber
weighted (delta^2 10), two rounds of LM over the 7-dof left perturbation
g <- exp(dx) g, the outliers reclassified between them over all valid pairs.

The JAX package takes the [N, 2, 7] Jacobians by forward-mode autodiff
through ``sim3.exp``; here they are written out. At dx = 0 the perturbed
point of the forward residual moves by [p, -hat(p), I] dx (p = g X2), that
of the inverse residual by -(1/s) R^T [X1, -hat(X1), I] dx, each through the
pinhole's derivative. The damped 7x7 system is solved by Cholesky; where it
fails to factor the step is zero and LM rejects it. Nothing is read back to
the host.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.estimators.sim3_solver import project_z
from hyslam_tpu_torch.geometry import sim3, so3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.solver.robust import huber_weight

DELTA2 = 10.0   # Huber delta^2
CHI2_INLIER = 9.21


def _project_jac(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """d(pixel)/d(point) [..., 2, 3] of project_z; the held depth has no
    derivative."""
    zr = pc[..., 2]
    z = torch.clamp_min(zr, 1e-6)
    dz = (zr > 1e-6).to(pc.dtype)
    zero = torch.zeros_like(z)
    ru = torch.stack([cam.fx / z, zero, -cam.fx * pc[..., 0] / (z * z) * dz], dim=-1)
    rv = torch.stack([zero, cam.fy / z, -cam.fy * pc[..., 1] / (z * z) * dz], dim=-1)
    return torch.stack([ru, rv], dim=-2)


def _point_jac(p: torch.Tensor) -> torch.Tensor:
    """d(exp(dx) p)/d(dx) at dx = 0, [..., 3, 7]: [p, -hat(p), I]."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape + (3,))
    return torch.cat([p[..., None], -so3.hat(p), eye], dim=-1)


def residuals(cam1: Camera, cam2: Camera, g, X1, X2, uv1, uv2):
    """(r1 [N,2], r2 [N,2]): X2 through g into image 1, X1 through g^-1 into
    image 2, less the observed pixels."""
    r1 = project_z(cam1, sim3.apply(g, X2)) - uv1
    r2 = project_z(cam2, sim3.apply(sim3.inverse(g), X1)) - uv2
    return r1, r2


def jacobians(cam1: Camera, cam2: Camera, g, X1, X2, fix_scale: bool = False):
    """(J1, J2), each [N, 2, 7]: the residuals' derivatives in the left
    perturbation of g at zero (column 0 zero with a fixed scale)."""
    p1 = sim3.apply(g, X2)
    J1 = _project_jac(cam1, p1) @ _point_jac(p1)
    s, R, _ = sim3.unpack(g)
    p2 = sim3.apply(sim3.inverse(g), X1)
    dq = -(R.transpose(-1, -2) / s[..., None, None]) @ _point_jac(X1)   # [N, 3, 7]
    J2 = _project_jac(cam2, p2) @ dq
    if fix_scale:
        J1 = torch.cat([torch.zeros_like(J1[..., :1]), J1[..., 1:]], dim=-1)
        J2 = torch.cat([torch.zeros_like(J2[..., :1]), J2[..., 1:]], dim=-1)
    return J1, J2


def _chi2(cam1, cam2, g, X1, X2, uv1, uv2, is2_1, is2_2):
    r1, r2 = residuals(cam1, cam2, g, X1, X2, uv1, uv2)
    return is2_1 * torch.sum(r1 * r1, -1), is2_2 * torch.sum(r2 * r2, -1)


def _lm_round(cam1, cam2, g, X1, X2, uv1, uv2, is2_1, is2_2, active, fix_scale, n_iters):
    lam = torch.full((), 1e-3, dtype=g.dtype, device=g.device)
    for _ in range(n_iters):
        J1, J2 = jacobians(cam1, cam2, g, X1, X2, fix_scale)
        r1, r2 = residuals(cam1, cam2, g, X1, X2, uv1, uv2)
        c1 = is2_1 * torch.sum(r1 * r1, -1)
        c2 = is2_2 * torch.sum(r2 * r2, -1)
        w1 = is2_1 * huber_weight(c1, DELTA2) * active
        w2 = is2_2 * huber_weight(c2, DELTA2) * active
        H = (torch.einsum("n,nri,nrj->ij", w1, J1, J1)
             + torch.einsum("n,nri,nrj->ij", w2, J2, J2))
        b = -(torch.einsum("n,nri,nr->i", w1, J1, r1)
              + torch.einsum("n,nri,nr->i", w2, J2, r2))
        A = H + lam * torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))
        Lf, info = torch.linalg.cholesky_ex(A)
        # with a fixed scale row and column 0 of H and b[0] are zero, so the
        # step's scale component is exactly 0
        dx = torch.cholesky_solve(b[:, None], Lf)[:, 0]
        ok = (info == 0) & torch.all(torch.isfinite(dx))
        dx = torch.where(ok, dx, 0.0)
        g_new = sim3.compose(sim3.exp(dx), g)
        c1n, c2n = _chi2(cam1, cam2, g_new, X1, X2, uv1, uv2, is2_1, is2_2)
        cost = torch.sum(w1 * c1 + w2 * c2)
        cost_new = torch.sum(w1 * c1n + w2 * c2n)
        accept = (cost_new < cost) & ok
        g = torch.where(accept, g_new, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e5)
    return g


def optimize_sim3(cam1: Camera, cam2: Camera, g12: torch.Tensor, X1, X2, uv1, uv2,
                  inv_sigma2_1, inv_sigma2_2, valid, fix_scale: bool = False,
                  n_iters: int = 10, seed_inliers: torch.Tensor | None = None):
    """Returns (g12 refined, inliers [N], their count). seed_inliers: the
    pairs the first round trusts (the RANSAC consensus set); the second
    round takes every valid pair whose chi2 is under 9.21 in both images."""
    args = (cam1, cam2)
    data = (X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2)
    seed = valid if seed_inliers is None else (valid & seed_inliers)
    g = _lm_round(*args, g12, *data, seed.to(g12.dtype), fix_scale, n_iters)
    c1, c2 = _chi2(*args, g, *data)
    inl = valid & (c1 < CHI2_INLIER) & (c2 < CHI2_INLIER)
    g = _lm_round(*args, g, *data, inl.to(g12.dtype), fix_scale, n_iters)
    c1, c2 = _chi2(*args, g, *data)
    inl = valid & (c1 < CHI2_INLIER) & (c2 < CHI2_INLIER)
    return g, inl, torch.sum(inl, dtype=torch.int32)
