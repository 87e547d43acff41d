"""Plain reference of the mapper's local bundle adjustment: Levenberg-
Marquardt over keyframe poses and landmark positions with the landmark
block eliminated exactly (Schur complement, dense [6K, 6K] reduced camera
system factored by Cholesky), in the reference's two phases
(LocalBundleAdjustment.cc:113-152): 5 iterations under Huber, the chi2
outliers demoted, then 10 without them.

A frozen copy of the port's plain PyTorch dense solve without pose priors
(the path local BA takes where no sensor reading or registered sub-map
exists) as the benchmark was defined, written out in one file so that it
imports nothing of the program. It takes the problem the mapper gathered
and solved, field by field, and solves it again.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference.pose_opt import CHI2_MONO, CHI2_STEREO, hat, se3_exp


class Solved(NamedTuple):
    kf_Tcw: torch.Tensor
    lm_pos: torch.Tensor
    obs_inlier: torch.Tensor


def _huber_weight(c2, delta2):
    return torch.where(c2 <= delta2, 1.0, torch.sqrt(delta2 / torch.clamp_min(c2, 1e-12)))


def _huber_rho(c2, delta2):
    d = torch.sqrt(torch.as_tensor(delta2, dtype=c2.dtype, device=c2.device))
    e = torch.sqrt(torch.clamp_min(c2, 0.0))
    return torch.where(c2 <= delta2, c2, 2.0 * d * e - delta2)


def _residuals(p, kf_Tcw, lm_pos):
    kf = p.obs.kf.clamp(0, kf_Tcw.shape[0] - 1).long()
    T = kf_Tcw[kf]
    pc = torch.einsum("...ij,...j->...i", T[..., :3, :3], lm_pos[:, None, :]) + T[..., :3, 3]
    fx, fy, cx, cy, bf = (a[kf] for a in p.cams)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    r3 = torch.where(p.obs.stereo, u - bf / zs - p.obs.ur, 0.0)
    r = torch.stack([u - p.obs.uv[..., 0], v - p.obs.uv[..., 1], r3], dim=-1)
    return r, pc, (fx, fy, bf), T


def _jacobians(pc, fx, fy, bf, stereo, T):
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / zs
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    Jv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    Jur = torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], dim=-1)
    Jur = torch.where(stereo[..., None], Jur, 0.0)
    Jproj = torch.stack([Ju, Jv, Jur], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    return Jproj @ torch.cat([-hat(pc), eye], dim=-1), Jproj @ T[..., :3, :3]


def _inv3x3(A):
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    co00, co01, co02 = e * i - f * h, c * h - b * i, b * f - c * e
    co10, co11, co12 = f * g - d * i, a * i - c * g, c * d - a * f
    co20, co21, co22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * co00 + b * co10 + c * co20
    det = torch.where(torch.abs(det) < 1e-18, 1e-18, det)
    adj = torch.stack([torch.stack([co00, co01, co02], -1),
                       torch.stack([co10, co11, co12], -1),
                       torch.stack([co20, co21, co22], -1)], dim=-2)
    return adj / det[..., None, None]


def _chol3x3(A):
    def s(x):
        return torch.sqrt(torch.clamp_min(x, 1e-18))

    l00 = s(A[..., 0, 0])
    l10 = A[..., 1, 0] / l00
    l11 = s(A[..., 1, 1] - l10 * l10)
    l20 = A[..., 2, 0] / l00
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = s(A[..., 2, 2] - l20 * l20 - l21 * l21)
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z, z], -1), torch.stack([l10, l11, z], -1),
                        torch.stack([l20, l21, l22], -1)], dim=-2)


def _delta2(p):
    return torch.where(p.obs.stereo, CHI2_STEREO, CHI2_MONO)


def _cost(p, kf_Tcw, lm_pos, huber):
    r, pc, _, _ = _residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    cost = _huber_rho(c2, _delta2(p)) if huber else c2
    w_valid = p.obs.valid & p.lm_valid[:, None] & (pc[..., 2] > 0.0)
    return torch.sum(cost * w_valid.to(r.dtype))


def _trace(M):
    return M.diagonal(dim1=-2, dim2=-1).sum(-1)


def _segment_sum(vals, kf_idx, K):
    out = torch.zeros((K,) + vals.shape[2:], dtype=vals.dtype, device=vals.device)
    return out.index_put_((kf_idx.reshape(-1),), vals.reshape((-1,) + vals.shape[2:]),
                          accumulate=True)


def _step(p, kf_Tcw, lm_pos, lam, obs_active, huber, chunk):
    """One linearization, Schur reduction and solve: (delta_pose [K,6],
    delta_lm [L,3])."""
    K = kf_Tcw.shape[0]
    dtype, dev = kf_Tcw.dtype, kf_Tcw.device
    r, pc, (fx, fy, bf), T = _residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    w_h = _huber_weight(c2, _delta2(p)) if huber else 1.0
    w = p.obs.inv_sigma2 * w_h * (obs_active & p.lm_valid[:, None] & (pc[..., 2] > 0.0)).to(dtype)
    J_pose, J_point = _jacobians(pc, fx, fy, bf, p.obs.stereo, T)
    kf_idx = p.obs.kf.clamp(0, K - 1).long()
    Hpp = _segment_sum(torch.einsum("lo,lori,lorj->loij", w, J_pose, J_pose), kf_idx, K)
    b_pose = _segment_sum(-torch.einsum("lo,lori,lor->loi", w, J_pose, r), kf_idx, K)
    V = torch.einsum("lo,lori,lorj->lij", w, J_point, J_point)
    b_lm = -torch.einsum("lo,lori,lor->li", w, J_point, r)
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Vinv = _inv3x3(V + lam * eye3 * torch.clamp_min(_trace(V) / 3.0, 1e-6)[:, None, None])
    M = _chol3x3(Vinv)
    Wlo = torch.einsum("lo,lori,lorj->loij", w, J_pose, J_point)
    Y = Wlo @ M[:, None]
    y = torch.einsum("lji,lj->li", M, b_lm)

    # dense Schur reduction over landmark chunks
    L, O = kf_idx.shape
    n_chunks = (L + chunk - 1) // chunk
    pad = n_chunks * chunk - L
    Y_p = torch.nn.functional.pad(Y, (0, 0, 0, 0, 0, 0, 0, pad))
    y_p = torch.nn.functional.pad(y, (0, 0, 0, pad))
    kf_p = torch.nn.functional.pad(kf_idx, (0, 0, 0, pad))
    S_red = torch.zeros((K * 6, K * 6), dtype=dtype, device=dev)
    b_red = torch.zeros((K, 6), dtype=dtype, device=dev)
    rows = torch.arange(chunk, device=dev)[:, None] * K
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        Z = torch.zeros((chunk * K, 6, 3), dtype=dtype, device=dev).index_add_(
            0, (rows + kf_p[sl]).reshape(-1), Y_p[sl].reshape(-1, 6, 3)).reshape(chunk, K, 6, 3)
        Zf = Z.permute(0, 3, 1, 2).reshape(chunk * 3, K * 6)
        S_red = S_red + Zf.T @ Zf
        b_red = b_red + torch.einsum("lkab,lb->ka", Z, y_p[sl])

    # the damped reduced camera system; fixed and unobserved poses get
    # identity rows and a zero step
    tr = _trace(Hpp)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    Hpp_d = Hpp + lam * eye6 * torch.clamp_min(tr / 6.0, 1e-6)[:, None, None]
    idx = torch.arange(K, device=dev)
    S = torch.zeros((K, 6, K, 6), dtype=dtype, device=dev)
    S[idx, :, idx, :] = Hpp_d
    S = S.reshape(K * 6, K * 6) - S_red
    bhat = (b_pose - b_red).reshape(K * 6)
    fmask = ((~p.kf_fixed) & (tr > 0)).to(dtype).repeat_interleave(6)
    S = S * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
    Lf, info = torch.linalg.cholesky_ex(S)
    delta = torch.cholesky_solve((bhat * fmask)[:, None], Lf)[:, 0]
    dp = torch.where((info == 0) & torch.isfinite(delta), delta, 0.0).reshape(K, 6)

    rhs = b_lm - torch.einsum("loij,loi->lj", Wlo, dp[kf_idx])
    dl = torch.einsum("lij,lj->li", Vinv, rhs)
    return dp, torch.where(p.lm_valid[:, None] & torch.isfinite(dl), dl, 0.0)


def bundle_adjustment(p, n_iters, huber, chunk=256, obs_active=None, lam0=1e-4) -> Solved:
    obs_active = p.obs.valid if obs_active is None else obs_active & p.obs.valid
    pa = p._replace(obs=p.obs._replace(valid=obs_active))
    kf_Tcw, lm_pos = p.kf_Tcw, p.lm_pos
    lam = torch.full((), lam0, dtype=kf_Tcw.dtype, device=kf_Tcw.device)
    cost = _cost(pa, kf_Tcw, lm_pos, huber)
    for _ in range(n_iters):
        dp, dl = _step(p, kf_Tcw, lm_pos, lam, obs_active, huber, chunk)
        kf_new = torch.where(p.kf_fixed[:, None, None], kf_Tcw, se3_exp(dp) @ kf_Tcw)
        lm_new = lm_pos + dl
        new_cost = _cost(pa, kf_new, lm_new, huber)
        accept = new_cost < cost
        kf_Tcw = torch.where(accept, kf_new, kf_Tcw)
        lm_pos = torch.where(accept, lm_new, lm_pos)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        cost = torch.minimum(new_cost, cost)
    r, pc, _, _ = _residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    inlier = p.obs.valid & (c2 <= _delta2(p)) & (pc[..., 2] > 0.0)
    return Solved(kf_Tcw, lm_pos, inlier)


def local_ba_two_phase(p, chunk: int = 256) -> Solved:
    """``p`` has the fields of the mapper's problem: kf_Tcw [K,4,4],
    kf_fixed [K], cams (fx, fy, cx, cy, bf: [K] each), lm_pos [L,3],
    lm_valid [L], obs (kf, uv, ur, inv_sigma2, stereo, valid: [L,O...])."""
    phase1 = bundle_adjustment(p, n_iters=5, huber=True, chunk=chunk)
    p2 = p._replace(kf_Tcw=phase1.kf_Tcw, lm_pos=phase1.lm_pos)
    return bundle_adjustment(p2, n_iters=10, huber=False, chunk=chunk,
                             obs_active=phase1.obs_inlier)


def truncated_cost(p, kf_Tcw, lm_pos):
    """The robust cost of a solution: over the valid observations of valid
    landmarks, each one's chi2 truncated at its outlier threshold (a point
    at or behind z = 0 counts the threshold). Continuous in the solution,
    so two sound solves that stop apart along a weakly determined direction
    (a far landmark's depth) read nearly the same."""
    r, pc, _, _ = _residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    d2 = _delta2(p).to(c2.dtype)
    c2 = torch.where(pc[..., 2] > 0.0, torch.minimum(c2, d2), d2)
    return torch.sum(torch.where(p.obs.valid & p.lm_valid[:, None], c2, 0.0))
