"""Bundle adjustment with Schur-complement landmark marginalization
(counterpart of ``hyslam_tpu/solver/ba.py``: the dense solve, the
matrix-free CG solve, and sensor / tiepoint pose priors; the sharded solve
over several devices, ``psum_axis``, is ROADMAP step 20).

Levenberg-Marquardt over keyframe poses [K] and landmark positions [L], the
landmark block eliminated exactly:

  for each landmark l with (padded) observations o
    V_l  = sum_o w J_pt^T J_pt + lambda diag      (3x3, closed-form inverse)
    W_lo = w J_pose^T J_pt,  Y_lo = W_lo M_l,  M_l M_l^T = V_l^-1
  S = Hpp_diag - sum_chunks Z_c^T Z_c,  b^ = b_pose - sum_chunks Z_c^T y_c

where Z scatters Y by keyframe. The scatters are accumulating: an invalid
observation has its keyframe clipped to slot 0 and carries a zero Y, which
only adds nothing when the scatter adds. Hpp and b_pose, which sum many
observations per keyframe, are summed by ``index_put_(accumulate=True)``,
which adds in row order on the CPU and on a card alike, so BA gives the
same bits on every run. The
reduced system is solved by ``cholesky_ex`` + ``cholesky_solve``; where the
factorization fails (info != 0) the pose step is zero, as the JAX package's
NaN -> 0 gives it. ``solver="cg"`` never forms the [6K,6K] system: it runs
block-Jacobi preconditioned conjugate gradients on matrix-free products, a
fixed number of iterations with a converged mask under the stopping rule of
``jax.scipy.sparse.linalg.cg`` (||r|| <= tol ||b||), so that no residual is
read per iteration. Nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.geometry import se3, so3
from hyslam_tpu_torch.solver import robust
from hyslam_tpu_torch.solver.priors import (
    PosePriors,
    linearize_priors_blocks,
    prior_cost,
    tie_offdiag_dense,
    tie_offdiag_matvec,
)

CG_MIN_KEYFRAMES = 512   # solver="auto" picks the CG path from here on


class CamArrays(NamedTuple):
    """Per-keyframe pinhole parameters [K]."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    bf: torch.Tensor


class BAObservations(NamedTuple):
    """Padded per-landmark observation blocks: kf [L,O] int32, uv [L,O,2],
    ur [L,O], inv_sigma2 [L,O], stereo [L,O] bool, valid [L,O] bool."""

    kf: torch.Tensor
    uv: torch.Tensor
    ur: torch.Tensor
    inv_sigma2: torch.Tensor
    stereo: torch.Tensor
    valid: torch.Tensor


class BAProblem(NamedTuple):
    kf_Tcw: torch.Tensor      # [K, 4, 4]
    kf_fixed: torch.Tensor    # [K] bool pose held constant
    cams: CamArrays           # [K] intrinsics
    lm_pos: torch.Tensor      # [L, 3]
    lm_valid: torch.Tensor    # [L] bool
    obs: BAObservations
    priors: PosePriors | None = None  # sensor + tiepoint pose priors


class BAResult(NamedTuple):
    kf_Tcw: torch.Tensor
    lm_pos: torch.Tensor
    obs_chi2: torch.Tensor     # [L, O] final chi2 per observation
    obs_inlier: torch.Tensor   # [L, O] chi2 <= threshold & positive depth
    cost: torch.Tensor         # final robust cost


def _obs_residuals(p: BAProblem, kf_Tcw, lm_pos):
    """Residuals r [L,O,3], camera-frame points pc [L,O,3], the per-obs
    camera (fx, fy, bf) and pose T [L,O,4,4]."""
    kf = p.obs.kf.clamp(0, kf_Tcw.shape[0] - 1).long()
    T = kf_Tcw[kf]
    pc = se3.apply(T, lm_pos[:, None, :])
    fx, fy, cx, cy, bf = (a[kf] for a in p.cams)
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * pc[..., 0] / zs + cx
    v = fy * pc[..., 1] / zs + cy
    ur = u - bf / zs
    r3 = torch.where(p.obs.stereo, ur - p.obs.ur, 0.0)
    r = torch.stack([u - p.obs.uv[..., 0], v - p.obs.uv[..., 1], r3], dim=-1)
    return r, pc, (fx, fy, bf), T


def _obs_jacobians(pc, fx, fy, bf, stereo, T):
    """J_pose [L,O,3,6] (left-multiplicative tangent), J_point [L,O,3,3]."""
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
    dpc = torch.cat([-so3.hat(pc), eye], dim=-1)
    return Jproj @ dpc, Jproj @ T[..., :3, :3]


def _inv3x3(A):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
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
    """Batched closed-form lower Cholesky factor of SPD 3x3 (guarded sqrt)."""
    def s(x):
        return torch.sqrt(torch.clamp_min(x, 1e-18))

    l00 = s(A[..., 0, 0])
    l10 = A[..., 1, 0] / l00
    l11 = s(A[..., 1, 1] - l10 * l10)
    l20 = A[..., 2, 0] / l00
    l21 = (A[..., 2, 1] - l20 * l10) / l11
    l22 = s(A[..., 2, 2] - l20 * l20 - l21 * l21)
    z = torch.zeros_like(l00)
    return torch.stack([torch.stack([l00, z, z], -1),
                        torch.stack([l10, l11, z], -1),
                        torch.stack([l20, l21, l22], -1)], dim=-2)


def _delta2(p: BAProblem):
    return torch.where(p.obs.stereo, robust.CHI2_STEREO, robust.CHI2_MONO)


def _robust_cost(p: BAProblem, kf_Tcw, lm_pos, huber: bool):
    r, pc, _, _ = _obs_residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    cost = robust.huber_rho(c2, _delta2(p)) if huber else c2
    w_valid = p.obs.valid & p.lm_valid[:, None] & (pc[..., 2] > 0.0)
    total = torch.sum(cost * w_valid.to(r.dtype))
    if p.priors is not None:
        total = total + prior_cost(kf_Tcw, p.priors)
    return total


def _trace(M):
    return M.diagonal(dim1=-2, dim2=-1).sum(-1)


def _linearize_factors(p: BAProblem, kf_Tcw, lm_pos, lam, obs_active,
                       huber: bool):
    """Linearize all observations and eliminate the landmark block. Returns
    (Hpp [K,6,6], b_pose [K,6], Y [L,O,6,3], y [L,3], Vinv [L,3,3],
    Wlo [L,O,6,3], b_lm [L,3], kf_idx [L,O])."""
    K = kf_Tcw.shape[0]
    dtype = kf_Tcw.dtype
    r, pc, (fx, fy, bf), T = _obs_residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    w_h = robust.huber_weight(c2, _delta2(p)) if huber else 1.0
    w = p.obs.inv_sigma2 * w_h * (
        obs_active & p.lm_valid[:, None] & (pc[..., 2] > 0.0)).to(dtype)

    J_pose, J_point = _obs_jacobians(pc, fx, fy, bf, p.obs.stereo, T)
    kf_idx = p.obs.kf.clamp(0, K - 1).long()

    # pose-diagonal blocks and gradient, scattered by keyframe (adding, in
    # row order on every device: index_add_ on a card adds atomically, in
    # an order that changes from run to run)
    Hpp_blk = torch.einsum("lo,lori,lorj->loij", w, J_pose, J_pose)
    bp_blk = -torch.einsum("lo,lori,lor->loi", w, J_pose, r)
    Hpp = _segment_sum(Hpp_blk, kf_idx, K)
    b_pose = _segment_sum(bp_blk, kf_idx, K)

    # landmark blocks
    V = torch.einsum("lo,lori,lorj->lij", w, J_point, J_point)
    b_lm = -torch.einsum("lo,lori,lor->li", w, J_point, r)
    eye3 = torch.eye(3, dtype=dtype, device=w.device)
    V_d = V + lam * eye3 * torch.clamp_min(_trace(V) / 3.0, 1e-6)[:, None, None]
    Vinv = _inv3x3(V_d)
    M = _chol3x3(Vinv)                                       # Vinv = M M^T
    Wlo = torch.einsum("lo,lori,lorj->loij", w, J_pose, J_point)
    Y = Wlo @ M[:, None]
    y = torch.einsum("lji,lj->li", M, b_lm)                  # M^T b
    return Hpp, b_pose, Y, y, Vinv, Wlo, b_lm, kf_idx


def _schur_reduce_dense(Y, y, kf_idx, K: int, chunk: int):
    """Dense Schur reduction over landmark chunks. Z[l, k] is built with an
    accumulating scatter (at most one real observation per (l, k); padded
    ones add zero). Returns (S_red [6K,6K], b_red [K,6])."""
    L, O = kf_idx.shape
    dtype, dev = Y.dtype, Y.device
    n_chunks = (L + chunk - 1) // chunk
    pad = n_chunks * chunk - L
    Y_p = torch.nn.functional.pad(Y, (0, 0, 0, 0, 0, 0, 0, pad))
    y_p = torch.nn.functional.pad(y, (0, 0, 0, pad))
    kf_p = torch.nn.functional.pad(kf_idx, (0, 0, 0, pad))
    S = torch.zeros((K * 6, K * 6), dtype=dtype, device=dev)
    bh = torch.zeros((K, 6), dtype=dtype, device=dev)
    rows = torch.arange(chunk, device=dev)[:, None] * K
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        Z = torch.zeros((chunk * K, 6, 3), dtype=dtype, device=dev).index_add_(
            0, (rows + kf_p[sl]).reshape(-1), Y_p[sl].reshape(-1, 6, 3)
        ).reshape(chunk, K, 6, 3)
        Zf = Z.permute(0, 3, 1, 2).reshape(chunk * 3, K * 6)  # [(l b), (k a)]
        S = S + Zf.T @ Zf
        bh = bh + torch.einsum("lkab,lb->ka", Z, y_p[sl])
    return S, bh


def _linearize(p: BAProblem, kf_Tcw, lm_pos, lam, obs_active, huber: bool,
               chunk: int):
    """Linearize every observation and reduce the landmark block, dense:
    (Hpp [K,6,6], b_pose [K,6], S_red [6K,6K], b_red [K,6], Vinv [L,3,3],
    Wlo [L,O,6,3], b_lm [L,3], kf_idx [L,O]). For a caller that adds its
    own pose blocks before the solve (imaging BA's trajectory anchors)."""
    K = kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, Vinv, Wlo, b_lm, kf_idx = _linearize_factors(
        p, kf_Tcw, lm_pos, lam, obs_active, huber)
    S_red, b_red = _schur_reduce_dense(Y, y, kf_idx, K, chunk)
    return Hpp, b_pose, S_red, b_red, Vinv, Wlo, b_lm, kf_idx


def _segment_sum(vals: torch.Tensor, kf_idx: torch.Tensor, K: int) -> torch.Tensor:
    """Sum vals [L,O,...] by keyframe into [K,...], adding in row order."""
    out = torch.zeros((K,) + vals.shape[2:], dtype=vals.dtype, device=vals.device)
    return out.index_put_((kf_idx.reshape(-1),), vals.reshape((-1,) + vals.shape[2:]),
                          accumulate=True)


def _reduced_matvec(Y, kf_idx, x):
    """Matrix-free S_red @ x for x [K,6]: t_l = sum_o Y[l,o]^T x[kf(l,o)],
    then sum_o Y[l,o] t_l scattered back by keyframe. O(L*O) a product."""
    t = torch.einsum("loac,loa->lc", Y, x[kf_idx])
    return _segment_sum(torch.einsum("loac,lc->loa", Y, t), kf_idx, x.shape[0])


def _reduced_rhs(Y, y, kf_idx, K: int):
    """b_red [K,6] = sum_l A_{l,k} y_l, matrix-free."""
    return _segment_sum(torch.einsum("loac,lc->loa", Y, y), kf_idx, K)


def _reduced_diag(Y, kf_idx, K: int):
    """Block diagonal of S_red [K,6,6], for the block-Jacobi preconditioner:
    the sum over observations of Y Y^T, scattered by keyframe."""
    return _segment_sum(torch.einsum("loac,lobc->loab", Y, Y), kf_idx, K)


def _damped(Hpp, lam):
    tr = _trace(Hpp)
    eye6 = torch.eye(6, dtype=Hpp.dtype, device=Hpp.device)
    return Hpp + lam * eye6 * torch.clamp_min(tr / 6.0, 1e-6)[:, None, None], tr


def _solve_poses(Hpp, b_pose, S_red, b_red, kf_fixed, lam):
    """Solve the damped reduced camera system; fixed and unobserved poses
    get identity rows and a zero step. Returns delta_pose [K, 6]."""
    K = Hpp.shape[0]
    dtype, dev = Hpp.dtype, Hpp.device
    Hpp_d, tr = _damped(Hpp, lam)
    idx = torch.arange(K, device=dev)
    S = torch.zeros((K, 6, K, 6), dtype=dtype, device=dev)
    S[idx, :, idx, :] = Hpp_d
    S = S.reshape(K * 6, K * 6) - S_red
    bhat = (b_pose - b_red).reshape(K * 6)
    fmask = ((~kf_fixed) & (tr > 0)).to(dtype).repeat_interleave(6)
    S = S * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
    bhat = bhat * fmask
    Lf, info = torch.linalg.cholesky_ex(S)
    delta = torch.cholesky_solve(bhat[:, None], Lf)[:, 0]
    delta = torch.where((info == 0) & torch.isfinite(delta), delta, 0.0)
    return delta.reshape(K, 6)


def _solve_poses_cg(Hpp, b_pose, b_red, Y, kf_idx, kf_fixed, lam,
                    priors: PosePriors | None = None,
                    Hab: torch.Tensor | None = None,
                    n_cg: int = 200, tol: float = 1e-5):
    """Solve the reduced camera system by preconditioned CG on matrix-free
    products: S x = Hpp_d x - S_red x (+ the tiepoint off-diagonal), the
    preconditioner block-Jacobi on the exact 6x6 diagonal blocks of S (their
    Cholesky factors; a block that fails to factor preconditions with the
    identity). The loop runs n_cg times; a system that has met
    ||r||^2 <= tol^2 ||b||^2 stops changing, so the result is that of
    ``jax.scipy.sparse.linalg.cg`` with the same tol and maxiter."""
    K = Hpp.shape[0]
    dtype, dev = Hpp.dtype, Hpp.device
    Hpp_d, tr = _damped(Hpp, lam)
    free = (~kf_fixed) & (tr > 0)
    fm = free[:, None].to(dtype)                                  # [K,1]

    def S_mv(x):
        xz = x * fm
        out = torch.einsum("kij,kj->ki", Hpp_d, xz) - _reduced_matvec(Y, kf_idx, xz)
        if priors is not None and Hab is not None:
            out = out + tie_offdiag_matvec(priors, Hab, xz, K)
        # the identity on fixed and unused coordinates keeps S SPD
        return out * fm + x * (1.0 - fm)

    eye6 = torch.eye(6, dtype=dtype, device=dev)
    D = torch.where(free[:, None, None], Hpp_d - _reduced_diag(Y, kf_idx, K), eye6)
    Lf, info = torch.linalg.cholesky_ex(D)
    Dinv = torch.where((info == 0)[:, None, None],
                       torch.cholesky_solve(eye6.expand(K, 6, 6), Lf), eye6)

    def precond(r):
        return torch.einsum("kij,kj->ki", Dinv, r) * fm + r * (1.0 - fm)

    b = (b_pose - b_red) * fm
    atol2 = tol * tol * torch.sum(b * b)
    x = torch.zeros_like(b)
    r = b
    p = z = precond(r)
    gamma = torch.sum(r * z)
    for _ in range(n_cg):
        active = torch.sum(r * r) > atol2
        Ap = S_mv(p)
        alpha = gamma / torch.sum(p * Ap)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        gamma_new = torch.sum(r_new * z)
        p_new = z + (gamma_new / gamma) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        gamma = torch.where(active, gamma_new, gamma)
    return torch.where(torch.isfinite(x) & free[:, None], x, 0.0)


def _backsub(Vinv, Wlo, b_lm, kf_idx, delta_pose, lm_valid):
    """Per-landmark back-substitution."""
    rhs = b_lm - torch.einsum("loij,loi->lj", Wlo, delta_pose[kf_idx])
    delta_lm = torch.einsum("lij,lj->li", Vinv, rhs)
    return torch.where(lm_valid[:, None] & torch.isfinite(delta_lm), delta_lm, 0.0)


def _assemble_and_solve(p: BAProblem, kf_Tcw, lm_pos, lam, obs_active,
                        huber: bool, chunk: int, solver: str = "dense"):
    """One LM linearization + Schur solve -> (delta_pose [K,6],
    delta_lm [L,3]). solver "dense" forms the [6K,6K] reduced system and
    factors it; "cg" runs matrix-free preconditioned CG (memory O(K)). The
    priors' diagonal blocks join Hpp before the damping; the tiepoint
    coupling enters the reduced system off the diagonal."""
    K = kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, Vinv, Wlo, b_lm, kf_idx = _linearize_factors(
        p, kf_Tcw, lm_pos, lam, obs_active, huber)
    Hab = None
    if p.priors is not None:
        Hd_pr, b_pr, Hab = linearize_priors_blocks(kf_Tcw, p.priors)
        Hpp = Hpp + Hd_pr
        b_pose = b_pose + b_pr
    if solver == "cg":
        b_red = _reduced_rhs(Y, y, kf_idx, K)
        delta_pose = _solve_poses_cg(Hpp, b_pose, b_red, Y, kf_idx, p.kf_fixed, lam,
                                     priors=p.priors, Hab=Hab)
    else:
        S_red, b_red = _schur_reduce_dense(Y, y, kf_idx, K, chunk)
        if p.priors is not None:
            S_red = S_red - tie_offdiag_dense(p.priors, Hab, K, Hpp.dtype)
        delta_pose = _solve_poses(Hpp, b_pose, S_red, b_red, p.kf_fixed, lam)
    return delta_pose, _backsub(Vinv, Wlo, b_lm, kf_idx, delta_pose, p.lm_valid)


def _resolve_solver(p: BAProblem, solver: str) -> str:
    if solver == "auto":
        return "cg" if p.kf_Tcw.shape[0] >= CG_MIN_KEYFRAMES else "dense"
    if solver not in ("cg", "dense"):
        raise ValueError(f"unknown solver {solver!r}")
    return solver


def bundle_adjustment(p: BAProblem, n_iters: int = 10, huber: bool = True,
                      chunk: int = 256, obs_active: torch.Tensor | None = None,
                      lam0: float = 1e-4, solver: str = "auto") -> BAResult:
    """LM bundle adjustment over (poses, landmarks). obs_active optionally
    masks observations (the two-phase driver passes the phase-1 inliers).
    A step is kept only where it lowers the robust cost; lambda halves on
    acceptance and quadruples otherwise. solver: "dense", "cg", or "auto"
    (cg from CG_MIN_KEYFRAMES poses on, where the dense reduced system
    leaves the small-map regime)."""
    solver = _resolve_solver(p, solver)
    obs_active = p.obs.valid if obs_active is None else obs_active & p.obs.valid
    pa = p._replace(obs=p.obs._replace(valid=obs_active))
    kf_Tcw, lm_pos = p.kf_Tcw, p.lm_pos
    lam = torch.full((), lam0, dtype=kf_Tcw.dtype, device=kf_Tcw.device)
    cost = _robust_cost(pa, kf_Tcw, lm_pos, huber)
    for _ in range(n_iters):
        dp, dl = _assemble_and_solve(p, kf_Tcw, lm_pos, lam, obs_active, huber, chunk,
                                     solver)
        kf_new = torch.where(p.kf_fixed[:, None, None], kf_Tcw, se3.exp(dp) @ kf_Tcw)
        lm_new = lm_pos + dl
        new_cost = _robust_cost(pa, kf_new, lm_new, huber)
        accept = new_cost < cost
        kf_Tcw = torch.where(accept, kf_new, kf_Tcw)
        lm_pos = torch.where(accept, lm_new, lm_pos)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        cost = torch.minimum(new_cost, cost)

    r, pc, _, _ = _obs_residuals(p, kf_Tcw, lm_pos)
    c2 = p.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    inlier = p.obs.valid & (c2 <= _delta2(p)) & (pc[..., 2] > 0.0)
    return BAResult(kf_Tcw=kf_Tcw, lm_pos=lm_pos, obs_chi2=c2, obs_inlier=inlier,
                    cost=cost)


def local_ba_two_phase(p: BAProblem, chunk: int = 256,
                       solver: str = "auto") -> BAResult:
    """The reference's local-BA schedule (LocalBundleAdjustment.cc:113-152):
    5 robust iterations, demote chi2 outliers, then 10 iterations without
    them; the caller erases the outlier associations afterwards."""
    phase1 = bundle_adjustment(p, n_iters=5, huber=True, chunk=chunk, solver=solver)
    p2 = p._replace(kf_Tcw=phase1.kf_Tcw, lm_pos=phase1.lm_pos)
    return bundle_adjustment(p2, n_iters=10, huber=False, chunk=chunk,
                             obs_active=phase1.obs_inlier, solver=solver)
