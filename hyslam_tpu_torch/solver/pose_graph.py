"""Sim3 pose-graph optimization, the essential graph (counterpart of
``hyslam_tpu/solver/pose_graph.py``).

Vertices are keyframes' Sim3 world->camera poses, edges carry measurements
S_ji; the residual of an edge is r = log(S_ji g_i g_j^-1) [7]. LM over 20
iterations with left perturbations g <- exp(d) g.

The JAX package takes the [E, 7, 14] Jacobians by forward-mode autodiff;
here they are written out. With E = S_ji g_i g_j^-1 and r = log(E):
dr/dd_i = Jl^-1(r) Ad(S_ji) and dr/dd_j = -Jl^-1(r) Ad(E), where Ad is the
Sim3 adjoint and Jl^-1 the inverse left Jacobian, summed as its Bernoulli
series in ad(r) up to the 10th power (its eigenvalues are 0, sigma and
+-i theta; the first term left out is below 1e-9 for |r| < 1).

Two solvers of the damped normal equations:
- ``dense``: the [7K, 7K] system by ``cholesky_ex`` (fixed rows the
  identity), the step zero where the factorization fails or is not finite;
- ``cg``: matrix-free block-Jacobi PCG over edge-block products, as
  ``jax.scipy.sparse.linalg.cg`` with tol 1e-6 and maxiter 4K, which stops
  at ||r||^2 <= tol^2 ||b||^2. Iterations past that test leave the state as
  it is (a mask); the loop reads the test back every CG_CHECK_EVERY
  iterations and stops there, so it stops within that many iterations of
  the JAX solver and returns its result.
``auto`` takes CG from K >= 512.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import sim3, so3

CG_MIN_KEYFRAMES = 512
CG_CHECK_EVERY = 16        # CG iterations between reads of the stopping test

# Bernoulli numbers B_n / n! of Jl^-1 = sum_n B_n / n! ad^n, n = 0..10
_BERNOULLI = (1.0, -0.5, 1.0 / 12.0, 0.0, -1.0 / 720.0, 0.0, 1.0 / 30240.0, 0.0,
              -1.0 / 1209600.0, 0.0, 1.0 / 47900160.0)


def adjoint(g: torch.Tensor) -> torch.Tensor:
    """Ad(g) [..., 7, 7] on (sigma, omega, upsilon) tangents:
    [[1, 0, 0], [0, R, 0], [-t, hat(t) R, s R]]."""
    s, R, t = sim3.unpack(g)
    out = torch.zeros(g.shape[:-1] + (7, 7), dtype=g.dtype, device=g.device)
    out[..., 0, 0] = 1.0
    out[..., 1:4, 1:4] = R
    out[..., 4:7, 0] = -t
    out[..., 4:7, 1:4] = so3.hat(t) @ R
    out[..., 4:7, 4:7] = s[..., None, None] * R
    return out


def ad(xi: torch.Tensor) -> torch.Tensor:
    """ad(xi) [..., 7, 7], the Lie bracket [xi, .]:
    [[0, 0, 0], [0, hat(w), 0], [-v, hat(v), sigma I + hat(w)]]."""
    sigma, w, v = xi[..., 0], xi[..., 1:4], xi[..., 4:7]
    out = torch.zeros(xi.shape[:-1] + (7, 7), dtype=xi.dtype, device=xi.device)
    hw = so3.hat(w)
    out[..., 1:4, 1:4] = hw
    out[..., 4:7, 0] = -v
    out[..., 4:7, 1:4] = so3.hat(v)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    out[..., 4:7, 4:7] = sigma[..., None, None] * eye + hw
    return out


def left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Jl^-1(xi) [..., 7, 7] by the Bernoulli series in ad(xi)."""
    A = ad(xi)
    out = torch.eye(7, dtype=xi.dtype, device=xi.device).expand(A.shape).clone()
    P = out
    for c in _BERNOULLI[1:]:
        P = P @ A
        if c:
            out = out + c * P
    return out


def edge_residual(g_i, g_j, meas_ji):
    """r = log(meas_ji o g_i o g_j^-1) [..., 7]."""
    return sim3.log(sim3.compose(meas_ji, sim3.compose(g_i, sim3.inverse(g_j))))


def edge_jacobians(g_i, g_j, meas_ji, fix_scale: bool = False):
    """(r [E,7], J [E,7,14]): the residual and its derivatives in the left
    perturbations of g_i (columns 0-6) and g_j (7-13)."""
    E = sim3.compose(meas_ji, sim3.compose(g_i, sim3.inverse(g_j)))
    r = sim3.log(E)
    Jinv = left_jacobian_inv(r)
    J = torch.cat([Jinv @ adjoint(meas_ji), -(Jinv @ adjoint(E))], dim=-1)
    if fix_scale:
        J[..., 0] = 0.0
        J[..., 7] = 0.0
    return r, J


def _segment(vals: torch.Tensor, idx: torch.Tensor, K: int) -> torch.Tensor:
    """Ordered accumulation of vals [E, ...] into [K, ...] at idx [E]."""
    out = torch.zeros((K,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_put_((idx,), vals, accumulate=True)


def _solve_dense(Hii, Hjj, Hij, b, ei, ej, free, lam, K: int):
    dtype, dev = b.dtype, b.device
    H = torch.zeros((K * K, 7, 7), dtype=dtype, device=dev)
    idx = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    H.index_put_((idx,), torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]),
                 accumulate=True)
    Hm = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
    fmask = free.to(dtype).repeat_interleave(7)
    diag = torch.diagonal(Hm)
    Hm = Hm + torch.diag(lam * torch.clamp_min(diag, 1e-6))
    Hm = Hm * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
    Lf, info = torch.linalg.cholesky_ex(Hm)
    dx = torch.cholesky_solve((b.reshape(7 * K) * fmask)[:, None], Lf)[:, 0]
    return torch.where(info == 0, dx, 0.0).reshape(K, 7)


def _solve_cg(Hii, Hjj, Hij, b, ei, ej, free, lam, K: int, tol: float = 1e-6):
    dtype, dev = b.dtype, b.device
    Hd = _segment(torch.cat([Hii, Hjj]), torch.cat([ei, ej]), K)      # diagonal blocks
    damp = lam * torch.clamp_min(torch.diagonal(Hd, dim1=-2, dim2=-1), 1e-6)
    fm = free[:, None].to(dtype)
    HijT = Hij.transpose(-1, -2)

    def mv(x):
        xz = x * fm
        oi = (torch.einsum("eij,ej->ei", Hii, xz[ei]) + torch.einsum("eij,ej->ei", Hij, xz[ej]))
        oj = (torch.einsum("eij,ej->ei", HijT, xz[ei]) + torch.einsum("eij,ej->ei", Hjj, xz[ej]))
        out = _segment(torch.cat([oi, oj]), torch.cat([ei, ej]), K) + damp * xz
        return out * fm + x * (1.0 - fm)

    eye7 = torch.eye(7, dtype=dtype, device=dev)
    Dp = torch.where(free[:, None, None], Hd + torch.diag_embed(damp), eye7)
    Lf, info = torch.linalg.cholesky_ex(Dp)
    Dinv = torch.where((info == 0)[:, None, None],
                       torch.cholesky_solve(eye7.expand(K, 7, 7), Lf), eye7)

    def precond(r):
        return torch.einsum("kij,kj->ki", Dinv, r) * fm + r * (1.0 - fm)

    bb = b * fm
    atol2 = tol * tol * torch.sum(bb * bb)
    x = torch.zeros_like(bb)
    r = bb
    p = z = precond(r)
    gamma = torch.sum(r * z)
    done = 0
    while done < 4 * K:
        for _ in range(min(CG_CHECK_EVERY, 4 * K - done)):
            active = torch.sum(r * r) > atol2
            Ap = mv(p)
            alpha = gamma / torch.sum(p * Ap)
            x_new, r_new = x + alpha * p, r - alpha * Ap
            z = precond(r_new)
            gamma_new = torch.sum(r_new * z)
            p_new = z + (gamma_new / gamma) * p
            x = torch.where(active, x_new, x)
            r = torch.where(active, r_new, r)
            p = torch.where(active, p_new, p)
            gamma = torch.where(active, gamma_new, gamma)
            done += 1
        if not bool(torch.sum(r * r) > atol2):   # one read a CG_CHECK_EVERY iterations
            break
    return x


def optimize_pose_graph(g: torch.Tensor, fixed: torch.Tensor, edge_i: torch.Tensor,
                        edge_j: torch.Tensor, edge_meas: torch.Tensor,
                        edge_valid: torch.Tensor, edge_weight: torch.Tensor | None = None,
                        n_iters: int = 20, fix_scale: bool = False,
                        solver: str = "auto") -> torch.Tensor:
    """g [K,8] initial Sim3 world->camera poses, fixed [K] bool, edges
    (i [E], j [E], measurement S_ji [E,8], valid [E], weight [E]). Returns
    the optimized poses [K,8]. solver: 'dense' | 'cg' | 'auto' (CG from
    K >= 512)."""
    K = g.shape[0]
    if solver == "auto":
        solver = "cg" if K >= CG_MIN_KEYFRAMES else "dense"
    if solver not in ("dense", "cg"):
        raise ValueError(f"unknown solver {solver!r}")
    if edge_weight is None:
        edge_weight = torch.ones(edge_i.shape[0], dtype=g.dtype, device=g.device)
    w = edge_weight * edge_valid.to(g.dtype)
    ei = edge_i.long().clamp(0, K - 1)
    ej = edge_j.long().clamp(0, K - 1)
    free = ~fixed

    def cost_of(gv):
        r = edge_residual(gv[ei], gv[ej], edge_meas)
        return torch.sum(w * torch.sum(r * r, -1))

    lam = torch.full((), 1e-4, dtype=g.dtype, device=g.device)
    for _ in range(n_iters):
        r, J = edge_jacobians(g[ei], g[ej], edge_meas, fix_scale)
        Ji, Jj = J[..., :7], J[..., 7:]
        Hii = torch.einsum("e,eri,erj->eij", w, Ji, Ji)
        Hjj = torch.einsum("e,eri,erj->eij", w, Jj, Jj)
        Hij = torch.einsum("e,eri,erj->eij", w, Ji, Jj)
        bi = -torch.einsum("e,eri,er->ei", w, Ji, r)
        bj = -torch.einsum("e,eri,er->ei", w, Jj, r)
        b = _segment(torch.cat([bi, bj]), torch.cat([ei, ej]), K)
        solve = _solve_cg if solver == "cg" else _solve_dense
        dx = solve(Hii, Hjj, Hij, b, ei, ej, free, lam, K)
        if fix_scale:
            dx = torch.cat([torch.zeros_like(dx[:, :1]), dx[:, 1:]], dim=-1)
        dx = torch.where(torch.isfinite(dx) & free[:, None], dx, 0.0)
        g_new = torch.where(fixed[:, None], g, sim3.compose(sim3.exp(dx), g))
        cost = torch.sum(w * torch.sum(r * r, -1))
        accept = cost_of(g_new) < cost
        g = torch.where(accept, g_new, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e5)
    return g
