"""Distributed bundle adjustment: the landmark-sharded Schur reduction
summed over ``torch.distributed`` (counterpart of
``hyslam_tpu/parallel/dist_ba.py``).

Keyframe poses, cameras and pose priors are replicated (small); the
landmark axis of the observation blocks is sharded over the mesh's 'lm'
axis. Each rank linearizes its landmark slice and contributes partial
(Hpp, b_pose, S_red, b_red), which are all-reduced; the reduced camera
system is solved replicated, and the landmark back-substitution stays
shard-local. Where JAX's ``shard_map`` body calls ``psum``, this code calls
``all_reduce`` on the same values at the same places.

Every rank takes the whole problem and returns a whole ``BAResult``: the
landmark positions, chi2 and inlier masks are gathered at the end. Three
rules keep the ranks in step:
- the pose priors stay out of the shard-local cost and linearization and
  are added once, after the reduction (else they would count once a shard);
- the accept and the damping come only from the all-reduced cost, so every
  rank takes the same branch;
- no rank reads a value of its own to decide a branch or to stop a loop:
  the LM loop and the CG loop run their fixed counts and mask, so a rank
  that decided otherwise cannot leave the others waiting in a collective.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.parallel.mesh import Mesh, gather_blocks
from hyslam_tpu_torch.solver.ba import (
    BAObservations,
    BAProblem,
    BAResult,
    CamArrays,
    _backsub,
    _block_jacobi,
    _damped,
    _delta2,
    _linearize_factors,
    _obs_residuals,
    _pcg,
    _reduced_diag,
    _reduced_rhs,
    _resolve_solver,
    _robust_cost,
    _schur_reduce_dense,
    _solve_poses,
    _solve_poses_cg,
    psum,
)
from hyslam_tpu_torch.solver.priors import (
    PosePriors,
    linearize_priors_blocks,
    prior_cost,
    tie_offdiag_dense,
    tie_offdiag_matvec,
)


def _shard_rows(L: int, mesh: Mesh, axis: str) -> tuple[int, int]:
    n = mesh.shape[axis]
    if L % n:
        raise ValueError(f"L={L} landmarks not divisible by the {axis!r} axis ({n})")
    Ls = L // n
    return mesh.index(axis) * Ls, Ls


def shard_ba_problem(p: BAProblem, mesh: Mesh, axis: str = "lm") -> BAProblem:
    """This rank's part of a BAProblem (counterpart of ``ba_problem_spec``):
    poses, cameras and priors replicated, the landmark and observation
    blocks sliced to this rank's L/n rows along ``axis``; only what this
    rank keeps goes to its device."""
    off, Ls = _shard_rows(p.lm_pos.shape[0], mesh, axis)
    dev = mesh.device

    def rows(t):
        return t[off:off + Ls].to(dev)

    return BAProblem(
        kf_Tcw=p.kf_Tcw.to(dev), kf_fixed=p.kf_fixed.to(dev),
        cams=CamArrays(*(c.to(dev) for c in p.cams)),
        lm_pos=rows(p.lm_pos), lm_valid=rows(p.lm_valid),
        obs=BAObservations(*(rows(o) for o in p.obs)),
        priors=None if p.priors is None else PosePriors(*(x.to(dev) for x in p.priors)))


def _lm_sharded(p: BAProblem, mesh: Mesh, n_iters: int, huber: bool, lam0: float,
                step) -> BAResult:
    """The LM loop over a landmark shard, shared by the 1-D and 2-D
    solvers. ``step(ps, kf_Tcw, lm_pos, lam)`` returns this shard's
    (delta_pose [K,6], delta_lm [Ls,3]), the pose step the same on every
    rank."""
    L = p.lm_pos.shape[0]
    off, _ = _shard_rows(L, mesh, "lm")
    ps = shard_ba_problem(p, mesh)
    pn = ps._replace(priors=None)

    def cost_of(kf_Tcw, lm_pos):
        total = psum(_robust_cost(pn, kf_Tcw, lm_pos, huber), mesh.group("lm"))
        if ps.priors is not None:
            total = total + prior_cost(kf_Tcw, ps.priors)
        return total

    kf_Tcw, lm_pos = ps.kf_Tcw, ps.lm_pos
    lam = torch.full((), lam0, dtype=kf_Tcw.dtype, device=kf_Tcw.device)
    cost = cost_of(kf_Tcw, lm_pos)
    for _ in range(n_iters):
        dp, dl = step(ps, kf_Tcw, lm_pos, lam)
        kf_new = torch.where(ps.kf_fixed[:, None, None], kf_Tcw, se3.exp(dp) @ kf_Tcw)
        lm_new = lm_pos + dl
        new_cost = cost_of(kf_new, lm_new)
        accept = new_cost < cost
        kf_Tcw = torch.where(accept, kf_new, kf_Tcw)
        lm_pos = torch.where(accept, lm_new, lm_pos)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
        cost = torch.minimum(new_cost, cost)

    r, pc, _, _ = _obs_residuals(ps, kf_Tcw, lm_pos)
    c2 = ps.obs.inv_sigma2 * torch.sum(r * r, dim=-1)
    inlier = ps.obs.valid & (c2 <= _delta2(ps)) & (pc[..., 2] > 0.0)
    return BAResult(
        kf_Tcw=kf_Tcw,
        lm_pos=gather_blocks(lm_pos, off, L, mesh, "lm"),
        obs_chi2=gather_blocks(c2, off, L, mesh, "lm"),
        obs_inlier=gather_blocks(inlier, off, L, mesh, "lm"),
        cost=cost)


def _pose_blocks(ps: BAProblem, mesh: Mesh, kf_Tcw, lm_pos, lam, huber: bool):
    """Linearize this shard, reduce the pose blocks over 'lm' and add the
    priors' blocks once: (Hpp, b_pose, Hab, Y, y, Vinv, Wlo, b_lm, kf_idx)."""
    Hpp, b_pose, Y, y, Vinv, Wlo, b_lm, kf_idx = _linearize_factors(
        ps, kf_Tcw, lm_pos, lam, ps.obs.valid, huber)
    Hpp = psum(Hpp, mesh.group("lm"))
    b_pose = psum(b_pose, mesh.group("lm"))
    Hab = None
    if ps.priors is not None:
        Hd_pr, b_pr, Hab = linearize_priors_blocks(kf_Tcw, ps.priors)
        Hpp = Hpp + Hd_pr
        b_pose = b_pose + b_pr
    return Hpp, b_pose, Hab, Y, y, Vinv, Wlo, b_lm, kf_idx


def distributed_bundle_adjustment(p: BAProblem, mesh: Mesh, n_iters: int = 10,
                                  huber: bool = True, chunk: int = 256,
                                  lam0: float = 1e-4, solver: str = "auto") -> BAResult:
    """LM bundle adjustment with the landmark axis sharded over mesh 'lm';
    the result of ``solver.ba.bundle_adjustment`` up to the order of the
    reductions. Every rank of the mesh calls it with the whole problem and
    gets the whole result. L must be divisible by the 'lm' axis.

    solver 'dense' all-reduces a [6K,6K] reduced system an LM iteration;
    'cg' runs the distributed matrix-free PCG, whose every S-product
    all-reduces a [K,6] (no rank holds a [6K,6K]); 'auto' takes cg from
    K >= 512."""
    solver = _resolve_solver(p, solver)
    K = p.kf_Tcw.shape[0]
    g_lm = mesh.group("lm")

    def step(ps, kf_Tcw, lm_pos, lam):
        Hpp, b_pose, Hab, Y, y, Vinv, Wlo, b_lm, kf_idx = _pose_blocks(
            ps, mesh, kf_Tcw, lm_pos, lam, huber)
        if solver == "cg":
            dp = _solve_poses_cg(Hpp, b_pose, _reduced_rhs(Y, y, kf_idx, K), Y, kf_idx,
                                 ps.kf_fixed, lam, priors=ps.priors, Hab=Hab, group=g_lm)
        else:
            S_red, b_red = _schur_reduce_dense(Y, y, kf_idx, K, chunk)
            # the [6K,6K] collective at the heart of dense distributed BA
            S_red = psum(S_red, mesh.group("lm"))
            b_red = psum(b_red, mesh.group("lm"))
            if ps.priors is not None:
                S_red = S_red - tie_offdiag_dense(ps.priors, Hab, K, Hpp.dtype)
            dp = _solve_poses(Hpp, b_pose, S_red, b_red, ps.kf_fixed, lam)
        return dp, _backsub(Vinv, Wlo, b_lm, kf_idx, dp, ps.lm_valid)

    return _lm_sharded(p, mesh, n_iters, huber, lam0, step)


# ---------------------------------------------------------------------------
# 2-D (kf x lm) sharded BA: keyframe AND landmark partitioning
# ---------------------------------------------------------------------------

def _schur_cols(Y, y, kf_idx, K: int, Kb: int, col0: int, chunk: int):
    """Column-block Schur reduction: (S_cb [6K, 6Kb], b_red [K,6]), where
    S_cb holds this kf-shard's 6Kb columns of the landmark shard's partial
    reduced term sum_l A_l A_l^T. Each kf-shard does 1/n_kf of the rank-3C
    matmul work and holds 1/n_kf of the [6K,6K]. Z is scattered by
    keyframe with the ordered ``index_put_(accumulate=True)``, not the
    card's atomic ``index_add_``: a landmark may have two observations in
    one keyframe, and the ranks of one 'lm' coordinate each compute this
    shard's b_red, which must be the same bits on all of them."""
    L, O = kf_idx.shape
    dtype, dev = Y.dtype, Y.device
    n_chunks = (L + chunk - 1) // chunk
    pad = n_chunks * chunk - L
    Y_p = torch.nn.functional.pad(Y, (0, 0, 0, 0, 0, 0, 0, pad))
    y_p = torch.nn.functional.pad(y, (0, 0, 0, pad))
    kf_p = torch.nn.functional.pad(kf_idx, (0, 0, 0, pad))
    S = torch.zeros((K * 6, Kb * 6), dtype=dtype, device=dev)
    bh = torch.zeros((K, 6), dtype=dtype, device=dev)
    rows = torch.arange(chunk, device=dev)[:, None] * K
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        Z = torch.zeros((chunk * K, 6, 3), dtype=dtype, device=dev).index_put_(
            ((rows + kf_p[sl]).reshape(-1),), Y_p[sl].reshape(-1, 6, 3), accumulate=True
        ).reshape(chunk, K, 6, 3)
        Zf = Z.permute(0, 3, 1, 2).reshape(chunk * 3, K * 6)
        S = S + Zf.T @ Zf[:, col0 * 6:(col0 + Kb) * 6]
        bh = bh + torch.einsum("lkab,lb->ka", Z, y_p[sl])
    return S, bh


def distributed_bundle_adjustment_2d(p: BAProblem, mesh: Mesh, n_iters: int = 10,
                                     huber: bool = True, chunk: int = 256,
                                     lam0: float = 1e-4) -> BAResult:
    """LM bundle adjustment on a 2-D ('kf', 'lm') mesh: landmark and
    observation blocks sharded over 'lm', the reduced camera system's
    column blocks over 'kf'. Each CG product multiplies this rank's
    [6K, 6K/n_kf] column block by its slice of x and all-reduces the [K,6]
    over both axes, so the Schur system's work and memory drop by n_kf
    while a product still moves O(K). The result of
    ``bundle_adjustment(solver="cg")`` up to the order of the reductions.

    The pose priors ride replicated: their diagonal blocks join Hpp after
    the landmark reduction, and the tiepoint coupling is applied inside
    every CG product outside the collective (no shard-count scaling).
    K must be divisible by the 'kf' axis and L by the 'lm' axis."""
    n_kf = mesh.shape["kf"]
    K = p.kf_Tcw.shape[0]
    if K % n_kf:
        raise ValueError(f"K={K} keyframes not divisible by the 'kf' axis ({n_kf})")
    Kb = K // n_kf
    col0 = mesh.index("kf") * Kb

    def step(ps, kf_Tcw, lm_pos, lam):
        Hpp, b_pose, Hab, Y, y, Vinv, Wlo, b_lm, kf_idx = _pose_blocks(
            ps, mesh, kf_Tcw, lm_pos, lam, huber)
        S_cb, b_red = _schur_cols(Y, y, kf_idx, K, Kb, col0, chunk)
        b_red = psum(b_red, mesh.group("lm"))
        Hpp_d, tr = _damped(Hpp, lam)
        free = (~ps.kf_fixed) & (tr > 0)
        fm = free[:, None].to(Hpp.dtype)

        def S_mv(x):
            xz = x * fm
            xb = xz.reshape(K * 6)[col0 * 6:(col0 + Kb) * 6]
            red = psum((S_cb @ xb).reshape(K, 6), mesh.group(("kf", "lm")))
            out = torch.einsum("kij,kj->ki", Hpp_d, xz) - red
            if ps.priors is not None:
                out = out + tie_offdiag_matvec(ps.priors, Hab, xz, K)
            return out * fm + x * (1.0 - fm)

        Dinv = _block_jacobi(Hpp_d - psum(_reduced_diag(Y, kf_idx, K), mesh.group("lm")),
                             free)
        x = _pcg(S_mv, Dinv, fm, (b_pose - b_red) * fm, n_cg=200, tol=1e-5)
        dp = torch.where(torch.isfinite(x) & free[:, None], x, 0.0)
        return dp, _backsub(Vinv, Wlo, b_lm, kf_idx, dp, ps.lm_valid)

    return _lm_sharded(p, mesh, n_iters, huber, lam0, step)
