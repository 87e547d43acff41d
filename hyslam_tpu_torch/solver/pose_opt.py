"""Pose-only optimization, Optimizer::PoseOptimization (counterpart of
``hyslam_tpu/solver/pose_opt.py``).

4 rounds x 10 Levenberg-Marquardt iterations over fixed-size padded arrays,
Huber at sqrt(5.991) mono / sqrt(7.815) stereo in the first two rounds,
outliers reclassified by chi2 between rounds. ``pose_optimization`` is the
plain PyTorch version: it never reads a value back to the host, so on a card
it queues all 40 iterations without a sync. ``pose_optimization_fast`` runs
the whole schedule as one CUDA kernel (``ops/pose_opt_cuda.py``) on CUDA
tensors, and the plain version on CPU tensors.
``pose_optimization_fused_schedule`` is the plain version of the order in
which that kernel works (one evaluation an iteration), for holding the
kernel and the two schedules against each other.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
from hyslam_tpu_torch.solver import robust
from hyslam_tpu_torch.solver.residuals import (
    camera_point,
    chi2,
    reproj_jacobians,
    reproj_residual,
)


class PoseOptResult(NamedTuple):
    Tcw: torch.Tensor          # [4,4] optimized pose
    inliers: torch.Tensor      # [N] bool, valid & chi2 below threshold
    num_inliers: torch.Tensor  # int32 scalar
    chi2: torch.Tensor         # [N] final per-observation chi2


def _lm_rounds(cam, Tcw0, X, uv, ur, inv_sigma2, valid, stereo,
               n_rounds: int, iters_per_round: int):
    chi2_th = torch.where(stereo, robust.CHI2_STEREO, robust.CHI2_MONO)

    def residual_chi2(T):
        pc = camera_point(T, X)
        r = reproj_residual(cam, pc, uv, ur, stereo)
        c2 = chi2(r, inv_sigma2, stereo)
        # behind-camera points are hard outliers
        c2 = torch.where(pc[..., 2] > 0.05, c2, 1e9)
        return pc, r, c2

    def weights(c2, use_huber, active):
        w_h = robust.huber_weight(c2, chi2_th) if use_huber else 1.0
        return inv_sigma2 * w_h * active.to(X.dtype)

    T = Tcw0
    active = valid
    for round_idx in range(n_rounds):
        use_huber = round_idx < 2  # the reference drops the kernel after 2
        lam = torch.tensor(1e-3, dtype=T.dtype, device=T.device)
        for _ in range(iters_per_round):
            pc, r, c2 = residual_chi2(T)
            w = weights(c2, use_huber, active)
            Jp, _ = reproj_jacobians(cam, T, pc, stereo)
            # H = sum_i w_i J_i^T J_i  (per-row weight is scalar: Omega = w*I)
            H = torch.einsum("n,nri,nrj->ij", w, Jp, Jp)
            g = -torch.einsum("n,nri,nr->i", w, Jp, r)
            cost = torch.sum(w * torch.sum(r * r, dim=-1))

            D = torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))
            # solve_ex: a singular system gives a non-finite step, which is
            # rejected below, instead of raising (and syncing) on the card
            delta = torch.linalg.solve_ex(H + lam * D, g).result
            T_new = se3.exp(delta) @ T

            _, r2, c2_2 = residual_chi2(T_new)
            w2 = weights(c2_2, use_huber, active)
            new_cost = torch.sum(w2 * torch.sum(r2 * r2, dim=-1))

            accept = (new_cost < cost) & torch.all(torch.isfinite(delta))
            T = torch.where(accept, T_new, T)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-9, 1e6)

        # reclassify: outliers excluded from the next round (Optimizer.cc:195)
        _, _, c2 = residual_chi2(T)
        active = valid & (c2 <= chi2_th)

    _, _, c2 = residual_chi2(T)
    inliers = valid & (c2 <= chi2_th)
    return T, inliers, c2


def pose_optimization(
    cam: Camera,
    Tcw0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    ur: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    stereo: torch.Tensor,
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """Optimize a single camera pose against fixed landmarks.

    Tcw0 [4,4] initial world->cam pose; X [N,3] landmark world positions;
    uv [N,2] observed pixels; ur [N] observed right-u; inv_sigma2 [N]
    per-observation information; valid [N] bool real observations; stereo
    [N] bool rows with a right-u measurement. All float32."""
    T, inliers, c2 = _lm_rounds(
        cam, Tcw0, X, uv, ur, inv_sigma2, valid, stereo, n_rounds,
        iters_per_round,
    )
    return PoseOptResult(
        Tcw=T,
        inliers=inliers,
        num_inliers=torch.sum(inliers, dtype=torch.int32),
        chi2=c2,
    )


def _final_chi2(cam, T, X, uv, ur, inv_sigma2, stereo):
    pc = camera_point(T, X)
    r = reproj_residual(cam, pc, uv, ur, stereo)
    c2 = chi2(r, inv_sigma2, stereo)
    return torch.where(pc[..., 2] > 0.05, c2, 1e9)


def pose_optimization_fused_schedule(
    cam: Camera,
    Tcw0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    ur: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    stereo: torch.Tensor,
    n_rounds: int = 4,
    iters_per_round: int = 10,
    reuse_sums: bool = True,
) -> tuple[PoseOptResult, torch.Tensor]:
    """pose_optimization in the order kernel K1 works, in plain PyTorch:
    one evaluation an iteration. The system (H, g, cost) is built at the
    *candidate*; an accepted step makes it the current system, a rejected
    one keeps the old system at the old pose and only lambda changes; one
    more evaluation opens each round, where the active set and the Huber
    switch change. It takes the steps of the two-pass schedule, with
    n_rounds * (iters + 1) evaluations for its 2 * n_rounds * iters.
    Returns (result, accepts [n_rounds * iters] bool).

    With reuse_sums false the system is built anew at the pose before
    every step: the two-pass schedule itself, with its steps recorded
    (the tests hold that form bit for bit against pose_optimization and
    the fused form's steps against its). The tests and the chip check use
    this function; the port's main path does not call it."""
    chi2_th = torch.where(stereo, robust.CHI2_STEREO, robust.CHI2_MONO)

    def system(T, use_huber, active):
        pc = camera_point(T, X)
        r = reproj_residual(cam, pc, uv, ur, stereo)
        c2 = torch.where(pc[..., 2] > 0.05, chi2(r, inv_sigma2, stereo), 1e9)
        w_h = robust.huber_weight(c2, chi2_th) if use_huber else 1.0
        w = inv_sigma2 * w_h * active.to(X.dtype)
        Jp, _ = reproj_jacobians(cam, T, pc, stereo)
        H = torch.einsum("n,nri,nrj->ij", w, Jp, Jp)
        g = -torch.einsum("n,nri,nr->i", w, Jp, r)
        return H, g, torch.sum(w * torch.sum(r * r, dim=-1))

    T = Tcw0
    active = valid
    accepts = []
    for round_idx in range(n_rounds):
        use_huber = round_idx < 2
        lam = torch.tensor(1e-3, dtype=T.dtype, device=T.device)
        H, g, cost = system(T, use_huber, active)
        for _ in range(iters_per_round):
            if not reuse_sums:
                H, g, cost = system(T, use_huber, active)
            D = torch.diag(torch.clamp_min(torch.diagonal(H), 1e-6))
            delta = torch.linalg.solve_ex(H + lam * D, g).result
            T_new = se3.exp(delta) @ T
            H_new, g_new, new_cost = system(T_new, use_huber, active)
            accept = (new_cost < cost) & torch.all(torch.isfinite(delta))
            T = torch.where(accept, T_new, T)
            H = torch.where(accept, H_new, H)
            g = torch.where(accept, g_new, g)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0),
                              1e-9, 1e6)
            accepts.append(accept)
        c2 = _final_chi2(cam, T, X, uv, ur, inv_sigma2, stereo)
        active = valid & (c2 <= chi2_th)

    c2 = _final_chi2(cam, T, X, uv, ur, inv_sigma2, stereo)
    inliers = valid & (c2 <= chi2_th)
    accepts = (torch.stack(accepts) if accepts
               else torch.zeros(0, dtype=torch.bool, device=T.device))
    return PoseOptResult(
        Tcw=T, inliers=inliers,
        num_inliers=torch.sum(inliers, dtype=torch.int32), chi2=c2,
    ), accepts


def pose_optimization_fast(
    cam: Camera,
    Tcw0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    ur: torch.Tensor,
    inv_sigma2: torch.Tensor,
    valid: torch.Tensor,
    stereo: torch.Tensor,
    n_rounds: int = 4,
    iters_per_round: int = 10,
) -> PoseOptResult:
    """pose_optimization with the whole schedule in one kernel launch.

    On CPU tensors this is the plain version (there is no kernel to run).
    On any other device it launches kernel K1 through
    ``pose_optimization_cuda``, which raises if the kernel cannot be built
    or launched: there is no fallback on the card. All four fields of the
    result come from that one launch."""
    if X.device.type == "cpu":
        return pose_optimization(
            cam, Tcw0, X, uv, ur, inv_sigma2, valid, stereo,
            n_rounds=n_rounds, iters_per_round=iters_per_round,
        )

    # the main path's tensors are float32 / bool and contiguous already, and
    # then go to the kernel as they are: no device work but the launch
    def as_(x, dtype=torch.float32):
        return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()

    return PoseOptResult(*pose_optimization_cuda(
        cam, as_(Tcw0), as_(X), as_(uv), as_(ur), as_(inv_sigma2),
        as_(valid, torch.bool), as_(stereo, torch.bool),
        n_rounds=n_rounds, iters_per_round=iters_per_round,
    ))
