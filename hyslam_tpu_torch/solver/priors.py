"""Pose-prior residual blocks for bundle adjustment: GPS / IMU / depth
sensor edges and sub-map tiepoint SE3 edges (counterpart of
``hyslam_tpu/solver/priors.py``).

- IMU:   unary 4-dim residual  q(R_cw) - q_meas  (quaternion stored
         (w,x,y,z), flipped onto the measurement's hemisphere first).
- depth: unary 1-dim residual  t_z(Tcw) - d_meas.
- GPS:   unary 3-dim residual  camera_center(Tcw) - p_meas with per-axis
         diagonal information.
- tie:   binary 6-dim residual log(T_b^-1 M T_a) between a sub-map's origin
         keyframe b and its parent tiepoint keyframe a, with the measurement
         M = Tcw_b Tcw_a^-1 taken at registration.

All priors of one type are linearized at once over the left-multiplicative
se3 tangent xi = (omega, upsilon), T <- exp(xi) T (the parameterization of
the reprojection Jacobians in ``solver/ba.py``). The JAX package takes the
Jacobians with ``jax.jacfwd``; here they are written out (forward mode
through ``torch.func`` spends ~0.1 s of host time a linearization, and BA
linearizes 15 times a keyframe):

- GPS:   d(-R^T t) = -R^T d(upsilon)                    J = [0, -R^T]
- depth: d(t_z) = (omega x t)_z + upsilon_z             J = [t_y, -t_x, 0, 0, 0, 1]
- IMU:   q' = (1, omega/2) (x) q                        J = s/2 [[-v^T], [w I - hat(v)]]
         for q = (w, v), s the sign of the hemisphere flip
- tie:   D = Tb^-1 M Ta, r = log D;  Ta' = exp(xi) Ta gives D' = exp(Ad(Tb^-1 M) xi) D,
         Tb' = exp(xi) Tb gives D' = exp(-Ad(Tb^-1) xi) D, and
         log(exp(e) D) = r + Jl^-1(r) e, so
         Ja = Jl^-1(r) Ad(Tb^-1 M),  Jb = -Jl^-1(r) Ad(Tb^-1)
         with the SE(3) left Jacobian's inverse in closed form (Barfoot,
         State Estimation for Robotics, eq. 7.85-7.95). The tie Jacobian is
         evaluated in float64 (its coefficients cancel in float32) and then
         rounded; at a residual of exactly zero it is Ja = Ad, Jb = -Ad, with
         no NaN from any untaken small-angle branch.

The result is per-pose 6x6 diagonal
blocks plus sparse tiepoint off-diagonal blocks that add into the reduced
camera system. The sums over duplicate targets (the padding rows of the
tiepoint table all name slot 0) are ordered ``index_put_(accumulate=True)``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.geometry import se3, so3


class PosePriors(NamedTuple):
    """Slot-aligned prior measurements for a BAProblem's K poses. All
    information weights are absolute. Invalid rows are masked, not
    compacted."""

    gps_pos: torch.Tensor      # [K, 3] target camera center (SLAM frame)
    gps_info: torch.Tensor     # [K, 3] per-axis diagonal information
    gps_valid: torch.Tensor    # [K] bool
    imu_quat: torch.Tensor     # [K, 4] measured world->cam quat (w,x,y,z)
    imu_info: torch.Tensor     # [K]
    imu_valid: torch.Tensor    # [K] bool
    depth: torch.Tensor        # [K] measured t_z of Tcw
    depth_info: torch.Tensor   # [K]
    depth_valid: torch.Tensor  # [K] bool
    tie_a: torch.Tensor        # [E] int32 parent keyframe slot
    tie_b: torch.Tensor        # [E] int32 sub-map-origin keyframe slot
    tie_T: torch.Tensor        # [E, 4, 4] measurement M (= Tcw_b Tcw_a^-1)
    tie_info: torch.Tensor     # [E]
    tie_valid: torch.Tensor    # [E] bool


def empty_pose_priors(K: int, E: int = 0, dtype=torch.float32,
                      device=None) -> PosePriors:
    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return PosePriors(
        gps_pos=z(K, 3), gps_info=z(K, 3), gps_valid=z(K, dt=torch.bool),
        imu_quat=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                              device=device).repeat(K, 1),
        imu_info=z(K), imu_valid=z(K, dt=torch.bool),
        depth=z(K), depth_info=z(K), depth_valid=z(K, dt=torch.bool),
        tie_a=z(E, dt=torch.int32), tie_b=z(E, dt=torch.int32),
        tie_T=torch.eye(4, dtype=dtype, device=device).repeat(E, 1, 1),
        tie_info=z(E), tie_valid=z(E, dt=torch.bool),
    )


# The residuals take one pose [4,4] and one measurement, or a batch of each.

def _gps_residual(T, m):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return -torch.einsum("...ji,...j->...i", R, t) - m


def _imu_residual(T, q_meas):
    q = so3.quat_from_mat(T[..., :3, :3])
    q = torch.where(torch.sum(q * q_meas, dim=-1, keepdim=True) < 0, -q, q)
    return q - q_meas


def _depth_residual(T, d):
    return (T[..., 2, 3] - d)[..., None]


def _tie_residual(Ta, Tb, M):
    return se3.log(se3.inverse(Tb) @ M @ Ta)


def _gps_jacobian(T):
    z = torch.zeros_like(T[..., :3, :3])
    return torch.cat([z, -T[..., :3, :3].transpose(-1, -2)], dim=-1)       # [K,3,6]


def _depth_jacobian(T):
    t = T[..., :3, 3]
    z, one = torch.zeros_like(t[..., 0]), torch.ones_like(t[..., 0])
    return torch.stack([t[..., 1], -t[..., 0], z, z, z, one], dim=-1)[..., None, :]


def _imu_jacobian(T, q_meas):
    q = so3.quat_from_mat(T[..., :3, :3])
    s = torch.where(torch.sum(q * q_meas, dim=-1, keepdim=True) < 0, -1.0, 1.0)
    w, v = q[..., :1], q[..., 1:]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Jw = torch.cat([-v[..., None, :], w[..., None] * eye - so3.hat(v)], dim=-2)
    return torch.cat([(0.5 * s)[..., None] * Jw, torch.zeros_like(Jw)], dim=-1)  # [K,4,6]


def _adjoint(T):
    """Ad(T) [..., 6, 6] in (omega, upsilon) order: T exp(xi) T^-1 =
    exp(Ad(T) xi)."""
    R = T[..., :3, :3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    return torch.cat([top, torch.cat([so3.hat(T[..., :3, 3]) @ R, R], dim=-1)], dim=-2)


def _se3_left_jacobian_inv(xi):
    """Inverse of the SE(3) left Jacobian at xi = (omega, upsilon) [..., 6]:
    [[A, 0], [-A Q A, A]], A the SO(3) left Jacobian's inverse."""
    w, u = xi[..., :3], xi[..., 3:]
    t2 = torch.sum(w * w, dim=-1)
    _, B, C = so3._sinc_coeffs(t2)
    small = t2 < 0.25
    st2 = torch.where(small, 1.0, t2)
    t4 = t2 * t2
    t6 = t4 * t2
    c2 = torch.where(small, 1 / 24 - t2 / 720 + t4 / 40320 - t6 / 3628800,
                     (0.5 - B) / st2)
    c3 = torch.where(small, 1 / 120 - t2 / 2520 + t4 / 120960 - t6 / 9979200,
                     (3.0 * C - B) / (2.0 * st2))
    W, U = so3.hat(w), so3.hat(u)
    WU, UW = W @ U, U @ W
    WUW = WU @ W
    Q = (0.5 * U + C[..., None, None] * (WU + UW + WUW)
         + c2[..., None, None] * (W @ WU + UW @ W - 3.0 * WUW)
         + c3[..., None, None] * (WUW @ W + W @ WUW))
    A = so3.left_jacobian_inv(w)
    top = torch.cat([A, torch.zeros_like(A)], dim=-1)
    return torch.cat([top, torch.cat([-A @ Q @ A, A], dim=-1)], dim=-2)


def _tie_jacobians(Ta, Tb, M):
    """(Ja, Jb) [E,6,6] of the tie residual over the left tangents of Ta and
    Tb, evaluated in float64 and rounded to the poses' dtype."""
    f64 = torch.float64
    P = se3.inverse(Tb.to(f64)) @ M.to(f64)
    Jinv = _se3_left_jacobian_inv(se3.log(P @ Ta.to(f64)))
    Ja = Jinv @ _adjoint(P)
    Jb = -(Jinv @ _adjoint(se3.inverse(Tb.to(f64))))
    return Ja.to(Ta.dtype), Jb.to(Ta.dtype)


def _unary_blocks(r, J, w):
    """Normal-equation blocks of one unary prior type from its residual r
    [K,d], Jacobian J [K,d,6] and per-component information w [K,d] (zeros
    mask invalid rows). Returns (H [K,6,6], b [K,6])."""
    H = torch.einsum("kdi,kd,kdj->kij", J, w, J)
    b = -torch.einsum("kdi,kd->ki", J, w * r)
    return H, b


def _tie_weight(pr: PosePriors, a, b):
    # a self-edge (a == b: the masked padding rows) would land its
    # off-diagonal block on the diagonal: its weight is zero
    return pr.tie_info * pr.tie_valid * (a != b)


def _tie_slots(pr: PosePriors, K: int):
    return pr.tie_a.clamp(0, K - 1).long(), pr.tie_b.clamp(0, K - 1).long()


def prior_cost(kf_Tcw: torch.Tensor, pr: PosePriors) -> torch.Tensor:
    """Total quadratic prior cost (sensor edges carry no robust kernel)."""
    dtype = kf_Tcw.dtype
    r_gps = _gps_residual(kf_Tcw, pr.gps_pos)
    r_imu = _imu_residual(kf_Tcw, pr.imu_quat)
    r_dep = _depth_residual(kf_Tcw, pr.depth)
    cost = torch.sum(pr.gps_info * pr.gps_valid[:, None] * r_gps**2)
    cost = cost + torch.sum(pr.imu_info[:, None] * pr.imu_valid[:, None] * r_imu**2)
    cost = cost + torch.sum(pr.depth_info[:, None] * pr.depth_valid[:, None] * r_dep**2)
    if pr.tie_a.shape[0]:
        a, b = _tie_slots(pr, kf_Tcw.shape[0])
        r_tie = _tie_residual(kf_Tcw[a], kf_Tcw[b], pr.tie_T)
        cost = cost + torch.sum(_tie_weight(pr, a, b)[:, None] * r_tie**2)
    return cost.to(dtype)


def linearize_priors_blocks(kf_Tcw: torch.Tensor, pr: PosePriors):
    """Linearize all priors about kf_Tcw, keeping the tiepoint coupling as
    sparse edge blocks (the matrix-free form for the CG solve). Returns
    (Hd [K,6,6] pose-diagonal blocks, b [K,6], Hab [E,6,6] tiepoint
    off-diagonal blocks coupling (pr.tie_a, pr.tie_b)). Hd adds into BA's
    Hpp, so LM damping sees it."""
    K = kf_Tcw.shape[0]
    dtype, dev = kf_Tcw.dtype, kf_Tcw.device

    Hg, bg = _unary_blocks(_gps_residual(kf_Tcw, pr.gps_pos), _gps_jacobian(kf_Tcw),
                           pr.gps_info * pr.gps_valid[:, None])
    Hi, bi = _unary_blocks(
        _imu_residual(kf_Tcw, pr.imu_quat), _imu_jacobian(kf_Tcw, pr.imu_quat),
        (pr.imu_info * pr.imu_valid)[:, None] * torch.ones((1, 4), dtype=dtype, device=dev))
    Hz, bz = _unary_blocks(_depth_residual(kf_Tcw, pr.depth), _depth_jacobian(kf_Tcw),
                           (pr.depth_info * pr.depth_valid)[:, None])
    Hd = Hg + Hi + Hz
    b = bg + bi + bz

    E = pr.tie_a.shape[0]
    Hab = torch.zeros((E, 6, 6), dtype=dtype, device=dev)
    if E:
        a, bb = _tie_slots(pr, K)
        Ta, Tb = kf_Tcw[a], kf_Tcw[bb]

        r = _tie_residual(Ta, Tb, pr.tie_T)                    # [E,6]
        Ja, Jb = _tie_jacobians(Ta, Tb, pr.tie_T)              # [E,6,6] each
        w = _tie_weight(pr, a, bb)
        Haa = torch.einsum("edi,e,edj->eij", Ja, w, Ja)
        Hbb = torch.einsum("edi,e,edj->eij", Jb, w, Jb)
        Hab = torch.einsum("edi,e,edj->eij", Ja, w, Jb)
        ba_ = -torch.einsum("edi,ed->ei", Ja, w[:, None] * r)
        bb_ = -torch.einsum("edi,ed->ei", Jb, w[:, None] * r)
        Hd = Hd.index_put((a,), Haa, accumulate=True).index_put((bb,), Hbb, accumulate=True)
        b = b.index_put((a,), ba_, accumulate=True).index_put((bb,), bb_, accumulate=True)
    return Hd, b, Hab


def tie_offdiag_matvec(pr: PosePriors, Hab: torch.Tensor, x: torch.Tensor,
                       K: int) -> torch.Tensor:
    """The tiepoint off-diagonal coupling applied to x [K,6] without the
    [6K,6K] matrix: out[a] += Hab x[b], out[b] += Hab^T x[a] per edge."""
    if not pr.tie_a.shape[0]:
        return torch.zeros_like(x)
    a, bb = _tie_slots(pr, K)
    xa = torch.einsum("eij,ej->ei", Hab, x[bb])
    xb = torch.einsum("eji,ej->ei", Hab, x[a])
    return torch.zeros_like(x).index_put((a,), xa, accumulate=True).index_put(
        (bb,), xb, accumulate=True)


def tie_offdiag_dense(pr: PosePriors, Hab: torch.Tensor, K: int,
                      dtype=torch.float32) -> torch.Tensor:
    """The tiepoint off-diagonal coupling as a dense [6K,6K] (zero diagonal
    blocks): the dense solve's counterpart of ``tie_offdiag_matvec``."""
    Hoff = torch.zeros((K, K, 6, 6), dtype=dtype, device=Hab.device)
    if pr.tie_a.shape[0]:
        a, bb = _tie_slots(pr, K)
        Hab = Hab.to(dtype)
        Hoff = Hoff.index_put((a, bb), Hab, accumulate=True)
        Hoff = Hoff.index_put((bb, a), Hab.transpose(1, 2), accumulate=True)
    return Hoff.permute(0, 2, 1, 3).reshape(K * 6, K * 6)


def linearize_priors(kf_Tcw: torch.Tensor, pr: PosePriors):
    """Linearize all priors about kf_Tcw (dense form). Returns (Hd [K,6,6]
    pose-diagonal blocks, Hoff [6K,6K] off-diagonal contributions with zero
    diagonal blocks, b [K,6])."""
    Hd, b, Hab = linearize_priors_blocks(kf_Tcw, pr)
    return Hd, tie_offdiag_dense(pr, Hab, kf_Tcw.shape[0], kf_Tcw.dtype), b
