"""Closed-form reprojection residuals and Jacobians, batched (counterpart of
``hyslam_tpu/solver/residuals.py``).

Pose is Tcw (world -> camera), perturbed left-multiplicatively with tangent
(omega, upsilon). Residual rows are (u - u_obs, v - v_obs, u_r - ur_obs);
the third row is zero for monocular observations.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import se3, so3
from hyslam_tpu_torch.geometry.camera import Camera


def camera_point(Tcw: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """World points [..., 3] into the camera frame under pose(s) [..., 4, 4]."""
    return se3.apply(Tcw, X)


def reproj_residual(
    cam: Camera,
    pc: torch.Tensor,
    uv_obs: torch.Tensor,
    ur_obs: torch.Tensor,
    stereo_mask: torch.Tensor,
) -> torch.Tensor:
    """Residual [..., 3] from camera-frame points pc [..., 3]."""
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    ur = u - cam.bf / zs
    r3 = torch.where(stereo_mask, ur - ur_obs, 0.0)
    return torch.stack([u - uv_obs[..., 0], v - uv_obs[..., 1], r3], dim=-1)


def reproj_jacobians(
    cam: Camera,
    Tcw: torch.Tensor,
    pc: torch.Tensor,
    stereo_mask: torch.Tensor,
):
    """Jacobians of the 3-row residual: (J_pose [..., 3, 6] w.r.t. the
    left tangent of Tcw, J_point [..., 3, 3] w.r.t. the world point).
    d pc / d delta = [ -hat(pc) | I ],  d pc / d X = R(Tcw)."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    iz = 1.0 / zs
    iz2 = iz * iz

    fx, fy, bf = cam.fx, cam.fy, cam.bf
    zero = torch.zeros_like(x)
    Ju = torch.stack([fx * iz, zero, -fx * x * iz2], dim=-1)
    Jv = torch.stack([zero, fy * iz, -fy * y * iz2], dim=-1)
    Jur = torch.stack([fx * iz, zero, -fx * x * iz2 + bf * iz2], dim=-1)
    Jur = torch.where(stereo_mask[..., None], Jur, 0.0)
    Jproj = torch.stack([Ju, Jv, Jur], dim=-2)

    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(
        pc.shape[:-1] + (3, 3))
    dpc_ddelta = torch.cat([-so3.hat(pc), eye], dim=-1)     # [..., 3, 6]

    J_pose = Jproj @ dpc_ddelta
    J_point = Jproj @ se3.rotation(Tcw)
    return J_pose, J_point


def chi2(r: torch.Tensor, inv_sigma2: torch.Tensor,
         stereo_mask: torch.Tensor) -> torch.Tensor:
    """Information-weighted squared error per observation [...]; the third
    row is already zero for mono residuals."""
    del stereo_mask
    return inv_sigma2 * torch.sum(r * r, dim=-1)
