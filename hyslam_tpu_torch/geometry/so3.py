"""SO(3) as 3x3 matrices and (w, x, y, z) unit quaternions, batched and
branch-free (counterpart of ``hyslam_tpu/geometry/so3.py``; what the tracker
and the mapper use is ported)."""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [..., 3] -> [..., 3, 3] with hat(w) @ v = w x v."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _sinc_coeffs(theta2: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (1 - sin t/t)/t^2) for
    theta2 = |w|^2, with the JAX package's Taylor switch at theta = 0.5 so
    the closed forms are used only where they do not cancel in float32."""
    small = theta2 < 0.25
    st2 = torch.where(small, 1.0, theta2)
    t = torch.sqrt(st2)
    t4 = theta2 * theta2
    t6 = t4 * theta2
    A = torch.where(
        small, 1.0 - theta2 / 6.0 + t4 / 120.0 - t6 / 5040.0, torch.sin(t) / t
    )
    sh = torch.sin(0.5 * t)
    B = torch.where(
        small,
        0.5 - theta2 / 24.0 + t4 / 720.0 - t6 / 40320.0,
        2.0 * sh * sh / st2,
    )
    C = torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0 + t4 / 5040.0 - t6 / 362880.0,
        (1.0 - A) / st2,
    )
    return A, B, C


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation [..., 3, 3] (Rodrigues)."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> axis-angle [..., 3], through the quaternion
    (stable up to theta = pi, where the (R - R^T) formula degenerates)."""
    return quat_log(quat_from_mat(R))


def quat_from_mat(R: torch.Tensor) -> torch.Tensor:
    """Rotation [..., 3, 3] -> unit quaternion (w, x, y, z), Shepperd's
    method as the JAX package writes it: all four candidates are built and
    the one with the largest 4 q_i^2 is taken (first on ties), then the sign
    is made canonical (w >= 0)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cand = torch.stack([cw, cx, cy, cz], dim=-2)             # [..., 4, 4]
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cand, -2, idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def quat_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> axis-angle [..., 3] (|v| in [0, pi])."""
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < _EPS
    scale = torch.where(small, 2.0 / torch.clamp_min(w, _EPS),
                        theta / torch.where(small, 1.0, vn))
    return v * scale[..., None]


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian I + B*hat + C*hat^2 (the V of the SE(3) exp)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of the SO(3) left Jacobian, I - hat/2 + D*hat^2, with the
    JAX package's Taylor switch at theta = 0.5."""
    theta2 = torch.sum(w * w, dim=-1)
    A, B, _ = _sinc_coeffs(theta2)
    small = theta2 < 0.25
    safe_t2 = torch.where(small, 1.0, theta2)
    t4 = theta2 * theta2
    D = torch.where(small, 1.0 / 12.0 + theta2 / 720.0 + t4 / 30240.0,
                    (1.0 - A / (2.0 * B)) / safe_t2)
    W = hat(w)
    return _eye_like(W) - 0.5 * W + D[..., None, None] * (W @ W)
