"""SO(3) as 3x3 matrices, batched and branch-free (counterpart of
``hyslam_tpu/geometry/so3.py``; only what the front end uses is ported)."""

from __future__ import annotations

import torch


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


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian I + B*hat + C*hat^2 (the V of the SE(3) exp)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, B, C = _sinc_coeffs(theta2)
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)
