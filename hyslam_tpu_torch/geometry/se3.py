"""SE(3) as [..., 4, 4] homogeneous matrices (counterpart of
``hyslam_tpu/geometry/se3.py``).

Tangent vectors are [..., 6] ordered (omega, upsilon), and solver updates are
left-multiplicative, T <- exp(delta) @ T, as in the JAX package.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import so3


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (4, 4)).clone()


def from_Rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Build [..., 4, 4] from rotation [..., 3, 3] and translation [..., 3]."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def rotation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def translation(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = rotation(T).transpose(-1, -2)
    return from_Rt(Rt, -torch.einsum("...ij,...j->...i", Rt, translation(T)))


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points: T [..., 4, 4] applied to pts [..., 3] (broadcasting)."""
    return torch.einsum("...ij,...j->...i", rotation(T), pts) + translation(T)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map [..., 6] (omega, upsilon) -> [..., 4, 4]."""
    w = xi[..., :3]
    v = xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", so3.left_jacobian(w), v)
    return from_Rt(so3.exp(w), t)
