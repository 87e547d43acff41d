"""Sim(3): similarity transforms (s, R, t) acting on points as
x' = s * R @ x + t (counterpart of ``hyslam_tpu/geometry/sim3.py``).

Packed representation: [..., 8] = (s, qw, qx, qy, qz, tx, ty, tz).
Tangent: [..., 7] = (sigma, omega[3], upsilon[3]) with s = exp(sigma).

The exponential's W matrix comes from its integral form by the same
10-point Gauss-Legendre rule as in the JAX package; ``log`` solves
W upsilon = t in closed form (adjugate over determinant), with no LU call.
"""

from __future__ import annotations

import numpy as np
import torch

from hyslam_tpu_torch.geometry import so3


def pack(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([s[..., None], so3.quat_from_mat(R), t], dim=-1)


def unpack(g: torch.Tensor):
    return g[..., 0], so3.mat_from_quat(g[..., 1:5]), g[..., 5:8]


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    g = torch.zeros(tuple(batch_shape) + (8,), dtype=dtype, device=device)
    g[..., 0] = 1.0
    g[..., 1] = 1.0
    return g


def _mv(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, x)


def apply(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    s, R, t = unpack(g)
    return s[..., None] * _mv(R, pts) + t


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(sa, Ra, ta) o (sb, Rb, tb) = (sa*sb, Ra Rb, sa Ra tb + ta)."""
    sa, Ra, ta = unpack(a)
    sb, Rb, tb = unpack(b)
    return pack(sa * sb, Ra @ Rb, sa[..., None] * _mv(Ra, tb) + ta)


def inverse(g: torch.Tensor) -> torch.Tensor:
    s, R, t = unpack(g)
    si = 1.0 / s
    Ri = R.transpose(-1, -2)
    return pack(si, Ri, -si[..., None] * _mv(Ri, t))


def from_se3(T: torch.Tensor) -> torch.Tensor:
    """Promote an SE(3) matrix [..., 4, 4] to a Sim3 with s = 1."""
    return pack(torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device),
                T[..., :3, :3], T[..., :3, 3])


def to_se3_scaled(g: torch.Tensor) -> torch.Tensor:
    """Collapse a Sim3 onto SE(3) as loop correction does: keep R, divide t
    by s."""
    from hyslam_tpu_torch.geometry import se3

    s, R, t = unpack(g)
    return se3.from_Rt(R, t / s[..., None])


# 10-point Gauss-Legendre nodes and weights on [0, 1], float32 as in the JAX
# package
_GL_X, _GL_W = np.polynomial.legendre.leggauss(10)
_GL_U = ((_GL_X + 1.0) / 2.0).astype(np.float32)
_GL_A = (_GL_W / 2.0).astype(np.float32)


def _sincsq_arg(x2: torch.Tensor) -> torch.Tensor:
    """sin(sqrt(x2)) / sqrt(x2), with a Taylor form under 1e-4."""
    small = x2 < 1e-4
    sx = torch.sqrt(torch.where(small, 1.0, x2))
    return torch.where(small, 1.0 - x2 / 6.0 + x2 * x2 / 120.0, torch.sin(sx) / sx)


def _W_coeffs(sigma: torch.Tensor, theta2: torch.Tensor):
    """(A, B, C) of W = A I + B hat(w) + C hat(w)^2, W = int_0^1 e^{sigma u}
    exp(u hat(w)) du, by the fixed quadrature rule."""
    u = torch.as_tensor(_GL_U, dtype=sigma.dtype, device=sigma.device)
    a = torch.as_tensor(_GL_A, dtype=sigma.dtype, device=sigma.device)
    es = torch.exp(sigma[..., None] * u)
    x2 = (u * u) * theta2[..., None]
    snc = _sincsq_arg(x2)
    snc_h = _sincsq_arg(x2 / 4.0)
    A = torch.sum(a * es, dim=-1)
    B = torch.sum(a * es * u * snc, dim=-1)
    C = torch.sum(a * es * (u * u) * 0.5 * snc_h * snc_h, dim=-1)
    return A, B, C


def _W(sigma: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    A, B, C = _W_coeffs(sigma, torch.sum(w * w, dim=-1))
    Wh = so3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wh.shape)
    return A[..., None, None] * eye + B[..., None, None] * Wh + C[..., None, None] * (Wh @ Wh)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map [..., 7] (sigma, omega, upsilon) -> packed Sim3 [..., 8]."""
    sigma, w, v = xi[..., 0], xi[..., 1:4], xi[..., 4:7]
    return pack(torch.exp(sigma), so3.exp(w), _mv(_W(sigma, w), v))


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A [..., 3, 3] x = b [..., 3] by the adjugate over the determinant."""
    c0 = torch.cross(A[..., 1, :], A[..., 2, :], dim=-1)
    c1 = torch.cross(A[..., 2, :], A[..., 0, :], dim=-1)
    c2 = torch.cross(A[..., 0, :], A[..., 1, :], dim=-1)
    det = torch.sum(A[..., 0, :] * c0, dim=-1)
    adj_t = torch.stack([c0, c1, c2], dim=-1)        # adj(A) = [c0 c1 c2]
    return _mv(adj_t, b) / det[..., None]


def log(g: torch.Tensor) -> torch.Tensor:
    """Logarithm map: packed Sim3 [..., 8] -> [..., 7] (sigma, omega, upsilon)."""
    s, R, t = unpack(g)
    sigma = torch.log(s)
    w = so3.log(R)
    return torch.cat([sigma[..., None], w, _solve3(_W(sigma, w), t)], dim=-1)
