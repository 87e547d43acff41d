"""Horn 1987 closed-form Sim(3)/SE(3) point-set alignment, batched and
weighted (counterpart of ``hyslam_tpu/geometry/horn.py``).

Finds (s, R, t) minimizing sum_i w_i || y_i - (s R x_i + t) ||^2 by the
quaternion eigenvector method. Runs in the dtype and on the device of its
inputs.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import se3, sim3, so3


DEGENERATE_RTOL = 1e-3


def horn_sim3(x: torch.Tensor, y: torch.Tensor, weights: torch.Tensor | None = None,
              fix_scale: bool = False, q_prior: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted Horn alignment mapping x -> y.

    x, y: [..., N, 3] correspondences. weights: [..., N] (>= 0) or None.
    Returns packed Sim3 [..., 8]; with fix_scale=True, s = 1.

    Where the points are collinear the rotation about their line is not
    fixed by them: the top eigenvalue of Horn's N matrix is double and the
    eigenvector an arbitrary one of its plane (the JAX package takes what
    its ``eigh`` returns). With ``q_prior`` [..., 4] (w, x, y, z), a top
    eigenvalue within DEGENERATE_RTOL of the next, relative, gives the unit
    vector of that plane nearest q_prior instead; otherwise nothing
    changes."""
    if weights is None:
        weights = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    wsum = torch.sum(weights, dim=-1, keepdim=True)
    wn = (weights / torch.clamp_min(wsum, 1e-12))[..., None]

    cx = torch.sum(wn * x, dim=-2)
    cy = torch.sum(wn * y, dim=-2)
    xc = x - cx[..., None, :]
    yc = y - cy[..., None, :]

    # cross-covariance with Horn's indexing: S_ab = sum_n w_n * x_a * y_b
    M = torch.einsum("...ni,...nj->...ij", wn * xc, yc)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]

    # Horn's symmetric 4x4 N matrix; its top eigenvector is the quaternion
    # rotating x into y
    N = torch.stack(
        [
            torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
            torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
            torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
            torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
        ],
        dim=-2,
    )
    vals, vecs = torch.linalg.eigh(N)
    q = vecs[..., :, -1]
    if q_prior is not None:
        plane = vecs[..., :, -2:]
        proj = (plane @ (plane.transpose(-1, -2) @ q_prior[..., None]))[..., 0]
        norm = torch.linalg.norm(proj, dim=-1, keepdim=True)
        degenerate = ((vals[..., -1:] - vals[..., -2:-1])
                      <= DEGENERATE_RTOL * vals[..., -1:].abs()) & (norm > 1e-6)
        q = torch.where(degenerate, proj / torch.clamp_min(norm, 1e-6), q)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    R = so3.mat_from_quat(q)

    # symmetric scale (Horn sec. 2E): s = sqrt(sum|yc|^2 / sum|xc|^2)
    num = torch.sum(wn[..., 0] * torch.sum(yc * yc, dim=-1), dim=-1)
    den = torch.sum(wn[..., 0] * torch.sum(xc * xc, dim=-1), dim=-1)
    s = torch.sqrt(torch.clamp_min(num, 1e-24) / torch.clamp_min(den, 1e-24))
    if fix_scale:
        s = torch.ones_like(s)

    t = cy - s[..., None] * torch.einsum("...ij,...j->...i", R, cx)
    return sim3.pack(s, R, t)


def horn_se3(x: torch.Tensor, y: torch.Tensor,
             weights: torch.Tensor | None = None) -> torch.Tensor:
    """Rigid (fixed-scale) Horn alignment; returns SE(3) [..., 4, 4]."""
    _, R, t = sim3.unpack(horn_sim3(x, y, weights, fix_scale=True))
    return se3.from_Rt(R, t)
