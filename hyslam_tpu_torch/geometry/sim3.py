"""Sim(3): similarity transforms (s, R, t) acting on points as
x' = s * R @ x + t (counterpart of ``hyslam_tpu/geometry/sim3.py``).

Packed representation: [..., 8] = (s, qw, qx, qy, qz, tx, ty, tz). Ported is
what the Horn alignment and ``io.evaluate.ate_rmse(align="sim3")`` use:
``pack``, ``unpack`` and ``apply``. The group operations, ``exp`` and
``log`` come with loop closing (ROADMAP step 15b).
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import so3


def pack(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([s[..., None], so3.quat_from_mat(R), t], dim=-1)


def unpack(g: torch.Tensor):
    return g[..., 0], so3.mat_from_quat(g[..., 1:5]), g[..., 5:8]


def apply(g: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    s, R, t = unpack(g)
    return s[..., None] * torch.einsum("...ij,...j->...i", R, pts) + t
