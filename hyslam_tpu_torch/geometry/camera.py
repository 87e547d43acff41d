"""Pinhole camera model (counterpart of ``hyslam_tpu/geometry/camera.py``)."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Camera(NamedTuple):
    """Static camera description with the JAX package's fields, all Python
    numbers (``interop.camera_from`` converts a JAX-package Camera)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float = 0.0          # stereo baseline * fx; 0 => monocular
    th_depth: float = 35.0   # close/far stereo point threshold, in baselines
    Tcam: tuple | None = None  # rig extrinsic body->camera, 4x4 nested tuple
    scale: float = 1.0       # image pre-scaling applied before processing
    fps: float = 30.0

    @property
    def is_stereo(self) -> bool:
        return self.bf > 0.0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx if self.bf > 0 else 0.0

    @property
    def close_depth(self) -> float:
        """Depth below which a stereo point counts as close (thDepth *
        baseline); infinite for a monocular camera."""
        return self.th_depth * self.baseline if self.bf > 0 else math.inf

    def K(self, dtype=torch.float32, device=None) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=dtype, device=device)

    def K_inv(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """The closed-form inverse of K (no general matrix inverse)."""
        return torch.tensor(
            [[1.0 / self.fx, 0.0, -self.cx / self.fx],
             [0.0, 1.0 / self.fy, -self.cy / self.fy], [0.0, 0.0, 1.0]],
            dtype=dtype, device=device)


def project(cam: Camera, pts_cam: torch.Tensor):
    """Camera-frame points [..., 3] -> (pixel coords [..., 2], depth [...])."""
    z = pts_cam[..., 2]
    zsafe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pts_cam[..., 0] / zsafe + cam.cx
    v = cam.fy * pts_cam[..., 1] / zsafe + cam.cy
    return torch.stack([u, v], dim=-1), z


def backproject(cam: Camera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Pixel coords [..., 2] + depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)
