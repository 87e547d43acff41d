"""Per-keyframe auxiliary sensor arrays (counterpart of
``hyslam_tpu/core/sensordata.py``; only the empty arena the Tracker builds
is ported. Sensor readings and the pose priors they feed are ROADMAP
step 16)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SensorArena(NamedTuple):
    """Per-keyframe sensor arrays, slot-aligned with the KeyFrame arena."""

    gps: torch.Tensor          # [K, 3]
    gps_err: torch.Tensor      # [K, 3]
    gps_valid: torch.Tensor    # [K] bool
    quat: torch.Tensor         # [K, 4] (w, x, y, z)
    quat_valid: torch.Tensor   # [K] bool
    depth: torch.Tensor        # [K]
    depth_valid: torch.Tensor  # [K] bool


def empty_sensor_arena(K: int, device=None) -> SensorArena:
    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return SensorArena(
        gps=z(K, 3), gps_err=torch.ones((K, 3), device=device),
        gps_valid=z(K, dtype=torch.bool),
        quat=torch.tensor([1.0, 0.0, 0.0, 0.0], device=device).repeat(K, 1),
        quat_valid=z(K, dtype=torch.bool), depth=z(K),
        depth_valid=z(K, dtype=torch.bool),
    )
