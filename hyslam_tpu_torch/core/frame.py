"""Per-image feature containers (counterpart of ``hyslam_tpu/core/frame.py``).

Descriptors are ``[..., 8]`` int32 tensors holding the bits of the JAX
package's ``[..., 8]`` uint32 lanes: torch's CPU uint32 has no ``>>``, and an
int32 bit-view keeps every bit (``interop.py`` converts both ways).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# Pyramid scale model, copied from hyslam_tpu/core/frame.py (the reference's
# FeatureExtractorSettings: scale factor 1.2, 8 levels, sigma^2 = scale^2L).
DEFAULT_SCALE_FACTOR = 1.2
DEFAULT_N_LEVELS = 8


def level_sigma2(n_levels=DEFAULT_N_LEVELS, scale=DEFAULT_SCALE_FACTOR,
                 device=None) -> torch.Tensor:
    s = np.asarray(scale ** np.arange(n_levels), np.float32)
    return torch.as_tensor(s * s, device=device)


def level_inv_sigma2(n_levels=DEFAULT_N_LEVELS, scale=DEFAULT_SCALE_FACTOR,
                     device=None) -> torch.Tensor:
    return 1.0 / level_sigma2(n_levels, scale, device)


def feature_inv_sigma2(level: torch.Tensor, n_levels=DEFAULT_N_LEVELS,
                       scale=DEFAULT_SCALE_FACTOR) -> torch.Tensor:
    """Per-feature information weight from pyramid level [..] -> [..]."""
    table = level_inv_sigma2(n_levels, scale, level.device)
    return table[level.clamp(0, n_levels - 1).long()]


class FrameFeatures(NamedTuple):
    """Extracted features of one image, padded to capacity F (a leading
    batch axis is allowed on every field).

    uv:     [F, 2] f32 pixel coords (level-0 / full-res frame)
    ur:     [F]    f32 right-image u for stereo matches, -1 where absent
    depth:  [F]    f32 stereo depth, -1 where absent
    level:  [F]    int32 pyramid level
    angle:  [F]    f32 orientation (radians)
    desc:   [F, 8] int32 bit-view of the packed 256-bit descriptor
    valid:  [F]    bool real-feature mask
    """

    uv: torch.Tensor
    ur: torch.Tensor
    depth: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    desc: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.uv.shape[-2]


def empty_features(F: int, device=None) -> FrameFeatures:
    return FrameFeatures(
        uv=torch.zeros((F, 2), dtype=torch.float32, device=device),
        ur=torch.full((F,), -1.0, dtype=torch.float32, device=device),
        depth=torch.full((F,), -1.0, dtype=torch.float32, device=device),
        level=torch.zeros((F,), dtype=torch.int32, device=device),
        angle=torch.zeros((F,), dtype=torch.float32, device=device),
        desc=torch.zeros((F, 8), dtype=torch.int32, device=device),
        valid=torch.zeros((F,), dtype=torch.bool, device=device),
    )
