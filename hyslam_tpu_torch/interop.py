"""Carry state between the JAX package and the port.

The port has no learned weights: its "parameters" are constant tables,
rebuilt in the port from the same numpy code, and the map state. These
functions turn JAX-package arrays, given as numpy (``np.asarray`` of a JAX
array), into the port's tensors and back. Objects are read by field name,
so nothing here imports the JAX package.

Descriptors travel as the int32 bit-view of the JAX package's uint32 lanes:
every bit is kept, and ``features_to_numpy`` restores uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.geometry.camera import Camera

_FEATURE_DTYPES = {
    "uv": np.float32, "ur": np.float32, "depth": np.float32,
    "level": np.int32, "angle": np.float32, "valid": np.bool_,
}


def desc_to_torch(desc, device=None) -> torch.Tensor:
    """[..., 8] uint32 (or int32 bit-view) descriptors -> int32 tensor with
    the same bits."""
    a = np.asarray(desc)
    if a.dtype not in (np.uint32, np.int32):
        raise TypeError(f"descriptors must be uint32 or int32, got {a.dtype}")
    return torch.from_numpy(np.array(a).view(np.int32)).to(device)


def desc_to_numpy(desc: torch.Tensor) -> np.ndarray:
    """int32 descriptor tensor -> [..., 8] uint32 numpy, the same bits."""
    return desc.detach().cpu().numpy().astype(np.int32).view(np.uint32)


def features_from_numpy(f, device=None) -> FrameFeatures:
    """Any object with FrameFeatures' fields as arrays (a JAX-package
    FrameFeatures, or the dict from ``features_to_numpy``) -> the port's
    FrameFeatures on ``device``. A leading batch axis is kept."""
    get = f.__getitem__ if isinstance(f, dict) else (lambda k: getattr(f, k))
    fields = {
        k: torch.from_numpy(np.array(get(k), dtype=dt)).to(device)
        for k, dt in _FEATURE_DTYPES.items()
    }
    return FrameFeatures(desc=desc_to_torch(get("desc"), device), **fields)


def features_to_numpy(f: FrameFeatures) -> dict:
    """The port's FrameFeatures -> dict of numpy arrays in the JAX package's
    dtypes (uint32 descriptors): ``FrameFeatures(**d)`` of either package."""
    d = {k: getattr(f, k).detach().cpu().numpy().astype(dt)
         for k, dt in _FEATURE_DTYPES.items()}
    d["desc"] = desc_to_numpy(f.desc)
    return d


def camera_from(cam) -> Camera:
    """A JAX-package Camera (any object with Camera's fields) -> Camera."""
    return Camera(**{k: getattr(cam, k) for k in Camera._fields})


def extractor_config_from(cfg) -> ExtractorConfig:
    """A JAX-package ExtractorConfig -> ExtractorConfig."""
    return ExtractorConfig(**{k: getattr(cfg, k) for k in ExtractorConfig._fields})


class LandmarkTable(NamedTuple):
    """The local-map arrays that ``track_stereo_frame`` takes, in order."""

    lm_pos: torch.Tensor       # [L,3] f32
    lm_normal: torch.Tensor    # [L,3] f32
    lm_desc: torch.Tensor      # [L,8] int32 bit-view
    lm_max_dist: torch.Tensor  # [L] f32
    lm_min_dist: torch.Tensor  # [L] f32
    lm_valid: torch.Tensor     # [L] bool


def landmarks_from_numpy(lm_pos, lm_normal, lm_desc, lm_max_dist, lm_min_dist,
                         lm_valid, device=None) -> LandmarkTable:
    def f32(x):
        return torch.from_numpy(np.array(x, dtype=np.float32)).to(device)

    return LandmarkTable(
        lm_pos=f32(lm_pos), lm_normal=f32(lm_normal),
        lm_desc=desc_to_torch(lm_desc, device),
        lm_max_dist=f32(lm_max_dist), lm_min_dist=f32(lm_min_dist),
        lm_valid=torch.from_numpy(np.array(lm_valid, dtype=np.bool_)).to(device),
    )


def landmarks_to_numpy(t: LandmarkTable) -> dict:
    d = {k: getattr(t, k).detach().cpu().numpy()
         for k in ("lm_pos", "lm_normal", "lm_max_dist", "lm_min_dist", "lm_valid")}
    d["lm_desc"] = desc_to_numpy(t.lm_desc)
    return d
