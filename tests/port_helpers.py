"""Shared pieces of the PyTorch port's parity tests: conversions between the
JAX package and the port (through numpy), the small scene both are fed, and
the comparison measures the tests state their bounds in."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hyslam_tpu.core.frame import FrameFeatures as JFrameFeatures
from hyslam_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from hyslam_tpu.geometry.camera import Camera as JCamera
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.utils import synth

# the small sizes of tests/test_frontend.py: 320x240, 4 levels, 200
# features, capacity 256, a 512-row local map
SMALL_CAM = Camera(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320,
                   height=240, bf=30.0)
J_SMALL_CAM = JCamera(**SMALL_CAM._asdict())
CFG = ExtractorConfig(n_features=200, n_levels=4)
J_CFG = JExtractorConfig(n_features=200, n_levels=4)
F_CAP = 256
L_MAP = 512


def to_torch(x) -> torch.Tensor:
    """JAX or numpy array -> CPU tensor (uint32 -> int32 bit-view)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return interop.desc_to_torch(a)
    return torch.from_numpy(np.array(a))


def to_jax(x: torch.Tensor, uint32: bool = False):
    a = x.detach().cpu().numpy()
    return jnp.asarray(a.view(np.uint32) if uint32 else a)


def feats_to_torch(f):
    return interop.features_from_numpy(jax.tree.map(np.asarray, f))


def feats_to_jax(f) -> JFrameFeatures:
    return JFrameFeatures(**{k: jnp.asarray(v) for k, v in
                             interop.features_to_numpy(f).items()})


def bits(desc) -> np.ndarray:
    """[..., 8] descriptors (either dtype) -> [..., 256] 0/1 uint8."""
    a = np.asarray(desc).view(np.uint32)
    return ((a[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(
        np.uint8).reshape(a.shape[:-1] + (256,))


def angle_diff(a, b) -> np.ndarray:
    """|a - b| on the circle, so that -pi and +pi agree."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def small_world(seed: int = 0):
    """The world of tests/test_frontend.py's slice test: 150 points."""
    rng = np.random.default_rng(seed)
    return synth.make_world(rng, 150, extent=(4.0, 3.0, 10.0), z_min=3.0)


def stereo_pair(Tcw, pts) -> np.ndarray:
    return synth.render_stereo_pair(SMALL_CAM, Tcw, pts)


def seeded_map(feats_np: dict, Tcw=None) -> dict:
    """L_MAP-row local map seeded from one frame's (numpy) features."""
    Tcw = np.eye(4) if Tcw is None else Tcw
    return synth.seed_landmarks(
        SMALL_CAM, Tcw, feats_np["uv"], feats_np["depth"], feats_np["level"],
        feats_np["desc"], feats_np["valid"], L_MAP)


def map_args_jax(table: dict) -> tuple:
    return tuple(jnp.asarray(table[k]) for k in interop.LandmarkTable._fields)


def map_args_torch(table: dict) -> interop.LandmarkTable:
    return interop.landmarks_from_numpy(
        *(table[k] for k in interop.LandmarkTable._fields))
