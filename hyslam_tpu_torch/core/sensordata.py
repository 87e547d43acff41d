"""Per-keyframe auxiliary sensor data: GPS, IMU orientation, pressure depth
(counterpart of ``hyslam_tpu/core/sensordata.py``).

A GPS position (a local metric frame, or lat/lon through
``latlon_to_relative``) with a per-axis error, an absolute orientation
quaternion from an AHRS IMU, and a scalar depth reading, each with a
validity flag. The readings live in arrays aligned slot for slot with the
keyframe arena, so bundle adjustment gathers them as tensors and turns them
into batched unary pose residuals (``solver/priors.py``).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

# WGS84 ellipsoid
_WGS84_A = 6378137.0
_WGS84_E2 = 6.69437999014e-3


class SensorData(NamedTuple):
    """One frame's sensor record (host-side).

    gps_rel:  (x, y, z) position in the local metric GPS frame
    gps_err:  per-axis 1-sigma error (same units)
    quat:     absolute orientation (w, x, y, z) of the camera (world->cam)
    depth:    scalar depth from pressure
    """

    gps_rel: Sequence[float] = (0.0, 0.0, 0.0)
    gps_err: Sequence[float] = (1.0, 1.0, 1.0)
    gps_valid: bool = False
    quat: Sequence[float] = (1.0, 0.0, 0.0, 0.0)
    quat_valid: bool = False
    depth: float = 0.0
    depth_valid: bool = False


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


def set_sensor(arena: SensorArena, k: int, sd: SensorData) -> SensorArena:
    """Write one keyframe's sensor record into a copy of the arena (one
    small host-to-device copy per field, nothing read back)."""
    k = int(k)
    new = {
        "gps": np.asarray(sd.gps_rel, np.float32),
        "gps_err": np.asarray(sd.gps_err, np.float32),
        "gps_valid": bool(sd.gps_valid),
        "quat": np.asarray(sd.quat, np.float32),
        "quat_valid": bool(sd.quat_valid),
        "depth": float(sd.depth),
        "depth_valid": bool(sd.depth_valid),
    }
    out = {}
    for name, v in new.items():
        a = getattr(arena, name).clone()
        a[k] = torch.as_tensor(v, dtype=a.dtype)
        out[name] = a
    return SensorArena(**out)


def latlon_to_relative(lat, lon, alt, lat0: float, lon0: float,
                       alt0: float = 0.0) -> np.ndarray:
    """Geodetic (deg) -> local east/north/up metric coordinates about a
    reference point (the local-tangent form: no UTM dependency, equivalent
    over the extent of a survey site). float64 numpy inside, float32 out."""
    lat = np.asarray(lat, np.float64)
    lon = np.asarray(lon, np.float64)
    alt = np.asarray(alt, np.float64)
    phi = math.radians(lat0)
    s, c = math.sin(phi), math.cos(phi)
    # radii of curvature at the reference latitude
    den = math.sqrt(1.0 - _WGS84_E2 * s * s)
    Rn = _WGS84_A / den                         # prime vertical
    Rm = _WGS84_A * (1.0 - _WGS84_E2) / den**3  # meridian
    east = np.radians(lon - lon0) * (Rn + alt0) * c
    north = np.radians(lat - lat0) * (Rm + alt0)
    up = alt - alt0
    return np.stack([east, north, up], axis=-1).astype(np.float32)
