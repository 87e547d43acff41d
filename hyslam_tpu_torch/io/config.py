"""Typed configuration tree (counterpart of ``hyslam_tpu/io/config.py``): a
primary YAML config with per-camera blocks and the state -> parameter-set
indirection, parsed into dataclasses and NamedTuples with the JAX package's
fields and defaults. ``SystemConfig`` also names the device the system runs
on. ``yaml`` is needed by ``load_config`` only and imported there; a
``SystemConfig`` can always be built in code."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, Optional

from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
from hyslam_tpu_torch.slam.mapper import MapperParams
from hyslam_tpu_torch.slam.tracking_params import (
    TrackingParams,
    resolve_tracking_params,
)


@dataclass
class CameraConfig:
    """Per-camera calibration block.

    fx/fy/cx/cy/bf/width/height are given at the camera's NATIVE resolution
    (as in the reference's YAML, e.g. fx=1829 @ 2704x2028 with scale 0.5);
    when scale != 1 the ``camera()`` accessor multiplies the calibration by
    scale so that it matches the pre-scaled images ``preprocess_image``
    produces."""

    name: str = "SLAM"
    fx: float = 450.0
    fy: float = 450.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    bf: float = 0.0
    th_depth: float = 35.0
    fps: float = 30.0
    scale: float = 1.0          # image pre-scaling (Imaging camera 0.5)
    mono: bool = False
    Tcam: Optional[list] = None  # 4x4 rig extrinsic body->camera
    extractor: ExtractorConfig = field(default_factory=ExtractorConfig)
    init_feature_factor: int = 3  # feature-budget multiplier while a
                                  # monocular tracker initializes
    policy: KeyFramePolicyParams = field(default_factory=KeyFramePolicyParams)
    tracking: TrackingParams = field(default_factory=TrackingParams)
        # the camera's resolved state/strategy parameter sets

    def camera(self) -> Camera:
        # the calibration is stored at native resolution; scale it to the
        # working (pre-scaled) resolution. bf = baseline * fx scales with fx.
        s = float(self.scale)
        return Camera(
            fx=self.fx * s, fy=self.fy * s, cx=self.cx * s, cy=self.cy * s,
            width=int(round(self.width * s)), height=int(round(self.height * s)),
            bf=0.0 if self.mono else self.bf * s,
            th_depth=self.th_depth,
            Tcam=None if self.Tcam is None else tuple(
                tuple(float(x) for x in row) for row in self.Tcam),
            scale=self.scale, fps=self.fps,
        )


@dataclass
class OptimizerInfo:
    """Sensor information weights and the global-BA cadence."""

    gps_info: float = 0.0
    imu_info: float = 0.0
    depth_info: float = 0.0
    tiepoint_info: float = 1.0
    realtime: bool = True
    gba_interval: int = 50      # periodic GBA every N keyframes (offline)


@dataclass
class SystemConfig:
    cameras: Dict[str, CameraConfig] = field(
        default_factory=lambda: {"SLAM": CameraConfig()}
    )
    mapper: MapperParams = field(default_factory=MapperParams)
    optimizer: OptimizerInfo = field(default_factory=OptimizerInfo)
    caps: MapCaps = MapCaps()
    enable_loop_closing: bool = True
    vocab_path: Optional[str] = None
    viewer: bool = False
    pipelined: bool = False   # the threaded pipeline (runtime.pipeline)
    async_tracking: bool = False
                              # the async tracking loop: one dispatched frame
                              # after another, the host decisions committed
                              # commit_lag frames later from a non-blocking
                              # fetch of the decision counters
    commit_lag: int = 2       # decision latency of the async loop
    run_data_dir: Optional[str] = None  # enables the TSV telemetry logs
    device: object = None     # where the system's state lives and its frames
                              # are processed; None = the current CUDA card


def _build(cls, d: dict):
    fields = cls._fields if hasattr(cls, "_fields") else None
    if fields is not None:  # NamedTuple
        return cls(**{k: v for k, v in d.items() if k in fields})
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def load_config(path: str) -> SystemConfig:
    """Load a primary YAML config (see config/sample_config.yaml)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)
    tracking_raw = raw.get("tracking") or {}
    cams = {}
    for name, c in (raw.get("cameras") or {}).items():
        ex = _build(ExtractorConfig, c.pop("extractor", {}) or {})
        pol_block = c.pop("policy", {}) or {}
        cc = _build(CameraConfig, {**c, "name": name})
        cc.extractor = ex
        if tracking_raw:
            # the state/strategy indirection; its Normal block carries the
            # keyframe policy unless the camera sets an explicit one
            cc.tracking = resolve_tracking_params(
                tracking_raw, name, is_mono=cc.mono)
            cc.policy = (_build(KeyFramePolicyParams, pol_block)
                         if pol_block else cc.tracking.policy)
        else:
            cc.policy = _build(KeyFramePolicyParams, pol_block)
        cams[name] = cc
    cfg = SystemConfig(cameras=cams or {"SLAM": CameraConfig()})
    if "mapper" in raw:
        cfg.mapper = _build(MapperParams, raw["mapper"] or {})
    if "optimizer" in raw:
        cfg.optimizer = _build(OptimizerInfo, raw["optimizer"] or {})
    if "caps" in raw:
        cfg.caps = _build(MapCaps, raw["caps"] or {})
    cfg.enable_loop_closing = bool(raw.get("enable_loop_closing", True))
    cfg.vocab_path = raw.get("vocab_path")
    cfg.run_data_dir = raw.get("run_data_dir")
    cfg.pipelined = bool(raw.get("pipelined", False))
    cfg.async_tracking = bool(raw.get("async_tracking", False))
    cfg.commit_lag = int(raw.get("commit_lag", 2))
    cfg.device = raw.get("device")
    return cfg
