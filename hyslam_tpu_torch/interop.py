"""Carry state and configuration between the JAX package and the port.

The port has no learned weights: its "parameters" are constant tables,
rebuilt in the port from the same numpy code, and the map state. These
functions turn JAX-package arrays, given as numpy (``np.asarray`` of a JAX
array), into the port's tensors and back: features, cameras, extractor
configs, landmark tables, whole map states, trajectories, the async loop's
tracker state, sensor records and arenas, BA's pose priors and whole BA
problems, a whole
``SystemConfig``, the BoW vocabulary, and a loop closer's state (its
recognizer's rows, consistency groups and loop edges). Objects are read by field name,
so nothing here imports the JAX package.

Descriptors travel as the int32 bit-view of the JAX package's uint32 lanes:
every bit is kept, and ``features_to_numpy`` restores uint32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.core.trajectory import Trajectory
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


def _tensor(a, device) -> torch.Tensor:
    """A numpy (or JAX) array -> tensor; uint32 travels as its int32 view."""
    a = np.array(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(device)


def _tuple_from(cls, src, device):
    get = src.__getitem__ if isinstance(src, dict) else (lambda k: getattr(src, k))
    return cls(**{k: _tensor(get(k), device) for k in cls._fields})


def _tuple_to(t) -> dict:
    """NamedTuple of tensors -> dict of numpy; descriptor fields back to
    uint32."""
    return {k: (desc_to_numpy(v) if k == "desc" else v.detach().cpu().numpy())
            for k, v in t._asdict().items()}


def map_state_from_numpy(ms, device=None):
    """A JAX-package MapState (read by field name, its arrays through
    numpy), or the dict from ``map_state_to_numpy`` -> the port's MapState
    on ``device``, bit for bit."""
    get = ms.__getitem__ if isinstance(ms, dict) else (lambda k: getattr(ms, k))
    return M.MapState(
        kf=_tuple_from(M.KeyFrameArena, get("kf"), device),
        lm=_tuple_from(M.LandmarkArena, get("lm"), device),
        maps=_tuple_from(M.MapTable, get("maps"), device),
        **{k: _tensor(get(k), device) for k in ("covis", "next_kf", "next_lm")},
    )


def map_state_to_numpy(ms) -> dict:
    """The port's MapState -> nested dict of numpy arrays in the JAX
    package's dtypes (uint32 descriptors): {"kf": {...}, "lm": {...},
    "maps": {...}, "covis", "next_kf", "next_lm"}."""
    out = {k: _tuple_to(getattr(ms, k)) for k in ("kf", "lm", "maps")}
    out.update({k: getattr(ms, k).detach().cpu().numpy()
                for k in ("covis", "next_kf", "next_lm")})
    return out


def trajectory_from_numpy(traj, device=None):
    """A JAX-package Trajectory (or the dict from ``trajectory_to_numpy``)
    -> the port's Trajectory on ``device``."""
    return _tuple_from(Trajectory, traj, device)


def trajectory_to_numpy(traj) -> dict:
    return _tuple_to(traj)


def sensor_arena_from_numpy(arena, device=None):
    """A JAX-package SensorArena (or the dict from ``sensor_arena_to_numpy``)
    -> the port's on ``device``."""
    from hyslam_tpu_torch.core.sensordata import SensorArena

    return _tuple_from(SensorArena, arena, device)


def sensor_arena_to_numpy(arena) -> dict:
    return _tuple_to(arena)


def sensor_data_from(sd):
    """A SensorData of either package (plain host numbers, read by field)
    -> the port's SensorData; ``SensorData(**sd._asdict())`` is the way back."""
    from hyslam_tpu_torch.core.sensordata import SensorData

    return SensorData(**{k: getattr(sd, k) for k in SensorData._fields})


def pose_priors_from_numpy(pr, device=None):
    """A JAX-package PosePriors (or the dict from ``pose_priors_to_numpy``)
    -> the port's on ``device``."""
    from hyslam_tpu_torch.solver.priors import PosePriors

    return _tuple_from(PosePriors, pr, device)


def pose_priors_to_numpy(pr) -> dict:
    return _tuple_to(pr)


def ba_problem_from_numpy(p, device=None):
    """A JAX-package BAProblem (read by field name, its arrays through
    numpy; pose priors included), or the dict from ``ba_problem_to_numpy``
    -> the port's BAProblem on ``device``."""
    from hyslam_tpu_torch.solver.ba import BAObservations, BAProblem, CamArrays

    get = p.get if isinstance(p, dict) else (lambda k: getattr(p, k))
    pr = get("priors")
    return BAProblem(
        kf_Tcw=_tensor(get("kf_Tcw"), device), kf_fixed=_tensor(get("kf_fixed"), device),
        cams=_tuple_from(CamArrays, get("cams"), device),
        lm_pos=_tensor(get("lm_pos"), device), lm_valid=_tensor(get("lm_valid"), device),
        obs=_tuple_from(BAObservations, get("obs"), device),
        priors=None if pr is None else pose_priors_from_numpy(pr, device))


def ba_problem_to_numpy(p) -> dict:
    """The port's BAProblem -> nested dict of numpy arrays ("cams", "obs"
    and "priors" as dicts; "priors" None where there are none)."""
    out = {k: getattr(p, k).detach().cpu().numpy()
           for k in ("kf_Tcw", "kf_fixed", "lm_pos", "lm_valid")}
    out.update(cams=_tuple_to(p.cams), obs=_tuple_to(p.obs),
               priors=None if p.priors is None else _tuple_to(p.priors))
    return out


def dev_track_state_from_numpy(dev, device=None):
    """A JAX-package DevTrackState (its arrays through numpy), or the dict
    from ``dev_track_state_to_numpy`` -> the port's on ``device``."""
    from hyslam_tpu_torch.slam.strategies import DevTrackState

    get = dev.__getitem__ if isinstance(dev, dict) else (lambda k: getattr(dev, k))
    fields = {k: _tensor(get(k), device) for k in DevTrackState._fields
              if k != "last_feats"}
    return DevTrackState(last_feats=features_from_numpy(get("last_feats"), device),
                         **fields)


def dev_track_state_to_numpy(dev) -> dict:
    d = {k: v.detach().cpu().numpy() for k, v in dev._asdict().items()
         if k != "last_feats"}
    d["last_feats"] = features_to_numpy(dev.last_feats)
    return d


def _named_tuple_from(cls, src):
    """A NamedTuple of Python numbers (or of such NamedTuples) by field."""
    out = {}
    for k in cls._fields:
        v = getattr(src, k)
        sub = cls._field_defaults.get(k)
        out[k] = _named_tuple_from(type(sub), v) if hasattr(sub, "_fields") else v
    return cls(**out)


def system_config_from(cfg, device=None):
    """A JAX-package SystemConfig -> the port's, field by field (dataclasses
    and NamedTuples read as plain attributes), running on ``device``."""
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.io.config import CameraConfig, OptimizerInfo, SystemConfig
    from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
    from hyslam_tpu_torch.slam.mapper import MapperParams
    from hyslam_tpu_torch.slam.tracking_params import TrackingParams

    import dataclasses

    nested = {"extractor": ExtractorConfig, "policy": KeyFramePolicyParams,
              "tracking": TrackingParams}
    cams = {}
    for name, cc in cfg.cameras.items():
        kw = {f.name: getattr(cc, f.name) for f in dataclasses.fields(CameraConfig)
              if f.name not in nested}
        kw.update({k: _named_tuple_from(cls, getattr(cc, k)) for k, cls in nested.items()})
        cams[name] = CameraConfig(**kw)
    plain = ("enable_loop_closing", "vocab_path", "viewer", "pipelined",
             "async_tracking", "commit_lag", "run_data_dir")
    return SystemConfig(
        cameras=cams, mapper=_named_tuple_from(MapperParams, cfg.mapper),
        optimizer=OptimizerInfo(**{f.name: getattr(cfg.optimizer, f.name)
                                   for f in dataclasses.fields(OptimizerInfo)}),
        caps=_named_tuple_from(MapCaps, cfg.caps), device=device,
        **{k: getattr(cfg, k) for k in plain})


def vocabulary_from_numpy(vocab, device=None):
    """A JAX-package Vocabulary (or the dict from ``vocabulary_to_numpy``)
    -> the port's on ``device``, bit for bit."""
    from hyslam_tpu_torch.features.bow import vocabulary_from_arrays

    get = vocab.__getitem__ if isinstance(vocab, dict) else (lambda k: getattr(vocab, k))
    return vocabulary_from_arrays(*(get(k) for k in (
        "centers", "children", "word_id", "idf", "k", "depth")), device=device)


def vocabulary_to_numpy(vocab) -> dict:
    """The port's Vocabulary -> dict of numpy arrays in the JAX package's
    dtypes (uint32 centers): ``Vocabulary(**d)`` of either package."""
    from hyslam_tpu_torch.features.bow import vocabulary_arrays

    return vocabulary_arrays(vocab)


def loop_closer_from(closer, device=None):
    """A JAX-package LoopCloser (its PlaceRecognizer's vocabulary, BoW rows
    ``kf_bow``, ``present``, and the closer's ``consistency``,
    ``loop_edges``, ``last_loop_kf``, ``n_closed``; or the dict from
    ``loop_closer_to_numpy``) -> the port's LoopCloser on ``device``."""
    from hyslam_tpu_torch.features.bow import PlaceRecognizer
    from hyslam_tpu_torch.slam.loop_closing import LoopCloser

    get = closer.__getitem__ if isinstance(closer, dict) else (lambda k: getattr(closer, k))
    rec = get("recognizer")
    rget = rec.__getitem__ if isinstance(rec, dict) else (lambda k: getattr(rec, k))
    kf_bow = np.asarray(rget("kf_bow"), np.float32)
    pr = PlaceRecognizer(vocabulary_from_numpy(rget("vocab"), device), K=kf_bow.shape[0])
    pr.kf_bow = torch.from_numpy(np.array(kf_bow)).to(device)
    pr.present = np.array(rget("present"), bool)
    return LoopCloser(
        cam=camera_from(get("cam")), recognizer=pr, fix_scale=bool(get("fix_scale")),
        consistency=[(set(int(x) for x in g), int(c)) for g, c in get("consistency")],
        loop_edges=[(int(i), int(j), np.array(m, np.float32)) for i, j, m in get("loop_edges")],
        last_loop_kf=int(get("last_loop_kf")), n_closed=int(get("n_closed")))


def loop_closer_to_numpy(closer) -> dict:
    """The port's LoopCloser -> nested dict of numpy arrays and plain
    values, which ``loop_closer_from`` reads back."""
    pr = closer.recognizer
    return dict(
        cam=closer.cam, fix_scale=closer.fix_scale,
        recognizer=dict(vocab=vocabulary_to_numpy(pr.vocab), kf_bow=pr.kf_bow.cpu().numpy(),
                        present=pr.present.copy()),
        consistency=[(set(g), c) for g, c in closer.consistency],
        loop_edges=[(i, j, np.array(m)) for i, j, m in closer.loop_edges],
        last_loop_kf=closer.last_loop_kf, n_closed=closer.n_closed)
