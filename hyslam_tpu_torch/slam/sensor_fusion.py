"""Assemble PosePriors for bundle adjustment from the per-keyframe sensor
arena and the sub-map tiepoint table (counterpart of
``hyslam_tpu/slam/sensor_fusion.py``).

- GPS: fit a GPS->SLAM Horn Sim3 on all keyframes carrying a valid fix
  (at least ``MIN_GPS_FIXES``), carry each fix into the SLAM frame, rotate
  the per-axis GPS error into the SLAM frame and take its reciprocal as
  diagonal information, scaled by ``OptimizerInfo.gps_info``.
- IMU / depth: per-keyframe unary priors weighted by ``imu_info`` /
  ``depth_info``.
- Tiepoints: one SE3 edge per registered sub-map between its origin keyframe
  and the parent's tiepoint keyframe, weighted by ``tiepoint_info``.

This is host code, run once per BA call: everything it needs is fetched
from the device in one transfer (``fetch``), the Horn fit and the error
rotation run in numpy / CPU tensors, and the finished priors are uploaded.
"""

from __future__ import annotations

import numpy as np
import torch

from hyslam_tpu_torch.core.mapstate import MAX_MAPS, MapState, camera_centers
from hyslam_tpu_torch.core.sensordata import SensorArena
from hyslam_tpu_torch.geometry import sim3
from hyslam_tpu_torch.geometry.horn import horn_sim3
from hyslam_tpu_torch.solver.priors import PosePriors

MIN_GPS_FIXES = 5  # the reference requires more than 4 fixes

_NUMPY_DTYPE = {torch.float32: np.float32, torch.int32: np.int32,
                torch.int64: np.int64, torch.bool: np.bool_}


def fetch(*tensors: torch.Tensor) -> list:
    """The tensors as numpy arrays in their own dtypes. From a card they
    travel as one float32 buffer in one transfer: bool, float32 and integers
    below 2^24 in size (slot and map ids) survive the round trip exactly;
    another dtype or a larger integer raises."""
    if not tensors:
        return []
    for t in tensors:
        if t.dtype not in _NUMPY_DTYPE:
            raise TypeError(f"fetch: {t.dtype} does not travel exactly as float32")
    if tensors[0].device.type == "cpu":
        return [t.numpy() for t in tensors]
    return _fetch_packed(tensors)


def _fetch_packed(tensors) -> list:
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        a = flat[at:at + n].reshape(tuple(t.shape))
        # rounding to float32 is monotonic: an integer of 2^24 or more shows
        if t.dtype in (torch.int32, torch.int64) and n and np.abs(a).max() >= 2.0 ** 24:
            raise OverflowError("fetch: an integer of 2^24 or more does not travel "
                                "exactly as float32")
        out.append(a.astype(_NUMPY_DTYPE[t.dtype]))
        at += n
    return out


def gps_alignment(centers: np.ndarray, gps: np.ndarray):
    """Horn Sim3 mapping GPS coordinates -> SLAM camera centers (float32,
    on the host). Returns (g packed [8], R [3,3]) or (None, None) when
    degenerate."""
    g = horn_sim3(torch.from_numpy(np.ascontiguousarray(gps, np.float32)),
                  torch.from_numpy(np.ascontiguousarray(centers, np.float32)),
                  fix_scale=False)
    if not bool(torch.all(torch.isfinite(g))):
        return None, None
    _, R, _ = sim3.unpack(g)
    return g.numpy(), R.numpy()


def rotate_gps_info(gps_err: np.ndarray, R: np.ndarray) -> np.ndarray:
    """Per-axis information of GPS errors rotated into the SLAM frame:
    rotate the per-axis error columns, take the row norms as the new
    per-axis error, information = 1 / error. float64 numpy."""
    merr_r = R @ (np.eye(3) * gps_err[:, None, :])        # [K, 3, 3]
    err_rot = np.linalg.norm(merr_r, axis=-1)             # row norms [K, 3]
    return 1.0 / np.maximum(err_rot, 1e-9)


def _tie_tensors(ms: MapState) -> tuple:
    return (ms.kf.map_id, ms.kf.origin & ms.kf.valid & ~ms.kf.bad, ms.maps.tie_kf,
            ms.maps.registered, ms.maps.parent, ms.maps.n_maps, ms.maps.Tse3_parent)


def _tiepoint_edges(kf_map, kf_origin, tie_kf, registered, parent, n_maps, Tse3):
    tie_a = np.zeros(MAX_MAPS, np.int32)
    tie_b = np.zeros(MAX_MAPS, np.int32)
    tie_T = np.tile(np.eye(4, dtype=np.float32), (MAX_MAPS, 1, 1))
    tie_valid = np.zeros(MAX_MAPS, bool)
    # n_maps is a cursor that only grows: clamp it to the table's capacity
    for mid in range(min(int(n_maps), MAX_MAPS)):
        if parent[mid] < 0 or not registered[mid] or tie_kf[mid] < 0:
            continue
        origins = np.nonzero(kf_origin & (kf_map == mid))[0]
        if origins.size == 0:
            continue
        tie_a[mid] = tie_kf[mid]
        tie_b[mid] = origins[0]
        tie_T[mid] = Tse3[mid]
        tie_valid[mid] = True
    return tie_a, tie_b, tie_T, tie_valid


def build_tiepoint_edges(ms: MapState):
    """(tie_a, tie_b, tie_T, tie_valid) numpy arrays [MAX_MAPS] from the map
    table: one edge per registered sub-map with a tiepoint, between the
    parent's tiepoint keyframe (a) and the sub-map's origin keyframe (b),
    measurement M = Tse3_parent (pose_b = M pose_a)."""
    return _tiepoint_edges(*fetch(*_tie_tensors(ms)))


def pose_priors_numpy(ms: MapState, sensors: SensorArena | None = None,
                      opt=None, include_tiepoints: bool = True,
                      extra: tuple = ()):
    """The fields of ``build_pose_priors`` as a dict of numpy arrays (None
    when no prior would be active), and the ``extra`` tensors fetched along
    in the same transfer. Returns (fields or None, extras list)."""
    if opt is None:
        # imported here: io.config imports the mapper, which imports this
        from hyslam_tpu_torch.io.config import OptimizerInfo

        opt = OptimizerInfo()
    K = ms.K
    use_tie = include_tiepoints and opt.tiepoint_info > 0
    want = list(_tie_tensors(ms)) if use_tie else []
    n_tie = len(want)
    if sensors is not None:
        want += [ms.kf.valid & ~ms.kf.bad, camera_centers(ms), *sensors]
    got = fetch(*want, *extra)
    extras = got[len(want):]

    E = MAX_MAPS if include_tiepoints else 0
    f32 = np.float32
    pr = dict(
        gps_pos=np.zeros((K, 3), f32), gps_info=np.zeros((K, 3), f32),
        gps_valid=np.zeros(K, bool),
        imu_quat=np.tile(np.asarray([1.0, 0, 0, 0], f32), (K, 1)),
        imu_info=np.zeros(K, f32), imu_valid=np.zeros(K, bool),
        depth=np.zeros(K, f32), depth_info=np.zeros(K, f32),
        depth_valid=np.zeros(K, bool),
        tie_a=np.zeros(E, np.int32), tie_b=np.zeros(E, np.int32),
        tie_T=np.tile(np.eye(4, dtype=f32), (E, 1, 1)),
        tie_info=np.zeros(E, f32), tie_valid=np.zeros(E, bool),
    )
    any_active = False

    if use_tie:
        tie_a, tie_b, tie_T, tie_valid = _tiepoint_edges(*got[:n_tie])
        any_active = bool(tie_valid.any())
        pr.update(tie_a=tie_a, tie_b=tie_b, tie_T=tie_T, tie_valid=tie_valid,
                  tie_info=np.full(MAX_MAPS, float(opt.tiepoint_info), f32))

    if sensors is not None:
        kf_ok, centers = got[n_tie], got[n_tie + 1]
        sn = SensorArena(*got[n_tie + 2:n_tie + 2 + len(SensorArena._fields)])
        if opt.imu_info > 0:
            imu_valid = sn.quat_valid & kf_ok
            if imu_valid.any():
                any_active = True
                pr.update(imu_quat=sn.quat, imu_valid=imu_valid,
                          imu_info=np.full(K, float(opt.imu_info), f32))
        if opt.depth_info > 0:
            depth_valid = sn.depth_valid & kf_ok
            if depth_valid.any():
                any_active = True
                pr.update(depth=sn.depth, depth_valid=depth_valid,
                          depth_info=np.full(K, float(opt.depth_info), f32))
        if opt.gps_info > 0:
            gps_valid = sn.gps_valid & kf_ok
            if gps_valid.sum() >= MIN_GPS_FIXES:
                g, Rg = gps_alignment(centers[gps_valid], sn.gps[gps_valid])
                if g is not None:
                    any_active = True
                    gps_slam = sim3.apply(torch.from_numpy(g),
                                          torch.from_numpy(np.ascontiguousarray(sn.gps)))
                    info = rotate_gps_info(sn.gps_err, Rg) * float(opt.gps_info)
                    pr.update(gps_pos=gps_slam.numpy(), gps_info=info.astype(f32),
                              gps_valid=gps_valid)
    return (pr if any_active else None), extras


def priors_to_device(fields: dict, device) -> PosePriors:
    return PosePriors(**{
        k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
        for k, v in fields.items()})


def build_pose_priors(ms: MapState, sensors: SensorArena | None = None,
                      opt=None, include_tiepoints: bool = True) -> PosePriors | None:
    """PosePriors slot-aligned with the keyframe arena, on the map's device,
    or None when no prior would be active (BA then skips the prior path).
    ``opt`` is an ``io.config.OptimizerInfo`` (default: its defaults)."""
    fields, _ = pose_priors_numpy(ms, sensors, opt, include_tiepoints)
    return None if fields is None else priors_to_device(fields, ms.kf.Tcw.device)
