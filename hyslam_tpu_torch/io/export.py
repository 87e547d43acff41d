"""Data exporters and map checkpointing (counterpart of
``hyslam_tpu/io/export.py``).

Trajectory TSV (name, time, 3x4 [Rwc|twc] row-major) and TUM text, the
COLMAP sparse text model, the Agisoft Metashape XML, the landmark TSV, and
the full MapState / tracker checkpoint as one npz. All of it is host code
over numpy views of the state.

The npz files carry the JAX package's key names and dtypes (descriptors as
uint32 on disk, the int32 bit-view in memory), so a map or checkpoint
written by either package loads in the other.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np
import torch

from hyslam_tpu_torch import interop
from hyslam_tpu_torch.device import resolve_device
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.core.sensordata import SensorArena
from hyslam_tpu_torch.core.trajectory import Trajectory
from hyslam_tpu_torch.geometry import se3, so3
from hyslam_tpu_torch.geometry.camera import Camera


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def save_trajectory_tsv(path: str, traj: Trajectory, name: str = "SLAM",
                        align_first_kf: np.ndarray | None = None):
    """Reference format: name \\t time \\t r00 r01 r02 tx r10.. (camera->world)."""
    n = int(traj.size)
    Twc = _np(se3.inverse(traj.Tcw[:n]))
    if align_first_kf is not None:
        # re-base the world so that the first keyframe sits at the origin
        T0w = np.asarray(align_first_kf)  # first KF's Tcw
        Twc = np.einsum("ij,njk->nik", T0w, Twc)
    t = _np(traj.t[:n])
    with open(path, "w") as f:
        for i in range(n):
            R = Twc[i, :3, :3]
            c = Twc[i, :3, 3]
            row = [name, f"{t[i]:.9f}"]
            for r in range(3):
                row += [f"{R[r,0]:.6f}", f"{R[r,1]:.6f}", f"{R[r,2]:.6f}",
                        f"{c[r]:.6f}"]
            f.write("\t".join(row) + "\n")


def save_trajectory_tum(path: str, traj: Trajectory):
    """TUM RGB-D benchmark format (ts tx ty tz qx qy qz qw, camera->world)."""
    n = int(traj.size)
    Twc_t = se3.inverse(traj.Tcw[:n])
    Twc = _np(Twc_t)
    q = _np(so3.quat_from_mat(Twc_t[:, :3, :3]))
    t = _np(traj.t[:n])
    with open(path, "w") as f:
        for i in range(n):
            c = Twc[i, :3, 3]
            f.write(
                f"{t[i]:.6f} {c[0]:.6f} {c[1]:.6f} {c[2]:.6f} "
                f"{q[i,1]:.6f} {q[i,2]:.6f} {q[i,3]:.6f} {q[i,0]:.6f}\n"
            )


def export_colmap(folder: str, ms: MapState, cam: Camera, cam_name="SLAM"):
    """COLMAP sparse-model text: cameras.txt / images.txt / points3D.txt
    (PINHOLE model, keyframes as images, landmarks as points with their
    observation tracks)."""
    out = os.path.join(folder, cam_name)
    os.makedirs(out, exist_ok=True)
    kf_ok = _np(ms.kf.valid & ~ms.kf.bad)
    lm_ok = _np(ms.lm.valid & ~ms.lm.bad)
    Tcw = _np(ms.kf.Tcw)
    q = _np(so3.quat_from_mat(ms.kf.Tcw[:, :3, :3]))
    lm_id = _np(ms.kf.lm_id)
    uv = _np(ms.kf.uv)
    kp_ok = _np(ms.kf.kp_valid)
    pos = _np(ms.lm.pos)
    obs_kf = _np(ms.lm.obs_kf)
    obs_feat = _np(ms.lm.obs_feat)
    obs_ok = _np(ms.lm.obs_valid)

    with open(os.path.join(out, "cameras.txt"), "w") as f:
        f.write("# Camera list: CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]\n")
        f.write(
            f"1 PINHOLE {cam.width} {cam.height} "
            f"{cam.fx} {cam.fy} {cam.cx} {cam.cy}\n"
        )
    with open(os.path.join(out, "images.txt"), "w") as f:
        f.write("# IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME\n")
        for k in np.nonzero(kf_ok)[0]:
            tx, ty, tz = Tcw[k, :3, 3]
            f.write(
                f"{k+1} {q[k,0]:.8f} {q[k,1]:.8f} {q[k,2]:.8f} {q[k,3]:.8f} "
                f"{tx:.8f} {ty:.8f} {tz:.8f} 1 kf{k:06d}.png\n"
            )
            pts2d = []
            for s in np.nonzero(kp_ok[k])[0]:
                l = lm_id[k, s]
                pts2d.append(
                    f"{uv[k,s,0]:.2f} {uv[k,s,1]:.2f} {l+1 if l >= 0 else -1}"
                )
            f.write(" ".join(pts2d) + "\n")
    with open(os.path.join(out, "points3D.txt"), "w") as f:
        f.write("# POINT3D_ID X Y Z R G B ERROR TRACK[] (IMAGE_ID POINT2D_IDX)\n")
        for l in np.nonzero(lm_ok)[0]:
            track = []
            for o in np.nonzero(obs_ok[l])[0]:
                track += [str(obs_kf[l, o] + 1), str(obs_feat[l, o])]
            f.write(
                f"{l+1} {pos[l,0]:.6f} {pos[l,1]:.6f} {pos[l,2]:.6f} "
                f"128 128 128 1.0 " + " ".join(track) + "\n"
            )


def save_keyframes_agisoft(path: str, ms: MapState, cam: Camera,
                           cam_name="SLAM"):
    """Agisoft Metashape camera-calibration XML: a sensor block with the
    intrinsics and one camera per keyframe with its 4x4 camera->world
    transform."""
    kf_ok = _np(ms.kf.valid & ~ms.kf.bad)
    Twc = _np(se3.inverse(ms.kf.Tcw))
    doc = ET.Element("document", version="1.2.0")
    chunk = ET.SubElement(doc, "chunk")
    sensors = ET.SubElement(chunk, "sensors")
    sensor = ET.SubElement(sensors, "sensor", id="0", label=cam_name,
                           type="frame")
    ET.SubElement(sensor, "resolution",
                  width=str(cam.width), height=str(cam.height))
    calib = ET.SubElement(sensor, "calibration", type="frame")
    ET.SubElement(calib, "resolution", width=str(cam.width),
                  height=str(cam.height))
    ET.SubElement(calib, "f").text = str(cam.fx)
    ET.SubElement(calib, "cx").text = str(cam.cx - cam.width / 2.0)
    ET.SubElement(calib, "cy").text = str(cam.cy - cam.height / 2.0)
    cameras = ET.SubElement(chunk, "cameras")
    for k in np.nonzero(kf_ok)[0]:
        c = ET.SubElement(cameras, "camera", id=str(int(k)),
                          sensor_id="0", label=f"kf{k:06d}")
        t = ET.SubElement(c, "transform")
        t.text = " ".join(f"{v:.9g}" for v in Twc[k].reshape(-1))
    ET.indent(doc)
    ET.ElementTree(doc).write(path, xml_declaration=True, encoding="utf-8")


def save_map_points_tsv(path: str, ms: MapState):
    """Landmark positions TSV."""
    lm_ok = _np(ms.lm.valid & ~ms.lm.bad)
    pos = _np(ms.lm.pos)
    with open(path, "w") as f:
        for l in np.nonzero(lm_ok)[0]:
            f.write(f"{pos[l,0]:.6f}\t{pos[l,1]:.6f}\t{pos[l,2]:.6f}\n")


# ---------------------------------------------------------------------------
# checkpoint / restore
# ---------------------------------------------------------------------------

def _flatten(flat: dict, prefix: str, nt) -> None:
    """A NamedTuple of tensors into flat["prefix.field"] as numpy in the JAX
    package's dtypes (descriptors uint32)."""
    for name, val in nt._asdict().items():
        flat[f"{prefix}.{name}"] = (interop.desc_to_numpy(val) if name == "desc"
                                    else _np(val))


def _flatten_map(flat: dict, ms: MapState) -> None:
    _flatten(flat, "kf", ms.kf)
    _flatten(flat, "lm", ms.lm)
    _flatten(flat, "maps", ms.maps)
    for k in ("covis", "next_kf", "next_lm"):
        flat[k] = _np(getattr(ms, k))


def _sub(z, prefix: str, cls) -> dict:
    return {name: z[f"{prefix}.{name}"] for name in cls._fields}


def _map_from(z, device) -> MapState:
    from hyslam_tpu_torch.core import mapstate as MS

    return interop.map_state_from_numpy({
        "kf": _sub(z, "kf", MS.KeyFrameArena), "lm": _sub(z, "lm", MS.LandmarkArena),
        "maps": _sub(z, "maps", MS.MapTable),
        **{k: z[k] for k in ("covis", "next_kf", "next_lm")}}, device)


def save_map_state(path: str, ms: MapState):
    """Serialize the full MapState to one npz (poses, landmarks,
    associations, covisibility, sub-map table, cursors)."""
    flat = {}
    _flatten_map(flat, ms)
    np.savez_compressed(path, **flat)


def load_map_state(path: str, device=None) -> MapState:
    """The MapState of an npz written by ``save_map_state`` of either
    package, on ``device``: the card where it is None
    (``device.resolve_device``; raises where there is none)."""
    return _map_from(np.load(path), resolve_device(device))


def save_checkpoint(path: str, tracker, system_scalars=None) -> None:
    """Full per-camera checkpoint: map state, trajectory, sensor arena and
    the tracker's host state. system_scalars: optional iterable of
    System-level counters (frame counter, keyframes since global BA) stored
    alongside."""
    flat = {}
    _flatten_map(flat, tracker.ms)
    _flatten(flat, "traj", tracker.traj)
    _flatten(flat, "sensors", tracker.sensors)
    flat["tk.state"] = np.asarray(tracker.state.value)
    flat["tk.last_Tcw"] = _np(tracker.last_Tcw)
    flat["tk.last_Tcr"] = _np(tracker.last_Tcr)
    flat["tk.scalars"] = np.asarray([
        tracker.ref_kf, tracker.last_ref_kf, tracker.last_kf_frame_id,
        tracker.n_frames, tracker.postinit_left, tracker.frames_since_reloc,
        tracker.mapper.kf_count,
    ])
    if system_scalars is not None:
        flat["sys.scalars"] = np.asarray(list(system_scalars))
    if tracker.last_feats is not None:
        _flatten(flat, "last_feats", tracker.last_feats)
        flat["tk.last_lm_id"] = _np(tracker.last_lm_id)
    np.savez_compressed(path, **flat)


def load_checkpoint(path: str, tracker):
    """Restore a tracker from a checkpoint of either package (in place, on
    the tracker's device). Returns the saved System-level scalars, or None
    if none were stored."""
    from hyslam_tpu_torch.slam.mapper import _has_priors
    from hyslam_tpu_torch.slam.tracker import State

    z = np.load(path)
    dev = tracker.device
    tracker.ms = _map_from(z, dev)
    tracker.traj = interop.trajectory_from_numpy(_sub(z, "traj", Trajectory), dev)
    tracker.sensors = interop.sensor_arena_from_numpy(_sub(z, "sensors", SensorArena), dev)
    # the async loop's host-known flag "local BA takes the prior path": the
    # file may hold sensor readings or registered sub-maps
    tracker._has_priors = _has_priors(tracker.ms, tracker.sensors)
    tracker.state = State(int(z["tk.state"]))
    tracker.last_Tcw = torch.from_numpy(np.array(z["tk.last_Tcw"], np.float32)).to(dev)
    tracker.last_Tcr = torch.from_numpy(np.array(z["tk.last_Tcr"], np.float32)).to(dev)
    sc = [int(x) for x in z["tk.scalars"]]
    (tracker.ref_kf, tracker.last_ref_kf, tracker.last_kf_frame_id,
     tracker.n_frames) = sc[:4]
    if len(sc) >= 7:  # the first checkpoints stored only the first four
        tracker.postinit_left = sc[4]
        tracker.frames_since_reloc = sc[5]
        tracker.mapper.kf_count = sc[6]
    if "last_feats.uv" in z:
        tracker.last_feats = interop.features_from_numpy(
            _sub(z, "last_feats", FrameFeatures), dev)
        tracker.last_lm_id = torch.from_numpy(
            np.array(z["tk.last_lm_id"], np.int32)).to(dev)
    return z["sys.scalars"] if "sys.scalars" in z else None
