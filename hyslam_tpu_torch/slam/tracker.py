"""Per-camera tracking: the state machine and per-frame orchestration
(counterpart of ``hyslam_tpu/slam/tracker.py``, the synchronous stereo
path).

  INITIALIZE -> POSTINIT (5 forced-keyframe frames) -> NORMAL

A host-side state machine sequences the strategies, the keyframe policy and
the mapper. Per NORMAL frame it reads the packed decision counters back once;
a keyframe adds the mapper's reads. Not ported yet, each raising
NotImplementedError where it would be entered: monocular tracking (ROADMAP
step 13), RELOCALIZE (step 14), REINITIALIZE after a loss, forced-loss fault
injection and sensor readings (step 16), the async tracking loop (step 12).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Optional

import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core import trajectory as TJ
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.core.mapstate import MapCaps, MapState, empty_map_state
from hyslam_tpu_torch.core.sensordata import empty_sensor_arena
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.slam.initializers import stereo_initialize
from hyslam_tpu_torch.slam.keyframe_policy import (
    KeyFramePolicyParams,
    KFDecisionInputs,
    need_new_keyframe,
    seed_close_landmarks,
)
from hyslam_tpu_torch.slam.mapper import Mapper
from hyslam_tpu_torch.slam.strategies import TrackResult, track_normal_frame
from hyslam_tpu_torch.slam.tracking_params import TrackingParams


class State(enum.Enum):
    """eTrackingState analog (Tracking_datastructs.h:21-30)."""

    NO_IMAGES_YET = 0
    INITIALIZE = 1
    POSTINIT = 2
    NORMAL = 3
    RELOCALIZE = 4
    REINITIALIZE = 5
    NULL = 6


POSTINIT_FRAMES = 5          # TrackingStatePostInitialization hold

_NOT_PORTED = {
    State.RELOCALIZE: "RELOCALIZE (place recognition) is ROADMAP step 14",
    State.REINITIALIZE: "REINITIALIZE (a new registered sub-map) is ROADMAP step 16",
    State.NULL: "the NULL state of imaging cameras is ROADMAP step 17",
    State.NO_IMAGES_YET: "NO_IMAGES_YET is not a tracking state",
}


@dataclass
class TrackerTelemetry:
    """Per-frame telemetry row (tracking_data.txt analog)."""

    frame_id: int = 0
    state: str = ""
    n_motion: int = 0
    n_inliers: int = 0
    n_local: int = 0
    kf_inserted: int = -1
    n_seeded: int = 0
    mapper_stats: dict = field(default_factory=dict)


@dataclass
class Tracker:
    cam: Camera
    cam_id: int = 0
    caps: MapCaps = MapCaps()
    is_mono: bool = False         # monocular: ROADMAP step 13
    policy: KeyFramePolicyParams = field(default_factory=KeyFramePolicyParams)
    reset_interval: int = 0       # forced-loss fault injection: step 16
    opt_info: object = None       # sensor-prior weights, held for step 16
    n_levels: int = 8             # pyramid model of this camera's extractor
    scale_factor: float = 1.2
    params: TrackingParams = field(default_factory=TrackingParams)
    device: object = None         # where the map state lives (default CPU)

    def __post_init__(self):
        if self.is_mono:
            raise NotImplementedError(
                "monocular tracking (mono initializer) is ROADMAP step 13, not ported")
        if self.reset_interval or self.params.normal.reset_interval > 0:
            raise NotImplementedError(
                "forced-loss fault injection enters REINITIALIZE, ROADMAP step 16")
        self.device = torch.device(self.device if self.device is not None else "cpu")
        self.ms: MapState = empty_map_state(self.caps, device=self.device)
        self.sensors = empty_sensor_arena(self.caps.K, device=self.device)
        self.traj = TJ.empty_trajectory(device=self.device)
        self.mapper = Mapper(self.cam, n_levels=self.n_levels,
                             scale_factor=self.scale_factor)
        self.state = State.INITIALIZE
        self.last_feats: Optional[FrameFeatures] = None
        self.last_lm_id = None
        eye = torch.eye(4, dtype=torch.float32, device=self.device)
        self.last_Tcw = eye
        self.last_Tcr = eye
        self.last_ref_kf = -1
        self.ref_kf = -1
        self.last_kf_frame_id = -(10**6)
        self.postinit_left = 0
        self.frames_since_reloc = 10**6
        self.n_frames = 0
        self.telemetry: list[TrackerTelemetry] = []
        self.last_result = None   # the last NORMAL-state NormalFrameResult

    # -- public -------------------------------------------------------------

    def track(self, feats: FrameFeatures, timestamp: float, frame_id: int,
              sensor_data=None) -> TrackerTelemetry:
        """Process one frame (features on the tracker's device); returns its
        TrackerTelemetry."""
        if sensor_data is not None:
            raise NotImplementedError(
                "sensor readings on keyframes feed pose priors, ROADMAP step 16")
        if self.state not in (State.INITIALIZE, State.POSTINIT, State.NORMAL):
            raise NotImplementedError(_NOT_PORTED[self.state])
        tel = TrackerTelemetry(frame_id=frame_id, state=self.state.name)
        self.n_frames += 1
        if self.state == State.INITIALIZE:
            self._do_initialize(feats, timestamp, frame_id, tel)
        else:
            self._do_normal(feats, timestamp, frame_id, tel)
        self.telemetry.append(tel)
        return tel

    @property
    def current_Tcw(self) -> torch.Tensor:
        return self.last_Tcw

    # -- states -------------------------------------------------------------

    def _do_initialize(self, feats, timestamp, frame_id, tel):
        """Stereo initialization at the origin; on too little depth the map
        stays as it was and the state stays INITIALIZE."""
        ms, kf_id, n = stereo_initialize(self.ms, feats, self.cam, timestamp,
                                         frame_id, self.cam_id)
        if kf_id < 0:
            return
        self.ms = ms
        tel.n_seeded = n
        self.last_Tcw = self.ms.kf.Tcw[kf_id]
        self.ref_kf = kf_id
        self.last_ref_kf = kf_id
        self.last_Tcr = torch.eye(4, dtype=torch.float32, device=self.device)
        self.last_kf_frame_id = frame_id
        self.last_feats = feats
        self.last_lm_id = self.ms.kf.lm_id[kf_id]
        self.traj = TJ.append(self.traj, timestamp, self.last_Tcw, kf_id,
                              self.ms.kf.Tcw[kf_id], True)
        self.state = State.POSTINIT
        self.postinit_left = POSTINIT_FRAMES
        tel.kf_inserted = kf_id

    def _update_last_frame(self):
        """UpdateLastFrame (Tracking.cpp:249): re-derive the last frame's
        pose from its (possibly re-optimized) reference keyframe."""
        if self.last_ref_kf >= 0:
            self.last_Tcw = self.last_Tcr @ self.ms.kf.Tcw[self.last_ref_kf]

    def _do_normal(self, feats, timestamp, frame_id, tel):
        self._update_last_frame()
        min_inl = (self.params.normal.thresh_refine_postreloc
                   if self.frames_since_reloc < 30
                   else self.params.normal.thresh_refine)
        nf = track_normal_frame(
            self.cam, feats, timestamp, self.traj, self.last_Tcw,
            self.last_feats, self.last_lm_id, self.ref_kf, self.ms, min_inl,
            n_levels=self.n_levels, scale_factor=self.scale_factor,
            params=self.params)
        self.last_result = nf
        # one read of the counters and the local map's reference keyframe
        (n_motion, init_ok, n_inliers, n_local, n_tracked_close,
         n_nontracked_close, ok, n_kfs, local_ref_kf) = torch.cat(
            [nf.scalars, nf.local_ref_kf.reshape(1).to(torch.int32)]).tolist()
        tel.n_motion = n_motion
        tel.n_inliers = n_inliers
        tel.n_local = n_local
        if not (init_ok and ok):
            self._lose_tracking()
        tr = TrackResult(Tcw=nf.Tcw, lm_id=nf.lm_id, n_inliers=n_inliers, ok=True)
        self.ref_kf = local_ref_kf

        inp = KFDecisionInputs(
            n_inliers=n_inliers, frame_id=frame_id,
            last_kf_frame_id=self.last_kf_frame_id, n_kfs_in_map=n_kfs,
            n_tracked_close=n_tracked_close, n_nontracked_close=n_nontracked_close,
            mapping_idle=True, mapping_queue_len=0, is_mono=False,
            force=self.state == State.POSTINIT)
        kf_id = -1
        if need_new_keyframe(inp, self.policy):
            kf_id = self._insert_keyframe(feats, tr, timestamp, frame_id, tel)

        # trajectory append, relative to the reference keyframe
        ref = kf_id if kf_id >= 0 else self.ref_kf
        ref_pose = self.ms.kf.Tcw[ref]
        self.traj = TJ.append(self.traj, timestamp, tr.Tcw, ref, ref_pose, True)
        self.last_Tcw = tr.Tcw
        self.last_Tcr = tr.Tcw @ se3.inverse(ref_pose)
        self.last_ref_kf = ref
        self.last_feats = feats
        self.last_lm_id = tr.lm_id
        self.frames_since_reloc += 1
        if self.state == State.POSTINIT:
            self.postinit_left -= 1
            if self.postinit_left <= 0:
                self.state = State.NORMAL

    def _insert_keyframe(self, feats, tr, timestamp, frame_id, tel) -> int:
        """Add the frame as a keyframe, seed its close stereo points, and
        run the mapper's jobs on it. Returns the keyframe id, or -1 when
        the keyframe arena is full."""
        kf_id = int(self.ms.next_kf)
        if kf_id >= self.caps.K:
            return -1
        ms, _ = M.add_keyframe(self.ms, feats, tr.Tcw, timestamp, frame_id,
                               self.cam_id, tr.lm_id)
        ms, n_seeded = seed_close_landmarks(ms, kf_id, self.cam)
        tel.n_seeded = int(n_seeded)
        ms, tel.mapper_stats = self.mapper.integrate_keyframe(
            ms, kf_id, sensors=self.sensors)
        self.ms = ms
        self.last_kf_frame_id = frame_id
        self.ref_kf = kf_id
        tel.kf_inserted = kf_id
        return kf_id

    def _lose_tracking(self):
        """Tracking was lost: a stereo camera enters REINITIALIZE, which is
        not ported yet, so this raises."""
        self.state = State.REINITIALIZE
        raise NotImplementedError(
            "tracking lost: " + _NOT_PORTED[State.REINITIALIZE])
