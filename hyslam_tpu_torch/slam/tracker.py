"""Per-camera tracking: the state machine and per-frame orchestration
(counterpart of ``hyslam_tpu/slam/tracker.py``, the stereo path, synchronous
and async).

  INITIALIZE -> POSTINIT (5 forced-keyframe frames) -> NORMAL
  NORMAL --loss--> REINITIALIZE (stereo): a new registered sub-map at the
                   velocity-extrapolated pose, tied to the last reference
                   keyframe by a tiepoint that BA carries as a pose prior
  NORMAL --loss--> RELOCALIZE (monocular): PnP against ranked keyframes,
                   then NORMAL
  NULL: frames of an accessory camera while the SLAM camera is lost

A stereo camera initializes from one frame's stereo depth, a monocular one
from two frames (``slam.mono_init``: the two-view estimator, median depth 1).

A host-side state machine sequences the strategies, the keyframe policy and
the mapper. ``track`` reads the packed decision counters back once per
NORMAL frame; a keyframe adds the mapper's reads. ``track_async`` dispatches
a frame (``strategies.track_normal_step`` keeps the tracker's state in
tensors), starts a non-blocking fetch of the counters, and commits the host
decisions (loss, keyframe policy, telemetry) ``commit_lag`` frames later, so
the host never waits for the frame it has just dispatched.

A frame's ``sensor_data`` (GPS, IMU orientation, pressure depth) is attached
to the keyframe made from it and feeds local BA's pose priors, weighted by
``opt_info``. ``reset_interval`` forces a loss every N frames (fault
injection).

Relocalization ranks its candidates through ``recognizer``, the BoW place
recognizer that ``System`` hands over once its loop closer exists (dense
similarity before).

``mapping_status`` is the threaded pipeline's view of its mapping stage
(``runtime/pipeline.py``): where it is set, ``idle()`` and ``queue_len()``
feed the keyframe policy's mapping-idle gate, and ``sync(tracker)`` drains
the mapping stage and adopts its map before an initialization or a keyframe
insertion allocates keyframes, so that insertions form one chain (a keyframe
inserted on a snapshot the mapper never saw would be lost at adoption), and
``defer(ms, kf_id, maintenance_sensors, **kw)`` takes a new keyframe's mapper jobs in
place of ``Mapper.integrate_keyframe``.
"""

from __future__ import annotations

import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core import trajectory as TJ
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.core.mapstate import MapCaps, MapState, empty_map_state
from hyslam_tpu_torch.core.sensordata import empty_sensor_arena, set_sensor
from hyslam_tpu_torch.device import default_device
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.slam.initializers import stereo_initialize
from hyslam_tpu_torch.slam.keyframe_policy import (
    KeyFramePolicyParams,
    KFDecisionInputs,
    need_new_keyframe,
    seed_close_landmarks,
)
from hyslam_tpu_torch.slam.mapper import Mapper, MapperParams
from hyslam_tpu_torch.slam.mono_init import MonoInitializer
from hyslam_tpu_torch.slam.relocalization import try_relocalize
from hyslam_tpu_torch.slam.strategies import (
    DevTrackState,
    TrackResult,
    track_normal_frame,
    track_normal_step,
)
from hyslam_tpu_torch.slam.tracking_params import TrackingParams
from hyslam_tpu_torch.utils.telemetry import OFF, StageTimer


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
    State.NO_IMAGES_YET: "NO_IMAGES_YET is not a tracking state",
}


@dataclass
class _Pending:
    """One dispatched, uncommitted frame of the async tracking loop: the
    tensors the lagged host decisions need, and the fetch of its counters."""

    frame_id: int
    timestamp: float
    state_name: str
    force_kf: bool
    feats: FrameFeatures       # on the tracker's device
    scalars: torch.Tensor      # int32 [8] on the host (the fetch's target)
    fetched: object            # torch.cuda.Event after the fetch, or None
    Tcw: torch.Tensor          # [4,4]
    lm_id: torch.Tensor        # [F]
    sensor_data: object = None  # SensorData riding the frame to its keyframe


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
    is_mono: bool = False         # monocular: two-view init, RELOCALIZE on a loss
    policy: KeyFramePolicyParams = field(default_factory=KeyFramePolicyParams)
    reset_interval: int = 0       # forced-loss fault injection: every N frames
    opt_info: object = None       # OptimizerInfo: the weights of the sensor
                                  # and tiepoint priors in local BA
    n_levels: int = 8             # pyramid model of this camera's extractor
    scale_factor: float = 1.2
    params: TrackingParams = field(default_factory=TrackingParams)
    commit_lag: int = 2           # async loop: frames a dispatched frame's
                                  # host decisions trail behind (the
                                  # reference's tracking queue blocks at
                                  # depth 2: the same latency)
    mapper_busy_frames: int = 2   # async loop: frames the mapper's work on
                                  # the last keyframe is taken to occupy; the
                                  # keyframe policy's mapping-idle gate
                                  # (optional keyframes wait while mapping is
                                  # busy) is estimated from it on the host
    on_keyframe: object = None    # async loop: callable(kf_id) after a
                                  # deferred keyframe insertion
    mapping_status: object = None  # the threaded pipeline's view of its
                                   # mapping stage: idle(), queue_len(),
                                   # sync(tracker), defer(); None: no pipeline
    mapper_params: MapperParams = field(default_factory=MapperParams)
    device: object = None         # where the map state lives (default: the card)
    timer: StageTimer = OFF       # the tracer, shared with the mapper
                                  # (OFF: always off)

    def __post_init__(self):
        # fault injection configured through the params tree; the explicit
        # field wins when set
        if not self.reset_interval and self.params.normal.reset_interval > 0:
            self.reset_interval = self.params.normal.reset_interval
        self.device = (torch.device(self.device) if self.device is not None
                       else default_device())
        self.ms: MapState = empty_map_state(self.caps, device=self.device)
        self.sensors = empty_sensor_arena(self.caps.K, device=self.device)
        self._pending_sensor = None   # SensorData of the current frame
        self.traj = TJ.empty_trajectory(device=self.device)
        self.mapper = Mapper(self.cam, params=self.mapper_params,
                             is_mono=self.is_mono, n_levels=self.n_levels,
                             scale_factor=self.scale_factor, timer=self.timer)
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
        # the async tracking loop
        self._pending: deque[_Pending] = deque()
        self._dev: Optional[DevTrackState] = None
        self._kf_mirror = 0       # host mirror of ms.next_kf (exact: every
                                  # allocation is an event the host sees)
        self._has_priors = False  # sensor readings / registered sub-maps
                                  # exist: local BA takes the prior path
        self._fetch_free: list = []   # pinned (buffer, event) pairs not in use
        self._mono_init: Optional[MonoInitializer] = None
        self.recognizer = None        # the BoW place recognizer, from System
        self.reloc_log: list = []     # per RELOCALIZE frame: its frame id,
                                      # try_relocalize's stats and the outcome

    # -- public -------------------------------------------------------------

    def track(self, feats: FrameFeatures, timestamp: float, frame_id: int,
              sensor_data=None) -> TrackerTelemetry:
        """Process one frame (features on the tracker's device); returns its
        TrackerTelemetry. ``sensor_data`` (core.sensordata.SensorData) is
        attached to the keyframe if one is made from this frame."""
        if self.state in _NOT_PORTED:
            raise NotImplementedError(_NOT_PORTED[self.state])
        tel = TrackerTelemetry(frame_id=frame_id, state=self.state.name)
        self.n_frames += 1
        self._pending_sensor = sensor_data
        with self.timer.span("track", frame_id):
            if self.state == State.INITIALIZE:
                self._do_initialize(feats, timestamp, frame_id, tel)
            elif self.state in (State.NORMAL, State.POSTINIT):
                self._do_normal(feats, timestamp, frame_id, tel)
            elif self.state == State.REINITIALIZE:
                self._do_reinitialize(feats, timestamp, frame_id, tel)
            elif self.state == State.RELOCALIZE:
                self._do_relocalize(feats, timestamp, frame_id, tel)
            # State.NULL: the frame is counted and nothing else
        self.telemetry.append(tel)
        return tel

    @property
    def current_Tcw(self) -> torch.Tensor:
        return self.last_Tcw

    # -- states -------------------------------------------------------------

    def _do_initialize(self, feats, timestamp, frame_id, tel, Tcw0=None,
                       as_submap=False, tie_kf=-1):
        """Stereo initialization at Tcw0 (default the origin), with
        ``as_submap`` in a new sub-map that is registered at once, tied to
        keyframe ``tie_kf``. On too little depth the map (a sub-map opened
        here included) stays as it was and so does the state. A monocular
        tracker feeds the frame to its two-frame initializer instead. Under
        the threaded pipeline the mapping stage is drained and its map
        adopted first: keyframes allocated on a stale snapshot would be
        dropped at the next adoption."""
        if self.mapping_status is not None:
            self.mapping_status.sync(self)
        if self.is_mono:
            kf_id = self._mono_initialize(feats, timestamp, frame_id)
            if kf_id >= 0:
                self._initialized(feats, timestamp, frame_id, tel, kf_id,
                                  self.ms.kf.Tcw[kf_id])
            return
        if as_submap and int(self.ms.maps.n_maps) >= M.MAX_MAPS:
            # the sub-map table is full: re-initialize within the active map
            # (a map id past MAX_MAPS would poison every walk of the table)
            as_submap = False
        ms, submap, maps_before = self.ms, None, None
        if as_submap:
            # create_submap writes the map table only: a copy of it is what a
            # failed initialization goes back to, whether the state is
            # updated by copy or in place (else every blank frame in
            # REINITIALIZE would leak an empty sub-map)
            maps_before = M.MapTable(*(t.clone() for t in ms.maps))
            ms, submap = M.create_submap(ms)
        ms, kf_id, n = stereo_initialize(ms, feats, self.cam, timestamp,
                                         frame_id, self.cam_id, Tcw0=Tcw0)
        if kf_id < 0:
            if as_submap:
                self.ms = self.ms._replace(maps=maps_before)
            return
        if as_submap:
            # the tiepoint measurement Tse3 = Tcw_origin @ Tcw_parent^-1, so
            # that pose_this = Tse3 pose_parent: on the host, with numpy's
            # float32 inverse of the 4x4, as the JAX package computes it
            if tie_kf >= 0:
                Tcw_child, Tcw_par = (t.cpu().numpy() for t in
                                      (ms.kf.Tcw[kf_id], ms.kf.Tcw[tie_kf]))
                tse3 = (Tcw_child @ np.linalg.inv(Tcw_par)).astype(np.float32)
            else:
                tse3 = np.eye(4, dtype=np.float32)
            ms = M.register_submap(ms, submap, Tse3_parent=torch.from_numpy(tse3),
                                   tie_kf=tie_kf)
            self._has_priors = True   # tiepoint edges exist now
        self.ms = ms
        tel.n_seeded = n
        self._initialized(feats, timestamp, frame_id, tel, kf_id,
                          self.ms.kf.Tcw[kf_id] if Tcw0 is None else Tcw0)

    def _mono_initialize(self, feats, timestamp, frame_id) -> int:
        """One frame through the two-frame initializer: the second
        keyframe's id once it has made the map, else -1."""
        if self._mono_init is None:
            self._mono_init = MonoInitializer(self.cam)
        done, self.ms, kf_ids = self._mono_init.feed(self.ms, feats, timestamp,
                                                     frame_id, self.cam_id)
        return kf_ids[-1] if done else -1

    def _initialized(self, feats, timestamp, frame_id, tel, kf_id: int, Tcw):
        """The tracker's state after an initialization made keyframe kf_id
        with the frame at pose Tcw: POSTINIT."""
        self.last_Tcw = Tcw
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
        self._attach_sensor(kf_id, self._pending_sensor)

    def _attach_sensor(self, kf_id: int, sensor_data) -> None:
        if sensor_data is not None:
            self.sensors = set_sensor(self.sensors, kf_id, sensor_data)
            self._has_priors = True

    def _update_last_frame(self):
        """UpdateLastFrame (Tracking.cpp:249): re-derive the last frame's
        pose from its (possibly re-optimized) reference keyframe."""
        if self.last_ref_kf >= 0:
            self.last_Tcw = self.last_Tcr @ self.ms.kf.Tcw[self.last_ref_kf]

    def _do_normal(self, feats, timestamp, frame_id, tel):
        self._update_last_frame()
        # fault injection: a forced loss every reset_interval frames
        if self.reset_interval and self.n_frames % self.reset_interval == 0:
            self._lose_tracking()
            tel.state += ">FORCED_LOSS"
            return
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
            return
        tr = TrackResult(Tcw=nf.Tcw, lm_id=nf.lm_id, n_inliers=n_inliers, ok=True)
        self.ref_kf = local_ref_kf

        idle, qlen = True, 0
        if self.mapping_status is not None:
            idle = bool(self.mapping_status.idle())
            qlen = int(self.mapping_status.queue_len())
        inp = KFDecisionInputs(
            n_inliers=n_inliers, frame_id=frame_id,
            last_kf_frame_id=self.last_kf_frame_id, n_kfs_in_map=n_kfs,
            n_tracked_close=n_tracked_close, n_nontracked_close=n_nontracked_close,
            mapping_idle=idle, mapping_queue_len=qlen, is_mono=self.is_mono,
            force=self.state == State.POSTINIT)
        kf_id = -1
        if need_new_keyframe(inp, self.policy):
            if self.mapping_status is not None:
                # drain the mapper and adopt its map, so that keyframe
                # insertions form one chain
                self.mapping_status.sync(self)
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
        """Add the frame as a keyframe, seed its close stereo points (a
        stereo camera's), and run the mapper's jobs on it. Returns the
        keyframe id, or -1 when the keyframe arena is full."""
        with self.timer.span("kf_insert"):
            kf_id = int(self.ms.next_kf)
            if kf_id >= self.caps.K:
                return -1
            ms, _ = M.add_keyframe(self.ms, feats, tr.Tcw, timestamp, frame_id,
                                   self.cam_id, tr.lm_id)
            if not self.is_mono:
                ms, n_seeded = seed_close_landmarks(ms, kf_id, self.cam)
                tel.n_seeded = int(n_seeded)
        sensors = self.sensors      # the mapper's local BA: without this reading
        self._attach_sensor(kf_id, self._pending_sensor)
        self.ms, tel.mapper_stats = self._integrate(ms, kf_id, sensors=sensors,
                                                    opt_info=self.opt_info)
        self.last_kf_frame_id = frame_id
        self.ref_kf = kf_id
        tel.kf_inserted = kf_id
        return kf_id

    # -- async tracking loop --------------------------------------------------

    def track_async(self, feats: FrameFeatures, timestamp: float,
                    frame_id: int, sensor_data=None):
        """Dispatch-only tracking for NORMAL/POSTINIT: nothing of the frame
        it dispatches is read here; its telemetry row appears in
        ``self.telemetry`` at commit time, ``commit_lag`` frames later, and
        None is returned. The cold states (INITIALIZE, REINITIALIZE,
        RELOCALIZE) drain the pending window and run ``track``, returning its
        row."""
        if self.state not in (State.NORMAL, State.POSTINIT):
            self.drain_pending()
            return self.track(feats, timestamp, frame_id, sensor_data=sensor_data)
        self.n_frames += 1
        if self.reset_interval and self.n_frames % self.reset_interval == 0:
            # fault injection is a host event: take the synchronous path
            self.drain_pending()
            if self.state in (State.NORMAL, State.POSTINIT):
                self._sync_dev_to_host()
                self._lose_tracking()
                self.telemetry.append(TrackerTelemetry(
                    frame_id=frame_id, state="NORMAL>FORCED_LOSS"))
            return None
        self._ensure_dev()
        min_inl = (self.params.normal.thresh_refine_postreloc
                   if self.frames_since_reloc < 30
                   else self.params.normal.thresh_refine)
        with self.timer.span("track", frame_id):
            out = track_normal_step(
                self.cam, feats, timestamp, self.traj, self._dev, self.ms, min_inl,
                n_levels=self.n_levels, scale_factor=self.scale_factor,
                params=self.params)
        self.traj = out.traj
        self._dev = out.dev
        scalars, fetched = self._fetch(out.scalars)
        self._pending.append(_Pending(
            frame_id=frame_id, timestamp=timestamp, state_name=self.state.name,
            force_kf=self.state == State.POSTINIT, feats=feats,
            scalars=scalars, fetched=fetched, Tcw=out.Tcw, lm_id=out.lm_id,
            sensor_data=sensor_data))
        while len(self._pending) > self.commit_lag:
            self._commit_one()
        return None

    def drain_pending(self):
        """Commit every dispatched frame that is still unresolved."""
        while self._pending:
            self._commit_one()

    def _fetch(self, scalars: torch.Tensor):
        """Start the fetch of a frame's counters: on a card a non-blocking
        copy into a pinned host buffer of the frame's own and an event
        recorded behind it; on the CPU a plain copy. Returns (host tensor,
        event or None)."""
        if scalars.device.type != "cuda":
            return scalars.clone(), None
        buf, event = (self._fetch_free.pop() if self._fetch_free else (
            torch.empty(scalars.shape, dtype=scalars.dtype, pin_memory=True),
            torch.cuda.Event()))
        buf.copy_(scalars, non_blocking=True)
        event.record()
        return buf, event

    def _read(self, p: _Pending) -> list:
        """A pending frame's counters, waiting for its fetch (not for the
        device) where it has not landed yet."""
        with self.timer.span("commit.wait"):
            if p.fetched is None:
                return p.scalars.tolist()
            p.fetched.synchronize()
            s = p.scalars.tolist()
        self._fetch_free.append((p.scalars, p.fetched))
        return s

    def _ensure_dev(self):
        """Enter async mode: the host tracker state becomes tensors (one
        read of the keyframe cursor for its host mirror)."""
        if self._dev is not None:
            return
        i32 = dict(dtype=torch.int32, device=self.device)
        lm = (self.last_lm_id if self.last_lm_id is not None
              else torch.full((self.caps.F,), -1, **i32))
        self._dev = DevTrackState(
            last_Tcw=self.last_Tcw, last_Tcr=self.last_Tcr,
            last_ref_kf=torch.full((), int(self.last_ref_kf), **i32),
            ref_kf=torch.full((), int(self.ref_kf), **i32),
            last_lm_id=lm.to(torch.int32), last_feats=self.last_feats)
        self._kf_mirror = int(self.ms.next_kf)

    def _sync_dev_to_host(self):
        """Leave async mode: the tensors' state back into the host fields
        that ``track`` and the checkpoint read (blocking)."""
        if self._dev is None:
            return
        d = self._dev
        self.last_Tcw = d.last_Tcw
        self.last_Tcr = d.last_Tcr
        self.last_ref_kf, self.ref_kf = torch.stack([d.last_ref_kf, d.ref_kf]).tolist()
        self.last_lm_id = d.last_lm_id
        self.last_feats = d.last_feats
        self._dev = None

    def _commit_one(self):
        """Resolve the oldest pending frame: read its fetched counters and
        run the host state machine for it (loss, keyframe policy, telemetry),
        ``commit_lag`` frames late."""
        p = self._pending.popleft()
        with self.timer.span("commit"):
            return self._commit(p)

    def _commit(self, p: _Pending):
        s = self._read(p)
        tel = TrackerTelemetry(frame_id=p.frame_id, state=p.state_name,
                               n_motion=s[0], n_inliers=s[2], n_local=s[3])
        self.telemetry.append(tel)
        if not (s[1] and s[6]):
            # the frames still in flight tracked against the frozen
            # last-good state; if the tail re-acquired, the blip heals
            # without a state transition, otherwise the tracker is lost
            recovered = False
            while self._pending:
                q = self._pending.popleft()
                sq = self._read(q)
                self.telemetry.append(TrackerTelemetry(
                    frame_id=q.frame_id, state=q.state_name, n_motion=sq[0],
                    n_inliers=sq[2], n_local=sq[3]))
                recovered = bool(sq[1] and sq[6])
            if not recovered:
                self._sync_dev_to_host()
                tel.state += ">LOST"
                self._lose_tracking()
            return tel

        self.frames_since_reloc += 1
        if self.state == State.POSTINIT:
            self.postinit_left -= 1
            if self.postinit_left <= 0:
                self.state = State.NORMAL

        if self.mapping_status is not None:
            idle = bool(self.mapping_status.idle())
            qlen = int(self.mapping_status.queue_len())
        else:
            # mapper occupancy, estimated from the last insertion: its work
            # is taken to last mapper_busy_frames frames
            busy = p.frame_id < self.last_kf_frame_id + self.mapper_busy_frames
            idle, qlen = not busy, int(busy)
        inp = KFDecisionInputs(
            n_inliers=s[2], frame_id=p.frame_id,
            last_kf_frame_id=self.last_kf_frame_id, n_kfs_in_map=s[7],
            n_tracked_close=s[4], n_nontracked_close=s[5],
            mapping_idle=idle, mapping_queue_len=qlen, is_mono=self.is_mono,
            force=p.force_kf)
        # arena-full guard: the cursor only grows, and an insert past K
        # would clamp in the arena while the host mirror ran on
        if need_new_keyframe(inp, self.policy) and self._kf_mirror < self.caps.K:
            self._insert_keyframe_deferred(p, tel)
        return tel

    def _insert_keyframe_deferred(self, p: _Pending, tel):
        """Keyframe insertion, close-point seeding (stereo) and the mapper's jobs for
        a committed frame, whose features, pose and associations are still
        held by its pending record. The keyframe id is the host mirror of
        the allocation cursor, and the counters are not fetched: this adds
        no read of its own to the mapper's."""
        kf_id = self._kf_mirror
        with self.timer.span("kf_insert"):
            ms, _ = M.add_keyframe(self.ms, p.feats, p.Tcw, p.timestamp, p.frame_id,
                                   self.cam_id, p.lm_id)
            if not self.is_mono:
                ms, _ = seed_close_landmarks(ms, kf_id, self.cam)
        self._kf_mirror += 1
        self._attach_sensor(kf_id, p.sensor_data)
        ms, stats = self._integrate(
            ms, kf_id, sensors=self.sensors, opt_info=self.opt_info,
            fetch_stats=False, has_priors=self._has_priors)
        self.ms = ms
        self.last_kf_frame_id = p.frame_id
        tel.kf_inserted = kf_id
        tel.mapper_stats = stats
        if self.on_keyframe is not None:
            self.on_keyframe(kf_id)

    def _integrate(self, ms, kf_id: int, **kw):
        """The mapper's jobs on new keyframe kf_id (``kw`` for
        ``Mapper.integrate_keyframe``): run here, or under the threaded
        pipeline handed to its mapping thread with the sensor readings as
        they stand now, the keyframe's own included, for the map maintenance
        there. Returns (ms, stats)."""
        if self.mapping_status is None:
            return self.mapper.integrate_keyframe(ms, kf_id, **kw)
        return self.mapping_status.defer(ms, kf_id, self.sensors, **kw)

    def _lose_tracking(self):
        """Transition on loss: a stereo camera re-initializes in a registered
        sub-map, a monocular one relocalizes."""
        self.state = State.RELOCALIZE if self.is_mono else State.REINITIALIZE

    def reenter_initialize(self):
        """Re-enter INITIALIZE without discarding the map (an accessory
        camera recovering from NULL): the new initialization happens in a
        fresh private sub-map, so that the map before keeps its single origin
        and gauge. The sub-map stays unregistered, no pose relation to the
        parent being known yet, until imaging BA aligns and registers it
        (ROADMAP step 17); until then global BA holds its origin fixed.
        Under the threaded pipeline the mapping stage is drained and its map
        adopted first, so that the adoption cannot drop the new sub-map."""
        if self.mapping_status is not None:
            self.mapping_status.sync(self)
        self.state = State.INITIALIZE
        if self._mono_init is not None:
            self._mono_init.ref = None   # the frame from before the loss is stale
        n_kf, active, n_maps = torch.stack(
            [self.ms.next_kf, self.ms.maps.active, self.ms.maps.n_maps]).tolist()
        if n_kf == 0:
            return  # nothing in the map yet: a plain first init
        # an empty active sub-map left by an earlier failed re-entry is reused
        in_active = bool(torch.any(self.ms.kf.valid & (self.ms.kf.map_id == active)))
        if active != 0 and not in_active:
            return
        if n_maps >= M.MAX_MAPS:
            return  # the sub-map table is full: keep the current map
        self.ms, _ = M.create_submap(self.ms)

    def _do_reinitialize(self, feats, timestamp, frame_id, tel):
        """A new registered sub-map placed at the velocity-extrapolated pose
        and tied to the last reference keyframe."""
        self._do_initialize(feats, timestamp, frame_id, tel,
                            Tcw0=TJ.predict_pose(self.traj, timestamp),
                            as_submap=True, tie_kf=self.last_ref_kf)
        if self.state == State.POSTINIT:
            tel.state += ">REINIT_OK"

    def _do_relocalize(self, feats, timestamp, frame_id, tel):
        """PnP against the ranked keyframes, then NORMAL from the recovered
        pose (the trajectory gets no row for this frame, as in the JAX
        package); ``reloc_log`` keeps the frame's counts."""
        stats = {}
        ok, Tcw, lm_id, n = try_relocalize(
            self.cam, feats, self.ms, recognizer=self.recognizer,
            n_levels=self.n_levels, scale_factor=self.scale_factor,
            p=self.params.place_rec, stats=stats)
        self.reloc_log.append(dict(frame_id=frame_id, ok=ok, **stats))
        tel.n_inliers = n
        if not ok:
            return
        self.last_Tcw = Tcw
        self.last_Tcr = torch.eye(4, dtype=torch.float32, device=self.device)
        self.last_feats = feats
        self.last_lm_id = lm_id
        self.frames_since_reloc = 0
        self.state = State.NORMAL
        tel.state += ">RELOC_OK"
