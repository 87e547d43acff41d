"""System: the public API over the stereo / RGB-D / monocular pipeline and
the dual-camera rig (counterpart of ``hyslam_tpu/slam/system.py``).

Builds a camera, feature family (ORB or SURF), tracker and map for every
camera of a ``SystemConfig``, runs the image front end (grayscale and the
camera's ``scale``, extraction, stereo match or depth sampling; a monocular
camera initializing takes ``init_feature_factor`` times the features) and
hands each frame to its camera's tracker: synchronously
(``Tracker.track``, one telemetry row returned per frame) or through the
async tracking loop (``async_tracking=True``: ``Tracker.track_async``, rows
committed ``commit_lag`` frames later, ``flush()`` to settle). After every
keyframe comes the map maintenance: with ``optimizer.realtime=False`` a
global BA every ``gba_interval`` keyframes, in async mode too (between
frames, after the frames in flight are committed; the JAX package's async
mode never reaches it), and loop closing (``enable_loop_closing``, the
config's default): BoW place recognition over the keyframes, Sim3
verification, loop correction with the essential graph, then a global BA
of 10 iterations. The recognizer is built once the map holds 4 keyframes
(from ``vocab_path``, else the shipped ``Vocabulary/synthetic_orb.npz``,
else a vocabulary trained on the map's own descriptors) and also ranks
relocalization's candidates. In async mode the maintenance of every
committed keyframe runs between frames, in keyframe order, as the sync
path runs it: there is no worker thread and no keyframe is left without
detection; before a verified loop is applied the frames in flight are
committed and the loop is verified again on the map they leave. Loop
closing runs on the "SLAM" camera only; the count of keyframes towards the
periodic global BA is one for all cameras, as in the JAX package.

Two cameras, "SLAM" and an accessory (the reference's "Imaging" camera,
usually monocular, with its rig transform ``Tcam``): each has its own
tracker, map arena and ``cam_id``. After every frame the cameras' states are
coupled: while SLAM is lost (REINITIALIZE, RELOCALIZE) the others are held
in NULL, and when it recovers they re-initialize in a fresh sub-map. An
Imaging frame is judged by ``place_imaging_frame`` (posed from the SLAM
trajectory and the rig, kept where its landmark overlap with the last kept
frame is low); ``run_imaging_bundle_adjustment`` aligns and registers every
Imaging sub-map by the SLAM trajectory, runs the trajectory-tied BA and
sparsifies the Imaging map (``slam/imaging.py``, ``slam/sparsify.py``).
Also the data exporters (trajectory TSV / TUM, COLMAP, Agisoft XML, map
points), map and checkpoint files, and the TSV telemetry logs.

The threaded pipeline (``pipelined=True``, ``runtime/pipeline.py``, the
reference's thread topology; it takes precedence over ``async_tracking``):
the caller's thread extracts and feeds a bounded tracking queue and
``track_*`` returns None; a tracking thread runs every camera's state
machine; a mapping thread runs the mapper's jobs (at a lower budget while
keyframes wait), loop closing and the periodic global BA on a map snapshot,
which the tracker adopts at its next frame boundary. Rows are in
``_pipe.telemetry`` and the trackers'; ``flush()`` drains both stages.

The system lives on ``config.device``; with none given it takes the current
CUDA card and raises where there is none. All its threads launch on the
device's current stream. Every ``track_*`` entry takes
``sensor_data`` (a ``core.sensordata.SensorData``: GPS, IMU orientation,
pressure depth), which rides the frame to its keyframe and feeds local BA's
pose priors under the weights of ``config.optimizer``. With
``run_data_dir`` set the TSV logs are written (not in async mode) and an
annotated feature image every 20th frame (``viz/``, not in async mode).
"""

from __future__ import annotations

import contextlib
import os
from typing import Dict

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core import trajectory as TJ
from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.device import default_device
from hyslam_tpu_torch.features.factory import make_family
from hyslam_tpu_torch.io import export as EXP
from hyslam_tpu_torch.io.config import SystemConfig
from hyslam_tpu_torch.ops.pyramid import preprocess_image
from hyslam_tpu_torch.ops.stereo import match_stereo_refined
from hyslam_tpu_torch.features.bow import PlaceRecognizer, train_vocabulary
from hyslam_tpu_torch.features.vocab_io import load_dbow2_text, load_vocabulary
from hyslam_tpu_torch.slam.global_ba import run_global_ba
from hyslam_tpu_torch.slam.imaging import ImagingFramePlacer, run_imaging_ba
from hyslam_tpu_torch.slam.loop_closing import LoopCloser
from hyslam_tpu_torch.slam.sparsify import sparsify_map
from hyslam_tpu_torch.slam.tracker import State, Tracker
from hyslam_tpu_torch.utils.telemetry import MappingLog, StageTimer, TrackingLog
from hyslam_tpu_torch.viz.draw2d import write_png
from hyslam_tpu_torch.viz.frame_drawer import draw_frame


VOCAB_TRAIN_KFS = 4   # the loop closer is built once the map holds this many keyframes


def default_vocab_path():
    """The shipped vocabulary, ``Vocabulary/synthetic_orb.npz`` at the
    repository's root, or None where it is absent."""
    p = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "Vocabulary", "synthetic_orb.npz")
    return p if os.path.exists(p) else None


class System:
    """One SLAM system over a stereo, RGB-D or monocular camera, or over a
    SLAM camera and an Imaging camera, built from a ``SystemConfig``. Feed
    it frames with ``track_stereo`` /
    ``track_rgbd`` / ``track_monocular`` (or features with
    ``track_features``), call ``flush()`` before reading
    its trackers or stopping a clock, and ``shutdown()`` at the end. With
    ``config.run_data_dir`` set it writes the TSV telemetry logs and the
    annotated frame dumps (not in async mode). With ``config.pipelined``
    the frames go through the threaded pipeline, see the module
    docstring. ``timer`` is the System's tracer (``utils/telemetry.py``),
    shared with its trackers and their mappers: off unless ``trace=True`` or
    ``timer.enabled`` is set."""

    def __init__(self, config: SystemConfig | None = None, trace: bool = False):
        self.config = config or SystemConfig()
        self.device = (torch.device(self.config.device)
                       if self.config.device is not None else default_device())
        self.trackers: Dict[str, Tracker] = {}
        self.cameras = {}
        self.loop_closers: Dict[str, LoopCloser] = {}
        self._vocab = None
        self._frame_counter = 0
        self._kfs_since_gba = 0
        self._shutdown = False
        self._tracking_log = None
        self._mapping_log = None
        self.timer = StageTimer(enabled=trace)
        self._open_logs()
        self._families = {}   # per-camera feature family
        self._init_families = {}   # the monocular initializer's, per camera
        self._pending_kfs = {}     # async mode: keyframes awaiting maintenance
        self._frame_placer = None  # the Imaging camera's, built at first use
        for name, cc in self.config.cameras.items():
            self.cameras[name] = cc.camera()
            self._families[name] = make_family(cc.extractor)
            self.trackers[name] = self._make_tracker(name)
        self._pipe = self._make_pipe()

    def _make_pipe(self):
        """The threaded pipeline over the current trackers where the config
        asks for it, else None."""
        if not self.config.pipelined:
            return None
        from hyslam_tpu_torch.runtime.pipeline import SystemPipeline

        return SystemPipeline(self)

    def _make_tracker(self, name: str) -> Tracker:
        """The camera's tracker, as the config describes it (for __init__
        and reset alike). In async mode the keyframes its commits make are
        queued for the map maintenance between frames."""
        cc = self.config.cameras[name]
        tracker = Tracker(
            cam=self.cameras[name],
            cam_id=list(self.config.cameras).index(name),
            caps=self.config.caps,
            is_mono=cc.mono,
            policy=cc.policy,
            opt_info=self.config.optimizer,
            n_levels=cc.extractor.n_levels,
            scale_factor=cc.extractor.scale_factor,
            params=cc.tracking,
            commit_lag=self.config.commit_lag,
            mapper_params=self.config.mapper,
            device=self.device,
            timer=self.timer,
        )
        self._pending_kfs[name] = []
        if self.config.async_tracking:
            tracker.on_keyframe = self._pending_kfs[name].append
        return tracker

    def flush(self):
        """Pipelined mode: wait until both pipeline stages are empty and
        idle and every map snapshot is adopted (a thread's exception is
        raised here). Async mode: commit every frame in flight and run the
        map maintenance of the keyframes they made. Then wait until the
        device has finished all queued work (use before reading trackers or
        maps mid-run, and before stopping a clock). In synchronous mode only
        the wait."""
        if self._pipe is not None:
            self._pipe.drain_all()
        for name, t in self.trackers.items():
            t.drain_pending()
            self._maintain_pending(name)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ input

    def _host_turn(self):
        """Pipelined mode: the pipeline's turn for the caller's extraction
        (``runtime.pipeline.Turns``); else nothing to wait for."""
        return (self._pipe.turns.hold() if self._pipe is not None
                else contextlib.nullcontext())

    def _image(self, img, scale: float) -> torch.Tensor:
        """A numpy image (or a tensor, which is not copied when it already
        lives on the system's device) -> preprocessed grey image there."""
        if not isinstance(img, torch.Tensor):
            img = torch.from_numpy(np.ascontiguousarray(img))
        return preprocess_image(img.to(self.device), scale)

    def track_stereo(self, img_left, img_right, timestamp: float,
                     camera: str = "SLAM", frame_id: int | None = None,
                     sensor_data=None):
        """Full stereo entry: grayscale, extraction of both images as one
        batch of two, stereo match + sub-pixel refinement, then track.
        ``sensor_data`` attaches GPS / IMU / depth readings to a keyframe
        made from this frame."""
        cc = self.config.cameras[camera]
        cam = self.cameras[camera]
        with self._frame_span(frame_id):
            with self._host_turn(), self.timer.span("frontend"):
                il = self._image(img_left, cam.scale)
                ir = self._image(img_right, cam.scale)
                with self.timer.span("frontend.extract"):
                    feats2 = self._families[camera].extract_batch(
                        torch.stack([il, ir]), capacity=self._capacity(cc))
                fl = FrameFeatures(*(x[0] for x in feats2))
                fr = FrameFeatures(*(x[1] for x in feats2))
                with self.timer.span("frontend.stereo"):
                    fl = match_stereo_refined(fl, fr, il, ir, bf=cam.bf)
                self._maybe_dump_frame(camera, il, fl)
            return self._track_features(fl, timestamp, camera, frame_id, sensor_data)

    def track_rgbd(self, img, depth, timestamp: float, camera: str = "SLAM",
                   frame_id: int | None = None, sensor_data=None):
        """RGB-D entry: extract the image's features, sample the depth image
        at each keypoint (nearest neighbour) and fill ur = u - bf/z and
        depth, so that the whole stereo pipeline (close-point seeding, stereo
        BA residuals, culling thresholds) applies unchanged.

        ``depth`` is a registered metric depth image [H, W] (metres; <= 0 or
        non-finite = no reading) at the image's native resolution."""
        cc = self.config.cameras[camera]
        cam = self.cameras[camera]
        with self._frame_span(frame_id):
            with self._host_turn(), self.timer.span("frontend"):
                gray = self._image(img, cam.scale)
                with self.timer.span("frontend.extract"):
                    feats = self._families[camera].extract(gray, capacity=self._capacity(cc))
                if not isinstance(depth, torch.Tensor):
                    depth = torch.from_numpy(np.ascontiguousarray(depth))
                dep = depth.to(device=self.device, dtype=torch.float32)
                H0, W0 = dep.shape
                uv0 = feats.uv / cam.scale            # native-resolution coordinates
                ui = torch.round(uv0[:, 0]).to(torch.int64).clamp(0, W0 - 1)
                vi = torch.round(uv0[:, 1]).to(torch.int64).clamp(0, H0 - 1)
                z = dep[vi, ui]
                ok = feats.valid & torch.isfinite(z) & (z > 0.05)
                # a true division: a Python number over a tensor would multiply
                # by the tensor's reciprocal, one rounding more
                disparity = torch.full_like(z, cam.bf) / torch.clamp_min(z, 1e-6)
                feats = feats._replace(
                    ur=torch.where(ok, feats.uv[:, 0] - disparity, -1.0),
                    depth=torch.where(ok, z, -1.0))
                self._maybe_dump_frame(camera, gray, feats)
            return self._track_features(feats, timestamp, camera, frame_id, sensor_data)

    def track_monocular(self, img, timestamp: float, camera: str = "SLAM",
                        frame_id: int | None = None, sensor_data=None):
        """Monocular entry: grayscale, extraction, then track. While the
        tracker initializes, the extractor takes ``init_feature_factor``
        times the features (capped at the arena's F)."""
        cc = self.config.cameras[camera]
        with self._frame_span(frame_id):
            with self._host_turn(), self.timer.span("frontend"):
                gray = self._image(img, self.cameras[camera].scale)
                fam = self._families[camera]
                if (self.trackers[camera].state == State.INITIALIZE
                        and cc.init_feature_factor > 1):
                    fam = self._init_family(camera)
                with self.timer.span("frontend.extract"):
                    feats = fam.extract(gray, capacity=self._capacity(cc))
                self._maybe_dump_frame(camera, gray, feats)
            return self._track_features(feats, timestamp, camera, frame_id, sensor_data)

    def track_features(self, feats: FrameFeatures, timestamp: float,
                       camera: str = "SLAM", frame_id: int | None = None,
                       sensor_data=None):
        """Feature-level entry (features on the system's device). Returns
        the frame's TrackerTelemetry; in async mode None while the frame is
        in flight (its row appears in the tracker's telemetry at commit); in
        pipelined mode None: the frame is queued to the tracking thread
        (blocking while the queue holds 2) and its row appears in
        ``_pipe.telemetry`` once tracked."""
        with self._frame_span(frame_id):
            return self._track_features(feats, timestamp, camera, frame_id, sensor_data)

    def _frame_span(self, frame_id: int | None):
        """The tracer's root span of one ``track_*`` call: the frame's id is
        the one given, else the System's counter (as ``track_features``
        assigns it)."""
        return self.timer.span("frame", self._frame_counter if frame_id is None else frame_id)

    def _track_features(self, feats, timestamp, camera, frame_id, sensor_data):
        if self._shutdown:
            raise RuntimeError("System is shut down")
        if frame_id is None:
            frame_id = self._frame_counter
        self._frame_counter += 1
        if self._pipe is not None:
            self._pipe.feed(camera, feats, timestamp, frame_id, sensor_data)
            return None
        if self.config.async_tracking:
            tel = self.trackers[camera].track_async(feats, timestamp, frame_id,
                                                    sensor_data=sensor_data)
            if tel is not None and tel.kf_inserted >= 0:   # a cold state's keyframe
                self._pending_kfs[camera].append(tel.kf_inserted)
            self._maintain_pending(camera)
            self._transition_states()
            return tel
        return self._track_features_inline(feats, timestamp, camera, frame_id,
                                           sensor_data)

    def _track_features_inline(self, feats, timestamp, camera, frame_id,
                               sensor_data=None, defer_maintenance=False):
        """One frame through the state machine, its telemetry rows and the
        cameras' state coupling. With ``defer_maintenance`` (the pipeline's
        tracking thread) the map maintenance of a keyframe is left to the
        mapping thread."""
        tracker = self.trackers[camera]
        tel = tracker.track(feats, timestamp, frame_id, sensor_data=sensor_data)
        if self._tracking_log is not None:
            # the live landmark count, not the allocation cursor: with slot
            # recycling next_lm can pass both the live size and the capacity
            n_kfs, n_lm = torch.stack([
                tracker.ms.next_kf, M.n_live_landmarks(tracker.ms).to(torch.int32)
            ]).tolist()
            self._tracking_log.log(camera, tel, timestamp, n_kfs=n_kfs,
                                   n_landmarks=n_lm)
        if tel.kf_inserted >= 0:
            if self._mapping_log is not None and tel.mapper_stats:
                self._mapping_log.log(camera, tel.kf_inserted, tel.mapper_stats)
            if not defer_maintenance:
                self._on_new_keyframe(camera, tel.kf_inserted)
        self._transition_states()
        return tel

    def _transition_states(self):
        """Cross-camera state coupling: while the SLAM camera is lost
        (REINITIALIZE, RELOCALIZE) every other camera is held in NULL (its
        poses ride the SLAM trajectory and cannot be placed); when SLAM
        recovers they re-enter INITIALIZE in a fresh sub-map, which imaging
        BA aligns and registers later. In async mode a camera sent to NULL
        first commits its frames in flight and leaves async mode, so that
        its tracking after the re-initialization starts from the new map's
        state (the JAX package keeps the async state from before the loss)."""
        slam = self.trackers.get("SLAM")
        if slam is None or len(self.trackers) < 2:
            return
        lost = slam.state in (State.REINITIALIZE, State.RELOCALIZE)
        for name, t in self.trackers.items():
            if name == "SLAM":
                continue
            if lost and t.state != State.NULL:
                t.drain_pending()
                self._maintain_pending(name)
                t._sync_dev_to_host()
                t.state = State.NULL
            elif not lost and t.state == State.NULL:
                t.reenter_initialize()

    def _maintain_pending(self, camera: str):
        """Async mode: the map maintenance of the keyframes committed since
        the last call, in the order they were made."""
        pending = self._pending_kfs[camera]
        while pending:
            self._on_new_keyframe(camera, pending.pop(0))

    def _on_new_keyframe(self, camera: str, kf_id: int):
        tracker = self.trackers[camera]
        tracker.ms, moved = self._maintain_map(camera, tracker.ms, kf_id)
        if moved:
            self._refresh_trajectory(camera)

    def _commit_in_flight(self, camera: str, ms, live: bool):
        """The map to change: where ``live`` and the camera's tracker has
        async frames in flight, they are committed first and the map they
        leave is returned (the map then holds every keyframe made so far,
        and no frame is left in flight with a pose of the map before it);
        else ms. Returns (the map, whether frames were committed)."""
        tracker = self.trackers[camera]
        if not (live and tracker._pending):
            return ms, False
        tracker.drain_pending()
        return tracker.ms, True

    def _maintain_map(self, camera: str, ms, kf_id: int, live: bool = True,
                      sensors=None):
        """The map maintenance after keyframe kf_id on the map ms: loop
        closing (with a global BA of 10 iterations after a closure), and in
        the offline mode (``optimizer.realtime=False``) a global BA every
        ``gba_interval`` keyframes. ``live``: ms is the tracker's own map,
        and async frames in flight are committed before it is changed; the
        pipeline's mapping thread passes a snapshot with ``live=False`` and
        the tracker is not touched, but for the recognizer that a newly built
        loop closer hands it, and global BA takes ``sensors``, the arena the
        keyframe's job carries (None: the tracker's). Returns (ms, whether
        the map moved)."""
        moved = False
        if self.config.enable_loop_closing and camera == "SLAM":
            closer = self._get_loop_closer(camera, ms)
            if closer is not None:
                ms, moved = self._close_loop(camera, closer, ms, kf_id, live, sensors)
        self._kfs_since_gba += 1
        opt = self.config.optimizer
        if opt.realtime or self._kfs_since_gba < opt.gba_interval:
            return ms, moved
        ms = self._global_ba(camera, self._commit_in_flight(camera, ms, live)[0], sensors)
        self._kfs_since_gba = 0
        return ms, True

    def _global_ba(self, camera: str, ms, sensors=None, **kw):
        ex = self.config.cameras[camera].extractor
        if sensors is None:
            sensors = self.trackers[camera].sensors
        ms, _ = run_global_ba(
            ms, self.cameras[camera], sensors=sensors,
            opt_info=self.config.optimizer, n_levels=ex.n_levels,
            scale_factor=ex.scale_factor, **kw)
        return ms

    def _close_loop(self, camera: str, closer: LoopCloser, ms, kf_id: int,
                    live: bool, sensors=None):
        """Detection and verification of keyframe kf_id on ms; on a loop, the
        correction and the global BA. In async mode frames in flight are
        committed first and the loop verified again on the map they leave
        (the same RANSAC draws), so that no loop is applied to a map other
        than the one it was verified on. Returns (ms, whether a loop
        closed)."""
        found, cand, g_cl, _ = closer.detect_and_verify(ms, kf_id)
        if not found:
            return ms, False
        ms, committed = self._commit_in_flight(camera, ms, live)
        if committed:
            found, g_cl, _ = closer.compute_sim3(ms, kf_id, cand)
            if not found:
                return ms, False
        corrected, applied = closer.correct(ms, kf_id, cand, g_cl)
        if not applied:
            return ms, False
        closer.n_closed += 1
        return self._global_ba(camera, corrected, sensors, n_iters=10), True

    def _get_loop_closer(self, camera: str, ms):
        """The camera's loop closer, built once the map ms holds
        VOCAB_TRAIN_KFS keyframes (None before), its recognizer back-filled
        with every keyframe so far and handed to the tracker for
        relocalization."""
        if camera in self.loop_closers:
            return self.loop_closers[camera]
        tracker = self.trackers[camera]
        n_kf = int(ms.next_kf)
        if n_kf < VOCAB_TRAIN_KFS:
            return None
        vp = self.config.vocab_path or default_vocab_path()
        if self._vocab is None and vp:
            self._vocab = (load_vocabulary(vp, self.device) if vp.endswith(".npz")
                           else load_dbow2_text(vp, self.device))
        if self._vocab is None:
            # last resort: a vocabulary of the map's own descriptors
            descs = ms.kf.desc[:n_kf].reshape(-1, 8).cpu().numpy()
            valid = ms.kf.kp_valid[:n_kf].reshape(-1).cpu().numpy()
            self._vocab = train_vocabulary(descs[valid][:20000], k=10, depth=3,
                                           device=self.device)
        pr = PlaceRecognizer(self._vocab, K=self.config.caps.K)
        for k in range(n_kf):
            pr.add_keyframe(k, ms.kf.desc[k], ms.kf.kp_valid[k])
        closer = LoopCloser(cam=self.cameras[camera], recognizer=pr,
                            fix_scale=not self.config.cameras[camera].mono)
        self.loop_closers[camera] = closer
        tracker.recognizer = pr
        return closer

    def _drop_loop_closer(self, camera: str):
        """Forget the camera's loop closer and recognizer (after the map is
        replaced): the next keyframe builds them anew from the new map."""
        self.loop_closers.pop(camera, None)
        self.trackers[camera].recognizer = None

    def _refresh_trajectory(self, camera: str):
        """Re-derive every trajectory pose from its (re-optimized) reference
        keyframe."""
        t = self.trackers[camera]
        t.traj = TJ.refresh(t.traj, t.ms.kf.Tcw, t.ms.kf.bad,
                            t.ms.kf.span_parent, t.ms.kf.Tcp)

    # ------------------------------------------------------------- dual-camera

    def _placer(self, imaging_camera: str) -> ImagingFramePlacer:
        if self._frame_placer is None:
            self._frame_placer = ImagingFramePlacer(self.cameras[imaging_camera])
        return self._frame_placer

    def place_imaging_frame(self, timestamp: float, imaging_camera: str = "Imaging"):
        """System::placeImagingFrame: whether an Imaging frame at this time is
        worth keeping. It is posed by the SLAM trajectory and the Imaging
        camera's rig transform ``Tcam``, and kept when its landmark overlap
        with the last kept frame is below the threshold and enough
        landmarks of the SLAM map are visible. Returns (keep, Tcw); before
        any SLAM tracking there is nothing to place (False)."""
        slam = self.trackers["SLAM"]
        return self._placer(imaging_camera).should_keep(
            slam.ms, slam.traj, timestamp, self.config.cameras[imaging_camera].Tcam)

    def set_imaging_frame_placer_params(self, overlap_threshold: float,
                                        min_visible: int,
                                        imaging_camera: str = "Imaging"):
        """System::setImagingFramePlacerParams."""
        placer = self._placer(imaging_camera)
        placer.overlap_threshold = overlap_threshold
        placer.min_visible = min_visible

    def run_imaging_bundle_adjustment(self, imaging_camera: str = "Imaging",
                                      sparsify_overlap: float | None = 0.98):
        """System::RunImagingBundleAdjustment: re-derive the SLAM trajectory
        from its optimized keyframes, align and register every Imaging
        sub-map by it, run the trajectory-tied BA (``slam/imaging.py``),
        then sparsify the Imaging map at ``sparsify_overlap`` (None: keep
        every keyframe). Frames in flight are committed first. Returns the
        number of keyframes sparsification culled."""
        self.flush()
        self._refresh_trajectory("SLAM")
        slam = self.trackers["SLAM"]
        imaging = self.trackers[imaging_camera]
        imaging._sync_dev_to_host()
        imaging.ms = run_imaging_ba(imaging.ms, self.cameras[imaging_camera], slam.traj,
                                    self.config.cameras[imaging_camera].Tcam)
        if sparsify_overlap is None:
            return 0
        imaging.ms, n = sparsify_map(imaging.ms, self.cameras[imaging_camera],
                                     sparsify_overlap)
        return n

    # ----------------------------------------------------------------- export

    def save_trajectory(self, path: str, camera: str = "SLAM"):
        self._refresh_trajectory(camera)
        EXP.save_trajectory_tsv(path, self.trackers[camera].traj, name=camera)

    def save_trajectory_tum(self, path: str, camera: str = "SLAM"):
        self._refresh_trajectory(camera)
        EXP.save_trajectory_tum(path, self.trackers[camera].traj)

    def export_colmap(self, folder: str):
        for name, t in self.trackers.items():
            EXP.export_colmap(folder, t.ms, self.cameras[name], name)

    def save_keyframes_agisoft(self, path: str, camera: str = "SLAM"):
        EXP.save_keyframes_agisoft(path, self.trackers[camera].ms,
                                   self.cameras[camera], camera)

    def save_map(self, path: str, camera: str = "SLAM"):
        EXP.save_map_state(path, self.trackers[camera].ms)

    def load_map(self, path: str, camera: str = "SLAM"):
        """Replace the camera's map by a file's (of either package). In
        async mode the frames in flight are committed first and the tracker
        leaves its tensor state, so that the next frame re-reads the new
        map's keyframe cursor. The loop closer and its recognizer are
        dropped (the file holds no BoW rows): the next keyframe rebuilds
        them from the loaded map."""
        t = self.trackers[camera]
        t.drain_pending()
        t._sync_dev_to_host()
        t.ms = EXP.load_map_state(path, self.device)
        self._drop_loop_closer(camera)

    def save_checkpoint(self, path: str, camera: str = "SLAM"):
        """Full resume checkpoint: map, trajectory, sensors, tracker state
        and the System's counters. In async mode the frames in flight are
        committed first and the tracker's state is read back, so that the
        file holds the state after the last frame fed."""
        t = self.trackers[camera]
        t.drain_pending()
        t._sync_dev_to_host()
        EXP.save_checkpoint(
            path, t, system_scalars=(self._frame_counter, self._kfs_since_gba))

    def load_checkpoint(self, path: str, camera: str = "SLAM"):
        t = self.trackers[camera]
        t.drain_pending()
        t._sync_dev_to_host()
        sys_scalars = EXP.load_checkpoint(path, t)
        self._drop_loop_closer(camera)
        if sys_scalars is not None:
            self._frame_counter, self._kfs_since_gba = (
                int(x) for x in sys_scalars)

    def save_map_points(self, path: str, camera: str = "SLAM"):
        EXP.save_map_points_tsv(path, self.trackers[camera].ms)

    # --------------------------------------------------------------- shutdown

    def _open_logs(self):
        if not self.config.run_data_dir:
            return
        d = self.config.run_data_dir
        self._tracking_log = TrackingLog(os.path.join(d, "tracking_data.txt"))
        self._mapping_log = MappingLog(os.path.join(d, "localmapping_data.txt"))

    def _close_logs(self):
        if self._tracking_log is not None:
            self._tracking_log.close()
            self._tracking_log = None
        if self._mapping_log is not None:
            self._mapping_log.close()
            self._mapping_log = None

    def shutdown(self):
        """Drain and join the pipeline's threads (pipelined mode; a thread's
        exception is raised here), close the telemetry logs and refuse
        further input."""
        self._shutdown = True
        try:
            self._join_pipe()
        finally:
            self._close_logs()

    def reset(self):
        """Fresh trackers, no loop closers, reopened telemetry logs and, in
        pipelined mode, a new pipeline (usable again after ``shutdown()``)."""
        self._shutdown = True   # stays so where the old pipeline's join raises
        self._join_pipe()
        for name in self.config.cameras:
            self.trackers[name] = self._make_tracker(name)
        self.loop_closers.clear()
        self._close_logs()
        self._open_logs()
        self._pipe = self._make_pipe()
        self._shutdown = False

    def _join_pipe(self):
        """Join the pipeline's threads (what they hold is finished first)
        and drop it; a thread's exception is raised."""
        pipe, self._pipe = self._pipe, None
        if pipe is not None:
            pipe.join()

    # ------------------------------------------------------------------ misc

    def _capacity(self, cc) -> int:
        cap = self.config.caps.F
        if cc.extractor.n_features > cap:
            raise ValueError("feature budget exceeds arena capacity F")
        return cap

    def _init_family(self, camera: str):
        """The feature family of a monocular camera's initialization:
        ``init_feature_factor`` times the features, capped at the arena's F
        so that frame shapes stay the same."""
        if camera not in self._init_families:
            cc = self.config.cameras[camera]
            n = min(cc.extractor.n_features * cc.init_feature_factor, self.config.caps.F)
            self._init_families[camera] = make_family(cc.extractor._replace(n_features=n))
        return self._init_families[camera]

    def _maybe_dump_frame(self, camera: str, gray, feats, every: int = 20):
        """With ``run_data_dir`` set, an annotated feature image every
        ``every``-th frame of the System's counter (the reference's debug
        dump, ImageProcessing.cpp:87-98): the image, the frame's keypoints,
        and the tracker's state and map counts before the frame. Not in
        async mode, where the reads it needs would stall the loop."""
        if not self.config.run_data_dir or self.config.async_tracking:
            return
        if self._frame_counter % every != 0:
            return
        t = self.trackers[camera]
        n_kfs, n_lm = torch.stack([
            t.ms.next_kf, M.n_live_landmarks(t.ms).to(torch.int32)]).tolist()
        img = draw_frame(gray.cpu().numpy(), feats.uv.cpu().numpy(),
                         feats.valid.cpu().numpy(), state=t.state.name,
                         n_kfs=n_kfs, n_landmarks=n_lm)
        write_png(os.path.join(self.config.run_data_dir,
                               f"features_{camera}_{self._frame_counter:06d}.png"), img)
