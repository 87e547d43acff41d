"""Threaded pipeline: the reference's thread topology over native queues
(counterpart of ``hyslam_tpu/runtime/pipeline.py``).

The caller's thread runs ImageProcessing (extraction on the card) and pushes
feature payloads into a bounded tracking queue (backpressure at depth 2,
System.cc:194). A tracking thread pops them and runs the state machine;
a new keyframe's jobs go to a mapping thread over a second queue
(``Tracker.mapping_status.defer``). Loop closing and the periodic global BA
run on the mapping thread after the per-keyframe jobs: one maintenance
thread keeps them off the tracking thread, as the reference's LoopClosing
thread does.

Every ``MapState`` update builds new tensors, so the mapper works on a
SNAPSHOT: the tracking thread refreshes covisibility, spanning parents and
landmark statistics inline (the mandatory part, so tracking sees them) and
queues the map it has; the tracker adopts the mapper's output at its next
frame boundary. Before an initialization or a keyframe insertion the tracker
drains the mapping stage (``Tracker.mapping_status.sync``), so insertions
form one chain and no keyframe is inserted on a map the adoption would
replace: the functional-state form of the reference's accepting-input /
queue-length protocol (InterThread.h:37-89). So at most one keyframe job
is ever queued, and the reference's shedding of waiting keyframes
(Mapping.cpp:285-304) has nothing to shed. Snapshots are shared, not
copied: nothing reached from ``Tracker.track`` or the mapper's jobs writes
into a tensor of the state it was given.

The three threads take turns (``Turns``): one runs its Python at a time,
a frame, a frame's extraction or a keyframe job long, in the order they
asked. Their operators then cost what they cost on one thread, and after a
keyframe the mapper's job runs before the tracker's next frame, so that
frame finds the mapper idle. The device runs one turn's kernels while the
next turn launches its own.

Both worker threads launch on the CUDA stream that was current in the
thread that built the pipeline (each enters that device and stream), as the
JAX package's threads share one device queue: a snapshot's producing
kernels are queued before it is pushed, so the mapper reads it complete.

An exception on either thread is kept, both queues are closed (no push or
pop stays blocked) and it is raised by the caller's next ``feed``,
``drain_all`` (``System.flush``) or ``join`` (``System.shutdown``); every
wait has a timeout, ``TIMEOUT_S`` by default.

``SystemPipeline`` is what ``System(config.pipelined=True)`` runs;
``PipelinedTracker`` runs a single ``Tracker`` the same way.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass

import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.runtime.native import NativeQueue, ThreadStatus

TIMEOUT_S = 600.0   # the longest wait of a drain or a join, s
TRACKING_DEPTH = 2  # frames fed and not yet tracked: the caller's backpressure
# The reference's bound on keyframes waiting for the mapper. The tracker
# drains the mapping stage before every insertion, so at most one job is
# ever queued and the mapper always runs at budget 2: the lower budget
# levels of Mapping.cpp:285-304 are kept in Mapper.integrate_keyframe for
# parity, and no path of the pipeline reaches them.
MAPPING_DEPTH = 3


class Turns:
    """The pipeline's threads run their Python one at a time, in the order
    they asked: the caller's extraction of a frame (``System``'s image
    entries), the tracking thread's frame, the mapping thread's job. Every
    PyTorch operator releases the GIL and takes it back; threads that each
    do so at every operator hand it over at every operator, which on the
    card's host made an operator 4x dearer with two such threads and 17x
    with three (``tools/thread_contention.py``, PERF.md) than taking turns.
    The device still runs one turn's kernels while the next turn launches.
    A thread that waits inside its turn for another stage (a drain) gives
    the turn up while it waits. After ``close()`` nobody waits."""

    def __init__(self):
        self._cv = threading.Condition()
        self._issued = 0            # tickets handed out
        self._served = 0            # the ticket whose turn it is
        self._abandoned = set()     # tickets whose waiter left
        self._closed = False
        self._local = threading.local()

    def _pass_on(self):
        self._served += 1
        while self._served in self._abandoned:
            self._abandoned.discard(self._served)
            self._served += 1
        self._cv.notify_all()

    def _acquire(self):
        with self._cv:
            ticket = self._issued
            self._issued += 1
            try:
                while ticket != self._served and not self._closed:
                    self._cv.wait()
            except BaseException:
                if ticket == self._served:
                    self._pass_on()
                else:
                    self._abandoned.add(ticket)
                raise
        self._local.held = True

    def _release(self):
        self._local.held = False
        with self._cv:
            self._pass_on()

    @contextlib.contextmanager
    def hold(self):
        """The calling thread's turn, for the body of the ``with``."""
        self._acquire()
        try:
            yield
        finally:
            self._release()

    @contextlib.contextmanager
    def given_up(self):
        """Inside a turn, wait outside it: the turn is released for the
        body of the ``with`` and asked for again after it."""
        held = getattr(self._local, "held", False)
        if held:
            self._release()
        try:
            yield
        finally:
            if held:
                self._acquire()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()


@dataclass
class FramePayload:
    feats: object
    timestamp: float
    frame_id: int
    camera: str | None = "SLAM"
    sensor_data: object = None


@dataclass
class _Job:
    """A keyframe's work for the mapping thread: the map snapshot with the
    keyframe inserted and refreshed, the mapper's arguments, and the
    tracker's sensor arena with the keyframe's own reading (for the global
    BA of the maintenance)."""
    camera: str | None
    ms: object
    kf_id: int
    kw: dict
    sensors: object


def _mandatory_refresh(ms):
    """The part of a keyframe's integration the tracker needs at once
    (ProcessNewKeyFrame): covisibility, spanning parents, landmark stats."""
    ms = M.refresh_covisibility(ms)
    ms = M.compute_spanning_parents(ms)
    return M.update_landmark_stats(ms)


class _MappingStatus:
    """A tracker's view of the mapping stage (``Tracker.mapping_status``):
    ``idle()`` and ``queue_len()`` feed its keyframe policy (each decision's
    idle read is logged in ``idle_reads``), ``sync()`` drains the stage and
    adopts its map, ``defer()`` hands a new keyframe's jobs to the mapping
    thread."""

    def __init__(self, pipe, camera: str | None):
        self._pipe = pipe
        self._camera = camera

    def idle(self) -> bool:
        idle = self._pipe.idle()
        self._pipe.idle_reads.append((self._camera, self._pipe._frame_id, idle))
        return idle

    def queue_len(self) -> int:
        return self._pipe.queue_len()

    def sync(self, tracker) -> None:
        self._pipe.drain_mapping(self._camera)

    def defer(self, ms, kf_id: int, maintenance_sensors, **kw):
        """The tracking thread's part of keyframe kf_id's integration: the
        mandatory refresh inline, the rest queued with ``kw`` for
        ``Mapper.integrate_keyframe`` and the sensor arena for the map
        maintenance after it. Returns (ms, stats)."""
        ms = _mandatory_refresh(ms)
        self._pipe._push_job(_Job(self._camera, ms, kf_id, kw, maintenance_sensors))
        return ms, {"deferred": True}


class _Stages:
    """The two threads, their queues, flag block and turns (``turns``),
    and what both pipelines share: the count of keyframe jobs queued or running, the
    adoption of the mapper's output at a frame boundary, the first
    exception of either thread, and the readings of the threads' time.
    A subclass says how a frame is tracked (``_track``), how a job is run
    (``_run_job``, returning the map and whether it moved) and what follows
    a moved map (``_moved``).

    Readings (perf_counter seconds): ``drain_waits`` one a ``drain_mapping``
    call, the time it waited; ``mapping_spans`` (start, end, the thread's
    CPU seconds) of each mapping job; ``frame_spans`` (start, end, the
    thread's CPU seconds) of each frame the tracking thread tracked; ``idle_reads`` (camera, frame id, idle) of each
    keyframe decision; ``adoptions`` (camera, frame id, where) of each map
    the tracker took from the mapper: "before" the frame, or "in" it (a
    drain before a keyframe insertion). Together they are the run's
    schedule, which a synchronous tracker can replay."""

    def __init__(self, device, trackers: dict):
        self.tracking_queue = NativeQueue(TRACKING_DEPTH)
        self.mapping_queue = NativeQueue(MAPPING_DEPTH)
        self.status = ThreadStatus()
        self._lock = threading.Lock()
        self._idle_cv = threading.Condition(self._lock)
        self._jobs = 0              # keyframe jobs queued or running
        self._pending_frames = 0    # fed and not yet tracked
        self._error = None
        self._device = torch.device(device)
        self._stream = (torch.cuda.current_stream(self._device)
                        if self._device.type == "cuda" else None)
        self._trackers = trackers
        self.turns = Turns()
        self._adopt = {}            # camera -> (ms, map moved)
        self._frame_id = -1         # the frame the tracking thread is on
        self.telemetry = []
        self.drain_waits: list[float] = []
        self.mapping_spans: list[tuple[float, float, float]] = []
        self.frame_spans: list[tuple[float, float, float]] = []
        self.idle_reads: list[tuple[str | None, int, bool]] = []
        self.adoptions: list[tuple[str | None, int, str]] = []
        for name, tracker in trackers.items():
            tracker.mapping_status = _MappingStatus(self, name)
        self._threads = []
        for name, fn in (("tracking", self._tracking_loop), ("mapping", self._mapping_loop)):
            th = threading.Thread(target=self._guarded, args=(fn,), daemon=True,
                                  name=f"hyslam-{name}")
            th.start()
            self._threads.append(th)

    def _guarded(self, fn):
        """A thread's body: on the pipeline's device and stream; an
        exception is kept for the caller and stops the pipeline."""
        try:
            with contextlib.ExitStack() as stack:
                if self._stream is not None:
                    stack.enter_context(torch.cuda.device(self._device))
                    stack.enter_context(torch.cuda.stream(self._stream))
                fn()
        except BaseException as e:
            self._fail(e)

    def _fail(self, e: BaseException):
        with self._idle_cv:
            if self._error is None:
                self._error = e
            self._jobs = 0
            self._pending_frames = 0
            self._idle_cv.notify_all()
        self.tracking_queue.close()
        self.mapping_queue.close()
        self.turns.close()

    def _check(self):
        if self._error is not None:
            raise RuntimeError(f"pipeline thread died: {self._error!r}") from self._error

    # -- caller side ----------------------------------------------------------

    def _feed(self, payload: FramePayload):
        """Queue one frame, blocking while the tracking queue is full (the
        caller-side spin while tracking_queue.size() > depth,
        System.cc:194)."""
        self._check()
        with self._idle_cv:
            self._pending_frames += 1
        if not self.tracking_queue.push(payload):
            # undo the count, so that drain_all does not wait for a frame
            # that never entered the pipeline
            with self._idle_cv:
                self._pending_frames = max(0, self._pending_frames - 1)
                self._idle_cv.notify_all()
            self._check()
            raise RuntimeError("tracking queue is closed; frame rejected")

    def drain_all(self, timeout: float | None = None):
        """Block until both stages are empty and idle, then adopt every
        waiting map (System.flush)."""
        self._wait_idle(frames=True, timeout=timeout)
        for name in self._trackers:
            self._adopt_for(name, self._frame_id + 1, "before")

    def join(self, timeout: float | None = None):
        """Finish what both stages hold, stop the threads and detach from
        the trackers (System::Shutdown). Returns the telemetry rows."""
        deadline = time.monotonic() + (TIMEOUT_S if timeout is None else timeout)
        t_thread, m_thread = self._threads
        self.tracking_queue.close()
        t_thread.join(timeout=max(0.0, deadline - time.monotonic()))
        self.mapping_queue.close()
        m_thread.join(timeout=max(0.0, deadline - time.monotonic()))
        if t_thread.is_alive() or m_thread.is_alive():
            raise TimeoutError("pipeline threads did not stop")
        for name, tracker in self._trackers.items():
            self._adopt_for(name, self._frame_id + 1, "before")
            tracker.mapping_status = None
        self._check()
        return self.telemetry

    # -- the mapping stage, as the tracker sees it ------------------------------

    def idle(self) -> bool:
        return self._jobs == 0

    def queue_len(self) -> int:
        return self._jobs

    def drain_mapping(self, camera, timeout: float | None = None):
        """Block until the mapping stage is empty and idle, then adopt its
        map for ``camera`` (the tracker's sync before it allocates
        keyframes)."""
        t0 = time.perf_counter()
        with self.turns.given_up():
            self._wait_idle(frames=False, timeout=timeout)
        self.drain_waits.append(time.perf_counter() - t0)
        self._adopt_for(camera, self._frame_id, "in")

    def _push_job(self, job: _Job):
        """Tracking thread: queue a keyframe job (blocks while the mapping
        queue is full)."""
        with self._idle_cv:
            self._jobs += 1
            self.status.set("accepting_input", 0)
            self.status.set("queue_length", self._jobs)
        if not self.mapping_queue.push(job):
            self._check()
            raise RuntimeError("mapping queue is closed; keyframe job rejected")

    def _wait_idle(self, frames: bool, timeout: float | None):
        """Block until the mapping stage (and, with ``frames``, the tracking
        stage) is empty and idle; raise a thread's exception or
        TimeoutError."""
        deadline = time.monotonic() + (TIMEOUT_S if timeout is None else timeout)
        with self._idle_cv:
            while self._jobs > 0 or (frames and self._pending_frames > 0):
                self._check()
                if not self._idle_cv.wait(timeout=max(0.0, deadline - time.monotonic())):
                    raise TimeoutError("pipeline did not drain")
        self._check()

    def _adopt_for(self, camera, frame_id: int, where: str):
        """Hand the mapper's map for ``camera``, if one waits, to its
        tracker: at a frame boundary of the tracking thread or once the
        stages are drained ("before" frame_id), or in a drain before a
        keyframe insertion ("in" it)."""
        with self._lock:
            out = self._adopt.pop(camera, None)
        if out is None:
            return
        self.adoptions.append((camera, frame_id, where))
        ms, moved = out
        self._trackers[camera].ms = ms
        if moved:
            self._moved(camera)

    # -- the threads -------------------------------------------------------------

    def _tracking_loop(self):
        try:
            while True:
                payload = self.tracking_queue.pop()
                if payload is None:
                    break
                with self.turns.hold():
                    self._frame_id = payload.frame_id
                    self._adopt_for(payload.camera, payload.frame_id, "before")
                    t0, c0 = time.perf_counter(), time.thread_time()
                    tel = self._track(payload)
                    self.frame_spans.append((t0, time.perf_counter(), time.thread_time() - c0))
                    self.telemetry.append(tel)
                with self._idle_cv:
                    self._pending_frames -= 1
                    self._idle_cv.notify_all()
        finally:
            self.status.set("finished", 1)

    def _mapping_loop(self):
        while True:
            job = self.mapping_queue.pop()
            if job is None:
                break
            with self.turns.hold():
                t0, c0 = time.perf_counter(), time.thread_time()
                out = self._run_job(job)
                self.mapping_spans.append((t0, time.perf_counter(), time.thread_time() - c0))
            with self._idle_cv:
                self._adopt[job.camera] = out
                self._jobs -= 1
                self.status.set("queue_length", self._jobs)
                self.status.set("accepting_input", int(self._jobs == 0))
                self._idle_cv.notify_all()

    def _moved(self, camera):
        pass


class SystemPipeline(_Stages):
    """The reference's thread topology at the System level: ONE tracking
    thread runs every camera's state machine (Tracking::Run), ONE mapping
    thread runs the per-keyframe jobs, loop closing and the periodic global
    BA on map snapshots. The caller's thread extracts and feeds the bounded
    tracking queue (System.cc:125-159)."""

    def __init__(self, system):
        self.sys = system
        super().__init__(system.device, system.trackers)

    def feed(self, camera, feats, timestamp, frame_id, sensor_data=None):
        self._feed(FramePayload(feats, timestamp, frame_id, camera, sensor_data))

    def _track(self, p: FramePayload):
        return self.sys._track_features_inline(
            p.feats, p.timestamp, p.camera, p.frame_id, p.sensor_data, defer_maintenance=True)

    def _run_job(self, job: _Job):
        ms, _ = self._trackers[job.camera].mapper.integrate_keyframe(job.ms, job.kf_id, **job.kw)
        return self.sys._maintain_map(job.camera, ms, job.kf_id, live=False,
                                      sensors=job.sensors)

    def _moved(self, camera):
        self.sys._refresh_trajectory(camera)


class PipelinedTracker(_Stages):
    """Runs one ``slam.tracker.Tracker`` across a tracking and a mapping
    thread over native queues; ``join()`` returns the telemetry rows."""

    def __init__(self, tracker):
        self.tracker = tracker
        super().__init__(tracker.device, {None: tracker})

    def feed(self, feats, timestamp: float, frame_id: int):
        """Queue one frame, blocking while the tracking queue is full."""
        self._feed(FramePayload(feats, timestamp, frame_id, camera=None))

    def _track(self, p: FramePayload):
        return self.tracker.track(p.feats, p.timestamp, p.frame_id)

    def _run_job(self, job: _Job):
        ms, _ = self.tracker.mapper.integrate_keyframe(job.ms, job.kf_id, **job.kw)
        return ms, False
