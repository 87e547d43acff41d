"""The port's threaded pipeline (``runtime/pipeline.py``), the mapper's
budget levels and ``Tracker.mapping_status``, on the CPU.

- The mapper at budget levels 0, 1 and 2, and without keyframe culling,
  against the JAX mapper on one state (tests/test_torch_mapper.py's input
  and tolerances).
- A pipelined System flushed after every frame against the JAX package's
  pipelined System driven the same way, on tests/test_pipeline_system.py's
  features: the same rows and keyframes, poses within
  tests/test_torch_system.py's bounds (rotation entries 5e-5, translations
  5e-4 m).
- Unflushed runs, where what the tracker adopts depends on thread timing,
  held to the JAX tests' own bounds: keyframes within 1 of the sync
  System's, ATE < 0.02 m against it and < 0.05 m against the truth;
  ``PipelinedTracker`` ATE < 0.08 m after re-anchoring.
- Shutdown, refusal and reset; an exception of either thread raised to the
  caller; the map snapshots handed to the mapping thread unchanged by the
  tracker's later frames and the mapper; a keyframe's job carrying the
  sensor arena with its own reading to the map maintenance; two cameras
  pipelined; the threads' turns (order, a drain giving its turn up).

Every drain, join and flush waits at most WAIT_S seconds; two CPU threads."""

import hashlib
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.slam import mapper as j_mapper
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.core.sensordata import SensorData
from hyslam_tpu_torch.core import trajectory as TJ
from hyslam_tpu_torch.io.evaluate import ate_rmse
from hyslam_tpu_torch.runtime import pipeline
from hyslam_tpu_torch.runtime.pipeline import PipelinedTracker
from hyslam_tpu_torch.slam import mapper
from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.slam.tracker import State, Tracker
from hyslam_tpu_torch.utils import synth

import test_pipeline_system as jtest
from helpers import DEFAULT_CAM, make_world, synth_frame_features
from port_helpers import DUAL_DT, dual_camera_scene, dual_system_configs, feats_to_torch
from test_torch_mapper import CAM, PX_DLT, assert_map_close, mapper_input  # noqa: F401

WAIT_S = 120.0
ROT_ATOL, TRANS_ATOL = 5e-5, 5e-4
N_FRAMES = 22


@pytest.fixture(autouse=True)
def bounded_waits(monkeypatch):
    monkeypatch.setattr(pipeline, "TIMEOUT_S", WAIT_S)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """The CPU threads the tolerances above were set with (in
    tests/test_torch_mapper.py and tests/test_torch_system.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sequence(seed: int, n: int = N_FRAMES, step: float = 0.12):
    """tests/test_pipeline_system.py:drive's poses and features (the JAX
    package's), without driving anything."""
    rng = np.random.default_rng(seed)
    pts = make_world(rng, 1500, extent=(10.0, 7.0, 60.0), z_min=2.0)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    delta = np.asarray(j_se3.exp(jnp.asarray([0, 0.004, 0, 0, 0, -step], jnp.float32)))
    T, Ts, feats = np.eye(4, dtype=np.float32), [], []
    for _ in range(n):
        Ts.append(T.copy())
        feats.append(synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=512)[0])
        T = (delta @ T).astype(np.float32)
    return np.stack(Ts), feats


def port_system(pipelined: bool) -> System:
    """tests/test_pipeline_system.py's System, the port's, on the CPU."""
    cfg = interop.system_config_from(jtest.make_system(False).config, device="cpu")
    cfg.pipelined = pipelined
    return System(cfg)


def drive(sysm, feats, to_features=feats_to_torch, flush_each=False, flush=None):
    flush = flush or sysm.flush
    for i, f in enumerate(feats):
        sysm.track_features(to_features(f), timestamp=0.1 * i, frame_id=i)
        if flush_each:
            flush()
    flush()


def rows(tels):
    return [(t.frame_id, t.state, t.n_motion, t.n_inliers, t.n_local, t.kf_inserted,
             t.n_seeded) for t in tels]


def trajectory(tracker) -> np.ndarray:
    n = int(np.asarray(tracker.traj.size))
    Tcw = tracker.traj.Tcw[:n]
    return Tcw.numpy() if isinstance(Tcw, torch.Tensor) else np.asarray(Tcw)


@pytest.fixture(scope="module")
def seq7():
    return sequence(7)


@pytest.mark.parametrize("budget,cull", [(0, True), (1, True), (2, True), (2, False)])
def test_mapper_budget_levels_match_jax(mapper_input, budget, cull):
    """integrate_keyframe at each budget level: the same jobs run (stats
    keys and counts equal) and the same map, to test_torch_mapper.py's
    tolerances."""
    ms_j, ms_t, kf_id = mapper_input
    mj, mt = j_mapper.Mapper(DEFAULT_CAM), mapper.Mapper(CAM)
    mj.kf_count = mt.kf_count = 3
    out_j, st_j = mj.integrate_keyframe(ms_j, kf_id, budget_level=budget, cull_kfs=cull)
    out_t, st_t = mt.integrate_keyframe(ms_t, kf_id, budget_level=budget, cull_kfs=cull)
    assert set(st_t) == set(st_j)
    assert ("triangulated" in st_t) == (budget >= 1)
    assert ("ba_cost" in st_t) == (budget >= 2)
    assert ("kf_culled" in st_t) == (budget >= 2 and cull)
    assert {k: v for k, v in st_t.items() if k != "ba_cost"} == \
        {k: v for k, v in st_j.items() if k != "ba_cost"}
    if budget >= 2:
        np.testing.assert_allclose(st_t["ba_cost"], st_j["ba_cost"], rtol=1e-4)
    assert mt.kf_count == mj.kf_count == 4
    assert_map_close(out_t, out_j, PX_DLT)


def test_flushed_pipelined_system_matches_jax(seq7):
    """Flushed after every frame, each keyframe's mapper jobs and
    maintenance end before the next frame: both packages' pipelines then
    do what their sync Systems do, and must agree."""
    Ts, feats = seq7
    js, ts = jtest.make_system(True), port_system(True)
    # the JAX System's flush waits up to 600 s: drain its pipeline directly
    drive(js, feats, to_features=lambda f: f, flush_each=True,
          flush=lambda: js._pipe.drain_all(timeout=WAIT_S))
    drive(ts, feats, flush_each=True)
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    assert rows(ts._pipe.telemetry) == rows(js._pipe.telemetry)
    assert rows(tt.telemetry) == rows(ts._pipe.telemetry)
    kfs = [t.kf_inserted for t in tt.telemetry if t.kf_inserted >= 0]
    assert kfs == list(range(int(tt.ms.next_kf))) and len(kfs) >= 5
    assert int(tt.ms.next_kf) == int(np.asarray(jt.ms.next_kf))
    assert all(t.mapper_stats == {"deferred": True} for t in tt.telemetry[1:]
               if t.kf_inserted >= 0)
    est, want = trajectory(tt), trajectory(jt)
    assert est.shape == want.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(est[:, :3, :3], want[:, :3, :3], atol=ROT_ATOL)
    np.testing.assert_allclose(est[:, :3, 3], want[:, :3, 3], atol=TRANS_ATOL)
    assert ate_rmse(est, Ts) < 0.05
    js.shutdown()   # both stages drained above: the join only stops idle threads
    ts.shutdown()


def test_unflushed_pipelined_system_keeps_the_jax_bounds(seq7):
    """tests/test_pipeline_system.py's two tests on the port: every frame
    tracked and every keyframe after the first integrated by the mapping
    thread; against the sync System keyframes within 1, ATE < 0.02 m, and
    < 0.05 m against the truth."""
    Ts, feats = seq7
    sync, pipe = port_system(False), port_system(True)
    drive(sync, feats)
    drive(pipe, feats)
    tr_s, tr_p = sync.trackers["SLAM"], pipe.trackers["SLAM"]
    tels = pipe._pipe.telemetry
    assert [t.frame_id for t in tels] == list(range(N_FRAMES))
    assert tr_p.state in (State.NORMAL, State.POSTINIT)
    kf_tels = [t for t in tels if t.kf_inserted >= 0 and t.mapper_stats]
    assert len(kf_tels) >= 2 and all(t.mapper_stats.get("deferred") for t in kf_tels)
    assert len(pipe._pipe.mapping_spans) == len(kf_tels)
    # one logged idle read a keyframe decision: every frame after the first
    assert [f for _, f, _ in pipe._pipe.idle_reads] == list(range(1, N_FRAMES))
    assert abs(int(tr_s.ms.next_kf) - int(tr_p.ms.next_kf)) <= 1
    est_s, est_p = trajectory(tr_s), trajectory(tr_p)
    n = min(len(est_s), len(est_p))
    assert n >= N_FRAMES - 1
    assert ate_rmse(est_p[:n], est_s[:n]) < 0.02
    assert ate_rmse(est_p[:n], Ts[:n]) < 0.05
    pipe.shutdown()


def test_pipelined_tracker_matches_synchronous_quality():
    """tests/test_runtime.py's PipelinedTracker case: 25 frames, NORMAL at
    the end, ATE < 0.08 m once re-anchored to the final keyframes (what was
    adopted during the run depends on thread timing; the final map does
    not)."""
    Ts, feats = sequence(0, n=25)
    tracker = Tracker(cam=CAM, caps=MapCaps(K=64, L=8192, F=512, O=8),
                      policy=KeyFramePolicyParams(max_kf_interval=10), device="cpu")
    pipe = PipelinedTracker(tracker)
    for i, f in enumerate(feats):
        pipe.feed(feats_to_torch(f), 0.1 * i, i)
    tels = pipe.join(timeout=WAIT_S)
    assert len(tels) == 25 and tracker.state == State.NORMAL
    assert tracker.mapper.integrate_keyframe.__func__ is mapper.Mapper.integrate_keyframe
    assert tracker.mapping_status is None     # the join detaches the pipeline
    assert len(pipe.mapping_spans) == sum(t.kf_inserted >= 0 for t in tels) - 1
    ms = tracker.ms
    tracker.traj = TJ.refresh(tracker.traj, ms.kf.Tcw, ms.kf.bad, ms.kf.span_parent, ms.kf.Tcp)
    est = trajectory(tracker)
    errs = [synth.pose_error(est[i], Ts[i])[1] for i in range(len(est))]
    assert len(est) == 25 and np.sqrt(np.mean(np.square(errs))) < 0.08


def test_shutdown_refuses_input_and_reset_rebuilds_the_pipeline(seq7):
    _, feats = seq7
    sysm = port_system(True)
    first = sysm._pipe
    drive(sysm, feats[:10])
    sysm.shutdown()
    assert sysm._pipe is None and not any(t.is_alive() for t in first._threads)
    with pytest.raises(RuntimeError, match="shut down"):
        sysm.track_features(None, 0.0)
    sysm.reset()
    assert sysm._pipe is not None and sysm._pipe is not first
    assert sysm.trackers["SLAM"].mapping_status._pipe is sysm._pipe
    _, other = sequence(6, n=10)
    drive(sysm, other)
    assert sysm.trackers["SLAM"].state in (State.NORMAL, State.POSTINIT)
    assert len(sysm._pipe.telemetry) == 10
    sysm.shutdown()


@pytest.mark.parametrize("where", ["mapping", "tracking"])
def test_a_thread_exception_reaches_the_caller(seq7, monkeypatch, where):
    """A mapper that raises on its 2nd job, or a frame the tracker cannot
    take: the next flush raises it well within the wait's bound, and the
    pipeline refuses further frames instead of hanging."""
    _, feats = seq7
    calls = []
    real = mapper.Mapper.integrate_keyframe

    def failing(self, ms, kf_id, **kw):
        calls.append(kf_id)
        if len(calls) == 2:
            raise ValueError("mapper failed")
        return real(self, ms, kf_id, **kw)

    if where == "mapping":
        monkeypatch.setattr(mapper.Mapper, "integrate_keyframe", failing)
    sysm = port_system(True)
    pipe = sysm._pipe
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="pipeline thread died") as err:
        for i, f in enumerate(feats):
            sysm.track_features(feats_to_torch(f) if where == "mapping" or i != 3 else None,
                                0.1 * i, frame_id=i)
        sysm.flush()
    assert time.monotonic() - t0 < WAIT_S
    cause = err.value.__cause__
    if where == "mapping":
        assert isinstance(cause, ValueError) and len(calls) == 2
    else:
        assert isinstance(cause, (AttributeError, TypeError))
    with pytest.raises(RuntimeError, match="pipeline thread died"):
        sysm.track_features(feats_to_torch(feats[0]), 9.9, frame_id=99)
    with pytest.raises(RuntimeError, match="pipeline thread died"):
        sysm.shutdown()
    assert not any(t.is_alive() for t in pipe._threads)
    with pytest.raises(RuntimeError, match="shut down"):
        sysm.track_features(feats_to_torch(feats[0]), 9.9, frame_id=99)


def _digest(tree) -> list:
    """sha256 of every tensor of a NamedTuple / dict tree, in order."""
    out = []
    if isinstance(tree, torch.Tensor):
        return [hashlib.sha256(tree.contiguous().numpy().tobytes()).hexdigest()]
    items = tree._asdict().values() if hasattr(tree, "_asdict") else (
        tree.values() if isinstance(tree, dict) else ())
    for v in items:
        out += _digest(v)
    return out


def test_snapshots_are_not_written_in_place(seq7, monkeypatch):
    """Snapshots are shared with the mapping thread, not copied: every
    tensor of each pushed map (and sensor arena) hashes the same after the
    tracker's later frames and the mapper's jobs as when it was pushed."""
    _, feats = seq7
    pushed = []
    real_push = pipeline._Stages._push_job

    def recording(self, job):
        pushed.append((job, _digest(job.ms) + _digest(job.kw) + _digest(job.sensors)))
        return real_push(self, job)

    monkeypatch.setattr(pipeline._Stages, "_push_job", recording)
    sysm = port_system(True)
    drive(sysm, feats)
    assert len(pushed) >= 5
    for job, digest in pushed:
        assert _digest(job.ms) + _digest(job.kw) + _digest(job.sensors) == digest
    sysm.shutdown()


def test_a_keyframe_job_carries_its_own_sensor_reading(seq7, monkeypatch):
    """Every frame carries a GPS reading (at the true camera centre, 100 m
    sigma): the mapper's local BA gets the arena without the new
    keyframe's reading, as in the sync System, and the map maintenance on
    the mapping thread gets the arena with it, whatever the tracking thread
    does meanwhile."""
    Ts, feats = seq7
    jobs, maintained = [], []
    real_push, real_maintain = pipeline._Stages._push_job, System._maintain_map

    def recording(self, job):
        jobs.append(job)
        return real_push(self, job)

    def maintain(self, camera, ms, kf_id, live=True, sensors=None):
        maintained.append((kf_id, live, sensors))
        return real_maintain(self, camera, ms, kf_id, live, sensors)

    monkeypatch.setattr(pipeline._Stages, "_push_job", recording)
    monkeypatch.setattr(System, "_maintain_map", maintain)
    sysm = port_system(True)
    for i, f in enumerate(feats):
        centre = -Ts[i][:3, :3].T @ Ts[i][:3, 3]
        sysm.track_features(feats_to_torch(f), 0.1 * i, frame_id=i,
                            sensor_data=SensorData(gps_rel=tuple(centre), gps_err=(100.0,) * 3,
                                                   gps_valid=True))
    sysm.flush()
    assert len(jobs) >= 5 and len(maintained) == len(jobs)
    for job, (kf_id, live, sensors) in zip(jobs, maintained):
        assert kf_id == job.kf_id and not live and sensors is job.sensors
        assert bool(sensors.gps_valid[kf_id]) and not bool(job.kw["sensors"].gps_valid[kf_id])
    sysm.shutdown()


def test_two_cameras_pipelined_reach_normal():
    """The SLAM and Imaging cameras of tests/test_torch_dual_camera.py
    (without the blackout), both through one pipeline: every frame of both
    tracked in order, both NORMAL at the end, both mappers fed."""
    _, slam, img = dual_camera_scene(n=14, dark=(0, 0))
    _, cfg = dual_system_configs()
    cfg.pipelined = True
    sysm = System(cfg)
    for i, (fs, fi) in enumerate(zip(slam, img)):
        sysm.track_features(feats_to_torch(fs), DUAL_DT * i, camera="SLAM", frame_id=i)
        sysm.track_features(feats_to_torch(fi), DUAL_DT * i, camera="Imaging", frame_id=i)
    sysm.flush()
    tels = sysm._pipe.telemetry
    assert len(tels) == 28
    for name in ("SLAM", "Imaging"):
        tr = sysm.trackers[name]
        assert [t.frame_id for t in tr.telemetry] == list(range(14)), name
        assert tr.state == State.NORMAL, (name, [t.state for t in tr.telemetry])
        assert int(tr.ms.next_kf) >= 3, name
    assert len(sysm._pipe.mapping_spans) == sum(
        t.kf_inserted >= 0 and bool(t.mapper_stats) for t in tels)
    sysm.shutdown()


def test_turns_go_in_the_order_asked_and_a_drain_gives_its_turn_up():
    """``Turns``: threads asking while one holds the turn get it in the
    order they asked; a holder that waits in ``given_up`` lets the next one
    run and gets the turn back after it; a waiter that leaves does not
    block those behind it; ``close`` lets every waiter through."""
    turns, order, ready = pipeline.Turns(), [], []

    def runner(name, asked):
        with turns.hold():
            order.append(name)
        asked.set()

    with turns.hold():
        threads = []
        for name in "abc":
            asked = threading.Event()
            th = threading.Thread(target=runner, args=(name, asked))
            th.start()
            deadline = time.monotonic() + WAIT_S
            while turns._issued < len(threads) + 2 and time.monotonic() < deadline:
                time.sleep(0.001)
            threads.append((th, asked))
        assert order == []
    for th, _ in threads:
        th.join(timeout=WAIT_S)
    assert order == ["a", "b", "c"]

    # a drain inside a turn: the other thread runs while the holder waits
    done = threading.Event()

    def other():
        with turns.hold():
            ready.append("other")
        done.set()

    with turns.hold():
        th = threading.Thread(target=other)
        th.start()
        with turns.given_up():
            assert done.wait(timeout=WAIT_S)
        ready.append("holder")
    th.join(timeout=WAIT_S)
    assert ready == ["other", "holder"]

    # the ticket of a waiter that left is skipped
    with turns.hold():
        with turns._cv:
            turns._abandoned.add(turns._issued)
            turns._issued += 1
        th = threading.Thread(target=runner, args=("d", threading.Event()))
        th.start()
    th.join(timeout=WAIT_S)
    assert order[-1] == "d"

    # close: a waiter behind a holder that never releases goes through
    turns._acquire()
    turns.close()
    th = threading.Thread(target=runner, args=("e", threading.Event()))
    th.start()
    th.join(timeout=WAIT_S)
    assert order[-1] == "e" and not th.is_alive()
