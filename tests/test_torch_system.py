"""The port's synchronous ``System`` against the JAX package's on the CPU:
640x360 rendered frames, 300 features over 4 levels, capacity 512,
MapCaps(K=32, L=4096, F=512, O=8). ``track_stereo`` over 12 frames and
``track_rgbd`` over 10, then the System's own services: logs, exports,
checkpoints, shutdown, reset, and the options it refuses.

Tolerances: states, keyframes and every counter equal; rotation entries
within 5e-5 and translations within 5e-4 m. The float32 pose solve and local
BA of a scene with 100-150 inliers leave a frame's pose determined to a few
1e-5, and the two packages' reductions differ in order: the largest
differences seen in these runs are 2.2e-5 in a rotation entry and 2.4e-4 m
in a translation."""

import os

import numpy as np
import pytest
import torch

from hyslam_tpu.slam.system import System as JSystem
from hyslam_tpu_torch.core.frame import empty_features
from hyslam_tpu_torch.io.config import CameraConfig, OptimizerInfo, SystemConfig
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.slam.mapper import MapperParams
from hyslam_tpu_torch.slam.system import System
from hyslam_tpu_torch.slam.tracker import State
from hyslam_tpu_torch.utils import synth

from port_helpers import SYS_CAM, SYS_DT, system_configs, system_sequence

torch.set_num_threads(2)

N_STEREO = 12
N_RGBD = 10
ROT_ATOL = 5e-5
TRANS_ATOL = 5e-4


def assert_poses_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=ROT_ATOL)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=TRANS_ATOL)


def rows(telemetry):
    return [(t.frame_id, t.state, t.n_motion, t.n_inliers, t.n_local, t.kf_inserted,
             t.n_seeded) for t in telemetry]


@pytest.fixture(scope="module")
def sequence():
    return system_sequence(N_STEREO + 1)


@pytest.fixture(scope="module")
def stereo_runs(sequence, tmp_path_factory):
    """Both Systems over the first 12 frames, each writing its logs."""
    _, _, pairs = sequence
    d = tmp_path_factory.mktemp("run_data")
    jcfg, tcfg = system_configs(run_data_dir=str(d / "j"))
    tcfg.run_data_dir = str(d / "t")
    js, ts = JSystem(jcfg), System(tcfg)
    returned = []
    for i in range(N_STEREO):
        js.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i)
        returned.append(ts.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i, frame_id=i))
    ts.flush()
    tt = ts.trackers["SLAM"]
    # what the checkpoint test's extra frame would change, as it is now
    end = dict(state=tt.state, next_kf=int(tt.ms.next_kf), next_lm=int(tt.ms.next_lm),
               est=tt.traj.Tcw[:int(tt.traj.size)].numpy().copy())
    return js, ts, returned, d, end


def test_stereo_states_keyframes_and_counts_equal_jax(stereo_runs):
    js, ts, returned, _, end = stereo_runs
    jt, tel = js.trackers["SLAM"], ts.trackers["SLAM"].telemetry[:N_STEREO]
    assert rows(tel) == rows(jt.telemetry)
    assert returned == tel
    assert end["state"] == State.NORMAL and jt.state.name == "NORMAL"
    assert [t.kf_inserted for t in tel if t.kf_inserted >= 0] == list(range(end["next_kf"]))
    assert end["next_kf"] >= 6
    assert end["next_kf"] == int(np.asarray(jt.ms.next_kf))
    assert end["next_lm"] == int(np.asarray(jt.ms.next_lm))
    for a, b in zip(tel, jt.telemetry):
        assert set(a.mapper_stats) == set(b.mapper_stats)
        for k in ("triangulated", "fused", "fuse_added", "kf_culled"):
            assert a.mapper_stats.get(k) == b.mapper_stats.get(k)


def test_stereo_trajectory_matches_jax_and_truth(stereo_runs, sequence):
    from hyslam_tpu_torch.io.evaluate import ate_rmse

    Ts, _, _ = sequence
    js, _, _, _, end = stereo_runs
    jt, est = js.trackers["SLAM"], end["est"]
    assert len(est) == int(np.asarray(jt.traj.size)) == N_STEREO
    assert_poses_close(est, np.asarray(jt.traj.Tcw[:N_STEREO]))
    assert ate_rmse(est, Ts[:N_STEREO]) < 0.05


def test_run_data_dir_logs_equal_jax(stereo_runs):
    """tracking_data.txt byte-equal; localmapping_data.txt equal but for
    the printed float ba_cost (within 1e-4 of it)."""
    _, _, _, d, end = stereo_runs
    got = (d / "t" / "tracking_data.txt").read_text().strip().split("\n")[:N_STEREO + 1]
    assert got == (d / "j" / "tracking_data.txt").read_text().strip().split("\n")
    assert len(got) == N_STEREO + 1
    a = (d / "t" / "localmapping_data.txt").read_text().strip().split("\n")
    b = (d / "j" / "localmapping_data.txt").read_text().strip().split("\n")
    assert len(a) == len(b) == end["next_kf"] and a[0] == b[0]
    cost = a[0].split("\t").index("ba_cost")
    for ra, rb in zip(a[1:], b[1:]):
        ra, rb = ra.split("\t"), rb.split("\t")
        assert ra[:cost] + ra[cost + 1:] == rb[:cost] + rb[cost + 1:]
        if rb[cost]:
            assert abs(float(ra[cost]) - float(rb[cost])) <= 1e-4 * float(rb[cost])
    assert not [f for f in os.listdir(d / "t") if f.startswith("frame_")]


def test_exports_and_checkpoint_resume(stereo_runs, sequence, tmp_path):
    """The System's export methods write well-formed files, and a second
    System restored from its checkpoint tracks the next frame (given as
    tensors) to the same pose, bit for bit."""
    _, _, pairs = sequence
    _, ts, _, _, end = stereo_runs
    tt, n_kf = ts.trackers["SLAM"], end["next_kf"]
    assert int(tt.traj.size) == N_STEREO, "this test feeds the shared System one frame"
    ts.save_trajectory(str(tmp_path / "traj.tsv"))
    ts.save_trajectory_tum(str(tmp_path / "traj.tum"))
    ts.export_colmap(str(tmp_path / "colmap"))
    ts.save_keyframes_agisoft(str(tmp_path / "kf.xml"))
    ts.save_map_points(str(tmp_path / "points.tsv"))
    ts.save_map(str(tmp_path / "map.npz"))
    assert len((tmp_path / "traj.tsv").read_text().splitlines()) == N_STEREO
    tum = np.loadtxt(tmp_path / "traj.tum")
    assert tum.shape == (N_STEREO, 8)
    np.testing.assert_allclose(np.linalg.norm(tum[:, 4:], axis=1), 1.0, atol=1e-5)
    n_live = int((tt.ms.lm.valid & ~tt.ms.lm.bad).sum())
    assert len((tmp_path / "points.tsv").read_text().splitlines()) == n_live > 100
    assert len((tmp_path / "colmap" / "SLAM" / "images.txt").read_text().splitlines()) == 2 * n_kf + 1
    assert (tmp_path / "kf.xml").read_text().count("<camera ") == n_kf

    ts.save_checkpoint(str(tmp_path / "ck.npz"))
    _, tcfg = system_configs()
    other = System(tcfg)
    other.load_checkpoint(str(tmp_path / "ck.npz"))
    assert other._frame_counter == ts._frame_counter == N_STEREO
    assert other.trackers["SLAM"].state == State.NORMAL
    i = N_STEREO
    il, ir = torch.from_numpy(pairs[i, 0]), torch.from_numpy(pairs[i, 1])
    a = other.track_stereo(il, ir, SYS_DT * i)
    b = ts.track_stereo(pairs[i, 0], pairs[i, 1], SYS_DT * i)
    assert a == b and a.frame_id == N_STEREO and a.state == "NORMAL"
    assert torch.equal(other.trackers["SLAM"].last_Tcw, tt.last_Tcw)

    third = System(tcfg)
    third.load_map(str(tmp_path / "map.npz"))
    assert int(third.trackers["SLAM"].ms.next_kf) == n_kf


def test_rgbd_features_exact_and_poses_match_jax(sequence):
    """``track_rgbd`` with depth rendered from the truth: the features'
    ``ur`` and ``depth`` equal the JAX package's exactly on every frame, the
    rows equal, the poses within the tolerances above."""
    Ts, pts, pairs = sequence
    jcfg, tcfg = system_configs()
    js, ts = JSystem(jcfg), System(tcfg)
    jt, tt = js.trackers["SLAM"], ts.trackers["SLAM"]
    for i in range(N_RGBD):
        depth = synth.render_depth(SYS_CAM, Ts[i], pts)
        js.track_rgbd(pairs[i, 0], depth, SYS_DT * i, frame_id=i)
        ts.track_rgbd(pairs[i, 0], depth, SYS_DT * i, frame_id=i)
        for k in ("uv", "ur", "depth", "level", "valid"):
            np.testing.assert_array_equal(
                getattr(tt.last_feats, k).numpy(), np.asarray(getattr(jt.last_feats, k)), k)
    assert int((tt.last_feats.depth > 0).sum()) > 100
    assert rows(tt.telemetry) == rows(jt.telemetry)
    assert tt.state == State.NORMAL and tt.telemetry[0].n_seeded > 100
    n = int(tt.traj.size)
    assert n == N_RGBD
    assert_poses_close(tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n]))


def test_shutdown_and_reset(tmp_path):
    """After shutdown the System refuses input; reset gives fresh trackers
    built from the whole config (commit_lag and the mapper's parameters
    included) and reopens the logs."""
    _, tcfg = system_configs(commit_lag=3, run_data_dir=str(tmp_path))
    tcfg.mapper = MapperParams(orphan_age=5)
    s = System(tcfg)
    first = s.trackers["SLAM"]
    assert first.mapper.params.orphan_age == 5 and first.commit_lag == 3
    assert first.device == torch.device("cpu") and s.timer is not None
    s.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        s.track_features(empty_features(512), 0.0)
    assert s._tracking_log is None
    s.reset()
    t = s.trackers["SLAM"]
    assert t is not first and t.state == State.INITIALIZE
    assert t.commit_lag == 3 and t.mapper.params.orphan_age == 5
    assert s._tracking_log is not None
    assert s.track_features(empty_features(512), 0.0).state == "INITIALIZE"
    s.shutdown()
    assert len((tmp_path / "tracking_data.txt").read_text().splitlines()) == 2


def _cfg(**kw):
    kw.setdefault("enable_loop_closing", False)
    kw.setdefault("device", "cpu")
    kw.setdefault("cameras", {"SLAM": CameraConfig(bf=45.0)})
    return SystemConfig(**kw)


@pytest.mark.parametrize("kw", [dict(pipelined=True),
                                dict(pipelined=True, async_tracking=True)])
def test_unported_config_options_raise(kw, monkeypatch):
    """The option this test once held to raise, the threaded pipeline, is
    ported: the System builds its pipeline (which takes precedence over
    async_tracking), hooks every tracker to it, tracks through it, and
    stops it at shutdown (each wait bounded by 60 s)."""
    from hyslam_tpu_torch.runtime import pipeline

    monkeypatch.setattr(pipeline, "TIMEOUT_S", 60.0)
    s = System(_cfg(**kw))
    pipe = s._pipe
    assert pipe is not None and s.trackers["SLAM"].mapping_status._pipe is pipe
    assert s.track_features(empty_features(1024), 0.0) is None
    s.flush()
    assert [t.state for t in pipe.telemetry] == ["INITIALIZE"]
    assert s.trackers["SLAM"].telemetry == pipe.telemetry
    s.shutdown()
    assert s._pipe is None and not any(t.is_alive() for t in pipe._threads)


@pytest.mark.parametrize("kw", [dict(optimizer=OptimizerInfo(realtime=False)),
                                dict(cameras={"SLAM": CameraConfig(mono=True)}),
                                dict(enable_loop_closing=True),
                                dict(optimizer=OptimizerInfo(realtime=False),
                                     enable_loop_closing=True),
                                dict(cameras={"SLAM": CameraConfig(mono=True),
                                              "Imaging": CameraConfig(mono=True)}),
                                dict(cameras={"SLAM": CameraConfig(bf=45.0),
                                              "Imaging": CameraConfig(mono=True, scale=0.5)}),
                                dict(cameras={"SLAM": CameraConfig(
                                    bf=45.0, extractor=ExtractorConfig(family="SURF"))})])
def test_ported_config_options_build(kw):
    """Periodic global BA, a monocular camera, loop closing (alone and with
    periodic global BA), a second camera (each with its own tracker and
    cam_id; the Imaging camera at half scale) and the SURF family no longer
    raise."""
    s = System(_cfg(**kw))
    assert s.trackers["SLAM"].is_mono == s.config.cameras["SLAM"].mono
    assert s.loop_closers == {}
    for i, (name, cc) in enumerate(s.config.cameras.items()):
        assert s.trackers[name].cam_id == i and s.trackers[name].is_mono == cc.mono
        assert s.cameras[name].width == round(cc.width * cc.scale)
        assert s._families[name].name == cc.extractor.family


def test_unported_entry_points_raise_and_defaults():
    """The default config (loop closing on) builds; every entry point that
    is not ported names its step; with no device the System takes the card
    or raises."""
    d = System(SystemConfig(device="cpu"))
    assert d.config.enable_loop_closing and d.loop_closers == {}
    s = System(_cfg())
    img = np.zeros((480, 640), np.float32)
    # a flat image: nothing to extract, the tracker stays in INITIALIZE
    assert s.track_monocular(img, 0.0).state == "INITIALIZE"
    # the Imaging camera's entry points: before any SLAM tracking there is
    # no trajectory to place a frame by, and no Imaging keyframe to adjust
    dual = System(_cfg(cameras={"SLAM": CameraConfig(bf=45.0),
                                "Imaging": CameraConfig(mono=True)}))
    keep, Tcw = dual.place_imaging_frame(0.0)
    assert keep is False and tuple(Tcw.shape) == (4, 4)
    assert dual.run_imaging_bundle_adjustment() == 0
    assert int(dual.trackers["Imaging"].ms.next_kf) == 0
    from hyslam_tpu_torch.core.sensordata import SensorData
    tel = s.track_features(empty_features(1024), 0.0,
                           sensor_data=SensorData(depth=1.0, depth_valid=True))
    assert tel.state == "INITIALIZE" and not s.trackers["SLAM"]._has_priors
    with pytest.raises(ValueError, match="exceeds arena capacity"):
        System(_cfg(cameras={"SLAM": CameraConfig(
            bf=45.0, extractor=ExtractorConfig(n_features=2000))})).track_stereo(img, img, 0.0)
    if torch.cuda.is_available():
        assert System(_cfg(device=None)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            System(_cfg(device=None))
