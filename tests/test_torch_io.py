"""The port's host-side modules against the JAX package's on the same
inputs: Horn alignment and ATE / RPE, the dataset readers, the config
loader and the tracking-parameter resolver, the telemetry logs, the
exporters, and map / checkpoint files passing between the two packages."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hyslam_tpu.geometry import horn as j_horn
from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.io import config as j_config
from hyslam_tpu.io import datasets as j_data
from hyslam_tpu.io import evaluate as j_eval
from hyslam_tpu.io import export as j_export
from hyslam_tpu.slam import tracker as j_tracker
from hyslam_tpu.slam import tracking_params as j_tp
from hyslam_tpu.utils import telemetry as j_tel
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.features.factory import make_family
from hyslam_tpu_torch.geometry import horn, sim3
from hyslam_tpu_torch.io import config, datasets, evaluate, export
from hyslam_tpu_torch.slam import tracker, tracking_params
from hyslam_tpu_torch.utils import synth, telemetry

from port_helpers import (J_SMALL_CAM, SMALL_CAM, jax_tracker_state, ms_to_torch,
                          small_world, stereo_pair, traj_to_torch, tree_np)
from test_tracking_params import REFERENCE_STYLE

torch.set_num_threads(2)


def plain(x):
    """A config tree (dataclasses, NamedTuples, dicts) as nested dicts of
    Python values, so that the two packages' trees compare field by field."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if hasattr(x, "_asdict"):
        return {k: plain(v) for k, v in x._asdict().items()}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


# ---------------------------------------------------------------- evaluation

def _line(n=10):
    """tests/test_datasets.py's forward-moving trajectory."""
    Tcw = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    Tcw[:, 2, 3] = -0.3 * np.arange(n)
    return Tcw


def _evaluate_cases():
    T = _line()
    off = np.eye(4, dtype=np.float32)
    off[0, 3] = 5.0
    noisy = T.copy()
    noisy[:, :3, 3] += np.random.default_rng(0).normal(0, 0.1, (len(T), 3))
    rng = np.random.default_rng(3)
    curve = np.stack([np.asarray(j_se3.exp(jnp.asarray(
        rng.normal(0, 0.3, 6), jnp.float32))) for _ in range(12)])
    return {"identical": (T, T), "rigid_offset": (np.einsum("nij,jk->nik", T, off), T),
            "noise": (noisy, T), "curve": (curve, _line(12))}


@pytest.mark.parametrize("case", ["identical", "rigid_offset", "noise", "curve"])
@pytest.mark.parametrize("align", ["none", "se3", "sim3"])
def test_ate_matches_jax(case, align):
    """ATE within 1e-5 m of the JAX package's value (its Horn fit runs in
    float32, the port's in float64)."""
    est, gt = _evaluate_cases()[case]
    got = evaluate.ate_rmse(est, gt, align=align)
    assert abs(got - j_eval.ate_rmse(est, gt, align=align)) < 1e-5
    if case in ("identical", "rigid_offset") and align != "none":
        assert got < 1e-4


@pytest.mark.parametrize("case", ["identical", "noise", "curve"])
def test_rpe_matches_jax(case):
    """Both RPE numbers within 1e-5 (m, degrees) of the JAX package's."""
    est, gt = _evaluate_cases()[case]
    got, want = evaluate.rpe(est, gt), j_eval.rpe(est, gt)
    assert abs(got[0] - want[0]) < 1e-5 and abs(got[1] - want[1]) < 1e-5
    got2, want2 = evaluate.rpe(est, gt, delta=3), j_eval.rpe(est, gt, delta=3)
    assert abs(got2[0] - want2[0]) < 1e-5 and abs(got2[1] - want2[1]) < 1e-5
    np.testing.assert_array_equal(evaluate.camera_centers(est),
                                  j_eval.camera_centers(est))


@pytest.mark.parametrize("weighted", [False, True])
def test_horn_matches_jax(weighted):
    """horn_se3 and horn_sim3 on a scaled, rotated, shifted, noisy cloud
    (one batch axis): the transforms within 1e-5 of the JAX package's, and
    sim3.apply of the fit maps x onto y."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (2, 40, 3)).astype(np.float32)
    R = np.asarray(j_se3.exp(jnp.asarray([0.3, -0.2, 0.5, 0, 0, 0], jnp.float32)))[:3, :3]
    y = (1.7 * x @ R.T + np.float32([1.0, -2.0, 0.5])).astype(np.float32)
    y += rng.normal(0, 0.01, y.shape).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (2, 40)).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else torch.from_numpy(w)
    g = horn.horn_sim3(torch.from_numpy(x), torch.from_numpy(y), tw)
    np.testing.assert_allclose(g.numpy(), np.asarray(
        j_horn.horn_sim3(jnp.asarray(x), jnp.asarray(y), jw)), atol=1e-5)
    T = horn.horn_se3(torch.from_numpy(x), torch.from_numpy(y), tw)
    np.testing.assert_allclose(T.numpy(), np.asarray(
        j_horn.horn_se3(jnp.asarray(x), jnp.asarray(y), jw)), atol=1e-5)
    assert abs(float(g[0, 0]) - 1.7) < 1e-2
    np.testing.assert_allclose(sim3.apply(g[:, None], torch.from_numpy(x)).numpy(), y,
                               atol=0.06)


# ------------------------------------------------------------------ datasets

@pytest.fixture(scope="module")
def rendered():
    """Four rendered stereo pairs with depth, their poses and times."""
    pts = small_world()
    Ts = synth.make_trajectory(4, step=0.1, yaw_rate=0.01)
    pairs = np.stack([stereo_pair(T, pts) for T in Ts])
    depths = np.stack([synth.render_depth(SMALL_CAM, T, pts) for T in Ts])
    return Ts, pairs, depths, 0.1 * np.arange(4)


def test_kitti_folder_reads_equal_in_both_packages(rendered, tmp_path):
    """A sequence written by synth.write_kitti_sequence, read by both
    readers: calibration, images, times and poses equal; the images are the
    rendered ones rounded to 8 bits."""
    Ts, pairs, _, times = rendered
    root = str(tmp_path / "kitti")
    synth.write_kitti_sequence(root, SMALL_CAM, pairs, times, poses=Ts)
    ds, jds = datasets.KittiOdometry(root, "00"), j_data.KittiOdometry(root, "00")
    assert len(ds) == len(jds) == 4
    assert dataclasses.asdict(ds.calib) == dataclasses.asdict(jds.calib)
    assert abs(ds.calib.bf - SMALL_CAM.bf) < 1e-6 and ds.calib.width == SMALL_CAM.width
    for i, (a, b) in enumerate(zip(ds.frames(), jds.frames())):
        assert isinstance(a.img_left, np.ndarray) and a.img_left.dtype == np.float32
        np.testing.assert_array_equal(a.img_left, b.img_left)
        np.testing.assert_array_equal(a.img_right, b.img_right)
        assert (a.timestamp, a.frame_id) == (b.timestamp, b.frame_id)
        np.testing.assert_array_equal(a.gt_Tcw, b.gt_Tcw)
        np.testing.assert_array_equal(a.img_left, np.clip(np.rint(pairs[i, 0]), 0, 255))
        np.testing.assert_allclose(a.gt_Tcw, Ts[i], atol=1e-6)
    assert [f.frame_id for f in ds.frames(1, 3)] == [1, 2]


def test_tum_folder_reads_equal_in_both_packages(rendered, tmp_path):
    """A TUM-layout folder (8-bit grey, 16-bit depth PGM): images and depth
    equal in both readers, depth within half a quantum (1e-4 m) of the
    rendered depth, the ground truth rows equal."""
    Ts, pairs, depths, times = rendered
    root = str(tmp_path / "tum")
    synth.write_tum_sequence(root, pairs[:, 0], depths, times, poses=Ts)
    ds, jds = datasets.TumRgbd(root), j_data.TumRgbd(root)
    np.testing.assert_array_equal(ds.gt, jds.gt)
    assert ds.gt.shape == (4, 8)
    got, want = list(ds.frames()), list(jds.frames())
    assert len(got) == len(want) == 4
    for k, (a, b) in enumerate(zip(got, want)):
        assert a[:2] == b[:2]
        np.testing.assert_array_equal(a[2], b[2])
        np.testing.assert_array_equal(a[3], b[3])
        assert a[3].dtype == np.float32 and a[3].max() > 3.0
        np.testing.assert_allclose(a[3], depths[k], atol=1.01e-4)
    q = ds.gt[2, [7, 4, 5, 6]]
    Twc = np.linalg.inv(Ts[2].astype(np.float64))
    np.testing.assert_allclose(datasets._mat_from_quat(q), Twc[:3, :3], atol=1e-6)
    np.testing.assert_allclose(ds.gt[2, 1:4], Twc[:3, 3], atol=1e-6)


def test_pgm_reader_without_pil(rendered, tmp_path, monkeypatch):
    """With PIL not importable the pure-numpy reader gives the same arrays,
    8-bit and 16-bit."""
    import builtins
    _, pairs, depths, _ = rendered
    p8, p16 = str(tmp_path / "a.pgm"), str(tmp_path / "d.pgm")
    synth.write_pgm(p8, pairs[0, 0])
    synth.write_pgm(p16, depths[0] * 5000.0, maxval=65535)
    with_pil = datasets._imread_gray(p8), datasets._imread_depth(p16, 5000.0)
    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    np.testing.assert_array_equal(datasets._imread_gray(p8), with_pil[0])
    np.testing.assert_array_equal(datasets._imread_depth(p16, 5000.0), with_pil[1])
    np.testing.assert_array_equal(with_pil[0], np.clip(np.rint(pairs[0, 0]), 0, 255))


def test_euroc_folder_reads_equal_in_both_packages(rendered, tmp_path):
    """An ASL-layout folder (tests/test_datasets.py's, with a rotated body):
    calibration, pairing, images, times and ground-truth poses equal."""
    _, pairs, _, _ = rendered
    root = str(tmp_path / "euroc")
    t0 = 1403636579763555580
    for ci, cam in enumerate(("cam0", "cam1")):
        T_BS = np.eye(4)
        T_BS[0, 3] = 0.11 * ci
        os.makedirs(os.path.join(root, "mav0", cam, "data"))
        with open(os.path.join(root, "mav0", cam, "sensor.yaml"), "w") as f:
            yaml.safe_dump({"intrinsics": [458.654, 457.296, 367.215, 248.375],
                            "resolution": [SMALL_CAM.width, SMALL_CAM.height],
                            "T_BS": {"data": T_BS.ravel().tolist()}}, f)
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n")
            for i in range(4):
                # the last cam1 frame is 20 ms off: its pair is dropped
                ts = t0 + i * 50_000_000 + ci * (20_000_000 if i == 3 else 1_000_000)
                f.write("%d,%d.pgm\n" % (ts, i))
                synth.write_pgm(os.path.join(root, "mav0", cam, "data", "%d.pgm" % i),
                                pairs[i, ci])
    os.makedirs(os.path.join(root, "mav0", "state_groundtruth_estimate0"))
    with open(os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], ...\n")
        for i in range(4):
            f.write("%d,%f,0.1,0.0,0.9238795,0.0,0.3826834,0.0\n" % (
                t0 + i * 50_000_000, 0.5 * i))
    ds, jds = datasets.EurocMav(root), j_data.EurocMav(root)
    assert len(ds) == len(jds) == 3 and ds.pairs == jds.pairs
    assert dataclasses.asdict(ds.calib) == dataclasses.asdict(jds.calib)
    for a, b in zip(ds.frames(), jds.frames()):
        np.testing.assert_array_equal(a.img_left, b.img_left)
        np.testing.assert_array_equal(a.img_right, b.img_right)
        assert (a.timestamp, a.frame_id) == (b.timestamp, b.frame_id)
        np.testing.assert_allclose(a.gt_Tcw, b.gt_Tcw, atol=1e-6)


def test_synthetic_sequence_matches_jax():
    """The same seed gives the same world and poses (within 1e-6)."""
    pts, Ts = datasets.synthetic_stereo_sequence(
        np.random.default_rng(4), SMALL_CAM, n_frames=6, n_points=50)
    jpts, jTs = j_data.synthetic_stereo_sequence(
        np.random.default_rng(4), J_SMALL_CAM, n_frames=6, n_points=50)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_allclose(Ts, jTs, atol=1e-6)


# -------------------------------------------------------------------- config

def _dual_camera_yaml(tmp_path, **slam):
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump({
        "cameras": {"SLAM": {"bf": 45.0, **slam},
                    "Imaging": {"mono": True, "scale": 0.5}},
        "tracking": REFERENCE_STYLE, "mapper": {"orphan_age": 5},
        "optimizer": {"realtime": False, "gba_interval": 8},
        "caps": {"K": 32, "L": 4096, "F": 512, "O": 8},
        "enable_loop_closing": False, "async_tracking": True, "commit_lag": 3}))
    return str(p)


@pytest.mark.parametrize("which", ["sample", "dual", "explicit_policy"])
def test_load_config_matches_jax_field_by_field(which, tmp_path):
    """load_config on the sample config and on tests/test_tracking_params.py's
    dual-camera YAML (once with an explicit policy block): every field of the
    tree equal to the JAX package's; the port adds ``device``."""
    path = {"sample": "config/sample_config.yaml",
            "dual": _dual_camera_yaml(tmp_path),
            "explicit_policy": _dual_camera_yaml(
                tmp_path, policy={"n_tracked_target": 99})}[which]
    cfg, jcfg = config.load_config(path), j_config.load_config(path)
    got, want = plain(cfg), plain(jcfg)
    assert got.pop("device") is None
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    assert interop.system_config_from(jcfg) == cfg
    for name, cc in cfg.cameras.items():
        assert plain(cc.camera()) == plain(jcfg.cameras[name].camera()), name
    if which != "sample":
        assert cfg.cameras["Imaging"].tracking.motion.match_radius == 15.0
        assert cfg.mapper.orphan_age == 5 and cfg.commit_lag == 3
        assert cfg.cameras["Imaging"].camera().width == 320


@pytest.mark.parametrize("camera,is_mono", [("SLAM", False), ("Imaging", False),
                                            ("Imaging", True), ("SomeOtherCam", False)])
def test_resolve_tracking_params_matches_jax(camera, is_mono):
    """The cases of tests/test_tracking_params.py: the resolved sets equal,
    hashable, with the declared types."""
    got = tracking_params.resolve_tracking_params(REFERENCE_STYLE, camera, is_mono)
    want = j_tp.resolve_tracking_params(REFERENCE_STYLE, camera, is_mono)
    assert plain(got) == plain(want)
    assert hash(got) == hash(tracking_params.resolve_tracking_params(
        REFERENCE_STYLE, camera, is_mono))
    assert isinstance(got.normal.thresh_refine, int)
    assert isinstance(got.motion.match_radius, float)
    assert plain(tracking_params.TrackingParams()) == plain(j_tp.TrackingParams())


def test_feature_family():
    """ORB resolves to the atlas extractors; SURF to the Hessian family."""
    fam = make_family(ExtractorConfig(n_features=100, n_levels=4))
    assert (fam.name, fam.th_high, fam.th_low) == ("ORB", 100.0, 50.0)
    img = torch.from_numpy(stereo_pair(np.eye(4, dtype=np.float32), small_world()))
    one = fam.extract(img[0], capacity=128)
    two = fam.extract_batch(img, capacity=128)
    for a, b in zip(one, two):
        assert torch.equal(a, b[0])
    assert fam.distance_matrix(one.desc[:4], one.desc).shape == (4, 128)
    surf = make_family(ExtractorConfig(family="SURF", n_features=100))
    assert (surf.name, surf.th_high, surf.th_low) == ("SURF", 100.0, 50.0)
    assert surf.distance_matrix is fam.distance_matrix
    got = surf.extract_batch(img, capacity=128)
    assert got.uv.shape == (2, 128, 2) and bool(got.valid.any())
    with pytest.raises(ValueError, match="unknown feature family"):
        make_family(ExtractorConfig(family="SIFT"))


# ----------------------------------------------------------------- telemetry

def test_telemetry_logs_byte_equal(tmp_path):
    """The same rows through both packages' logs give the same bytes."""
    rows = [dict(frame_id=0, state="INITIALIZE", kf_inserted=0, n_seeded=212),
            dict(frame_id=3, state="NORMAL", n_motion=80, n_inliers=120, n_local=300,
                 kf_inserted=2, n_seeded=17),
            dict(frame_id=4, state="NORMAL>LOST")]
    stats = [{"triangulated": 55, "fused": 7, "fuse_added": 2, "ba_cost": 12.5,
              "kf_culled": 1}, {"triangulated": 3, "fused": 0, "fuse_added": 0}]
    for mod, tel_cls, d in ((telemetry, tracker.TrackerTelemetry, tmp_path / "t"),
                            (j_tel, j_tracker.TrackerTelemetry, tmp_path / "j")):
        tl = mod.TrackingLog(str(d / "tracking_data.txt"))
        ml = mod.MappingLog(str(d / "localmapping_data.txt"))
        for i, r in enumerate(rows):
            tl.log("SLAM", tel_cls(**r), timestamp=0.1 * i, n_kfs=i + 1, n_landmarks=99 * i)
        for i, s in enumerate(stats):
            ml.log("SLAM", i + 1, s)
        tl.close()
        ml.close()
    for name in ("tracking_data.txt", "localmapping_data.txt"):
        got = (tmp_path / "t" / name).read_bytes()
        assert got == (tmp_path / "j" / name).read_bytes() and got.count(b"\n") >= 3
    assert telemetry.TRACKING_COLUMNS == j_tel.TRACKING_COLUMNS
    assert telemetry.MAPPING_COLUMNS == j_tel.MAPPING_COLUMNS


def test_stage_timer_records_spans():
    t = telemetry.StageTimer()
    assert t.span("frame", 0) is telemetry.OFF and len(t.spans) == 0     # off
    t.enabled = True
    with t.span("frame", 7):
        for n in (2, 3):
            with t.span("mapper.fuse") as sp:
                sp.note("fuse_calls", n)
    with t.span("commit"):
        pass
    frame, fuse1, fuse2, commit = t.spans
    assert [(x.id, x.name, x.parent, x.frame) for x in t.spans] == [
        (0, "frame", -1, 7), (1, "mapper.fuse", 0, 7), (2, "mapper.fuse", 0, 7),
        (3, "commit", -1, -1)]
    assert fuse1.counters == {"fuse_calls": 2} and fuse2.counters == {"fuse_calls": 3}
    assert frame.counters is None and t.dropped == 0
    assert frame.start_ns <= fuse1.start_ns <= fuse1.end_ns <= fuse2.start_ns
    assert fuse2.end_ns <= frame.end_ns <= commit.start_ns <= commit.end_ns


# ------------------------------------------------------------------- exports

@pytest.fixture(scope="module")
def carried():
    """A JAX-package map state (a moved keyframe, landmarks with tracks, a
    culled one) and a two-row trajectory, and the same carried across."""
    ms, traj = jax_tracker_state()
    from hyslam_tpu.core import trajectory as JT
    T = j_se3.exp(jnp.asarray([0.2, -0.1, 0.3, 1.0, -2.0, 0.5], jnp.float32))
    ms = ms._replace(kf=ms.kf._replace(Tcw=ms.kf.Tcw.at[0].set(T)))
    traj = JT.append(traj, 0.6, j_se3.exp(jnp.asarray([0.0, 0.4, 0.1, 0.3, 0.2, -1.0])),
                     0, T, True)
    return ms, traj, ms_to_torch(ms), traj_to_torch(traj)


def _same_text(a: str, b: str, atol=1e-6):
    """Equal token by token: numbers within atol, everything else exactly."""
    ta, tb = a.split(), b.split()
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        if x != y:
            assert abs(float(x) - float(y)) <= atol, (x, y)


@pytest.mark.parametrize("what", ["tsv", "tsv_aligned", "tum", "colmap", "agisoft", "points"])
def test_export_files_match_jax(what, carried, tmp_path):
    """Each export of the carried state: byte-equal, or token-equal with the
    printed floats within 1e-6."""
    ms_j, traj_j, ms_t, traj_t = carried
    jd, td = tmp_path / "j", tmp_path / "t"
    jd.mkdir()
    td.mkdir()
    files = ["out.txt"]
    if what in ("tsv", "tsv_aligned"):
        kw = {} if what == "tsv" else {"align_first_kf": np.asarray(ms_j.kf.Tcw[0])}
        j_export.save_trajectory_tsv(str(jd / "out.txt"), traj_j, "SLAM", **kw)
        export.save_trajectory_tsv(str(td / "out.txt"), traj_t, "SLAM", **kw)
    elif what == "tum":
        j_export.save_trajectory_tum(str(jd / "out.txt"), traj_j)
        export.save_trajectory_tum(str(td / "out.txt"), traj_t)
    elif what == "colmap":
        j_export.export_colmap(str(jd), ms_j, J_SMALL_CAM, "SLAM")
        export.export_colmap(str(td), ms_t, SMALL_CAM, "SLAM")
        files = ["SLAM/cameras.txt", "SLAM/images.txt", "SLAM/points3D.txt"]
    elif what == "agisoft":
        j_export.save_keyframes_agisoft(str(jd / "out.txt"), ms_j, J_SMALL_CAM)
        export.save_keyframes_agisoft(str(td / "out.txt"), ms_t, SMALL_CAM)
    else:
        j_export.save_map_points_tsv(str(jd / "out.txt"), ms_j)
        export.save_map_points_tsv(str(td / "out.txt"), ms_t)
    for f in files:
        a, b = (td / f).read_text(), (jd / f).read_text()
        assert len(b.splitlines()) >= 1 and a.count("\n") == b.count("\n")
        _same_text(a.replace(">", "> ").replace("<", " <"),
                   b.replace(">", "> ").replace("<", " <"))
    if what == "points":
        assert (td / "out.txt").read_bytes() == (jd / "out.txt").read_bytes()


def _assert_same_state(ms_t, ms_j):
    got, want = interop.map_state_to_numpy(ms_t), tree_np(ms_j)
    for part in ("kf", "lm", "maps"):
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype and got[part][k].tobytes() == v.tobytes(), k
    for k in ("covis", "next_kf", "next_lm"):
        assert got[k].tobytes() == want[k].tobytes()


def test_map_file_passes_between_packages(carried, tmp_path):
    """A map written by the JAX package loads in the port, and the port's
    file of it loads in the JAX package: every array bit for bit, and the
    two files hold the same keys and dtypes."""
    ms_j, _, _, _ = carried
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_export.save_map_state(pj, ms_j)
    ms_t = export.load_map_state(pj, "cpu")
    assert ms_t.kf.desc.dtype == torch.int32
    _assert_same_state(ms_t, ms_j)
    export.save_map_state(pt, ms_t)
    zj, zt = np.load(pj), np.load(pt)
    assert set(zj.files) == set(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype and zj[k].tobytes() == zt[k].tobytes(), k
    _assert_same_state(ms_t, j_export.load_map_state(pt))


def _tracker_fields(t):
    return (t.state.value, t.ref_kf, t.last_ref_kf, t.last_kf_frame_id, t.n_frames,
            t.postinit_left, t.frames_since_reloc, t.mapper.kf_count)


def test_checkpoint_passes_between_packages(carried, tmp_path):
    """A checkpoint written by the JAX package's tracker restores the port's
    (map, trajectory, sensors, the last frame, the host state, the System's
    counters), and the port's file of it restores a JAX tracker: all equal
    bit for bit."""
    ms_j, traj_j, _, _ = carried
    jt = j_tracker.Tracker(cam=J_SMALL_CAM, caps=j_tracker.MapCaps(K=4, L=32, F=16, O=4))
    jt.ms, jt.traj = ms_j, traj_j
    jt.state = j_tracker.State.NORMAL
    jt.last_Tcw = np.asarray(traj_j.Tcw[1])
    jt.last_Tcr = np.asarray(traj_j.Tcr[1])
    jt.ref_kf, jt.last_ref_kf, jt.last_kf_frame_id, jt.n_frames = 0, 0, 3, 5
    jt.postinit_left, jt.frames_since_reloc, jt.mapper.kf_count = 2, 17, 4
    from hyslam_tpu.core.frame import FrameFeatures as JFF
    jt.last_feats = JFF(uv=ms_j.kf.uv[0], ur=ms_j.kf.ur[0], depth=ms_j.kf.depth[0],
                        level=ms_j.kf.level[0], angle=ms_j.kf.angle[0],
                        desc=ms_j.kf.desc[0], valid=ms_j.kf.kp_valid[0])
    jt.last_lm_id = ms_j.kf.lm_id[0]
    pj, pt = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    j_export.save_checkpoint(pj, jt, system_scalars=(6, 1))

    tt = tracker.Tracker(cam=SMALL_CAM, caps=MapCaps(K=4, L=32, F=16, O=4), device="cpu")
    assert [int(x) for x in export.load_checkpoint(pj, tt)] == [6, 1]
    _assert_same_state(tt.ms, ms_j)
    assert _tracker_fields(tt) == _tracker_fields(jt) and tt.state == tracker.State.NORMAL
    assert tt.last_Tcw.numpy().tobytes() == jt.last_Tcw.tobytes()
    assert tt.last_feats.desc.dtype == torch.int32 and not tt._has_priors
    for k, v in tree_np(traj_j).items():
        assert interop.trajectory_to_numpy(tt.traj)[k].tobytes() == v.tobytes(), k

    export.save_checkpoint(pt, tt, system_scalars=(6, 1))
    zj, zt = np.load(pj), np.load(pt)
    assert set(zj.files) == set(zt.files)
    for k in zj.files:
        assert zj[k].dtype == zt[k].dtype and zj[k].tobytes() == zt[k].tobytes(), k
    jt2 = j_tracker.Tracker(cam=J_SMALL_CAM, caps=j_tracker.MapCaps(K=4, L=32, F=16, O=4))
    assert [int(x) for x in j_export.load_checkpoint(pt, jt2)] == [6, 1]
    assert _tracker_fields(jt2) == _tracker_fields(jt)
    _assert_same_state(tt.ms, jt2.ms)
    np.testing.assert_array_equal(np.asarray(jt2.last_feats.desc), np.asarray(jt.last_feats.desc))
    np.testing.assert_array_equal(np.asarray(jt2.sensors.quat), np.asarray(jt.sensors.quat))

    # a file with a sensor reading: the async loop's host-known flag is set
    # and the arena carries the reading, which build_pose_priors sees
    from hyslam_tpu_torch.io.config import OptimizerInfo
    from hyslam_tpu_torch.slam.sensor_fusion import build_pose_priors
    jt.sensors = jt.sensors._replace(depth_valid=jt.sensors.depth_valid.at[0].set(True),
                                     depth=jt.sensors.depth.at[0].set(-1.5))
    j_export.save_checkpoint(pj, jt)
    assert export.load_checkpoint(pj, tt) is None and tt._has_priors
    assert tt.mapper.kf_count == 4
    assert tt.sensors.depth_valid.tolist() == [True, False, False, False]
    pr = build_pose_priors(tt.ms, tt.sensors, OptimizerInfo(depth_info=2.0))
    assert pr.depth_valid.tolist() == [True, False, False, False]
    assert float(pr.depth[0]) == -1.5 and float(pr.depth_info[0]) == 2.0
