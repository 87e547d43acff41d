"""The PyTorch port's own contract: it loads without JAX, its constant
tables are the JAX package's bit for bit, state crosses between the two
packages unchanged, and on the CPU nothing builds or launches a kernel."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.ops import orb as j_orb
from hyslam_tpu_torch import interop, kernels
from hyslam_tpu_torch.ops import orb
from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
from hyslam_tpu_torch.solver.pose_opt import pose_optimization_fast
from hyslam_tpu_torch.utils import synth

import helpers
from port_helpers import J_SMALL_CAM, SMALL_CAM, bits, feats_to_jax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SLICE_MODULES = [
    "hyslam_tpu_torch", "hyslam_tpu_torch.device", "hyslam_tpu_torch.interop",
    "hyslam_tpu_torch.kernels", "hyslam_tpu_torch.core.frame",
    "hyslam_tpu_torch.geometry.so3", "hyslam_tpu_torch.geometry.se3",
    "hyslam_tpu_torch.geometry.camera", "hyslam_tpu_torch.features.extractor",
    "hyslam_tpu_torch.features.atlas", "hyslam_tpu_torch.features.matcher",
    "hyslam_tpu_torch.ops.pyramid", "hyslam_tpu_torch.ops.hamming",
    "hyslam_tpu_torch.ops.fast", "hyslam_tpu_torch.ops.orb",
    "hyslam_tpu_torch.ops.stereo", "hyslam_tpu_torch.ops.pose_opt_cuda",
    "hyslam_tpu_torch.solver.robust", "hyslam_tpu_torch.solver.residuals",
    "hyslam_tpu_torch.solver.pose_opt", "hyslam_tpu_torch.slam.frontend",
    "hyslam_tpu_torch.utils.synth", "hyslam_tpu_torch.ops.indexing",
    "hyslam_tpu_torch.geometry.triangulation", "hyslam_tpu_torch.core.mapstate",
    "hyslam_tpu_torch.core.trajectory", "hyslam_tpu_torch.core.sensordata",
    "hyslam_tpu_torch.solver.ba", "hyslam_tpu_torch.slam.keyframe_policy",
    "hyslam_tpu_torch.slam.tracking_params", "hyslam_tpu_torch.slam.initializers",
    "hyslam_tpu_torch.slam.localmap", "hyslam_tpu_torch.slam.strategies",
    "hyslam_tpu_torch.slam.mapper", "hyslam_tpu_torch.slam.tracker",
    "hyslam_tpu_torch.geometry.horn", "hyslam_tpu_torch.geometry.sim3",
    "hyslam_tpu_torch.features.factory", "hyslam_tpu_torch.io.config",
    "hyslam_tpu_torch.io.datasets", "hyslam_tpu_torch.io.evaluate",
    "hyslam_tpu_torch.io.export", "hyslam_tpu_torch.utils.telemetry",
    "hyslam_tpu_torch.slam.system", "hyslam_tpu_torch.solver.priors",
    "hyslam_tpu_torch.slam.sensor_fusion", "hyslam_tpu_torch.estimators",
    "hyslam_tpu_torch.estimators.two_view", "hyslam_tpu_torch.estimators.pnp",
    "hyslam_tpu_torch.slam.mono_init", "hyslam_tpu_torch.slam.relocalization",
    "hyslam_tpu_torch.slam.global_ba", "hyslam_tpu_torch.features.bow",
    "hyslam_tpu_torch.features.vocab_io", "hyslam_tpu_torch.estimators.sim3_solver",
    "hyslam_tpu_torch.solver.sim3_opt", "hyslam_tpu_torch.solver.pose_graph",
    "hyslam_tpu_torch.slam.loop_closing", "hyslam_tpu_torch.runtime.native",
    "hyslam_tpu_torch.runtime.pipeline", "hyslam_tpu_torch.viz.draw2d",
    "hyslam_tpu_torch.viz.frame_drawer", "hyslam_tpu_torch.viz.map_drawer",
    "hyslam_tpu_torch.viz.viewer", "hyslam_tpu_torch.viz", "hyslam_tpu_torch.parallel",
    "hyslam_tpu_torch.parallel.mesh", "hyslam_tpu_torch.parallel.launch",
    "hyslam_tpu_torch.parallel.dist_ba", "hyslam_tpu_torch.parallel.dist_pose_graph",
    "hyslam_tpu_torch.parallel.multicam",
]


def _run(code: str, cwd=REPO) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    """Importing every slice module in a fresh interpreter leaves jax and
    the JAX package out of sys.modules, and sets TF32 off."""
    code = (
        "import importlib, sys, torch\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'hyslam_tpu.'))"
        " or m == 'hyslam_tpu']\n"
        "assert not bad, bad\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_system_imports_and_runs_without_yaml_and_pil(tmp_path):
    """Where ``yaml`` and ``PIL`` cannot be imported the System still loads,
    builds from a SystemConfig made in code, and reads PGM files; only
    ``load_config`` needs yaml."""
    synth.write_pgm(str(tmp_path / "a.pgm"), np.arange(12.0).reshape(3, 4))
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None; sys.modules['PIL'] = None\n"
        "from hyslam_tpu_torch.io.config import CameraConfig, SystemConfig, load_config\n"
        "from hyslam_tpu_torch.io.datasets import _imread_gray\n"
        "from hyslam_tpu_torch.slam.system import System\n"
        "s = System(SystemConfig(cameras={'SLAM': CameraConfig(bf=45.0)},\n"
        "                        enable_loop_closing=False, device='cpu'))\n"
        f"assert _imread_gray({str(tmp_path / 'a.pgm')!r}).tolist()[2] == [8.0, 9.0, 10.0, 11.0]\n"
        "try:\n"
        "    load_config('config/sample_config.yaml')\n"
        "except ImportError:\n"
        "    print('ok')\n"
    )
    proc = _run(code)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_orb_tables_equal_jax_bit_for_bit():
    assert orb.PATTERN.dtype == j_orb.PATTERN.dtype
    np.testing.assert_array_equal(orb.PATTERN, j_orb.PATTERN)
    assert orb._W48.tobytes() == j_orb._W48.tobytes()
    np.testing.assert_array_equal(orb._blur_taps(), j_orb._blur_taps())
    # the gathered sample pairs, written back as +/-1 selection columns,
    # are the JAX package's steering matrices
    sel = j_orb._SEL_NP
    recon = np.zeros_like(sel)
    b = np.arange(orb.N_ROT_BINS)[:, None]
    s = np.arange(orb.PATTERN_BITS)[None, :]
    np.add.at(recon, (b, orb._SEL_PLUS, s), 1.0)
    np.add.at(recon, (b, orb._SEL_MINUS, s), -1.0)
    assert recon.tobytes() == sel.tobytes()


def test_interop_roundtrips_features():
    """A JAX-package FrameFeatures (with the high descriptor bit set) to the
    port and back: every field and every descriptor bit unchanged."""
    from hyslam_tpu.core.frame import FrameFeatures as JFF

    rng = np.random.default_rng(7)
    F = 64
    desc = rng.integers(0, 2**32, (2, F, 8), dtype=np.uint32)
    desc[:, 0] = 0xFFFFFFFF
    jf = JFF(uv=jnp.asarray(rng.uniform(0, 300, (2, F, 2)).astype(np.float32)),
             ur=jnp.full((2, F), -1.0), depth=jnp.asarray(rng.uniform(1, 9, (2, F))),
             level=jnp.asarray(rng.integers(0, 8, (2, F)).astype(np.int32)),
             angle=jnp.asarray(rng.uniform(-3, 3, (2, F)).astype(np.float32)),
             desc=jnp.asarray(desc), valid=jnp.asarray(rng.uniform(size=(2, F)) < 0.7))
    tf = interop.features_from_numpy(jax.tree.map(np.asarray, jf))
    assert tf.desc.dtype == torch.int32 and tf.capacity == F
    np.testing.assert_array_equal(bits(tf.desc.numpy()), bits(desc))
    back = feats_to_jax(tf)
    for a, b in zip(back, jf):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert interop.camera_from(J_SMALL_CAM) == SMALL_CAM
    from hyslam_tpu.features.extractor import ExtractorConfig as JCfg
    assert tuple(interop.extractor_config_from(JCfg(n_features=300))) == tuple(JCfg(n_features=300))
    table = synth.seed_landmarks(SMALL_CAM, np.eye(4), np.asarray(jf.uv[0]),
                                 np.asarray(jf.depth[0]), np.asarray(jf.level[0]),
                                 desc[0], np.asarray(jf.valid[0]), 80)
    back_t = interop.landmarks_to_numpy(interop.landmarks_from_numpy(**table))
    for k, v in table.items():
        np.testing.assert_array_equal(back_t[k], v)


def test_fast_solver_on_cpu_builds_and_launches_nothing(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU call reached the kernel build")

    monkeypatch.setattr(kernels, "build", no_build)
    monkeypatch.setattr(kernels, "load", no_build)
    before = pose_optimization_cuda.launches
    rng = np.random.default_rng(8)
    n = 64
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                  rng.uniform(3, 8, n)], -1).astype(np.float32)
    uv = (X[:, :2] / X[:, 2:] * 300 + [160, 120]).astype(np.float32)
    ur = (uv[:, 0] - 30 / X[:, 2]).astype(np.float32)
    ones = torch.ones(n, dtype=torch.bool)
    res = pose_optimization_fast(SMALL_CAM, torch.eye(4), torch.from_numpy(X),
                                 torch.from_numpy(uv), torch.from_numpy(ur),
                                 torch.ones(n), ones, ones)
    assert pose_optimization_cuda.launches == before
    assert int(res.num_inliers) == n
    assert not list(kernels.BUILD_ROOT.glob("*/*.tmp"))


def test_cuda_wrapper_raises_on_cpu_tensors():
    B, N = 1, 8
    args = [torch.zeros(B, 4, 4), torch.zeros(B, N, 3), torch.zeros(B, N, 2),
            torch.zeros(B, N), torch.zeros(B, N),
            torch.zeros(B, N, dtype=torch.bool), torch.zeros(B, N, dtype=torch.bool)]
    before = pose_optimization_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        pose_optimization_cuda(SMALL_CAM, *args)
    with pytest.raises(ValueError, match="N <= 4096"):
        pose_optimization_cuda(SMALL_CAM, torch.zeros(1, 4, 4), torch.zeros(1, 4097, 3),
                               *args[2:])
    # N = 4096 passes the size check and every shape check, and is refused
    # only for lying on the CPU
    N = 4096
    big = [torch.zeros(B, 4, 4), torch.zeros(B, N, 3), torch.zeros(B, N, 2),
           torch.zeros(B, N), torch.zeros(B, N),
           torch.zeros(B, N, dtype=torch.bool), torch.zeros(B, N, dtype=torch.bool)]
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        pose_optimization_cuda(SMALL_CAM, *big)
    assert pose_optimization_cuda.launches == before


@pytest.mark.parametrize("mask", ["valid", "stereo"])
def test_cuda_wrapper_wants_bool_masks(mask, monkeypatch):
    """The kernel reads the masks as bytes of torch.bool storage: a 0/1
    float mask is refused before anything is built or launched."""
    def no_build(*a, **k):
        raise AssertionError("a refused call reached the kernel build")

    monkeypatch.setattr(kernels, "load", no_build)
    B, N = 2, 8
    kw = dict(Tcw0=torch.zeros(B, 4, 4), X=torch.zeros(B, N, 3), uv=torch.zeros(B, N, 2),
              ur=torch.zeros(B, N), inv_sigma2=torch.zeros(B, N),
              valid=torch.zeros(B, N, dtype=torch.bool),
              stereo=torch.zeros(B, N, dtype=torch.bool))
    kw[mask] = torch.zeros(B, N)
    before = pose_optimization_cuda.launches
    with pytest.raises(ValueError, match=f"{mask}: expected torch.bool"):
        pose_optimization_cuda(SMALL_CAM, **kw)
    assert pose_optimization_cuda.launches == before


def test_tracker_defaults_to_the_card():
    """An entry point given no device runs on the card or raises; it never
    carries on on the CPU. The CPU is asked for by name."""
    from hyslam_tpu_torch import device
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.slam import tracker

    caps = MapCaps(K=4, L=64, F=16, O=4)
    if torch.cuda.is_available():
        assert device.default_device().type == "cuda"
        assert tracker.Tracker(cam=SMALL_CAM, caps=caps).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA device"):
            device.default_device()
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tracker.Tracker(cam=SMALL_CAM, caps=caps)
    tr = tracker.Tracker(cam=SMALL_CAM, caps=caps, device="cpu")
    assert tr.device == torch.device("cpu")
    assert tr.ms.lm.pos.device.type == "cpu" and tr.traj.Tcw.device.type == "cpu"


def test_load_map_state_defaults_to_the_card(tmp_path, monkeypatch):
    """load_map_state(path) with no device puts the map on
    device.default_device() (the card; monkeypatched here to the meta
    device, which the CPU has), as the JAX package puts it on its default
    device; device="cpu" still gives the CPU."""
    from hyslam_tpu_torch import device
    from hyslam_tpu_torch.core.mapstate import MapCaps, empty_map_state
    from hyslam_tpu_torch.io import export

    path = str(tmp_path / "map.npz")
    export.save_map_state(path, empty_map_state(MapCaps(K=4, L=16, F=8, O=2), device="cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            export.load_map_state(path)
    monkeypatch.setattr(device, "default_device", lambda: torch.device("meta"))
    ms = export.load_map_state(path)
    assert ms.kf.Tcw.device.type == "meta" and ms.lm.pos.device.type == "meta"
    assert ms.covis.device.type == "meta"
    ms = export.load_map_state(path, device="cpu")
    assert ms.kf.Tcw.device.type == "cpu" and ms.lm.pos.device.type == "cpu"


def test_the_port_runs_deterministic_algorithms():
    """Loading the package switches on PyTorch's deterministic algorithms
    (warn only, fresh memory not filled), so a run on the card is the same
    run every time."""
    from torch.utils import deterministic

    assert torch.are_deterministic_algorithms_enabled()
    assert torch.is_deterministic_algorithms_warn_only_enabled()
    assert not deterministic.fill_uninitialized_memory


def test_kernel_build_is_keyed_and_ignored():
    """The library goes under build/ (which .gitignore lists), in a folder
    named by a hash of the sources and flags."""
    d = kernels.build_dir()
    assert d.parent == REPO / "build" / "hyslam_tpu_torch" and len(d.name) == 16
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert [p.name for p in kernels._sources()] == [
        "covisibility.cu", "landmark_stats.cu", "pose_opt.cu"]


def test_numpy_renderer_matches_helpers():
    """utils/synth is the numpy twin of tests/helpers.py: the rendered image
    within 1e-3, the same draws and poses."""
    rng = np.random.default_rng(9)
    pts = helpers.make_world(rng, 200, extent=(4.0, 3.0, 10.0), z_min=3.0)
    T = helpers.make_trajectory(4, step=0.1, yaw_rate=0.02)[3]
    img_j, uv_j, vis_j = helpers.render_world(J_SMALL_CAM, T, pts)
    img_t, uv_t, vis_t = synth.render_world(SMALL_CAM, T, pts)
    np.testing.assert_allclose(img_t, img_j, atol=1e-3)
    np.testing.assert_array_equal(vis_t, vis_j)
    np.testing.assert_allclose(uv_t, uv_j, atol=1e-3)
    np.testing.assert_allclose(synth.make_trajectory(4, step=0.1, yaw_rate=0.02),
                               helpers.make_trajectory(4, step=0.1, yaw_rate=0.02),
                               atol=1e-6)
    np.testing.assert_array_equal(synth.make_world(np.random.default_rng(1), 50),
                                  helpers.make_world(np.random.default_rng(1), 50))
    o_t = synth.observe(SMALL_CAM, T, pts, rng=np.random.default_rng(2), stereo_frac=0.5)
    o_j = helpers.observe(J_SMALL_CAM, T, pts, rng=np.random.default_rng(2), stereo_frac=0.5)
    for a, b in zip(o_t, o_j):
        np.testing.assert_allclose(a, b, atol=1e-3)
    Tp_t = synth.perturb_pose(np.random.default_rng(3), T)
    Tp_j = helpers.perturb_pose(np.random.default_rng(3), T)
    np.testing.assert_allclose(Tp_t, Tp_j, atol=1e-5)
    np.testing.assert_allclose(synth.pose_error(Tp_t, T), helpers.pose_error(Tp_j, T),
                               rtol=1e-3, atol=1e-5)


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA card the chip check exits non-zero and prints no
    result, from the repository and from a folder holding only itself."""
    script = (REPO / "chip_smoke.py").read_text()
    (tmp_path / "chip_smoke.py").write_text(script)
    for cwd in (REPO, tmp_path):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["CUDA_VISIBLE_DEVICES"] = ""
        proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_interop_roundtrips_map_state_and_trajectory():
    """A JAX-package MapState and Trajectory to the port and back: every
    field unchanged, bit for bit, descriptors as uint32 again."""
    from port_helpers import jax_tracker_state, tree_np

    ms_j, traj_j = jax_tracker_state()
    ms_t = interop.map_state_from_numpy(jax.tree.map(np.asarray, ms_j))
    assert ms_t.kf.desc.dtype == torch.int32 and ms_t.lm.valid.dtype == torch.bool
    back = interop.map_state_to_numpy(ms_t)
    want = tree_np(ms_j)
    for part in ("kf", "lm", "maps"):
        for k, v in want[part].items():
            assert back[part][k].dtype == v.dtype, (part, k)
            assert back[part][k].tobytes() == v.tobytes(), (part, k)
    for k in ("covis", "next_kf", "next_lm"):
        assert back[k].tobytes() == want[k].tobytes()
    # and back in from the port's own dict
    again = interop.map_state_to_numpy(interop.map_state_from_numpy(back))
    assert tree_np(again)["lm"]["desc"].tobytes() == want["lm"]["desc"].tobytes()
    traj_t = interop.trajectory_from_numpy(jax.tree.map(np.asarray, traj_j))
    tb = interop.trajectory_to_numpy(traj_t)
    for k, v in tree_np(traj_j).items():
        assert tb[k].dtype == v.dtype and tb[k].tobytes() == v.tobytes(), k


def test_unported_paths_raise():
    """Every state, flag and solver path that is not ported raises
    NotImplementedError and names its ROADMAP step; none falls back. What
    loss recovery and sensor fusion brought no longer raises: forced-loss
    injection, sensor readings, REINITIALIZE, the CG solve, pose priors;
    nor what the monocular camera brought: a monocular tracker, RELOCALIZE,
    which ranks its candidates through a BoW recognizer as the JAX package
    does where it has one."""
    from hyslam_tpu_torch.core.frame import empty_features
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.core.sensordata import SensorData
    from hyslam_tpu_torch.slam import tracker
    from hyslam_tpu_torch.slam.tracking_params import NormalStateParams, TrackingParams
    from hyslam_tpu_torch.solver import ba, priors

    caps = MapCaps(K=4, L=64, F=16, O=4)
    mono = tracker.Tracker(cam=SMALL_CAM, caps=caps, is_mono=True, device="cpu")
    assert mono.mapper.is_mono
    mono.state = tracker.State.NORMAL
    mono._lose_tracking()
    assert mono.state == tracker.State.RELOCALIZE
    # an empty map: no candidate, the frame stays in RELOCALIZE
    assert mono.track(empty_features(16), 0.0, 0).state == "RELOCALIZE"
    assert mono.reloc_log == [dict(frame_id=0, ok=False, candidates=0, pnp_solves=0,
                                   local_solves=0)]
    from hyslam_tpu.features import bow as j_bow
    from hyslam_tpu_torch.features import bow

    descs = np.random.default_rng(2).integers(0, 2**32, (200, 8), dtype=np.uint32)
    vocab = bow.train_vocabulary(descs, k=4, depth=2, device="cpu")
    mono.recognizer = bow.PlaceRecognizer(vocab, K=caps.K)
    j_rec = j_bow.PlaceRecognizer(j_bow.Vocabulary(**interop.vocabulary_to_numpy(vocab)),
                                  K=caps.K)
    for k in (0, 1):   # two keyframes indexed by both recognizers
        mono.recognizer.add_keyframe(k, interop.desc_to_torch(descs[16 * k:16 * k + 16]),
                                     torch.ones(16, dtype=torch.bool))
        j_rec.add_keyframe(k, jnp.asarray(descs[16 * k:16 * k + 16]), jnp.ones(16, bool))
    q = descs[16:32]
    covis = np.zeros((caps.K, caps.K), np.int32)
    want = j_rec.detect_relocalization_candidates(jnp.asarray(q), jnp.ones(16, bool), covis)
    assert want[0] == 1 and want == mono.recognizer.detect_relocalization_candidates(
        interop.desc_to_torch(q), torch.ones(16, dtype=torch.bool), torch.from_numpy(covis))
    # the empty map's frame: the recognizer ranks; no candidate has landmarks
    assert mono.track(empty_features(16), 0.1, 1).state == "RELOCALIZE"
    # the threaded pipeline's hook is accepted (runtime/pipeline.py sets it)
    hook = object()
    assert tracker.Tracker(cam=SMALL_CAM, caps=caps, mapping_status=hook,
                           device="cpu").mapping_status is hook
    assert tracker.Tracker(cam=SMALL_CAM, caps=caps, reset_interval=15,
                           device="cpu").reset_interval == 15
    from_params = tracker.Tracker(cam=SMALL_CAM, caps=caps, params=TrackingParams(
        normal=NormalStateParams(reset_interval=15)), device="cpu")
    assert from_params.reset_interval == 15
    # the explicit field wins over the params tree
    assert tracker.Tracker(cam=SMALL_CAM, caps=caps, reset_interval=7, params=TrackingParams(
        normal=NormalStateParams(reset_interval=15)), device="cpu").reset_interval == 7
    tr = tracker.Tracker(cam=SMALL_CAM, caps=caps, device="cpu")
    sd = SensorData(depth=1.0, depth_valid=True)
    # a featureless frame: no keyframe, so the reading is dropped
    assert tr.track(empty_features(16), 0.0, 0, sensor_data=sd).state == "INITIALIZE"
    assert not tr._has_priors and not tr.sensors.depth_valid.any()
    tr.state = tracker.State.NO_IMAGES_YET
    with pytest.raises(NotImplementedError, match="not a tracking state"):
        tr.track(empty_features(16), 0.0, 0)
    tr.state = tracker.State.NULL
    assert tr.track(empty_features(16), 0.1, 1).state == "NULL"
    tr.state = tracker.State.NORMAL
    tr._lose_tracking()
    assert tr.state == tracker.State.REINITIALIZE
    # a featureless frame in REINITIALIZE opens no sub-map
    assert tr.track(empty_features(16), 0.2, 2).state == "REINITIALIZE"
    assert int(tr.ms.maps.n_maps) == 1 and tr.state == tracker.State.REINITIALIZE

    K, L, O = 3, 4, 2
    prob = ba.BAProblem(
        kf_Tcw=torch.eye(4).repeat(K, 1, 1), kf_fixed=torch.zeros(K, dtype=torch.bool),
        cams=ba.CamArrays(*(torch.ones(K) for _ in range(5))), lm_pos=torch.ones(L, 3),
        lm_valid=torch.ones(L, dtype=torch.bool),
        obs=ba.BAObservations(torch.zeros(L, O, dtype=torch.int32), torch.zeros(L, O, 2),
                              torch.zeros(L, O), torch.ones(L, O),
                              torch.zeros(L, O, dtype=torch.bool),
                              torch.ones(L, O, dtype=torch.bool)))
    for kw in (dict(solver="cg"), dict(solver="dense"), dict(solver="auto")):
        assert bool(torch.isfinite(ba.bundle_adjustment(prob, n_iters=2, **kw).kf_Tcw).all())
    with_pr = ba.bundle_adjustment(prob._replace(priors=priors.empty_pose_priors(K, E=2)),
                                   n_iters=2)
    assert bool(torch.isfinite(with_pr.cost))
    with pytest.raises(ValueError, match="unknown solver"):
        ba.bundle_adjustment(prob, solver="lu")
    # the sharded solve: where JAX's CG takes psum_axis, the port's takes a
    # process group, and a mesh needs an initialized default group
    assert "group" in inspect.signature(ba._solve_poses_cg).parameters
    from hyslam_tpu_torch.parallel import mesh as pmesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        pmesh.make_mesh(device="cpu")
