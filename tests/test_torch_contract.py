"""The PyTorch port's own contract: it loads without JAX, its constant
tables are the JAX package's bit for bit, state crosses between the two
packages unchanged, and on the CPU nothing builds or launches a kernel."""

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
    args = [torch.zeros(B, 4, 4), torch.zeros(B, N, 3), torch.zeros(B, N, 2)] + [
        torch.zeros(B, N) for _ in range(4)]
    before = pose_optimization_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        pose_optimization_cuda(SMALL_CAM, *args)
    with pytest.raises(ValueError, match="N <= 1024"):
        pose_optimization_cuda(SMALL_CAM, torch.zeros(1, 4, 4), torch.zeros(1, 1025, 3),
                               *args[2:])
    assert pose_optimization_cuda.launches == before


def test_kernel_build_is_keyed_and_ignored():
    """The library goes under build/ (which .gitignore lists), in a folder
    named by a hash of the sources and flags."""
    d = kernels.build_dir()
    assert d.parent == REPO / "build" / "hyslam_tpu_torch" and len(d.name) == 16
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert [p.name for p in kernels._sources()] == ["pose_opt.cu"]


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


def _jax_tracker_state():
    """A JAX-package map state and trajectory with keyframes, landmarks,
    culled flags and the high descriptor bit set."""
    from hyslam_tpu.core import mapstate as JM
    from hyslam_tpu.core import trajectory as JT
    from hyslam_tpu.geometry import se3 as jse3

    rng = np.random.default_rng(11)
    F = 16
    desc = rng.integers(0, 2**32, (F, 8), dtype=np.uint32)
    desc[0] = 0xFFFFFFFF
    from hyslam_tpu.core.frame import FrameFeatures as JFF
    f = JFF(uv=jnp.asarray(rng.uniform(0, 300, (F, 2)).astype(np.float32)),
            ur=jnp.full((F,), 5.0), depth=jnp.asarray(rng.uniform(1, 9, F).astype(np.float32)),
            level=jnp.zeros(F, jnp.int32), angle=jnp.zeros(F), desc=jnp.asarray(desc),
            valid=jnp.ones(F, bool))
    ms = JM.empty_map_state(JM.MapCaps(K=4, L=32, F=F, O=4))
    ms, k = JM.add_keyframe(ms, f, jse3.identity(), 0.5, 3, 0, jnp.full(F, -1, jnp.int32),
                            origin=True)
    ms, _ = JM.add_landmarks(ms, jnp.asarray(rng.normal(0, 5, (F, 3)).astype(np.float32)),
                             f.desc, k, jnp.arange(F, dtype=jnp.int32), jnp.arange(F) < 9)
    ms = JM.update_landmark_stats(JM.refresh_covisibility(ms))
    ms = JM.set_landmarks_bad(ms, jnp.arange(32) == 2)
    traj = JT.append(JT.empty_trajectory(8), 0.5, jse3.exp(jnp.full(6, 0.1)), 0,
                     jse3.identity(), True)
    return ms, traj


def test_interop_roundtrips_map_state_and_trajectory():
    """A JAX-package MapState and Trajectory to the port and back: every
    field unchanged, bit for bit, descriptors as uint32 again."""
    from port_helpers import tree_np

    ms_j, traj_j = _jax_tracker_state()
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
    NotImplementedError and names its ROADMAP step; none falls back."""
    from hyslam_tpu_torch.core.mapstate import MapCaps
    from hyslam_tpu_torch.core.sensordata import empty_sensor_arena
    from hyslam_tpu_torch.slam import mapper, tracker
    from hyslam_tpu_torch.slam.tracking_params import NormalStateParams, TrackingParams
    from hyslam_tpu_torch.solver import ba

    caps = MapCaps(K=4, L=64, F=16, O=4)
    with pytest.raises(NotImplementedError, match="step 13"):
        tracker.Tracker(cam=SMALL_CAM, caps=caps, is_mono=True)
    with pytest.raises(NotImplementedError, match="step 16"):
        tracker.Tracker(cam=SMALL_CAM, caps=caps, reset_interval=15)
    with pytest.raises(NotImplementedError, match="step 16"):
        tracker.Tracker(cam=SMALL_CAM, caps=caps, params=TrackingParams(
            normal=NormalStateParams(reset_interval=15)))
    tr = tracker.Tracker(cam=SMALL_CAM, caps=caps)
    from hyslam_tpu_torch.core.frame import empty_features
    with pytest.raises(NotImplementedError, match="step 16"):
        tr.track(empty_features(16), 0.0, 0, sensor_data=object())
    for state, step in ((tracker.State.REINITIALIZE, "step 16"),
                        (tracker.State.RELOCALIZE, "step 14")):
        tr.state = state
        with pytest.raises(NotImplementedError, match=step):
            tr.track(empty_features(16), 0.0, 0)
    with pytest.raises(NotImplementedError, match="step 16"):
        tr._lose_tracking()
    assert tr.state == tracker.State.REINITIALIZE

    K, L, O = 3, 4, 2
    prob = ba.BAProblem(
        kf_Tcw=torch.eye(4).repeat(K, 1, 1), kf_fixed=torch.zeros(K, dtype=torch.bool),
        cams=ba.CamArrays(*(torch.ones(K) for _ in range(5))), lm_pos=torch.ones(L, 3),
        lm_valid=torch.ones(L, dtype=torch.bool),
        obs=ba.BAObservations(torch.zeros(L, O, dtype=torch.int32), torch.zeros(L, O, 2),
                              torch.zeros(L, O), torch.ones(L, O),
                              torch.zeros(L, O, dtype=torch.bool),
                              torch.ones(L, O, dtype=torch.bool)))
    with pytest.raises(NotImplementedError, match="step 15"):
        ba.bundle_adjustment(prob, solver="cg")
    big = prob._replace(kf_Tcw=torch.eye(4).repeat(512, 1, 1))
    with pytest.raises(NotImplementedError, match="step 15"):
        ba.bundle_adjustment(big, solver="auto")
    with pytest.raises(NotImplementedError, match="step 16"):
        ba.bundle_adjustment(prob._replace(priors=object()))

    from hyslam_tpu_torch.core.mapstate import empty_map_state
    ms = empty_map_state(caps)
    sensors = empty_sensor_arena(4)
    sensors = sensors._replace(gps_valid=torch.tensor([True, False, False, False]))
    m = mapper.Mapper(SMALL_CAM)
    m.kf_count = 3
    with pytest.raises(NotImplementedError, match="step 16"):
        m.integrate_keyframe(ms, 0, sensors=sensors)
    ms = ms._replace(maps=ms.maps._replace(registered=torch.ones_like(ms.maps.registered)))
    with pytest.raises(NotImplementedError, match="step 16"):
        m.integrate_keyframe(ms, 0)
