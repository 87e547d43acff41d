"""Shared pieces of the PyTorch port's parity tests: conversions between the
JAX package and the port (through numpy), the small scene both are fed, and
the comparison measures the tests state their bounds in."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.core.frame import FrameFeatures as JFrameFeatures
from hyslam_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from hyslam_tpu.geometry.camera import Camera as JCamera
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.utils import synth

# the small sizes of tests/test_frontend.py: 320x240, 4 levels, 200
# features, capacity 256, a 512-row local map
SMALL_CAM = Camera(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320,
                   height=240, bf=30.0)
J_SMALL_CAM = JCamera(**SMALL_CAM._asdict())
CFG = ExtractorConfig(n_features=200, n_levels=4)
J_CFG = JExtractorConfig(n_features=200, n_levels=4)
F_CAP = 256
L_MAP = 512


def to_torch(x) -> torch.Tensor:
    """JAX or numpy array -> CPU tensor (uint32 -> int32 bit-view)."""
    a = np.asarray(x)
    if a.dtype == np.uint32:
        return interop.desc_to_torch(a)
    return torch.from_numpy(np.array(a))


def to_jax(x: torch.Tensor, uint32: bool = False):
    a = x.detach().cpu().numpy()
    return jnp.asarray(a.view(np.uint32) if uint32 else a)


def feats_to_torch(f):
    return interop.features_from_numpy(jax.tree.map(np.asarray, f))


def feats_to_jax(f) -> JFrameFeatures:
    return JFrameFeatures(**{k: jnp.asarray(v) for k, v in
                             interop.features_to_numpy(f).items()})


def bits(desc) -> np.ndarray:
    """[..., 8] descriptors (either dtype) -> [..., 256] 0/1 uint8."""
    a = np.asarray(desc).view(np.uint32)
    return ((a[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(
        np.uint8).reshape(a.shape[:-1] + (256,))


def angle_diff(a, b) -> np.ndarray:
    """|a - b| on the circle, so that -pi and +pi agree."""
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.minimum(d, 2 * np.pi - d)


def small_world(seed: int = 0):
    """The world of tests/test_frontend.py's slice test: 150 points."""
    rng = np.random.default_rng(seed)
    return synth.make_world(rng, 150, extent=(4.0, 3.0, 10.0), z_min=3.0)


def stereo_pair(Tcw, pts) -> np.ndarray:
    return synth.render_stereo_pair(SMALL_CAM, Tcw, pts)


def seeded_map(feats_np: dict, Tcw=None) -> dict:
    """L_MAP-row local map seeded from one frame's (numpy) features."""
    Tcw = np.eye(4) if Tcw is None else Tcw
    return synth.seed_landmarks(
        SMALL_CAM, Tcw, feats_np["uv"], feats_np["depth"], feats_np["level"],
        feats_np["desc"], feats_np["valid"], L_MAP)


def map_args_jax(table: dict) -> tuple:
    return tuple(jnp.asarray(table[k]) for k in interop.LandmarkTable._fields)


def map_args_torch(table: dict) -> interop.LandmarkTable:
    return interop.landmarks_from_numpy(
        *(table[k] for k in interop.LandmarkTable._fields))


def tree_np(x):
    """A NamedTuple / dict tree of JAX arrays or tensors -> nested dict of
    numpy arrays (descriptor fields as uint32)."""
    if isinstance(x, dict):
        return {k: tree_np(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)) and not hasattr(x, "_asdict"):
        return {str(i): tree_np(v) for i, v in enumerate(x)}
    if hasattr(x, "_asdict"):
        return {k: (np.asarray(v.detach().cpu().numpy()).view(np.uint32)
                    if k == "desc" and isinstance(v, torch.Tensor) else tree_np(v))
                for k, v in x._asdict().items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_tree_close(got, want, atol=1e-5, rtol=0.0, path=""):
    """Integer and bool leaves equal, float leaves within atol (+ rtol)."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], atol, rtol, f"{path}.{k}")
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (path, got.shape, want.shape)
    if np.issubdtype(want.dtype, np.floating):
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol, err_msg=path)
    else:
        np.testing.assert_array_equal(got.astype(want.dtype), want, err_msg=path)


def ms_to_torch(ms_j):
    return interop.map_state_from_numpy(jax.tree.map(np.asarray, ms_j))


def traj_to_torch(traj_j):
    return interop.trajectory_from_numpy(jax.tree.map(np.asarray, traj_j))


# the small system of the System-level tests: 640x360, 300 features over 4
# levels, capacity 512, MapCaps(K=32, L=4096, F=512, O=8)
SYS_CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=180.0, width=640, height=360,
                 bf=45.0)
SYS_DT = 0.1


def system_configs(async_tracking=False, **kw):
    """(the JAX package's SystemConfig, the port's on the CPU) for SYS_CAM;
    keyword arguments go to the JAX SystemConfig and are carried across."""
    from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
    from hyslam_tpu.io.config import CameraConfig as JCameraConfig
    from hyslam_tpu.io.config import SystemConfig as JSystemConfig

    c = SYS_CAM
    cc = JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width,
                       height=c.height, bf=c.bf,
                       extractor=JExtractorConfig(n_features=300, n_levels=4))
    jcfg = JSystemConfig(cameras={"SLAM": cc}, caps=JMapCaps(K=32, L=4096, F=512, O=8),
                         enable_loop_closing=False, async_tracking=async_tracking, **kw)
    return jcfg, interop.system_config_from(jcfg, device="cpu")


def system_sequence(n: int, seed: int = 0, n_points: int = 2000):
    """n poses (0.1 m forward, 0.003 rad yaw a frame), the world's points
    and the rendered stereo pairs [n,2,H,W] of tests/test_async_tracking.py's
    world, for SYS_CAM."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, n_points), rng.uniform(-6, 6, n_points),
                    rng.uniform(3, 30, n_points)], -1).astype(np.float32)
    Ts = synth.make_trajectory(n, step=0.1, yaw_rate=0.003)
    pairs = np.stack([synth.render_stereo_pair(SYS_CAM, T, pts) for T in Ts])
    return Ts, pts, pairs


def jax_tracker_state():
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


# the RANSAC sample sets of the JAX package's estimators, drawn with
# jax.random exactly as they draw them, for the port's estimators, which
# take their sets as an argument (ROADMAP queue 1, the rule for steps 13-15)

def jax_two_view_samples(valid, seed: int = 0):
    """(F sets, H sets) [256, 8] that ``two_view_reconstruct(seed=seed)``
    of the JAX package draws for the mask ``valid``."""
    from hyslam_tpu.estimators import two_view as jtv

    kF, kH = jax.random.split(jax.random.PRNGKey(seed))
    v = jnp.asarray(np.asarray(valid))
    return tuple(torch.from_numpy(np.asarray(jtv._sample_valid(k, v, jtv.N_HYPOTHESES)))
                 for k in (kF, kH))


def jax_pnp_samples(valid, seed: int = 0) -> torch.Tensor:
    """The [256, 6] sets that ``pnp_ransac`` of the JAX package draws with
    ``PRNGKey(seed)`` for the mask ``valid``."""
    from hyslam_tpu.estimators import pnp as jpnp

    v = jnp.asarray(np.asarray(valid))
    logits = jnp.where(v, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        jax.random.PRNGKey(seed),
        jnp.broadcast_to(logits, (jpnp.N_HYPOTHESES * jpnp.MIN_SET, v.shape[0])), axis=-1
    ).reshape(jpnp.N_HYPOTHESES, jpnp.MIN_SET)
    return torch.from_numpy(np.asarray(jnp.where(jnp.any(v), idx, 0)))


def jax_sim3_samples(valid, seed: int = 0) -> torch.Tensor:
    """The [128, 3] sets that ``sim3_ransac`` of the JAX package draws with
    ``PRNGKey(seed)`` (the loop closer keys it by the keyframe id)."""
    from hyslam_tpu.estimators import sim3_solver as jsim3

    v = jnp.asarray(np.asarray(valid))
    logits = jnp.where(v, 0.0, -jnp.inf)
    idx = jax.random.categorical(
        jax.random.PRNGKey(seed),
        jnp.broadcast_to(logits, (jsim3.N_HYPOTHESES * 3, v.shape[0])), axis=-1
    ).reshape(jsim3.N_HYPOTHESES, 3)
    return torch.from_numpy(np.asarray(jnp.where(jnp.any(v), idx, 0)))


def use_jax_samples(monkeypatch):
    """Make the port's estimators draw the JAX package's sample sets."""
    from hyslam_tpu_torch.estimators import pnp, sim3_solver, two_view

    monkeypatch.setattr(two_view, "sample_sets",
                        lambda valid, seed=0: jax_two_view_samples(valid.cpu(), seed))
    monkeypatch.setattr(pnp, "sample_sets",
                        lambda valid, seed=0: jax_pnp_samples(valid.cpu(), seed))
    monkeypatch.setattr(sim3_solver, "sample_sets",
                        lambda valid, seed=0: jax_sim3_samples(valid.cpu(), seed).to(valid.device))


def mono_sequence(n: int, dark=(0, 0), seed: int = 0):
    """Monocular features (no stereo) of a world that is a tilted plane and
    a cloud beside it, for both packages' Trackers, F = 512: the camera
    moves 0.12 m sideways and 0.06 m forward a frame with 0.004 rad of yaw,
    so that two frames give the two-view estimator parallax. Frames
    dark[0]..dark[1]-1 have no features. Returns (poses [n,4,4], the JAX
    package's features)."""
    from hyslam_tpu.core.frame import empty_features as j_empty_features

    from helpers import DEFAULT_CAM, synth_frame_features

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-14, 14, (2000, 2)).astype(np.float32)
    plane = np.concatenate([xy, 6.0 + 0.25 * xy[:, :1]], -1)
    cloud = np.stack([rng.uniform(4.5, 20, 1200), rng.uniform(-5, 5, 1200),
                      rng.uniform(3, 10, 1200)], -1)
    pts = np.concatenate([plane, cloud]).astype(np.float32)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    delta = synth.se3_exp([0.0, 0.004, 0.0, -0.12, 0.0, -0.06]).astype(np.float32)
    Ts, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n):
        Ts.append(T.copy())
        T = (delta @ T).astype(np.float32)
    feats = []
    for i in range(n):
        f = synth_frame_features(DEFAULT_CAM, Ts[i], pts, descs, rng, F=512)[0]
        f = f._replace(ur=jnp.full_like(f.ur, -1.0), depth=jnp.full_like(f.depth, -1.0))
        feats.append(j_empty_features(512) if dark[0] <= i < dark[1] else f)
    return np.stack(Ts), feats


def mono_images(n: int, dark=(0, 0)):
    """The left images of system_sequence(n) (0.1 m forward a frame, which
    both packages' two-view estimators initialize on after a few frames),
    frames dark[0]..dark[1]-1 flat: (poses, images [n,H,W])."""
    Ts, _, pairs = system_sequence(n)
    return Ts, synth.blackout(pairs, *dark)[:, 0]


def mono_system_configs(async_tracking=False, **kw):
    """system_configs with a monocular SYS_CAM (bf 0)."""
    import dataclasses

    jcfg, _ = system_configs(async_tracking, **kw)
    jcfg.cameras["SLAM"] = dataclasses.replace(jcfg.cameras["SLAM"], bf=0.0, mono=True)
    return jcfg, interop.system_config_from(jcfg, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Imported into a test module: one CPU thread for its tests (float
    scatter-adds then sum in one order), and the thread count it found
    restored after them. A module-level set_num_threads would set it for
    every test collected in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the feature-level circuit of the loop-closing System tests: DEFAULT_CAM
# (640x480, bf 45), F = 256, MapCaps(K=32, L=4096, F=256, O=8)
LOOP_F = 256
LOOP_DT = 0.1
LOOP_PERTURB = (0.0, 0.05, 0.0, 0.35, 0.0, 0.35)   # tests/test_longrun.py's


def loop_circuit(n_circle: int = 24, n_revisit: int = 4, dark=(6, 8), step: float = 0.6,
                 seed: int = 0):
    """A circle of n_circle frames (0.6 m forward and 2 pi / n_circle of yaw
    a frame), then n_revisit frames over its start again; 30 points from
    default_rng(seed) around each of the circle's camera centres, each with
    a random descriptor; frames dark[0]..dark[1]-1 without features. Returns
    (poses [n,4,4], the JAX package's features a frame, the descriptors)."""
    from helpers import DEFAULT_CAM, synth_frame_features

    yaw = 2 * np.pi / n_circle
    delta = synth.se3_exp([0.0, yaw, 0.0, 0.0, 0.0, -step]).astype(np.float32)
    Ts, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n_circle + n_revisit):
        Ts.append(T.copy())
        T = (delta @ T).astype(np.float32)
    rng = np.random.default_rng(seed)
    centers = np.stack([-(T[:3, :3].T @ T[:3, 3]) for T in Ts[:n_circle]])
    pts = np.concatenate([c + rng.uniform([-6, -3, -6], [6, 3, 6], size=(30, 3))
                          for c in centers]).astype(np.float32)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    feats = []
    for i, T in enumerate(Ts):
        f, _ = synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=LOOP_F)
        if dark[0] <= i < dark[1]:
            f = f._replace(valid=jnp.zeros_like(f.valid))
        feats.append(f)
    return np.stack(Ts), feats, descs


def corridor_circuit(dark=(9, 13), n_back: int = 14, seed: int = 0):
    """The async loop circuit: the camera runs 0.3 m a frame along a
    corridor of 1200 points (default_rng(seed), each with a random
    descriptor), slows down over 5 frames, and runs back at 0.3 m a frame
    over its start with the same heading; frames dark[0]..dark[1]-1 without
    features. Returns (poses, the JAX package's features a frame,
    descriptors)."""
    from helpers import DEFAULT_CAM, synth_frame_features

    vel = [0.3] * 12 + [0.2, 0.1, 0.0, -0.1, -0.2] + [-0.3] * n_back
    Ts, T = [], np.eye(4, dtype=np.float32)
    for v in vel:
        Ts.append(T.copy())
        T = (synth.se3_exp([0.0, 0.0, 0.0, 0.0, 0.0, -v]) @ T).astype(np.float32)
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-8, 8, 1200), rng.uniform(-4, 4, 1200),
                    rng.uniform(2, 25, 1200)], -1).astype(np.float32)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    feats = []
    for i, T in enumerate(Ts):
        f, _ = synth_frame_features(DEFAULT_CAM, T, pts, descs, rng, F=LOOP_F)
        if dark[0] <= i < dark[1]:
            f = f._replace(valid=jnp.zeros_like(f.valid))
        feats.append(f)
    return np.stack(Ts), feats, descs


def loop_system_configs(vocab_path: str, async_tracking=False):
    """(the JAX package's SystemConfig, the port's on the CPU) of the loop
    circuit: loop closing on (the default), the vocabulary from vocab_path."""
    from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
    from hyslam_tpu.io.config import CameraConfig as JCameraConfig
    from hyslam_tpu.io.config import SystemConfig as JSystemConfig

    from helpers import DEFAULT_CAM as c

    cc = JCameraConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height,
                       bf=c.bf)
    jcfg = JSystemConfig(cameras={"SLAM": cc}, caps=JMapCaps(K=32, L=4096, F=LOOP_F, O=8),
                         vocab_path=vocab_path, async_tracking=async_tracking)
    return jcfg, interop.system_config_from(jcfg, device="cpu")


def run_loop_circuit(sysm, feats, to_frame, perturb, flush):
    """Feed the circuit's features to a System; after the row that carries
    >REINIT_OK, move the sub-map by LOOP_PERTURB with perturb(tracker, T)
    (a bad re-initialization placement, the tiepoint re-measured to match).
    Returns the returned rows and the frame of the perturbation."""
    tracker = sysm.trackers["SLAM"]
    out, nudged = [], None
    for i, f in enumerate(feats):
        tel = sysm.track_features(to_frame(f), LOOP_DT * i, frame_id=i)
        out.append(tel)
        state = tel.state if tel is not None else (
            tracker.telemetry[-1].state if tracker.telemetry else "")
        if nudged is None and ">REINIT_OK" in state:
            perturb(tracker, synth.se3_exp(LOOP_PERTURB).astype(np.float32))
            nudged = i
    flush()
    return out, nudged


# the two-camera System of the dual-camera tests: a stereo SLAM camera and a
# monocular Imaging camera (DEFAULT_CAM's intrinsics, tests/test_dual_camera.py's
# rig), fed features, MapCaps(K=32, L=4096, F=256, O=8)
DUAL_F = 256
DUAL_DT = 0.1
DUAL_TCAM = synth.se3_exp([0.0, 0.06, 0.02, 0.15, -0.1, 0.0]).astype(np.float32)


def dual_camera_scene(n: int = 14, dark=(6, 9), yaw: float = 0.03, seed: int = 0):
    """mono_sequence's world (a tilted plane and a cloud) and motion (0.12 m
    sideways and 0.06 m forward a frame), turning by ``yaw`` rad a frame so
    that an Imaging sub-map's keyframe centres are not collinear (on a
    straight path the JAX package's Horn alignment leaves the rotation
    about the path to its eigensolver). Frames dark[0]..dark[1]-1 have no
    features in either camera. Returns (SLAM poses [n,4,4], SLAM features,
    Imaging features), the features the JAX package's."""
    from hyslam_tpu.core.frame import empty_features as j_empty_features

    from helpers import DEFAULT_CAM, synth_frame_features

    rng = np.random.default_rng(seed)
    xy = rng.uniform(-14, 14, (2000, 2)).astype(np.float32)
    plane = np.concatenate([xy, 6.0 + 0.25 * xy[:, :1]], -1)
    cloud = np.stack([rng.uniform(4.5, 20, 1200), rng.uniform(-5, 5, 1200),
                      rng.uniform(3, 10, 1200)], -1)
    pts = np.concatenate([plane, cloud]).astype(np.float32)
    descs = rng.integers(0, 2**32, (len(pts), 8), dtype=np.uint32)
    delta = synth.se3_exp([0.0, yaw, 0.0, -0.12, 0.0, -0.06]).astype(np.float32)
    Ts, T = [], np.eye(4, dtype=np.float32)
    for _ in range(n):
        Ts.append(T.copy())
        T = (delta @ T).astype(np.float32)
    slam, img = [], []
    for i in range(n):
        if dark[0] <= i < dark[1]:
            slam.append(j_empty_features(DUAL_F))
            img.append(j_empty_features(DUAL_F))
            continue
        slam.append(synth_frame_features(DEFAULT_CAM, Ts[i], pts, descs, rng, F=DUAL_F)[0])
        f = synth_frame_features(DEFAULT_CAM, (DUAL_TCAM @ Ts[i]).astype(np.float32), pts,
                                 descs, rng, F=DUAL_F)[0]
        img.append(f._replace(ur=jnp.full_like(f.ur, -1.0), depth=jnp.full_like(f.depth, -1.0)))
    return np.stack(Ts), slam, img


def dual_system_configs(async_tracking=False):
    """(the JAX package's SystemConfig, the port's on the CPU) of the
    two-camera System; the Imaging camera makes a keyframe at least every
    3rd frame (tests/test_dual_camera.py's policy is 4)."""
    from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
    from hyslam_tpu.io.config import CameraConfig as JCameraConfig
    from hyslam_tpu.io.config import SystemConfig as JSystemConfig
    from hyslam_tpu.slam.keyframe_policy import KeyFramePolicyParams as JPolicy

    from helpers import DEFAULT_CAM as c

    intr = dict(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, width=c.width, height=c.height)
    jcfg = JSystemConfig(
        cameras={"SLAM": JCameraConfig(bf=c.bf, **intr),
                 "Imaging": JCameraConfig(mono=True, Tcam=DUAL_TCAM.tolist(),
                                          policy=JPolicy(max_kf_interval=3), **intr)},
        caps=JMapCaps(K=32, L=4096, F=DUAL_F, O=8), enable_loop_closing=False,
        async_tracking=async_tracking, commit_lag=2)
    return jcfg, interop.system_config_from(jcfg, device="cpu")


def run_dual(sysm, slam_feats, img_feats, to_features=lambda f: f, tmp=None):
    """Both cameras' frames through a System, the Imaging frame after the
    SLAM frame of the same time, ``place_imaging_frame`` on every frame
    where SLAM tracks; then ``flush`` and ``run_imaging_bundle_adjustment``
    (and the exports into ``tmp``). Returns what the tests compare, as
    numpy."""
    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    states, keeps = [], []
    for i, (fs, fi) in enumerate(zip(slam_feats, img_feats)):
        sysm.track_features(to_features(fs), DUAL_DT * i, camera="SLAM", frame_id=i)
        sysm.track_features(to_features(fi), DUAL_DT * i, camera="Imaging", frame_id=i)
        states.append((sysm.trackers["SLAM"].state.name, sysm.trackers["Imaging"].state.name))
        if states[-1][0] in ("NORMAL", "POSTINIT"):
            keeps.append(bool(sysm.place_imaging_frame(DUAL_DT * i)[0]))
    sysm.flush()
    it = sysm.trackers["Imaging"]
    n_kf = int(arr(it.ms.next_kf))
    out = dict(states=states, keeps=keeps, n_kf=n_kf, n_maps=int(arr(it.ms.maps.n_maps)),
               rows=[t.state for t in it.telemetry],
               slam_rows=[t.state for t in sysm.trackers["SLAM"].telemetry],
               before=arr(it.ms.kf.Tcw)[:n_kf].copy(),
               ts=arr(it.ms.kf.timestamp)[:n_kf].copy(),
               map_id=arr(it.ms.kf.map_id)[:n_kf].copy())
    sysm.run_imaging_bundle_adjustment()
    out.update(after=arr(it.ms.kf.Tcw)[:n_kf].copy(), bad=arr(it.ms.kf.bad)[:n_kf].copy(),
               registered=arr(it.ms.maps.registered)[:out["n_maps"]].copy())
    if tmp is not None:
        import os

        sysm.export_colmap(str(tmp))
        sysm.save_keyframes_agisoft(os.path.join(str(tmp), "imaging.xml"), camera="Imaging")
        sysm.save_trajectory(os.path.join(str(tmp), "slam_traj.tsv"))
    return out
