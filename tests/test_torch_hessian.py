"""The SURF family of the port (``ops/hessian.py``, ``features/factory.py``'s
``extract_hessian``) against the JAX package's on the CPU, the JAX test
file's own assertions run on the port, and a stereo ``System`` with
``family: SURF`` against the JAX package's.

Tolerances: the box filters, responses, keypoints, levels and descriptors
are compared for equality (the port's prefix sums add in the JAX package's
order, so every value is the same float32); the descriptors are also held to
the < 0.5% of differing bits that ORB's parity allows, which is what a
reordered mean in the descriptor's threshold could cost. The System: states
and keyframes equal, poses within 1e-3 m and 1e-4 in a rotation entry (the
pose solve and local BA of two packages whose reductions differ in order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hyslam_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from hyslam_tpu.features.factory import _extract_hessian_batch as j_extract_batch
from hyslam_tpu.features.factory import extract_hessian as j_extract_hessian
from hyslam_tpu.ops import fast as j_fast
from hyslam_tpu.ops import hessian as JH
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.features.factory import extract_hessian, make_family
from hyslam_tpu_torch.ops import hessian as TH
from hyslam_tpu_torch.ops.fast import nms3x3, select_keypoints
from hyslam_tpu_torch.ops.hamming import hamming_pairwise
from hyslam_tpu_torch.utils import synth

from port_helpers import bits, one_thread  # noqa: F401

MAX_BIT_FRACTION = 0.005


def _blob_image(h=120, w=160, centers=((40, 60, 4.0), (80, 110, 6.0)), seed=0):
    """tests/test_hessian.py's Gaussian blobs on mild noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = rng.uniform(0, 8, (h, w)).astype(np.float32)
    for (cy, cx, s) in centers:
        img += 200.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    return img


def _texture(seed=0, h=150, w=210):
    """A non-integer image: the prefix sums round at every addition."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (h, w)) * 0.37).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize("ky,kx", [(3, 5), (9, 9), (17, 5), (2, 1), (6, 12)])
def test_box_filter_equals_jax(ky, kx):
    img = _texture()
    want = np.asarray(JH.box_filter(jnp.asarray(img), ky, kx))
    np.testing.assert_array_equal(TH.box_filter(_t(img), ky, kx).numpy(), want)


@pytest.mark.parametrize("n", [5, 16, 17, 45, 300, 720, 1014, 1352])
def test_prefix_sum_adds_in_the_jax_order(n):
    x = (np.random.default_rng(n).uniform(0, 255, (n, 3)) * 0.37).astype(np.float32)
    np.testing.assert_array_equal(TH._prefix_sum(_t(x), 0).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x), 0)))
    np.testing.assert_array_equal(TH._prefix_sum(_t(x.T.copy()), -1).numpy(),
                                  np.asarray(jnp.cumsum(jnp.asarray(x.T), 1)))


@pytest.mark.parametrize("L", TH.FILTER_SIZES)
def test_doh_and_haar_equal_jax(L):
    img = _texture(L)
    np.testing.assert_array_equal(TH.doh_response(_t(img), L).numpy(),
                                  np.asarray(JH.doh_response(jnp.asarray(img), L)))
    step = max(int(round(2 * L / 9.0)), 2)
    for got, want in zip(TH.haar_responses(_t(img), step),
                         JH.haar_responses(jnp.asarray(img), step)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("scale", [1.0, 15 / 9.0, 21 / 9.0, 3.0])
def test_binary_haar_descriptors_equal_jax(scale):
    """Integer keypoints: with an odd step (15/9 -> 3) the sample grid lies
    on half pixels, where jnp.round and torch.round both round to even."""
    img = _texture(1)
    rng = np.random.default_rng(2)
    uv = np.stack([rng.integers(0, 210, 64), rng.integers(0, 150, 64)], -1).astype(np.float32)
    want = np.asarray(JH.binary_haar_descriptors(jnp.asarray(img), jnp.asarray(uv), scale))
    got = TH.binary_haar_descriptors(_t(img), _t(uv), scale).numpy().view(np.uint32)
    assert (bits(got) != bits(want)).mean() < MAX_BIT_FRACTION
    np.testing.assert_array_equal(got, want)
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, 3.5])
    assert torch.round(half).tolist() == np.asarray(jnp.round(jnp.asarray(half.numpy()))).tolist()


def test_select_keypoints_equals_jax():
    score = np.asarray(nms3x3(TH.doh_response(_t(_texture(3)), 15).clamp_min(0.0)))
    for n, cell, border in ((100, 32, 15), (37, 16, 19), (400, 32, 27)):
        want = j_fast.select_keypoints(jnp.asarray(score), n, cell=cell, border=border)
        got = select_keypoints(_t(score), n, cell=cell, border=border)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("img_fn,n", [(lambda: _blob_image(), 128),
                                      (lambda: _texture(4, 240, 320), 300)])
def test_extract_hessian_equals_jax(img_fn, n):
    img = img_fn()
    cap = n + 32
    want = j_extract_hessian(jnp.asarray(img), JExtractorConfig(n_features=n, family="SURF"),
                             capacity=cap)
    got = extract_hessian(_t(img), ExtractorConfig(n_features=n, family="SURF"), cap)
    for k in ("uv", "level", "valid", "ur", "depth", "angle"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)), k)
    assert int(got.valid.sum()) > 0
    assert (bits(got.desc.numpy()) != bits(np.asarray(want.desc))).mean() < MAX_BIT_FRACTION
    np.testing.assert_array_equal(got.desc.numpy().view(np.uint32), np.asarray(want.desc))


def test_extract_hessian_batch_equals_jax_and_single():
    imgs = np.stack([_texture(5, 240, 320), _texture(6, 240, 320)])
    cfg = ExtractorConfig(n_features=200, family="SURF")
    batch = extract_hessian(_t(imgs), cfg, 256)
    want = j_extract_batch(jnp.asarray(imgs), JExtractorConfig(n_features=200, family="SURF"),
                           256)
    for k in batch._fields:
        g = getattr(batch, k).numpy()
        np.testing.assert_array_equal(g.view(np.uint32) if k == "desc" else g,
                                      np.asarray(getattr(want, k)), k)
    for i in range(2):
        one = extract_hessian(_t(imgs[i]), cfg, 256)
        assert all(torch.equal(a, b[i]) for a, b in zip(one, batch))


# ------------------------------------------- tests/test_hessian.py on the port

def test_box_filter_matches_naive():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (20, 17)).astype(np.float32)
    out = TH.box_filter(_t(img), 3, 5).numpy()
    pad = np.pad(img, ((1, 1), (2, 2)))
    want = np.zeros_like(img)
    for y in range(20):
        for x in range(17):
            want[y, x] = pad[y:y + 3, x:x + 5].sum()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-4)


def test_doh_peak_at_blob_and_scale_selectivity():
    r = TH.doh_response(_t(_blob_image(centers=((60, 80, 3.0),))), 9).numpy().copy()
    r[:12] = r[-12:] = 0
    r[:, :12] = r[:, -12:] = 0
    y, x = np.unravel_index(np.argmax(r), r.shape)
    assert abs(y - 60) <= 2 and abs(x - 80) <= 2
    big = _t(_blob_image(centers=((60, 80, 9.0),)))
    assert float(TH.doh_response(big, 27)[60, 80]) > float(TH.doh_response(big, 9)[60, 80])


def test_extractor_detects_blobs_and_is_repeatable_under_shift():
    cfg = ExtractorConfig(n_features=128, family="SURF")
    f = extract_hessian(_t(_blob_image()), cfg, 128)
    uv = f.uv[f.valid].numpy()
    assert np.linalg.norm(uv - [60.0, 40.0], axis=-1).min() < 3.0
    assert np.linalg.norm(uv - [110.0, 80.0], axis=-1).min() < 3.0

    img = _blob_image(seed=1)
    f0 = extract_hessian(_t(img), cfg, 128)
    f1 = extract_hessian(_t(np.roll(img, (0, 7), axis=(0, 1))), cfg, 128)
    uv0, uv1 = f0.uv[f0.valid].numpy(), f1.uv[f1.valid].numpy()
    d0, d1 = f0.desc[f0.valid], f1.desc[f1.valid]
    rng = np.random.default_rng(0)
    match_d, rand_d = [], []
    for i in range(len(uv0)):
        err = np.linalg.norm(uv1 - (uv0[i] + [7.0, 0.0]), axis=-1)
        j = int(np.argmin(err))
        if err[j] < 1.5:
            match_d.append(int(hamming_pairwise(d0[i], d1[j])))
            rand_d.append(int(hamming_pairwise(d0[i], d1[int(rng.integers(0, len(d1)))])))
    assert len(match_d) >= 10
    assert np.mean(match_d) < 0.6 * np.mean(rand_d)
    assert np.mean(match_d) < 60


def test_factory_surf_family():
    fam = make_family(ExtractorConfig(n_features=64, family="SURF"))
    assert (fam.name, fam.th_high, fam.th_low) == ("SURF", 100.0, 50.0)
    f = fam.extract(_t(_blob_image()), capacity=64)
    assert bool(f.valid.any())
    assert fam.name == make_family(ExtractorConfig(family="hessian")).name
    with pytest.raises(ValueError, match="capacity 32 < budget 64"):
        fam.extract(_t(_blob_image()), capacity=32)


# ----------------------------------------------------- a SURF camera's System

N_SURF = 12
SURF_DT = 0.1


@pytest.fixture(scope="module")
def surf_runs():
    """The JAX and the port's System over 12 rendered 640x480 stereo frames
    with ``family: SURF`` and 400 features."""
    from hyslam_tpu.core.mapstate import MapCaps as JMapCaps
    from hyslam_tpu.io.config import CameraConfig as JCameraConfig
    from hyslam_tpu.io.config import SystemConfig as JSystemConfig
    from hyslam_tpu.slam.system import System as JSystem
    from hyslam_tpu_torch.geometry.camera import Camera
    from hyslam_tpu_torch.slam.system import System

    cam = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480, bf=45.0)
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(-10, 10, 2000), rng.uniform(-7, 7, 2000),
                    rng.uniform(3, 30, 2000)], -1).astype(np.float32)
    Ts = synth.make_trajectory(N_SURF, step=0.1, yaw_rate=0.003)
    pairs = [synth.render_stereo_pair(cam, T, pts) for T in Ts]
    cc = JCameraConfig(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, width=cam.width,
                       height=cam.height, bf=cam.bf,
                       extractor=JExtractorConfig(n_features=400, family="SURF"))
    jcfg = JSystemConfig(cameras={"SLAM": cc}, caps=JMapCaps(K=32, L=4096, F=512, O=8),
                         enable_loop_closing=False)
    js, ts = JSystem(jcfg), System(interop.system_config_from(jcfg, device="cpu"))
    for i, (left, right) in enumerate(pairs):
        js.track_stereo(left, right, SURF_DT * i, frame_id=i)
        ts.track_stereo(left, right, SURF_DT * i, frame_id=i)
    return Ts, js.trackers["SLAM"], ts.trackers["SLAM"]


def test_surf_system_tracks_like_jax(surf_runs):
    Ts, jt, tt = surf_runs
    assert [t.state for t in tt.telemetry] == [t.state for t in jt.telemetry]
    assert [t.kf_inserted for t in tt.telemetry] == [t.kf_inserted for t in jt.telemetry]
    assert all(t.state in ("POSTINIT", "NORMAL") for t in tt.telemetry[1:])
    assert tt.telemetry[-1].n_inliers > 150
    n = int(tt.traj.size)
    assert n == int(np.asarray(jt.traj.size)) == N_SURF
    got, want = tt.traj.Tcw[:n].numpy(), np.asarray(jt.traj.Tcw[:n])
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-4)
    errs = [synth.pose_error(got[i], Ts[i])[1] for i in range(n)]
    assert float(np.median(errs)) < 0.05
