"""Parity of the PyTorch port's ops, extraction, stereo and matcher with the
JAX package, on the CPU at the small sizes of tests/test_frontend.py. The
same numpy inputs go through both; each test states its bound and why."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.core.frame import empty_features as j_empty_features
from hyslam_tpu.core.frame import feature_inv_sigma2 as j_feature_inv_sigma2
from hyslam_tpu.core.frame import level_inv_sigma2 as j_level_inv_sigma2
from hyslam_tpu.features import atlas as j_atlas
from hyslam_tpu.features import matcher as j_matcher
from hyslam_tpu.features.extractor import level_budgets as j_level_budgets
from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.geometry import so3 as j_so3
from hyslam_tpu.geometry.camera import project as j_project
from hyslam_tpu.ops import fast as j_fast
from hyslam_tpu.ops import hamming as j_hamming
from hyslam_tpu.ops import orb as j_orb
from hyslam_tpu.ops import pyramid as j_pyramid
from hyslam_tpu.ops import stereo as j_stereo
from hyslam_tpu_torch.core.frame import empty_features, feature_inv_sigma2, level_inv_sigma2
from hyslam_tpu_torch.features import atlas, matcher
from hyslam_tpu_torch.features.extractor import level_budgets
from hyslam_tpu_torch.geometry import se3, so3
from hyslam_tpu_torch.geometry.camera import project
from hyslam_tpu_torch.ops import fast, hamming, orb, pyramid, stereo

from port_helpers import (
    CFG, F_CAP, J_CFG, J_SMALL_CAM, SMALL_CAM, angle_diff, bits,
    feats_to_jax, feats_to_torch, map_args_jax, map_args_torch, seeded_map,
    small_world, stereo_pair, to_jax, to_torch,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    """Frame 0 and frame 1 (0.1 m forward) of the small stereo scene, and
    the JAX package's features of both, as numpy."""
    pts = small_world()
    T1 = np.eye(4, dtype=np.float32)
    T1[2, 3] = -0.1
    pairs = [stereo_pair(np.eye(4, dtype=np.float32), pts), stereo_pair(T1, pts)]
    feats = [j_atlas.extract_atlas_batch(jnp.asarray(p), J_CFG, capacity=F_CAP)
             for p in pairs]
    return pairs, feats, T1


def _canvas(pair):
    layout = j_atlas.atlas_layout(*pair.shape[1:], J_CFG)
    return np.array(j_atlas._build_canvas(jnp.asarray(pair[0]), layout, J_CFG))


# --- frame contract, extractor budget, geometry ----------------------------

def test_level_weights_and_budgets():
    level = np.array([0, 1, 3, 7, 9, -1], np.int32)
    np.testing.assert_array_equal(
        feature_inv_sigma2(torch.from_numpy(level)).numpy(),
        np.asarray(j_feature_inv_sigma2(jnp.asarray(level))))
    assert level_budgets(CFG) == j_level_budgets(J_CFG)
    np.testing.assert_array_equal(level_inv_sigma2(4, 1.4).numpy(),
                                  np.asarray(j_level_inv_sigma2(4, 1.4)))
    empty = feats_to_jax(empty_features(F_CAP))
    for a, b in zip(empty, j_empty_features(F_CAP)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_geometry_matches_jax():
    """se3/so3/camera against JAX within 1e-5 (float32 sums of 3 terms in
    another order)."""
    rng = np.random.default_rng(1)
    xi = (rng.normal(0, 0.4, (5, 6))).astype(np.float32)
    xi[0, :3] = 1e-4                                  # the Taylor branch
    pts = rng.uniform(-3, 3, (5, 7, 3)).astype(np.float32)
    pts[..., 2] += 6.0
    T = se3.exp(torch.from_numpy(xi))
    Tj = j_se3.exp(jnp.asarray(xi))
    np.testing.assert_allclose(T.numpy(), np.asarray(Tj), atol=1e-5)
    np.testing.assert_allclose(so3.hat(torch.from_numpy(xi[:, :3])).numpy(),
                               np.asarray(j_so3.hat(jnp.asarray(xi[:, :3]))))
    np.testing.assert_allclose(se3.inverse(T).numpy(),
                               np.asarray(j_se3.inverse(Tj)), atol=1e-5)
    np.testing.assert_allclose(se3.compose(T, se3.inverse(T)).numpy(),
                               np.broadcast_to(np.eye(4), (5, 4, 4)), atol=1e-5)
    pc = se3.apply(T[:, None], torch.from_numpy(pts))
    np.testing.assert_allclose(
        pc.numpy(), np.asarray(j_se3.apply(Tj[:, None], jnp.asarray(pts))),
        atol=1e-5)
    uv, z = project(SMALL_CAM, pc)
    uvj, zj = j_project(J_SMALL_CAM, jnp.asarray(pc.numpy()))
    np.testing.assert_allclose(uv.numpy(), np.asarray(uvj), atol=1e-3)
    np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    assert np.array_equal(se3.identity((2,)).numpy(),
                          np.asarray(j_se3.identity((2,))))
    np.testing.assert_allclose(
        se3.translation(T).numpy(), np.asarray(j_se3.translation(Tj)), atol=1e-5)


def test_grayscale_and_preprocess():
    """Luminance within 1e-4 (einsum order); the half-scale antialiased
    resize within 2e-3 of jax.image.resize."""
    rgb = np.random.default_rng(2).uniform(0, 255, (60, 80, 3)).astype(np.float32)
    np.testing.assert_allclose(
        pyramid.to_grayscale(torch.from_numpy(rgb)).numpy(),
        np.asarray(j_pyramid.to_grayscale(jnp.asarray(rgb))), atol=1e-4)
    np.testing.assert_allclose(
        pyramid.preprocess_image(torch.from_numpy(rgb), 0.5).numpy(),
        np.asarray(j_pyramid.preprocess_image(jnp.asarray(rgb), 0.5)), atol=2e-3)
    assert pyramid.pyramid_shapes(240, 320, 8) == j_pyramid.pyramid_shapes(240, 320, 8)


# --- Hamming: exact -------------------------------------------------------

def test_hamming_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (33, 8), dtype=np.uint32)
    a[0] = 0
    a[1] = 0xFFFFFFFF
    b[0] = 0xFFFFFFFF
    b[1] = 0
    ta, tb = to_torch(a), to_torch(b)
    np.testing.assert_array_equal(hamming.popcount(ta).numpy(),
                                  np.asarray(j_hamming.popcount(jnp.asarray(a))))
    np.testing.assert_array_equal(
        hamming.unpack_bits(ta).numpy(),
        np.asarray(j_hamming.unpack_bits(jnp.asarray(a)), np.float32))
    planes = rng.integers(0, 2, (12, 256)).astype(bool)
    planes[0] = True
    planes[1] = False
    np.testing.assert_array_equal(
        hamming.pack_bits(torch.from_numpy(planes)).numpy().view(np.uint32),
        np.asarray(j_hamming.pack_bits(jnp.asarray(planes))))
    hm = hamming.hamming_matrix(ta, tb).numpy()
    np.testing.assert_array_equal(
        hm, np.asarray(j_hamming.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))
    assert hm[0, 0] == 256 and hm[1, 0] == 0 and hm[0, 1] == 0


# --- FAST / NMS, canvas, descriptors --------------------------------------

def test_fast_scores_and_nms(scene):
    """Scores within 1e-3 (the same f32 ops; sums in the same order), and
    the corner and NMS masks equal."""
    canvas = _canvas(scene[0][0])
    s_t = fast.fast_scores(torch.from_numpy(canvas), 7.0)
    s_j = j_fast.fast_scores(jnp.asarray(canvas), 7.0)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-3)
    np.testing.assert_array_equal(s_t.numpy() > 0, np.asarray(s_j) > 0)
    assert (s_t.numpy() > 0).sum() > 100
    n_t = fast.nms3x3(s_t).numpy()
    n_j = np.asarray(j_fast.nms3x3(s_j))
    np.testing.assert_allclose(n_t, n_j, atol=1e-3)
    np.testing.assert_array_equal(n_t > 0, n_j > 0)


def test_build_canvas(scene):
    """The pyramid canvas within 2e-3: the antialiased bilinear resize
    differs from jax.image.resize by ~6e-4 per cascade step."""
    pair = scene[0][0]
    layout = atlas.atlas_layout(*pair.shape[1:], CFG)
    assert tuple(layout) == tuple(j_atlas.atlas_layout(*pair.shape[1:], J_CFG))
    c_t = atlas._build_canvas(torch.from_numpy(pair), layout, CFG).numpy()
    c_j = np.asarray(j_atlas._build_canvas(jnp.asarray(pair[0]), layout, J_CFG))
    assert c_t.shape == (2,) + c_j.shape
    np.testing.assert_allclose(c_t[0], c_j, atol=2e-3)


def test_orient_and_describe():
    """Same canvas and keypoints, including keypoints within 3 px of the
    canvas borders: angles within 1e-4 (moment sums in another order), at
    most 0.5% of descriptor bits differ (a centred sample that rounds to
    another bf16 value can flip a comparison). The canvas is smoothed noise:
    on a flat patch both moments round to ~0 and the angle is noise in
    either package."""
    rng = np.random.default_rng(4)
    noise = rng.uniform(0, 255, (120, 200)).astype(np.float32)
    canvas = np.array(j_pyramid.gaussian_blur(jnp.asarray(noise), 5, 1.0))
    H, W = canvas.shape
    inner = np.stack([rng.uniform(20, W - 20, 300), rng.uniform(20, H - 20, 300)], -1)
    edge = np.array([[0, 0], [1.4, 2.6], [W - 1, H - 1], [W - 3, 5], [7, H - 2],
                     [W - 2.5, 100], [100, 0.4], [2.2, 50]])
    uv = np.concatenate([inner, edge]).astype(np.float32)
    a_t, d_t = orb.orient_and_describe(torch.from_numpy(canvas), torch.from_numpy(uv))
    a_j, d_j = j_orb.orient_and_describe(jnp.asarray(canvas), jnp.asarray(uv))
    assert angle_diff(a_t.numpy(), a_j).max() < 1e-4
    assert (bits(d_t.numpy()) != bits(d_j)).mean() <= 0.005


def test_extract_atlas_batch(scene):
    """Rendered stereo frames: the valid keypoint sets (uv, level) overlap
    by at least 98%, and at most 1% of descriptor bits differ on the
    keypoints both found."""
    for pair, fj in zip(scene[0], scene[1]):
        ft = atlas.extract_atlas_batch(torch.from_numpy(pair), CFG, F_CAP)
        for b in range(2):
            kt = {(float(u), float(v), int(l)): i for i, ((u, v), l, ok) in
                  enumerate(zip(ft.uv[b].numpy(), ft.level[b].numpy(),
                                ft.valid[b].numpy())) if ok}
            kj = {(float(u), float(v), int(l)): i for i, ((u, v), l, ok) in
                  enumerate(zip(np.asarray(fj.uv[b]), np.asarray(fj.level[b]),
                                np.asarray(fj.valid[b]))) if ok}
            common = kt.keys() & kj.keys()
            assert len(common) >= 0.98 * max(len(kt), len(kj)) > 100
            it = [kt[k] for k in common]
            ij = [kj[k] for k in common]
            diff = bits(ft.desc[b].numpy()[it]) != bits(np.asarray(fj.desc[b])[ij])
            assert diff.mean() <= 0.01


def test_extract_atlas_single_is_batch_of_one(scene):
    """extract_atlas is the batch of one: the same keypoints; angles within
    1e-5 (a batched matmul may sum in another order)."""
    pair = torch.from_numpy(scene[0][0])
    one = atlas.extract_atlas(pair[1], CFG, F_CAP)
    both = atlas.extract_atlas_batch(pair, CFG, F_CAP)
    for k in ("uv", "level", "valid", "ur", "depth"):
        assert torch.equal(getattr(one, k), getattr(both, k)[1])
    np.testing.assert_allclose(one.angle.numpy(), both.angle[1].numpy(), atol=1e-5)
    assert (bits(one.desc.numpy()) != bits(both.desc[1].numpy())).mean() <= 0.005


# --- stereo ---------------------------------------------------------------

def test_match_stereo_refined(scene):
    """Identical (JAX-extracted) features into both: the matched masks are
    equal after each stage, and ur/depth agree within 1e-4 on matched
    rows."""
    pair, fj = scene[0][0], scene[1][0]
    fl_j = jax.tree.map(lambda x: x[0], fj)
    fr_j = jax.tree.map(lambda x: x[1], fj)
    fl_t, fr_t = feats_to_torch(fl_j), feats_to_torch(fr_j)
    bf = SMALL_CAM.bf

    m_t = stereo.match_stereo(fl_t, fr_t, bf=bf)
    m_j = j_stereo.match_stereo(fl_j, fr_j, bf=bf)
    ok = np.asarray(m_j.ur) > 0
    np.testing.assert_array_equal(m_t.ur.numpy() > 0, ok)
    assert ok.sum() > 50
    np.testing.assert_allclose(m_t.ur.numpy()[ok], np.asarray(m_j.ur)[ok], atol=1e-4)
    np.testing.assert_allclose(m_t.depth.numpy()[ok], np.asarray(m_j.depth)[ok],
                               atol=1e-4)

    r_t = stereo.match_stereo_refined(fl_t, fr_t, torch.from_numpy(pair[0]),
                                      torch.from_numpy(pair[1]), bf=bf)
    r_j = j_stereo.match_stereo_refined(fl_j, fr_j, jnp.asarray(pair[0]),
                                        jnp.asarray(pair[1]), bf=bf)
    ok = np.asarray(r_j.depth) > 0
    np.testing.assert_array_equal(r_t.depth.numpy() > 0, ok)
    np.testing.assert_allclose(r_t.ur.numpy()[ok], np.asarray(r_j.ur)[ok], atol=1e-4)
    np.testing.assert_allclose(r_t.depth.numpy()[ok], np.asarray(r_j.depth)[ok],
                               atol=1e-4)


# --- matcher --------------------------------------------------------------

def _stereo_left(pair, fj):
    fl = jax.tree.map(lambda x: x[0], fj)
    fr = jax.tree.map(lambda x: x[1], fj)
    return j_stereo.match_stereo_refined(fl, fr, jnp.asarray(pair[0]),
                                         jnp.asarray(pair[1]), bf=SMALL_CAM.bf)


def test_search_by_projection_landmarks(scene):
    """A map seeded from frame 0, frame 1's features from the JAX package
    into both: the per-feature landmark rows are equal."""
    pairs, feats, _ = scene
    f0 = jax.tree.map(np.asarray, _stereo_left(pairs[0], feats[0]))
    table = seeded_map(f0._asdict())
    f1 = _stereo_left(pairs[1], feats[1])
    kw = dict(th=3.0, ratio=0.8, n_levels=4)
    r_j = j_matcher.search_by_projection_landmarks(
        J_SMALL_CAM, f1, jnp.eye(4), *map_args_jax(table),
        jnp.zeros((F_CAP,), bool), **kw)
    r_t = matcher.search_by_projection_landmarks(
        SMALL_CAM, feats_to_torch(f1), torch.eye(4), *map_args_torch(table),
        torch.zeros((F_CAP,), dtype=torch.bool), **kw)
    np.testing.assert_array_equal(r_t.lm_for_feature.numpy(),
                                  np.asarray(r_j.lm_for_feature))
    assert int(r_t.n_matches) == int(r_j.n_matches) > 50


def test_predict_level_and_dedup():
    rng = np.random.default_rng(5)
    dist = rng.uniform(0.5, 40, 500).astype(np.float32)
    max_dist = (dist * 1.2 ** rng.integers(0, 9, 500)).astype(np.float32)
    np.testing.assert_array_equal(
        matcher.predict_level(torch.from_numpy(dist), torch.from_numpy(max_dist)).numpy(),
        np.asarray(j_matcher.predict_level(jnp.asarray(dist), jnp.asarray(max_dist))))
    d = rng.integers(0, 60, (50, 20)).astype(np.int32)
    match = rng.integers(0, 20, 50).astype(np.int32)
    ok = rng.uniform(size=50) < 0.8
    np.testing.assert_array_equal(
        matcher._dedup_feature_side(torch.from_numpy(d), torch.from_numpy(match),
                                    torch.from_numpy(ok)).numpy(),
        np.asarray(j_matcher._dedup_feature_side(jnp.asarray(d), jnp.asarray(match),
                                                 jnp.asarray(ok))))


def test_feats_roundtrip_helpers(scene):
    fj = jax.tree.map(lambda x: x[0], scene[1][0])
    back = feats_to_jax(feats_to_torch(fj))
    for a, b in zip(back, fj):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.array_equal(np.asarray(to_jax(to_torch(np.asarray(fj.desc)), uint32=True)),
                          np.asarray(fj.desc))
