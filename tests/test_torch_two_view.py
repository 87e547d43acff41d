"""The port's two-view estimator (``hyslam_tpu_torch/estimators/two_view.py``)
against the JAX package's, on the CPU, fed the same correspondences and the
same RANSAC sample sets (drawn with ``jax.random`` as the JAX package draws
them).

Tolerances: the minimal-set models are eigenvectors, equal only up to sign
and scale, so they are compared after scaling to unit norm with a common
sign. The homography path (Hartley-normalized, as in the JAX package) is
held tight: models within 1e-4, scores within 1e-4 relative (float sums in
another order), masks, votes, motions (1e-4) and points (1e-3 relative)
equal. The fundamental path fits the 8-point system in raw pixels in
float32, as the JAX package does, and there the minimal-set models are
rounding noise in both packages: its scores, masks and the F-branch motion
are held to the looser bounds each test states. Every decision (RH > 0.40,
the 0.75 uniqueness rule, the 90% triangulation rule, the 50-point minimum)
is equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.estimators import two_view as jtv
from hyslam_tpu_torch.estimators import two_view as tv
from hyslam_tpu_torch.interop import camera_from
from hyslam_tpu_torch.utils import synth

from helpers import DEFAULT_CAM
from port_helpers import jax_two_view_samples, one_thread

CAM = camera_from(DEFAULT_CAM)
F_CAP = 512


def planar_world(rng, n=1200, z0=6.0, tilt=0.25):
    """tests/test_tracking.py's planar scene (TestMonoPlanarInit)."""
    xy = rng.uniform(-6, 6, (n, 2)).astype(np.float32)
    z = z0 + tilt * xy[:, 0]
    return np.concatenate([xy, z[:, None]], -1).astype(np.float32)


def correspondences(rng, pts, T2, noise=0.3):
    """The points seen from the origin and from T2, both in a 640x480
    image, with pixel noise, padded to F_CAP rows: (p1, p2, idx)."""
    def proj(T):
        pc = pts @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                       CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], -1)
        return uv, pc[:, 2]

    uv1, z1 = proj(np.eye(4, dtype=np.float32))
    uv2, z2 = proj(T2)
    vis = ((z1 > 0.2) & (z2 > 0.2) & (uv1 >= 0).all(-1) & (uv2 >= 0).all(-1)
           & (uv1[:, 0] < 640) & (uv1[:, 1] < 480) & (uv2[:, 0] < 640) & (uv2[:, 1] < 480))
    k = min(int(vis.sum()), F_CAP)
    p1 = np.zeros((F_CAP, 2), np.float32)
    p2 = np.zeros((F_CAP, 2), np.float32)
    p1[:k] = uv1[vis][:k] + rng.normal(0, noise, (k, 2))
    p2[:k] = uv2[vis][:k] + rng.normal(0, noise, (k, 2))
    idx = np.full(F_CAP, -1, np.int32)
    idx[:k] = np.arange(k)
    return p1, p2, idx, k


SCENES = {
    # a plane, sideways: the H-branch (tests/test_tracking.py:173,206)
    "plane": (lambda rng: planar_world(rng), [0.0, 0.03, 0.0, -0.6, 0.05, 0.0]),
    # a deep 3-D scene, sideways with some forward motion: the F-branch
    "depth": (lambda rng: synth.make_world(rng, 1200, extent=(8.0, 6.0, 14.0), z_min=3.0),
              [0.02, -0.03, 0.01, -0.5, 0.05, -0.2]),
    # pure rotation: nothing triangulates, both refuse
    "rotation": (lambda rng: synth.make_world(rng, 1200, extent=(8.0, 6.0, 14.0), z_min=3.0),
                 [0.0, 0.05, 0.0, 0.0, 0.0, 0.0]),
}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    rng = np.random.default_rng(0)
    make, xi = SCENES[request.param]
    pts = make(rng)
    T2 = synth.se3_exp(xi).astype(np.float32)
    p1, p2, idx, k = correspondences(rng, pts, T2)
    return request.param, T2, p1, p2, idx, k


def unit_model(M):
    """A 3x3 model up to sign and scale: unit Frobenius norm, its largest
    entry positive."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M)
    return M * np.sign(M.flat[np.argmax(np.abs(M))])


def test_normalize_points_matches_jax(scene):
    _, _, p1, _, idx, _ = scene
    valid = idx >= 0
    pn_j, T_j = jtv._normalize_points(jnp.asarray(p1), jnp.asarray(valid))
    pn, T, Tinv = tv._normalize_points(torch.from_numpy(p1), torch.from_numpy(valid))
    np.testing.assert_allclose(pn.numpy(), np.asarray(pn_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(T.numpy(), np.asarray(T_j), rtol=1e-6)
    np.testing.assert_allclose((T @ Tinv).numpy(), np.eye(3), atol=1e-5)


@pytest.mark.parametrize("model", ["fundamental", "homography"])
def test_minimal_set_fits_match_jax_up_to_sign(scene, model):
    """Every one of the 256 minimal-set models, batched in one eigh, is the
    JAX package's up to sign and scale, on Hartley-normalized points (the
    homography RANSAC fits there): homographies within 1e-4. Eight points
    for the fundamental matrix's nine unknowns are sensitive to float32
    rounding even there (a third of the models differ by more than 2e-2
    between the packages): on the scene with depth each package's models
    are held to the float64 fit of the same sets, the port's median distance
    from it at most twice the JAX package's (4.5e-3 against 2.8e-3 seen). On
    the plane and under pure rotation the 8-point system has a nullspace
    of more than one dimension and the two packages pick different members
    of it: there both models are only held to rank 2."""
    name, _, p1, p2, idx, _ = scene
    valid = idx >= 0
    sets_f, sets_h = jax_two_view_samples(valid)
    sets = (sets_f if model == "fundamental" else sets_h).numpy()
    pn1, _ = jtv._normalize_points(jnp.asarray(p1), jnp.asarray(valid))
    pn2, _ = jtv._normalize_points(jnp.asarray(p2), jnp.asarray(valid))
    fit_j = jtv._fit_fundamental if model == "fundamental" else jtv._fit_homography
    fit_t = tv._fit_fundamental if model == "fundamental" else tv._fit_homography
    want = np.asarray(jax.vmap(lambda i: fit_j(pn1[i], pn2[i]))(jnp.asarray(sets)))
    a, b = torch.from_numpy(np.asarray(pn1))[sets], torch.from_numpy(np.asarray(pn2))[sets]
    got = fit_t(a, b).numpy()
    if model == "fundamental":
        for M in (got, want):
            s = np.linalg.svd(M.astype(np.float64), compute_uv=False)
            assert (s[:, 2] < 1e-5 * s[:, 0]).all()
        if name != "depth":
            return
    if model == "fundamental":
        exact = fit_t(a.double(), b.double()).numpy()
        d_t, d_j = ([np.abs(unit_model(g) - unit_model(e)).max() for g, e in zip(m, exact)]
                    for m in (got, want))
        assert np.median(d_t) <= 2 * np.median(d_j), (np.median(d_t), np.median(d_j))
        return
    d = [np.abs(unit_model(g) - unit_model(w)).max() for g, w in zip(got, want)]
    assert max(d) < 1e-4


def test_ransac_scores_masks_and_models_match_jax(scene):
    """With the same sample sets: the homography RANSAC picks the same model
    up to scale, with the same inlier mask, its score within 1e-4 relative.
    The fundamental RANSAC fits the 8-point system in raw pixels in float32
    (as the JAX package does): its minimal-set models are far from their
    float64 values in both packages, so the two pick different models of
    nearly the same score, within 1% relative (0.4% seen), their masks apart
    on at most 1% of the rows. RH and its decision agree."""
    name, _, p1, p2, idx, k = scene
    valid = idx >= 0
    sets_f, sets_h = jax_two_view_samples(valid)
    kF, kH = jax.random.split(jax.random.PRNGKey(0))
    jargs = (jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    targs = (torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid))
    _, inlFj, sFj = jtv.ransac_fundamental(*jargs, kF)
    Hj, inlHj, sHj = jtv.ransac_homography(*jargs, kH)
    _, inlFt, sFt = tv.ransac_fundamental(*targs, sets_f.long())
    Ht, inlHt, sHt = tv.ransac_homography(*targs, sets_h.long())
    np.testing.assert_allclose(float(sHt), float(sHj), rtol=1e-4)
    np.testing.assert_array_equal(inlHt.numpy(), np.asarray(inlHj))
    np.testing.assert_allclose(unit_model(Ht), unit_model(Hj), atol=1e-4)
    np.testing.assert_allclose(float(sFt), float(sFj), rtol=1e-2)
    assert int((inlFt.numpy() != np.asarray(inlFj)).sum()) <= 0.01 * k
    rh = float(sHt) / (float(sHt) + float(sFt))
    rh_j = float(sHj) / (float(sHj) + float(sFj))
    assert (rh > tv.RH_SELECT) == (rh_j > jtv.RH_SELECT)
    if name == "plane":     # tests/test_tracking.py:173: H selected on a plane
        assert rh > tv.RH_SELECT and int(inlHt.sum()) > 0.9 * k
    if name == "depth":     # the F-branch scene
        assert rh < tv.RH_SELECT


def test_recover_pose_branches_match_jax(scene):
    """Both motion recoveries, fed the JAX package's models: the same
    chosen motion (1e-4), votes, runner-up and masks, each where its model
    is defined: the essential matrix's on the scene with depth, the
    homography's on the plane. Under pure rotation the homography is a
    rotation, its decomposition undefined: both make the same
    decomposability call."""
    name, _, p1, p2, idx, _ = scene
    valid = idx >= 0
    kF, kH = jax.random.split(jax.random.PRNGKey(0))
    jargs = (jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid))
    Fj, inlF, _ = jtv.ransac_fundamental(*jargs, kF)
    Hj, inlH, _ = jtv.ransac_homography(*jargs, kH)
    t = (torch.from_numpy(p1), torch.from_numpy(p2))
    if name == "depth":
        want = jtv._recover_pose(DEFAULT_CAM, Fj, *jargs[:2], jargs[2] & inlF)
        got = tv._recover_pose(CAM, torch.from_numpy(np.asarray(Fj)), *t,
                               torch.from_numpy(np.asarray(jargs[2] & inlF)))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert int(got[3]) == int(want[3]) >= tv.MIN_TRIANGULATED
        return
    want = jtv._recover_pose_homography(DEFAULT_CAM, Hj, *jargs[:2], jargs[2] & inlH)
    got = tv._recover_pose_homography(CAM, torch.from_numpy(np.asarray(Hj)), *t,
                                      torch.from_numpy(np.asarray(jargs[2] & inlH)))
    assert bool(got[5]) == bool(want[5])
    if name == "plane":
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-4)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        assert [int(got[3]), int(got[4])] == [int(want[3]), int(want[4])]


def test_two_view_reconstruct_matches_jax(scene):
    """The whole estimator with the JAX package's sample sets: the same
    decision. On the plane (the H-branch) the same motion within 1e-4, mask
    and points, and the rendered motion (tests/test_tracking.py:206's
    bounds). On the scene with depth (the F-branch) the two packages start
    from different fundamental matrices (see the RANSAC test): their motions
    within 0.2 deg and 0.01 in the translation's direction, masks apart on
    at most 2% of the rows, both within 0.5 deg of the truth."""
    name, T2, p1, p2, idx, k = scene
    want = jtv.two_view_reconstruct(DEFAULT_CAM, jnp.asarray(p1), jnp.asarray(p2),
                                    jnp.asarray(idx))
    got = tv.two_view_reconstruct(CAM, torch.from_numpy(p1), torch.from_numpy(p2),
                                  torch.from_numpy(idx),
                                  samples=jax_two_view_samples(idx >= 0))
    assert got[0] == want[0] == (name != "rotation")
    if not got[0]:
        assert got[1:] == (None, None, None)
        return
    T21, X, good = (x.numpy() for x in got[1:])
    T21_j, X_j, good_j = (np.asarray(x) for x in want[1:])
    tgt = T2[:3, 3] / np.linalg.norm(T2[:3, 3])
    if name == "plane":
        np.testing.assert_allclose(T21, T21_j, atol=1e-4)
        np.testing.assert_array_equal(good, good_j)
        np.testing.assert_allclose(X[good], X_j[good], rtol=1e-3, atol=1e-4)
        assert float(T21[:3, 3] @ tgt) > 0.999 and int(good.sum()) > 0.9 * k
    else:
        assert rotation_deg(T21, T21_j) < 0.2
        assert float(T21[:3, 3] @ T21_j[:3, 3]) > 0.99
        assert int((good != good_j).sum()) <= 0.02 * k
    assert rotation_deg(T21, T2) < 0.5 and rotation_deg(T21_j, T2) < 0.5


def rotation_deg(Ta, Tb) -> float:
    Re = Ta[:3, :3] @ Tb[:3, :3].T
    return float(np.degrees(np.arccos(np.clip((np.trace(Re) - 1) / 2, -1, 1))))


def test_default_sample_sets_draw_valid_rows_only():
    """The port's own draw: rows where valid is True, on the mask's device,
    the same sets for the same seed; no valid row gives row 0."""
    valid = torch.zeros(F_CAP, dtype=torch.bool)
    valid[10:60] = True
    f, h = tv.sample_sets(valid, seed=3)
    assert f.shape == h.shape == (tv.N_HYPOTHESES, 8)
    assert bool(valid[f].all() and valid[h].all()) and not torch.equal(f, h)
    assert torch.equal(tv.sample_sets(valid, seed=3)[0], f)
    assert len(set(f.reshape(-1).tolist())) == 50
