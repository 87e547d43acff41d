"""Sensor fusion of the port against the JAX package's, on the CPU: the
sensor arena, the pose-prior residual blocks, ``build_pose_priors``, bundle
adjustment with priors, and the matrix-free CG solve. The same numpy inputs,
made from a seed, go through both packages.

Tolerances: ``set_sensor`` exact, ``latlon_to_relative`` 1e-9 in float64;
residuals, costs and the blocks Hd, b, Hab within 1e-5 absolute + 1e-4
relative, at a random state and at a residual of zero; ``build_pose_priors``
within 1e-4 relative; BA poses within 1e-4 and costs within 1e-4 relative;
a CG pose step within 1e-3 relative of the dense one."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.core import mapstate as j_mapstate
from hyslam_tpu.core import sensordata as j_sensordata
from hyslam_tpu.core.frame import empty_features as j_empty_features
from hyslam_tpu.geometry import se3 as j_se3
from hyslam_tpu.geometry import so3 as j_so3
from hyslam_tpu.io.config import OptimizerInfo as JOptimizerInfo
from hyslam_tpu.slam import mapper as j_mapper
from hyslam_tpu.slam import sensor_fusion as j_fusion
from hyslam_tpu.solver import ba as j_ba
from hyslam_tpu.solver import priors as j_priors
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.core import sensordata
from hyslam_tpu_torch.io.config import OptimizerInfo
from hyslam_tpu_torch.slam import mapper, sensor_fusion
from hyslam_tpu_torch.solver import ba, priors
from hyslam_tpu_torch.utils import synth

import test_sensors
import test_solver
from helpers import DEFAULT_CAM
from port_helpers import assert_tree_close, ms_to_torch, tree_np
from test_torch_mapper import (  # noqa: F401  (mapper_input is a fixture)
    CAM, PX_BA, _core, assert_map_close, ba_to_torch, mapper_input)

torch.set_num_threads(2)
ATOL, RTOL = 1e-5, 1e-4


def _np_tree(x):
    return jax.tree.map(np.asarray, x)


def _rand_pose(rng, scale=0.3):
    return np.asarray(j_se3.exp(jnp.asarray(
        np.concatenate([rng.normal(0, scale, 3), rng.normal(0, scale, 3)]), jnp.float32)))


# ---------------------------------------------------------------------------
# core/sensordata.py
# ---------------------------------------------------------------------------

SD = dict(gps_rel=(1.0, 2.0, 3.0), gps_err=(0.5, 0.5, 1.0), gps_valid=True,
          quat=(0.0, 1.0, 0.0, 0.0), quat_valid=True, depth=-4.2, depth_valid=True)


@pytest.mark.parametrize("fields", [SD, dict(depth=0.25, depth_valid=True), {}],
                         ids=["all", "depth_only", "defaults"])
def test_set_sensor_equals_jax(fields):
    a_j = j_sensordata.set_sensor(j_sensordata.empty_sensor_arena(8), 3,
                                  j_sensordata.SensorData(**fields))
    a0 = sensordata.empty_sensor_arena(8)
    a_t = sensordata.set_sensor(a0, 3, sensordata.SensorData(**fields))
    assert_tree_close(tree_np(a_t), tree_np(a_j), atol=0.0)
    assert_tree_close(tree_np(a0), tree_np(j_sensordata.empty_sensor_arena(8)), atol=0.0)
    assert sensordata.SensorData._fields == j_sensordata.SensorData._fields
    assert sensordata.SensorData() == tuple(j_sensordata.SensorData())


def test_latlon_to_relative_equals_jax():
    rng = np.random.default_rng(4)
    lat, lon = 47.3 + rng.normal(0, 1e-3, 20), 8.5 + rng.normal(0, 1e-3, 20)
    alt = rng.uniform(300, 500, 20)
    got = sensordata.latlon_to_relative(lat, lon, alt, 47.3, 8.5, 400.0)
    want = j_sensordata.latlon_to_relative(lat, lon, alt, 47.3, 8.5, 400.0)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), atol=1e-9)
    one = sensordata.latlon_to_relative(0.001, 0.0, 5.0, 0.0, 0.0, 0.0)
    assert one[1] == pytest.approx(110.57, rel=0.01) and one[2] == pytest.approx(5.0)


def test_interop_carries_sensor_types_both_ways():
    a_j = j_sensordata.set_sensor(j_sensordata.empty_sensor_arena(4), 1,
                                  j_sensordata.SensorData(**SD))
    a_t = interop.sensor_arena_from_numpy(_np_tree(a_j))
    back = j_sensordata.SensorArena(**{k: jnp.asarray(v) for k, v in
                                       interop.sensor_arena_to_numpy(a_t).items()})
    for k, v in tree_np(a_j).items():
        got = np.asarray(getattr(back, k))
        assert got.dtype == v.dtype and got.tobytes() == v.tobytes(), k
    sd = interop.sensor_data_from(j_sensordata.SensorData(**SD))
    assert isinstance(sd, sensordata.SensorData) and sd == tuple(j_sensordata.SensorData(**SD))
    assert j_sensordata.SensorData(**sd._asdict()) == tuple(sd)
    pr_j = j_priors.empty_pose_priors(3, E=2)._replace(tie_a=jnp.asarray([1, 0], jnp.int32))
    pr_t = interop.pose_priors_from_numpy(_np_tree(pr_j))
    assert pr_t.tie_a.dtype == torch.int32 and pr_t.gps_valid.dtype == torch.bool
    assert_tree_close(tree_np(pr_t), tree_np(pr_j), atol=0.0)
    assert_tree_close(tree_np(priors.empty_pose_priors(3, E=2)._replace(
        tie_a=torch.tensor([1, 0], dtype=torch.int32))), interop.pose_priors_to_numpy(pr_t),
        atol=0.0)


# ---------------------------------------------------------------------------
# solver/priors.py
# ---------------------------------------------------------------------------

def prior_inputs(at_zero: bool, seed: int = 1, K: int = 5):
    """Poses [K,4,4] and the fields of a PosePriors with every type active
    (some rows masked, two padding tie rows naming slot 0 twice): at a random
    state, or with every measurement at its pose (zero residual)."""
    rng = np.random.default_rng(seed)
    E = 4
    T = np.stack([_rand_pose(rng) for _ in range(K)]).astype(np.float32)
    if at_zero:
        centers = np.stack([-T[k, :3, :3].T @ T[k, :3, 3] for k in range(K)])
        quats = np.asarray(j_so3.quat_from_mat(jnp.asarray(T[:, :3, :3])))
        dep = T[:, 2, 3]
        tie_T = np.stack([T[1] @ np.linalg.inv(T[0]), T[3] @ np.linalg.inv(T[2]),
                          np.eye(4), np.eye(4)])
    else:
        centers = rng.normal(0, 1, (K, 3))
        quats = rng.normal(0, 1, (K, 4))
        quats /= np.linalg.norm(quats, axis=1, keepdims=True)
        dep = rng.normal(0, 1, K)
        tie_T = np.stack([_rand_pose(rng) for _ in range(E)])
    f32 = np.float32
    fields = dict(
        gps_pos=centers.astype(f32), gps_info=rng.uniform(0.5, 2, (K, 3)).astype(f32),
        gps_valid=np.array([1, 1, 0, 1, 1], bool), imu_quat=quats.astype(f32),
        imu_info=np.full(K, 0.7, f32), imu_valid=np.array([1, 0, 1, 1, 1], bool),
        depth=dep.astype(f32), depth_info=np.full(K, 3.0, f32), depth_valid=np.ones(K, bool),
        tie_a=np.array([0, 2, 0, 0], np.int32), tie_b=np.array([1, 3, 0, 0], np.int32),
        tie_T=tie_T.astype(f32), tie_info=np.full(E, 100.0, f32),
        tie_valid=np.array([1, 1, 0, 0], bool))
    return T, fields


def both_priors(fields):
    return (j_priors.PosePriors(**{k: jnp.asarray(v) for k, v in fields.items()}),
            interop.pose_priors_from_numpy(fields))


def close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL,
                               err_msg=err_msg)


@pytest.mark.parametrize("at_zero", [False, True], ids=["random", "zero_residual"])
@pytest.mark.parametrize("kind", ["gps", "imu", "depth", "tie"])
def test_prior_residual_matches_jax(kind, at_zero):
    """Each residual row for row (a hemisphere flip or a quaternion branch
    that differed would change a whole row's sign, which a cost hides)."""
    T, f = prior_inputs(at_zero)
    Tj, Tt = jnp.asarray(T), torch.from_numpy(T)
    if kind == "tie":
        a, b = f["tie_a"], f["tie_b"]
        want = jax.vmap(j_priors._tie_residual)(Tj[a], Tj[b], jnp.asarray(f["tie_T"]))
        got = priors._tie_residual(Tt[a], Tt[b], torch.from_numpy(f["tie_T"]))
    else:
        meas = {"gps": "gps_pos", "imu": "imu_quat", "depth": "depth"}[kind]
        want = jax.vmap(getattr(j_priors, f"_{kind}_residual"))(Tj, jnp.asarray(f[meas]))
        got = getattr(priors, f"_{kind}_residual")(Tt, torch.from_numpy(f[meas]))
    assert got.shape == want.shape
    close(got.numpy(), want)
    if at_zero and kind != "tie":
        assert float(got.abs().max()) < 1e-6


def test_imu_residual_flips_onto_the_measurements_hemisphere():
    """-q and q measure the same rotation: the residual of the port, as of
    the JAX package, is the one against the nearer of the two."""
    T, f = prior_inputs(True)
    q = torch.from_numpy(f["imu_quat"])
    r_pos = priors._imu_residual(torch.from_numpy(T), q)
    r_neg = priors._imu_residual(torch.from_numpy(T), -q)
    want = jax.vmap(j_priors._imu_residual)(jnp.asarray(T), -jnp.asarray(f["imu_quat"]))
    assert float(r_pos.abs().max()) < 1e-6 and float(r_neg.abs().max()) < 1e-6
    close(r_neg.numpy(), want)


@pytest.mark.parametrize("at_zero", [False, True], ids=["random", "zero_residual"])
def test_prior_cost_and_blocks_match_jax(at_zero):
    T, f = prior_inputs(at_zero)
    pj, pt = both_priors(f)
    Tj, Tt = jnp.asarray(T), torch.from_numpy(T)
    K = T.shape[0]
    close(priors.prior_cost(Tt, pt), j_priors.prior_cost(Tj, pj))
    got = priors.linearize_priors_blocks(Tt, pt)
    want = j_priors.linearize_priors_blocks(Tj, pj)
    for name, g, w in zip(("Hd", "b", "Hab"), got, want):
        assert bool(torch.isfinite(g).all()), name
        close(g.numpy(), w, name)
    if at_zero:
        assert float(priors.prior_cost(Tt, pt)) < 1e-8
        assert float(got[1].abs().max()) < 1e-4     # the gradient vanishes
    dense_t = priors.tie_offdiag_dense(pt, got[2], K)
    close(dense_t.numpy(), j_priors.tie_offdiag_dense(pj, want[2], K), "dense")
    Hd, Hoff, b = priors.linearize_priors(Tt, pt)
    Hd_j, Hoff_j, b_j = j_priors.linearize_priors(Tj, pj)
    close(Hoff.numpy(), Hoff_j, "Hoff")
    close(Hd.numpy(), Hd_j, "Hd")
    close(b.numpy(), b_j, "b")
    # the tie edge couples 0-1 and 2-3 symmetrically, and nothing else
    D = dense_t.numpy().reshape(K, 6, K, 6)
    np.testing.assert_allclose(D[0, :, 1, :], D[1, :, 0, :].T, atol=1e-5)
    assert np.abs(D[0, :, 1, :]).max() > 0 and np.abs(D[2, :, 3, :]).max() > 0
    assert not D[4].any() and not D[0, :, 0, :].any()


@pytest.mark.parametrize("at_zero", [False, True], ids=["random", "zero_residual"])
def test_tie_offdiag_matvec_is_the_dense_product(at_zero):
    T, f = prior_inputs(at_zero)
    pj, pt = both_priors(f)
    K = T.shape[0]
    _, _, Hab = priors.linearize_priors_blocks(torch.from_numpy(T), pt)
    x = np.random.default_rng(9).normal(0, 1, (K, 6)).astype(np.float32)
    mv = priors.tie_offdiag_matvec(pt, Hab, torch.from_numpy(x), K)
    dense = priors.tie_offdiag_dense(pt, Hab, K)
    close(mv.numpy(), (dense @ torch.from_numpy(x).reshape(-1)).reshape(K, 6).numpy())
    close(mv.numpy(), j_priors.tie_offdiag_matvec(pj, jnp.asarray(Hab.numpy()),
                                                  jnp.asarray(x), K))
    no_edges = priors.empty_pose_priors(K)
    assert not priors.tie_offdiag_matvec(no_edges, Hab[:0], torch.from_numpy(x), K).any()
    assert not priors.tie_offdiag_dense(no_edges, Hab[:0], K).any()


def test_prior_cost_positive_away_from_measurement():
    T = torch.eye(4).repeat(2, 1, 1)
    pr = priors.empty_pose_priors(2)._replace(
        depth=torch.tensor([0.5, 0.0]), depth_info=torch.tensor([2.0, 2.0]),
        depth_valid=torch.tensor([True, False]))
    assert float(priors.prior_cost(T, pr)) == pytest.approx(0.5)   # 2 * 0.5^2 on KF0


# ---------------------------------------------------------------------------
# slam/sensor_fusion.py
# ---------------------------------------------------------------------------

def gps_map(n_kf=6, seed=3, with_imu=False):
    """tests/test_sensors.py's ``build_pose_priors`` case: keyframes on a line, the GPS
    frame the SLAM frame rotated 90 degrees about z, and here also scaled by
    1.03 and shifted (the Horn fit estimates the scale), in both packages."""
    caps = j_mapstate.MapCaps(K=8, L=64, F=32, O=4)
    ms = j_mapstate.empty_map_state(caps)
    arena = j_sensordata.empty_sensor_arena(caps.K)
    rng = np.random.default_rng(seed)
    Rz = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    feats = j_empty_features(caps.F)
    for k in range(n_kf):
        Tcw = np.eye(4, dtype=np.float32)
        Tcw[:3, 3] = [-k * 1.0, 0.1 * k * k, 0]
        ms, kf_id = j_mapstate.add_keyframe(ms, feats, jnp.asarray(Tcw), float(k), k, 0,
                                            jnp.full((caps.F,), -1, jnp.int32))
        gps = (1.03 * (Rz @ np.array([k, -0.1 * k * k, 0], np.float32))
               + np.array([12.0, -4.0, 2.0], np.float32) + rng.normal(0, 1e-3, 3))
        sd = dict(gps_rel=tuple(gps), gps_err=(0.1, 0.1, 0.2), gps_valid=True)
        if with_imu:
            sd.update(quat=(1.0, 0.0, 0.0, 0.0), quat_valid=k % 2 == 0, depth=0.3 * k,
                      depth_valid=True)
        arena = j_sensordata.set_sensor(arena, int(kf_id), j_sensordata.SensorData(**sd))
    return ms, arena


def assert_priors_close(got, want):
    if want is None:
        assert got is None
        return
    g, w = tree_np(got), tree_np(want)
    assert set(g) == set(w)
    for k in w:
        if np.issubdtype(w[k].dtype, np.floating):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.mark.parametrize("opt,with_imu,n_kf", [
    (dict(gps_info=1.0), False, 6), (dict(gps_info=2.0, imu_info=0.5, depth_info=5.0), True, 6),
    (dict(gps_info=1.0), False, 4), (dict(imu_info=0.5), True, 4), (dict(), True, 6),
], ids=["gps", "gps_imu_depth", "too_few_fixes", "imu_only", "nothing_weighted"])
def test_build_pose_priors_matches_jax(opt, with_imu, n_kf):
    ms_j, arena_j = gps_map(n_kf, with_imu=with_imu)
    ms_t, arena_t = ms_to_torch(ms_j), interop.sensor_arena_from_numpy(_np_tree(arena_j))
    for tie in (False, True):
        want = j_fusion.build_pose_priors(ms_j, arena_j, JOptimizerInfo(**opt),
                                          include_tiepoints=tie)
        got = sensor_fusion.build_pose_priors(ms_t, arena_t, OptimizerInfo(**opt),
                                              include_tiepoints=tie)
        assert_priors_close(got, want)
    if opt == dict(gps_info=1.0) and n_kf == 6:
        line = np.stack([[k, -0.1 * k * k, 0] for k in range(6)]).astype(np.float32)
        np.testing.assert_allclose(got.gps_pos[:6].numpy(), line, atol=5e-3)
        assert got.gps_valid[:6].all() and float(got.gps_info[:6].min()) > 0
    if n_kf == 4 and "gps_info" in opt or not opt:
        assert got is None


def test_build_pose_priors_none_when_nothing_is_active():
    from hyslam_tpu_torch.core.mapstate import MapCaps, empty_map_state

    ms = empty_map_state(MapCaps(K=8, L=64, F=32, O=4))
    assert sensor_fusion.build_pose_priors(ms, None, OptimizerInfo()) is None
    assert sensor_fusion.build_pose_priors(ms, sensordata.empty_sensor_arena(8),
                                           OptimizerInfo(gps_info=1.0, imu_info=1.0)) is None
    assert sensor_fusion.MIN_GPS_FIXES == j_fusion.MIN_GPS_FIXES == 5


def submap_state():
    """tests/test_sensors.py's remap case: 4 keyframes in map 0, a fifth as
    the origin of a sub-map registered with a tiepoint on keyframe 3."""
    caps = j_mapstate.MapCaps(K=16, L=64, F=32, O=4)
    ms = j_mapstate.empty_map_state(caps)
    feats = j_empty_features(caps.F)
    none = jnp.full((caps.F,), -1, jnp.int32)
    for k in range(4):
        Tk = np.eye(4, dtype=np.float32)
        Tk[2, 3] = -0.5 * k
        ms, _ = j_mapstate.add_keyframe(ms, feats, jnp.asarray(Tk), float(k), k, 0, none,
                                        origin=(k == 0))
    ms, sub = j_mapstate.create_submap(ms)
    Tk = np.eye(4, dtype=np.float32)
    Tk[2, 3] = -2.0
    ms, _ = j_mapstate.add_keyframe(ms, feats, jnp.asarray(Tk), 4.0, 4, 0, none, origin=True)
    return j_mapstate.register_submap(ms, sub, Tse3_parent=jnp.asarray(Tk), tie_kf=3)


def test_build_tiepoint_edges_equals_jax():
    ms_j = submap_state()
    want = j_fusion.build_tiepoint_edges(ms_j)
    got = sensor_fusion.build_tiepoint_edges(ms_to_torch(ms_j))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert got[3].sum() == 1 and got[0][1] == 3 and got[1][1] == 4
    # an unregistered sub-map gives no edge
    ms_u = ms_j._replace(maps=ms_j.maps._replace(
        registered=jnp.zeros_like(ms_j.maps.registered)))
    assert not sensor_fusion.build_tiepoint_edges(ms_to_torch(ms_u))[3].any()


@pytest.mark.parametrize("slots,used", [
    ([3, 4, 0, 0], [True, True, False, False]), ([3, 2, 0, 0], [True, True, False, False]),
    ([4, 1, 3, 0], [True, True, True, True]),
], ids=["both_endpoints", "endpoint_without_slot", "reordered"])
def test_slot_priors_remap_equals_jax(slots, used):
    ms_j = submap_state()
    arena_j = j_sensordata.set_sensor(j_sensordata.empty_sensor_arena(16), 4,
                                      j_sensordata.SensorData(depth=-2.0, depth_valid=True))
    for arena, opt in ((None, {}), (arena_j, dict(depth_info=2.0))):
        want = j_mapper._slot_priors(ms_j, arena, JOptimizerInfo(**opt),
                                     jnp.asarray(slots, jnp.int32), jnp.asarray(used))
        got = mapper._slot_priors(
            ms_to_torch(ms_j),
            None if arena is None else interop.sensor_arena_from_numpy(_np_tree(arena)),
            OptimizerInfo(**opt), torch.tensor(slots, dtype=torch.int32), torch.tensor(used))
        if want is None:
            assert got is None
            continue
        g, w = tree_np(got), tree_np(want)
        for k in w:   # exact: a remap moves values, it computes none
            assert g[k].tobytes() == w[k].astype(g[k].dtype).tobytes(), k
    if slots == [3, 4, 0, 0]:
        e = int(torch.nonzero(got.tie_valid)[0])
        assert int(got.tie_a[e]) == 0 and int(got.tie_b[e]) == 1


def test_local_bundle_adjustment_with_sensors_matches_jax(mapper_input):
    """The prior path of local BA, the way ``Mapper.integrate_keyframe`` takes
    it: a reading on every keyframe of the JAX tracker's map (GPS in a frame
    of its own, IMU and depth 1 cm / 2 mrad off the poses), in both packages."""
    ms_j, ms_t, kf_id = mapper_input
    (m_j, _), _ = _core(ms_j, ms_t, kf_id)
    m_t = ms_to_torch(m_j)
    ok = np.asarray(m_j.kf.valid & ~m_j.kf.bad)
    assert ok.sum() >= sensor_fusion.MIN_GPS_FIXES
    rng = np.random.default_rng(11)
    poses = [_rand_pose(rng, 0.002) @ np.asarray(T, np.float64) for T in np.asarray(m_j.kf.Tcw)]
    readings = synth.render_sensors(poses, seed=4, gps_sigma=(0.01, 0.01, 0.02))
    arena_j = j_sensordata.empty_sensor_arena(m_j.K)
    for k in np.nonzero(ok)[0]:
        arena_j = j_sensordata.set_sensor(arena_j, int(k), j_sensordata.SensorData(**readings[k]))
    arena_t = interop.sensor_arena_from_numpy(_np_tree(arena_j))
    w = dict(gps_info=10.0, imu_info=1.0, depth_info=10.0)
    out_j, cost_j = j_mapper.local_bundle_adjustment(
        m_j, kf_id, DEFAULT_CAM, 16, 2048, sensors=arena_j,
        opt_info=JOptimizerInfo(**w))
    out_t, cost_t = mapper.local_bundle_adjustment(
        m_t, kf_id, CAM, 16, 2048, sensors=arena_t, opt_info=OptimizerInfo(**w))
    np.testing.assert_allclose(float(cost_t), float(cost_j), rtol=1e-4)
    assert_map_close(out_t, out_j, PX_BA)
    # the priors did act: without them the job ends at another cost
    _, cost_0 = mapper._local_ba_noprior(m_t, kf_id, CAM, 16, 2048, 8, 1.2)
    assert abs(float(cost_t) - float(cost_0)) > 1e-3 * float(cost_0)


def test_fetch_returns_each_tensor_in_its_dtype():
    """The one-transfer fetch of ``build_pose_priors``: values and dtypes kept."""
    ts = (torch.tensor([1, -1, 7], dtype=torch.int32), torch.tensor([True, False]),
          torch.tensor(3, dtype=torch.int32), torch.rand(2, 4, 4))
    for got, t in zip(sensor_fusion.fetch(*ts), ts):
        assert got.shape == tuple(t.shape) and got.tobytes() == t.numpy().tobytes()
    assert sensor_fusion.fetch() == []
    # the packed form a card's tensors travel in: exact, or it raises
    for got, t in zip(sensor_fusion._fetch_packed(ts), ts):
        assert got.dtype == t.numpy().dtype and got.tobytes() == t.numpy().tobytes()
    with pytest.raises(OverflowError):
        sensor_fusion._fetch_packed((torch.tensor([2 ** 24 + 1], dtype=torch.int64),))
    with pytest.raises(TypeError):
        sensor_fusion.fetch(torch.zeros(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# solver/ba.py: priors and the CG solve
# ---------------------------------------------------------------------------

def with_priors(prob_j, pr_j):
    """(the JAX problem, the port's) carrying the priors."""
    tp = ba_to_torch(prob_j)
    if pr_j is None:
        return prob_j, tp
    return prob_j._replace(priors=pr_j), tp._replace(
        priors=interop.pose_priors_from_numpy(_np_tree(pr_j)))


def toy_gps():
    prob, kf_T, _ = test_sensors._toy_problem()
    K = kf_T.shape[0]
    shifted = np.stack([-kf_T[k, :3, :3].T @ kf_T[k, :3, 3] for k in range(K)]).astype(np.float32)
    shifted[3] += [0.05, 0.0, 0.0]
    pr = j_priors.empty_pose_priors(K)._replace(
        gps_pos=jnp.asarray(shifted), gps_info=jnp.full((K, 3), 1e6, jnp.float32),
        gps_valid=jnp.asarray([False, False, False, True]))
    return prob, pr, dict(n_iters=15, huber=False), shifted


def toy_tie():
    prob, kf_T, _ = test_sensors._toy_problem()
    K = kf_T.shape[0]
    keep = np.asarray(prob.obs.kf) != 3          # keyframe 3 sees nothing
    prob = prob._replace(obs=prob.obs._replace(valid=prob.obs.valid & jnp.asarray(keep)))
    T_pert = kf_T.copy()
    T_pert[3] = test_sensors._rand_pose(np.random.default_rng(7), 0.1) @ kf_T[3]
    M_meas = (kf_T[3] @ np.linalg.inv(kf_T[0])).astype(np.float32)
    pr = j_priors.empty_pose_priors(K, E=1)._replace(
        tie_a=jnp.asarray([0]), tie_b=jnp.asarray([3]), tie_T=jnp.asarray(M_meas[None]),
        tie_info=jnp.full(1, 1e4, jnp.float32), tie_valid=jnp.ones(1, bool))
    return prob._replace(kf_Tcw=jnp.asarray(T_pert)), pr, dict(n_iters=20, huber=False), kf_T


def assert_ba_result_close(got, want):
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(want.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(want.obs_inlier))


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_gps_prior_pulls_free_pose(solver):
    prob, pr, kw, shifted = toy_gps()
    pj, pt = with_priors(prob, pr)
    got = ba.bundle_adjustment(pt, solver=solver, **kw)
    assert_ba_result_close(got, j_ba.bundle_adjustment(pj, solver=solver, **kw))
    T3 = got.kf_Tcw[3].numpy()
    assert np.linalg.norm(-T3[:3, :3].T @ T3[:3, 3] - shifted[3]) < 0.02


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_tie_edge_constrains_disconnected_pose(solver):
    prob, pr, kw, kf_T = toy_tie()
    pj, pt = with_priors(prob, pr)
    got = ba.bundle_adjustment(pt, solver=solver, **kw)
    assert_ba_result_close(got, j_ba.bundle_adjustment(pj, solver=solver, **kw))
    assert np.abs(got.kf_Tcw[3].numpy() - kf_T[3]).max() < 1e-2


def test_priors_none_matches_baseline():
    prob, _, _ = test_sensors._toy_problem()
    _, pt = with_priors(prob, None)
    r0 = ba.bundle_adjustment(pt, n_iters=3)
    r1 = ba.bundle_adjustment(pt._replace(priors=None), n_iters=3)
    assert torch.equal(r0.kf_Tcw, r1.kf_Tcw) and torch.equal(r0.lm_pos, r1.lm_pos)
    assert_ba_result_close(r0, j_ba.bundle_adjustment(prob, n_iters=3))
    # priors that are all masked add nothing to the cost or the step
    empty = priors.empty_pose_priors(prob.kf_Tcw.shape[0], E=2)
    r2 = ba.bundle_adjustment(pt._replace(priors=empty), n_iters=3)
    np.testing.assert_allclose(r2.kf_Tcw.numpy(), r0.kf_Tcw.numpy(), atol=1e-6)


def _tied(prob):
    """tests/test_solver.py's CG-with-priors case: a tiepoint edge 0 -> 3
    measured from the (perturbed) current poses."""
    K = prob.kf_Tcw.shape[0]
    pr = j_priors.empty_pose_priors(K, E=2)
    M = np.asarray(prob.kf_Tcw[3]) @ np.linalg.inv(np.asarray(prob.kf_Tcw[0]))
    return pr._replace(
        tie_a=pr.tie_a.at[0].set(0), tie_b=pr.tie_b.at[0].set(3),
        tie_T=pr.tie_T.at[0].set(jnp.asarray(M)), tie_info=pr.tie_info.at[0].set(1.0),
        tie_valid=pr.tie_valid.at[0].set(True))


@pytest.mark.parametrize("tied,n_iters", [(False, 8), (True, 6)],
                         ids=["cg_matches_dense", "cg_with_priors_matches_dense"])
def test_cg_solver_matches_jax_and_dense(tied, n_iters, rng):
    prob, _, _ = test_solver.build_ba_problem(rng)
    pj, pt = with_priors(prob, _tied(prob) if tied else None)
    kw = dict(n_iters=n_iters, chunk=64)
    got = ba.bundle_adjustment(pt, solver="cg", **kw)
    want = j_ba.bundle_adjustment(pj, solver="cg", **kw)
    np.testing.assert_allclose(got.kf_Tcw.numpy(), np.asarray(want.kf_Tcw), atol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(want.cost), rtol=1e-4)
    dense = ba.bundle_adjustment(pt, solver="dense", **kw)
    np.testing.assert_allclose(got.kf_Tcw.numpy(), dense.kf_Tcw.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(dense.cost), rtol=1e-4)


@pytest.mark.parametrize("tied", [False, True], ids=["no_priors", "tie_edge"])
def test_cg_pose_step_matches_dense_and_jax(tied, rng):
    """One linearization, both solves: the CG step within 1e-3 relative of
    the dense one (float32 CG at tol 1e-5 may stop an iteration apart for
    another summation order) and of the JAX package's CG step."""
    prob, _, _ = test_solver.build_ba_problem(rng)
    pj, pt = with_priors(prob, _tied(prob) if tied else None)
    lam = torch.tensor(1e-4)
    K = pt.kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, _, _, _, kf_idx = ba._linearize_factors(
        pt, pt.kf_Tcw, pt.lm_pos, lam, pt.obs.valid, True)
    Hab = None
    if tied:
        Hd, b_pr, Hab = priors.linearize_priors_blocks(pt.kf_Tcw, pt.priors)
        Hpp, b_pose = Hpp + Hd, b_pose + b_pr
    S_red, b_red = ba._schur_reduce_dense(Y, y, kf_idx, K, 64)
    np.testing.assert_allclose(ba._reduced_rhs(Y, y, kf_idx, K).numpy(), b_red.numpy(),
                               rtol=1e-4, atol=1e-3)
    x = torch.from_numpy(rng.normal(0, 1, (K, 6)).astype(np.float32))
    np.testing.assert_allclose(ba._reduced_matvec(Y, kf_idx, x).reshape(-1).numpy(),
                               (S_red @ x.reshape(-1)).numpy(), rtol=1e-4, atol=1e-2)
    diag = S_red.reshape(K, 6, K, 6)[range(K), :, range(K), :]
    np.testing.assert_allclose(ba._reduced_diag(Y, kf_idx, K).numpy(), diag.numpy(),
                               rtol=1e-4, atol=1e-2)
    if tied:
        S_red = S_red - priors.tie_offdiag_dense(pt.priors, Hab, K)
    d_dense = ba._solve_poses(Hpp, b_pose, S_red, b_red, pt.kf_fixed, lam)
    d_cg = ba._solve_poses_cg(Hpp, b_pose, b_red, Y, kf_idx, pt.kf_fixed, lam,
                              priors=pt.priors, Hab=Hab)
    scale = float(d_dense.abs().max())
    assert scale > 1e-3
    np.testing.assert_allclose(d_cg.numpy(), d_dense.numpy(), atol=1e-3 * scale)
    j = lambda t: jnp.asarray(t.numpy())
    d_jax = j_ba._solve_poses_cg(j(Hpp), j(b_pose), j(b_red), j(Y), j(kf_idx.to(torch.int32)),
                                 j(pt.kf_fixed), 1e-4, priors=pj.priors,
                                 Hab=None if Hab is None else j(Hab))
    np.testing.assert_allclose(d_cg.numpy(), np.asarray(d_jax), atol=1e-3 * scale)
    assert not d_cg[:2].any()                      # the fixed poses do not move


@pytest.fixture
def one_thread():
    """A float scatter-add on the CPU sums in an order that depends on how
    its rows fall to the threads; with one thread two runs give the same
    bits (a card's accumulate is ordered)."""
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(2)


def test_cg_stops_changing_once_converged(one_thread):
    """The loop runs a fixed count with a converged mask: more iterations
    past convergence give the same bits, and a zero right side a zero step.
    (At the default tol of 1e-5 this float32 system never converges and
    both packages run all 200 iterations.)"""
    rng = np.random.default_rng(5)
    prob, _, _ = test_solver.build_ba_problem(rng)
    pt = ba_to_torch(prob)
    lam = torch.tensor(1e-4)
    K = pt.kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, _, _, _, kf_idx = ba._linearize_factors(
        pt, pt.kf_Tcw, pt.lm_pos, lam, pt.obs.valid, True)
    b_red = ba._reduced_rhs(Y, y, kf_idx, K)
    few, a, b = (ba._solve_poses_cg(Hpp, b_pose, b_red, Y, kf_idx, pt.kf_fixed, lam,
                                    n_cg=n, tol=1e-3) for n in (3, 60, 90))
    assert torch.equal(a, b) and not torch.equal(few, a)
    z = ba._solve_poses_cg(Hpp, b_red, b_red, Y, kf_idx, pt.kf_fixed, lam)
    assert not z.any()


def test_solver_auto_routes_to_cg_from_cg_min_keyframes(monkeypatch, rng, one_thread):
    """solver="auto" is dense below CG_MIN_KEYFRAMES (512, as the JAX
    package) and CG from there on; an unknown name is refused."""
    assert ba.CG_MIN_KEYFRAMES == 512
    prob, _, _ = test_solver.build_ba_problem(rng)
    pt = ba_to_torch(prob)
    assert ba._resolve_solver(pt, "auto") == "dense"
    big = pt._replace(kf_Tcw=torch.eye(4).repeat(512, 1, 1))
    assert ba._resolve_solver(big, "auto") == "cg"
    with pytest.raises(ValueError, match="unknown solver"):
        ba.bundle_adjustment(pt, solver="sparse")
    monkeypatch.setattr(ba, "CG_MIN_KEYFRAMES", 4)
    auto = ba.bundle_adjustment(pt, n_iters=3, chunk=64, solver="auto")
    cg = ba.bundle_adjustment(pt, n_iters=3, chunk=64, solver="cg")
    assert torch.equal(auto.kf_Tcw, cg.kf_Tcw)


# ---------------------------------------------------------------------------
# utils/synth.py: the sensor renderer
# ---------------------------------------------------------------------------

def test_render_sensors_and_blackout():
    Ts = synth.make_trajectory(8, step=0.3, yaw_rate=0.02)
    a, b = synth.render_sensors(Ts, seed=2), synth.render_sensors(Ts, seed=2)
    assert a == b and a != synth.render_sensors(Ts, seed=3) and len(a) == 8
    sd = [sensordata.SensorData(**d) for d in a]
    assert j_sensordata.SensorData(**a[0]) == tuple(sd[0])
    # the fixes are the camera centres in a rotated, scaled and shifted
    # frame: a Horn fit carries them back within their noise, and at a small
    # noise reads the scale
    centres = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts]).astype(np.float32)
    gps = np.asarray([s.gps_rel for s in sd], np.float32)
    assert np.abs(gps - centres).min() > 5.0
    g, _ = sensor_fusion.gps_alignment(centres, gps)
    back = sensor_fusion.sim3.apply(torch.from_numpy(g), torch.from_numpy(gps)).numpy()
    assert np.abs(back - centres).max() < 0.15
    quiet = np.asarray([d["gps_rel"] for d in synth.render_sensors(Ts, seed=2, gps_sigma=(1e-3,) * 3)],
                       np.float32)
    g, _ = sensor_fusion.gps_alignment(centres, quiet)
    assert synth.GPS_SCALE != 1.0 and abs(float(g[0]) * synth.GPS_SCALE - 1.0) < 2e-3
    for s, T in zip(sd, Ts):
        assert s.depth == pytest.approx(float(T[2, 3])) and s.quat[0] >= 0
        R = j_so3.mat_from_quat(jnp.asarray(s.quat, jnp.float32))
        np.testing.assert_allclose(np.asarray(R), T[:3, :3], atol=1e-5)
    frames = np.arange(5 * 2 * 3 * 4, dtype=np.float32).reshape(5, 2, 3, 4)
    dark = synth.blackout(frames, 1, 3)
    assert (dark[1:3] == 20.0).all() and (dark[[0, 3, 4]] == frames[[0, 3, 4]]).all()
    assert frames[1].max() > 20.0
