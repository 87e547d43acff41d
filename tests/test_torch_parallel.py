"""The port's ``parallel`` package (``hyslam_tpu_torch/parallel``) on the CPU:
four gloo ranks against the JAX package on its 8-device virtual CPU mesh.

One module-scoped spawn of 4 ranks (``tests/torch_dist_ranks.py``, which
imports no JAX) runs every case while this process computes the JAX
package's results and the port's single-process ones on the same numpy
inputs. The bounds:

- BA, 1-D dense and cg, 2-D with and without priors, against JAX's
  ``distributed_bundle_adjustment(_2d)``: tests/test_parallel.py's (rot <
  0.05, tr < 0.01, cost within 10% + 5);
- the same ranks against the port's single-process ``bundle_adjustment``
  (1 thread): poses within 1e-3 entry by entry, cost within 2e-5 relative,
  inlier masks equal and the inliers' chi2 within 1e-2 (seen: 2.3e-4,
  6.7e-6 and 2.9e-3; the sums are taken in another order, and near the
  minimum LM's accept decisions then part: the single-process and the JAX
  runs agree to 1.2e-6 in pose on the same problems);
- every rank returns the same bits;
- the pose graph: tests/test_dist_pose_graph.py's atol 5e-4 against JAX's
  ``distributed_pose_graph``, 1e-5 against the port's
  ``optimize_pose_graph``;
- camera-sharded extraction: the bits of ``extract_atlas_batch`` over the
  whole batch;
- ``run_global_ba(mesh=)`` on a 1-D and a folded 2-D mesh against JAX's
  ``run_global_ba(mesh=make_mesh(8))``: poses within 1e-4, cost within
  1e-5 relative; against the port without a mesh: poses and landmarks
  within 1e-5, cost within 1e-6 relative (seen: equal bits).
"""

import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.parallel.dist_ba import (
    distributed_bundle_adjustment as j_dist_ba,
    distributed_bundle_adjustment_2d as j_dist_ba_2d,
)
from hyslam_tpu.parallel.dist_pose_graph import distributed_pose_graph as j_dist_pg
from hyslam_tpu.parallel.mesh import make_mesh as j_make_mesh, make_mesh_2d as j_make_mesh_2d
from hyslam_tpu.slam import global_ba as jgba
from hyslam_tpu.solver.priors import empty_pose_priors as j_empty_priors
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.core.mapstate import MapCaps
from hyslam_tpu_torch.features.atlas import extract_atlas_batch
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.parallel import launch, mesh as tmesh
from hyslam_tpu_torch.slam import global_ba as gba
from hyslam_tpu_torch.slam.keyframe_policy import KeyFramePolicyParams
from hyslam_tpu_torch.slam.tracker import Tracker
from hyslam_tpu_torch.solver import ba, pose_graph

import torch_dist_ranks
from helpers import DEFAULT_CAM, pose_error
from port_helpers import feats_to_torch, one_thread  # noqa: F401
from test_dist_pose_graph import _loop_problem, _pad_edges
from test_solver import build_ba_problem
from test_torch_tracker import CAPS, sequence

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_MAP = 8           # frames of the port's tracker that make run_global_ba's map
GBA_ITERS = 5


def _priors(prob, Ts_true):
    """tests/test_parallel.py's GPS and tiepoint priors."""
    K = prob.kf_Tcw.shape[0]
    Ts = np.stack(Ts_true)
    centers = -np.einsum("kji,kj->ki", Ts[:, :3, :3], Ts[:, :3, 3])
    return j_empty_priors(K, E=1)._replace(
        gps_pos=jnp.asarray(centers.astype(np.float32)),
        gps_info=jnp.full((K, 3), 25.0),
        gps_valid=jnp.asarray(np.arange(K) % 2 == 0),
        tie_a=jnp.asarray([1], jnp.int32), tie_b=jnp.asarray([6], jnp.int32),
        tie_T=jnp.asarray((Ts[6] @ np.linalg.inv(Ts[1])).astype(np.float32)[None]),
        tie_info=jnp.asarray([100.0]), tie_valid=jnp.asarray([True]))


def _to_np(p):
    return interop.ba_problem_to_numpy(interop.ba_problem_from_numpy(p))


def _port_map():
    """A map of the port's tracker over N_MAP frames of
    tests/test_torch_tracker.py's sequence: keyframes, landmarks, local BA."""
    _, feats = sequence(n_frames=N_MAP)
    tr = Tracker(cam=interop.camera_from(DEFAULT_CAM), caps=MapCaps(*CAPS),
                 policy=KeyFramePolicyParams(max_kf_interval=10), device="cpu")
    for i, f in enumerate(feats):
        tr.track(feats_to_torch(f), timestamp=0.1 * i, frame_id=i)
    return tr.ms


def _jax_map(ms_np):
    from hyslam_tpu.core import mapstate as JM

    def tup(cls, d):
        return cls(**{k: jnp.asarray(d[k].view(np.uint32) if k == "desc" else d[k])
                      for k in cls._fields})

    return JM.MapState(kf=tup(JM.KeyFrameArena, ms_np["kf"]),
                       lm=tup(JM.LandmarkArena, ms_np["lm"]),
                       maps=tup(JM.MapTable, ms_np["maps"]),
                       **{k: jnp.asarray(ms_np[k]) for k in ("covis", "next_kf", "next_lm")})


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Inputs, the 4 ranks' outputs, the JAX results and the port's
    single-process results."""
    tmpd = tmp_path_factory.mktemp("dist")
    prob1, Ts1, _ = build_ba_problem(np.random.default_rng(0), n_lm=160)
    prob2, Ts2, _ = build_ba_problem(np.random.default_rng(0), n_kf=8, n_lm=160)
    prob2p = prob2._replace(priors=_priors(prob2, Ts2))
    K = 12
    g_true, g_est, ei, ej, meas = _loop_problem(K)
    eis, ejs, meass, valid = _pad_edges(ei, ej, meas, 8)
    fixed = np.arange(K) == 0
    imgs = np.random.default_rng(0).uniform(0, 255, (8, 96, 128)).astype(np.float32)
    ms = _port_map()
    ms_np = interop.map_state_to_numpy(ms)
    inp = {
        "ba": _to_np(prob1), "ba2d": _to_np(prob2), "ba2d_priors": _to_np(prob2p),
        "pose_graph": {"g": np.asarray(g_est), "fixed": fixed, "ei": np.asarray(eis),
                       "ej": np.asarray(ejs), "meas": np.asarray(meass),
                       "valid": np.asarray(valid)},
        "imgs": imgs, "extract_cfg": dict(n_features=64, n_levels=3), "capacity": 64,
        "cam": interop.camera_from(DEFAULT_CAM), "map": ms_np, "gba_iters": GBA_ITERS,
    }
    in_path = tmpd / "inputs.pkl"
    with open(in_path, "wb") as f:
        pickle.dump(inp, f)
    init_file = tmpd / "rendezvous"
    ctx = launch.start_ranks(torch_dist_ranks.run_rank, torch_dist_ranks.WORLD,
                             (str(init_file), str(in_path), str(tmpd)))
    try:
        # the JAX package on its 8-device mesh, while the ranks run
        mesh8 = j_make_mesh(8)
        jx = {f"ba_{s}": j_dist_ba(prob1, mesh8, n_iters=6, chunk=20, solver=s)
              for s in ("dense", "cg")}
        mesh2d = j_make_mesh_2d(8, kf=2)
        jx["ba2d"] = j_dist_ba_2d(prob2, mesh2d, n_iters=6, chunk=20)
        jx["ba2d_priors"] = j_dist_ba_2d(prob2p, mesh2d, n_iters=6, chunk=20)
        jx["pose_graph"] = j_dist_pg(g_est, jnp.asarray(fixed), eis, ejs, meass, valid, mesh8)
        jms, jcost = jgba.run_global_ba(_jax_map(ms_np), DEFAULT_CAM, n_iters=GBA_ITERS,
                                        mesh=mesh8)
        jx["gba"] = dict(Tcw=np.asarray(jms.kf.Tcw), pos=np.asarray(jms.lm.pos), cost=jcost)
        jx = jax.tree.map(np.asarray, jx)

        # the port in this process, one rank's worth of everything
        pt = {}
        p1 = interop.ba_problem_from_numpy(inp["ba"], "cpu")
        for s in ("dense", "cg"):
            pt[f"ba_{s}"] = ba.bundle_adjustment(p1, n_iters=6, chunk=20, solver=s)
        for name in ("ba2d", "ba2d_priors"):
            pt[name] = ba.bundle_adjustment(interop.ba_problem_from_numpy(inp[name], "cpu"),
                                            n_iters=6, chunk=20, solver="cg")
        pg = {k: torch.from_numpy(np.array(v)) for k, v in inp["pose_graph"].items()}
        pt["pose_graph"] = pose_graph.optimize_pose_graph(
            pg["g"], pg["fixed"], pg["ei"], pg["ej"], pg["meas"], pg["valid"], solver="dense")
        pt["extract"] = extract_atlas_batch(torch.from_numpy(imgs), ExtractorConfig(
            n_features=64, n_levels=3), 64)
        ms2, cost = gba.run_global_ba(ms, inp["cam"], n_iters=GBA_ITERS)
        pt["gba"] = dict(Tcw=ms2.kf.Tcw.numpy(), pos=ms2.lm.pos.numpy(), cost=cost)
    finally:
        launch.join_ranks(ctx, torch_dist_ranks.TIMEOUT_S)
    ranks = []
    for r in range(torch_dist_ranks.WORLD):
        with open(tmpd / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return dict(inp=inp, ranks=ranks, jax=jx, port=pt, Ts1=Ts1, Ts2=Ts2, g_true=g_true,
                g_est=np.asarray(g_est))


def _close_poses(got, want, n, rot=0.05, tr=0.01):
    for k in range(n):
        r, t = pose_error(np.asarray(got[k]), np.asarray(want[k]))
        assert r < rot and t < tr, (k, r, t)


def _cost_close(got, want):
    assert abs(float(got) - float(want)) < 0.1 * float(want) + 5.0, (got, want)


def test_mesh_shapes_and_coordinates(world):
    """make_mesh over all 4 ranks and over the first 2, make_mesh_2d (2, 2)
    in row order, and its fold into one 'lm' axis of 4."""
    for r, out in enumerate(world["ranks"]):
        m = out["mesh"]
        assert m["shape4"] == {"lm": 4, "model": 1} and m["coords4"] == {"lm": r, "model": 0}
        assert m["coords2"] == ({"lm": r, "model": 0} if r < 2 else None)
        assert m["shape2d"] == {"kf": 2, "lm": 2}
        assert m["coords2d"] == {"kf": r // 2, "lm": r % 2}
        assert m["folded"] == {"lm": 4}


def test_mesh_needs_a_process_group():
    """No default group: make_mesh raises; there is no quiet one-rank mesh."""
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh(device="cpu")
    with pytest.raises(RuntimeError, match="init_process_group"):
        tmesh.make_mesh_2d(device="cpu")


@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_dist_ba_matches_jax(world, solver):
    got, want = world["ranks"][0][f"ba_{solver}_4"], world["jax"][f"ba_{solver}"]
    _close_poses(got.kf_Tcw, want.kf_Tcw, len(world["Ts1"]))
    _cost_close(got.cost, want.cost)
    for k in range(2, len(world["Ts1"])):   # tests/test_parallel.py's truth bound
        r, t = pose_error(got.kf_Tcw[k], world["Ts1"][k])
        assert r < 0.2 and t < 0.04, (k, r, t)


@pytest.mark.parametrize("case", ["ba_dense_4", "ba_cg_4", "ba_dense_2", "ba_cg_2",
                                  "ba2d", "ba2d_priors"])
def test_dist_ba_matches_the_single_process_port(world, case):
    """4 ranks (2 for *_2, kf 2 x lm 2 for ba2d) against the port's
    bundle_adjustment on one rank, to the module docstring's bounds."""
    got = world["ranks"][0][case]
    key = case if case.startswith("ba2d") else case[:-2]
    want = world["port"][key]
    np.testing.assert_allclose(got.kf_Tcw, want.kf_Tcw.numpy(), atol=1e-3)
    assert abs(float(got.cost) - float(want.cost)) <= 2e-5 * float(want.cost)
    inl = want.obs_inlier.numpy()
    np.testing.assert_array_equal(got.obs_inlier, inl)
    np.testing.assert_allclose(got.obs_chi2[inl], want.obs_chi2.numpy()[inl], atol=1e-2)
    assert got.lm_pos.shape == want.lm_pos.shape and np.isfinite(got.lm_pos).all()


@pytest.mark.parametrize("case", ["ba2d", "ba2d_priors"])
def test_dist_ba_2d_matches_jax(world, case):
    got, want = world["ranks"][0][case], world["jax"][case]
    _close_poses(got.kf_Tcw, want.kf_Tcw, len(world["Ts2"]))
    _cost_close(got.cost, want.cost)


def test_every_rank_returns_the_same_bits(world):
    first = world["ranks"][0]
    for out in world["ranks"][1:]:
        for case in ("ba_dense_4", "ba_cg_4", "ba_auto_4", "ba2d", "ba2d_priors"):
            for a, b in zip(first[case], out[case]):
                assert a.tobytes() == b.tobytes(), case
        assert first["pose_graph"].tobytes() == out["pose_graph"].tobytes()
        for name in ("gba_1d", "gba_2d"):
            assert first[name]["Tcw"].tobytes() == out[name]["Tcw"].tobytes()
            assert first[name]["pos"].tobytes() == out[name]["pos"].tobytes()
    assert world["ranks"][1]["ba_dense_2"].cost.tobytes() == first["ba_dense_2"].cost.tobytes()


def test_auto_takes_dense_below_512_keyframes_and_indivisible_raises(world):
    r0 = world["ranks"][0]
    assert r0["ba_auto_4"].kf_Tcw.tobytes() == r0["ba_dense_4"].kf_Tcw.tobytes()
    assert "not divisible" in r0["ba_raises_3"]
    assert "not divisible" in r0["pose_graph_raises"]
    with pytest.raises(ValueError, match="unknown solver"):
        from hyslam_tpu_torch.parallel.dist_ba import distributed_bundle_adjustment
        distributed_bundle_adjustment(interop.ba_problem_from_numpy(world["inp"]["ba"]),
                                      None, solver="lu")


def test_dist_pose_graph_matches_jax_and_the_port(world):
    got = world["ranks"][0]["pose_graph"]
    np.testing.assert_allclose(got, world["jax"]["pose_graph"], atol=5e-4)
    np.testing.assert_allclose(got, world["port"]["pose_graph"].numpy(), atol=1e-5)
    K = got.shape[0]
    g_true = np.asarray(world["g_true"])
    err0 = np.linalg.norm(world["g_est"][K - 1][5:] - g_true[K - 1][5:])
    assert np.linalg.norm(got[K - 1][5:] - g_true[K - 1][5:]) < 0.1 * err0


def test_extract_cameras_sharded_equals_the_whole_batch(world):
    want = world["port"]["extract"]
    for r, out in enumerate(world["ranks"]):
        for name, a, b in zip(want._fields, out["extract"], want):
            assert a.tobytes() == b.numpy().tobytes(), (r, name)
        shard, off = out["extract_shard"]
        assert off == 2 * r and shard.uv.shape[0] == 2
        assert shard.desc.tobytes() == want.desc[off:off + 2].numpy().tobytes()
        assert "not divisible" in out["extract_raises"]


@pytest.mark.parametrize("name", ["gba_1d", "gba_2d"])
def test_run_global_ba_with_a_mesh_matches_jax(world, name):
    got, want, port = world["ranks"][0][name], world["jax"]["gba"], world["port"]["gba"]
    np.testing.assert_allclose(got["Tcw"], want["Tcw"], atol=1e-4)
    assert abs(got["cost"] - float(want["cost"])) <= 1e-5 * float(want["cost"])
    np.testing.assert_allclose(got["Tcw"], port["Tcw"], atol=1e-5)
    np.testing.assert_allclose(got["pos"], port["pos"], atol=1e-5)
    assert abs(got["cost"] - port["cost"]) <= 1e-6 * port["cost"]


def test_bench_problem_equals_the_jax_builder():
    """tools/bench_multihost_torch.build_problem draws bench_multihost's
    arrays bit for bit (at a small size)."""
    sys.path.insert(0, REPO)
    from bench_multihost import build_problem as j_build
    from tools.bench_multihost_torch import build_problem

    got = build_problem(K=8, L=512, O=4, seed=3)
    want = _to_np(j_build(K=8, L=512, O=4, seed=3))
    for k in ("kf_Tcw", "kf_fixed", "lm_pos", "lm_valid"):
        assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes(), k
    for part in ("cams", "obs"):
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype, (part, k)
            assert got[part][k].tobytes() == v.tobytes(), (part, k)
    assert got["priors"] is None
