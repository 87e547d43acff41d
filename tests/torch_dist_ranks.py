"""The ranks of tests/test_torch_parallel.py: a process each, started by
``torch.multiprocessing`` with the spawn method, which imports this module
(and so only torch and the port, never JAX) in every rank.

Every rank joins one gloo process group of WORLD ranks on the CPU, reads
the inputs the test wrote (numpy, pickled), runs every case of the port's
``parallel`` package and writes what it got, as numpy, to
``rank{r}.pkl``. A case that must raise is run where it raises before any
collective, so that no rank is left waiting."""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
import torch.distributed as dist

from hyslam_tpu_torch.parallel import launch

WORLD = 4
TIMEOUT_S = 240


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple):
        return type(x)(*(_np(v) for v in x)) if hasattr(x, "_fields") else tuple(map(_np, x))
    return x


def _raises(fn) -> str | None:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def run_cases(inp: dict) -> dict:
    from hyslam_tpu_torch import interop
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.parallel.dist_ba import (
        distributed_bundle_adjustment,
        distributed_bundle_adjustment_2d,
    )
    from hyslam_tpu_torch.parallel.dist_pose_graph import distributed_pose_graph
    from hyslam_tpu_torch.parallel.mesh import make_mesh, make_mesh_2d
    from hyslam_tpu_torch.parallel.multicam import extract_cameras_sharded
    from hyslam_tpu_torch.slam.global_ba import run_global_ba

    cpu = "cpu"
    mesh4 = make_mesh(device=cpu)
    mesh3 = make_mesh(3, device=cpu)
    mesh2 = make_mesh(2, device=cpu)
    mesh2d = make_mesh_2d(device=cpu, kf=2)
    out = {"mesh": dict(shape4=mesh4.shape, coords4=mesh4.coords, coords2=mesh2.coords,
                        shape2d=mesh2d.shape, coords2d=mesh2d.coords,
                        folded=mesh2d.folded().shape)}

    p = interop.ba_problem_from_numpy(inp["ba"], cpu)
    kw = dict(n_iters=6, chunk=20)
    for solver in ("dense", "cg"):
        out[f"ba_{solver}_4"] = _np(distributed_bundle_adjustment(p, mesh4, solver=solver, **kw))
        if mesh2.coords is not None:
            out[f"ba_{solver}_2"] = _np(distributed_bundle_adjustment(p, mesh2, solver=solver,
                                                                      **kw))
    out["ba_auto_4"] = _np(distributed_bundle_adjustment(p, mesh4, **kw))
    if mesh3.coords is not None:
        out["ba_raises_3"] = _raises(lambda: distributed_bundle_adjustment(p, mesh3, **kw))
    for name in ("ba2d", "ba2d_priors"):
        p2 = interop.ba_problem_from_numpy(inp[name], cpu)
        out[name] = _np(distributed_bundle_adjustment_2d(p2, mesh2d, **kw))

    g = {k: torch.from_numpy(np.array(v)) for k, v in inp["pose_graph"].items()}
    out["pose_graph"] = _np(distributed_pose_graph(
        g["g"], g["fixed"], g["ei"], g["ej"], g["meas"], g["valid"], mesh4))
    out["pose_graph_raises"] = _raises(lambda: distributed_pose_graph(
        g["g"], g["fixed"], g["ei"][:-1], g["ej"][:-1], g["meas"][:-1], g["valid"][:-1],
        mesh4))

    cfg = ExtractorConfig(**inp["extract_cfg"])
    imgs = torch.from_numpy(inp["imgs"])
    out["extract"] = _np(extract_cameras_sharded(imgs, cfg, inp["capacity"], mesh4,
                                                 gather=True))
    shard, off = extract_cameras_sharded(imgs, cfg, inp["capacity"], mesh4)
    out["extract_shard"] = (_np(shard), off)
    out["extract_raises"] = _raises(lambda: extract_cameras_sharded(
        imgs[:3], cfg, inp["capacity"], mesh4))

    cam = inp["cam"]
    for name, mesh in (("gba_1d", mesh4), ("gba_2d", mesh2d)):
        ms = interop.map_state_from_numpy(inp["map"], cpu)
        ms2, cost = run_global_ba(ms, cam, n_iters=inp["gba_iters"], mesh=mesh)
        out[name] = dict(Tcw=_np(ms2.kf.Tcw), pos=_np(ms2.lm.pos), cost=cost)
    return out


def run_rank(rank: int, init_file: str, in_path: str, out_dir: str) -> None:
    """One rank: join the group, run every case, write rank{rank}.pkl."""
    torch.set_num_threads(1)
    launch.init_rank(rank, WORLD, f"file://{init_file}", "gloo", TIMEOUT_S)
    try:
        with open(in_path, "rb") as f:
            inp = pickle.load(f)
        out = run_cases(inp)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
