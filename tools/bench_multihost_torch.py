"""BA scaling of the PyTorch port: LM iterations/s of the landmark-sharded
``parallel.dist_ba.distributed_bundle_adjustment`` on 1, 2 and 4 ranks
(the twin of bench_multihost.py, with ``torch.distributed`` ranks in place
of JAX devices).

    python3 tools/bench_multihost_torch.py [out.json] [--ranks 1,2,4]
        [--backend gloo|nccl] [--device cpu] [--solver auto|dense|cg]

Each rank count is one spawn of that many ranks, rank r on
``cuda:{r % device_count}`` (or the CPU with ``--device cpu``). NCCL refuses
two ranks on one card, so ranks that share one run gloo, the default, and
their lines say so: they check the sharded path, and their efficiency is
not a scaling figure. Prints one JSON line a rank count, each with the
card's name.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def build_problem(K=64, L=65536, O=8, seed=0) -> dict:
    """bench_multihost.build_problem's arrays, bit for bit, in numpy: a
    ``interop.ba_problem_to_numpy`` dict (``interop.ba_problem_from_numpy``
    makes the port's BAProblem of it)."""
    rng = np.random.default_rng(seed)
    fx = fy = np.float32(450.0)
    cx, cy, bf = np.float32(320.0), np.float32(240.0), np.float32(45.0)
    pts = np.stack([rng.uniform(-10, 10, L), rng.uniform(-6, 6, L),
                    rng.uniform(4, 40, L)], -1).astype(np.float32)
    kf_T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    kf_T[:, 2, 3] = -0.3 * np.arange(K)
    obs_kf = rng.integers(0, K, (L, O)).astype(np.int32)
    pc = np.einsum("loij,lj->loi", kf_T[obs_kf][..., :3, :3], pts) + \
        kf_T[obs_kf][..., :3, 3]
    z = np.maximum(pc[..., 2], np.float32(0.5))
    uv = np.stack([fx * pc[..., 0] / z + cx, fy * pc[..., 1] / z + cy], -1).astype(np.float32)
    uv += rng.normal(0, 0.4, uv.shape).astype(np.float32)
    lm_pos = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)

    def full(v):
        return np.full(K, v, np.float32)

    return {
        "kf_Tcw": kf_T, "kf_fixed": np.arange(K) < 1,
        "lm_pos": lm_pos, "lm_valid": np.ones(L, bool),
        "cams": {"fx": full(fx), "fy": full(fy), "cx": full(cx), "cy": full(cy),
                 "bf": full(bf)},
        "obs": {"kf": obs_kf, "uv": uv, "ur": uv[..., 0] - bf / z,
                "inv_sigma2": np.ones((L, O), np.float32),
                "stereo": np.ones((L, O), bool), "valid": z > 0.5},
        "priors": None,
    }


def _rank(rank, world, init, backend, device, solver, n_iters, reps, prob_path, out_path):
    import torch

    from hyslam_tpu_torch import interop
    from hyslam_tpu_torch.parallel import launch
    from hyslam_tpu_torch.parallel.dist_ba import distributed_bundle_adjustment
    from hyslam_tpu_torch.parallel.mesh import make_mesh

    launch.init_rank(rank, world, init, backend, timeout_s=600)
    try:
        mesh = make_mesh(device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        with open(prob_path, "rb") as f:
            p = interop.ba_problem_from_numpy(pickle.load(f))

        def sync():
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)

        res = distributed_bundle_adjustment(p, mesh, n_iters=n_iters, solver=solver)
        sync()                                          # warm
        torch.distributed.barrier(device_ids=[mesh.device.index]
                                  if backend == "nccl" else None)
        t0 = time.perf_counter()
        for _ in range(reps):
            res = distributed_bundle_adjustment(p._replace(kf_Tcw=res.kf_Tcw), mesh,
                                                n_iters=n_iters, solver=solver)
        sync()
        dt = (time.perf_counter() - t0) / reps
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump({"s": dt, "cost": float(res.cost), "device": str(mesh.device)}, f)
    finally:
        torch.distributed.destroy_process_group()


def run_at(world: int, prob_path: str, backend: str, device, solver: str, n_iters=10,
           reps=3) -> dict:
    from hyslam_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "rank0.json")
        launch.run_ranks(_rank, world, (world, f"file://{d}/rendezvous", backend, device,
                                        solver, n_iters, reps, prob_path, out),
                         timeout_s=1800)
        with open(out) as f:
            return json.load(f)


def card() -> str:
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("out", nargs="?")
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    ap.add_argument("--solver", default="auto")
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--L", type=int, default=65536)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the CPU")
    on_card = args.device is None
    n_cards = torch.cuda.device_count() if on_card else 0
    where = card() if on_card else "cpu"
    rows, base = [], None
    with tempfile.TemporaryDirectory() as d:
        prob_path = os.path.join(d, "problem.pkl")
        with open(prob_path, "wb") as f:
            pickle.dump(build_problem(K=args.K, L=args.L), f)
        for n in (int(x) for x in args.ranks.split(",")):
            r = run_at(n, prob_path, args.backend, args.device, args.solver, args.iters)
            ips = args.iters / r["s"]
            base = base or ips
            row = {"metric": "ba_iters_per_s", "ranks": n, "value": ips, "unit": "iters/s",
                   "scaling_efficiency": ips / (base * n), "cost": r["cost"],
                   "solver": args.solver, "backend": args.backend, "device": where,
                   "cards": n_cards,
                   "problem": {"K": args.K, "L": args.L, "O": 8}}
            if n > 1 and (not on_card or n > n_cards):
                row["note"] = "ranks share one card; efficiency not meaningful" if on_card \
                    else "ranks share the host's cores; efficiency not meaningful"
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": where, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
