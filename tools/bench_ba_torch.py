"""Bundle-adjustment throughput of the PyTorch port on the card, with a
roofline estimate (the twin of tools/bench_ba_tpu.py).

Sweeps ``solver.ba.bundle_adjustment`` over K keyframes at L = 65536
landmarks and O = 8 observation slots (tools/bench_multihost_torch.py's
problem), the dense Schur path (the [6K,6K] reduced system built from
rank-3C chunk products) and the matrix-free block-Jacobi PCG path, and
reports LM iterations/s with the FLOP model of bench_ba_tpu.py against the
card's float32 peak outside the tensor cores (67 TFLOP/s for an H100 SXM at
700 W; TF32 is off in the port), named beside the card's name and power
limit as nvidia-smi gives them.

FLOP model per LM iteration (a multiply-add as 2 FLOPs):
  linearize:     ~700 * L * O
  dense Schur:   216 * L * K^2
  dense solve:   (2/3) * (6K)^3
  CG:            n_cg * (4 * 36 * L * O + 2 * 36 * K)   (n_cg = 200: the
                 port's CG runs all 200 iterations, masked after convergence)
  backsub:       ~60 * L * O

    python3 tools/bench_ba_torch.py [out.json]
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from tools.bench_multihost_torch import build_problem, card  # noqa: E402

PEAK_F32_FLOPS = 67e12      # H100 SXM, float32 outside the tensor cores, at 700 W
SWEEP = [(64, "dense"), (256, "dense"), (256, "cg"), (1024, "cg"), (2048, "cg")]


def flops_per_iter(K: int, L: int, O: int, solver: str, n_cg: int = 200) -> float:
    lin = 700.0 * L * O
    back = 60.0 * L * O
    if solver == "dense":
        return lin + 216.0 * L * K * K + (2.0 / 3.0) * (6 * K) ** 3 + back
    return lin + n_cg * (4.0 * 36 * L * O + 2.0 * 36 * K) + back


def run(K: int, solver: str, L=65536, O=8, n_iters=10, reps=3) -> dict:
    import torch

    from hyslam_tpu_torch import interop
    from hyslam_tpu_torch.device import default_device
    from hyslam_tpu_torch.solver.ba import bundle_adjustment

    dev = default_device()
    prob = interop.ba_problem_from_numpy(build_problem(K=K, L=L, O=O), dev)
    res = bundle_adjustment(prob, n_iters=n_iters, solver=solver)
    torch.cuda.synchronize()                              # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        # each rep starts from the last one's poses
        res = bundle_adjustment(prob._replace(kf_Tcw=res.kf_Tcw), n_iters=n_iters,
                                solver=solver)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    ips = n_iters / dt
    fl = flops_per_iter(K, L, O, solver)
    return {"K": K, "L": L, "O": O, "solver": solver, "iters_per_s": ips,
            "s_per_iter": dt / n_iters, "est_tflops_per_iter": fl / 1e12,
            "achieved_tflops": ips * fl / 1e12,
            "pct_f32_peak": 100.0 * ips * fl / PEAK_F32_FLOPS,
            "peak_ms_per_iter": 1e3 * fl / PEAK_F32_FLOPS,
            "final_cost": float(res.cost),
            "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9}


def main(out_path=None):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark times the card")
    where = card()
    rows = []
    for K, solver in SWEEP:
        torch.cuda.reset_peak_memory_stats()
        row = {"card": where, **run(K, solver)}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"card": where, "peak_f32_tflops": PEAK_F32_FLOPS / 1e12,
                       "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1] if len(sys.argv) > 1 else None))
