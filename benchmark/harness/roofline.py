"""The yardstick of the pose kernel K1: the least time one H100 could take
for one of its problems, from the problem's sizes and the card's published
peaks (NVIDIA's data sheet, H100 SXM, 700 W: 67 TFLOP/s float32 outside
the tensor cores, 3.35 TB/s of HBM).

Operations are counted from the schedule the kernel runs (the reference's
4 rounds x 10 LM iterations), a multiply-add as two: FLOP_SYSTEM an active
observation for a pass that sums H, g and the cost (40 for the residual
and chi2, 31 for the weight and the three Jacobian rows, 112 + 36 + 7 for
the sums with the identically zero products left out), FLOP_RESIDUAL an
observation for a reclassification or final pass, FLOP_STEP for a damped
6x6 Cholesky solve, the SE3 exp and the compose. A schedule makes
n_rounds * (iters + 1) system passes (round 0 over the valid observations,
later rounds over about the final inliers), n_rounds + 1 residual passes
over all n_obs, and n_rounds * iters steps. Bytes: every input read once
and every output written once.
"""

from __future__ import annotations

PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def k1_bound(n_obs: int, n_valid: int, n_inliers: int, n_rounds: int = 4,
             iters: int = 10) -> dict:
    """The least time (ms) for one K1 problem, and what sets it."""
    FLOP_SYSTEM, FLOP_RESIDUAL, FLOP_STEP = 226, 40, 330
    read = 64 + n_obs * (12 + 8 + 4 + 4 + 1 + 1)
    written = 64 + n_obs * (1 + 4) + 4
    active = (n_valid + (n_rounds - 1) * n_inliers) if n_rounds else 0
    flop = (active * (iters + 1) * FLOP_SYSTEM + (n_rounds + 1) * n_obs * FLOP_RESIDUAL
            + n_rounds * iters * FLOP_STEP)
    by_bytes = 1e3 * (read + written) / PEAK_BYTES
    by_ops = 1e3 * flop / PEAK_FLOPS_F32
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "operations" if by_ops >= by_bytes else "bytes",
            "bytes": read + written, "flop": flop}
