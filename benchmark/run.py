"""Benchmark of hySLAM's PyTorch and CUDA port: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs on the first CUDA card and refuses to run (exit 2, no result) without
one. Renders the cell's stereo sequence from the seed on the card, warms
the System up, feeds frames closed-loop to ``System.track_stereo`` for
``--seconds`` and ends with ``System.flush()``. Earlier lines: the set-up's
parts, the window's frames, keyframes and pose-kernel launches, the arenas'
use, the correctness readings and, after the window, the card and its
power limit. The last lines of standard error: each number compared,
beside its limit. The last line of standard output: one JSON object
(``correct``, ``attempted`` = frames fed in the window, ``failed`` = those
not tracked, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
last ``checks``). ``--trace 1`` reports the per-layer metrics from a
separate traced run. ``--control`` runs the correctness control (lower
precision in place of float32: ``harness/check.py``) and is not a
benchmark run.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "hyslam_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out[0] if out else "nvidia-smi printed nothing"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    import torch

    sys.path.insert(0, ROOT)
    from benchmark.harness.spec import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness.cell import log, run_cell

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    log(f"cell {args.workload}, seed {args.seed}, {args.seconds} s, trace {args.trace}"
        + (", CONTROL (lower precision)" if args.control else ""))
    line = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                    device, T_START, control=args.control)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
