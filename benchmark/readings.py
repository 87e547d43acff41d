"""Readings of the correctness numbers over many seeds in one process, for
setting each cell's limits (``limits/<cell>.json``): sound runs, the
control, and runs with a fault planted (``harness/faults.py``). Not a
benchmark run: it prints one ``READING {json}`` line a run, with every
number ``harness/check.py`` reads, whether compared or not.

    python3 benchmark/readings.py --workload <cell> --seconds <s> \\
        --plan 'sound:1,2,3;control:4,5,6;no_fusion:7,8,9'
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--plan", required=True,
                    help="mode:seed,seed;... where mode is sound, control or a fault's name")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, ROOT)
    from benchmark.harness import faults
    from benchmark.harness.cell import run_cell
    from benchmark.harness.spec import Bench

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    bench = Bench()
    for part in args.plan.split(";"):
        mode, seeds = part.split(":")
        for seed in (int(x) for x in seeds.split(",")):
            undo = faults.plant(mode) if mode in faults.FAULTS else (lambda: None)
            records = []
            t = time.perf_counter()
            try:
                line = run_cell(bench, args.workload, seed, args.seconds, False, device, t,
                                control=(mode == "control"), records=records)
            finally:
                undo()
            info = records[0].check
            print("READING " + json.dumps({
                "cell": args.workload, "mode": mode, "seed": seed, "correct": line["correct"],
                "attempted": line["attempted"], "failed": line["failed"],
                "fps": line["metrics"]["fps"]["value"], "numbers": info.pop("numbers"),
                "info": info}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
