#!/usr/bin/env python3
"""Time kernel K1's wrapper (``hyslam_tpu_torch.ops.pose_opt_cuda``) on one
CUDA card: ms a call between CUDA events, runs of 200 calls after 50 warm
ones, on the stereo problem of tests/test_pose_opt_pallas.py at each N.

The package is imported from the current directory, so the same script
times another checkout's kernel when run from there, for example the parent
commit's unpacked into ``build/parent`` (git-ignored), in turns in one call:

    mkdir -p build/parent && git archive <commit> | tar -x -C build/parent
    for d in build/parent . . build/parent; do
      (cd $d && python3 "$OLDPWD/tools/k1_timing.py" --n 1024); done

Prints the card (name, power limit) and one JSON line per N.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, nargs="+", default=[1024, 3072])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_timing: no CUDA card", file=sys.stderr)
        return 1
    from hyslam_tpu_torch import kernels
    from hyslam_tpu_torch.ops.pose_opt_cuda import pose_optimization_cuda
    from hyslam_tpu_torch.utils.synth import pose_problem

    kernels.load()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    for n in args.n:
        cam, _, a = pose_problem(0, 0.0, 1.0, n)
        a = [torch.from_numpy(np.array(x)).cuda()[None] for x in a]
        for _ in range(50):
            pose_optimization_cuda(cam, *a)
        runs = []
        for _ in range(args.runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(200):
                pose_optimization_cuda(cam, *a)
            end.record()
            torch.cuda.synchronize()
            runs.append(start.elapsed_time(end) / 200)
        print(json.dumps({"tree": os.path.basename(os.getcwd()) or os.getcwd(), "n_obs": n,
                          "ms_a_call": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
