#!/usr/bin/env python3
"""What Python threads that launch small PyTorch operators cost each other
on one CUDA card, apart from the SLAM code: each case runs ``--ops``
operators on a thread per worker, all workers at once, and prints each
worker's wall and thread-CPU microseconds an operator.

    cuda        ``a.add_(1)`` on a 4-element CUDA tensor (one launch)
    cuda_sync   the same with a read back to the host every 32 operators
    upload      ``torch.tensor(row, device="cuda")`` from a Python list
                (a copy from pageable memory)
    cpu         ``a.add_(1)`` on a 4-element CPU tensor (no device: what
                the GIL alone costs)
    python      a pure Python loop of the same length (never releases the
                GIL between operators)

A run is ``case[:case...]``, one worker a case, each worker on the current
stream (``--streams`` gives each worker its own). With ``--blocking`` the
CUDA context's scheduling is set to blocking sync first.

    python3 tools/thread_contention.py                     # the default runs
    python3 tools/thread_contention.py --runs cuda cuda:cuda cuda:python

Prints the card (name, power limit) and one JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

RUNS = ("cuda", "cuda:cuda", "cuda:cuda:cuda", "cuda_sync", "cuda_sync:cuda_sync",
        "upload", "upload:upload", "cpu", "cpu:cpu", "cuda:python", "cuda:cpu")


def worker(case: str, n_ops: int, stream, barrier, out: list, torch):
    dev = torch.device("cuda", 0)
    a = torch.zeros(4, device=dev if case.startswith(("cuda", "upload")) else "cpu")
    row = [1.0, 2.0, 3.0, 4.0]
    ctx = torch.cuda.stream(stream) if stream is not None else torch.cuda.stream(None)
    with ctx:
        barrier.wait()
        t0, c0 = time.perf_counter(), time.thread_time()
        if case == "python":
            x = 0
            for i in range(n_ops * 200):
                x += i & 3
        else:
            for i in range(n_ops):
                if case == "upload":
                    a = torch.tensor(row, device=dev)
                else:
                    a.add_(1)
                if case == "cuda_sync" and i % 32 == 31:
                    a[0].item()
        if a.is_cuda:
            torch.cuda.current_stream().synchronize()
        out.append((case, 1e6 * (time.perf_counter() - t0) / n_ops,
                    1e6 * (time.thread_time() - c0) / n_ops))


def run_one(spec: str, n_ops: int, streams: bool, blocking: bool) -> dict:
    if blocking:
        from pipeline_probe import set_blocking_sync
        set_blocking_sync()
    import torch

    torch.zeros(1, device="cuda")
    cases = spec.split(":")
    for case in cases:                       # warm each kind once
        worker(case, 200, None, threading.Barrier(1), [], torch)
    barrier, out = threading.Barrier(len(cases)), []
    threads = [threading.Thread(target=worker, args=(
        c, n_ops, torch.cuda.Stream() if streams else None, barrier, out, torch))
        for c in cases]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return {"run": spec, "streams": streams, "blocking": blocking, "ops": n_ops,
            "us_an_op_wall_cpu": [[c, round(w, 2), round(cp, 2)] for c, w, cp in sorted(out)]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", default=list(RUNS))
    ap.add_argument("--ops", type=int, default=20000)
    ap.add_argument("--streams", action="store_true")
    ap.add_argument("--blocking", action="store_true")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print("RUN " + json.dumps(run_one(args.one, args.ops, args.streams, args.blocking)),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("thread_contention: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    flags = (["--streams"] if args.streams else []) + (["--blocking"] if args.blocking else [])
    rc = 0
    for spec in args.runs:
        p = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", spec,
                            "--ops", str(args.ops)] + flags, capture_output=True, text=True)
        lines = [ln[4:] for ln in p.stdout.splitlines() if ln.startswith("RUN ")]
        if p.returncode or not lines:
            print(f"{spec}: failed rc {p.returncode}\n{p.stderr[-2000:]}", flush=True)
            rc = 1
            continue
        print(json.dumps({"card": card, **json.loads(lines[0])}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
