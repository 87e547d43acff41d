"""Feed a cell's whole sequence, as long as BENCHMARK.json's run_seconds
makes it, through the System with no clock, step by step, and print the
arenas' use every 100 steps: the keyframe cursor against K and the landmark rows
allocated against L (a row allocated past L is a recycled one). Sizes K
and L so that neither fills within the sequence, whatever rate a later
program reaches. Exit 1 where one does.

    python3 benchmark/rehearse.py --workload <cell> --seed <n> [--device cpu]
"""

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    sys.path.insert(0, ROOT)
    from types import SimpleNamespace

    from benchmark.harness import sequence
    from benchmark.harness.cell import Feeder, _states, make_system, rig_cameras
    from benchmark.harness.spec import Bench

    bench = Bench()
    cell = bench.cell(args.workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    device = torch.device(args.device)
    seq = sequence.build(rig_cameras(cfg), traffic, cfg["frame_dt"], args.seed,
                         bench.spec["run_seconds"], device)
    system = make_system(cfg, device)
    feed = Feeder(system, seq, cfg, SimpleNamespace())
    tk = system.trackers["SLAM"]
    caps = cfg["caps"]
    n = len(seq.pairs)
    t0 = time.perf_counter()
    for i in range(n):
        feed(i)
        if (i + 1) % 100 == 0 or i + 1 == n:
            system.flush()
            states, _ = _states(tk)
            lost = sum(1 for f in range(i + 1) if states.get(f) not in ("NORMAL", "POSTINIT",
                                                                         "INITIALIZE"))
            nk, nl = (int(x) for x in torch.stack([tk.ms.next_kf, tk.ms.next_lm]).tolist())
            print(f"frame {i + 1}/{n}: keyframes {nk} of K={caps['K']}, landmark rows "
                  f"{nl} of L={caps['L']}, frames not tracked {lost}, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    rows = tk.telemetry
    first = next((j for j, t in enumerate(rows)
                  if t.state not in ("NORMAL", "POSTINIT", "INITIALIZE")), None)
    if first is not None:
        print("rows around the first frame not tracked (frame, state, inliers, motion-model "
              "matches, local-map matches, keyframe):")
        for t in rows[max(0, first - 8):first + 8]:
            print(f"  {t.frame_id} {t.state} {t.n_inliers} {t.n_motion} {t.n_local} "
                  f"{t.kf_inserted}")
    system.shutdown()
    return 0 if nk < caps["K"] and nl <= caps["L"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
