#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase 8 (loop closing through ``System``: 8a
sync, 8b async) several times in one process on one CUDA card, and say
whether the runs are the same run: each run's per-frame rows (state,
motion-model matches, inliers, keyframe) against the first run's, its
gates, ATE and sub-map count.

The port runs PyTorch's deterministic algorithms (``hyslam_tpu_torch/
device.py``); ``--nondeterministic`` switches them off after the import, to
show what they change. Run from the root of a checkout:

    python3 tools/repeat_phase8_torch.py --reps 3
    python3 tools/repeat_phase8_torch.py --reps 3 --nondeterministic

Prints the card (name, power limit), one JSON line a run and a summary.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402


def rows_and_summary(text: str) -> dict:
    """The per-frame rows and the summary numbers of 8a and 8b in phase 8's
    printed output."""
    out = {}
    for name in ("a", "b"):
        rows = [ln for ln in text.splitlines() if ln.startswith(f"  8{name} frame ")]
        summary = next((ln for ln in text.splitlines()
                        if ln.startswith(f"phase 8{name}: ") and " rows, " in ln), "")
        ate = re.search(r"ATE ([0-9.]+) m", summary)
        maps = re.search(r"n_maps (\d+)", summary)
        out[name] = dict(rows=rows, ate=float(ate.group(1)) if ate else None,
                         n_maps=int(maps.group(1)) if maps else None)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--nondeterministic", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("repeat_phase8_torch: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    import hyslam_tpu_torch  # noqa: F401  (its numeric settings)
    if args.nondeterministic:
        torch.use_deterministic_algorithms(False)
    deterministic = torch.are_deterministic_algorithms_enabled()
    print(cs.card_line(), flush=True)
    dev = torch.device("cuda", 0)
    cs.phase0()
    cam, cfg = cs.camera_and_config()
    first, runs = None, []
    for rep in range(args.reps):
        buf = io.StringIO()
        t = time.perf_counter()
        failed = None
        with contextlib.redirect_stdout(buf):
            try:
                cs.phase8(cam, cfg, dev)
            except AssertionError as e:
                failed = str(e)
        secs = time.perf_counter() - t
        got = rows_and_summary(buf.getvalue())
        first = first or got
        run = {"rep": rep, "deterministic": deterministic, "ok": failed is None,
               "failed": failed, "s": round(secs, 1),
               **{f"ate_8{n}": got[n]["ate"] for n in "ab"},
               **{f"n_maps_8{n}": got[n]["n_maps"] for n in "ab"},
               **{f"rows_equal_run0_8{n}": got[n]["rows"] == first[n]["rows"]
                  for n in "ab"},
               **{f"first_row_apart_8{n}": next(
                   (i for i, (x, y) in enumerate(zip(got[n]["rows"], first[n]["rows"]))
                    if x != y), None) for n in "ab"}}
        runs.append(run)
        print(json.dumps(run), flush=True)
    print(json.dumps({"card": cs.card_line(), "deterministic": deterministic,
                      "runs": len(runs), "passed": sum(r["ok"] for r in runs),
                      "all_rows_equal": all(r["rows_equal_run0_8a"] and r["rows_equal_run0_8b"]
                                            for r in runs)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
