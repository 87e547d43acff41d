"""Replay a KITTI-layout sequence through examples/run_kitti_torch.py and
record, after every fed frame, the landmark arena and the names that point
into it: the rows never used (virgin), the live and the recyclable ones, the
keyframe names of bad rows, the names that the named landmark's observation
list does not hold (a recycled row's stale names among them), and the fused
rows whose ``replaced_by`` points at a younger landmark. At the end, the
loop closer's record, the sub-maps, and the trajectory against the
sequence's truth: the ATE (se3-aligned) of every 100 frames and the frames
whose motion from the frame before is off by more than STEP_M. The
trajectory is the one ``save_trajectory_tum`` writes, its rows re-derived
from their keyframes after the run; the driver's own ATE and RPE are read
before that. ``--L`` sizes the landmark arena (MapCaps.L), to tell a fall
that follows the recycling of rows from one that follows the scene.

    python3 tools/kitti_soak_probe_torch.py <kitti root> --frames 200 --device cpu \\
        --out out_probe [--L 65536] [run_kitti_torch.py's other options]

Writes <out>/probe.tsv (a row a fed frame) and <out>/probe.json beside the
driver's own outputs.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import examples.run_kitti_torch as run_kitti  # noqa: E402
from hyslam_tpu_torch.io.datasets import KittiOdometry  # noqa: E402
from hyslam_tpu_torch.io.evaluate import ate_rmse  # noqa: E402

SEGMENT = 100     # frames a segment of the trajectory's ATE
STEP_M = 0.5      # m: a frame-to-frame motion this far off the truth's is listed
COLUMNS = ("frame", "virgin", "live", "recyclable", "bad_names", "names_not_held",
           "replaced_into_younger")


def arena_row(ms) -> tuple:
    """The arena's counts (see the module docstring) for one map state."""
    lm, kf = ms.lm, ms.kf
    L = ms.L
    named = (kf.valid & ~kf.bad)[:, None] & (kf.lm_id >= 0)
    row = kf.lm_id.clamp(0, L - 1).long()
    K, F = kf.lm_id.shape
    k_of = torch.arange(K, device=row.device)[:, None, None]
    f_of = torch.arange(F, device=row.device)[None, :, None]
    holds = (lm.obs_valid[row] & (lm.obs_kf[row] == k_of) & (lm.obs_feat[row] == f_of)).any(-1)
    room = ~lm.obs_valid[row].all(-1)
    rep = lm.replaced_by.clamp(0, L - 1).long()
    younger = (lm.bad & (lm.replaced_by >= 0) & ~lm.bad[rep]
               & (lm.first_kf[rep] > lm.first_kf))
    return (int((~lm.valid).sum()), int((lm.valid & ~lm.bad).sum()),
            int((lm.valid & lm.bad & (lm.protection <= 0)).sum()),
            int((named & lm.bad[row]).sum()),
            int((named & ~lm.bad[row] & ~holds & room).sum()), int(younger.sum()))


def trajectory_record(est: np.ndarray, gt: np.ndarray, frame: np.ndarray) -> dict:
    """ATE of every SEGMENT frames and the frames whose motion from the
    frame before is off the truth's by more than STEP_M. est, gt: [n,4,4]
    Tcw of the trajectory's rows and of their frames; frame [n]: the frame
    index of each row."""
    segments = {}
    for a in range(0, int(frame.max()) + 1, SEGMENT):
        m = (frame >= a) & (frame < a + SEGMENT)
        if m.sum() > 5:
            segments[f"{a}-{a + SEGMENT - 1}"] = ate_rmse(est[m], gt[m])
    steps = []
    for k in np.nonzero(np.diff(frame) == 1)[0] + 1:
        off = np.linalg.inv(gt[k] @ np.linalg.inv(gt[k - 1])) @ est[k] @ np.linalg.inv(est[k - 1])
        if np.linalg.norm(off[:3, 3]) > STEP_M:
            steps.append((int(frame[k]), float(np.linalg.norm(off[:3, 3]))))
    return {"ate_se3": ate_rmse(est, gt), "segment_ate_se3": segments, "steps_off": steps}


def write_records(out: str, rows: list, info: dict) -> None:
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "probe.tsv"), "w") as f:
        f.write("\t".join(COLUMNS) + "\n")
        f.writelines("\t".join(map(str, r)) + "\n" for r in rows)
    with open(os.path.join(out, "probe.json"), "w") as f:
        json.dump(info, f)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    caps = run_kitti.CAPS
    if "--L" in argv:
        i = argv.index("--L")
        caps = caps._replace(L=int(argv[i + 1]))
        del argv[i:i + 2]
    rows, systems = [], []

    def record(system):
        if not systems:
            systems.append(system)
        rows.append((len(rows),) + arena_row(system.trackers["SLAM"].ms))

    rc = run_kitti.main(argv, caps=caps, on_frame=record)
    tracker = systems[0].trackers["SLAM"]
    ms = tracker.ms
    lc = systems[0].loop_closers.get("SLAM")
    n_maps = int(ms.maps.n_maps)
    n = int(tracker.traj.size)
    ds = KittiOdometry(argv[0])
    frame = np.abs(ds.times[None, :] - tracker.traj.t[:n].cpu().numpy()[:, None]).argmin(1)
    info = {"loops_closed": 0 if lc is None else lc.n_closed,
            "loop_edges": [] if lc is None else [(i, j) for i, j, _ in lc.loop_edges],
            "n_maps": n_maps, "registered": ms.maps.registered.tolist()[:n_maps],
            "tie_kf": ms.maps.tie_kf.tolist()[:n_maps],
            **trajectory_record(tracker.traj.Tcw[:n].cpu().numpy().astype(np.float64),
                                np.asarray(ds.gt, np.float64)[frame], frame)}
    write_records(argv[argv.index("--out") + 1], rows, info)
    print("probe:", json.dumps(info))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
