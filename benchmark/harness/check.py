"""The comparison that decides ``correct``: what the timed path produced,
held against the plain reference (``reference/``), which solves the same
inputs again in float64, and against the rendered truth.

The numbers read, each at the timed sizes on what the window produced:

- ``fe_mismatch``: on frames drawn from the seed among the window's, the
  share of features where the program's front end and the reference's
  (``reference/frontend.py`` on the same uint8 pair, its image arithmetic
  in float64) disagree: a feature of either side with no feature of the
  other at the same level and pixel (to 0.01 px), with the same 256
  descriptor bits and, for the left image, the same stereo match (right u
  within 0.001 px, or both unmatched).
- ``k1_cost_gap_2nd``: over each of N_SOLVES pose-only solves drawn from
  the seed among the window's with at least MIN_VALID observations (kernel
  K1 on the card), the share by which the truncated robust cost
  (``reference/pose_opt.py:truncated_cost``, float64) of the kernel's pose
  exceeds that of the reference's, solved in float64 from the kernel's own
  arguments; the number is the second largest of these shares. A cost, not
  a pose: two sound schedules that stop apart along a weakly determined
  direction (far points) read nearly the same. The second largest, not the
  largest: about one sound solve in some hundreds reads up to ~0.4%, where
  the schedule meets a knife edge (an LM step whose cost differs from the
  last by ~1e-5 relative, or an observation on its chi2 threshold between
  rounds) that float32 rounding decides, as plain float32 solves of the
  same problem in other summation orders show; a fault of the solve reads
  on every solve it touches. Printed beside it:
  the largest share, the largest |Tcw - Tcw_ref| entry, the inlier flags
  that differ in each solve and, where they differ, how far the
  reference's chi2 of a differing observation lies from its threshold
  (relative, the least of the solve).
- ``ba_cost_gap``: on N_LOCAL_BA local BA problems drawn from the seed
  among the window's, the median of the share by which the truncated
  robust cost (``reference/ba.py:truncated_cost``, float64) of the
  mapper's solved poses and landmarks exceeds that of the reference's,
  solved in float64 from the problem the mapper gathered (0 where the
  median is below 0). The median, not the largest: the two-phase
  schedule's 15 iterations leave some problems unconverged, and there
  float32 and float64 accept different steps, a sound gap of up to ~2% on
  one problem in ten. Printed beside it: the largest pose entry gap.
- ``rpe_m`` and ``kf_rpe_m``: the root mean square, over the window's
  frames as tracked or its keyframes after local BA, of the error of the
  camera's displacement to the first pose at least RPE_GAP frames later,
  in the earlier camera's frame, against the rendered truth's (a relative
  error does not grow with the window's length).

These read the rig's SLAM camera. A number that the limits file names and
that is none of these is read by ``checks/<number>.py``: ``read(run)``
over what the run kept of every camera (``cell.CheckRun``); a limits file
that names a number with neither raises before the run.

The numbers compared are those with a limit in ``limits/<cell>.json``,
which holds the readings each limit was set from; the others are printed.
The control (``--control``) puts lower precision where the program's
float32 is: the reference front end in bfloat16 in the program's place,
the pose-only reference solved in float32 with TF32 on in the kernel's
place, and the program's local BA run with TF32 on.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import ba as ref_ba
from benchmark.reference import frontend as ref_fe
from benchmark.reference import pose_opt as ref_po

N_FRONTEND = 3     # frames whose front end is compared
N_SOLVES = 16      # pose-only solves compared
MIN_VALID = 100    # ... among those with this many observations: with fewer
                   # (a motion-model search that found a handful) the pose
                   # is ill-determined, and two sound LM schedules stop apart
N_LOCAL_BA = 8     # local BA problems compared
RPE_GAP = 10       # frames between the two poses of a relative error


def _tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _cast(x, dtype):
    """Every floating tensor of x (a tensor, or tuples of them) in dtype."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype) if x.is_floating_point() else x
    if isinstance(x, tuple):
        vals = [_cast(v, dtype) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
    return x


def _keyed(uv, level, valid):
    uv = uv.cpu().numpy()
    level = level.cpu().numpy()
    keys = {}
    for j in np.nonzero(valid.cpu().numpy())[0]:
        keys[(int(level[j]), int(round(uv[j, 0] * 100)), int(round(uv[j, 1] * 100)))] = j
    return keys


def _side_mismatch(prog, ref, with_ur: bool) -> tuple[int, int]:
    """(features that disagree, reference features) of one image."""
    kp, kr = _keyed(prog.uv, prog.level, prog.valid), _keyed(ref.uv, ref.level, ref.valid)
    dp, dr = prog.desc.cpu().numpy(), ref.desc.cpu().numpy()
    up, ur = prog.ur.cpu().numpy(), ref.ur.cpu().numpy()
    bad = len(set(kp) ^ set(kr))
    for key in set(kp) & set(kr):
        i, j = kp[key], kr[key]
        same = bool((dp[i] == dr[j]).all())
        if with_ur:
            if (up[i] > 0) != (ur[j] > 0) or (ur[j] > 0 and abs(float(up[i] - ur[j])) > 1e-3):
                same = False
        bad += not same
    return bad, len(kr)


def frontend_mismatch(frames, extracted, matched, pairs, ex, capacity, bf,
                      control: bool = False):
    bad = total = 0
    for f in frames:
        left_ref, right_ref = ref_fe.stereo_frame(pairs[f], ex, capacity, bf,
                                                  work=torch.float64)
        if control:
            left_prog, right_prog = ref_fe.stereo_frame(pairs[f], ex, capacity, bf,
                                                        work=torch.bfloat16)
        else:
            both = extracted[f]
            left_prog, right_prog = matched[f], type(both)(*(x[1] for x in both))
        b1, n1 = _side_mismatch(left_prog, left_ref, with_ur=True)
        b2, n2 = _side_mismatch(right_prog, right_ref, with_ur=False)
        bad, total = bad + b1 + b2, total + n1 + n2
    return bad / max(total, 1)


def _intrinsics(cam):
    return ref_po.Intrinsics(float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
                             float(cam.bf))


def _ref_solve(args, dtype):
    cam, Tcw0, X, uv, ur, inv_s2, valid, stereo = args[:8]
    return ref_po.pose_optimization(_intrinsics(cam), *_cast((Tcw0, X, uv, ur, inv_s2), dtype),
                                    valid, stereo)


def pose_readings(solves, control: bool) -> dict:
    """Per solve: the relative gap of truncated costs, the largest pose
    entry gap and the inlier flags that differ, against the reference in
    float64."""
    cost, pose, flips, margin = [], [], [], []
    for args, res in solves:
        if control:
            _tf32(True)
            res = _ref_solve(args, torch.float32)
        _tf32(False)
        T_ref, inl_ref, _, c2_ref = _ref_solve(args, torch.float64)
        cam, _, X, uv, ur, inv_s2, valid, stereo = args[:8]
        obs = _cast((X, uv, ur, inv_s2), torch.float64)
        c_ref = float(ref_po.truncated_cost(_intrinsics(cam), T_ref, *obs, valid, stereo))
        c_prog = float(ref_po.truncated_cost(_intrinsics(cam), res[0].to(torch.float64),
                                             *obs, valid, stereo))
        cost.append((c_prog - c_ref) / max(c_ref, 1e-9))
        pose.append(float((res[0].to(torch.float64) - T_ref).abs().max()))
        flipped = res[1] != inl_ref
        flips.append(int(flipped.sum()))
        th = torch.where(stereo, ref_po.CHI2_STEREO, ref_po.CHI2_MONO).to(c2_ref)
        margin.append(float((c2_ref[flipped] / th[flipped] - 1).abs().min())
                      if flipped.any() else None)
    return {"cost": cost, "pose": pose, "flips": flips, "margin": margin}


def _centre(T):
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def ba_readings(problems) -> dict:
    """Per problem [(problem, result)]: the relative gap of truncated costs
    and the largest pose entry gap, against the reference in float64."""
    out = {"cost": [], "pose": []}
    for prob, res in problems:
        p = _cast(prob, torch.float64)
        ref = ref_ba.local_ba_two_phase(p)
        c_ref = float(ref_ba.truncated_cost(p, ref.kf_Tcw, ref.lm_pos))
        c_prog = float(ref_ba.truncated_cost(p, res.kf_Tcw.to(torch.float64),
                                             res.lm_pos.to(torch.float64)))
        out["cost"].append((c_prog - c_ref) / max(c_ref, 1e-9))
        out["pose"].append(float((res.kf_Tcw.to(torch.float64) - ref.kf_Tcw).abs().max()))
    return out


def centre_errors(Tcw: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Distances between the camera centres of Tcw [n,4,4] and truth [n,4,4]."""
    return np.linalg.norm(_centre(Tcw.astype(np.float64)) - _centre(truth), axis=-1)


def relative_errors(ids: np.ndarray, Tcw: np.ndarray, truth: np.ndarray,
                    gap: int = RPE_GAP) -> np.ndarray:
    """For each pose (frame ids ``ids``, Tcw [n,4,4], truth [n,4,4]) with a
    later one at least ``gap`` frames on, the error of the displacement to
    it, expressed in the earlier camera's frame."""
    order = np.argsort(ids, kind="stable")
    ids, Tcw, truth = ids[order], Tcw[order].astype(np.float64), truth[order]
    later = np.searchsorted(ids, ids + gap)
    a = np.nonzero(later < len(ids))[0]
    if not len(a):
        return np.zeros(0)
    b = later[a]

    def disp(T):
        C = _centre(T)
        return np.einsum("nij,nj->ni", T[a, :3, :3], C[b] - C[a])
    return np.linalg.norm(disp(Tcw) - disp(truth), axis=-1)


def _worst(xs):
    return max(xs) if xs else float("inf")


def _excess(gaps, rank: int = 1):
    """The rank-th most by which the program's cost exceeds the
    reference's, as a share of the reference's (0 where the program's is
    lower)."""
    return max(0.0, sorted(gaps)[-rank]) if len(gaps) >= rank else float("inf")


BUILT_IN = ("fe_mismatch", "k1_cost_gap_2nd", "ba_cost_gap", "rpe_m", "kf_rpe_m")


def numbers_named(limits: dict) -> list[str]:
    """The numbers a limits file names (compared or printed) that are not
    built in: each is read by checks/<number>.py."""
    return [k for k, v in limits.items() if isinstance(v, dict) and k not in BUILT_IN]


def run(rng, record, limits, checks, control=False):
    """([(name, value, limit)] of every number compared, what was read).
    ``record`` is what the run kept (``cell.CheckRun``); the built-in
    numbers read its SLAM camera, ``checks`` (number -> the module of
    checks/<number>.py) reads the others."""
    slam = record.cameras["SLAM"]
    window_frames = set(slam.frames)
    block = record.rig["SLAM"]
    frames = sorted(f for f in window_frames if f in slam.matched and f in slam.features)
    pick = sorted(rng.choice(frames, size=min(N_FRONTEND, len(frames)), replace=False).tolist())
    solves = [(a, r) for c, f, a, r in record.solves if c == "SLAM" and f in window_frames]
    n_valid = torch.stack([a[6].sum() for a, _ in solves]).tolist() if solves else []
    big = [j for j, n in enumerate(n_valid) if n >= MIN_VALID]
    idx = sorted(rng.choice(big, size=min(N_SOLVES, len(big)), replace=False).tolist())
    bas = [(p, r) for c, f, p, r in record.local_ba
           if c == "SLAM" and f in window_frames and p.priors is None]
    ib = sorted(rng.choice(len(bas), size=min(N_LOCAL_BA, len(bas)), replace=False).tolist())
    _tf32(False)     # the reference in float64, TF32 off
    fe = (frontend_mismatch(pick, slam.features, slam.matched, record.seq.pairs,
                            block["extractor"], record.cfg["caps"]["F"], block["bf"], control)
          if pick else float("inf"))
    k1 = pose_readings([solves[i] for i in idx], control)
    ba = ba_readings([bas[j] for j in ib])
    numbers = {"fe_mismatch": fe, "k1_cost_gap_2nd": _excess(k1["cost"], 2),
               "ba_cost_gap": max(0.0, float(np.median(ba["cost"]))) if ba["cost"]
               else float("inf")}
    info = {"frames_compared": pick, "solves_compared": [n_valid[j] for j in idx],
            "solves_under_min_valid": len(solves) - len(big),
            "k1_cost_gaps": [float("%.3g" % g) for g in k1["cost"]],
            "k1_cost_gap_max": _excess(k1["cost"]),
            "k1_pose_gap_max": _worst(k1["pose"]),
            "k1_inlier_flips_max": max(k1["flips"], default=None),
            "k1_inlier_flips": k1["flips"],
            "k1_flip_chi2_margin": [m if m is None else float("%.3g" % m)
                                    for m in k1["margin"]],
            "local_ba_compared": len(ib), "ba_cost_gaps": [float("%.3g" % g) for g in ba["cost"]],
            "ba_pose_gap": _worst(ba["pose"])}
    for name, (ids, Tcw, truth) in (("rpe_m", slam.traj), ("kf_rpe_m", slam.kfs)):
        err = relative_errors(ids, Tcw, truth)
        numbers[name] = float(np.sqrt(np.mean(err ** 2))) if len(err) else float("inf")
        ate = centre_errors(Tcw, truth) if len(ids) else np.zeros(1)
        info[name] = (len(err), float(err.max()) if len(err) else None, float(ate.max()))
    for name, mod in checks.items():
        numbers[name] = float(mod.read(record))
    info["numbers"] = numbers
    compared = [k for k, v in limits.items() if isinstance(v, dict) and "limit" in v]
    return [(k, numbers[k], limits[k]["limit"]) for k in compared], info
