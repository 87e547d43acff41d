#!/usr/bin/env python3
"""Where the CG and the dense solve of the PyTorch port's bundle adjustment
part on a local-BA window with sensor priors, on one CUDA card.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 tools/cg_against_dense.py

It drives ``chip_smoke.py``'s sensor-fused run (phase 6c: 60 rendered
1280x720 stereo frames through ``System`` with GPS, IMU and depth readings),
takes the local-BA problem of the last keyframe with its priors, and prints:

- the scale of the Horn fit of the GPS fixes beside the renderer's;
- the pose step of the first linearization by CG at 50, 200 and 800
  iterations against the dense step, and the condition number of the
  reduced camera system (float64 eigenvalues of its free block);
- the accept-or-reject sequence and costs of LM's iterations by each
  solver, for local BA's robust phase 1 and for its phase 2 started, by
  both solvers, from the dense solve's phase-1 result and inlier mask;
- how far the results are apart after phase 1, after phase 2 from that
  common start, after the whole schedule by each solver alone, and between
  two dense solves.

About 3 minutes on an H100. It gates nothing: it is a diagnostic.
"""

from __future__ import annotations

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("cg_against_dense: this script runs only on a CUDA card", file=sys.stderr)
        return 1
    import hyslam_tpu_torch  # noqa: F401  (pins float32 matmuls)
    from hyslam_tpu_torch import kernels
    from hyslam_tpu_torch.core.sensordata import SensorData
    from hyslam_tpu_torch.geometry import se3
    from hyslam_tpu_torch.io.config import OptimizerInfo
    from hyslam_tpu_torch.slam import mapper as mapper_mod
    from hyslam_tpu_torch.slam import sensor_fusion
    from hyslam_tpu_torch.solver import ba, priors
    from hyslam_tpu_torch.utils import synth

    c.log(c.card_line())
    kernels.build()
    kernels.load()
    dev = torch.device("cuda", 0)
    cam, cfg = c.camera_and_config()
    poses, pairs, _ = c.render_sequence(cam, dev, c.N_TRACK)
    sensors = synth.render_sensors(poses, seed=0, gps_sigma=c.GPS_SIGMA)
    sysm = c.make_system(cam, cfg, optimizer=OptimizerInfo(**c.SENSOR_WEIGHTS))
    tr = sysm.trackers["SLAM"]

    # the last _slot_priors call's inputs are the last local BA's problem
    held = {}
    slot_priors = mapper_mod._slot_priors

    def spy(ms, sn, opt_info, kf_of_slot, slot_used):
        held.update(ms=ms, kf_id=int(ms.next_kf) - 1, sensors=sn, opt_info=opt_info)
        return slot_priors(ms, sn, opt_info, kf_of_slot, slot_used)

    mapper_mod._slot_priors = spy
    try:
        for i in range(c.N_TRACK):
            sysm.track_stereo(pairs[i, 0], pairs[i, 1], c.FRAME_DT * i, frame_id=i,
                              sensor_data=SensorData(**sensors[i]))
    finally:
        mapper_mod._slot_priors = slot_priors
    _, ate, errs = c.trajectory_errors(tr, poses)
    c.log(f"sensor-fused run: ATE {ate:.6f} m, worst frame {max(errs):.6f} m")
    ok, centers, gps, gps_valid = sensor_fusion.fetch(
        tr.ms.kf.valid & ~tr.ms.kf.bad, sensor_fusion.camera_centers(tr.ms),
        tr.sensors.gps, tr.sensors.gps_valid)
    g, _ = sensor_fusion.gps_alignment(centers[ok & gps_valid], gps[ok & gps_valid])
    c.log(f"Horn fit GPS -> SLAM: scale {float(g[0]):.6f}, the renderer's "
          f"{1 / synth.GPS_SCALE:.6f}")

    prob, kf_of_slot, slot_used, *_ = mapper_mod._gather_local_ba(
        held["ms"], held["kf_id"], cam, 16, 2048, cfg.n_levels, cfg.scale_factor)
    prob = prob._replace(priors=slot_priors(held["ms"], held["sensors"], held["opt_info"],
                                            kf_of_slot, slot_used))

    # one linearization: the CG step by iteration count against the dense step
    lam = torch.full((), 1e-4, device=dev)
    K = prob.kf_Tcw.shape[0]
    Hpp, b_pose, Y, y, _, _, _, kf_idx = ba._linearize_factors(
        prob, prob.kf_Tcw, prob.lm_pos, lam, prob.obs.valid, True)
    Hd, b_pr, Hab = priors.linearize_priors_blocks(prob.kf_Tcw, prob.priors)
    Hpp, b_pose = Hpp + Hd, b_pose + b_pr
    S_red, b_red = ba._schur_reduce_dense(Y, y, kf_idx, K, 256)
    S_red = S_red - priors.tie_offdiag_dense(prob.priors, Hab, K, Hpp.dtype)
    dense = ba._solve_poses(Hpp, b_pose, S_red, b_red, prob.kf_fixed, lam)
    rhs = ba._reduced_rhs(Y, y, kf_idx, K)
    for n_cg in (50, 200, 800):
        cg = ba._solve_poses_cg(Hpp, b_pose, rhs, Y, kf_idx, prob.kf_fixed, lam,
                                priors=prob.priors, Hab=Hab, n_cg=n_cg)
        c.log(f"pose step, {n_cg} CG iterations: max|d_cg - d_dense| "
              f"{float((cg - dense).abs().max()):.3e} of max|d_dense| "
              f"{float(dense.abs().max()):.3e}")
    Hpp_d, trace = ba._damped(Hpp, lam)
    free = ((~prob.kf_fixed) & (trace > 0)).repeat_interleave(6)
    S = torch.block_diag(*Hpp_d).double() - S_red.double()
    ev = torch.linalg.eigvalsh(S[free][:, free])
    c.log(f"reduced camera system, {int(free.sum())} free coordinates: eigenvalues "
          f"{float(ev.min()):.4e} to {float(ev.max()):.4e}, condition "
          f"{float(ev.max() / ev.min()):.4e}")

    def lm_trace(p, solver, n_iters, huber, obs_active=None):
        """ba.bundle_adjustment's loop with each iteration's (accepted, cost)."""
        active = p.obs.valid if obs_active is None else obs_active & p.obs.valid
        pa = p._replace(obs=p.obs._replace(valid=active))
        kf, lm = p.kf_Tcw, p.lm_pos
        lam = torch.full((), 1e-4, device=dev)
        cost = ba._robust_cost(pa, kf, lm, huber)
        seq = []
        for _ in range(n_iters):
            dp, dl = ba._assemble_and_solve(p, kf, lm, lam, active, huber, 256, solver)
            kf_new = torch.where(p.kf_fixed[:, None, None], kf, se3.exp(dp) @ kf)
            lm_new = lm + dl
            new_cost = ba._robust_cost(pa, kf_new, lm_new, huber)
            accept = new_cost < cost
            seq.append((bool(accept), float(new_cost)))
            kf = torch.where(accept, kf_new, kf)
            lm = torch.where(accept, lm_new, lm)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e4)
            cost = torch.minimum(new_cost, cost)
        return seq

    def apart(a, b):
        return json.dumps(dict(
            cost=(float(a.cost), float(b.cost)),
            relative=abs(float(a.cost) - float(b.cost)) / float(b.cost),
            max_dT=float((a.kf_Tcw - b.kf_Tcw).abs().max()),
            max_dX=float((a.lm_pos - b.lm_pos).abs().max()),
            inlier_masks_differ_at=int((a.obs_inlier != b.obs_inlier).sum())))

    def solve(p, solver, phase, obs_active=None):
        return ba.bundle_adjustment(p, n_iters=(5, 10)[phase - 1], huber=phase == 1,
                                    chunk=256, obs_active=obs_active, solver=solver)

    for s in ("dense", "cg"):
        c.log(f"phase 1, LM by {s}: {lm_trace(prob, s, 5, True)}")
    d1, c1 = solve(prob, "dense", 1), solve(prob, "cg", 1)
    c.log(f"after phase 1, cg against dense: {apart(c1, d1)}")
    from_d = prob._replace(kf_Tcw=d1.kf_Tcw, lm_pos=d1.lm_pos)
    from_c = prob._replace(kf_Tcw=c1.kf_Tcw, lm_pos=c1.lm_pos)
    for s in ("dense", "cg"):
        c.log(f"phase 2 from the dense phase 1, LM by {s}: "
              f"{lm_trace(from_d, s, 10, False, d1.obs_inlier)}")
    d2 = solve(from_d, "dense", 2, d1.obs_inlier)
    c.log("after phase 2 from the dense phase 1, cg against dense: "
          + apart(solve(from_d, "cg", 2, d1.obs_inlier), d2))
    c.log("after the whole schedule, cg alone against dense alone: "
          + apart(solve(from_c, "cg", 2, c1.obs_inlier), d2))
    c.log(f"two dense solves: {apart(solve(from_d, 'dense', 2, d1.obs_inlier), d2)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
