"""Global bundle adjustment over the whole map (counterpart of
``hyslam_tpu/slam/global_ba.py``): every valid keyframe and landmark in one
BAProblem whose slots are the arena's, the first origin fixed, LM with the
sensor and sub-map tiepoint pose priors, and the result scattered back. The
landmark-sharded solve over several devices (``mesh``) is ROADMAP step 20.

At ``MapCaps(K=512)`` and above ``solver="auto"`` takes the matrix-free CG
solve (``solver/ba.py``), below it the dense Schur solve.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.frame import feature_inv_sigma2
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.slam.sensor_fusion import build_pose_priors
from hyslam_tpu_torch.solver.ba import BAObservations, BAProblem, CamArrays, bundle_adjustment


def build_global_problem(ms: MapState, cam: Camera, tie_active: bool = False,
                         n_levels: int = 8, scale_factor: float = 1.2) -> BAProblem:
    """The whole map as a BAProblem on the arena's indices (K slots = arena
    slots; invalid and bad entries masked by kf_fixed / lm_valid).

    The root map's first origin is always fixed. A sub-map's origin is free
    only with ``tie_active`` (tiepoint priors will constrain the problem)
    and where its map is registered to a parent through a valid tie
    keyframe: otherwise the sub-map would be a component with its gauge
    free and the reduced camera system singular, so its origin stays where
    its registration put it."""
    K, F = ms.K, ms.F
    dev = ms.kf.Tcw.device
    kf_ok = ms.kf.valid & ~ms.kf.bad
    lm_ok = ms.lm.valid & ~ms.lm.bad
    obs_kf = ms.lm.obs_kf.clamp(0, K - 1).long()
    obs_feat = ms.lm.obs_feat.clamp(0, F - 1).long()
    obs_ok = ms.lm.obs_valid & lm_ok[:, None] & kf_ok[obs_kf]
    uv = ms.kf.uv[obs_kf, obs_feat]
    ur = ms.kf.ur[obs_kf, obs_feat]
    inv_s2 = feature_inv_sigma2(ms.kf.level[obs_kf, obs_feat], n_levels, scale_factor)

    def full(v):
        return torch.full((K,), v, dtype=torch.float32, device=dev)

    cams = CamArrays(fx=full(cam.fx), fy=full(cam.fy), cx=full(cam.cx), cy=full(cam.cy),
                     bf=full(cam.bf))
    slot = torch.arange(K, device=dev)
    first_origin = torch.amin(torch.where(ms.kf.origin & kf_ok, slot, K))
    mt = ms.maps
    if tie_active:
        map_tied = (mt.registered & (mt.tie_kf >= 0) & (mt.parent >= 0)
                    & kf_ok[mt.tie_kf.clamp(0, K - 1).long()])
    else:
        map_tied = torch.zeros_like(mt.registered)
    kf_map_tied = map_tied[ms.kf.map_id.clamp(0, M.MAX_MAPS - 1).long()]
    fixed_origin = ms.kf.origin & kf_ok & ~kf_map_tied
    return BAProblem(
        kf_Tcw=ms.kf.Tcw,
        kf_fixed=~kf_ok | fixed_origin | (slot == first_origin),
        cams=cams,
        lm_pos=ms.lm.pos,
        lm_valid=lm_ok,
        obs=BAObservations(kf=obs_kf.to(torch.int32), uv=uv,
                           ur=torch.where(ur > 0, ur, 0.0), inv_sigma2=inv_s2,
                           stereo=(ur > 0) & obs_ok, valid=obs_ok),
    )


def run_global_ba(ms: MapState, cam: Camera, n_iters: int = 20, chunk: int = 512,
                  mesh=None, sensors=None, opt_info=None, n_levels: int = 8,
                  scale_factor: float = 1.2, solver: str = "auto"):
    """Optimize every keyframe pose and landmark; returns (ms, final cost).
    ``sensors`` / ``opt_info`` bring in the sensor and sub-map tiepoint pose
    priors (``slam.sensor_fusion.build_pose_priors``); ``solver`` is
    ``bundle_adjustment``'s. Reads back: the priors' host work, whether a
    tiepoint edge is valid, and the cost."""
    if mesh is not None:
        raise NotImplementedError(
            "global BA sharded over a device mesh is ROADMAP step 20")
    priors = build_pose_priors(ms, sensors=sensors, opt=opt_info)
    tie_active = priors is not None and bool(priors.tie_valid.any())
    prob = build_global_problem(ms, cam, tie_active=tie_active, n_levels=n_levels,
                                scale_factor=scale_factor)
    if priors is not None:
        prob = prob._replace(priors=priors)
    res = bundle_adjustment(prob, n_iters=n_iters, huber=True, chunk=chunk, solver=solver)
    Tcw = torch.where(~prob.kf_fixed[:, None, None], res.kf_Tcw, ms.kf.Tcw)
    pos = torch.where(prob.lm_valid[:, None], res.lm_pos, ms.lm.pos)
    ms = ms._replace(kf=ms.kf._replace(Tcw=Tcw), lm=ms.lm._replace(pos=pos))
    return M.update_landmark_stats(ms), float(res.cost)
