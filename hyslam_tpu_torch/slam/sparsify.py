"""Map sparsification: cull successive keyframes that are near-duplicates
(counterpart of ``hyslam_tpu/slam/sparsify.py``, GenUtils::sparsifyMap).

Walking the keyframes in id order, a keyframe is culled when more than
``overlap_criterion`` of the last kept keyframe's landmarks are visible
(project in front of it, inside the image) in it. The "which of keyframe
i's landmarks are visible in keyframe j" part for all pairs is one batched
[K, L] projection and one 0/1 matrix product on the device; the greedy walk
runs on the host over the [K, K] fractions, read back once.
"""

from __future__ import annotations

import numpy as np
import torch

from hyslam_tpu_torch.core import mapstate as M
from hyslam_tpu_torch.core.mapstate import MapState
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera, in_image, project


def keyframe_overlap_fractions(ms: MapState, cam: Camera) -> torch.Tensor:
    """[K, K] frac[i, j]: the fraction of keyframe i's associated landmarks
    that are visible in keyframe j. The counts are a float32 product of 0/1
    matrices (TF32 off): exact integers, as the JAX package's bf16 product
    with float32 sums, so the fractions are the same bits."""
    lm_ok = ms.lm.valid & ~ms.lm.bad
    Xc = se3.apply(ms.kf.Tcw[:, None], ms.lm.pos[None])          # [K, L, 3]
    uv, z = project(cam, Xc)
    vis = in_image(cam, uv) & (z > 0.2) & lm_ok[None, :]          # [K, L]
    inc = M.incidence_matrix(ms) & lm_ok[None, :]                 # [K, L]
    counts = inc.to(torch.float32) @ vis.to(torch.float32).T      # [K, K]
    denom = torch.clamp_min(inc.sum(dim=-1).to(torch.float32), 1.0)
    return counts / denom[:, None]


def sparsify_map(ms: MapState, cam: Camera,
                 overlap_criterion: float = 0.98) -> tuple[MapState, int]:
    """Greedy successive-keyframe culling: walk the keyframes in id order
    and cull the next while more than ``overlap_criterion`` of the current
    kept keyframe's landmarks are visible in it. Origin keyframes are never
    culled. Returns (ms, number culled)."""
    kf_ok = (ms.kf.valid & ~ms.kf.bad).cpu().numpy()
    ids = np.nonzero(kf_ok)[0]
    if len(ids) < 2:
        return ms, 0
    frac = keyframe_overlap_fractions(ms, cam).cpu().numpy()
    origin = ms.kf.origin.cpu().numpy()
    cull = np.zeros(ms.K, bool)
    cur = ids[0]
    for tgt in ids[1:]:
        if frac[cur, tgt] > overlap_criterion and not origin[tgt]:
            cull[tgt] = True
        else:
            cur = tgt
    n = int(cull.sum())
    if n == 0:
        return ms, 0
    ms = M.set_keyframes_bad(ms, torch.from_numpy(cull).to(ms.kf.valid.device))
    return M.refresh_covisibility(ms), n
