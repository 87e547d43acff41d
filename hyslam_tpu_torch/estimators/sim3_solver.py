"""Sim3 RANSAC between two keyframes' matched landmarks (counterpart of
``hyslam_tpu/estimators/sim3_solver.py``).

128 three-point Horn hypotheses, solved as one batch, scored together by
the reprojection chi2 in both images (each under 9.21 sigma^2); the best is
the first of most inliers (``argmax``), then a weighted Horn refit on its
inliers is kept where it scores no worse. Scale can be fixed (stereo,
RGB-D).

The minimal sets are an argument: ``sample_sets`` draws them from the valid
pairs with a ``torch.Generator`` seeded on the pairs' device (the JAX
package draws them with ``jax.random`` keyed by the keyframe id; the parity
tests feed both the JAX draws). Nothing is read back to the host.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.estimators.two_view import draw_valid
from hyslam_tpu_torch.geometry import sim3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.geometry.horn import horn_sim3

N_HYPOTHESES = 128
MIN_SET = 3
CHI2_SIM3 = 9.21  # 99% 2-dof


def sample_sets(valid: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """[N_HYPOTHESES, 3] pair indices drawn uniformly from the valid pairs,
    from a generator seeded with ``seed`` (all 0 where no pair is valid)."""
    g = torch.Generator(device=valid.device).manual_seed(seed)
    idx = draw_valid(valid, N_HYPOTHESES, MIN_SET, g)
    return torch.where(torch.any(valid), idx, 0)


def project_z(cam: Camera, pc: torch.Tensor) -> torch.Tensor:
    """Pinhole projection [..., 3] -> [..., 2] with the depth held at 1e-6
    or more."""
    z = torch.clamp_min(pc[..., 2], 1e-6)
    return torch.stack([cam.fx * pc[..., 0] / z + cam.cx,
                        cam.fy * pc[..., 1] / z + cam.cy], dim=-1)


def _score(cam1, cam2, g, X1, X2, uv1, uv2, is2_1, is2_2, valid):
    """Inlier count [...] and mask [..., N] of Sim3s g [..., 8]: X2 through
    g into image 1, X1 through g^-1 into image 2."""
    gb = g[..., None, :]
    p1 = project_z(cam1, sim3.apply(gb, X2))
    p2 = project_z(cam2, sim3.apply(sim3.inverse(gb), X1))
    e1 = torch.sum((p1 - uv1) ** 2, dim=-1) * is2_1
    e2 = torch.sum((p2 - uv2) ** 2, dim=-1) * is2_2
    ok = valid & (e1 < CHI2_SIM3) & (e2 < CHI2_SIM3)
    return torch.sum(ok, dim=-1, dtype=torch.int32), ok


def sim3_ransac(cam1: Camera, cam2: Camera, X1: torch.Tensor, X2: torch.Tensor,
                uv1: torch.Tensor, uv2: torch.Tensor, inv_sigma2_1: torch.Tensor,
                inv_sigma2_2: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor,
                fix_scale: bool = False):
    """X1 / X2 [N,3] the matched landmarks in camera 1 / camera 2
    coordinates, uv1 / uv2 [N,2] their pixels, inv_sigma2_* [N], valid [N],
    idx [S, 3] the minimal sets. Returns (g12 [8], mapping camera-2
    coordinates to camera 1's: X1 ~ g12 X2; inliers [N]; their count)."""
    idx = idx.long()
    gs = horn_sim3(X2[idx], X1[idx], fix_scale=fix_scale)               # [S, 8]
    counts, inls = _score(cam1, cam2, gs, X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2,
                          valid)
    best = torch.argmax(counts)
    g_best, inl, n_best = gs[best], inls[best], counts[best]
    # refit on the inliers
    g_ref = horn_sim3(X2, X1, weights=inl.to(X1.dtype), fix_scale=fix_scale)
    n_ref, inl_ref = _score(cam1, cam2, g_ref, X1, X2, uv1, uv2, inv_sigma2_1,
                            inv_sigma2_2, valid)
    better = n_ref >= n_best
    return (torch.where(better, g_ref, g_best), torch.where(better, inl_ref, inl),
            torch.maximum(n_ref, n_best))
