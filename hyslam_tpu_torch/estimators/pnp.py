"""PnP-RANSAC: absolute pose from 3D-2D correspondences (counterpart of
``hyslam_tpu/estimators/pnp.py``, used by relocalization).

All 256 hypotheses are one batch: minimal sets of 6 points solved by
normalized DLT (one batched 12x12 ``eigh``, then a 3x3 SVD that projects the
rotation block onto the rotations), scored together by chi2 reprojection
(5.991 sigma^2), the best taken by ``argmax`` (the first of equal counts).
The winner is refined by the pose-only LM on its inliers:
``pose_optimization_fast``, kernel K1 on a card.

The DLT solution is an eigenvector, whose sign is arbitrary: ``eigh`` in the
JAX package and in torch, on the CPU and on a card, return either. The JAX
package takes it as it comes, and where it comes negated its rotation block
has determinant -1 and the projection makes a pose far from the solution.
Here the sign is fixed first (the rotation block's determinant positive),
so that every hypothesis is the JAX package's for its positive sign. The
minimal sets are an argument, as in ``two_view``: ``sample_sets`` draws
them from a seeded ``torch.Generator`` on the points' device.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.estimators.two_view import det3, draw_valid
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.solver.pose_opt import pose_optimization_fast

N_HYPOTHESES = 256
MIN_SET = 6
CHI2_PNP = 5.991


def sample_sets(valid: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """[N_HYPOTHESES, MIN_SET] rows drawn uniformly from the valid rows, from
    a generator seeded with ``seed`` on valid's device (all 0 where no row
    is valid)."""
    g = torch.Generator(device=valid.device).manual_seed(seed)
    idx = draw_valid(valid, N_HYPOTHESES, MIN_SET, g)
    return torch.where(torch.any(valid), idx, 0)


def _dlt_pose(Xs: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Minimal sets Xs [S,m,3] world, xs [S,m,2] normalized image coordinates
    -> Tcw [S,4,4] (possibly ill-conditioned: the caller scores them)."""
    ones = torch.ones_like(Xs[..., :1])
    Xh = torch.cat([Xs, ones], dim=-1)
    zeros = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zeros, -xs[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zeros, Xh, -xs[..., 1:2] * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                                  # [S, 2m, 12]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    p = vecs[..., :, 0].reshape(*Xs.shape[:-2], 3, 4)
    # the eigenvector's sign: the one with a proper rotation block
    p = p * torch.where(det3(p[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    u, s, vt = torch.linalg.svd(p[..., :3])
    det = det3(u @ vt)
    scale = torch.mean(s, dim=-1) * det
    R = (u * torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)[..., None, :]) @ vt
    t = p[..., 3] / torch.where(torch.abs(scale) < 1e-12, 1e-12, scale)[..., None]
    return se3.from_Rt(R, t)


def pnp_hypotheses(cam: Camera, X: torch.Tensor, uv: torch.Tensor,
                   idx: torch.Tensor) -> torch.Tensor:
    """The DLT pose of every minimal set idx [S, MIN_SET] -> [S,4,4]."""
    xh = _homogeneous(uv) @ cam.K_inv(device=uv.device).T
    xn = xh[:, :2] / xh[:, 2:3]
    idx = idx.long()
    return _dlt_pose(X[idx], xn[idx])


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=-1)


def pnp_ransac(cam: Camera, X: torch.Tensor, uv: torch.Tensor,
               inv_sigma2: torch.Tensor, valid: torch.Tensor, idx: torch.Tensor):
    """X [N,3] world points, uv [N,2] pixels, inv_sigma2 [N], valid [N], and
    the minimal sets idx [S, MIN_SET] -> (Tcw [4,4], inliers [N], count):
    the hypothesis with the most points in front (z > 0.05) under the chi2
    gate. Refine it with the pose-only LM afterwards."""
    Ts = pnp_hypotheses(cam, X, uv, idx)                             # [S, 4, 4]
    pc = se3.apply(Ts[:, None], X)                                   # [S, N, 3]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    c2 = inv_sigma2 * ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2)
    ok = valid & (z > 0.05) & (c2 < CHI2_PNP)
    counts = torch.sum(ok, dim=-1, dtype=torch.int32)
    best = torch.argmax(counts)
    return Ts[best], ok[best], counts[best]


def pnp_ransac_refined(cam: Camera, X, uv, inv_sigma2, valid, seed: int = 0, idx=None):
    """RANSAC, then the pose-only LM on the inlier set, monocular
    (``stereo`` all False): (Tcw, inliers, count). ``idx`` defaults to
    ``sample_sets(valid, seed)``."""
    idx = sample_sets(valid, seed) if idx is None else idx
    T0, inl, _ = pnp_ransac(cam, X, uv, inv_sigma2, valid, idx)
    res = pose_optimization_fast(cam, T0, X, uv, torch.full_like(inv_sigma2, -1.0),
                                 inv_sigma2, inl, torch.zeros_like(inl))
    return res.Tcw, res.inliers, res.num_inliers
