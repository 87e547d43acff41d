"""Two-view DLT triangulation, batched (counterpart of
``hyslam_tpu/geometry/triangulation.py``)."""

from __future__ import annotations

import torch


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """DLT triangulation: P1, P2 [..., 3, 4] projection matrices, uv1, uv2
    [..., 2] pixels -> world points [..., 3]. The homogeneous solution is
    the eigenvector of A^T A with the smallest eigenvalue (``eigh`` sorts
    them ascending); its sign cancels in the dehomogenisation."""
    def rows(P, uv):
        r0 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
        r1 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
        return torch.stack([r0, r1], dim=-2)

    A = torch.cat([rows(P1, uv1), rows(P2, uv2)], dim=-2)     # [..., 4, 4]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    X = vecs[..., :, 0]
    w = X[..., 3]
    wsafe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / wsafe[..., None]


def projection_matrix(K: torch.Tensor, Tcw: torch.Tensor) -> torch.Tensor:
    """K [3,3] and Tcw [..., 4, 4] -> P = K [R|t], [..., 3, 4]."""
    return torch.einsum("ij,...jk->...ik", K, Tcw[..., :3, :])
