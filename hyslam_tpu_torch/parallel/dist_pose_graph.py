"""Distributed Sim3 pose-graph optimization: edge-sharded normal equations
all-reduced over ``torch.distributed`` (counterpart of
``hyslam_tpu/parallel/dist_pose_graph.py``).

The essential graph's edge count grows with the map (spanning tree, strong
covisibility and loop edges: O(K) to O(K^2) at loop-closure time). Here the
edge axis is sharded over the mesh: every rank holds the replicated [K, 8]
poses, linearizes its slice of edges with the written-out Jacobians of
``solver/pose_graph.edge_jacobians``, and the dense [7K, 7K] + [7K] normal
equations and the cost are all-reduced before a replicated solve. A rank
moves O(K^2) an LM iteration, whatever the edge count.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import sim3
from hyslam_tpu_torch.parallel.mesh import Mesh
from hyslam_tpu_torch.solver.ba import psum
from hyslam_tpu_torch.solver.pose_graph import edge_jacobians, edge_residual


def distributed_pose_graph(g: torch.Tensor, fixed: torch.Tensor, edge_i: torch.Tensor,
                           edge_j: torch.Tensor, edge_meas: torch.Tensor,
                           edge_valid: torch.Tensor, mesh: Mesh, axis: str = "lm",
                           edge_weight: torch.Tensor | None = None, n_iters: int = 20,
                           fix_scale: bool = False) -> torch.Tensor:
    """Edge-sharded ``optimize_pose_graph`` (the dense solve); the same
    result up to the order of the reductions. g [K,8] Sim3 world->camera
    poses, fixed [K] bool, edges (i [E], j [E], S_ji [E,8], valid [E],
    weight [E]), every rank with the whole arrays. E must be divisible by
    the axis size: pad with edge_valid False. Returns the poses [K,8], the
    same on every rank, on the mesh's device."""
    dev = mesh.device
    K, E = g.shape[0], edge_i.shape[0]
    n = mesh.shape[axis]
    if E % n:
        raise ValueError(f"E={E} edges not divisible by the {axis!r} axis ({n})")
    Es = E // n
    lo = mesh.index(axis) * Es
    group = mesh.group(axis)
    g = g.to(dev)
    fixed = fixed.to(dev)
    if edge_weight is None:
        edge_weight = torch.ones(E, dtype=g.dtype)
    sl = slice(lo, lo + Es)
    w = edge_weight[sl].to(dev) * edge_valid[sl].to(dev).to(g.dtype)
    ei = edge_i[sl].to(dev).long().clamp(0, K - 1)
    ej = edge_j[sl].to(dev).long().clamp(0, K - 1)
    meas = edge_meas[sl].to(dev)

    def cost_of(gv):
        r = edge_residual(gv[ei], gv[ej], meas)
        return psum(torch.sum(w * torch.sum(r * r, -1)), group)

    free = ~fixed
    fmask = free.to(g.dtype).repeat_interleave(7)
    lam = torch.full((), 1e-4, dtype=g.dtype, device=dev)
    cost = cost_of(g)
    for _ in range(n_iters):
        r, J = edge_jacobians(g[ei], g[ej], meas, fix_scale)
        Ji, Jj = J[..., :7], J[..., 7:]
        Hii = torch.einsum("e,eri,erj->eij", w, Ji, Ji)
        Hjj = torch.einsum("e,eri,erj->eij", w, Jj, Jj)
        Hij = torch.einsum("e,eri,erj->eij", w, Ji, Jj)
        bi = -torch.einsum("e,eri,er->ei", w, Ji, r)
        bj = -torch.einsum("e,eri,er->ei", w, Jj, r)
        H = torch.zeros((K * K, 7, 7), dtype=g.dtype, device=dev).index_put_(
            (torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei]),),
            torch.cat([Hii, Hjj, Hij, Hij.transpose(-1, -2)]), accumulate=True)
        b = torch.zeros((K, 7), dtype=g.dtype, device=dev).index_put_(
            (torch.cat([ei, ej]),), torch.cat([bi, bj]), accumulate=True)
        # the collective: the shards' normal equations summed
        H = psum(H, group)
        b = psum(b, group)

        Hm = H.reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        Hm = Hm + torch.diag(lam * torch.clamp_min(torch.diagonal(Hm), 1e-6))
        Hm = Hm * fmask[:, None] * fmask[None, :] + torch.diag(1.0 - fmask)
        # LU, as jnp.linalg.solve; a singular system gives a zero step, as
        # the JAX package's NaN -> 0 does (solve_ex does not raise)
        dx, info = torch.linalg.solve_ex(Hm, b.reshape(7 * K) * fmask)
        dx = dx.reshape(K, 7)
        if fix_scale:
            dx = torch.cat([torch.zeros_like(dx[:, :1]), dx[:, 1:]], dim=-1)
        dx = torch.where((info == 0) & torch.isfinite(dx), dx, 0.0)

        g_new = torch.where(fixed[:, None], g, sim3.compose(sim3.exp(dx), g))
        cost_new = cost_of(g_new)
        accept = cost_new < cost
        g = torch.where(accept, g_new, g)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e5)
        cost = torch.minimum(cost_new, cost)
    return g
