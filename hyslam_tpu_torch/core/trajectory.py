"""Per-frame trajectory: poses relative to continuously re-optimized
reference keyframes (counterpart of ``hyslam_tpu/core/trajectory.py``).

Every tracked frame stores Tcr = Tcw @ Tref^-1 so that, when BA moves the
keyframes, all frame poses re-derive by one gather and matmul (``refresh``).
Time interpolation and velocity integration are searchsorted plus SE3
geodesic interpolation. Fixed-capacity arena [T]; append is a cursor write.
State in, new state out; nothing reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.ops import indexing as ix


class Trajectory(NamedTuple):
    t: torch.Tensor         # [T] f32 timestamps
    Tcr: torch.Tensor       # [T, 4, 4] frame pose relative to its ref KF
    ref_kf: torch.Tensor    # [T] int32 reference keyframe id
    Tcw: torch.Tensor       # [T, 4, 4] cached absolute pose (refreshed)
    vel: torch.Tensor       # [T, 6] tangent velocity (per second)
    dt: torch.Tensor        # [T] time since the previous element
    good: torch.Tensor      # [T] bool tracking succeeded
    valid: torch.Tensor     # [T] bool
    size: torch.Tensor      # [] int32 cursor

    @property
    def capacity(self):
        return self.t.shape[0]


def empty_trajectory(T: int = 8192, device=None) -> Trajectory:
    eye = torch.eye(4, dtype=torch.float32, device=device).repeat(T, 1, 1)
    return Trajectory(
        t=torch.zeros((T,), dtype=torch.float32, device=device),
        Tcr=eye, ref_kf=torch.full((T,), -1, dtype=torch.int32, device=device),
        Tcw=eye.clone(), vel=torch.zeros((T, 6), dtype=torch.float32, device=device),
        dt=torch.zeros((T,), dtype=torch.float32, device=device),
        good=torch.zeros((T,), dtype=torch.bool, device=device),
        valid=torch.zeros((T,), dtype=torch.bool, device=device),
        size=torch.zeros((), dtype=torch.int32, device=device),
    )


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dtype=torch.float32, device=device)
    return torch.full((), x, dtype=torch.float32, device=device)


def append(traj: Trajectory, timestamp, Tcw: torch.Tensor, ref_kf,
           ref_Tcw: torch.Tensor, good, commit=True) -> Trajectory:
    """Append one frame: Tcr = Tcw @ ref_Tcw^-1 and the velocity against the
    previous element. With commit False the slot is written but ``size``
    stays, so the next append overwrites it. A write past the capacity is
    dropped, as the JAX package's scatter drops it."""
    dev = traj.t.device
    cap = traj.capacity
    i = traj.size
    prev = (i - 1).clamp(0, cap - 1)
    ts = _f32(timestamp, dev)
    dt = torch.where(i > 0, ts - ix.take(traj.t, prev), 0.0)
    rel = Tcw @ se3.inverse(ix.take(traj.Tcw, prev))
    v = torch.where((i > 0) & (dt > 1e-6),
                    se3.log(rel) / torch.clamp_min(dt, 1e-6), 0.0)
    Tcr = Tcw @ se3.inverse(ref_Tcw)
    commit_t = (commit.to(device=dev, dtype=torch.bool)
                if isinstance(commit, torch.Tensor)
                else torch.full((), bool(commit), dtype=torch.bool, device=dev))
    tgt = ix.route(cap, (i.reshape(1).long(),), (i < cap).reshape(1))

    def at(x, val):
        return ix.put(x, tgt, val.reshape((1,) + x.shape[1:])
                      if isinstance(val, torch.Tensor) else val)

    return traj._replace(
        t=at(traj.t, ts), Tcr=at(traj.Tcr, Tcr),
        ref_kf=at(traj.ref_kf, ix.rows_of(ref_kf, 1, dev)), Tcw=at(traj.Tcw, Tcw),
        vel=at(traj.vel, v), dt=at(traj.dt, dt),
        good=at(traj.good, good if isinstance(good, torch.Tensor) else bool(good)),
        valid=at(traj.valid, commit_t),
        size=i + commit_t.to(torch.int32),
    )


def refresh(traj: Trajectory, kf_Tcw: torch.Tensor, kf_bad: torch.Tensor,
            kf_span_parent: torch.Tensor,
            kf_Tcp: torch.Tensor | None = None) -> Trajectory:
    """Re-derive all absolute poses from the keyframes: Tcw[i] = Tcr[i] @
    kf_Tcw[ref]. A bad reference walks up the spanning tree to a live
    ancestor (K hops at most), composing each culled keyframe's frozen Tcp."""
    K = kf_Tcw.shape[0]
    if kf_Tcp is None:
        kf_Tcp = torch.eye(4, dtype=kf_Tcw.dtype, device=kf_Tcw.device).expand(kf_Tcw.shape)
    ref, T = traj.ref_kf, traj.Tcr
    for _ in range(K):
        rc = ref.clamp(0, K - 1).long()
        hop = (ref >= 0) & kf_bad[rc]
        T = torch.where(hop[:, None, None], T @ kf_Tcp[rc], T)
        ref = torch.where(hop, kf_span_parent[rc], ref)
    refc = ref.clamp(0, K - 1).long()
    ok = traj.valid & (ref >= 0) & ~kf_bad[refc]
    return traj._replace(Tcw=torch.where(ok[:, None, None], T @ kf_Tcw[refc], traj.Tcw))


def _bracket(traj: Trajectory, query_t: torch.Tensor):
    """(hi index of each query time among the recorded times, last index)."""
    cap = traj.capacity
    n = traj.size
    tmax = (n - 1).clamp(0, cap - 1)
    times = torch.where(torch.arange(cap, device=traj.t.device) < n, traj.t,
                        ix.take(traj.t, tmax) + 1e6)
    hi = torch.searchsorted(times, query_t.contiguous(), side="left")
    return torch.minimum(hi.clamp_min(0), tmax.long()), tmax


def pose_at_time(traj: Trajectory, query_t: torch.Tensor):
    """SE3-interpolated poses at query times [Q], clamped to the recorded
    range. Returns (Tcw [Q,4,4], ok [Q])."""
    hi, tmax = _bracket(traj, query_t)
    lo = torch.minimum((hi - 1).clamp_min(0), tmax.long())
    t0 = traj.t[lo]
    t1 = traj.t[hi]
    alpha = torch.clamp((query_t - t0) / torch.clamp_min(t1 - t0, 1e-9), 0.0, 1.0)
    T = se3.interpolate(traj.Tcw[lo], traj.Tcw[hi], alpha)
    ok = (traj.size > 0) & (query_t >= traj.t[0] - 0.5) & (
        query_t <= ix.take(traj.t, tmax) + 0.5)
    return T, ok


def velocity_at_time(traj: Trajectory, query_t: torch.Tensor) -> torch.Tensor:
    """Tangent velocity at query times [Q] -> [Q, 6]."""
    hi, _ = _bracket(traj, query_t)
    return traj.vel[hi]


def integrate_velocity(traj: Trajectory, t0, t1) -> torch.Tensor:
    """Integrated motion over [t0, t1] as an SE3 increment: piecewise-constant
    velocity per recorded interval, with exact partial weights at both ends."""
    idx = torch.arange(traj.capacity, device=traj.t.device)
    seg_ok = traj.valid & (idx < traj.size) & (traj.dt > 1e-9)
    ov0 = torch.maximum(traj.t - traj.dt, _f32(t0, traj.t.device))
    ov1 = torch.minimum(traj.t, _f32(t1, traj.t.device))
    w = torch.clamp_min(ov1 - ov0, 0.0) * seg_ok
    return se3.exp(torch.sum(traj.vel * w[:, None], dim=0))


def predict_pose(traj: Trajectory, query_t) -> torch.Tensor:
    """Constant-velocity extrapolated pose at a (future) time: the motion
    model's prior."""
    last = (traj.size - 1).clamp(0, traj.capacity - 1)
    dt = _f32(query_t, traj.t.device) - ix.take(traj.t, last)
    return se3.exp(ix.take(traj.vel, last) * dt) @ ix.take(traj.Tcw, last)
