"""The one traffic generator: a path of the rig's body and a world of
textured points along it, both from a traffic file's parameters and the
run's seed, and the images every camera of the rig sees, rendered on the
device.

Path. The body starts at the identity pose (looking down +z, x right, y
down) and each frame moves ``step_m`` along its own optical axis and turns
about its own y axis by ``yaw_rad + yaw_amp_rad * sin(2 pi i /
yaw_period_frames)``: the travel. Where ``motion`` holds
``hold_after_frames`` h, these keys sit in its block ``travel``, and after
frame h the body holds the pose it has reached and sways about it: at
frame i, with phi = 2 pi (i - h) / ``sway_period_frames``, it stands
``sway_m[0] sin(phi)`` along its held x axis and ``sway_m[1] sin(2 phi)``
along its held y axis (a figure of eight), turned by ``sway_yaw_rad
sin(phi)`` about its y axis. Poses are compounded in float64 on the host.

World. Each layer puts ``per_m`` points a metre of the travel over arc
lengths [start_m, length travelled + ahead_m], at the travel's pose there,
offset along the body's x axis within ``lateral_m`` and along its y axis
(down) within ``vertical_m``: the world is laid along the part of the path
that moves. The points are stratified, so that every seed gives the same
amount of structure everywhere and only the details differ: one point in
each of ``count`` equal slots of arc length, and each run of
SECTION_GRID**2 consecutive slots covers the SECTION_GRID x SECTION_GRID
cells of the section once each, in an order drawn from the seed; the
position within a slot and a cell is uniform. Drawn on the device by a
``torch.Generator`` seeded with the run's seed.

Cameras. The rig's first camera is the SLAM camera, posed at the body; it
sees every frame. Every other camera is posed by its ``Tcam`` (body ->
camera) on the body's path and sees one frame each ``every`` SLAM frames,
at the SLAM frame's time, or one each of its own ``frame_dt``, posed
between two frames of the path by the twist between them (or the sway at
that time). Each renders at its native size; a stereo camera (bf > 0)
renders a pair.

Images. The torch form of the port's synthetic renderer
(``utils/synth.py:render_world``): every visible point splats 5 sub-blobs
at offsets uniform in +/-4 px with amplitudes uniform in [0.4, 1] x 180
over a background of 20, then a 5-tap Gaussian blur (sigma 1) with
replicated borders, clipped to [0, 255] and truncated to uint8. A camera
whose images the program scales by ``scale`` before extraction renders at
its native size with the offsets and the blur widened by 1 / scale
(``render_world``'s ``blob_scale``), so that its working images look as a
scale-1 rendering does. The right image is rendered from the pose moved
one baseline along -x. Accumulation runs under PyTorch's deterministic
algorithms, so one seed gives the same bits in every run on one kind of
device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

SECTION_GRID = 3   # cells a side of the section that each run of slots covers


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    bf: float                  # 0: a monocular camera
    scale: float = 1.0         # the program scales its images by this
    Tcam: tuple | None = None  # 4x4 body -> camera; None: at the body
    every: int = 1             # one frame each `every` SLAM frames ...
    frame_dt: float | None = None   # ... or one each frame_dt seconds


class Feed(NamedTuple):
    """The frames of one camera other than the SLAM camera."""
    images: torch.Tensor       # [m, 2, H, W] (stereo) or [m, H, W] uint8 on the device
    times: np.ndarray          # [m] float64 timestamps
    steps: np.ndarray          # [m] the SLAM frame each is fed after
    poses: np.ndarray          # [m, 4, 4] float64 true Tcw


class Sequence(NamedTuple):
    poses: np.ndarray          # [n, 4, 4] float64 true Tcw of every SLAM frame
    pairs: torch.Tensor        # [n, 2, H, W] uint8 SLAM stereo pairs on the device
    points: torch.Tensor       # [P, 3] float32 world points on the device
    frame_dt: float            # seconds between SLAM frames
    warm: int                  # SLAM frames fed before the window
    feeds: dict                # camera name -> Feed, for every other camera


def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def se3_exp(xi) -> np.ndarray:
    """[6] (omega, upsilon) -> [4, 4] float64."""
    xi = np.asarray(xi, np.float64)
    w, v = xi[:3], xi[3:]
    th2 = float(w @ w)
    W = _hat(w)
    if th2 < 1e-12:
        A, B, C = 1.0, 0.5, 1.0 / 6.0
    else:
        th = math.sqrt(th2)
        A, B, C = math.sin(th) / th, (1.0 - math.cos(th)) / th2, (1.0 - math.sin(th) / th) / th2
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + A * W + B * (W @ W)
    T[:3, 3] = (np.eye(3) + B * W + C * (W @ W)) @ v
    return T


def _travel(motion: dict) -> dict:
    """The moving form's keys: ``travel`` where the path holds, else the
    motion itself."""
    return motion["travel"] if "hold_after_frames" in motion else motion


def _twist(travel: dict, i: float) -> list:
    """The travel's step from frame i to frame i + 1."""
    step = float(travel.get("step_m", 0.0))
    yaw = float(travel.get("yaw_rad", 0.0))
    amp = float(travel.get("yaw_amp_rad", 0.0))
    period = float(travel.get("yaw_period_frames", 1.0))
    return [0.0, yaw + amp * math.sin(2.0 * math.pi * i / period), 0.0, 0.0, 0.0, -step]


def _sway(motion: dict, held: np.ndarray, f: float) -> np.ndarray:
    """Tcw at frame f >= hold_after_frames: the held pose, swayed."""
    phi = 2.0 * math.pi * (f - int(motion["hold_after_frames"])) / float(
        motion["sway_period_frames"])
    sx, sy = (float(x) for x in motion.get("sway_m", (0.0, 0.0)))
    th = float(motion.get("sway_yaw_rad", 0.0)) * math.sin(phi)
    c, s = math.cos(th), math.sin(th)
    Thc = np.eye(4)              # the swayed camera in the held camera's frame
    Thc[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    Thc[:3, 3] = [sx * math.sin(phi), sy * math.sin(2.0 * phi), 0.0]
    return np.linalg.inv(Thc) @ held


def path_poses(motion: dict, n: int) -> np.ndarray:
    """[n, 4, 4] float64 Tcw of the path's first n frames."""
    travel = _travel(motion)
    hold = int(motion.get("hold_after_frames", n))
    T = np.eye(4)
    out = []
    for i in range(min(n, hold + 1)):
        out.append(T)
        T = se3_exp(_twist(travel, i)) @ T
    held = out[-1]
    out += [_sway(motion, held, i) for i in range(len(out), n)]
    return np.stack(out)


def pose_at(motion: dict, poses: np.ndarray, f: float) -> np.ndarray:
    """Tcw at the fractional frame f of a path whose frames are ``poses``."""
    hold = motion.get("hold_after_frames")
    if hold is not None and f >= int(hold):
        return _sway(motion, poses[int(hold)], f)
    i = int(math.floor(f))
    a = f - i
    if a == 0.0:
        return poses[i]
    return se3_exp(a * np.asarray(_twist(_travel(motion), i))) @ poses[i]


def n_frames(traffic: dict, seconds: float) -> int:
    """SLAM frames in the sequence: the warm frames and ``max_fps`` frames a
    second of the window."""
    return int(traffic["warm_frames"]) + int(math.ceil(float(traffic["max_fps"]) * seconds))


def world_points(traffic: dict, poses: np.ndarray, gen: torch.Generator,
                 device) -> torch.Tensor:
    """[P, 3] float32 world points along the travel of ``poses``."""
    motion = traffic["motion"]
    travel = _travel(motion)
    ahead = max(float(layer["ahead_m"]) for layer in traffic["world"])
    step = float(travel["step_m"])
    if step <= 0:
        raise ValueError("the world is laid along the path: step_m must be > 0")
    n_moving = min(len(poses), int(motion.get("hold_after_frames", len(poses))) + 1)
    n_ext = n_moving + int(math.ceil(ahead / step)) + 2
    ext = path_poses(travel, n_ext)
    Twc = np.linalg.inv(ext)
    centre = torch.as_tensor(Twc[:, :3, 3], dtype=torch.float64, device=device)
    axes = torch.as_tensor(Twc[:, :3, :3], dtype=torch.float64, device=device)
    travelled = step * (n_moving - 1)
    parts = []
    for layer in traffic["world"]:
        lo = float(layer["start_m"])
        hi = travelled + float(layer["ahead_m"])
        count = int(round(float(layer["per_m"]) * (hi - lo)))
        u = torch.rand((count, 3), generator=gen, device=device, dtype=torch.float64)
        slot = torch.arange(count, device=device, dtype=torch.float64)
        s = lo + (hi - lo) * (slot + u[:, 0]) / count
        g = SECTION_GRID
        n_runs = -(-count // (g * g))
        order = torch.rand((n_runs, g * g), generator=gen, device=device).argsort(dim=1)
        cell = order.reshape(-1)[:count].to(torch.float64)
        lat = layer["lateral_m"][0] + (layer["lateral_m"][1] - layer["lateral_m"][0]) * (
            torch.remainder(cell, g) + u[:, 1]) / g
        ver = layer["vertical_m"][0] + (layer["vertical_m"][1] - layer["vertical_m"][0]) * (
            torch.div(cell, g, rounding_mode="floor") + u[:, 2]) / g
        f = (s / step).clamp(0, n_ext - 1.000001)
        i0 = f.floor().long()
        a = (f - i0)[:, None]
        c = centre[i0] * (1 - a) + centre[(i0 + 1).clamp(max=n_ext - 1)] * a
        R = axes[i0]
        parts.append(c + lat[:, None] * R[:, :, 0] + ver[:, None] * R[:, :, 1])
    return torch.cat(parts).to(torch.float32)


def _blur(img: torch.Tensor, r: int = 2, sigma: float = 1.0) -> torch.Tensor:
    """Separable (2r + 1)-tap Gaussian of [B, H, W], borders replicated."""
    x0 = np.arange(2 * r + 1) - float(r)
    kk = np.exp(-0.5 * (x0 / sigma) ** 2)
    kk = (kk / kk.sum()).astype(np.float32)
    H, W = img.shape[-2:]
    x = torch.cat([img[:, :1]] * r + [img] + [img[:, -1:]] * r, dim=1)
    acc = torch.zeros_like(img)
    for i in range(2 * r + 1):
        acc = acc + float(kk[i]) * x[:, i:i + H]
    x = torch.cat([acc[:, :, :1]] * r + [acc] + [acc[:, :, -1:]] * r, dim=2)
    out = torch.zeros_like(img)
    for i in range(2 * r + 1):
        out = out + float(kk[i]) * x[:, :, i:i + W]
    return out


def render(cam: Camera, Tcw: torch.Tensor, pts: torch.Tensor, offs: torch.Tensor,
           amps: torch.Tensor) -> torch.Tensor:
    """uint8 images [B, H, W] of points [P, 3] from poses Tcw [B, 4, 4], at
    the camera's native size."""
    B = Tcw.shape[0]
    H, W = cam.height, cam.width
    widen = 1.0 / float(cam.scale)
    if widen != 1.0:
        offs = offs * widen
    # products and sums written out: no matmul, so no TF32 setting reaches them
    pc = (Tcw[:, None, :3, :3] * pts[None, :, None, :]).sum(-1) + Tcw[:, None, :3, 3]
    z = pc[..., 2]
    zs = torch.where(z.abs() < 1e-9, 1e-9, z)
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    vis = (z > 0.2) & (u > 8) & (u < W - 8) & (v > 8) & (v < H - 8)
    xi = torch.round(u[..., None] + offs[None, :, :, 0]).long()
    yi = torch.round(v[..., None] + offs[None, :, :, 1]).long()
    ok = vis[..., None] & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    b = torch.arange(B, device=pts.device)[:, None, None].expand_as(xi)
    flat = (b * (H * W) + yi * W + xi)[ok]
    img = torch.full((B * H * W,), 20.0, dtype=torch.float32, device=pts.device)
    img.index_put_((flat,), amps.expand(B, -1, -1)[ok], accumulate=True)
    img = _blur(img.reshape(B, H, W), int(round(2 * widen)), widen)
    return torch.clamp(img, 0.0, 255.0).to(torch.uint8)


def _schedule(cam: Camera, motion: dict, poses: np.ndarray, frame_dt: float):
    """(times, steps, body Tcw) of a camera other than the SLAM camera."""
    n = len(poses)
    if cam.frame_dt is None:
        steps = np.arange(0, n, int(cam.every))
        return steps * frame_dt, steps, poses[steps]
    times = np.arange(int(math.ceil(n * frame_dt / cam.frame_dt))) * float(cam.frame_dt)
    f = times / frame_dt
    steps = np.floor(f + 1e-9).astype(int)
    keep = steps < n
    f, times, steps = f[keep], times[keep], steps[keep]
    return times, steps, np.stack([pose_at(motion, poses, x) for x in f])


def _render_all(cam: Camera, Tcw: np.ndarray, pts, offs, amps, device, batch: int):
    """[m, 2, H, W] pairs (bf > 0) or [m, H, W] images of poses Tcw [m, 4, 4]."""
    m = len(Tcw)
    stereo = cam.bf > 0
    out = torch.empty((m, 2, cam.height, cam.width) if stereo else (m, cam.height, cam.width),
                      dtype=torch.uint8, device=device)
    T_right = np.eye(4)
    if stereo:
        T_right[0, 3] = -cam.bf / cam.fx
    for i in range(0, m, batch):
        Tl = torch.as_tensor(Tcw[i:i + batch], dtype=torch.float32, device=device)
        if not stereo:
            out[i:i + batch] = render(cam, Tl, pts, offs, amps)
            continue
        Tr = torch.as_tensor(T_right @ Tcw[i:i + batch], dtype=torch.float32, device=device)
        out[i:i + batch, 0] = render(cam, Tl, pts, offs, amps)
        out[i:i + batch, 1] = render(cam, Tr, pts, offs, amps)
    return out


def build(rig, traffic: dict, frame_dt: float, seed: int, seconds: float,
          device, batch: int = 16) -> Sequence:
    """The sequence of one run: n_frames(traffic, seconds) SLAM stereo pairs
    and every other camera's frames over the same time. ``rig``:
    {name: Camera}, the SLAM camera first."""
    (_, slam), *others = rig.items()
    n = n_frames(traffic, seconds)
    motion = traffic["motion"]
    poses = path_poses(motion, n)
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (2**63))
        pts = world_points(traffic, poses, gen, device)
        P = pts.shape[0]
        offs = (torch.rand((P, 5, 2), generator=gen, device=device) * 8.0 - 4.0)
        amps = (0.4 + 0.6 * torch.rand((P, 5), generator=gen, device=device)) * 180.0
        pairs = _render_all(slam, _posed(slam, poses), pts, offs, amps, device, batch)
        feeds = {}
        for name, cam in others:
            times, steps, body = _schedule(cam, motion, poses, frame_dt)
            Tcw = _posed(cam, body)
            feeds[name] = Feed(images=_render_all(cam, Tcw, pts, offs, amps, device, batch),
                               times=times, steps=steps, poses=Tcw)
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
    return Sequence(poses=_posed(slam, poses), pairs=pairs, points=pts, frame_dt=frame_dt,
                    warm=int(traffic["warm_frames"]), feeds=feeds)


def _posed(cam: Camera, body: np.ndarray) -> np.ndarray:
    """The camera's Tcw [m, 4, 4] on the body's poses."""
    return body if cam.Tcam is None else np.asarray(cam.Tcam, np.float64) @ body
