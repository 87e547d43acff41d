"""The one traffic generator: a camera path and a world of textured points
along it, both from a traffic file's parameters and the run's seed, and the
stereo pairs the rig sees, rendered on the device.

Path. The camera starts at the identity pose (looking down +z, x right, y
down) and each frame moves ``step_m`` along its own optical axis and turns
about its own y axis by ``yaw_rad + yaw_amp_rad * sin(2 pi i /
yaw_period_frames)``. Poses are compounded in float64 on the host.

World. Each layer puts ``per_m`` points a metre of path over arc lengths
[start_m, path length + ahead_m], at the path's pose there, offset along
the camera's x axis within ``lateral_m`` and along its y axis (down)
within ``vertical_m``. The points are stratified, so that every seed gives
the same amount of structure everywhere and only the details differ: one
point in each of ``count`` equal slots of arc length, and each run of
SECTION_GRID**2 consecutive slots covers the SECTION_GRID x SECTION_GRID
cells of the section once each, in an order drawn from the seed; the
position within a slot and a cell is uniform. Drawn on the device by a
``torch.Generator`` seeded with the run's seed.

Images. The torch form of the port's synthetic renderer
(``utils/synth.py:render_world``): every visible point splats 5 sub-blobs
at offsets uniform in +/-4 px with amplitudes uniform in [0.4, 1] x 180
over a background of 20, then a 5-tap Gaussian blur (sigma 1) with
replicated borders, clipped to [0, 255] and truncated to uint8. The right
image is rendered from the pose moved one baseline along -x. Accumulation
runs under PyTorch's deterministic algorithms, so one seed gives the same
bits in every run on one kind of device.
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
    bf: float


class Sequence(NamedTuple):
    poses: np.ndarray          # [n, 4, 4] float64 true Tcw of every frame
    pairs: torch.Tensor        # [n, 2, H, W] uint8 stereo pairs on the device
    points: torch.Tensor       # [P, 3] float32 world points on the device
    frame_dt: float            # seconds between frames
    warm: int                  # frames fed before the window


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


def path_poses(motion: dict, n: int) -> np.ndarray:
    """[n, 4, 4] float64 Tcw of the path's first n frames."""
    step = float(motion.get("step_m", 0.0))
    yaw = float(motion.get("yaw_rad", 0.0))
    amp = float(motion.get("yaw_amp_rad", 0.0))
    period = float(motion.get("yaw_period_frames", 1.0))
    T = np.eye(4)
    out = []
    for i in range(n):
        out.append(T)
        turn = yaw + amp * math.sin(2.0 * math.pi * i / period)
        T = se3_exp([0.0, turn, 0.0, 0.0, 0.0, -step]) @ T
    return np.stack(out)


def n_frames(traffic: dict, seconds: float) -> int:
    """Frames in the sequence: the warm frames and ``max_fps`` frames a
    second of the window."""
    return int(traffic["warm_frames"]) + int(math.ceil(float(traffic["max_fps"]) * seconds))


def world_points(traffic: dict, poses: np.ndarray, gen: torch.Generator,
                 device) -> torch.Tensor:
    """[P, 3] float32 world points along the path of ``poses``."""
    motion = traffic["motion"]
    ahead = max(float(layer["ahead_m"]) for layer in traffic["world"])
    step = float(motion["step_m"])
    if step <= 0:
        raise ValueError("the world is laid along the path: step_m must be > 0")
    n_moving = len(poses)
    n_ext = n_moving + int(math.ceil(ahead / step)) + 2
    ext = path_poses(motion, n_ext)
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


def _blur5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap Gaussian (sigma 1) of [B, H, W], borders replicated."""
    x0 = np.arange(5) - 2.0
    kk = np.exp(-0.5 * x0 ** 2)
    kk = (kk / kk.sum()).astype(np.float32)
    H, W = img.shape[-2:]
    x = torch.cat([img[:, :1]] * 2 + [img] + [img[:, -1:]] * 2, dim=1)
    acc = torch.zeros_like(img)
    for i in range(5):
        acc = acc + float(kk[i]) * x[:, i:i + H]
    x = torch.cat([acc[:, :, :1]] * 2 + [acc] + [acc[:, :, -1:]] * 2, dim=2)
    out = torch.zeros_like(img)
    for i in range(5):
        out = out + float(kk[i]) * x[:, :, i:i + W]
    return out


def render(cam: Camera, Tcw: torch.Tensor, pts: torch.Tensor, offs: torch.Tensor,
           amps: torch.Tensor) -> torch.Tensor:
    """uint8 images [B, H, W] of points [P, 3] from poses Tcw [B, 4, 4]."""
    B = Tcw.shape[0]
    H, W = cam.height, cam.width
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
    img = _blur5(img.reshape(B, H, W))
    return torch.clamp(img, 0.0, 255.0).to(torch.uint8)


def build(cam: Camera, traffic: dict, frame_dt: float, seed: int, seconds: float,
          device, batch: int = 16) -> Sequence:
    """The sequence of one run: n_frames(traffic, seconds) stereo pairs."""
    n = n_frames(traffic, seconds)
    poses = path_poses(traffic["motion"], n)
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
        T_right = np.eye(4)
        T_right[0, 3] = -cam.bf / cam.fx
        pairs = torch.empty((n, 2, cam.height, cam.width), dtype=torch.uint8, device=device)
        for i in range(0, n, batch):
            Tl = torch.as_tensor(poses[i:i + batch], dtype=torch.float32, device=device)
            Tr = torch.as_tensor(T_right @ poses[i:i + batch], dtype=torch.float32, device=device)
            pairs[i:i + batch, 0] = render(cam, Tl, pts, offs, amps)
            pairs[i:i + batch, 1] = render(cam, Tr, pts, offs, amps)
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
    return Sequence(poses=poses, pairs=pairs, points=pts, frame_dt=frame_dt,
                    warm=int(traffic["warm_frames"]))
