"""3D map rendering (src/viz/MapDrawer.{h,cc} parity; counterpart of
``hyslam_tpu/viz/map_drawer.py``, drawing the port's ``MapState``).

The reference MapDrawer draws into Pangolin: map points (black; tracked
local points red), keyframe frusta (blue), the covisibility graph +
spanning tree (green lines), the trajectory, and the current camera
(green frustum) — MapDrawer.h:49-62. Here the same scene is projected
through a virtual pinhole camera (default: elevated chase view behind the
current camera) and rasterized into a numpy RGB image. The state is read
to numpy on the host once a draw.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from hyslam_tpu_torch.core.mapstate import COVIS_THRESHOLD, MapState
from hyslam_tpu_torch.viz import draw2d

PT_COLOR = (210, 210, 210)
PT_LOCAL = (255, 90, 90)
KF_COLOR = (90, 140, 255)
GRAPH_COLOR = (90, 220, 90)
TRAJ_COLOR = (255, 210, 80)
CAM_COLOR = (90, 255, 120)
BG = (12, 12, 16)


def _look_at(eye, target, up=(0.0, -1.0, 0.0)):
    """World->view rotation/translation for a camera at eye looking at
    target (y-down image convention)."""
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / max(np.linalg.norm(f), 1e-9)
    r = np.cross(f, np.asarray(up, np.float64))
    r = r / max(np.linalg.norm(r), 1e-9)
    u = np.cross(f, r)
    R = np.stack([r, u, f])          # rows: right, down, forward
    t = -R @ eye
    return R, t


def _project(pts, R, t, f, cx, cy):
    pc = pts @ R.T + t
    z = np.maximum(pc[:, 2], 1e-6)
    uv = np.stack([f * pc[:, 0] / z + cx, f * pc[:, 1] / z + cy], -1)
    return uv, pc[:, 2] > 1e-3


def _frustum_corners(Twc, size):
    """5 corners (apex + 4 image-plane corners) of a camera frustum in
    world coordinates; Twc [4,4] camera->world."""
    s = size
    local = np.array([
        [0, 0, 0], [-s, -0.7 * s, 1.6 * s], [s, -0.7 * s, 1.6 * s],
        [s, 0.7 * s, 1.6 * s], [-s, 0.7 * s, 1.6 * s],
    ])
    return local @ Twc[:3, :3].T + Twc[:3, 3]


_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3), (3, 4),
                  (4, 1)]


def draw_map(
    ms: MapState,
    size=(960, 720),
    current_Tcw=None,
    trajectory_centers=None,
    local_lm_mask=None,
    draw_graph: bool = True,
    view_eye=None,
    view_target=None,
) -> np.ndarray:
    """Render the map state. Default viewpoint auto-frames the map."""
    w, h = size
    img = draw2d.blank(h, w, BG)
    kf_ok, lm_ok, Tcw, pos, Wc = (t.cpu().numpy() for t in (
        ms.kf.valid & ~ms.kf.bad, ms.lm.valid & ~ms.lm.bad, ms.kf.Tcw, ms.lm.pos,
        ms.covis))

    centers = np.stack([
        -Tcw[k, :3, :3].T @ Tcw[k, :3, 3] for k in range(len(Tcw))
    ]) if len(Tcw) else np.zeros((0, 3))

    focus_pts = []
    if kf_ok.any():
        focus_pts.append(centers[kf_ok])
    if lm_ok.any():
        focus_pts.append(pos[lm_ok])
    if focus_pts:
        allp = np.concatenate(focus_pts)
        ctr = allp.mean(0)
        radius = max(np.percentile(np.linalg.norm(allp - ctr, axis=-1), 90),
                     1.0)
    else:
        ctr, radius = np.zeros(3), 5.0

    if view_target is None:
        view_target = ctr
    if view_eye is None:
        view_eye = ctr + np.array([0.0, -2.2 * radius, -2.2 * radius])
    R, t = _look_at(view_eye, view_target)
    f = 0.9 * min(w, h)
    cx, cy = w / 2, h / 2

    # landmarks
    if lm_ok.any():
        uv, vis = _project(pos[lm_ok], R, t, f, cx, cy)
        draw2d.draw_points(img, uv, PT_COLOR, radius=0, mask=vis)
        if local_lm_mask is not None:
            loc = draw2d.to_numpy(local_lm_mask).astype(bool)[lm_ok]
            draw2d.draw_points(img, uv, PT_LOCAL, radius=0, mask=vis & loc)

    # covisibility graph (weight >= threshold) + spanning tree
    if draw_graph and kf_ok.any():
        ii, jj = np.nonzero(np.triu(Wc, 1) >= COVIS_THRESHOLD)
        ok_e = kf_ok[ii] & kf_ok[jj]
        if ok_e.any():
            u0, v0 = _project(centers[ii[ok_e]], R, t, f, cx, cy)
            u1, v1 = _project(centers[jj[ok_e]], R, t, f, cx, cy)
            draw2d.draw_segments(img, u0, u1, GRAPH_COLOR, mask=v0 & v1)

    # keyframe frusta
    if kf_ok.any():
        fsize = 0.04 * radius
        for k in np.nonzero(kf_ok)[0]:
            Twc = np.linalg.inv(Tcw[k])
            corners = _frustum_corners(Twc, fsize)
            uv, vis = _project(corners, R, t, f, cx, cy)
            e = np.asarray(_FRUSTUM_EDGES)
            m = vis[e[:, 0]] & vis[e[:, 1]]
            draw2d.draw_segments(img, uv[e[:, 0]], uv[e[:, 1]], KF_COLOR,
                                 mask=m)

    # trajectory polyline
    if trajectory_centers is not None and len(trajectory_centers) > 1:
        tc = draw2d.to_numpy(trajectory_centers)
        uv, vis = _project(tc, R, t, f, cx, cy)
        draw2d.draw_segments(img, uv[:-1], uv[1:], TRAJ_COLOR,
                             mask=vis[:-1] & vis[1:])

    # current camera
    if current_Tcw is not None:
        Twc = np.linalg.inv(draw2d.to_numpy(current_Tcw))
        corners = _frustum_corners(Twc, 0.06 * radius)
        uv, vis = _project(corners, R, t, f, cx, cy)
        e = np.asarray(_FRUSTUM_EDGES)
        draw2d.draw_segments(img, uv[e[:, 0]], uv[e[:, 1]], CAM_COLOR,
                             mask=vis[e[:, 0]] & vis[e[:, 1]])

    n_kf = int(kf_ok.sum())
    n_lm = int(lm_ok.sum())
    draw2d.draw_text(img, f"KFS: {n_kf}  MPS: {n_lm}", 6, 6, (235, 235, 235))
    return img


@dataclass
class MapDrawer:
    """Stateful wrapper matching the reference's follow-camera mode."""

    size: tuple = (960, 720)
    follow: bool = True

    def draw(self, ms: MapState, current_Tcw=None,
             trajectory_centers=None) -> np.ndarray:
        eye = None
        if self.follow and current_Tcw is not None:
            Twc = np.linalg.inv(draw2d.to_numpy(current_Tcw))
            c = Twc[:3, 3]
            back = -Twc[:3, 2]      # behind the optical axis
            eye = c + 6.0 * back + np.array([0.0, -3.0, 0.0])
            return draw_map(ms, self.size, current_Tcw, trajectory_centers,
                            view_eye=eye, view_target=c)
        return draw_map(ms, self.size, current_Tcw, trajectory_centers)
