"""Viewer: fps-paced rendering loop writing frame/map images to disk
(src/viz/Viewer.{h,cc} parity; counterpart of ``hyslam_tpu/viz/viewer.py``
— the reference runs a Pangolin window thread redrawn at a configured fps,
Viewer.h:22-60; a headless host writes PNG snapshots instead).

Also covers the reference's periodic feature-image debug dump
(ImageProcessing.cpp:87-98 writes an annotated image every 20 frames).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field

import numpy as np
import torch

from hyslam_tpu_torch.viz import draw2d
from hyslam_tpu_torch.viz.draw2d import write_png
from hyslam_tpu_torch.viz.frame_drawer import FrameDrawer
from hyslam_tpu_torch.viz.map_drawer import MapDrawer

DEBUG_DUMP_EVERY = 20   # ImageProcessing.cpp:87 cadence


@dataclass
class Viewer:
    """Renders the latest tracked frame + map view.

    Synchronous use: call update(...) per frame, snapshot(...) on demand.
    Threaded use (reference behavior): start() spawns a loop that writes
    PNGs at `fps` until stop().
    """

    out_dir: str = "./viz_out"
    fps: float = 2.0
    frame_drawer: FrameDrawer = field(default_factory=FrameDrawer)
    map_drawer: MapDrawer = field(default_factory=MapDrawer)
    dump_every: int = DEBUG_DUMP_EVERY

    def __post_init__(self):
        self._ms = None
        self._Tcw = None
        self._traj_centers = None
        self._n = 0
        self._thread = None
        self._stop = threading.Event()
        os.makedirs(self.out_dir, exist_ok=True)

    # ------------------------------------------------------------- updates

    def update(self, ms, current_Tcw=None, trajectory_centers=None,
               img=None, uv=None, feat_valid=None, lm_id=None,
               state: str = "", dump_debug: bool = True) -> None:
        """Called from the tracking loop after each frame (FrameDrawer::
        Update analog). Optionally auto-dumps an annotated feature image
        every `dump_every` frames."""
        self._ms = ms
        self._Tcw = current_Tcw
        self._traj_centers = trajectory_centers
        if img is not None and uv is not None:
            n_kf, n_lm = (torch.stack([ms.kf.valid.sum(), ms.lm.valid.sum()]).tolist()
                          if ms is not None else (0, 0))
            self.frame_drawer.update(
                img, uv,
                feat_valid if feat_valid is not None
                else np.ones(len(draw2d.to_numpy(uv)), bool),
                lm_id if lm_id is not None
                else np.full(len(draw2d.to_numpy(uv)), -1),
                state, n_kf, n_lm,
            )
            if dump_debug and self.dump_every and \
                    self._n % self.dump_every == 0:
                f = self.frame_drawer.draw()
                if f is not None:
                    write_png(os.path.join(
                        self.out_dir, f"features_{self._n:06d}.png"), f)
        self._n += 1

    # ------------------------------------------------------------ rendering

    def snapshot(self, prefix: str = "snapshot") -> list[str]:
        """Render current frame + map to PNGs; returns written paths."""
        paths = []
        f = self.frame_drawer.draw()
        if f is not None:
            p = os.path.join(self.out_dir, f"{prefix}_frame.png")
            write_png(p, f)
            paths.append(p)
        if self._ms is not None:
            m = self.map_drawer.draw(self._ms, self._Tcw, self._traj_centers)
            p = os.path.join(self.out_dir, f"{prefix}_map.png")
            write_png(p, m)
            paths.append(p)
        return paths

    # ------------------------------------------------------------- threaded

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            i = 0
            while not self._stop.is_set():
                self.snapshot(prefix=f"view_{i:05d}")
                i += 1
                self._stop.wait(1.0 / max(self.fps, 1e-3))

        self._thread = threading.Thread(target=loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
