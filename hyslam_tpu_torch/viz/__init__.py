"""Headless visualization layer (capability parity with src/viz:
Viewer.h, FrameDrawer.h, MapDrawer.h; counterpart of ``hyslam_tpu/viz``).

The reference renders into a Pangolin/OpenGL window from a dedicated
thread; a headless host has no window, so this package renders the same
artifacts — annotated current-frame images and a 3D map view (points,
keyframe frusta, covisibility graph, trajectory, current camera) — into
numpy RGB images written as PNG, either on demand or fps-paced from the
Viewer loop. Tensors given to it, on any device, are read to the host.
"""

from hyslam_tpu_torch.viz.frame_drawer import FrameDrawer, draw_frame
from hyslam_tpu_torch.viz.map_drawer import MapDrawer, draw_map
from hyslam_tpu_torch.viz.viewer import Viewer
from hyslam_tpu_torch.viz.draw2d import write_png

__all__ = [
    "FrameDrawer", "draw_frame", "MapDrawer", "draw_map", "Viewer",
    "write_png",
]
