"""Multi-camera data-parallel front end: the camera (or frame) batch axis of
feature extraction sharded over the ranks of a mesh (counterpart of
``hyslam_tpu/parallel/multicam.py``).

The reference extracts a rig's images on threads, two for a stereo pair
and one trio a camera (ImageProcessing.cpp:28-37, 82-84). A rig's frames
stack into [C, H, W]; rank r extracts its C/n cameras on its own device
with ``features/atlas.extract_atlas_batch``, with no collective (the work
is independent until matching). The same entry serves frame-batched
offline mapping: a sequence chunk of C frames.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.features.atlas import extract_atlas_batch
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.parallel.mesh import Mesh, gather_blocks


def extract_cameras_sharded(imgs: torch.Tensor, cfg: ExtractorConfig, capacity: int,
                            mesh: Mesh, axis: str = "lm", gather: bool = False):
    """Features of [C, H, W] images with the camera axis sharded over
    ``mesh[axis]``; every rank passes the whole batch (on any device) and
    extracts its C/n cameras on its own. C must be divisible by the axis
    size. Returns (this rank's FrameFeatures with a leading [C/n] axis, the
    index of its first camera). With ``gather=True`` (for tests and checks:
    downstream tracking consumes its own shard) returns the whole [C]
    FrameFeatures on every rank instead."""
    n = mesh.shape[axis]
    C = imgs.shape[0]
    if C % n:
        raise ValueError(f"camera batch {C} not divisible by the {axis!r} axis ({n})")
    Cs = C // n
    off = mesh.index(axis) * Cs
    feats = extract_atlas_batch(imgs[off:off + Cs].to(mesh.device), cfg, capacity)
    if not gather:
        return feats, off
    return FrameFeatures(*(gather_blocks(f, off, C, mesh, axis) for f in feats))
