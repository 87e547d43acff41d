"""Feature factory: the feature family selected from the config
(counterpart of ``hyslam_tpu/features/factory.py``).

One config-keyed object hands out the family's extractor, descriptor
distance and matching thresholds, so the rest of the system is
family-agnostic. "ORB": FAST + grid top-k + steered BRIEF-256 over the atlas
canvas. "SURF" (or "HESSIAN"): box-filter determinant-of-Hessian detection
and binary Haar descriptors (``ops/hessian.py``) in the same 256-bit format,
scale from the four first-octave filter sizes instead of a pyramid. Both
match by Hamming distance with TH_HIGH 100 / TH_LOW 50.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.features.atlas import extract_atlas, extract_atlas_batch
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.ops.fast import nms3x3, select_keypoints
from hyslam_tpu_torch.ops.hamming import hamming_matrix
from hyslam_tpu_torch.ops.hessian import (
    FILTER_SIZES, _col_prefix, _descriptors_from_prefix, _doh_from_prefix)


class FeatureFamily(NamedTuple):
    """What the factory hands out."""

    name: str
    extract: Callable          # (img [H,W] f32, capacity) -> FrameFeatures
    distance_matrix: Callable  # ([Q,8] int32, [F,8] int32) -> [Q,F]
    th_high: float             # first-pass match acceptance (TH_HIGH)
    th_low: float              # strict acceptance (TH_LOW)
    extract_batch: Callable = None  # (imgs [B,H,W], capacity) -> batched
                               # FrameFeatures, one pass for a stereo pair


def extract_hessian(img: torch.Tensor, cfg: ExtractorConfig,
                    capacity: int) -> FrameFeatures:
    """SURF-family extraction from img [..., H, W] (a leading batch axis
    extracts a stereo pair in one pass): the determinant-of-Hessian map at
    each filter size, 3x3 NMS and grid top-k selection of that size's share
    of the budget (the remainder to the first), binary Haar descriptors at
    the size's scale. Single resolution: the box filters scale instead of
    the image. Features are upright (angle 0), ``level`` is the filter-size
    index; padded to ``capacity``."""
    n_scales = len(FILTER_SIZES)
    budgets = [cfg.n_features // n_scales] * n_scales
    budgets[0] += cfg.n_features - sum(budgets)
    if sum(budgets) > capacity:
        raise ValueError(f"capacity {capacity} < budget {sum(budgets)}")
    cy = _col_prefix(img)          # shared by every box filter of the image
    lead = tuple(img.shape[:-2])
    dev = img.device
    uvs, levels, descs, valids = [], [], [], []
    for si, (L, n_s) in enumerate(zip(FILTER_SIZES, budgets)):
        if n_s <= 0:
            continue
        score = nms3x3(torch.clamp_min(_doh_from_prefix(cy, L), 0.0))
        uv, _, valid = select_keypoints(score, n_s, cell=cfg.cell_size,
                                        border=max(L, cfg.border))
        uvs.append(uv)
        levels.append(torch.full(lead + (n_s,), si, dtype=torch.int32, device=dev))
        descs.append(_descriptors_from_prefix(cy, uv, L / 9.0))
        valids.append(valid)
    n = sum(budgets)
    pad = capacity - n

    def padded(x, fill=0):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - len(lead) - 1) + (0, pad),
                                       value=fill)

    return FrameFeatures(
        uv=padded(torch.cat(uvs, dim=-2)),
        ur=torch.full(lead + (capacity,), -1.0, dtype=torch.float32, device=dev),
        depth=torch.full(lead + (capacity,), -1.0, dtype=torch.float32, device=dev),
        level=padded(torch.cat(levels, dim=-1)),
        angle=torch.zeros(lead + (capacity,), dtype=torch.float32, device=dev),
        desc=padded(torch.cat(descs, dim=-2)),
        valid=padded(torch.cat(valids, dim=-1), False),
    )


def make_family(cfg: ExtractorConfig) -> FeatureFamily:
    """Resolve the configured feature family."""
    name = getattr(cfg, "family", "ORB").upper()
    if name == "ORB":
        return FeatureFamily(
            name="ORB",
            extract=lambda img, capacity: extract_atlas(img, cfg, capacity),
            extract_batch=lambda imgs, capacity: extract_atlas_batch(
                imgs, cfg, capacity),
            distance_matrix=hamming_matrix,
            th_high=100.0, th_low=50.0,
        )
    if name in ("SURF", "HESSIAN"):
        return FeatureFamily(
            name="SURF",
            extract=lambda img, capacity: extract_hessian(img, cfg, capacity),
            extract_batch=lambda imgs, capacity: extract_hessian(imgs, cfg, capacity),
            distance_matrix=hamming_matrix,
            th_high=100.0, th_low=50.0,
        )
    raise ValueError(f"unknown feature family {name!r} (ORB | SURF)")
