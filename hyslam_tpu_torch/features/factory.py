"""Feature factory: the feature family selected from the config
(counterpart of ``hyslam_tpu/features/factory.py``).

One config-keyed object hands out the family's extractor, descriptor
distance and matching thresholds, so the rest of the system is
family-agnostic. "ORB" (FAST + grid top-k + steered BRIEF-256 over the atlas
canvas, Hamming distance, TH_HIGH 100 / TH_LOW 50) is ported; the "SURF"
family (``ops/hessian.py``) is ROADMAP step 18 and raises.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from hyslam_tpu_torch.features.atlas import extract_atlas, extract_atlas_batch
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.ops.hamming import hamming_matrix


class FeatureFamily(NamedTuple):
    """What the factory hands out."""

    name: str
    extract: Callable          # (img [H,W] f32, capacity) -> FrameFeatures
    distance_matrix: Callable  # ([Q,8] int32, [F,8] int32) -> [Q,F]
    th_high: float             # first-pass match acceptance (TH_HIGH)
    th_low: float              # strict acceptance (TH_LOW)
    extract_batch: Callable = None  # (imgs [B,H,W], capacity) -> batched
                               # FrameFeatures, one pass for a stereo pair


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
        raise NotImplementedError(
            "the SURF feature family (ops/hessian.py) is ROADMAP step 18, not ported")
    raise ValueError(f"unknown feature family {name!r} (ORB | SURF)")
