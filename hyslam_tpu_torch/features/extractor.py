"""Extractor settings (counterpart of ``hyslam_tpu/features/extractor.py``;
only the config and the per-level budget are ported: the production path is
the atlas extractor in ``features/atlas.py``)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class ExtractorConfig(NamedTuple):
    """Mirrors FeatureExtractorSettings (1000 features, 8 levels, x1.2,
    FAST min threshold 7, 32-px cells, EDGE_THRESHOLD 19)."""

    n_features: int = 1000
    n_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 7.0   # min threshold; strong corners rank higher
    cell_size: int = 32
    border: int = 19              # EDGE_THRESHOLD in the reference
    family: str = "ORB"           # "ORB" or "SURF" (features/factory.py)


def level_budgets(cfg: ExtractorConfig) -> list[int]:
    """Features per level, proportional to (1/scale)^level (reference ctor)."""
    inv = 1.0 / cfg.scale_factor
    raw = np.array([inv**i for i in range(cfg.n_levels)])
    n = np.floor(raw / raw.sum() * cfg.n_features).astype(int)
    n[0] += cfg.n_features - n.sum()
    return [int(x) for x in n]
