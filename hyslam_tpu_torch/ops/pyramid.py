"""Image preprocessing and pyramid shapes (counterpart of
``hyslam_tpu/ops/pyramid.py``).

Images are [..., H, W] float32 in [0, 255].
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear(img: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of [..., H, W] to [..., h, w], matching
    ``jax.image.resize(..., "bilinear")``: half-pixel centres, and an
    antialiasing (triangle) filter on downscale. Without ``antialias=True``
    the result differs from JAX by up to ~65 grey levels on textured
    images; with it, by ~6e-4."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.reshape(lead + tuple(hw))


def pyramid_shapes(h: int, w: int, n_levels: int = 8, scale: float = 1.2):
    """Static per-level (H, W) shapes."""
    shapes = []
    for lv in range(n_levels):
        s = scale ** lv
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """[H, W, 3] RGB (or [H, W]) -> [H, W] f32 luminance."""
    if img.dim() == 2:
        return img.to(torch.float32)
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32,
                     device=img.device)
    return torch.einsum("hwc,c->hw", img.to(torch.float32), w)


def preprocess_image(img: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """Grayscale conversion + optional pre-scaling
    (ImageProcessing::PreProcessImg)."""
    gray = to_grayscale(img)
    if scale != 1.0:
        h, w = gray.shape
        gray = resize_bilinear(
            gray, (max(int(round(h * scale)), 1), max(int(round(w * scale)), 1)))
    return gray
