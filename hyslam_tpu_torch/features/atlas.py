"""Atlas extractor: the full ORB pipeline with the pyramid levels packed side
by side into ONE canvas, so every dense stage runs once (counterpart of
``hyslam_tpu/features/atlas.py``).

The batch axis is written out: ``extract_atlas_batch`` runs both images of
a stereo pair through each stage together, and ``extract_atlas`` is the
batch of one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.features.extractor import ExtractorConfig, level_budgets
from hyslam_tpu_torch.ops.fast import fast_scores, nms3x3
from hyslam_tpu_torch.ops.orb import orient_and_describe
from hyslam_tpu_torch.ops.pyramid import pyramid_shapes, resize_bilinear


class AtlasLayout(NamedTuple):
    shapes: tuple            # ((Hl, Wl), ...)
    x_off: tuple             # canvas x offset per level
    canvas_hw: tuple         # (H0, Wc)


def atlas_layout(h: int, w: int, cfg: ExtractorConfig) -> AtlasLayout:
    shapes = tuple(pyramid_shapes(h, w, cfg.n_levels, cfg.scale_factor))
    x_off = []
    x = 0
    for (hl, wl) in shapes:
        x_off.append(x)
        x += wl
    return AtlasLayout(shapes=shapes, x_off=tuple(x_off), canvas_hw=(h, x))


def _build_canvas(img: torch.Tensor, layout: AtlasLayout, cfg: ExtractorConfig):
    """[..., H, W] -> [..., H0, Wc] canvas with all levels placed left to
    right, each level resized from the one before and zero-padded below."""
    H0, _ = layout.canvas_hw
    parts = []
    cur = img
    for lv, (hl, wl) in enumerate(layout.shapes):
        if lv > 0:
            cur = resize_bilinear(cur, (hl, wl))
        parts.append(F.pad(cur, (0, 0, 0, H0 - hl)))
    return torch.cat(parts, dim=-1)


def _top_k(x: torch.Tensor, k: int):
    """Top k along the last axis with ties broken toward the lower index,
    as ``lax.top_k`` breaks them (``torch.topk`` promises no tie order,
    and most NMS scores are tied at 0)."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def _select_level(
    score_slice: torch.Tensor, hl: int, wl: int, n_kp: int, cell: int,
    border: int,
):
    """Grid top-k inside one level region of the canvas score map
    ([B, H0, wl] slice; rows >= hl are zero). Returns (uv [B, n_kp, 2] in
    level coords, valid [B, n_kp])."""
    B, H0, _ = score_slice.shape
    dev = score_slice.device
    yy = torch.arange(H0, device=dev)[:, None]
    xx = torch.arange(wl, device=dev)[None, :]
    ok = (yy >= border) & (yy < hl - border) & (xx >= border) & (xx < wl - border)
    s = torch.where(ok, score_slice, 0.0)
    ncy = (hl + cell - 1) // cell
    ncx = (wl + cell - 1) // cell
    ph, pw = ncy * cell, ncx * cell
    sp = F.pad(s[:, :min(H0, ph)], (0, pw - wl, 0, max(0, ph - H0)))[:, :ph]
    tiles = sp.reshape(B, ncy, cell, ncx, cell).permute(0, 1, 3, 2, 4).reshape(
        B, ncy * ncx, cell * cell
    )
    quota = max(1, min(cell * cell, -(-n_kp // (ncy * ncx)) + 2))
    top_s, top_i = _top_k(tiles, quota)                       # [B, C, q]
    cidx = torch.arange(ncy * ncx, device=dev)
    py = (cidx // ncx)[:, None] * cell + top_i // cell
    px = (cidx % ncx)[:, None] * cell + top_i % cell
    pool_s = top_s.reshape(B, -1)
    n_take = min(n_kp, pool_s.shape[-1])
    best_s, best_i = _top_k(pool_s, n_take)
    uv = torch.stack(
        [torch.gather(px.reshape(B, -1), 1, best_i).to(torch.float32),
         torch.gather(py.reshape(B, -1), 1, best_i).to(torch.float32)], -1,
    )
    valid = best_s > 0
    pad = n_kp - n_take
    if pad > 0:
        uv = F.pad(uv, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, valid


def extract_atlas_batch(imgs: torch.Tensor, cfg: ExtractorConfig,
                        capacity: int) -> FrameFeatures:
    """Batched extraction: [B, H, W] -> FrameFeatures with a leading batch
    axis, every field padded to ``capacity`` features."""
    B, h, w = imgs.shape
    dev = imgs.device
    layout = atlas_layout(h, w, cfg)
    budgets = level_budgets(cfg)
    canvas = _build_canvas(imgs, layout, cfg)

    score = nms3x3(fast_scores(canvas, cfg.fast_threshold))

    uvs_canvas, uvs_lv0, levels, valids = [], [], [], []
    for lv, ((hl, wl), xo, n_lv) in enumerate(
            zip(layout.shapes, layout.x_off, budgets)):
        if n_lv <= 0:
            continue
        border = max(4, int(round(cfg.border / cfg.scale_factor ** lv)),
                     17)  # patches must stay inside the level region
        uv_loc, valid = _select_level(
            score[..., xo:xo + wl], hl, wl, n_lv, cfg.cell_size, border,
        )
        uvs_canvas.append(uv_loc + torch.tensor([float(xo), 0.0], device=dev))
        uvs_lv0.append(uv_loc * (cfg.scale_factor ** lv))
        levels.append(torch.full((B, n_lv), lv, dtype=torch.int32, device=dev))
        valids.append(valid)

    uv_canvas = torch.cat(uvs_canvas, dim=1)
    uv0 = torch.cat(uvs_lv0, dim=1)
    level = torch.cat(levels, dim=1)
    valid = torch.cat(valids, dim=1)

    # orientation + descriptors in ONE batch over all levels, in canvas coords
    ang, desc = orient_and_describe(canvas, uv_canvas)

    n = uv0.shape[1]
    pad = capacity - n
    if pad < 0:
        raise ValueError(f"capacity {capacity} < total budget {n}")
    return FrameFeatures(
        uv=F.pad(uv0, (0, 0, 0, pad)),
        ur=torch.full((B, capacity), -1.0, dtype=torch.float32, device=dev),
        depth=torch.full((B, capacity), -1.0, dtype=torch.float32, device=dev),
        level=F.pad(level, (0, pad)),
        angle=F.pad(ang, (0, pad)),
        desc=F.pad(desc, (0, 0, 0, pad)),
        valid=F.pad(valid, (0, pad)),
    )


def extract_atlas(img: torch.Tensor, cfg: ExtractorConfig, capacity: int
                  ) -> FrameFeatures:
    """Single-image extraction: [H, W] -> FrameFeatures."""
    feats = extract_atlas_batch(img[None], cfg, capacity)
    return FrameFeatures(*(x[0] for x in feats))
