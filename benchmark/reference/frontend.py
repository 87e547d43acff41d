"""Plain reference of the stereo front end: ORB extraction over the packed
pyramid canvas (FAST-9/16 scores, 3x3 non-max suppression, grid top k per
level, intensity-centroid orientation, steered BRIEF on the 7-tap blurred
patch) and rectified stereo matching with SAD sub-pixel refinement.

A frozen copy of the port's plain PyTorch front end as the benchmark was
defined, written out in one file so that it imports nothing of the program.
The benchmark holds the program's features against it on sampled frames.
The image arithmetic (pyramid, FAST excess sums, moments, blur, SAD) runs
in ``work``: float64 for the reference, bfloat16 for the correctness
control; coordinates stay float32.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Features(NamedTuple):
    uv: torch.Tensor      # [..., F, 2] f32 level-0 pixel coordinates
    ur: torch.Tensor      # [..., F] f32 right-image u, -1 where unmatched
    depth: torch.Tensor   # [..., F] f32, -1 where unmatched
    level: torch.Tensor   # [..., F] int32
    angle: torch.Tensor   # [..., F] f32
    desc: torch.Tensor    # [..., F, 8] int32 bit-view of 256 bits
    valid: torch.Tensor   # [..., F] bool


# --------------------------------------------------------------- pyramid

def level_budgets(n_features: int, n_levels: int, scale_factor: float) -> list[int]:
    inv = 1.0 / scale_factor
    raw = np.array([inv**i for i in range(n_levels)])
    n = np.floor(raw / raw.sum() * n_features).astype(int)
    n[0] += n_features - n.sum()
    return [int(x) for x in n]


def resize_bilinear(img: torch.Tensor, hw) -> torch.Tensor:
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    if x.dtype not in (torch.float32, torch.float64):     # no 16-bit kernel everywhere:
        x = x.to(torch.float32)                           # the result is rounded back
    y = F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                      antialias=True)
    return y.to(img.dtype).reshape(lead + tuple(hw))


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    return [(max(int(round(h / scale**lv)), 16), max(int(round(w / scale**lv)), 16))
            for lv in range(n_levels)]


# ------------------------------------------------------------------ FAST

CIRCLE = np.array(
    [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
     (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1)],
    dtype=np.int32)
ARC_LEN = 9


def _has_run(m: torch.Tensor) -> torch.Tensor:
    x = m | (m << 16)
    y = x
    for i in range(1, ARC_LEN):
        y = y & (x >> i)
    return y != 0


def fast_scores(img: torch.Tensor, threshold: float) -> torch.Tensor:
    c = img
    excess_b = torch.zeros_like(img)
    excess_d = torch.zeros_like(img)
    m_b = torch.zeros(img.shape, dtype=torch.int64, device=img.device)
    m_d = torch.zeros_like(m_b)
    for i, (dy, dx) in enumerate(CIRCLE):
        p = torch.roll(img, shifts=(-int(dy), -int(dx)), dims=(-2, -1))
        db = p - c - threshold
        dd = c - p - threshold
        m_b = m_b | ((db > 0).to(torch.int64) << i)
        m_d = m_d | ((dd > 0).to(torch.int64) << i)
        excess_b = excess_b + torch.clamp_min(db, 0.0)
        excess_d = excess_d + torch.clamp_min(dd, 0.0)
    score = torch.maximum(torch.where(_has_run(m_b), excess_b, 0.0),
                          torch.where(_has_run(m_d), excess_d, 0.0))
    h, w = img.shape[-2:]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(interior, score, 0.0)


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    s = score.reshape((-1, 1) + tuple(score.shape[-2:]))
    m = F.max_pool2d(s, kernel_size=3, stride=1, padding=1).reshape(score.shape)
    return torch.where(score >= m, score, 0.0)


def top_k(x: torch.Tensor, k: int):
    """The k largest along the last axis, ties toward the lower index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


# --------------------------------------------------------------- hamming

def unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[..., :, None] >> shifts) & 1
    return bits.reshape(desc.shape[:-1] + (256,)).to(torch.float32)


def popcount(desc: torch.Tensor) -> torch.Tensor:
    x = desc.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum(dim=-1).to(torch.int32)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    dot = unpack_bits(a) @ unpack_bits(b).transpose(-1, -2)
    return popcount(a)[:, None] + popcount(b)[None, :] - 2 * dot.to(torch.int32)


# ------------------------------------------------------------------- ORB

PATCH_RADIUS = 15
_PATTERN_CLIP = 13
PATCH = 48
PATCH_C = PATCH // 2
N_ROT_BINS = 30


def _tables():
    """The BRIEF pattern, its rotated sample positions in the 48x48 window
    and the moment weights over the radius-15 disc."""
    rng = np.random.default_rng(7)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pattern = np.clip(np.round(rng.normal(0.0, sigma, size=(256, 2, 2))),
                      -_PATTERN_CLIP, _PATTERN_CLIP).astype(np.int32)
    pat = pattern.astype(np.float64)
    a = 2.0 * np.pi * np.arange(N_ROT_BINS)[:, None, None] / N_ROT_BINS
    ca, sa = np.cos(a), np.sin(a)
    rx = np.clip(np.round(ca * pat[..., 0] - sa * pat[..., 1]),
                 -_PATTERN_CLIP - 6, _PATTERN_CLIP + 6).astype(np.int64)
    ry = np.clip(np.round(sa * pat[..., 0] + ca * pat[..., 1]),
                 -_PATTERN_CLIP - 6, _PATTERN_CLIP + 6).astype(np.int64)
    lin = (PATCH_C + ry) * PATCH + (PATCH_C + rx)
    dy, dx = np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1, -PATCH_RADIUS:PATCH_RADIUS + 1]
    mask = ((dy * dy + dx * dx) <= PATCH_RADIUS * PATCH_RADIUS).reshape(-1)
    dy, dx = dy.reshape(-1), dx.reshape(-1)
    w48 = np.zeros((PATCH * PATCH, 2), np.float32)
    lin48 = (PATCH_C + dy) * PATCH + (PATCH_C + dx)
    np.add.at(w48, (lin48, 0), np.where(mask, dx, 0))
    np.add.at(w48, (lin48, 1), np.where(mask, dy, 0))
    return lin[..., 1], lin[..., 0], w48


def _blur_taps(ksize=7, sigma=2.0):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def orient_and_describe(img: torch.Tensor, uv: torch.Tensor):
    """Angles [B, N] and descriptors [B, N, 8] of keypoints uv [B, N, 2] on
    images [B, H, W]."""
    sel_plus, sel_minus, w48 = _tables()
    B, H, W = img.shape
    N = uv.shape[1]
    dev = img.device
    padded = F.pad(img[:, None], (PATCH_C,) * 4, mode="replicate")[:, 0]
    Wp = W + 2 * PATCH_C
    y0 = torch.round(uv[..., 1]).to(torch.int64).clamp(0, H - 1)
    x0 = torch.round(uv[..., 0]).to(torch.int64).clamp(0, W - 1)
    ar = torch.arange(PATCH, device=dev)
    lin = ((y0[..., None] + ar)[..., :, None] * Wp + (x0[..., None] + ar)[..., None, :])
    patches = torch.gather(padded.reshape(B, -1), 1,
                           lin.reshape(B, -1)).reshape(B, N, PATCH, PATCH)
    flat_raw = patches.reshape(B, N, PATCH * PATCH)
    W48 = torch.as_tensor(w48, device=dev, dtype=img.dtype)
    m = torch.stack([f @ W48 for f in flat_raw])      # one image at a time
    ang = torch.atan2(m[..., 1], m[..., 0])
    taps = _blur_taps()
    pb = torch.zeros_like(patches)
    for i, t in enumerate(taps):
        pb = pb + float(t) * torch.roll(patches, 3 - i, dims=-2)
    pb2 = torch.zeros_like(pb)
    for i, t in enumerate(taps):
        pb2 = pb2 + float(t) * torch.roll(pb, 3 - i, dims=-1)
    flat_b = pb2.reshape(B, N, PATCH * PATCH)
    flat_b = flat_b - torch.stack([f.mean(dim=-1, keepdim=True) for f in flat_b])
    flat_b = flat_b.to(torch.bfloat16).to(torch.float32)
    two_pi = 2.0 * np.pi
    bins = torch.round(torch.remainder(ang, two_pi) / (two_pi / N_ROT_BINS))
    bins = torch.remainder(bins.to(torch.int64), N_ROT_BINS)
    plus = torch.as_tensor(sel_plus, device=dev)[bins]
    minus = torch.as_tensor(sel_minus, device=dev)[bins]
    diff = torch.gather(flat_b, -1, plus) - torch.gather(flat_b, -1, minus)
    return ang, pack_bits(diff > 0.0)


# ------------------------------------------------------------ extraction

def _select_level(score_slice, hl, wl, n_kp, cell, border):
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
        B, ncy * ncx, cell * cell)
    quota = max(1, min(cell * cell, -(-n_kp // (ncy * ncx)) + 2))
    top_s, top_i = top_k(tiles, quota)
    cidx = torch.arange(ncy * ncx, device=dev)
    py = (cidx // ncx)[:, None] * cell + top_i // cell
    px = (cidx % ncx)[:, None] * cell + top_i % cell
    pool_s = top_s.reshape(B, -1)
    n_take = min(n_kp, pool_s.shape[-1])
    best_s, best_i = top_k(pool_s, n_take)
    uv = torch.stack([torch.gather(px.reshape(B, -1), 1, best_i).to(torch.float32),
                      torch.gather(py.reshape(B, -1), 1, best_i).to(torch.float32)], -1)
    valid = best_s > 0
    pad = n_kp - n_take
    if pad > 0:
        uv = F.pad(uv, (0, 0, 0, pad))
        valid = F.pad(valid, (0, pad))
    return uv, valid


def extract(imgs: torch.Tensor, ex: dict, capacity: int) -> Features:
    """ORB features of images [B, H, W] (grey levels in the working dtype), padded to
    ``capacity``; ``ex`` holds n_features, n_levels, scale_factor,
    fast_threshold, cell_size and border."""
    B, h, w = imgs.shape
    dev = imgs.device
    sf = ex["scale_factor"]
    shapes = pyramid_shapes(h, w, ex["n_levels"], sf)
    x_off, x = [], 0
    for _, wl in shapes:
        x_off.append(x)
        x += wl
    parts, cur = [], imgs
    for lv, (hl, wl) in enumerate(shapes):
        if lv > 0:
            cur = resize_bilinear(cur, (hl, wl))
        parts.append(F.pad(cur, (0, 0, 0, h - hl)))
    canvas = torch.cat(parts, dim=-1)
    score = nms3x3(fast_scores(canvas, ex["fast_threshold"]))
    budgets = level_budgets(ex["n_features"], ex["n_levels"], sf)
    uvs_c, uvs_0, levels, valids = [], [], [], []
    for lv, ((hl, wl), xo, n_lv) in enumerate(zip(shapes, x_off, budgets)):
        if n_lv <= 0:
            continue
        border = max(4, int(round(ex["border"] / sf ** lv)), 17)
        uv_loc, valid = _select_level(score[..., xo:xo + wl], hl, wl, n_lv,
                                      ex["cell_size"], border)
        uvs_c.append(uv_loc + torch.tensor([float(xo), 0.0], device=dev))
        uvs_0.append(uv_loc * (sf ** lv))
        levels.append(torch.full((B, n_lv), lv, dtype=torch.int32, device=dev))
        valids.append(valid)
    uv_c = torch.cat(uvs_c, dim=1)
    uv0 = torch.cat(uvs_0, dim=1)
    ang, desc = orient_and_describe(canvas, uv_c)
    pad = capacity - uv0.shape[1]
    if pad < 0:
        raise ValueError(f"capacity {capacity} < total budget {uv0.shape[1]}")
    return Features(
        uv=F.pad(uv0, (0, 0, 0, pad)),
        ur=torch.full((B, capacity), -1.0, dtype=torch.float32, device=dev),
        depth=torch.full((B, capacity), -1.0, dtype=torch.float32, device=dev),
        level=F.pad(torch.cat(levels, dim=1), (0, pad)),
        angle=F.pad(ang, (0, pad)),
        desc=F.pad(desc, (0, 0, 0, pad)),
        valid=F.pad(torch.cat(valids, dim=1), (0, pad)))


# ---------------------------------------------------------------- stereo

TH_HIGH = 100
_SAD_R = 5
_SEARCH = 4


def match_stereo(left: Features, right: Features, bf: float, min_z: float = 0.1,
                 max_disp_slack: float = 2.0) -> Features:
    d = hamming_matrix(left.desc, right.desc)
    scale_l = 1.2 ** left.level.to(torch.float32)
    row_tol = max_disp_slack * scale_l[:, None]
    dv = torch.abs(left.uv[:, 1:2] - right.uv[None, :, 1])
    disp = left.uv[:, 0:1] - right.uv[None, :, 0]
    lvl_ok = torch.abs(left.level[:, None] - right.level[None, :]) <= 1
    ok = ((dv <= row_tol) & (disp >= 0.3) & (disp <= bf / min_z) & lvl_ok
          & left.valid[:, None] & right.valid[None, :])
    d = torch.where(ok, d, 1 << 16)
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    matched = best_d <= TH_HIGH
    ur = torch.where(matched, right.uv[best, 0], -1.0)
    disp_best = torch.clamp_min(left.uv[:, 0] - ur, 1e-3)
    depth = torch.where(matched, bf / disp_best, -1.0)
    return left._replace(ur=torch.where(matched, ur, -1.0), depth=depth)


def _windows(img, y, x, h, w):
    W_ = img.shape[1]
    lin = ((y[:, None] + torch.arange(h, device=img.device))[:, :, None] * W_
           + (x[:, None] + torch.arange(w, device=img.device))[:, None, :])
    return img.reshape(-1)[lin]


def refine_subpixel(m: Features, img_l, img_r, bf: float) -> Features:
    uv, ur0 = m.uv, m.ur
    ok = m.valid & (ur0 > 0)
    x0 = torch.round(uv[:, 0]).to(torch.int64)
    y0 = torch.round(uv[:, 1]).to(torch.int64)
    xr0 = torch.round(ur0).to(torch.int64)
    h, W_ = img_l.shape
    side = 2 * _SAD_R + 1
    wide = side + 2 * _SEARCH
    il_p = F.pad(img_l[None, None], (_SAD_R, _SAD_R, _SAD_R, _SAD_R), mode="replicate")[0, 0]
    pr = _SAD_R + _SEARCH
    ir_p = F.pad(img_r[None, None], (pr, pr, _SAD_R, _SAD_R), mode="replicate")[0, 0]
    yc = y0.clamp(0, h - 1)
    patch_l = _windows(il_p, yc, x0.clamp(0, W_ - 1), side, side)
    win_r = _windows(ir_p, yc, xr0.clamp(0, W_ - 1), side, wide)
    patch_l = patch_l - patch_l[:, _SAD_R:_SAD_R + 1, _SAD_R:_SAD_R + 1]
    n_sh = 2 * _SEARCH + 1
    patch_r = torch.stack([win_r[:, :, s:s + side] for s in range(n_sh)], dim=1)
    patch_r = patch_r - patch_r[:, :, _SAD_R:_SAD_R + 1, _SAD_R:_SAD_R + 1]
    sad = torch.sum(torch.abs(patch_r - patch_l[:, None]), dim=(-1, -2))
    bi = torch.argmin(sad, dim=-1)
    bic = bi.clamp(1, sad.shape[1] - 2)
    c0 = torch.gather(sad, 1, bic[:, None] - 1)[:, 0]
    c1 = torch.gather(sad, 1, bic[:, None])[:, 0]
    c2 = torch.gather(sad, 1, bic[:, None] + 1)[:, 0]
    denom = torch.clamp_min(c0 + c2 - 2.0 * c1, 1e-6)
    delta = torch.clamp(0.5 * (c0 - c2) / denom, -1.0, 1.0)
    ur_ref = xr0.to(torch.float32) + (bic - _SEARCH).to(torch.float32) + delta.to(torch.float32)
    ur_ref = ur_ref + (uv[:, 0] - x0.to(torch.float32))
    disp = torch.clamp_min(uv[:, 0] - ur_ref, 1e-3)
    good = ok & (disp > 0.2)
    depth = torch.where(good, bf / disp, -1.0)
    return m._replace(ur=torch.where(good, ur_ref, -1.0), depth=depth)


def stereo_frame(pair: torch.Tensor, ex: dict, capacity: int, bf: float,
                 work: torch.dtype = torch.float64):
    """A rectified stereo pair [2, H, W] (any dtype of grey levels) ->
    (left features with ur and depth, right features), the image
    arithmetic in ``work``."""
    imgs = pair.to(work)
    both = extract(imgs, ex, capacity)
    left = Features(*(x[0] for x in both))
    right = Features(*(x[1] for x in both))
    left = refine_subpixel(match_stereo(left, right, bf), imgs[0], imgs[1], bf)
    return left, right
