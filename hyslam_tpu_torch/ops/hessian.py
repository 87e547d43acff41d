"""SURF-family feature ops: box-filter determinant-of-Hessian detection and
binary Haar-response descriptors (counterpart of
``hyslam_tpu/ops/hessian.py``).

Box sums are prefix-sum differences, dense over the image at the four
first-octave filter sizes (9, 15, 21, 27). The descriptor binarizes an 8x8
grid of upright Haar responses into the 256-bit format of ORB, so the rest
of the system (Hamming matcher, arenas, BoW) is family-agnostic.

Every function takes [..., H, W] images (a leading batch axis for a stereo
pair). The prefix sums are float32 in the JAX package's order of additions
(``_prefix_sum``), so the responses, and so the keypoints, are the same
bits on the CPU, on the card and in the JAX package.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from hyslam_tpu_torch.ops.hamming import pack_bits

FILTER_SIZES = (9, 15, 21, 27)   # SURF first-octave box-filter sizes
_SCAN_BASE = 16


def _prefix_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sum along ``dim``, adding in the order of
    ``jnp.cumsum`` on XLA's CPU backend: a reduce-window that XLA tiles by
    16 (a sequential sum inside each tile of 16, the tiles' totals summed
    the same way, recursively, then added back). ``torch.cumsum`` adds in
    float64 on the CPU and in a parallel scan on the card, which differ
    from it in the last bits, and a box filter's difference of two large
    prefix sums shows those bits."""
    x = x.movedim(dim, 0)
    out = _tiled_scan(x)
    return out.movedim(0, dim)


def _sequential(x: torch.Tensor, exclusive: bool = False) -> torch.Tensor:
    """Left-to-right float32 running sum along dim 0 (inclusive, or
    exclusive with a leading 0)."""
    acc = torch.zeros_like(x[0])
    rows = []
    for k in range(x.shape[0]):
        if exclusive:
            rows.append(acc)
        acc = acc + x[k]
        if not exclusive:
            rows.append(acc)
    return torch.stack(rows)


def _tiled_scan(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    if n <= _SCAN_BASE:
        return _sequential(x)
    nb = -(-n // _SCAN_BASE)
    pad = nb * _SCAN_BASE - n
    xp = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) if pad else x
    tiles = xp.reshape((nb, _SCAN_BASE) + x.shape[1:]).movedim(1, 0)   # [16, nb, ...]
    inner = _sequential(tiles)                                         # [16, nb, ...]
    tot = inner[-1]                                                    # [nb, ...]
    if nb <= _SCAN_BASE:
        before = _sequential(tot, exclusive=True)
    else:
        before = torch.cat([torch.zeros_like(tot[:1]), _tiled_scan(tot)[:-1]])
    out = (inner + before[None]).movedim(0, 1).reshape((nb * _SCAN_BASE,) + x.shape[1:])
    return out[:n]


def _col_prefix(img: torch.Tensor) -> torch.Tensor:
    """The prefix sum down the columns with a zero row on top [..., H+1, W]:
    shared by every box filter of one image."""
    return F.pad(_prefix_sum(img, -2), (0, 0, 1, 0))


def _box_from_prefix(cy: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """The ky x kx box sums from the column prefix sums of ``_col_prefix``,
    as ``hyslam_tpu/ops/hessian.py:box_filter`` forms them (the edge rows
    and columns repeated past the border: zero padding of the image)."""
    h, w = cy.shape[-2] - 1, cy.shape[-1]
    ry0, ry1 = ky // 2, ky - ky // 2
    rx0, rx1 = kx // 2, kx - kx // 2
    cy = F.pad(cy.unsqueeze(-3), (0, 0, ry0, ry1), mode="replicate").squeeze(-3)
    v = (cy[..., ky:, :] - cy[..., :-ky, :])[..., :h, :]
    cx = F.pad(_prefix_sum(v, -1), (1, 0))
    cx = F.pad(cx.unsqueeze(-3), (rx0, rx1, 0, 0), mode="replicate").squeeze(-3)
    return (cx[..., :, kx:] - cx[..., :, :-kx])[..., :, :w]


def box_filter(img: torch.Tensor, ky: int, kx: int) -> torch.Tensor:
    """Centred ky x kx box sum at every pixel (zero padding outside), by two
    prefix-sum differences: O(HW) whatever the box size."""
    return _box_from_prefix(_col_prefix(img), ky, kx)


@functools.lru_cache(maxsize=256)
def _edge_mask(h: int, w: int, dy: int, dx: int, device: torch.device) -> torch.Tensor:
    """The 0/1 float mask of the pixels whose source (y+dy, x+dx) lies in
    the image; made once a shape and device (an upload from host memory
    makes the host wait for the card)."""
    yy = np.arange(h)
    xx = np.arange(w)
    my = (yy + dy >= 0) & (yy + dy < h)
    mx = (xx + dx >= 0) & (xx + dx < w)
    return torch.from_numpy(np.outer(my, mx).astype(np.float32)).to(device)


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with zero fill: the value at (y, x) comes from (y+dy, x+dx)."""
    mask = _edge_mask(x.shape[-2], x.shape[-1], dy, dx, x.device)
    return torch.roll(x, (-dy, -dx), dims=(-2, -1)) * mask


@functools.lru_cache(maxsize=16)
def _grid(step: int, device: torch.device):
    """The descriptor's 8x8 sample offsets (x [64], y [64]) at this step."""
    offs = (np.arange(8) - 3.5) * step
    gy, gx = np.meshgrid(offs, offs, indexing="ij")
    return (torch.from_numpy(gx.reshape(-1).astype(np.float32)).to(device),
            torch.from_numpy(gy.reshape(-1).astype(np.float32)).to(device))


def _doh_from_prefix(cy: torch.Tensor, L: int) -> torch.Tensor:
    l = L // 3
    wide = 2 * l - 1
    # Dyy: a column of three l x wide boxes, weights (+1, -2, +1)
    byy = _box_from_prefix(cy, l, wide)
    Dyy = _shift(byy, -l, 0) - 2.0 * byy + _shift(byy, l, 0)
    bxx = _box_from_prefix(cy, wide, l)
    Dxx = _shift(bxx, 0, -l) - 2.0 * bxx + _shift(bxx, 0, l)
    # Dxy: four l x l boxes at the diagonal quadrant centres
    bxy = _box_from_prefix(cy, l, l)
    o = (l + 1) // 2 + 1
    Dxy = (_shift(bxy, -o, -o) + _shift(bxy, o, o)
           - _shift(bxy, -o, o) - _shift(bxy, o, -o))
    inv_area = 1.0 / (L * L)
    Dxx = Dxx * inv_area
    Dyy = Dyy * inv_area
    Dxy = Dxy * inv_area
    d = 0.9 * Dxy
    return Dxx * Dyy - d * d


def doh_response(img: torch.Tensor, L: int) -> torch.Tensor:
    """Determinant-of-Hessian response for box-filter size L (SURF's
    Fast-Hessian: Dxx and Dyy from 3-lobe boxes, Dxy from 4 diagonal lobes,
    det = Dxx Dyy - (0.9 Dxy)^2, normalised by the filter area squared)."""
    return _doh_from_prefix(_col_prefix(img), L)


def _haar_from_prefix(cy: torch.Tensor, size: int):
    half = max(size // 2, 1)
    b = _box_from_prefix(cy, 2 * half, half)
    dx = _shift(b, 0, (half + 1) // 2) - _shift(b, 0, -(half + 1) // 2)
    b2 = _box_from_prefix(cy, half, 2 * half)
    dy = _shift(b2, (half + 1) // 2, 0) - _shift(b2, -(half + 1) // 2, 0)
    return dx, dy


def haar_responses(img: torch.Tensor, size: int):
    """Dense upright Haar wavelet responses (dx, dy) of the given size:
    dx = right-half box - left-half box, dy = bottom - top."""
    return _haar_from_prefix(_col_prefix(img), size)


def _descriptors_from_prefix(cy: torch.Tensor, uv: torch.Tensor,
                             scale: float) -> torch.Tensor:
    h, w = cy.shape[-2] - 1, cy.shape[-1]
    step = max(int(round(2 * scale)), 2)
    dx_map, dy_map = _haar_from_prefix(cy, step)

    gx, gy = _grid(step, uv.device)
    # round half to even, as jnp.round: with an odd step the grid lies on
    # half pixels
    x = torch.round(uv[..., 0, None] + gx).clamp(0, w - 1).long()           # [..., N, 64]
    y = torch.round(uv[..., 1, None] + gy).clamp(0, h - 1).long()
    flat = (y * w + x).flatten(-2)                                          # [..., N*64]
    dx = torch.gather(dx_map.flatten(-2), -1, flat).reshape(x.shape)
    dy = torch.gather(dy_map.flatten(-2), -1, flat).reshape(x.shape)
    adx, ady = dx.abs(), dy.abs()
    bits = torch.cat([dx > 0, dy > 0,
                      adx > adx.mean(dim=-1, keepdim=True),
                      ady > ady.mean(dim=-1, keepdim=True)], dim=-1)        # [..., N, 256]
    return pack_bits(bits)


def binary_haar_descriptors(img: torch.Tensor, uv: torch.Tensor,
                            scale: float = 1.0) -> torch.Tensor:
    """256-bit descriptors from an 8x8 grid of Haar responses around each
    keypoint: bits [dx > 0, dy > 0, |dx| > mean |dx|, |dy| > mean |dy|] a
    cell (an upright-SURF derivative binarized for Hamming matching).

    img [..., H, W], uv [..., N, 2] (x, y). Returns [..., N, 8] int32."""
    return _descriptors_from_prefix(_col_prefix(img), uv, scale)
