"""ORB orientation + steered BRIEF descriptors on 48x48 patches (counterpart
of ``hyslam_tpu/ops/orb.py:orient_and_describe`` and its tables; the
test-only ``orientations`` and ``descriptors`` are not ported).

The tables are rebuilt with the JAX package's numpy code, so the sampling
pattern, steering bins and moment weights are the same bit for bit.

The JAX package samples the steered pattern with 30 masked matmuls against
+/-1 selection matrices (a layout for the TPU's matrix unit). Each selection
column holds exactly one +1 and one -1 (or nothing, where both samples fall
on one pixel), so a column's product is the difference of two patch samples.
Here the two samples are gathered and subtracted directly: the same value
the float32-accumulated matmul gives, with one rounding, at a fraction of
the work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from hyslam_tpu_torch.ops.hamming import pack_bits

PATCH_RADIUS = 15            # HALF_PATCH_SIZE in the reference
PATTERN_BITS = 256
_PATTERN_CLIP = 13           # keep rotated samples inside the 31x31 patch


def _make_pattern(seed: int = 7, n_bits: int = PATTERN_BITS) -> np.ndarray:
    """[n_bits, 2, 2] int32 (pair, point, (dx, dy)) Gaussian BRIEF pattern."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATCH_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits, 2, 2))
    return np.clip(np.round(pts), -_PATTERN_CLIP, _PATTERN_CLIP).astype(np.int32)


PATTERN = _make_pattern()

# circular patch mask offsets for the orientation moments
_dy, _dx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
_CIRC = (_dy * _dy + _dx * _dx) <= PATCH_RADIUS * PATCH_RADIUS
PATCH_DY = _dy.reshape(-1)
PATCH_DX = _dx.reshape(-1)
PATCH_MASK = _CIRC.reshape(-1)

PATCH = 48                    # window: +/-19 rotated samples + blur context
PATCH_C = PATCH // 2
N_ROT_BINS = 30               # 12-degree steering bins


def _make_rot_indices():
    """(plus, minus) [N_ROT_BINS, 256] int64 flat 48x48 patch positions of
    the two samples of each pattern pair, rotated by the bin-centre angle
    with the JAX package's numpy code (its ``_make_rot_tables``): column s
    of its bin-b selection matrix has +1 at plus[b, s] and -1 at
    minus[b, s], so descriptor bit s is I(plus) - I(minus) > 0, i.e.
    I(p1) < I(p2). Where both samples fall on one pixel the column is zero,
    and so is the difference of the two equal gathers."""
    pat = PATTERN.astype(np.float64)          # [256, 2, 2] (dx, dy)
    a = 2.0 * np.pi * np.arange(N_ROT_BINS)[:, None, None] / N_ROT_BINS
    ca, sa = np.cos(a), np.sin(a)
    rx = np.clip(np.round(ca * pat[..., 0] - sa * pat[..., 1]),
                 -_PATTERN_CLIP - 6, _PATTERN_CLIP + 6).astype(np.int64)
    ry = np.clip(np.round(sa * pat[..., 0] + ca * pat[..., 1]),
                 -_PATTERN_CLIP - 6, _PATTERN_CLIP + 6).astype(np.int64)
    lin = (PATCH_C + ry) * PATCH + (PATCH_C + rx)     # [30, 256, 2]
    return lin[..., 1], lin[..., 0]


_SEL_PLUS, _SEL_MINUS = _make_rot_indices()

# orientation moment weights over the radius-15 disc, in 48x48 coords
_W48 = np.zeros((PATCH * PATCH, 2), np.float32)
_lin48 = (PATCH_C + _dy.reshape(-1)) * PATCH + (PATCH_C + _dx.reshape(-1))
np.add.at(_W48, (_lin48, 0), np.where(PATCH_MASK, PATCH_DX, 0))
np.add.at(_W48, (_lin48, 1), np.where(PATCH_MASK, PATCH_DY, 0))


def _blur_taps(ksize=7, sigma=2.0):
    x = np.arange(ksize) - (ksize - 1) / 2.0
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def orient_and_describe(img: torch.Tensor, uv: torch.Tensor):
    """Fused orientation + descriptor for keypoints uv [..., N, 2] (x, y) on
    RAW images [..., H, W] (one leading batch axis, or none): returns
    (angle [..., N] f32, desc [..., N, 8] int32).

    IC_Angle moments on the raw patch, rBRIEF sampled from the 7-tap
    Gaussian-blurred patch, steering quantized to 12-degree bins."""
    if img.dim() == 2:
        ang, desc = orient_and_describe(img[None], uv[None])
        return ang[0], desc[0]
    B, H, W = img.shape
    N = uv.shape[1]
    dev = img.device
    # edge-padded by the window radius, so every 48x48 window starts inside
    # the padded image and none is clamped (as the JAX dynamic_slice is not)
    padded = F.pad(img[:, None], (PATCH_C,) * 4, mode="replicate")[:, 0]
    Wp = W + 2 * PATCH_C
    y0 = torch.round(uv[..., 1]).to(torch.int64).clamp(0, H - 1)
    x0 = torch.round(uv[..., 0]).to(torch.int64).clamp(0, W - 1)
    ar = torch.arange(PATCH, device=dev)
    lin = ((y0[..., None] + ar)[..., :, None] * Wp
           + (x0[..., None] + ar)[..., None, :])              # [B,N,48,48]
    patches = torch.gather(padded.reshape(B, -1), 1,
                           lin.reshape(B, -1)).reshape(B, N, PATCH, PATCH)
    flat_raw = patches.reshape(B, N, PATCH * PATCH)

    m = flat_raw @ torch.as_tensor(_W48, device=dev)          # [B,N,2]
    ang = torch.atan2(m[..., 1], m[..., 0])

    # separable 7-tap blur with wrapping rolls; the wrap artifacts live in
    # the outer 3-px ring, outside the +/-19 sample range
    taps = _blur_taps()
    pb = torch.zeros_like(patches)
    for i, t in enumerate(taps):
        pb = pb + float(t) * torch.roll(patches, 3 - i, dims=-2)
    pb2 = torch.zeros_like(pb)
    for i, t in enumerate(taps):
        pb2 = pb2 + float(t) * torch.roll(pb, 3 - i, dims=-1)
    flat_b = pb2.reshape(B, N, PATCH * PATCH)
    # centre per patch, then round to bf16 as the JAX package does before
    # its matmul; back in f32 the sample difference is exact
    flat_b = flat_b - flat_b.mean(dim=-1, keepdim=True)
    flat_b = flat_b.to(torch.bfloat16).to(torch.float32)

    two_pi = 2.0 * np.pi
    bins = torch.round(torch.remainder(ang, two_pi) / (two_pi / N_ROT_BINS))
    bins = torch.remainder(bins.to(torch.int64), N_ROT_BINS)  # [B,N]

    plus = torch.as_tensor(_SEL_PLUS, device=dev)[bins]       # [B,N,256]
    minus = torch.as_tensor(_SEL_MINUS, device=dev)[bins]
    diff = torch.gather(flat_b, -1, plus) - torch.gather(flat_b, -1, minus)
    return ang, pack_bits(diff > 0.0)
