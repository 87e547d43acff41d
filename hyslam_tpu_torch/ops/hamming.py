"""256-bit binary descriptor Hamming distances (counterpart of
``hyslam_tpu/ops/hamming.py``).

Descriptors are [..., 8] int32 bit-views of the JAX package's uint32 lanes.
An arithmetic ``>>`` on int32 followed by ``& 1`` still reads bit i of the
word, so unpacking needs no unsigned type. Distances are int32 in [0, 256].
"""

from __future__ import annotations

import torch


def unpack_bits(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[..., 8] -> [..., 256] {0,1} planes (bit order: word-major, LSB first
    — consistent with pack_bits)."""
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc.to(torch.int32)[..., :, None] >> shifts) & 1   # [..., 8, 32]
    return bits.reshape(desc.shape[:-1] + (256,)).to(dtype)


def _popcount_words(w: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word [...] -> [...] int64, by the SWAR bit
    count on the word's unsigned value held in int64 (no product
    overflows), so no [..., 256] bit planes are materialised."""
    x = w.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def popcount(desc: torch.Tensor) -> torch.Tensor:
    """Total set bits per descriptor [..., 8] -> [...] int32."""
    return _popcount_words(desc).sum(dim=-1).to(torch.int32)


def hamming_pairwise(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Hamming distance between broadcast-compatible descriptor
    arrays [..., 8] -> [...] int32 (XOR, then the bit count)."""
    return popcount(torch.bitwise_xor(a, b))


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool/{0,1} -> [..., 8] int32 bit-view (inverse of
    unpack_bits). Words are summed in int64 and wrapped to the int32 with
    the same 32 bits."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def hamming_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distances: a [Q, 8], b [F, 8] -> [Q, F] int32,
    as popcount(a) + popcount(b) - 2 <bits(a), bits(b)>. The bit-plane
    product is a float32 matmul of {0,1} values with sums <= 256: exact."""
    dot = unpack_bits(a) @ unpack_bits(b).transpose(-1, -2)
    return popcount(a)[:, None] + popcount(b)[None, :] - 2 * dot.to(torch.int32)
