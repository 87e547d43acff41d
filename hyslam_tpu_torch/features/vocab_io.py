"""Vocabulary files: DBoW2 text parsing and npz serialization (counterpart
of ``hyslam_tpu/features/vocab_io.py``; the npz files of both packages are
the same).

The DBoW2 text format is

    k L scoring_type weighting_type
    parent_id is_leaf b0 b1 ... b31 weight      (one line per non-root node)

with node ids implicit in line order (root = 0). It loads into the array
layout of ``features.bow.Vocabulary``.

Usage (converts a text vocabulary, or rewrites an npz one):

    python -m hyslam_tpu_torch.features.vocab_io ORBvoc.txt ORBvoc.npz
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from hyslam_tpu_torch.device import resolve_device
from hyslam_tpu_torch.features.bow import (Vocabulary, vocabulary_arrays,
                                           vocabulary_from_arrays)
from hyslam_tpu_torch.ops.hamming import pack_bits


def load_dbow2_text(path: str, device=None) -> Vocabulary:
    """Parse a DBoW2 text vocabulary into a Vocabulary on ``device``."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaves, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaves.append(int(parts[1]) != 0)
            descs.append([int(b) for b in parts[2:34]])
            weights.append(float(parts[34]))

    n = len(parents) + 1                     # + root
    centers_u8 = np.zeros((n, 32), np.uint8)
    centers_u8[1:] = np.asarray(descs, np.uint8)
    # bytes -> 256 bits (LSB first in each byte) -> packed 32-bit words
    bits = np.unpackbits(centers_u8, axis=-1, bitorder="little")
    centers = pack_bits(torch.from_numpy(bits)).numpy()

    children = np.full((n, k), -1, np.int32)
    counts = np.zeros(n, np.int32)
    word_id = np.full(n, -1, np.int32)
    idf = []
    w = 0
    for i, (p, is_leaf) in enumerate(zip(parents, leaves)):
        node = i + 1
        if counts[p] < k:
            children[p, counts[p]] = node
            counts[p] += 1
        if is_leaf:
            word_id[node] = w
            idf.append(weights[i])
            w += 1
    return vocabulary_from_arrays(centers, children, word_id, np.asarray(idf, np.float32),
                                  k, L, device=resolve_device(device))


def save_vocabulary(path: str, vocab: Vocabulary) -> None:
    np.savez_compressed(path, **vocabulary_arrays(vocab))


def load_vocabulary(path: str, device=None) -> Vocabulary:
    z = np.load(path)
    return vocabulary_from_arrays(z["centers"], z["children"], z["word_id"], z["idf"],
                                  int(z["k"]), int(z["depth"]), device=resolve_device(device))


def main(argv=None):
    argv = argv or sys.argv[1:]
    if len(argv) != 2:
        print("usage: python -m hyslam_tpu_torch.features.vocab_io "
              "<in: ORBvoc.txt|.npz> <out: .npz>")
        return 1
    src, dst = argv
    voc = (load_vocabulary(src, device="cpu") if src.endswith(".npz")
           else load_dbow2_text(src, device="cpu"))
    save_vocabulary(dst, voc)
    print(f"{src} -> {dst}: {voc.n_words} words, k={voc.k}, L={voc.depth}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
