"""Pretrain a place-recognition vocabulary at scale with the PyTorch port (the
twin of tools/train_synthetic_vocab.py; the analog of the reference's shipped
~1M-word DBoW2 ORB vocabulary, System.cc:86).

Renders many random sparse-textured worlds (``utils/synth.render_world``,
the same worlds and point seeds as the JAX tool), extracts ORB descriptors
with the port's atlas extractor, and trains a k=10 hierarchical k-medians
tree with tf-idf weights (``features.bow.train_vocabulary_batched``), on the
card unless ``--device cpu`` is given. The result loads with
``features.vocab_io.load_vocabulary`` and ``System(vocab_path=...)``.

    python3 tools/train_synthetic_vocab_torch.py --worlds 150 --poses 2 \
        --depth 5 --out build/vocab/synthetic_orb.npz [--device cpu]

``--out`` defaults to the JAX tool's path, the shipped
``Vocabulary/synthetic_orb.npz`` (k 10, depth 5, 96,521 words, trained by the
JAX tool): name another path to keep that file.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hyslam_tpu_torch.geometry.camera import Camera  # noqa: E402

# tests/helpers.py's DEFAULT_CAM
CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480, bf=45.0,
             th_depth=35.0)
CAPACITY = 512


def build_corpus(n_worlds: int, n_poses: int, n_features: int, seed: int = 0, device=None):
    """(descriptors [N,8] uint32, source image of each [N] int64) of
    n_worlds random worlds seen from n_poses random poses each."""
    import torch

    from hyslam_tpu_torch.device import resolve_device
    from hyslam_tpu_torch.features.extractor import ExtractorConfig
    from hyslam_tpu_torch.features.factory import make_family
    from hyslam_tpu_torch.utils import synth

    dev = resolve_device(device)
    fam = make_family(ExtractorConfig(n_features=n_features, n_levels=4))
    rng = np.random.default_rng(seed)
    descs, docs = [], []
    for w in range(n_worlds):
        pts = np.stack([rng.uniform(-8, 8, 500), rng.uniform(-5, 5, 500),
                        rng.uniform(2.5, 30, 500)], -1).astype(np.float32)
        for p in range(n_poses):
            xi = np.r_[rng.normal(0, 0.05, 3), rng.normal(0, 0.4, 3)]
            T = synth.se3_exp(xi.astype(np.float32)).astype(np.float32)
            img, _, _ = synth.render_world(CAM, T, pts, point_seed=w * 7919 + 13)
            f = fam.extract(torch.from_numpy(img).to(dev), CAPACITY)
            v = f.valid.cpu().numpy()
            d = f.desc.cpu().numpy().view(np.uint32)[v]
            descs.append(d)
            docs.append(np.full(len(d), w * n_poses + p, np.int64))
        if (w + 1) % 25 == 0:
            print(f"  {w + 1}/{n_worlds} worlds, {sum(len(d) for d in descs)} descriptors",
                  flush=True)
    return np.concatenate(descs), np.concatenate(docs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=150)
    ap.add_argument("--poses", type=int, default=2)
    ap.add_argument("--features", type=int, default=500)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--out", default="Vocabulary/synthetic_orb.npz")
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    args = ap.parse_args(argv)

    from hyslam_tpu_torch.device import resolve_device
    from hyslam_tpu_torch.features.bow import train_vocabulary_batched
    from hyslam_tpu_torch.features.vocab_io import save_vocabulary

    dev = resolve_device(args.device)
    t0 = time.time()
    print("building corpus ...")
    descs, docs = build_corpus(args.worlds, args.poses, args.features, device=dev)
    print(f"corpus: {len(descs)} descriptors from {docs.max() + 1} images "
          f"({time.time() - t0:.0f}s)")
    t0 = time.time()
    voc = train_vocabulary_batched(descs, k=args.k, depth=args.depth, doc_id=docs,
                                   iters=args.iters, device=dev)
    print(f"trained: {voc.n_words} words, k={voc.k}, depth={voc.depth} "
          f"({time.time() - t0:.0f}s)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    save_vocabulary(args.out, voc)
    print(f"saved {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
