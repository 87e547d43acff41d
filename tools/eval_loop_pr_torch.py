"""Place-recognition quality of the port: precision and recall of BoW loop
scoring on held-out rendered revisits against non-revisits (the twin of
tools/eval_loop_pr.py, on the card or the CPU).

Protocol (eval_loop_pr.py's): W held-out worlds, each rendered from a
reference view and a revisit (the same place from a pose ~0.5 m and ~5 deg
off, the gap a loop closure bridges). Positive pairs: (reference, revisit)
of one world; negatives: (reference_i, revisit_j) across worlds. The score
is ``features.bow.l1_score`` of the BoW vectors, the quantity the place
recognizer thresholds. A threshold sweep gives the PR curve, its area, the
best-F1 operating point and the separation of the two score sets.

    python3 tools/eval_loop_pr_torch.py [--worlds 40] [--out ARTIFACTS/pr_curve_torch.json]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hyslam_tpu_torch.device import resolve_device  # noqa: E402
from hyslam_tpu_torch.features.bow import bow_vector, l1_score  # noqa: E402
from hyslam_tpu_torch.features.extractor import ExtractorConfig  # noqa: E402
from hyslam_tpu_torch.features.factory import make_family  # noqa: E402
from hyslam_tpu_torch.features.vocab_io import load_vocabulary  # noqa: E402
from hyslam_tpu_torch.geometry.camera import Camera  # noqa: E402
from hyslam_tpu_torch.slam.system import default_vocab_path  # noqa: E402
from hyslam_tpu_torch.utils import synth  # noqa: E402

CAM = Camera(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480, bf=45.0,
             th_depth=35.0)


def build_views(n_worlds: int, dev, seed: int = 123, n_features: int = 400):
    """Features of each held-out world's reference and revisit views. The
    point seeds are disjoint from the vocabulary trainer's (w*7919+13)."""
    import torch

    fam = make_family(ExtractorConfig(n_features=n_features, n_levels=4))
    rng = np.random.default_rng(seed)
    refs, revs = [], []
    for w in range(n_worlds):
        pts = np.stack([rng.uniform(-8, 8, 500), rng.uniform(-5, 5, 500),
                        rng.uniform(2.5, 30, 500)], -1).astype(np.float32)
        pseed = 10_000_019 + w * 104729
        img0, _, _ = synth.render_world(CAM, np.eye(4, dtype=np.float32), pts,
                                        point_seed=pseed)
        xi = np.r_[rng.normal(0, 0.04, 3), rng.normal(0, 0.35, 3)]
        T = synth.se3_exp(xi.astype(np.float32)).astype(np.float32)
        img1, _, _ = synth.render_world(CAM, T, pts, point_seed=pseed)
        for img, dst in ((img0, refs), (img1, revs)):
            f = fam.extract(torch.from_numpy(img).to(dev), 512)
            dst.append((f.desc, f.valid))
        if (w + 1) % 10 == 0:
            print(f"  rendered {w + 1}/{n_worlds} worlds", flush=True)
    return refs, revs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, default=40)
    ap.add_argument("--vocab", default=None, help="vocabulary npz (default: the shipped one)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cpu, or none for the card")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    vp = args.vocab or default_vocab_path()
    vocab = load_vocabulary(vp, dev)
    print(f"vocabulary: {vp} ({vocab.n_words} words)")
    t0 = time.time()
    refs, revs = build_views(args.worlds, dev)
    vec_ref = [bow_vector(vocab, d, v)[0] for d, v in refs]
    vec_rev = [bow_vector(vocab, d, v)[0] for d, v in revs]
    pos = np.asarray([float(l1_score(a, b)) for a, b in zip(vec_ref, vec_rev)])
    n = len(vec_ref)
    neg = np.asarray([float(l1_score(vec_ref[i], vec_rev[j]))
                      for i in range(n) for j in range(i + 1, n)])

    rows, best = [], None
    for th in np.unique(np.concatenate([pos, neg])):
        tp, fp, fn = int((pos >= th).sum()), int((neg >= th).sum()), int((pos < th).sum())
        if tp + fp == 0:
            continue
        p, r = tp / (tp + fp), tp / (tp + fn)
        f1 = 2 * p * r / max(p + r, 1e-9)
        rows.append({"threshold": float(th), "precision": p, "recall": r, "f1": f1})
        if best is None or f1 > best["f1"]:
            best = rows[-1]
    rs = np.asarray([r["recall"] for r in rows])
    ps = np.asarray([r["precision"] for r in rows])
    order = np.argsort(rs)
    out = {
        "vocab": os.path.relpath(vp), "n_words": int(vocab.n_words),
        "n_worlds": args.worlds, "n_pos_pairs": len(pos), "n_neg_pairs": len(neg),
        "pos_scores": {"mean": float(pos.mean()), "min": float(pos.min())},
        "neg_scores": {"mean": float(neg.mean()), "max": float(neg.max())},
        "auc_pr": float(np.trapezoid(ps[order], rs[order])),
        "best_f1_operating_point": best, "wall_s": time.time() - t0,
        "device": str(dev), "curve": rows[:: max(1, len(rows) // 50)],
    }
    print(json.dumps({k: v for k, v in out.items() if k != "curve"}, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
