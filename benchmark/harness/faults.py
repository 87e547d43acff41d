"""Faults planted under the timed path, to show that the correctness check
fails them: each replaces one call of the program, from outside, before
the System is built.

    undo = plant(name)            # or plant(name, monkeypatch.setattr)
"""

from __future__ import annotations

import torch


def _solve(set_attr, alter):
    from hyslam_tpu_torch.slam import strategies

    solve = strategies.pose_optimization_fast

    def broken(*args, **kw):
        res = solve(*args, **kw)
        return res._replace(Tcw=alter(args[1], res.Tcw))

    set_attr(strategies, "pose_optimization_fast", broken)


def _shift(T0, T):
    T = T.clone()
    T[..., 0, 3] += 0.01
    return T


def _half_batch(set_attr):
    """The stereo pair's extraction runs on the left image only and hands
    its features out for both."""
    from hyslam_tpu_torch.features import factory

    extract = factory.extract_atlas_batch

    def left_only(imgs, cfg, capacity):
        half = extract(imgs[:1], cfg, capacity)
        return type(half)(*(torch.cat([x, x]) for x in half))

    set_attr(factory, "extract_atlas_batch", left_only)


def _no_triangulation(set_attr):
    from hyslam_tpu_torch.slam import mapper

    def skipped(ms, kf_id, *a, **kw):
        return ms, torch.zeros((), dtype=torch.int32, device=ms.covis.device)

    set_attr(mapper, "triangulate_new_landmarks", skipped)


def _no_fusion(set_attr):
    from hyslam_tpu_torch.slam import mapper

    def skipped(ms, kf_id, *a, **kw):
        z = torch.zeros((), dtype=torch.int32, device=ms.covis.device)
        return ms, z, z

    set_attr(mapper, "fuse_landmarks", skipped)


def _ba_unchanged(set_attr):
    """Local BA hands back the poses and landmarks it was given."""
    from hyslam_tpu_torch.slam import mapper

    solve = mapper.local_ba_two_phase

    def unchanged(p, *a, **kw):
        return solve(p, *a, **kw)._replace(kf_Tcw=p.kf_Tcw, lm_pos=p.lm_pos)

    set_attr(mapper, "local_ba_two_phase", unchanged)


FAULTS = {
    "state_unchanged": lambda s: _solve(s, lambda T0, T: T0.clone()),
    "pose_altered": lambda s: _solve(s, _shift),
    "half_batch": _half_batch,
    "no_triangulation": _no_triangulation,
    "no_fusion": _no_fusion,
    "ba_unchanged": _ba_unchanged,
}


def plant(name: str, set_attr=None):
    """Plant fault ``name``; returns a function that takes it out again."""
    saved = []

    def record(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    FAULTS[name](set_attr or record)

    def undo():
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
    return undo
