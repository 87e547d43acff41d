"""Wrappers the benchmark puts around the program's calls into each layer,
from outside: nothing in the program changes.

Always on (the correctness check reads what the timed path produced): the
front end's outputs of every frame, and the arguments and results of every
pose-only solve (kernel K1 on the card) and of every local BA, kept by
reference. All are fresh tensors the program never writes again, so
keeping them adds no device work and no synchronisation.

With ``spans`` (the traced run): the host time of every call into the
front end, the tracker's step and the mapper, each also as a profiler
range ``bench:<layer>`` so the device trace can be cut by layer.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import nullcontext


class Probes:
    def __init__(self, system, spans: bool):
        from hyslam_tpu_torch.slam import mapper, strategies, tracker
        from hyslam_tpu_torch.slam import system as sysmod

        self.system = system
        self.with_spans = spans
        self.spans = defaultdict(list)     # layer -> [seconds of each call]
        self.frame = -1                    # index of the frame being fed
        self.extracted = {}                # frame -> batched features [2, F]
        self.matched = {}                  # frame -> left features after stereo
        self.solves = []                   # (frame, args, result) of each solve
        self.local_ba = []                 # (frame, problem, result) of each local BA
        self._mods = (sysmod, tracker, strategies, mapper)
        self._saved = []

    def _range(self, layer):
        if not self.with_spans:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(f"bench:{layer}")

    def _timed(self, layer, fn, keep=None):
        def run(*a, **kw):
            with self._range(layer):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if self.with_spans:
                    self.spans[layer].append(time.perf_counter() - t0)
            if keep is not None:
                keep(a, out)
            return out
        return run

    def _patch(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def install(self):
        sysmod, tracker, strategies, mapper_mod = self._mods
        s = self.system
        fam = s._families["SLAM"]
        s._families["SLAM"] = fam._replace(extract_batch=self._timed(
            "frontend", fam.extract_batch,
            lambda a, out: self.extracted.__setitem__(self.frame, out)))
        self._saved.append((s._families, "SLAM", fam))
        self._patch(sysmod, "preprocess_image",
                    self._timed("frontend", sysmod.preprocess_image))
        self._patch(sysmod, "match_stereo_refined", self._timed(
            "frontend", sysmod.match_stereo_refined,
            lambda a, out: self.matched.__setitem__(self.frame, out)))
        self._patch(tracker, "track_normal_step",
                    self._timed("track", tracker.track_normal_step))
        self._patch(strategies, "pose_optimization_fast", self._timed(
            "solve", strategies.pose_optimization_fast,
            lambda a, out: self.solves.append((self.frame, a, out))))
        self._patch(mapper_mod, "local_ba_two_phase", self._timed(
            "local_ba", mapper_mod.local_ba_two_phase,
            lambda a, out: self.local_ba.append((self.frame, a[0], out))))
        mapper = s.trackers["SLAM"].mapper
        self._patch(mapper, "integrate_keyframe",
                    self._timed("mapper", mapper.integrate_keyframe))
        return self

    def uninstall(self):
        for obj, name, value in reversed(self._saved):
            if isinstance(obj, dict):
                obj[name] = value
            else:
                setattr(obj, name, value)
        self._saved.clear()
