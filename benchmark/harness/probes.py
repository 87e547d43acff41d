"""Wrappers the benchmark puts around the program's calls into each layer,
from outside: nothing in the program changes.

Always on (the correctness check reads what the timed path produced): the
front end's outputs of every frame of every camera, the arguments and
results of every pose-only solve (kernel K1 on the card) and of every
local BA, and of every call that a check file names in its ``WRAPS``
(``checks/<number>.py``), each tagged with the camera and the frame being
fed when it was made (a mapper call, with the camera whose mapper made
it), all kept by reference. All are fresh tensors the program never writes
again, so keeping them adds no device work and no synchronisation.

With ``spans`` (the traced run): the host time of every call into the
front end, the tracker's step and the mapper, each also as a profiler
range ``bench:<layer>`` so the device trace can be cut by layer.
"""

from __future__ import annotations

import importlib
import time
from collections import defaultdict
from contextlib import nullcontext
from typing import NamedTuple


class Call(NamedTuple):
    """One recorded call of the program."""
    camera: str
    frame: int | None          # None: made by the finalization call
    args: tuple
    kwargs: dict
    result: object


class Probes:
    def __init__(self, system, spans: bool, wraps=()):
        from hyslam_tpu_torch.slam import mapper, strategies, tracker
        from hyslam_tpu_torch.slam import system as sysmod

        self.system = system
        self.with_spans = spans
        self.spans = defaultdict(list)       # layer -> [seconds of each call]
        self.camera = "SLAM"                 # the camera being fed
        self.frame = -1                      # index of its frame being fed
        self.extracted = defaultdict(dict)   # camera -> frame -> extracted features
                                             # (a stereo camera's batched [2, F])
        self.matched = defaultdict(dict)     # camera -> frame -> left features after stereo
        self.solves = []                     # (camera, frame, args, result) of each solve
        self.local_ba = []                   # (camera, frame, problem, result) of each local BA
        self.calls = {tuple(w): [] for w in wraps}   # (module, attribute) -> [Call]
        self._mods = (sysmod, tracker, strategies, mapper)
        self._saved = []

    def _range(self, layer):
        if not self.with_spans or layer is None:
            return nullcontext()
        from torch.profiler import record_function
        return record_function(f"bench:{layer}")

    def _timed(self, layer, fn, keep=None):
        def run(*a, **kw):
            with self._range(layer):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if self.with_spans and layer is not None:
                    self.spans[layer].append(time.perf_counter() - t0)
            if keep is not None:
                keep(a, kw, out)
            return out
        return run

    def _patch(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def _keep_features(self, a, kw, out):
        self.extracted[self.camera][self.frame] = out

    def _family(self, fam):
        """The feature family with its extraction timed and kept."""
        return fam._replace(
            extract=self._timed("frontend", fam.extract, self._keep_features),
            extract_batch=fam.extract_batch and self._timed(
                "frontend", fam.extract_batch, self._keep_features))

    def _mapper(self, camera, fn):
        """A tracker's Mapper.integrate_keyframe, timed, its calls tagged
        with the tracker's camera."""
        timed = self._timed("mapper", fn)

        def run(*a, **kw):
            fed, self.camera = self.camera, camera
            try:
                return timed(*a, **kw)
            finally:
                self.camera = fed
        return run

    def _record(self, key, fn):
        calls = self.calls[key]
        return self._timed(None, fn, lambda a, kw, out: calls.append(
            Call(self.camera, self.frame, a, kw, out)))

    def install(self):
        sysmod, tracker, strategies, mapper_mod = self._mods
        s = self.system
        for name, fam in list(s._families.items()):
            self._saved.append((s._families, name, fam))
            s._families[name] = self._family(fam)
        make_family = sysmod.make_family      # a monocular initializer's family
        self._patch(sysmod, "make_family", lambda cfg: self._family(make_family(cfg)))
        self._patch(sysmod, "preprocess_image",
                    self._timed("frontend", sysmod.preprocess_image))
        self._patch(sysmod, "match_stereo_refined", self._timed(
            "frontend", sysmod.match_stereo_refined,
            lambda a, kw, out: self.matched[self.camera].__setitem__(self.frame, out)))
        self._patch(tracker, "track_normal_step",
                    self._timed("track", tracker.track_normal_step))
        self._patch(strategies, "pose_optimization_fast", self._timed(
            "solve", strategies.pose_optimization_fast,
            lambda a, kw, out: self.solves.append((self.camera, self.frame, a, out))))
        self._patch(mapper_mod, "local_ba_two_phase", self._timed(
            "local_ba", mapper_mod.local_ba_two_phase,
            lambda a, kw, out: self.local_ba.append((self.camera, self.frame, a[0], out))))
        for name, tk in s.trackers.items():
            self._patch(tk.mapper, "integrate_keyframe",
                        self._mapper(name, tk.mapper.integrate_keyframe))
        for key in self.calls:
            module, attribute = key
            *path, last = attribute.split(".")
            owner = importlib.import_module(module)
            for part in path:
                owner = getattr(owner, part)
            self._patch(owner, last, self._record(key, getattr(owner, last)))
        return self

    def clear(self):
        """Forget what the warm frames left."""
        for store in (self.extracted, self.matched, self.spans):
            store.clear()
        self.solves.clear()
        self.local_ba.clear()
        for calls in self.calls.values():
            calls.clear()

    def uninstall(self):
        for obj, name, value in reversed(self._saved):
            if isinstance(obj, dict):
                obj[name] = value
            else:
                setattr(obj, name, value)
        self._saved.clear()
