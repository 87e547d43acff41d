"""The port's map sparsification (``slam/sparsify.py``) against the JAX
package's on tests/test_sparsify.py's three scenes: the [K, K] overlap
fractions bit-equal (both count exact integers: the JAX package in bf16
0/1 products with float32 sums, the port in float32), the same keyframes
culled, and that file's own assertions on the port."""

import numpy as np
import pytest
import torch

from helpers import DEFAULT_CAM
from hyslam_tpu.slam import sparsify as J
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.slam import sparsify as T
from test_sparsify import build_map

from port_helpers import ms_to_torch, one_thread  # noqa: F401

CAM = Camera(**DEFAULT_CAM._asdict())


def _scene(name, rng):
    if name == "duplicates":          # 6 keyframes at (almost) one pose
        Ts = [np.eye(4, dtype=np.float32) for _ in range(6)]
        for i, Tm in enumerate(Ts):
            Tm[0, 3] = 0.001 * i
        return build_map(rng, Ts), 0.9
    if name == "distinct":            # disjoint views: nothing culled
        Ts = []
        for i in range(4):
            Tm = np.eye(4, dtype=np.float32)
            Tm[0, 3] = 18.0 * i
            Ts.append(Tm)
        return build_map(rng, Ts), 0.5
    ms = build_map(rng, [np.eye(4, dtype=np.float32) for _ in range(3)])   # all origins
    return ms._replace(kf=ms.kf._replace(origin=ms.kf.origin | ms.kf.valid)), 0.5


@pytest.mark.parametrize("name,n_culled", [("duplicates", 5), ("distinct", 0),
                                           ("origins", 0)])
def test_fractions_and_culled_set_equal_jax(name, n_culled):
    ms_j, crit = _scene(name, np.random.default_rng(0))
    ms_t = ms_to_torch(ms_j)
    want = np.asarray(J.keyframe_overlap_fractions(ms_j, DEFAULT_CAM))
    got = T.keyframe_overlap_fractions(ms_t, CAM).numpy()
    np.testing.assert_array_equal(got, want)
    ms2_j, n_j = J.sparsify_map(ms_j, DEFAULT_CAM, overlap_criterion=crit)
    ms2_t, n_t = T.sparsify_map(ms_t, CAM, overlap_criterion=crit)
    assert n_t == n_j == n_culled
    np.testing.assert_array_equal(ms2_t.kf.bad.numpy(), np.asarray(ms2_j.kf.bad))
    np.testing.assert_array_equal(ms2_t.covis.numpy(), np.asarray(ms2_j.covis))
    if name == "duplicates":
        assert got[0, 1] > 0.97
        bad = ms2_t.kf.bad.numpy()
        assert not bad[0] and bad[1:6].all()


def test_nothing_to_walk():
    """Fewer than two live keyframes: the map comes back as it was."""
    ms_j, _ = _scene("distinct", np.random.default_rng(1))
    ms_t = ms_to_torch(ms_j)
    one = ms_t._replace(kf=ms_t.kf._replace(valid=torch.arange(ms_t.K) < 1))
    out, n = T.sparsify_map(one, CAM)
    assert n == 0 and out is one
