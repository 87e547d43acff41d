"""The port's BoW vocabulary and place recognizer (``hyslam_tpu_torch/
features/bow.py``, ``features/vocab_io.py``) against the JAX package's on
the CPU.

The shipped ``Vocabulary/synthetic_orb.npz`` (96,521 words, k 10, depth 5)
loads through both packages with equal arrays. On descriptors of the JAX
extractor on rendered 640x480 frames the word ids are equal and the BoW
vectors within 1e-6; the recognizer's scores within 1e-6, and its
relocalization and loop candidate lists equal. Both trainers, fed the same
descriptors and seed, build equal vocabularies.

Measured here and printed: the share of keypoints where the port's own
extractor (``features/factory.py``) gives a descriptor of the same word as
the JAX extractor's on the same keypoint, and whether the relocalization
candidates ranked from the port's descriptors are the JAX descriptors'."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hyslam_tpu.features import bow as jbow
from hyslam_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from hyslam_tpu.features.factory import make_family as j_make_family
from hyslam_tpu.features.vocab_io import load_vocabulary as j_load_vocabulary
from hyslam_tpu.slam.system import default_vocab_path as j_default_vocab_path
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.features import bow, vocab_io
from hyslam_tpu_torch.features.extractor import ExtractorConfig
from hyslam_tpu_torch.features.factory import make_family
from hyslam_tpu_torch.slam.system import default_vocab_path
from hyslam_tpu_torch.utils import synth

from helpers import DEFAULT_CAM
from port_helpers import feats_to_torch, one_thread  # noqa: F401

CAM = interop.camera_from(DEFAULT_CAM)
N_VIEWS = 6
K_REC = 16


@pytest.fixture(scope="module")
def vocabs():
    path = default_vocab_path()
    assert path is not None and path == j_default_vocab_path()
    return j_load_vocabulary(path), vocab_io.load_vocabulary(path, device="cpu")


@pytest.fixture(scope="module")
def views():
    """N_VIEWS rendered frames of one world along a short forward path
    (0.25 m and 0.012 rad a view): (JAX features, the port's own features)."""
    rng = np.random.default_rng(3)
    pts = np.stack([rng.uniform(-8, 8, 600), rng.uniform(-5, 5, 600),
                    rng.uniform(2.5, 30, 600)], -1).astype(np.float32)
    fam_j = j_make_family(JExtractorConfig(n_features=400, n_levels=4))
    fam_t = make_family(ExtractorConfig(n_features=400, n_levels=4))
    out = []
    for i in range(N_VIEWS):
        T = synth.se3_exp([0.0, 0.012 * i, 0.0, 0.0, 0.0, -0.25 * i]).astype(np.float32)
        img, _, _ = synth.render_world(CAM, T, pts)
        out.append((fam_j.extract(jnp.asarray(img), 512),
                    fam_t.extract(torch.from_numpy(img), capacity=512)))
    return out


def test_shipped_vocabulary_loads_equal(vocabs, tmp_path):
    vj, vt = vocabs
    got = interop.vocabulary_to_numpy(vt)
    for k in ("centers", "children", "word_id", "idf"):
        want = np.asarray(getattr(vj, k))
        assert got[k].dtype == want.dtype and got[k].tobytes() == want.tobytes(), k
    assert (vt.k, vt.depth, vt.n_words) == (vj.k, vj.depth, vj.n_words) == (10, 5, 96521)
    back = interop.vocabulary_from_numpy(vj)
    assert all(torch.equal(getattr(back, k), getattr(vt, k))
               for k in ("centers", "children", "word_id", "idf"))
    # the converter: npz -> npz through the port, read back by the JAX package
    out = tmp_path / "v.npz"
    assert vocab_io.main([default_vocab_path(), str(out)]) == 0
    vj2 = j_load_vocabulary(str(out))
    assert np.asarray(vj2.centers).tobytes() == np.asarray(vj.centers).tobytes()
    assert (vj2.k, vj2.depth) == (vj.k, vj.depth)


def test_dbow2_text_parses_like_jax(tmp_path):
    """A small DBoW2 text tree through both packages' parsers."""
    from hyslam_tpu.features.vocab_io import load_dbow2_text as j_text

    rng = np.random.default_rng(1)
    lines = ["3 2 0 0"]
    for parent, leaf in [(0, 0), (0, 0), (0, 1), (1, 1), (1, 1), (2, 1), (2, 1), (2, 1)]:
        b = " ".join(str(x) for x in rng.integers(0, 256, 32))
        lines.append(f"{parent} {leaf} {b} {rng.uniform(0.1, 3):.6f}")
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")
    vj, vt = j_text(str(p)), vocab_io.load_dbow2_text(str(p), device="cpu")
    got = interop.vocabulary_to_numpy(vt)
    for k in ("centers", "children", "word_id", "idf"):
        assert got[k].tobytes() == np.asarray(getattr(vj, k)).tobytes(), k


@pytest.mark.parametrize("i", [0, 3])
def test_bow_vector_matches_jax(vocabs, views, i):
    vj, vt = vocabs
    fj = views[i][0]
    v_j, w_j = jbow.bow_vector(vj, fj.desc, fj.valid)
    ft = feats_to_torch(fj)
    v_t, w_t = bow.bow_vector(vt, ft.desc, ft.valid)
    assert w_t.tolist() == np.asarray(w_j).tolist()
    assert int((w_t >= 0).sum()) == int(fj.valid.sum()) > 300
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), rtol=0, atol=1e-6)
    assert abs(float(v_t.sum()) - 1.0) < 1e-5


def _recognizers(vocabs, views):
    vj, vt = vocabs
    pj, pt = jbow.PlaceRecognizer(vj, K=K_REC), bow.PlaceRecognizer(vt, K=K_REC)
    for k in range(N_VIEWS - 1):
        f = views[k][0]
        pj.add_keyframe(k, f.desc, f.valid)
        ft = feats_to_torch(f)
        pt.add_keyframe(k, ft.desc, ft.valid)
    pj.remove_keyframe(1)
    pt.remove_keyframe(1)
    return pj, pt


def _covis():
    """A chain covisibility over the keyframes: neighbours share 120-30 k
    points."""
    cv = np.zeros((K_REC, K_REC), np.int32)
    for k in range(N_VIEWS - 2):
        cv[k, k + 1] = cv[k + 1, k] = 120 - 30 * k
    return cv


def test_recognizer_scores_and_candidates_match_jax(vocabs, views):
    pj, pt = _recognizers(vocabs, views)
    fq = views[N_VIEWS - 1][0]
    fqt = feats_to_torch(fq)
    s_j, s_t = pj.scores(fq.desc, fq.valid), pt.scores(fqt.desc, fqt.valid)
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-6)
    assert s_t[1] == -1.0 and (s_t[N_VIEWS:] == -1.0).all() and s_t[4] > s_t[0]
    cv = _covis()
    for excl in ((), (4,)):
        want = pj.detect_relocalization_candidates(fq.desc, fq.valid, cv, exclude=excl)
        assert pt.detect_relocalization_candidates(fqt.desc, fqt.valid, torch.from_numpy(cv),
                                                   exclude=excl) == want
        assert len(want) >= 1
    for kf_id, min_score in ((4, 0.01), (2, 0.01), (0, float(s_j[3]))):
        want = pj.detect_loop_candidates(fq.desc, fq.valid, cv[kf_id], kf_id, min_score)
        assert pt.detect_loop_candidates(fqt.desc, fqt.valid, cv[kf_id], kf_id,
                                         min_score) == want
        assert pt.detect_loop_candidates(fqt.desc, fqt.valid, cv, kf_id, min_score) == want


def test_port_descriptors_get_the_jax_words(vocabs, views):
    """Measured: the share of keypoints (those both extractors put at the
    same place and level) whose port descriptor falls in the JAX
    descriptor's word, and the relocalization ranking from the port's own
    descriptors against the JAX descriptors'. Printed; the test asserts
    that every keypoint pairs up and the ranking is the same."""
    vj, vt = vocabs
    same = total = bits_apart = bits = 0
    for fj, ft in views:
        ok = (np.asarray(fj.valid) & ft.valid.numpy()
              & (np.abs(np.asarray(fj.uv) - ft.uv.numpy()).max(1) < 1e-3)
              & (np.asarray(fj.level) == ft.level.numpy()))
        assert ok.sum() == int(fj.valid.sum())
        _, w_j = jbow.bow_vector(vj, fj.desc, fj.valid)
        _, w_t = bow.bow_vector(vt, ft.desc, ft.valid)
        same += int((w_t.numpy()[ok] == np.asarray(w_j)[ok]).sum())
        total += int(ok.sum())
        dj = np.asarray(fj.desc)[ok]
        dt = interop.desc_to_numpy(ft.desc)[ok]
        bits_apart += int(np.unpackbits((dj ^ dt).view(np.uint8)).sum())
        bits += dj.size * 32
    _, pt = _recognizers(vocabs, views)
    fj, ft = views[N_VIEWS - 1]
    fjt = feats_to_torch(fj)
    cv = torch.from_numpy(_covis())
    from_jax = pt.detect_relocalization_candidates(fjt.desc, fjt.valid, cv)
    from_port = pt.detect_relocalization_candidates(ft.desc, ft.valid, cv)
    print(f"port descriptors in the JAX descriptors' word: {same} of {total} keypoints "
          f"({same / total:.4f}); descriptor bits apart {bits_apart} of {bits} "
          f"({bits_apart / bits:.2e}); relocalization candidates from the JAX "
          f"descriptors {from_jax}, from the port's {from_port}")
    assert from_port == from_jax


def test_trainers_match_jax():
    """train_vocabulary (node by node) and train_vocabulary_batched (level
    by level, the assignment in torch) from the same descriptors and seed:
    equal arrays; the batched one is tests/test_vocabulary.py's corpus."""
    rng = np.random.default_rng(0)
    descs = rng.integers(0, 2**32, (1500, 8), dtype=np.uint32)
    vj = jbow.train_vocabulary(descs, k=8, depth=3)
    vt = bow.train_vocabulary(descs, k=8, depth=3, device="cpu")
    got = interop.vocabulary_to_numpy(vt)
    for k in ("centers", "children", "word_id", "idf"):
        assert got[k].tobytes() == np.asarray(getattr(vj, k)).tobytes(), k
    assert vt.n_words == vj.n_words > 50

    descs = np.random.default_rng(0).integers(0, 2**32, (3000, 8), dtype=np.uint32)
    docs = np.repeat(np.arange(30), 100)
    vj = jbow.train_vocabulary_batched(descs, k=5, depth=3, doc_id=docs, iters=3)
    vt = bow.train_vocabulary_batched(descs, k=5, depth=3, doc_id=docs, iters=3, device="cpu")
    got = interop.vocabulary_to_numpy(vt)
    for k in ("centers", "children", "word_id", "idf"):
        assert got[k].tobytes() == np.asarray(getattr(vj, k)).tobytes(), k
    assert 5 <= vt.n_words <= 125
    _, w = bow.bow_vector(vt, interop.desc_to_torch(descs[:256]), torch.ones(256, dtype=torch.bool))
    assert (w >= 0).all()
