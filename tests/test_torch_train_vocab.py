"""tools/train_synthetic_vocab_torch.py against tools/train_synthetic_vocab.py
on the CPU, at a small size (2 worlds x 1 pose, 300 features, depth 2):

- the corpus: the same number of keypoints in every image, and at least
  99.5% of the descriptor bits equal (the two renderers agree within 1e-3
  grey levels, the ORB angles within 1e-4 rad: tests/test_torch_tools.py,
  tests/test_torch_bow.py);
- both trainers fed the same corpus, the JAX tool's: equal ``centers``,
  ``children`` and ``word_id``, ``idf`` within 1e-6;
- the tool's ``main`` writes a vocabulary that ``vocab_io`` loads;
- importing the tool leaves JAX out, and with no card and no ``--device``
  it raises.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hyslam_tpu.features import bow as jbow
from hyslam_tpu_torch import interop
from hyslam_tpu_torch.features import bow, vocab_io

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

N_WORLDS, N_POSES, N_FEATURES, DEPTH = 2, 1, 300, 2


@pytest.fixture(scope="module")
def corpora():
    from tools import train_synthetic_vocab as jtool
    from tools import train_synthetic_vocab_torch as ttool

    return (jtool.build_corpus(N_WORLDS, N_POSES, N_FEATURES),
            ttool.build_corpus(N_WORLDS, N_POSES, N_FEATURES, device="cpu"))


def test_corpus_matches_the_jax_tool(corpora):
    (dj, docj), (dt, doct) = corpora
    assert dt.dtype == np.uint32 and dt.shape[1] == 8
    counts_j = np.bincount(docj, minlength=N_WORLDS * N_POSES)
    counts_t = np.bincount(doct, minlength=N_WORLDS * N_POSES)
    assert counts_t.tolist() == counts_j.tolist() and counts_j.min() > 100, (counts_j, counts_t)
    bits = np.unpackbits((dj ^ dt).view(np.uint8)).mean()
    print(f"keypoints an image {counts_j.tolist()}; descriptor bits apart {bits:.2e}")
    assert bits <= 0.005, bits


def test_trainers_on_the_jax_corpus_match(corpora):
    (dj, docj), _ = corpora
    vj = jbow.train_vocabulary_batched(dj, k=10, depth=DEPTH, doc_id=docj, iters=6)
    vt = bow.train_vocabulary_batched(dj, k=10, depth=DEPTH, doc_id=docj, iters=6,
                                      device="cpu")
    got = interop.vocabulary_to_numpy(vt)
    for key in ("centers", "children", "word_id"):
        assert got[key].tobytes() == np.asarray(getattr(vj, key)).tobytes(), key
    np.testing.assert_allclose(got["idf"], np.asarray(vj.idf), rtol=0, atol=1e-6)
    assert vt.n_words == vj.n_words > 20


def test_main_writes_a_loadable_vocabulary(tmp_path):
    from tools.train_synthetic_vocab_torch import main

    out = tmp_path / "v.npz"
    assert main(["--worlds", "1", "--poses", "1", "--features", "200", "--depth", "2",
                 "--iters", "2", "--out", str(out), "--device", "cpu"]) == 0
    voc = vocab_io.load_vocabulary(str(out), device="cpu")
    assert voc.k == 10 and voc.depth == 2 and 10 < voc.n_words <= 100


def test_tool_imports_without_jax_and_wants_a_card():
    code = ("import sys\n"
            f"sys.path.insert(0, {str(REPO)!r})\n"
            "import tools.train_synthetic_vocab_torch as t\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', "
            "'hyslam_tpu.')) or m == 'hyslam_tpu']\n"
            "assert not bad, bad\n"
            "print('imported', flush=True)\n"
            "t.main(['--worlds', '1', '--out', 'unused.npz'])\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.startswith("imported"), proc.stderr
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr, proc.stderr
    assert not (REPO / "unused.npz").exists()
