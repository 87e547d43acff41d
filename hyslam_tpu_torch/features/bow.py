"""Bag-of-words vocabulary and place-recognition scoring (counterpart of
``hyslam_tpu/features/bow.py``).

- A hierarchical k-medians tree over binary descriptors, held as flat
  tensors: centers [n_nodes, 8] (int32 bit-views of the JAX package's uint32
  lanes), children [n_nodes, k] (-1 past the last child), word_id [n_nodes]
  (-1 on inner nodes), idf [n_words].
- The BoW transform descends the tree for all descriptors of a frame at
  once: at each of ``depth`` levels XOR and bit count against the node's
  children, the first child of least distance (missing children at 1 << 16).
  Then an integer histogram of the word ids, tf-idf and L1 normalisation.
- Scoring is the DBoW2 L1 similarity 1 - 0.5 |a - b|_1 against a dense
  [K, n_words] matrix of keyframe vectors on the device. Candidate ranking
  runs on the host with the JAX package's numpy calls (``np.argsort`` of its
  default kind), so that equal score arrays rank alike.

The trainers are host numpy with ``default_rng(seed)``, as in the JAX
package; the batched trainer's assignment step runs in torch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hyslam_tpu_torch.device import resolve_device
from hyslam_tpu_torch.ops.hamming import _popcount_words, pack_bits, unpack_bits


class Vocabulary(NamedTuple):
    centers: torch.Tensor    # [n_nodes, 8] int32 node centers (bit-views)
    children: torch.Tensor   # [n_nodes, k] int32 child node ids (-1 none)
    word_id: torch.Tensor    # [n_nodes] int32 leaf -> word index (-1 inner)
    idf: torch.Tensor        # [n_words] f32 inverse document frequency
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.idf.shape[0]


def vocabulary_from_arrays(centers, children, word_id, idf, k, depth,
                           device=None) -> Vocabulary:
    """numpy (or JAX) arrays -> a Vocabulary on ``device``, bit for bit
    (uint32 centers become their int32 view)."""
    c = np.ascontiguousarray(np.asarray(centers))
    if c.dtype == np.uint32:
        c = c.view(np.int32)
    return Vocabulary(
        centers=torch.from_numpy(np.array(c, np.int32)).to(device),
        children=torch.from_numpy(np.array(children, np.int32)).to(device),
        word_id=torch.from_numpy(np.array(word_id, np.int32)).to(device),
        idf=torch.from_numpy(np.array(idf, np.float32)).to(device),
        k=int(k), depth=int(depth))


def vocabulary_arrays(vocab: Vocabulary) -> dict:
    """A Vocabulary -> dict of numpy arrays in the JAX package's dtypes
    (uint32 centers)."""
    return dict(centers=vocab.centers.cpu().numpy().view(np.uint32),
                children=vocab.children.cpu().numpy(),
                word_id=vocab.word_id.cpu().numpy(),
                idf=vocab.idf.cpu().numpy(), k=vocab.k, depth=vocab.depth)


def _pack_np(bits: np.ndarray) -> np.ndarray:
    """[..., 256] {0,1} numpy -> [..., 8] int32 bit-view."""
    return pack_bits(torch.from_numpy(np.asarray(bits))).numpy()


def train_vocabulary(descs: np.ndarray, k: int = 10, depth: int = 3,
                     seed: int = 0, iters: int = 8, device=None) -> Vocabulary:
    """Hierarchical k-medians over binary descriptors [N, 8] (uint32 or an
    int32 bit-view), node by node on the host. Each node clusters its
    descriptors into k children by Hamming k-means (mean, then threshold).
    Depth d gives up to k^d words; idf is 1."""
    rng = np.random.default_rng(seed)
    d32 = np.ascontiguousarray(np.asarray(descs)).view(np.int32)
    bits_all = unpack_bits(torch.from_numpy(np.array(d32))).numpy()

    centers = [np.zeros(8, np.int32)]     # node 0 = root (center unused)
    children: list[list[int]] = [[]]
    word_id = [-1]

    def kmeans(bits):
        n = len(bits)
        kk = min(k, n)
        if kk == 0:
            return None, None
        idx = rng.choice(n, kk, replace=False)
        C = bits[idx].copy()
        for _ in range(iters):
            d = (bits[:, None, :] != C[None, :, :]).sum(-1)
            a = d.argmin(1)
            for j in range(kk):
                m = a == j
                if m.any():
                    C[j] = (bits[m].mean(0) > 0.5).astype(bits.dtype)
        d = (bits[:, None, :] != C[None, :, :]).sum(-1)
        return C, d.argmin(1)

    frontier = [(0, bits_all, 0)]  # (node, member bits, level), depth first
    words = 0
    while frontier:
        node, bits, level = frontier.pop()
        if level >= depth or len(bits) <= k:
            word_id[node] = words
            words += 1
            continue
        C, assign = kmeans(bits)
        ch = []
        for j in range(len(C)):
            cid = len(centers)
            centers.append(_pack_np(C[j][None])[0])
            children.append([])
            word_id.append(-1)
            ch.append(cid)
            frontier.append((cid, bits[assign == j], level + 1))
        children[node] = ch

    ch_arr = np.full((len(centers), k), -1, np.int32)
    for i, ch in enumerate(children):
        ch_arr[i, : len(ch)] = ch
    return vocabulary_from_arrays(np.stack(centers), ch_arr, np.asarray(word_id, np.int32),
                                  np.ones(words, np.float32), k, depth,
                                  device=resolve_device(device))


def train_vocabulary_batched(descs: np.ndarray, k: int = 10, depth: int = 4,
                             doc_id: np.ndarray | None = None, seed: int = 0,
                             iters: int = 6, device=None) -> Vocabulary:
    """Level-parallel hierarchical k-medians for large corpora: every level
    clusters all nodes at once, one [N, k] Hamming argmin an iteration and
    one scatter of the [N, 256] bits for the bit medians (torch programs on
    ``device``; integer sums, so the order of the adds does not matter).
    doc_id [N] (e.g. the source image of each descriptor) enables idf
    weighting, idf = ln(n_docs / df_word), at least 1e-3."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    descs = np.ascontiguousarray(np.asarray(descs).view(np.uint32))
    d32 = descs.view(np.int32)
    N = len(descs)
    descs_t = torch.from_numpy(np.array(d32)).to(dev)
    bits_t = unpack_bits(descs_t, torch.int32)                       # [N,256]

    centers_out = [np.zeros((1, 8), np.uint32)]     # node 0 = root
    children_out = [np.full((1, k), -1, np.int32)]
    node_base = 1                                    # next node id
    slot = np.zeros(N, np.int64)                     # dense node slot / desc
    level_node_ids = np.asarray([0], np.int64)       # node id per slot

    def assign_step(C: np.ndarray, sl: torch.Tensor) -> np.ndarray:
        cen = torch.from_numpy(np.ascontiguousarray(C).view(np.int32)).to(dev)[sl]  # [N,k,8]
        d = _popcount_words(torch.bitwise_xor(cen, descs_t[:, None, :])).sum(-1)
        return torch.argmin(d, dim=-1).cpu().numpy().astype(np.int32)

    for level in range(depth):
        M = len(level_node_ids)
        # seed k centers per slot from its own members
        order = np.lexsort((rng.random(N), slot))
        sl_sorted = slot[order]
        starts = np.searchsorted(sl_sorted, np.arange(M))
        pos = np.arange(N) - starts[sl_sorted]
        sm = pos < k
        C = np.zeros((M, k, 8), np.uint32)
        C[sl_sorted[sm], pos[sm]] = descs[order[sm]]
        child_seen = np.zeros((M, k), bool)
        child_seen[sl_sorted[sm], pos[sm]] = True
        # nodes with < k members: duplicate the first member into the unused
        # seed rows so that all-zero centers never attract assignments
        first = descs[order[starts]]                  # [M,8] first member
        C[~child_seen] = np.repeat(first, k, axis=0).reshape(M, k, 8)[~child_seen]

        slt = torch.from_numpy(slot).to(dev)
        a = None
        for _ in range(iters):
            a = assign_step(C, slt)
            flat = slot * k + a
            cnt = np.bincount(flat, minlength=M * k)
            sums = torch.zeros(M * k, 256, dtype=torch.int32, device=dev).index_add_(
                0, torch.from_numpy(flat).to(dev), bits_t).cpu().numpy()
            nz = cnt > 0
            med = (sums[nz] * 2 > cnt[nz, None]).astype(np.uint8)
            newC = _pack_np(med).view(np.uint32).reshape(-1, 8)
            Cf = C.reshape(M * k, 8)
            Cf[nz] = newC
            C = Cf.reshape(M, k, 8)
        flat = slot * k + a
        cnt = np.bincount(flat, minlength=M * k)
        nonempty = (cnt > 0).reshape(M, k)

        # child node ids for the nonempty clusters, compacted
        n_children = int(nonempty.sum())
        child_id = np.full((M, k), -1, np.int64)
        child_id[nonempty] = node_base + np.arange(n_children)
        ch_rows = np.full((n_children, k), -1, np.int32)
        centers_out.append(C.reshape(M * k, 8)[nonempty.ravel()])
        children_out.append(ch_rows)
        # fill the parents' children tables (parents are earlier rows)
        parent_rows = np.concatenate(children_out[:-1])
        for m in range(M):
            ids = child_id[m][nonempty[m]]
            parent_rows[level_node_ids[m], :len(ids)] = ids
        off = 0
        for i, arr in enumerate(children_out[:-1]):
            children_out[i] = parent_rows[off:off + len(arr)]
            off += len(arr)

        slot = child_id[slot, a] - node_base                 # dense 0..n-1
        level_node_ids = node_base + np.arange(n_children)
        node_base += n_children

    centers = np.concatenate(centers_out)
    children = np.concatenate(children_out)
    word_id = np.full(len(centers), -1, np.int32)
    word_id[level_node_ids] = np.arange(len(level_node_ids), dtype=np.int32)
    n_words = len(level_node_ids)

    # idf from document frequency (DBoW2 TF_IDF weighting)
    idf = np.ones(n_words, np.float32)
    if doc_id is not None:
        word_per_desc = word_id[level_node_ids[slot]]
        docs = np.asarray(doc_id)
        n_docs = len(np.unique(docs))
        pairs = np.unique(word_per_desc.astype(np.int64) * (docs.max() + 1) + docs)
        df = np.bincount((pairs // (docs.max() + 1)).astype(np.int64), minlength=n_words)
        idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32)
        idf = np.maximum(idf, 1e-3)
    return vocabulary_from_arrays(centers, children, word_id, idf, k, depth, device=dev)


def words_of(vocab: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """The word id [N] int32 (-1 where the descent ends on an inner node) of
    each descriptor [N, 8]: the tree descent, one level at a time."""
    n_nodes = vocab.centers.shape[0]
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for _ in range(vocab.depth):
        ch = vocab.children[node]                                  # [N, k]
        cen = vocab.centers[ch.clamp(0, n_nodes - 1).long()]       # [N, k, 8]
        d = _popcount_words(torch.bitwise_xor(cen, desc[:, None, :])).sum(-1)
        d = torch.where(ch >= 0, d, 1 << 16)
        best = torch.argmin(d, dim=-1)                             # first on ties
        nxt = torch.gather(ch, 1, best[:, None])[:, 0]
        node = torch.where(nxt >= 0, nxt.long(), node)             # stay on a leaf
    return vocab.word_id[node]


def bow_vector(vocab: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Frame descriptors [F, 8] -> (tf-idf L1-normalised BoW [n_words],
    word id of each feature [F], -1 where invalid)."""
    n_words = vocab.n_words
    w = words_of(vocab, desc)
    w_ok = valid & (w >= 0)
    tgt = torch.where(w_ok, w.clamp(0, n_words - 1), n_words).long()
    hist = torch.zeros(n_words + 1, dtype=torch.int32, device=desc.device)
    hist.index_add_(0, tgt, torch.ones_like(tgt, dtype=torch.int32))
    v = hist[:n_words].to(torch.float32) * vocab.idf
    norm = torch.clamp_min(torch.sum(torch.abs(v)), 1e-9)
    return v / norm, torch.where(w_ok, w, -1)


def l1_score(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 similarity 1 - 0.5 |a - b|_1; broadcasts [.., W] x [.., W]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(a - b), dim=-1)


class PlaceRecognizer:
    """Keyframe BoW database: a dense [K, n_words] matrix on the
    vocabulary's device, a row written at keyframe insertion; a query
    scores against all rows in one program and reads the K scores back.
    Relocalization candidates accumulate each score over the keyframe's
    best covisible neighbours and keep those within 75% of the best."""

    def __init__(self, vocab: Vocabulary, K: int):
        self.vocab = vocab
        self.kf_bow = torch.zeros((K, vocab.n_words), dtype=torch.float32,
                                  device=vocab.idf.device)
        self.present = np.zeros(K, bool)

    def add_keyframe(self, k: int, desc, valid):
        v, _ = bow_vector(self.vocab, desc, valid)
        self.kf_bow[k] = v
        self.present[k] = True

    def remove_keyframe(self, k: int):
        self.kf_bow[k] = 0.0
        self.present[k] = False

    def scores(self, desc, valid) -> np.ndarray:
        v, _ = bow_vector(self.vocab, desc, valid)
        s = l1_score(self.kf_bow, v[None, :]).cpu().numpy()
        s[~self.present] = -1.0
        return s

    def detect_relocalization_candidates(self, desc, valid, covis, exclude=(),
                                         n_max: int = 5):
        s = self.scores(desc, valid)
        for e in exclude:
            s[e] = -1.0
        if (s <= 0).all():
            return []
        # accumulate over covisibility groups (top-10 neighbours)
        cv = covis.cpu().numpy() if isinstance(covis, torch.Tensor) else np.asarray(covis)
        acc = s.copy()
        for k in np.nonzero(s > 0)[0]:
            nb = np.argsort(-cv[k])[:10]
            acc[k] = s[k] + s[nb][(cv[k][nb] > 0) & (s[nb] > 0)].sum()
        best = float(acc.max())
        keep = np.nonzero(acc >= 0.75 * best)[0]
        order = keep[np.argsort(-acc[keep])]
        return [int(k) for k in order[:n_max]]

    def detect_loop_candidates(self, desc, valid, covis_row, kf_id: int,
                               min_score: float, n_max: int = 5):
        """Loop candidates: scored at least min_score (the least BoW
        similarity among the querying keyframe's covisible neighbours) and
        not covisible with it. ``covis_row`` is the keyframe's row of the
        covisibility matrix (numpy [K]; a [K, K] matrix is read at kf_id)."""
        s = self.scores(desc, valid)
        row = np.asarray(covis_row)
        if row.ndim == 2:
            row = row[kf_id]
        s[kf_id] = -1.0
        s[row > 0] = -1.0          # the covisible neighbourhood is excluded
        cands = np.nonzero(s >= min_score)[0]
        order = cands[np.argsort(-s[cands])]
        return [int(k) for k in order[:n_max]]
