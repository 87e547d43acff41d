"""MapState: fixed-capacity arenas for keyframes, landmarks, associations,
covisibility and the spanning tree (counterpart of
``hyslam_tpu/core/mapstate.py``), with the sub-map tree: ``create_submap``,
``register_submap``, ``set_active_map``, ``refresh_tiepoints`` and
``apply_transform_to_map``.

The state is NamedTuples of tensors with the JAX package's shapes and dtypes
(descriptors as int32 bit-views). Every function keeps the JAX semantics,
state in and new state out: what it writes it writes into a copy, so the
caller's state is never mutated. Nothing here reads a value back to the
host but ``refresh_tiepoints``, which walks the map table. Scatters follow ``ops/indexing.py``: dropped rows go to a pad row, and
of several rows writing one element the last one wins, as on XLA's CPU.

Conventions: keyframe and landmark ids are arena slots (int32), -1 = none;
"bad" entries keep their storage but drop out of every query; a fused
landmark points to its replacement through ``replaced_by``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from hyslam_tpu_torch.core.frame import FrameFeatures
from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.ops import indexing as ix
from hyslam_tpu_torch.ops.hamming import hamming_pairwise
from hyslam_tpu_torch.ops.map_refresh_cuda import covisibility_cuda, landmark_stats_cuda

# copied from hyslam_tpu/core/mapstate.py
COVIS_THRESHOLD = 15  # min shared landmarks for a covisibility edge
MAX_MAPS = 32         # sub-map tree capacity
RECYCLE_DELAY = 2     # mapper passes a freed landmark slot stays unallocatable
MAP_TREE_DEPTH = 8    # max nesting resolved by map_root()
# 1 / 1.2^8 in float32: XLA turns the JAX package's division by the constant
# into this product, and the port takes the same product to get the same bits
_INV_SCALE_RANGE = float(np.float32(1.0) / np.float32(1.2 ** 8))


class KeyFrameArena(NamedTuple):
    Tcw: torch.Tensor          # [K, 4, 4] f32
    timestamp: torch.Tensor    # [K] f32
    frame_id: torch.Tensor     # [K] int32
    cam_id: torch.Tensor       # [K] int32
    map_id: torch.Tensor       # [K] int32
    valid: torch.Tensor        # [K] bool slot allocated
    bad: torch.Tensor          # [K] bool culled
    origin: torch.Tensor       # [K] bool map-origin KF (never erased)
    span_parent: torch.Tensor  # [K] int32 spanning-tree parent (-1 root)
    Tcp: torch.Tensor          # [K, 4, 4] pose relative to span_parent, frozen
                               # at cull time
    uv: torch.Tensor           # [K, F, 2] f32
    ur: torch.Tensor           # [K, F] f32
    depth: torch.Tensor        # [K, F] f32
    level: torch.Tensor        # [K, F] int32
    angle: torch.Tensor        # [K, F] f32
    desc: torch.Tensor         # [K, F, 8] int32 bit-view
    kp_valid: torch.Tensor     # [K, F] bool
    lm_id: torch.Tensor        # [K, F] int32 feature -> landmark (-1)


class LandmarkArena(NamedTuple):
    pos: torch.Tensor          # [L, 3] f32
    normal: torch.Tensor       # [L, 3] f32 mean viewing direction
    desc: torch.Tensor         # [L, 8] int32 representative descriptor
    min_dist: torch.Tensor     # [L] f32 scale-invariance range
    max_dist: torch.Tensor     # [L] f32
    valid: torch.Tensor        # [L] bool
    bad: torch.Tensor          # [L] bool
    replaced_by: torch.Tensor  # [L] int32 fuse indirection (-1)
    protection: torch.Tensor   # [L] int32 new-point / recycle countdown
    map_id: torch.Tensor       # [L] int32
    first_kf: torch.Tensor     # [L] int32 creating KF
    n_obs: torch.Tensor        # [L] int32
    visible: torch.Tensor      # [L] int32
    found: torch.Tensor        # [L] int32
    obs_kf: torch.Tensor       # [L, O] int32 keyframe id
    obs_feat: torch.Tensor     # [L, O] int32 feature slot in that KF
    obs_valid: torch.Tensor    # [L, O] bool


class MapTable(NamedTuple):
    """Sub-map tree bookkeeping: a registered child joins its parent's
    queries (``map_root``), and its tiepoint transform feeds BA."""

    parent: torch.Tensor       # [M] int32 parent map id (-1 root)
    registered: torch.Tensor   # [M] bool
    active: torch.Tensor       # [] int32 active map id
    Tse3_parent: torch.Tensor  # [M, 4, 4] f32 tiepoint
    tie_kf: torch.Tensor       # [M] int32
    n_maps: torch.Tensor       # [] int32 allocation cursor


class MapState(NamedTuple):
    kf: KeyFrameArena
    lm: LandmarkArena
    maps: MapTable
    covis: torch.Tensor        # [K, K] int32 shared-landmark counts
    next_kf: torch.Tensor      # [] int32
    next_lm: torch.Tensor      # [] int32

    @property
    def K(self):
        return self.kf.Tcw.shape[0]

    @property
    def L(self):
        return self.lm.pos.shape[0]

    @property
    def F(self):
        return self.kf.uv.shape[1]

    @property
    def O(self):
        return self.lm.obs_kf.shape[1]


class MapCaps(NamedTuple):
    """Static arena capacities."""

    K: int = 256      # keyframes
    L: int = 16384    # landmarks
    F: int = 1024     # features per keyframe
    O: int = 16       # observations per landmark


def empty_map_state(caps: MapCaps = MapCaps(), device=None) -> MapState:
    K, L, F, O = caps.K, caps.L, caps.F, caps.O
    f32, i32 = torch.float32, torch.int32

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device=device)

    def eyes(n):
        return torch.eye(4, dtype=f32, device=device).repeat(n, 1, 1)

    kf = KeyFrameArena(
        Tcw=eyes(K), timestamp=full((K,), 0.0, f32), frame_id=full((K,), -1, i32),
        cam_id=full((K,), 0, i32), map_id=full((K,), 0, i32),
        valid=full((K,), False, torch.bool), bad=full((K,), False, torch.bool),
        origin=full((K,), False, torch.bool), span_parent=full((K,), -1, i32),
        Tcp=eyes(K), uv=full((K, F, 2), 0.0, f32), ur=full((K, F), -1.0, f32),
        depth=full((K, F), -1.0, f32), level=full((K, F), 0, i32),
        angle=full((K, F), 0.0, f32), desc=full((K, F, 8), 0, i32),
        kp_valid=full((K, F), False, torch.bool), lm_id=full((K, F), -1, i32),
    )
    lm = LandmarkArena(
        pos=full((L, 3), 0.0, f32), normal=full((L, 3), 0.0, f32),
        desc=full((L, 8), 0, i32), min_dist=full((L,), 0.0, f32),
        max_dist=full((L,), float("inf"), f32), valid=full((L,), False, torch.bool),
        bad=full((L,), False, torch.bool), replaced_by=full((L,), -1, i32),
        protection=full((L,), 0, i32), map_id=full((L,), 0, i32),
        first_kf=full((L,), -1, i32), n_obs=full((L,), 0, i32),
        visible=full((L,), 0, i32), found=full((L,), 0, i32),
        obs_kf=full((L, O), -1, i32), obs_feat=full((L, O), -1, i32),
        obs_valid=full((L, O), False, torch.bool),
    )
    maps = MapTable(
        parent=full((MAX_MAPS,), -1, i32),
        registered=full((MAX_MAPS,), False, torch.bool),
        active=full((), 0, i32), Tse3_parent=eyes(MAX_MAPS),
        tie_kf=full((MAX_MAPS,), -1, i32), n_maps=full((), 1, i32),
    )
    return MapState(kf=kf, lm=lm, maps=maps, covis=full((K, K), 0, i32),
                    next_kf=full((), 0, i32), next_lm=full((), 0, i32))


# ---------------------------------------------------------------------------
# multi-map visibility
# ---------------------------------------------------------------------------

def map_root(maps: MapTable, map_id: torch.Tensor) -> torch.Tensor:
    """Resolve map ids to their registration root: walk parents while the
    child is registered, MAP_TREE_DEPTH steps."""
    mid = map_id.reshape(-1)
    for _ in range(MAP_TREE_DEPTH):
        c = mid.clamp(0, MAX_MAPS - 1).long()
        mid = torch.where(maps.registered[c] & (maps.parent[c] >= 0),
                          maps.parent[c], mid)
    return mid.reshape(map_id.shape)


def visible_scope(ms: MapState):
    """(kf_in_scope [K], lm_in_scope [L]) for the active map."""
    active_root = map_root(ms.maps, ms.maps.active)
    kf_ok = ms.kf.valid & ~ms.kf.bad & (map_root(ms.maps, ms.kf.map_id) == active_root)
    lm_ok = ms.lm.valid & ~ms.lm.bad & (map_root(ms.maps, ms.lm.map_id) == active_root)
    return kf_ok, lm_ok


# ---------------------------------------------------------------------------
# allocation + association
# ---------------------------------------------------------------------------

def _scalar(v, dtype, device) -> torch.Tensor:
    """A Python number or tensor -> a 1-element tensor of dtype on device."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype=dtype, device=device).reshape(1)
    return torch.full((1,), v, dtype=dtype, device=device)


def add_keyframe(ms: MapState, feats: FrameFeatures, Tcw: torch.Tensor,
                 timestamp, frame_id, cam_id, lm_assoc: torch.Tensor,
                 origin=False):
    """Insert a keyframe at the allocation cursor with its features and the
    frame's landmark associations [F] (-1 = none); each associated landmark
    gets the observation (kf, feat). Returns (ms, k), k a 0-d tensor."""
    k = ms.next_kf
    kv = (k.reshape(1).long(),)
    kf = ms.kf
    dev = kf.Tcw.device

    def row(x, v):
        return x.index_put(kv, v.to(x.dtype)[None])

    def one(x, v):
        return x.index_put(kv, _scalar(v, x.dtype, dev))

    kf = kf._replace(
        Tcw=row(kf.Tcw, Tcw), timestamp=one(kf.timestamp, timestamp),
        frame_id=one(kf.frame_id, frame_id), cam_id=one(kf.cam_id, cam_id),
        map_id=one(kf.map_id, ms.maps.active), valid=one(kf.valid, True),
        bad=one(kf.bad, False), origin=one(kf.origin, origin),
        uv=row(kf.uv, feats.uv), ur=row(kf.ur, feats.ur),
        depth=row(kf.depth, feats.depth), level=row(kf.level, feats.level),
        angle=row(kf.angle, feats.angle), desc=row(kf.desc, feats.desc),
        kp_valid=row(kf.kp_valid, feats.valid),
        lm_id=row(kf.lm_id, torch.where(feats.valid, lm_assoc, -1)),
    )
    ms = ms._replace(kf=kf, next_kf=k + 1)
    F = ms.F
    ms = _append_observations(
        ms, k, torch.arange(F, dtype=torch.int32, device=dev), lm_assoc,
        feats.valid)
    return ms, k


def _append_observations(ms: MapState, k, feat_idx, lm_idx, mask) -> MapState:
    """Append (k, feat) to each landmark's observation list, in its first
    free slot; mask selects real associations. A landmark named by several
    rows gets the last row's observation and n_obs raised once per row, as
    the JAX package's scatters do."""
    L, O = ms.L, ms.O
    lm = ms.lm
    safe = lm_idx.clamp(0, L - 1).long()
    ok = mask & (lm_idx >= 0)
    free = torch.argmin(lm.obs_valid.to(torch.int8), dim=-1)     # first False
    has_room = ~torch.all(lm.obs_valid, dim=-1)
    ok = ok & has_room[safe]
    slot = free[safe]
    idx = (safe, slot)
    tgt = ix.route(L, idx, ix.last_writer((L, O), idx, ok))
    n = ok.shape[0]
    return ms._replace(lm=lm._replace(
        obs_kf=ix.put(lm.obs_kf, tgt, ix.rows_of(k, n, safe.device)),
        obs_feat=ix.put(lm.obs_feat, tgt, feat_idx),
        obs_valid=ix.put(lm.obs_valid, tgt, True),
        n_obs=ix.add(lm.n_obs, ix.route(L, (safe,), ok), 1),
    ))


def add_landmarks(ms: MapState, pos: torch.Tensor, desc: torch.Tensor, kf_id,
                  feat_idx: torch.Tensor, mask: torch.Tensor,
                  protection: int = 3):
    """Batch-allocate landmarks and bind them to (kf_id, feat). Virgin slots
    first in ascending order, then recycled ones (bad rows whose
    RECYCLE_DELAY countdown has run out). Returns (ms, lm_indices [N] int32,
    -1 where masked out or the arena is full)."""
    L = ms.L
    lm = ms.lm
    dev = pos.device
    virgin = ~lm.valid
    recycled = lm.valid & lm.bad & (lm.protection <= 0)
    n_free = torch.sum(virgin | recycled)
    idx = torch.arange(L, device=dev)
    key = torch.where(virgin, idx, torch.where(recycled, L + idx, 2 * L + idx))
    order = torch.argsort(key, stable=True)
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    ok = mask & (rank < n_free)
    slots = order[rank.clamp(0, L - 1)]
    tgt = ix.route(L, (slots,), ok)
    lm = lm._replace(
        pos=ix.put(lm.pos, tgt, pos), desc=ix.put(lm.desc, tgt, desc),
        valid=ix.put(lm.valid, tgt, True), bad=ix.put(lm.bad, tgt, False),
        replaced_by=ix.put(lm.replaced_by, tgt, -1),
        protection=ix.put(lm.protection, tgt, protection),
        map_id=ix.put(lm.map_id, tgt, ms.maps.active),
        first_kf=ix.put(lm.first_kf, tgt, ix.rows_of(kf_id, pos.shape[0], dev)),
        n_obs=ix.put(lm.n_obs, tgt, 0), visible=ix.put(lm.visible, tgt, 1),
        found=ix.put(lm.found, tgt, 1), obs_kf=ix.put(lm.obs_kf, tgt, -1),
        obs_feat=ix.put(lm.obs_feat, tgt, -1),
        obs_valid=ix.put(lm.obs_valid, tgt, False),
    )
    # a recycled row may still be named by keyframes that held the bad
    # landmark (a frame's association kept past its culling): the name then
    # aliases the new landmark. Names held by keyframes of another map than
    # the active one are cleared: kept, they forge a covisibility between
    # the two maps that hides the loop between them from detection. Within
    # the active map the alias stays, as in the JAX package.
    fresh = ix.put(torch.zeros(L, dtype=torch.bool, device=dev), tgt, True)
    ref = ms.kf.lm_id
    other = (ms.kf.map_id != ms.maps.active)[:, None]
    kf = ms.kf._replace(lm_id=torch.where(
        other & (ref >= 0) & fresh[ref.clamp(0, L - 1).long()], -1, ref))
    ms = ms._replace(lm=lm, kf=kf, next_lm=ms.next_lm + torch.sum(ok, dtype=torch.int32))
    out_idx = torch.where(ok, slots.clamp(0, L - 1), -1).to(torch.int32)
    ms = add_associations(ms, kf_id, feat_idx, out_idx, ok)
    return ms, out_idx


def add_associations(ms: MapState, k, feat_idx, lm_idx, mask) -> MapState:
    """Associate (kf k, feature slots) -> landmarks on both sides; batched
    over features of one KF."""
    K, F = ms.K, ms.F
    ok = mask & (lm_idx >= 0) & (feat_idx >= 0)
    fi = feat_idx.clamp(0, F - 1)
    idx = (ix.rows_of(k, ok.shape[0], ok.device), fi)
    lm_col = ix.put(ms.kf.lm_id, ix.route(K, idx, ix.last_writer((K, F), idx, ok)),
                    lm_idx)
    ms = ms._replace(kf=ms.kf._replace(lm_id=lm_col))
    return _append_observations(ms, k, fi, torch.where(ok, lm_idx, -1), ok)


def erase_associations(ms: MapState, k, feat_idx, mask) -> MapState:
    """Remove the associations of (kf k, feature slots) on both sides."""
    K, L, F = ms.K, ms.L, ms.F
    fi = feat_idx.clamp(0, F - 1).long()
    kr = ix.rows_of(k, fi.shape[0], fi.device)
    lm_idx = ms.kf.lm_id[kr, fi]
    ok = mask & (lm_idx >= 0)
    safe = lm_idx.clamp(0, L - 1).long()
    kf_lm = ix.put(ms.kf.lm_id, ix.route(K, (kr, fi), ok), -1)
    lm = ms.lm
    match = (lm.obs_kf[safe] == kr[:, None].to(torch.int32)) & lm.obs_valid[safe]
    slot = torch.argmax(match.to(torch.int8), dim=-1)
    found = torch.any(match, dim=-1) & ok
    return ms._replace(
        kf=ms.kf._replace(lm_id=kf_lm),
        lm=lm._replace(
            obs_valid=ix.put(lm.obs_valid, ix.route(L, (safe, slot), found), False),
            n_obs=ix.add(lm.n_obs, ix.route(L, (safe,), found), -1)),
    )


def erase_observations(ms: MapState, lm_rows: torch.Tensor, slots: torch.Tensor,
                       mask: torch.Tensor) -> MapState:
    """Remove specific (landmark, obs-slot) observations and the matching
    KF-side references (outlier erasure after BA)."""
    K, L, O, F = ms.K, ms.L, ms.O, ms.F
    ok = mask & (lm_rows >= 0) & (slots >= 0)
    lr = lm_rows.clamp(0, L - 1).long()
    sl = slots.clamp(0, O - 1).long()
    ok = ok & ms.lm.obs_valid[lr, sl]
    kf_i = ms.lm.obs_kf[lr, sl].clamp(0, K - 1)
    feat_i = ms.lm.obs_feat[lr, sl].clamp(0, F - 1)
    lm = ms.lm._replace(
        obs_valid=ix.put(ms.lm.obs_valid, ix.route(L, (lr, sl), ok), False),
        n_obs=ix.add(ms.lm.n_obs, ix.route(L, (lr,), ok), -1),
    )
    kf = ms.kf._replace(lm_id=ix.put(ms.kf.lm_id, ix.route(K, (kf_i, feat_i), ok), -1))
    return ms._replace(lm=lm, kf=kf)


def kf_features(ms: MapState, k) -> FrameFeatures:
    """Keyframe k's stored features as a FrameFeatures bundle."""
    kf = ms.kf
    return FrameFeatures(
        uv=ix.take(kf.uv, k), ur=ix.take(kf.ur, k), depth=ix.take(kf.depth, k),
        level=ix.take(kf.level, k), angle=ix.take(kf.angle, k),
        desc=ix.take(kf.desc, k), valid=ix.take(kf.kp_valid, k),
    )


def camera_centers(ms: MapState) -> torch.Tensor:
    """[K, 3] world-frame camera centres of all keyframes."""
    R = ms.kf.Tcw[:, :3, :3]
    t = ms.kf.Tcw[:, :3, 3]
    return -torch.einsum("kji,kj->ki", R, t)


def n_live_landmarks(ms: MapState) -> torch.Tensor:
    """Count of live landmarks (valid and not bad)."""
    return torch.sum(ms.lm.valid & ~ms.lm.bad, dtype=torch.int32)


def resolve_landmarks(ms: MapState, lm_idx: torch.Tensor) -> torch.Tensor:
    """Follow one step of replacement indirection and mask bad or invalid
    landmarks to -1."""
    L = ms.L
    rep = ms.lm.replaced_by[lm_idx.clamp(0, L - 1).long()]
    idx2 = torch.where((lm_idx >= 0) & (rep >= 0), rep, lm_idx)
    c = idx2.clamp(0, L - 1).long()
    ok = (idx2 >= 0) & ms.lm.valid[c] & ~ms.lm.bad[c]
    return torch.where(ok, idx2, -1)


# ---------------------------------------------------------------------------
# covisibility + spanning tree
# ---------------------------------------------------------------------------

def incidence_matrix(ms: MapState) -> torch.Tensor:
    """[K, L] bool: keyframe k observes landmark l (KF-side associations)."""
    K, L = ms.K, ms.L
    lm_id = ms.kf.lm_id
    ok = (lm_id >= 0) & ms.kf.kp_valid & ms.kf.valid[:, None] & ~ms.kf.bad[:, None]
    tgt = torch.where(ok, lm_id.clamp(0, L - 1).long(), L)
    rows = torch.arange(K, device=lm_id.device)[:, None].expand(lm_id.shape)
    inc = torch.zeros((K, L + 1), dtype=torch.bool, device=lm_id.device)
    inc.index_put_((rows, tgt), torch.ones((), dtype=torch.bool, device=lm_id.device))
    return inc[:, :L]


def refresh_covisibility(ms: MapState) -> MapState:
    """Recompute the covisibility weights: the live landmarks each pair of
    keyframes shares on the keyframe side. On CPU tensors the plain version
    below; on any other device kernel K2 (``ops/map_refresh_cuda.py``), whose
    work follows the live associations and which gives the plain version's
    bits or raises: there is no fallback on the card."""
    if ms.covis.device.type == "cpu":
        return refresh_covisibility_plain(ms)
    kf, lm = ms.kf, ms.lm
    return ms._replace(covis=covisibility_cuda(*(x.contiguous() for x in (
        kf.lm_id, kf.kp_valid, kf.valid, kf.bad, lm.valid, lm.bad))))


def refresh_covisibility_plain(ms: MapState) -> MapState:
    """refresh_covisibility as I @ I^T over the association incidence
    [K, L]. The 0/1 product is taken in float32 (TF32 off): the JAX
    package multiplies in bf16 with f32 accumulation, and a bf16 product in
    torch would round counts above 256; f32 keeps every count exact."""
    inc = incidence_matrix(ms).to(torch.float32)
    inc = inc * (ms.lm.valid & ~ms.lm.bad).to(torch.float32)[None, :]
    covis = (inc @ inc.T).to(torch.int32)
    return ms._replace(covis=covis.fill_diagonal_(0))


def covis_neighbors(ms: MapState, k, n_best: int, min_weight: int = COVIS_THRESHOLD):
    """Top-n covisible neighbour ids + weights of keyframe k (-1 where the
    weight is below min_weight)."""
    w = torch.where(ms.kf.valid & ~ms.kf.bad, ix.take(ms.covis, k), 0)
    w = torch.where(w >= min_weight, w, 0)
    top_w, top_i = ix.top_k(w, n_best)
    return torch.where(top_w > 0, top_i, -1), top_w


def compute_spanning_parents(ms: MapState) -> MapState:
    """Parent of each live keyframe = the earlier live keyframe sharing the
    most landmarks; culled keyframes keep their frozen parent."""
    K = ms.K
    idx = torch.arange(K, device=ms.covis.device)
    live = ms.kf.valid & ~ms.kf.bad
    ok = (idx[None, :] < idx[:, None]) & live[None, :]
    w = torch.where(ok, ms.covis, -1)
    best = torch.argmax(w, dim=-1)
    has = torch.amax(w, dim=-1) > 0
    parent = torch.where(live, torch.where(has, best, -1), ms.kf.span_parent)
    return ms._replace(kf=ms.kf._replace(span_parent=parent.to(torch.int32)))


# ---------------------------------------------------------------------------
# landmark statistics
# ---------------------------------------------------------------------------

def update_landmark_stats(ms: MapState) -> MapState:
    """Recompute normals, distance-invariance ranges and representative
    descriptors of all landmarks (the observation descriptor with the least
    total Hamming distance to the others); a landmark with no valid
    observation keeps its values. On CPU tensors the plain version below; on
    any other device kernel K3 (``ops/map_refresh_cuda.py``), whose work
    follows the live observations, with the plain version's descriptors bit
    for bit and its floats to rounding, or which raises: there is no
    fallback on the card."""
    if ms.lm.pos.device.type == "cpu":
        return update_landmark_stats_plain(ms)
    kf, lm = ms.kf, ms.lm
    normal, desc, min_dist, max_dist = landmark_stats_cuda(
        *(x.contiguous() for x in (
            lm.obs_kf, lm.obs_feat, lm.obs_valid, kf.Tcw, lm.pos, kf.level, kf.desc,
            lm.normal, lm.desc, lm.min_dist, lm.max_dist)),
        _INV_SCALE_RANGE)
    return ms._replace(lm=lm._replace(normal=normal, desc=desc, min_dist=min_dist,
                                      max_dist=max_dist))


def update_landmark_stats_plain(ms: MapState) -> MapState:
    """update_landmark_stats in one batched pass over every landmark slot
    and every pair of observation slots ([L, O, O] distances)."""
    kfc = ms.lm.obs_kf.clamp(0, ms.K - 1).long()
    featc = ms.lm.obs_feat.clamp(0, ms.F - 1).long()
    ov = ms.lm.obs_valid
    T = ms.kf.Tcw[kfc]                                       # [L,O,4,4]
    centers = -torch.einsum("...ji,...j->...i", T[..., :3, :3], T[..., :3, 3])
    vec = ms.lm.pos[:, None, :] - centers
    dist = torch.linalg.norm(vec, dim=-1)
    unit = vec / torch.clamp_min(dist[..., None], 1e-9)
    wsum = torch.clamp_min(torch.sum(ov, dim=-1), 1)
    normal = torch.sum(torch.where(ov[..., None], unit, 0.0), dim=1) / wsum[:, None]

    scale = torch.pow(1.2, ms.kf.level[kfc, featc].to(torch.float32))
    mean_dist = torch.sum(torch.where(ov, dist, 0.0), dim=-1) / wsum
    ref_scale = torch.sum(torch.where(ov, scale, 0.0), dim=-1) / wsum
    max_dist = mean_dist * ref_scale
    min_dist = max_dist * _INV_SCALE_RANGE

    descs = ms.kf.desc[kfc, featc]                           # [L,O,8]
    d = hamming_pairwise(descs[:, :, None, :], descs[:, None, :, :])  # [L,O,O]
    pairmask = ov[:, :, None] & ov[:, None, :]
    tot = torch.sum(torch.where(pairmask, d, 0), dim=-1) + torch.where(ov, 0, 1 << 20)
    best = torch.argmin(tot, dim=-1)
    best_desc = torch.gather(descs, 1, best[:, None, None].expand(-1, 1, 8))[:, 0]
    has_obs = torch.any(ov, dim=-1)
    lm = ms.lm._replace(
        normal=torch.where(has_obs[:, None], normal, ms.lm.normal),
        min_dist=torch.where(has_obs, min_dist, ms.lm.min_dist),
        max_dist=torch.where(has_obs, max_dist, ms.lm.max_dist),
        desc=torch.where(has_obs[:, None], best_desc, ms.lm.desc),
    )
    return ms._replace(lm=lm)


# ---------------------------------------------------------------------------
# bad-marking / replacement
# ---------------------------------------------------------------------------

def set_landmarks_bad(ms: MapState, bad_mask: torch.Tensor) -> MapState:
    """Mark landmarks bad and detach them from all keyframes; a bad row
    becomes recyclable after RECYCLE_DELAY mapper passes."""
    bad_mask = bad_mask & ms.lm.valid
    lm = ms.lm._replace(
        bad=ms.lm.bad | bad_mask,
        obs_valid=ms.lm.obs_valid & ~bad_mask[:, None],
        n_obs=torch.where(bad_mask, 0, ms.lm.n_obs),
        protection=torch.where(bad_mask, RECYCLE_DELAY, ms.lm.protection),
    )
    hit = (ms.kf.lm_id >= 0) & bad_mask[ms.kf.lm_id.clamp(0, ms.L - 1).long()]
    kf = ms.kf._replace(lm_id=torch.where(hit, -1, ms.kf.lm_id))
    return ms._replace(lm=lm, kf=kf)


def replace_landmarks(ms: MapState, src: torch.Tensor, dst: torch.Tensor,
                      mask: torch.Tensor) -> MapState:
    """Fuse: each src landmark is replaced by dst (src marked bad, KF
    references rewritten src -> dst). Observation lists are not merged."""
    L = ms.L
    ok = mask & (src >= 0) & (dst >= 0) & (src != dst)
    srcc = src.clamp(0, L - 1)
    tgt = ix.route(L, (srcc,), ok)
    last = ix.route(L, (srcc,), ix.last_writer((L,), (srcc,), ok))
    table = ix.put(torch.arange(L, dtype=torch.int32, device=src.device), last, dst)
    kf_ref = ms.kf.lm_id
    kf_new = torch.where(kf_ref >= 0, table[kf_ref.clamp(0, L - 1).long()], kf_ref)
    lm = ms.lm._replace(
        replaced_by=ix.put(ms.lm.replaced_by, last, dst),
        bad=ix.put(ms.lm.bad, tgt, True),
        obs_valid=ix.put(ms.lm.obs_valid, tgt, False),
        protection=ix.put(ms.lm.protection, tgt, RECYCLE_DELAY),
    )
    return ms._replace(lm=lm, kf=ms.kf._replace(lm_id=kf_new))


def set_keyframes_bad(ms: MapState, bad_mask: torch.Tensor) -> MapState:
    """Cull keyframes: mark bad, drop their observations from landmarks,
    lift spanning-tree children to the nearest live ancestor, and freeze
    each culled keyframe's pose relative to its parent (Tcp). Origin
    keyframes are never erased."""
    K = ms.K
    bad_mask = bad_mask & ms.kf.valid & ~ms.kf.origin
    drop = ms.lm.obs_valid & bad_mask[ms.lm.obs_kf.clamp(0, K - 1).long()]
    lm = ms.lm._replace(
        obs_valid=ms.lm.obs_valid & ~drop,
        n_obs=torch.clamp_min(ms.lm.n_obs - torch.sum(drop, dim=-1, dtype=torch.int32), 0),
    )
    par = ms.kf.span_parent
    new_par = par
    for _ in range(MAP_TREE_DEPTH):
        pc = new_par.clamp(0, K - 1).long()
        new_par = torch.where((new_par >= 0) & bad_mask[pc], par[pc], new_par)
    Tcw = ms.kf.Tcw
    Tcp_new = Tcw @ se3.inverse(Tcw[new_par.clamp(0, K - 1).long()])
    freeze = bad_mask & (new_par >= 0)
    Tcp = torch.where(freeze[:, None, None], Tcp_new, ms.kf.Tcp)
    p0c = par.clamp(0, K - 1).long()
    inherit = ms.kf.bad & (par >= 0) & bad_mask[p0c]
    Tcp = torch.where(inherit[:, None, None], ms.kf.Tcp @ Tcp_new[p0c], Tcp)
    kf = ms.kf._replace(
        bad=ms.kf.bad | bad_mask,
        lm_id=torch.where(bad_mask[:, None], -1, ms.kf.lm_id),
        span_parent=new_par, Tcp=Tcp,
    )
    return ms._replace(kf=kf, lm=lm)


# ---------------------------------------------------------------------------
# sub-map tree
# ---------------------------------------------------------------------------

def _at(x: torch.Tensor, i, v) -> torch.Tensor:
    """A copy of x with x[i] = v, i a Python int or a 0-d tensor (written as
    a 1-element scatter, so a tensor index is not read back)."""
    dev = x.device
    iv = (i.reshape(1).long() if isinstance(i, torch.Tensor)
          else torch.full((1,), int(i), dtype=torch.int64, device=dev))
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v)
    return x.index_put((iv,), v.to(dtype=x.dtype, device=dev)[None])


def create_submap(ms: MapState, set_active: bool = True):
    """Allocate a child of the active map and optionally make it active
    (Map::createSubMap). Returns (ms, new_map_id), the id a 0-d tensor. The
    caller keeps the table within MAX_MAPS."""
    mid = ms.maps.n_maps
    maps = ms.maps._replace(
        parent=_at(ms.maps.parent, mid, ms.maps.active),
        registered=_at(ms.maps.registered, mid, False),
        n_maps=mid + 1,
        active=mid.clone() if set_active else ms.maps.active,
    )
    return ms._replace(maps=maps), mid


def register_submap(ms: MapState, map_id, Tse3_parent=None, tie_kf=-1) -> MapState:
    """Register a sub-map with its parent: its keyframes and landmarks join
    the parent's queries (root resolution) and the tiepoint transform feeds
    BA residuals."""
    maps = ms.maps._replace(registered=_at(ms.maps.registered, map_id, True))
    if Tse3_parent is not None:
        maps = maps._replace(
            Tse3_parent=_at(maps.Tse3_parent, map_id, Tse3_parent),
            tie_kf=_at(maps.tie_kf, map_id, tie_kf),
        )
    return ms._replace(maps=maps)


def set_active_map(ms: MapState, map_id) -> MapState:
    active = (map_id.to(torch.int32).reshape(()) if isinstance(map_id, torch.Tensor)
              else torch.full((), int(map_id), dtype=torch.int32,
                              device=ms.maps.active.device))
    return ms._replace(maps=ms.maps._replace(active=active))


def refresh_tiepoints(ms: MapState) -> MapState:
    """Re-measure every registered sub-map's tiepoint from the current poses
    (Tse3_parent = Tcw_origin @ Tcw_tie^-1). For use after a loop closure has
    re-placed sub-maps: a stale tiepoint prior would drag global BA back.
    Reads the map table to the host."""
    maps = ms.maps
    n = int(maps.n_maps)
    reg = maps.registered.cpu().numpy()
    ties = maps.tie_kf.cpu().numpy()
    origin = (ms.kf.origin & ms.kf.valid).cpu().numpy()
    kf_map = ms.kf.map_id.cpu().numpy()
    Tse3 = maps.Tse3_parent
    for m in range(min(n, MAX_MAPS)):
        if not reg[m] or ties[m] < 0:
            continue
        child = np.nonzero(origin & (kf_map == m))[0]
        if len(child) == 0:
            continue
        T = ms.kf.Tcw[int(child[0])] @ se3.inverse(ms.kf.Tcw[int(ties[m])])
        Tse3 = _at(Tse3, m, T)
    return ms._replace(maps=maps._replace(Tse3_parent=Tse3))


def apply_transform_to_map(ms: MapState, map_id, T: torch.Tensor) -> MapState:
    """Rigidly move every keyframe pose and landmark of one sub-map:
    Tcw' = Tcw @ T^-1, X' = T X."""
    Tinv = se3.inverse(T)
    in_map_kf = ms.kf.valid & (ms.kf.map_id == map_id)
    in_map_lm = ms.lm.valid & (ms.lm.map_id == map_id)
    new_Tcw = torch.where(in_map_kf[:, None, None], ms.kf.Tcw @ Tinv, ms.kf.Tcw)
    new_pos = torch.where(in_map_lm[:, None], se3.apply(T, ms.lm.pos), ms.lm.pos)
    return ms._replace(kf=ms.kf._replace(Tcw=new_Tcw), lm=ms.lm._replace(pos=new_pos))
