"""Two-view relative pose estimation: batched H/F RANSAC and motion recovery
(counterpart of ``hyslam_tpu/estimators/two_view.py``).

Every RANSAC hypothesis is one row of a batch: the 256 minimal sets are fit
by one batched ``eigh``, scored by one [S, M] tensor program, and the best
row is taken by ``argmax`` (the first of equal scores, as in the JAX
package). The fundamental model is selected against the homography by
RH = SH / (SH + SF) at 0.40.

- F-branch: the essential matrix's four (R, t) candidates, arbitrated by how
  many points triangulate in front of both cameras with parallax.
- H-branch: the Faugeras decomposition into 8 motion hypotheses, with the
  uniqueness gate (second best < 0.75 best) and the 90% triangulation rule.

The minimal sets are an argument. The JAX package draws them with
``jax.random``, which a torch generator cannot reproduce; ``sample_sets``
draws them from a ``torch.Generator`` seeded on the points' device (the
parity tests replace it with the JAX package's draws). The eigenvectors'
signs are arbitrary and differ between libraries and devices; the models are
used only up to scale, so no result here depends on them.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch.geometry import se3
from hyslam_tpu_torch.geometry.camera import Camera
from hyslam_tpu_torch.geometry.triangulation import projection_matrix, triangulate_dlt
from hyslam_tpu_torch.solver.ba import _inv3x3

N_HYPOTHESES = 256
CHI2_F = 3.84    # per-direction epipolar chi2 gate
CHI2_H = 5.991   # scoring offset (both models) and the H transfer-error gate
RH_SELECT = 0.40  # the homography is selected when SH / (SH + SF) > 0.40
MIN_TRIANGULATED = 50
MIN_FRAC_TRIANGULATED = 0.9  # H-branch: the best must triangulate 90% of inliers


def det3(A: torch.Tensor) -> torch.Tensor:
    """Batched closed-form determinant of [..., 3, 3] (``linalg.det`` would
    make an LU call, host-bound on a card)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def draw_valid(valid: torch.Tensor, n_sets: int, set_size: int,
               generator: torch.Generator) -> torch.Tensor:
    """[n_sets, set_size] row indices drawn uniformly from the rows where
    valid is True (padded rows would otherwise fill the minimal sets), on
    valid's device and without reading anything back."""
    order = torch.argsort((~valid).to(torch.int8), stable=True)    # valid rows first
    nv = torch.clamp_min(torch.sum(valid), 1)
    u = torch.rand((n_sets, set_size), generator=generator, device=valid.device)
    samp = torch.minimum((u * nv).long(), nv - 1)
    return order[samp]


def sample_sets(valid: torch.Tensor, seed: int = 0):
    """(F sets, H sets), each [N_HYPOTHESES, 8], from a generator seeded with
    ``seed`` on valid's device."""
    g = torch.Generator(device=valid.device).manual_seed(seed)
    return (draw_valid(valid, N_HYPOTHESES, 8, g), draw_valid(valid, N_HYPOTHESES, 8, g))


def _fit_fundamental(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point fundamental for a batch of minimal sets ([S,8,2] each) ->
    [S,3,3], rank 2."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)                  # [S, 8, 9]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    f = vecs[..., :, 0].reshape(*p1.shape[:-2], 3, 3)
    u, s, vt = torch.linalg.svd(f)
    s = s * torch.tensor([1.0, 1.0, 0.0], dtype=s.dtype, device=s.device)
    return (u * s[..., None, :]) @ vt


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[:, :1])], dim=-1)


def _epipolar_chi2(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor):
    """Epipolar transfer chi2 in both images for models F [S,3,3] and points
    [M,2] -> (d2 in image 1 [S,M], d2 in image 2 [S,M])."""
    x1, x2 = _homogeneous(p1), _homogeneous(p2)
    l2 = x1 @ F.transpose(-1, -2)        # lines in image 2, [S, M, 3]
    l1 = x2 @ F                          # lines in image 1
    num = torch.sum(x2 * l2, dim=-1) ** 2
    d2_2 = num / torch.clamp_min(l2[..., 0] ** 2 + l2[..., 1] ** 2, 1e-12)
    d2_1 = num / torch.clamp_min(l1[..., 0] ** 2 + l1[..., 1] ** 2, 1e-12)
    return d2_1, d2_2


def ransac_fundamental(p1, p2, valid, idx):
    """Batched RANSAC over the minimal sets idx [S,8]: [M,2]
    correspondences -> (best F, inlier mask [M], score). A point scores
    (5.991 - d2) in each direction where both are under the 3.84 gate."""
    Fs = _fit_fundamental(p1[idx], p2[idx])
    d1, d2 = _epipolar_chi2(Fs, p1, p2)
    ok = (d1 < CHI2_F) & (d2 < CHI2_F) & valid
    scores = torch.sum(torch.where(ok, (CHI2_H - d1) + (CHI2_H - d2), 0.0), dim=-1)
    best = torch.argmax(scores)
    return Fs[best], ok[best], scores[best]


def _normalize_points(p: torch.Tensor, valid: torch.Tensor):
    """Hartley normalization: shift to the valid centroid, scale each axis by
    its mean absolute deviation. Returns (normalized points [M,2], T [3,3]
    with pn_h = T p_h, and T's inverse in closed form)."""
    w = valid.to(p.dtype)
    n = torch.clamp_min(w.sum(), 1.0)
    mean = (p * w[:, None]).sum(0) / n
    dev = (torch.abs(p - mean) * w[:, None]).sum(0) / n
    s = 1.0 / torch.clamp_min(dev, 1e-9)
    pn = (p - mean) * s
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]), torch.stack([z, z, o])])
    Tinv = torch.stack([torch.stack([1.0 / s[0], z, mean[0]]),
                        torch.stack([z, 1.0 / s[1], mean[1]]), torch.stack([z, z, o])])
    return pn, T, Tinv


def _fit_homography(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """DLT homography for a batch of minimal sets ([S,8,2] each) -> H21
    [S,3,3] with p2_h ~ H21 p1_h."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    rows_a = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)                       # [S, 16, 9]
    _, vecs = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return vecs[..., :, 0].reshape(*p1.shape[:-2], 3, 3)


def _homography_chi2(H21, H12, p1, p2):
    """Transfer chi2 both ways for models [S,3,3]: p1 through H21 against p2,
    p2 through H12 against p1. Returns (d2 in image 1, d2 in image 2), [S,M]."""
    def xfer(H, x):
        y = x @ H.transpose(-1, -2)
        w = y[..., 2]
        wsafe = torch.where(torch.abs(w) < 1e-9, 1e-9, w)
        return y[..., :2] / wsafe[..., None]

    x1, x2 = _homogeneous(p1), _homogeneous(p2)
    d2_2 = torch.sum((xfer(H21, x1) - p2) ** 2, dim=-1)
    d2_1 = torch.sum((xfer(H12, x2) - p1) ** 2, dim=-1)
    return d2_1, d2_2


def ransac_homography(p1, p2, valid, idx):
    """Batched homography RANSAC over the minimal sets idx [S,8]: ->
    (best H21, inlier mask [M], score). Each transfer direction adds (5.991
    - chi2) below the gate; an inlier passes both. The sets are fit on
    Hartley-normalized coordinates and scored at full resolution."""
    pn1, T1, _ = _normalize_points(p1, valid)
    pn2, _, T2inv = _normalize_points(p2, valid)
    Hs = T2inv @ _fit_homography(pn1[idx], pn2[idx]) @ T1
    d1, d2 = _homography_chi2(Hs, _inv3x3(Hs), p1, p2)
    in1 = (d1 < CHI2_H) & valid
    in2 = (d2 < CHI2_H) & valid
    scores = (torch.sum(torch.where(in1, CHI2_H - d1, 0.0), dim=-1)
              + torch.sum(torch.where(in2, CHI2_H - d2, 0.0), dim=-1))
    best = torch.argmax(scores)
    return Hs[best], (in1 & in2)[best], scores[best]


def _triangulate_and_check(cam: Camera, T21: torch.Tensor, p1, p2, valid):
    """Triangulate every correspondence under each candidate motion T21
    [C,4,4] -> (X [C,M,3], good [C,M]): in front of both cameras,
    reprojection under 4 px^2 in both, and parallax (cos < 0.99998)."""
    K = cam.K(device=p1.device)
    P1 = projection_matrix(K, se3.identity(device=p1.device))
    P2 = projection_matrix(K, T21)                                  # [C, 3, 4]
    C, M = T21.shape[0], p1.shape[0]
    X = triangulate_dlt(P1.expand(C, M, 3, 4), P2[:, None].expand(C, M, 3, 4),
                        p1.expand(C, M, 2), p2.expand(C, M, 2))
    z1 = X[..., 2]
    z2 = se3.apply(T21[:, None], X)[..., 2]
    Xh = _homogeneous(X.reshape(C * M, 3)).reshape(C, M, 4)

    def reproj(P, uv):
        x = Xh @ P.transpose(-1, -2)
        return torch.sum((x[..., :2] / torch.clamp_min(x[..., 2:], 1e-9) - uv) ** 2, dim=-1)

    e1 = reproj(P1, p1)
    e2 = reproj(P2, p2)
    C2 = se3.translation(se3.inverse(T21))                          # [C, 3]
    r1, r2 = X, X - C2[:, None]
    cosp = torch.sum(r1 * r2, dim=-1) / torch.clamp_min(
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1), 1e-9)
    good = valid & (z1 > 0) & (z2 > 0) & (e1 < 4.0) & (e2 < 4.0) & (cosp < 0.99998)
    return X, good


def _unit(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp_min(torch.linalg.norm(t, dim=-1, keepdim=True), 1e-9)


def _recover_pose(cam: Camera, F, p1, p2, valid):
    """E = K^T F K -> 4 candidate (R, t), chosen by the cheirality vote.
    Returns (T21, X [M,3], good [M], votes of the best)."""
    K = cam.K(device=F.device)
    u, _, vt = torch.linalg.svd(K.T @ F @ K)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=F.dtype, device=F.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    R1 = R1 * torch.sign(det3(R1))
    R2 = R2 * torch.sign(det3(R2))
    t = _unit(u[:, 2])
    cands = se3.from_Rt(torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t]))
    X, good = _triangulate_and_check(cam, cands, p1, p2, valid)
    votes = torch.sum(good, dim=-1, dtype=torch.int32)
    best = torch.argmax(votes)
    return cands[best], X[best], good[best], votes[best]


def _recover_pose_homography(cam: Camera, H21, p1, p2, valid):
    """The Faugeras decomposition of A = K^-1 H K into 8 motion hypotheses
    (4 for d' = d2, 4 for d' = -d2), each checked by triangulation.
    Returns (T21, X, good, best votes, second votes, decomposable)."""
    dev, dt = H21.device, H21.dtype
    A = cam.K_inv(device=dev) @ H21 @ cam.K(device=dev)
    U, w, Vt = torch.linalg.svd(A)
    s = det3(U) * det3(Vt)
    d1, d2, d3 = w[0], w[1], w[2]
    # degenerate where singular values are (nearly) equal
    ok_decomp = (d1 / torch.clamp_min(d2, 1e-12) > 1.00001) & (
        d2 / torch.clamp_min(d3, 1e-12) > 1.00001)

    denom13 = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    aux1 = torch.sqrt(torch.clamp_min(d1 * d1 - d2 * d2, 0.0) / denom13)
    aux3 = torch.sqrt(torch.clamp_min(d2 * d2 - d3 * d3, 0.0) / denom13)
    sign1 = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=dt, device=dev)
    sign3 = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=dt, device=dev)
    sign_s = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=dt, device=dev)
    x1s, x3s = aux1 * sign1, aux3 * sign3
    num = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0))
    # case d' = d2
    st = num / torch.clamp_min((d1 + d3) * d2, 1e-12)
    ct = (d2 * d2 + d1 * d3) / torch.clamp_min((d1 + d3) * d2, 1e-12)
    # case d' = -d2
    sp = num / torch.clamp_min((d1 - d3) * d2, 1e-12)
    cp = (d1 * d3 - d2 * d2) / torch.clamp_min((d1 - d3) * d2, 1e-12)
    sth, sph = st * sign_s, sp * sign_s
    z, o = torch.zeros_like(sth), torch.ones_like(sth)
    ctv, cpv = ct.expand(4), cp.expand(4)
    Rp = torch.cat([
        torch.stack([torch.stack([ctv, z, -sth], -1), torch.stack([z, o, z], -1),
                     torch.stack([sth, z, ctv], -1)], -2),
        torch.stack([torch.stack([cpv, z, sph], -1), torch.stack([z, -o, z], -1),
                     torch.stack([sph, z, -cpv], -1)], -2)])        # [8, 3, 3]
    tp = torch.cat([(d1 - d3) * torch.stack([x1s, z, -x3s], -1),
                    (d1 + d3) * torch.stack([x1s, z, x3s], -1)])    # [8, 3]
    R = (s * U) @ Rp @ Vt
    t = _unit(tp @ U.T)
    cands = se3.from_Rt(R, t)
    X, good = _triangulate_and_check(cam, cands, p1, p2, valid)
    votes = torch.sum(good, dim=-1, dtype=torch.int32)
    best = torch.argmax(votes)
    second = torch.max(torch.where(torch.arange(8, device=dev) == best, -1, votes))
    return cands[best], X[best], good[best], votes[best], second, ok_decomp


def two_view_reconstruct(cam: Camera, uv1, uv2, idx, seed: int = 0, samples=None):
    """Matched features (uv1 [F,2], idx [F] into uv2 or -1) -> (ok, T21
    [4,4], X [F,3] points in frame 1, good [F]), or (False, None, None,
    None). ``samples`` is (F sets, H sets), each [N_HYPOTHESES, 8] rows of
    uv1; by default ``sample_sets(valid, seed)``.

    Both models are fit and the homography is selected where RH > 0.40. The
    F-branch needs >= 50 points that triangulate in front of both cameras
    with parallax; the H-branch also needs the best hypothesis to
    triangulate > 90% of the inliers and to beat the runner-up by 4/3.
    Pure rotation fails (nothing triangulates): the tracker waits for
    parallax. Three reads of device values: the two scores, and the counts
    of the branch taken."""
    valid = idx >= 0
    p1 = uv1
    p2 = uv2[idx.clamp(0, uv2.shape[0] - 1).long()]
    idx_f, idx_h = sample_sets(valid, seed) if samples is None else samples
    Fm, inlF, sF = ransac_fundamental(p1, p2, valid, idx_f.long())
    Hm, inlH, sH = ransac_homography(p1, p2, valid, idx_h.long())
    sH, sF = torch.stack([sH, sF]).tolist()
    # in float64 on the host, as the JAX package divides Python floats
    rh = sH / max(sH + sF, 1e-9)

    if rh > RH_SELECT:
        inlH = valid & inlH
        T21, X, good, best, second, ok_d = _recover_pose_homography(cam, Hm, p1, p2, inlH)
        n_best, n_second, n_inl, ok_d = torch.stack(
            [best, second, torch.sum(inlH, dtype=torch.int32), ok_d.to(torch.int32)]).tolist()
        ok = (bool(ok_d) and n_second < 0.75 * n_best and n_best >= MIN_TRIANGULATED
              and n_best > MIN_FRAC_TRIANGULATED * n_inl)
        return (True, T21, X, good) if ok else (False, None, None, None)

    T21, X, good, votes = _recover_pose(cam, Fm, p1, p2, valid & inlF)
    if int(votes) < MIN_TRIANGULATED:
        return False, None, None, None
    return True, T21, X, good
