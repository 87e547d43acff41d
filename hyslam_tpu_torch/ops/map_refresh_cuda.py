"""Wrappers of kernels K2 (``csrc/covisibility.cu``) and K3
(``csrc/landmark_stats.cu``): the map's covisibility counts and its
landmarks' statistics, each in one call whose work follows the live
associations and observations, not the arena's capacity.

Neither replaces a TPU kernel: the JAX package computes both with XLA ops
(``hyslam_tpu/core/mapstate.py:refresh_covisibility``,
``update_landmark_stats``). Their plain PyTorch versions are
``core/mapstate.py:refresh_covisibility_plain`` and
``update_landmark_stats_plain``, which ``core/mapstate.py`` takes for CPU
tensors only; a tensor on any other device comes here, and a wrapper launches
its kernel or raises (``kernels.load()`` builds the library or raises).

Each wrapper counts its launches in ``.launches``. Both threads of the
threaded pipeline launch them (the tracking thread's keyframe refresh, the
mapping thread's jobs), so the counts are kept under a lock.
"""

from __future__ import annotations

import threading

import torch

from hyslam_tpu_torch import kernels
from hyslam_tpu_torch.kernels import check_tensor

MAX_OBS_SLOTS = 32   # observation slots a landmark: a row's lanes in K3

_count_lock = threading.Lock()


def _cuda_device(x: torch.Tensor) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {x.device}")
    return x.device


def _count(fn) -> None:
    with _count_lock:
        fn.launches += 1


def covisibility_cuda(lm_id: torch.Tensor, kp_valid: torch.Tensor,
                      kf_valid: torch.Tensor, kf_bad: torch.Tensor,
                      lm_valid: torch.Tensor, lm_bad: torch.Tensor) -> torch.Tensor:
    """[K, K] int32 counts of the live landmarks two keyframes share, from
    lm_id [K, F] int32, kp_valid [K, F], kf_valid / kf_bad [K] and
    lm_valid / lm_bad [L] bool, contiguous CUDA tensors on one device: what
    ``refresh_covisibility_plain`` puts in ``covis``, bit for bit. Raises on
    any other input, and if the kernel cannot be built or launched."""
    dev = _cuda_device(lm_id)
    if lm_id.dim() != 2:
        raise ValueError("expected lm_id [K, F]")
    K, F = lm_id.shape
    L = lm_valid.numel()
    if K <= 0 or F <= 0 or L <= 0:
        raise ValueError(f"need K, F, L >= 1, got K={K} F={F} L={L}")
    b = torch.bool
    check_tensor("lm_id", lm_id, (K, F), torch.int32, dev)
    check_tensor("kp_valid", kp_valid, (K, F), b, dev)
    check_tensor("kf_valid", kf_valid, (K,), b, dev)
    check_tensor("kf_bad", kf_bad, (K,), b, dev)
    check_tensor("lm_valid", lm_valid, (L,), b, dev)
    check_tensor("lm_bad", lm_bad, (L,), b, dev)

    lib = kernels.load()
    scratch = torch.empty(lib.hyslam_covisibility_scratch_ints(K, F, L),
                          dtype=torch.int32, device=dev)
    covis = torch.empty((K, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.hyslam_covisibility(
            lm_id.data_ptr(), kp_valid.data_ptr(), kf_valid.data_ptr(),
            kf_bad.data_ptr(), lm_valid.data_ptr(), lm_bad.data_ptr(), K, F, L,
            scratch.data_ptr(), covis.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, "covisibility kernel launch")
    _count(covisibility_cuda)
    return covis


covisibility_cuda.launches = 0


def landmark_stats_cuda(obs_kf: torch.Tensor, obs_feat: torch.Tensor,
                        obs_valid: torch.Tensor, Tcw: torch.Tensor, pos: torch.Tensor,
                        level: torch.Tensor, kf_desc: torch.Tensor, normal: torch.Tensor,
                        desc: torch.Tensor, min_dist: torch.Tensor,
                        max_dist: torch.Tensor, inv_scale_range: float):
    """The landmarks' (normal [L, 3], desc [L, 8], min_dist [L], max_dist [L])
    from their observations obs_kf / obs_feat [L, O] int32 and obs_valid
    [L, O] bool, the keyframes' Tcw [K, 4, 4], level [K, F] and desc
    [K, F, 8] int32, the landmarks' pos [L, 3], and their old values, which
    a row with no valid observation keeps: what
    ``update_landmark_stats_plain`` computes, the descriptor bit for bit and
    the floats to rounding (``csrc/landmark_stats.cu``). New tensors; the
    inputs are not written. Contiguous CUDA tensors on one device, float32
    and int32 as named, O <= 32. Raises on any other input, and if the kernel
    cannot be built or launched."""
    dev = _cuda_device(obs_kf)
    if obs_kf.dim() != 2 or Tcw.dim() != 3 or level.dim() != 2:
        raise ValueError("expected obs_kf [L, O], Tcw [K, 4, 4], level [K, F]")
    L, O = obs_kf.shape
    K, F = level.shape
    if not 0 < O <= MAX_OBS_SLOTS or L <= 0 or K <= 0 or F <= 0:
        raise ValueError(f"need L, K, F >= 1 and 1 <= O <= {MAX_OBS_SLOTS}, "
                         f"got L={L} O={O} K={K} F={F}")
    f32, i32 = torch.float32, torch.int32
    check_tensor("obs_kf", obs_kf, (L, O), i32, dev)
    check_tensor("obs_feat", obs_feat, (L, O), i32, dev)
    check_tensor("obs_valid", obs_valid, (L, O), torch.bool, dev)
    check_tensor("Tcw", Tcw, (K, 4, 4), f32, dev)
    check_tensor("pos", pos, (L, 3), f32, dev)
    check_tensor("level", level, (K, F), i32, dev)
    check_tensor("kf_desc", kf_desc, (K, F, 8), i32, dev)
    check_tensor("normal", normal, (L, 3), f32, dev)
    check_tensor("desc", desc, (L, 8), i32, dev)
    check_tensor("min_dist", min_dist, (L,), f32, dev)
    check_tensor("max_dist", max_dist, (L,), f32, dev)

    lib = kernels.load()
    out = (torch.empty_like(normal), torch.empty_like(desc),
           torch.empty_like(min_dist), torch.empty_like(max_dist))
    with torch.cuda.device(dev):
        code = lib.hyslam_landmark_stats(
            obs_kf.data_ptr(), obs_feat.data_ptr(), obs_valid.data_ptr(),
            Tcw.data_ptr(), pos.data_ptr(), level.data_ptr(), kf_desc.data_ptr(),
            normal.data_ptr(), desc.data_ptr(), min_dist.data_ptr(),
            max_dist.data_ptr(), K, F, L, O, float(inv_scale_range),
            *(x.data_ptr() for x in out), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check(lib, code, "landmark_stats kernel launch")
    _count(landmark_stats_cuda)
    return out


landmark_stats_cuda.launches = 0
