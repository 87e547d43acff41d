"""Wrapper of kernel K1 (``csrc/pose_opt.cu``), the whole pose-only LM
schedule in one launch: the counterpart of
``hyslam_tpu/ops/pose_opt_pallas.py:pose_optimization_pallas``.

Its plain PyTorch version is ``solver/pose_opt.py:pose_optimization``. The
JAX package's capability probe ``pallas_supported`` chose between the Pallas
kernel and the XLA version at run time; here the counterpart of that probe is
``kernels.load()``, which builds and loads the library or raises, so no
probe result can select the plain version for a CUDA tensor.
"""

from __future__ import annotations

import torch

from hyslam_tpu_torch import kernels
from hyslam_tpu_torch.kernels import check_tensor
from hyslam_tpu_torch.geometry.camera import Camera

MAX_OBS = 4096   # observations per problem: kMaxObs in csrc/pose_opt.cu


def pose_optimization_cuda(
    cam: Camera,
    Tcw0: torch.Tensor,        # [B, 4, 4] f32
    X: torch.Tensor,           # [B, N, 3] f32
    uv: torch.Tensor,          # [B, N, 2] f32
    ur: torch.Tensor,          # [B, N] f32
    inv_sigma2: torch.Tensor,  # [B, N] f32
    valid: torch.Tensor,       # [B, N] bool
    stereo: torch.Tensor,      # [B, N] bool
    n_rounds: int = 4,
    iters_per_round: int = 10,
):
    """Run B independent pose problems, one thread block each, in one
    kernel launch and no other device work, for any N <= 4096 (up to 1024
    observations in registers, the rest in shared memory). The inputs are contiguous CUDA
    tensors on one device, float32 but for the two bool masks. Rows that
    are not valid take part in no sum but must hold finite values, as for
    the plain version (the kernel weights them 0 and does not branch around
    them). Returns (Tcw [B,4,4] f32, inliers [B,N] bool, num_inliers [B]
    int32, chi2 [B,N] f32: the final per-observation chi2, 1e9 at or behind
    z = 0.05). One problem may come without the batch axis (X [N,3]); the
    outputs then have none either: the 11 views that would add and strip
    it cost the host 0.02 ms a call on an H100's machine, a quarter of the
    kernel's time. Raises on any other input, and if the kernel cannot be
    built or launched."""
    if X.dim() not in (2, 3):
        raise ValueError("expected X [B,N,3], or [N,3] for one problem")
    lead = tuple(X.shape[:-2])     # (B,) or ()
    B = lead[0] if lead else 1
    N = X.shape[-2]
    if not 0 < N <= MAX_OBS or B <= 0:
        raise ValueError(f"need B >= 1 and 1 <= N <= {MAX_OBS}, got B={B} N={N}")
    f32 = torch.float32
    check_tensor("Tcw0", Tcw0, lead + (4, 4), f32)
    check_tensor("X", X, lead + (N, 3), f32)
    check_tensor("uv", uv, lead + (N, 2), f32)
    check_tensor("ur", ur, lead + (N,), f32)
    check_tensor("inv_sigma2", inv_sigma2, lead + (N,), f32)
    check_tensor("valid", valid, lead + (N,), torch.bool)
    check_tensor("stereo", stereo, lead + (N,), torch.bool)
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got {dev}")
    if any(x.device != dev for x in (Tcw0, uv, ur, inv_sigma2, valid, stereo)):
        raise ValueError("all inputs must lie on one device")

    lib = kernels.load()
    Tout = torch.empty(lead + (4, 4), dtype=f32, device=dev)
    inl = torch.empty(lead + (N,), dtype=torch.bool, device=dev)
    ninl = torch.empty(lead, dtype=torch.int32, device=dev)
    chi2 = torch.empty(lead + (N,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        code = lib.hyslam_pose_opt(
            Tcw0.data_ptr(), X.data_ptr(), uv.data_ptr(), ur.data_ptr(),
            inv_sigma2.data_ptr(), valid.data_ptr(), stereo.data_ptr(),
            B, N, float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            float(cam.bf), int(n_rounds), int(iters_per_round),
            Tout.data_ptr(), inl.data_ptr(), ninl.data_ptr(), chi2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(lib, code, "pose_opt kernel launch")
    # one thread launches K1: under the threaded pipeline the tracking
    # thread (the mapping thread's jobs, loop closing and global BA never
    # reach it), so the count needs no lock
    pose_optimization_cuda.launches += 1
    return Tout, inl, ninl, chi2


pose_optimization_cuda.launches = 0
