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
from hyslam_tpu_torch.geometry.camera import Camera

MAX_OBS = 1024   # observations per problem: kMaxObs in csrc/pose_opt.cu


def _check(name: str, x: torch.Tensor, shape: tuple) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def pose_optimization_cuda(
    cam: Camera,
    Tcw0: torch.Tensor,        # [B, 4, 4]
    X: torch.Tensor,           # [B, N, 3]
    uv: torch.Tensor,          # [B, N, 2]
    ur: torch.Tensor,          # [B, N]
    inv_sigma2: torch.Tensor,  # [B, N]
    valid: torch.Tensor,       # [B, N] 0/1
    stereo: torch.Tensor,      # [B, N] 0/1
    n_rounds: int = 4,
    iters_per_round: int = 10,
):
    """Run B independent pose problems, one thread block each. All inputs
    are float32, contiguous CUDA tensors on one device (masks as 0/1).
    Returns (Tcw [B,4,4] f32, inliers [B,N] bool, num_inliers [B] int32).
    Raises on any other input, and if the kernel cannot be built or
    launched."""
    if Tcw0.dim() != 3 or X.dim() != 3:
        raise ValueError("expected batched inputs: Tcw0 [B,4,4], X [B,N,3]")
    B, N = X.shape[0], X.shape[1]
    if not 0 < N <= MAX_OBS or B <= 0:
        raise ValueError(f"need B >= 1 and 1 <= N <= {MAX_OBS}, got B={B} N={N}")
    _check("Tcw0", Tcw0, (B, 4, 4))
    _check("X", X, (B, N, 3))
    _check("uv", uv, (B, N, 2))
    for name, x in (("ur", ur), ("inv_sigma2", inv_sigma2), ("valid", valid),
                    ("stereo", stereo)):
        _check(name, x, (B, N))
    dev = X.device
    if any(x.device != dev for x in (Tcw0, uv, ur, inv_sigma2, valid, stereo)):
        raise ValueError("all inputs must lie on one device")

    lib = kernels.load()
    Tout = torch.empty((B, 4, 4), dtype=torch.float32, device=dev)
    inl = torch.empty((B, N), dtype=torch.bool, device=dev)
    ninl = torch.empty((B,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.hyslam_pose_opt(
            Tcw0.data_ptr(), X.data_ptr(), uv.data_ptr(), ur.data_ptr(),
            inv_sigma2.data_ptr(), valid.data_ptr(), stereo.data_ptr(),
            B, N, float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy),
            float(cam.bf), int(n_rounds), int(iters_per_round),
            Tout.data_ptr(), inl.data_ptr(), ninl.data_ptr(), stream,
        )
    kernels.check(lib, code, "pose_opt kernel launch")
    pose_optimization_cuda.launches += 1
    return Tout, inl, ninl


pose_optimization_cuda.launches = 0
