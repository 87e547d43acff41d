"""Numeric settings for the whole port, applied once when the package loads.

The JAX package pins true float32 matmuls (``hyslam_tpu/__init__.py``,
``hyslam_tpu/utils/precision.py``). On an NVIDIA card a float32 convolution
runs in TF32 by default, and a float32 matmul may be switched to it. TF32
keeps about three decimal digits: it moves the ORB moment angles
(``ops/orb.py``), and with them the steering bin and descriptor bits, and it
moves the pose solver's normal equations. Both are switched off here.

``default_device`` is where an entry point of the port puts its state when
its caller names no device: the current CUDA card. There is no quiet
fallback to the CPU; a caller that wants the CPU (the tests) says so.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device() -> torch.device:
    """The current CUDA device; raises RuntimeError where there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port's entry points run on the card by "
            "default; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch.device, or the default one where it is None."""
    return torch.device(device) if device is not None else default_device()
