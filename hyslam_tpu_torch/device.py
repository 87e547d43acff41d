"""Numeric settings for the whole port, applied once when the package loads.

The JAX package pins true float32 matmuls (``hyslam_tpu/__init__.py``,
``hyslam_tpu/utils/precision.py``). On an NVIDIA card a float32 convolution
runs in TF32 by default, and a float32 matmul may be switched to it. TF32
keeps about three decimal digits: it moves the ORB moment angles
(``ops/orb.py``), and with them the steering bin and descriptor bits, and it
moves the pose solver's normal equations. Both are switched off here.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
