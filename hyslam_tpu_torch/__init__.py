"""hyslam_tpu_torch — the PyTorch / CUDA port of ``hyslam_tpu``.

The port mirrors the JAX package's layout (``ops/``, ``features/``,
``geometry/``, ``solver/``, ``core/``, ``slam/``) and function names, so each
counterpart is found at the same path. It imports ``torch`` and numpy only:
never ``jax`` and never ``hyslam_tpu`` (whose ``__init__`` starts JAX).

What is ported so far is the per-frame stereo front end,
``slam.frontend.track_stereo_frame``: batched ORB extraction of both images,
stereo match with sub-pixel refinement, local-map projection matching, and
pose-only Levenberg-Marquardt. The pose optimizer runs as a hand-written CUDA
kernel for Hopper (``csrc/pose_opt.cu``) on CUDA tensors and as its plain
PyTorch version on CPU tensors.
"""

__version__ = "0.1.0"

from hyslam_tpu_torch import device  # noqa: F401  (pins float32 matmuls)
