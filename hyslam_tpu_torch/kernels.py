"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library with
a plain C interface, bound with ``ctypes``. The build happens at first use,
never on import, into ``build/hyslam_tpu_torch/<hash>/`` beside the package,
keyed by a hash of the sources and flags, so a changed source rebuilds. A
missing compiler, a failed build or a failed load raises: nothing on a CUDA
tensor falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "hyslam_tpu_torch"
LIB_NAME = "libhyslam_tpu_torch.so"

# Hopper with its architecture-specific features (sm_90a). No
# --use_fast_math: sinf, sqrtf and division stay IEEE. -Xptxas -v writes
# each kernel's registers, shared memory and spills into build.log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # T0 X uv ur is2 valid stereo | B N | fx fy cx cy bf | rounds iters |
    # Tout inl ninl chi2 | stream
    "hyslam_pose_opt": ([_P] * 7 + [_I, _I] + [_F] * 5 + [_I, _I]
                        + [_P] * 4 + [_P], _I),
    # lm_id kp_valid kf_valid kf_bad lm_valid lm_bad | K F L | scratch covis |
    # stream
    "hyslam_covisibility": ([_P] * 6 + [_I] * 3 + [_P] * 2 + [_P], _I),
    "hyslam_covisibility_scratch_ints": ([_I] * 3, ctypes.c_longlong),
    # obs_kf obs_feat obs_valid Tcw pos level kf_desc | normal desc min_dist
    # max_dist (old) | K F L O | inv_scale_range | the four new | stream
    "hyslam_landmark_stats": ([_P] * 7 + [_P] * 4 + [_I] * 4 + [_F] + [_P] * 4
                              + [_P], _I),
    "hyslam_error_string": ([_I], ctypes.c_char_p),
}


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(cuda_home) / "bin" / "nvcc"] if cuda_home else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                           "kernels are built from source at first use")
    return found


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/*.cu into the library unless this source hash is built.
    Returns the library path; raises RuntimeError with nvcc's output on
    failure."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument and result types."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if code != 0:
        msg = lib.hyslam_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def check_tensor(name: str, x: torch.Tensor, shape: tuple, dtype: torch.dtype,
                 device: torch.device | None = None) -> None:
    """Raise unless x is a contiguous tensor of this dtype and shape, and on
    ``device`` where one is given: a wrapper's check of an input before its
    pointer goes to a C entry point."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if device is not None and x.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {x.device}")
