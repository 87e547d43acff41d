"""ctypes bindings for the host runtime library ``native/hyslam_rt.cpp``
(counterpart of ``hyslam_tpu/runtime/native.py``): a bounded blocking queue
of uint64 handles and the flag block of the reference's InterThread.h.
Queues carry handles; ``HandleRegistry`` maps them to Python payloads on
this side of the ABI.

The library is built with g++ at first use, never on import, into
``build/hyslam_rt/<hash>/`` beside the package (ignored by git), keyed by a
hash of the source and flags, so a changed source rebuilds. Concurrent
builds (test workers, two processes starting at once) each compile to a
file of their own and move it into place with ``os.replace``. A missing
compiler or a failed build raises with g++'s output: there is no fallback
to a Python queue.
"""

from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC = _PKG / "native" / "hyslam_rt.cpp"
BUILD_ROOT = _PKG.parent / "build" / "hyslam_rt"
LIB_NAME = "libhyslam_rt.so"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

FLAGS = ("stop_requested", "stopped", "release_requested", "finish_requested",
         "finished", "interrupt_requested", "accepting_input", "queue_length")

_lock = threading.Lock()
_lib = None


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library unless this source hash is built. Returns its
    path; raises RuntimeError with g++'s output on failure."""
    out_dir = build_dir()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the pipeline's native queue "
                           f"({SRC.name}) is built from source at first use")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [gxx, *GXX_FLAGS, "-o", str(tmp), str(SRC), "-lpthread"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({proc.returncode}) building {SRC.name}:\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare every entry
    point's argument and result types."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.hq_create.restype = ctypes.c_void_p
        lib.hq_create.argtypes = [ctypes.c_size_t]
        lib.hq_push.restype = ctypes.c_int
        lib.hq_push.argtypes = [ctypes.c_void_p, ctypes.c_uint64, ctypes.c_long]
        lib.hq_pop.restype = ctypes.c_int
        lib.hq_pop.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                               ctypes.c_long]
        lib.hq_size.restype = ctypes.c_size_t
        lib.hq_size.argtypes = [ctypes.c_void_p]
        lib.hq_clear.restype = ctypes.c_size_t
        lib.hq_clear.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                                 ctypes.c_size_t]
        lib.hq_close.argtypes = [ctypes.c_void_p]
        lib.hq_destroy.argtypes = [ctypes.c_void_p]
        lib.hs_create.restype = ctypes.c_void_p
        lib.hs_destroy.argtypes = [ctypes.c_void_p]
        for f in FLAGS:
            getattr(lib, f"hs_set_{f}").argtypes = [ctypes.c_void_p, ctypes.c_int]
            getattr(lib, f"hs_get_{f}").restype = ctypes.c_int
            getattr(lib, f"hs_get_{f}").argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class HandleRegistry:
    """uint64 handle <-> Python object (the payload side of the native
    queue)."""

    def __init__(self):
        self._objs = {}
        self._next = itertools.count(1)
        self._lock = threading.Lock()

    def put(self, obj) -> int:
        h = next(self._next)
        with self._lock:
            self._objs[h] = obj
        return h

    def take(self, handle: int):
        with self._lock:
            return self._objs.pop(handle)

    def __len__(self):
        with self._lock:
            return len(self._objs)


class NativeQueue:
    """Bounded blocking queue backed by hyslam_rt (the reference's
    ThreadSafeQueue). ``capacity=0`` means unbounded; a push to a full queue
    blocks (backpressure) until a pop, its timeout or ``close``."""

    def __init__(self, capacity: int = 0):
        self._lib = load_library()
        self._q = self._lib.hq_create(capacity)
        self._reg = HandleRegistry()
        self._closed = False

    def push(self, obj, timeout_ms: int = -1) -> bool:
        """Queue obj; False on a timeout or a closed queue."""
        h = self._reg.put(obj)
        if not self._lib.hq_push(self._q, h, timeout_ms):
            self._reg.take(h)
            return False
        return True

    def pop(self, timeout_ms: int = -1):
        """The oldest item; None on a timeout or once closed and empty."""
        out = ctypes.c_uint64()
        if not self._lib.hq_pop(self._q, ctypes.byref(out), timeout_ms):
            return None
        return self._reg.take(out.value)

    def clear(self) -> int:
        """Drop everything queued (the mapping stage's overflow clearing).
        Returns the number of items dropped."""
        buf = (ctypes.c_uint64 * 4096)()
        n = self._lib.hq_clear(self._q, buf, 4096)
        for i in range(n):
            self._reg.take(buf[i])
        return n

    def size(self) -> int:
        return self._lib.hq_size(self._q)

    def close(self):
        """Refuse further pushes and wake every blocked push and pop; items
        already queued can still be popped."""
        if not self._closed:
            self._lib.hq_close(self._q)
            self._closed = True

    def __del__(self):
        try:
            self.close()
            self._lib.hq_destroy(self._q)
        except Exception:
            pass


class ThreadStatus:
    """The native atomic flag block (InterThread.h's ThreadStatus): read a
    flag as an attribute, write it with ``set``."""

    def __init__(self):
        self._lib = load_library()
        self._s = self._lib.hs_create()

    def __getattr__(self, name):
        if name in FLAGS:
            # getattr reuses the function pointer whose types load_library
            # declared (lib["name"] would make a fresh one without them)
            return getattr(self._lib, f"hs_get_{name}")(self._s)
        raise AttributeError(name)

    def set(self, name: str, value: int):
        if name not in FLAGS:
            raise AttributeError(name)
        getattr(self._lib, f"hs_set_{name}")(self._s, int(value))

    def __del__(self):
        try:
            self._lib.hs_destroy(self._s)
        except Exception:
            pass
