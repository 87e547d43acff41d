"""The port's native runtime (``hyslam_tpu_torch/runtime/native.py`` over
``native/hyslam_rt.cpp``) against the semantics tests/test_runtime.py holds
the JAX package's to: FIFO order, backpressure, clear, close unblocking a
pop, order across threads, and the flag block. Each case runs on the JAX
package's queue and on the port's. Then the port's own build: into the
git-ignored build directory, keyed by the source, safe when several
processes build at once, and raising with g++'s output on failure."""

import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from hyslam_tpu.runtime import native as j_native
from hyslam_tpu_torch.runtime import native

WAIT_S = 10          # every join in this file is bounded
PACKAGES = {"jax": j_native, "port": native}


def fifo(m):
    q = m.NativeQueue(8)
    for i in range(5):
        q.push(("item", i))
    assert q.size() == 5
    assert [q.pop() for _ in range(5)] == [("item", i) for i in range(5)]
    assert q.pop(timeout_ms=10) is None


def backpressure(m):
    q = m.NativeQueue(2)
    assert q.push(1, timeout_ms=100)
    assert q.push(2, timeout_ms=100)
    t0 = time.time()
    assert not q.push(3, timeout_ms=200)  # full: times out
    assert time.time() - t0 >= 0.15
    th = threading.Thread(target=lambda: (time.sleep(0.1), q.pop()))
    th.start()
    assert q.push(3, timeout_ms=2000)  # unblocked by the pop
    th.join(timeout=WAIT_S)
    assert not th.is_alive() and q.size() == 2


def clear(m):
    q = m.NativeQueue(16)
    for i in range(7):
        q.push(i)
    assert q.clear() == 7
    assert q.size() == 0 and len(q._reg) == 0


def close_unblocks_pop(m):
    q = m.NativeQueue(4)
    out = []
    th = threading.Thread(target=lambda: out.append(q.pop()))
    th.start()
    time.sleep(0.05)
    q.close()
    th.join(timeout=WAIT_S)
    assert out == [None]
    assert not q.push(1)          # a closed queue refuses pushes


def cross_thread_order(m):
    q = m.NativeQueue(32)
    n, got = 2000, []

    def consumer():
        while (x := q.pop()) is not None:
            got.append(x)

    th = threading.Thread(target=consumer)
    th.start()
    for i in range(n):
        q.push(i)
    q.close()
    th.join(timeout=WAIT_S)
    assert got == list(range(n))


def flags(m):
    s = m.ThreadStatus()
    assert s.accepting_input == 1 and s.queue_length == 0 and s.finished == 0
    s.set("accepting_input", 0)
    assert s.accepting_input == 0
    s.set("queue_length", 7)
    assert s.queue_length == 7
    s.set("stop_requested", 1)
    assert s.stop_requested == 1


CASES = {f.__name__: f for f in (fifo, backpressure, clear, close_unblocks_pop,
                                  cross_thread_order, flags)}


@pytest.mark.parametrize("pkg", list(PACKAGES))
@pytest.mark.parametrize("case", list(CASES))
def test_queue_and_flags_semantics(case, pkg):
    CASES[case](PACKAGES[pkg])


def test_port_flag_names_are_the_jax_packages():
    s = native.ThreadStatus()
    assert native.FLAGS == j_native.ThreadStatus._FLAGS
    with pytest.raises(AttributeError):
        s.set("no_such_flag", 1)
    with pytest.raises(AttributeError):
        s.no_such_flag


def test_library_builds_into_the_ignored_build_directory():
    repo = Path(__file__).resolve().parent.parent
    lib = native.build()
    assert lib.is_file() and lib.parent == native.build_dir()
    assert lib.parent.parent == repo / "build" / "hyslam_rt"
    assert "build/" in (repo / ".gitignore").read_text().split()
    assert not list((repo / "hyslam_tpu_torch" / "native").glob("*.so"))


def test_concurrent_builds_and_a_failed_build(tmp_path, monkeypatch):
    """Four processes build one fresh directory at once: each loads a whole
    library. A source that does not compile raises with g++'s message."""
    src = tmp_path / "hyslam_rt.cpp"
    src.write_text(native.SRC.read_text())
    code = (
        "import sys; from pathlib import Path\n"
        "from hyslam_tpu_torch.runtime import native as n\n"
        f"n.SRC = Path({str(src)!r}); n.BUILD_ROOT = Path({str(tmp_path / 'b')!r})\n"
        "q = n.NativeQueue(2); q.push(5); assert q.pop() == 5\n"
        "print(n.build())\n")
    repo = Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=repo, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(4)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    built = {o[0].strip() for o in outs}
    assert len(built) == 1
    assert [f.name for f in Path(built.pop()).parent.iterdir()] == [native.LIB_NAME]

    src.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "bad")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "bad").rglob("*.tmp"))
