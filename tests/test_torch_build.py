"""Kernel builds, loads and launch counts under threads, on the CPU.

Serving engines are threads of one process: the first requests of several
engines can reach a kernel's first build at once, and every engine counts
its launches. No nvcc here: ``subprocess.run`` is replaced by a fake
compiler, and the launch itself by a no-op.
"""

import ctypes
import sys
import threading
import time

import pytest
import torch

from deeprecsys_tpu_torch.ops import _build, embedding, embedding_bag, rnn, rnn_scan

THREADS = 8


@pytest.fixture
def short_switches():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _run_threads(fn, n=THREADS):
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def body(i):
        try:
            barrier.wait(timeout=30)
            results[i] = fn()
        except Exception as e:  # noqa: BLE001 - collected and asserted below
            errors.append(e)

    threads = [threading.Thread(target=body, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


def test_concurrent_builds_compile_once_into_one_intact_library(tmp_path, monkeypatch,
                                                                 short_switches):
    """Eight threads ask for the same source on an empty build directory:
    one compile, one library with the compiler's whole output, no
    temporary file left, and every thread gets that library."""
    calls = []

    def fake_nvcc(cmd, **kw):
        out = cmd[cmd.index("-o") + 1]
        calls.append(out)
        with open(out, "wb") as f:
            for i in range(64):  # written in pieces, slowly: a race would interleave
                f.write(bytes([i]) * 1024)
                time.sleep(0.0005)
        return type("Done", (), {"returncode": 0, "stdout": "ptxas info\n", "stderr": ""})()

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_nvcc)
    builds = _run_threads(lambda: _build.build("embedding_bag"))
    assert len(calls) == 1
    assert len({b.path for b in builds}) == 1
    assert sorted(b.seconds > 0 for b in builds) == [False] * (THREADS - 1) + [True]
    data = builds[0].path.read_bytes()
    assert data == b"".join(bytes([i]) * 1024 for i in range(64))
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        [builds[0].path.name, builds[0].path.with_suffix(".log").name])


def test_concurrent_loads_declare_once(tmp_path, monkeypatch, short_switches):
    """Every thread gets the same library, and none before its functions
    were declared."""
    loaded, declared = [], []

    class FakeLib:
        def __init__(self, path):
            loaded.append(path)
            self.drs_cuda_error_string = type("F", (), {})()

    def declare(lib):
        time.sleep(0.01)
        lib.declared = True
        declared.append(lib)

    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "build",
                        lambda name: _build.Build(tmp_path / f"{name}.so", 0.0, ""))
    monkeypatch.setattr(ctypes, "CDLL", FakeLib)
    libs = _run_threads(lambda: _build.load("embedding_bag", declare))
    assert len(loaded) == len(declared) == 1
    assert all(lib is libs[0] and lib.declared for lib in libs)


class _SlowCount:
    """A wrapper whose count yields the GIL while it is read, so that a
    read-modify-write without a lock loses updates every time."""

    def __init__(self):
        self._n = 0

    @property
    def kernel_launches(self):
        n = self._n
        time.sleep(0)
        return n

    @kernel_launches.setter
    def kernel_launches(self, n):
        self._n = n


def _k1_launch():
    embedding._launch(torch.zeros((10, 32)), torch.zeros(2, dtype=torch.int32),
                      torch.zeros((3, 2, 4), dtype=torch.int32), None, torch.float32,
                      embedding.k1_launch_plan(6, 4, 32, torch.float32))


@pytest.mark.parametrize("path", ["k1_launch", "count_launch"])
def test_launch_counts_are_exact_under_threads(path, monkeypatch, short_switches):
    """Each launch adds exactly one to its wrapper's count, from any number
    of threads at once: K1 through its launch path (the kernel call itself a
    no-op), and the helper K3 counts with."""
    counter = _SlowCount()
    monkeypatch.setattr(_build, "launch", lambda *a: None)
    monkeypatch.setattr(embedding, "_kernel_lib", lambda: None)
    monkeypatch.setattr(embedding, "embedding_bag", counter)
    step = _k1_launch if path == "k1_launch" else (lambda: _build.count_launch(counter))
    per_thread = 200

    def body():
        for _ in range(per_thread):
            step()

    _run_threads(body)
    assert counter.kernel_launches == THREADS * per_thread


def test_wrappers_count_with_the_locked_helper():
    """Every kernel counts through ``_build.count_launch`` (their CUDA
    paths cannot run here): K1, K3 (in ``rnn._dispatch``, which ``rnn_scan``
    and its autograd forward call), K1b, K5 and K3b."""
    import inspect

    from deeprecsys_tpu_torch.ops import sparse_adagrad

    assert "_build.count_launch(embedding_bag)" in inspect.getsource(embedding._launch)
    assert "_build.count_launch(rnn_scan)" in inspect.getsource(rnn._dispatch)
    assert "_build.count_launch(embedding_bag_backward)" in inspect.getsource(
        embedding.embedding_bag_backward)
    assert "_build.count_launch(sparse_adagrad_step)" in inspect.getsource(
        sparse_adagrad.sparse_adagrad_step)
    assert "_build.count_launch(rnn_scan_backward)" in inspect.getsource(rnn.rnn_scan_backward)
    assert embedding_bag.kernel_launches >= 0 and rnn_scan.kernel_launches >= 0
