"""Build the CUDA sources under ``csrc/`` at first use and load them.

Counterpart of ``deeprecsys_tpu/runtime/native.py`` (hash-keyed g++ build):
each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. No torch
headers are included, so a build takes seconds, not minutes. The library
goes to ``build/kernels/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import: the CPU-only tests import every module.

A failed build raises; there is no fallback. ``launch`` calls a loaded
kernel on PyTorch's current stream of a tensor's card (the calling
thread's: a serving engine launches on its own stream). Builds, loads and
launch counts are safe under threads: one compile a source per process,
one load, and ``count_launch`` loses no update.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Build:
    path: Path
    seconds: float  # time nvcc took in this process; 0.0 if the library was reused
    log: str        # nvcc's output, including ptxas's register and spill lines


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels cannot be built")


def _tag(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [src]:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


_GUARD = threading.Lock()       # guards the two dicts below
_NAME_LOCKS: dict[str, threading.RLock] = {}  # reentrant: load() holds it around build()
_LOADED: dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()


def _name_lock(name: str) -> threading.RLock:
    with _GUARD:
        return _NAME_LOCKS.setdefault(name, threading.RLock())


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources exists.

    Threads of one process that ask for the same source wait for one
    compile (a lock a name; different sources build in parallel).
    Processes each compile into a temporary name of their own, then rename
    atomically, so no two writers ever share a file."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}_{_tag(src)}.so"
    log_path = out.with_suffix(".log")
    with _name_lock(name):
        if out.exists():
            return Build(out, 0.0, log_path.read_text() if log_path.exists() else "")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".so.tmp.{os.getpid()}.{threading.get_ident()}")
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {proc.returncode}):\n{log[-4000:]}")
        log_path.write_text(log)
        os.replace(tmp, out)
        return Build(out, seconds, log)


def load(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library for ``csrc/<name>.cu``, built if needed, loaded once a
    process and handed out only after ``declare`` has set its functions'
    ``argtypes`` and ``restype``."""
    lib = _LOADED.get(name)
    if lib is not None:
        return lib
    with _name_lock(name):
        if name not in _LOADED:
            lib = ctypes.CDLL(str(build(name).path))
            lib.drs_cuda_error_string.restype = ctypes.c_char_p
            lib.drs_cuda_error_string.argtypes = [ctypes.c_int]
            declare(lib)
            _LOADED[name] = lib
        return _LOADED[name]


def count_launch(wrapper):
    """Add one to ``wrapper.kernel_launches``, exact under threads (the
    serving engines launch from several)."""
    with _COUNT_LOCK:
        wrapper.kernel_launches += 1


def launch(lib: ctypes.CDLL, fn: str, device: torch.device, *args):
    """``lib.<fn>(*args, stream)`` with the current stream of ``device``'s
    card, made the current card only for the call when it is not already;
    raises if the C function returns a nonzero ``cudaError_t``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index == torch.cuda.current_device():
        err = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = getattr(lib, fn)(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn} failed to launch: "
                           f"{lib.drs_cuda_error_string(err).decode()} ({err})")
