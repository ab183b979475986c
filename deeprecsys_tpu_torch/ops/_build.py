"""Build the CUDA sources under ``csrc/`` at first use and load them.

Counterpart of ``deeprecsys_tpu/runtime/native.py`` (hash-keyed g++ build):
each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
a shared library with a plain C interface, loaded with ``ctypes``. No torch
headers are included, so a build takes seconds, not minutes. The library
goes to ``build/kernels/`` at the root of the checkout, named by a hash of
the sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import: the CPU-only tests import every module.

A failed build raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless a library of the same sources exists."""
    src = CSRC / f"{name}.cu"
    out = BUILD_DIR / f"{name}_{_tag(src)}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        return Build(out, 0.0, log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Per-process temporary name, then an atomic rename: concurrent builds
    # of the same sources never interleave writes into one file.
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}")
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


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build(name).path))
