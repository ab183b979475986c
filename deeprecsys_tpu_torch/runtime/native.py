"""ctypes bindings and on-demand build of the native host runtime.

Counterpart of ``deeprecsys_tpu/runtime/native.py``: ``get_lib``,
``native_available``, ``HotIndex`` (the hot/cold splitter's index),
``precise_sleep_ns``, the LRU trace replay of synthetic mode
(``drs_trace_generate_lru``, wrapped by ``data/trace.py::NativeLruTrace``),
and the MPMC ring of 64-byte slots that
``shm_queue.ShmRingQueue`` wraps (the cpu-mp process engines' transport).
``cpp/drs_runtime.cpp`` is compiled once with ``g++`` into ``build/native/``
at the root of the checkout, named by a hash of the source, at first use;
the port never reads the JAX package's cache. A build that fails is
remembered, and ``native_available()`` then says False: the splitter's
``impl="auto"`` takes its numpy path, as in the JAX package, and the ring
raises (process engines have no pure-Python transport).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "cpp" / "drs_runtime.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None
_build_error: str | None = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library of the current source goes."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"drs_runtime_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # A temporary name of this process and thread, then an atomic rename:
    # concurrent first builds never write one file.
    tmp = out.with_suffix(f".so.tmp.{os.getpid()}.{threading.get_ident()}")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name} (exit {proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-2000:]}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL):
    # The ring: a header and ``capacity`` 64-byte slots in caller memory.
    lib.drs_ring_bytes.restype = ctypes.c_uint64
    lib.drs_ring_bytes.argtypes = [ctypes.c_uint64]
    lib.drs_ring_init.restype = ctypes.c_int
    lib.drs_ring_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
    lib.drs_ring_push.restype = ctypes.c_int
    lib.drs_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.drs_ring_pop.restype = ctypes.c_int
    lib.drs_ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.drs_ring_pop_wait.restype = ctypes.c_int
    lib.drs_ring_pop_wait.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.drs_ring_approx_size.restype = ctypes.c_uint64
    lib.drs_ring_approx_size.argtypes = [ctypes.c_void_p]
    lib.drs_trace_generate_lru.restype = ctypes.c_int64
    lib.drs_trace_generate_lru.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,  # lines, n, head
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,  # sd_vals, sd_cdf, n_sd
        ctypes.c_int64, ctypes.c_void_p,                   # out_len, out
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,   # rng_state, padding, i
    ]
    lib.drs_precise_sleep_ns.restype = None
    lib.drs_precise_sleep_ns.argtypes = [ctypes.c_int64, ctypes.c_int64]
    lib.drs_split_hot_cold_indexed.restype = ctypes.c_int64
    lib.drs_split_hot_cold_indexed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,                   # indices, n
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,   # offsets, T, L
        ctypes.c_void_p, ctypes.c_int64,                   # hot_ids, K
        ctypes.c_void_p,                                   # slot_mask (NULL = all valid)
        ctypes.c_void_p,                                   # hot_index (NULL = binary search)
        ctypes.c_void_p, ctypes.c_void_p,                  # hot_sel, hot_mask
        ctypes.c_void_p, ctypes.c_void_p,                  # cold_ids, cold_seg
        ctypes.c_int32,                                    # n_threads (0 = up to 8)
    ]
    lib.drs_hot_index_build.restype = ctypes.c_void_p
    lib.drs_hot_index_build.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.drs_hot_index_free.restype = None
    lib.drs_hot_index_free.argtypes = [ctypes.c_void_p]


def get_lib() -> ctypes.CDLL:
    """The loaded library, built if needed; raises RuntimeError (and keeps
    raising) when it cannot be built or loaded."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            if _build_error is not None:
                raise RuntimeError(f"native runtime unavailable: {_build_error}")
            try:
                lib = ctypes.CDLL(str(_build()))
                _declare(lib)
            except (OSError, RuntimeError) as e:
                _build_error = str(e)
                raise RuntimeError(f"native runtime unavailable: {e}") from e
            _lib = lib
    return _lib


def native_available() -> bool:
    try:
        get_lib()
        return True
    except RuntimeError:
        return False


def precise_sleep_ns(total_ns: int, spin_ns: int = 200_000):
    """Sleep ``total_ns`` with the GIL released (nanosleep, then a spin over
    the last ``spin_ns``)."""
    get_lib().drs_precise_sleep_ns(total_ns, spin_ns)


class HotIndex:
    """Persistent native hash index over a SORTED hot-id set (JAX
    ``runtime/native.py:138-171``): the splitter probes it in ~1 cache miss
    a lookup instead of a binary search's ~log2(K). Built once a hot-set
    install, off the dispatch path where it can be; outputs are the same
    with or without it. Owns the native table and frees it when collected:
    a hot/cold model's ``prepare`` holds it in its closure, so a swap never
    frees a table an in-flight split probes."""

    def __init__(self, hot_ids):
        lib = get_lib()  # raises when the native runtime is unavailable
        hot = np.ascontiguousarray(hot_ids, dtype=np.int64)
        self.K = int(len(hot))
        self._lib = lib
        self._ptr = lib.drs_hot_index_build(hot.ctypes.data, self.K) if self.K else None

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.drs_hot_index_free(ptr)
            self._ptr = None
