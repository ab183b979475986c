"""Builds the translation units of a kernel's mapping sweep.

A sweep (``experiments/int8_sweep.py``, ``experiments/k6_sweep.py``) writes
translation units that include a shipped ``ops/csrc`` source and add one C
entry point over more instances than the source ships. ``build_units``
compiles them with ``ops._build``'s nvcc flags, all at once, into
``build/<sweep>/`` and loads them; ``ptxas_of`` finds an instance's
registers and spills in the build's ptxas lines. It imports no JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

BUILD = Path(__file__).resolve().parents[2] / "build"


def build_units(sweep: str, units: dict, entry: str, argtypes: list) -> dict:
    """Writes each of ``units`` (``{stem: source}``) to
    ``build/<sweep>/<stem>.cu``, compiles every one at once, and returns
    ``{stem: (CDLL with entry point ``entry`` declared, ptxas lines)}``;
    raises with nvcc's output if one fails to build."""
    from deeprecsys_tpu_torch.kernel_bench import ptxas_summary
    from deeprecsys_tpu_torch.ops import _build

    out_dir = BUILD / sweep
    out_dir.mkdir(parents=True, exist_ok=True)

    def one(stem):
        cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
        cu.write_text(units[stem])
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {cu}:\n{(proc.stdout + proc.stderr)[-4000:]}")
        lib = ctypes.CDLL(str(so))
        fn = getattr(lib, entry)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
        return lib, ptxas_summary(proc.stdout + proc.stderr)

    with ThreadPoolExecutor(max(1, len(units))) as pool:
        return dict(zip(units, pool.map(one, units)))


def ptxas_of(lines: list, *names: str) -> str:
    """The ptxas summary (``"N regs, M B spilled"``) of the first of
    ``lines`` (``kernel_bench.ptxas_summary``'s) that names one of
    ``names``, or "not found"."""
    tags = tuple(n + ":" for n in names)
    return next((x.split(": ", 1)[1] for x in lines if x.startswith(tags)), "not found")
