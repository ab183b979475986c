"""Instance sweep of the RNN's reverse scan K3b on one card.

    python -m deeprecsys_tpu_torch.experiments.k3b_sweep [--json PATH]

``ops/csrc/rnn_scan_backward.cu`` is built with one instance (``Shipped``
there): threads a hidden unit or units a thread, FMA chains, and the
chunks of steps of y and gh its ring keeps in flight ahead of the chunk
that reads them. This script chose it: it writes translation units into ``build/k3b_sweep/`` that
include that source and add one C entry point over every instance of the
sweep (``instances``; f32 and bf16 weights), builds them (``experiments.sweep_build``), holds
each to the plain loop within 1e-5 of the largest |delta| with and without
seq_lengths (``kernel_bench.k3b_error``), and times it (the kernel's median
device time) at ``kernel_bench.K3B_SHAPES`` (T = 40, B = 128 and 512)
beside the shipped wrapper's, with the instance's registers and spills
(ptxas). Last it times the shipped instance at B = 128 over T from 1 to 80:
the slope is a step's time.

It needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from deeprecsys_tpu_torch.experiments.sweep_build import build_units, ptxas_of

ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
W_TYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}


def instances() -> list:
    """``(threads a unit, units a thread, chains, steps a chunk, chunks in
    the ring)`` of the sweep: one or two threads a unit, or one thread two
    units (one warp a row); 2 or 4 chains; chunks of 1 step (a wait a step)
    to 8, 2 or 3 of them in the ring."""
    return [(ks, nu, c, ch, r) for ks, nu in ((1, 1), (2, 1), (1, 2)) for c in (2, 4)
            for ch, r in ((1, 8), (4, 2), (4, 3), (8, 2), (8, 3))]


def keys() -> list:
    return [(wt, *inst) for wt in W_TYPES for inst in instances()]


def _source(src: Path, group: list) -> str:
    cases = "\n".join(
        f"    case {n}: return launch<{W_TYPES[wt]}, {ks}, {nu}, {c}, {ch}, {r}>"
        f"(y, gh, w, lens, d, h, T, B, s);"
        for n, (wt, ks, nu, c, ch, r) in enumerate(group))
    return f"""#include "{src}"
extern "C" int drs_k3b_sweep(int key, const void* y_, const void* gh_, const void* w,
                             const void* lens_, void* delta, void* dh0, int T, int B,
                             void* stream) {{
  const float* y = static_cast<const float*>(y_);
  const float* gh = static_cast<const float*>(gh_);
  const int32_t* lens = static_cast<const int32_t*>(lens_);
  float* d = static_cast<float*>(delta);
  float* h = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (key) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
}}
"""


def build_all(log) -> tuple:
    """Every instance, four translation units compiled in parallel:
    ((CDLL, case) of each key, ptxas lines)."""
    from deeprecsys_tpu_torch.ops import _build

    src = _build.CSRC / "rnn_scan_backward.cu"
    ks = keys()
    groups = [g for g in (ks[i::4] for i in range(4)) if g]
    built = build_units("k3b_sweep", {f"k3b_sweep_{n}": _source(src, g)
                                      for n, g in enumerate(groups)}, "drs_k3b_sweep", ARGTYPES)
    libs, lines = {}, []
    for group, (lib, ptx) in zip(groups, built.values()):
        for i, key in enumerate(group):
            libs[key] = (lib, i)
        lines += ptx
    log(f"{len(ks)} instances; ptxas " + "; ".join(lines))
    return libs, lines


def _call(lib_i, y, gh, w, lens=None):
    lib, i = lib_i
    T, B, H = y.shape
    delta = torch.empty((T, B, H), dtype=torch.float32, device=y.device)
    dh0 = torch.zeros((B, H), dtype=torch.float32, device=y.device)
    err = lib.drs_k3b_sweep(i, y.data_ptr(), gh.data_ptr(), w.data_ptr(),
                            None if lens is None else lens.data_ptr(), delta.data_ptr(),
                            dh0.data_ptr(), T, B, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sweep instance {i} failed to launch ({err})")
    return delta, dh0


def _ptxas_of(lines: list, key) -> str:
    wt, *inst = key
    return ptxas_of(lines, f"rnn_scan_backward_kernel<{'f32' if wt == torch.float32 else 'bf16'}, "
                           + ", ".join(map(str, inst)) + ">")


def sweep(libs: dict, lines: list, log) -> list:
    from deeprecsys_tpu_torch.kernel_bench import K3B_SHAPES, _us, k3b_error, k3b_inputs, measure
    from deeprecsys_tpu_torch.ops.rnn import rnn_scan_backward

    device = torch.device("cuda")
    rows = []
    for T, B in K3B_SHAPES:
        for wt in W_TYPES:
            inp = k3b_inputs(T, B, wt, device, seed=T + B)
            args = [(inp["y"], inp["gh"], inp["w"])]
            shipped = measure(rnn_scan_backward, args, 50)["kernel_ms"]
            for key in [k for k in keys() if k[0] == wt]:
                def fn(y, gh, w, lens=None, key=key):
                    return _call(libs[key], y, gh, w, lens)
                err = max(k3b_error(fn, inp, m) for m in (None, inp["lens"]))
                ms = measure(fn, args, 50)["kernel_ms"]
                row = {"T": T, "B": B, "w_dtype": str(wt)[6:], "threads_per_unit": key[1],
                       "units_per_thread": key[2], "chains": key[3], "chunk": key[4],
                       "ring": key[5], "ms": ms, "shipped_ms": shipped, "max_rel_err": err,
                       "ptxas": _ptxas_of(lines, key)}
                rows.append(row)
                log(f"T={T} B={B} W {row['w_dtype']} KS {key[1]} NU {key[2]} chains {key[3]} "
                    f"chunk {key[4]} ring {key[5]}: {_us(ms)} (shipped {_us(shipped)}); "
                    f"err {err:.2e}; {row['ptxas']}")
            del inp
    return rows


def step_slope(log) -> dict:
    """The shipped K3b's median device time at B = 128, f32 W, over T in
    ``STEPS``, and the least-squares line through them: its slope is a
    step's time, its intercept the launch and set-up."""
    import numpy as np

    from deeprecsys_tpu_torch.kernel_bench import _us, k3b_inputs, measure
    from deeprecsys_tpu_torch.ops.rnn import rnn_scan_backward

    device = torch.device("cuda")
    ms = []
    for T in STEPS:
        inp = k3b_inputs(T, 128, torch.float32, device, seed=T)
        ms.append(measure(rnn_scan_backward, [(inp["y"], inp["gh"], inp["w"])], 50)["kernel_ms"])
    slope, icept = np.polyfit(np.asarray(STEPS, float), np.asarray(ms), 1)
    log(f"shipped at B=128 f32 by T: " + ", ".join(f"T={T} {_us(m)}" for T, m in zip(STEPS, ms))
        + f"; a step {_us(slope)}, set-up {_us(icept)}")
    return {"T": list(STEPS), "ms": ms, "step_ms": float(slope), "setup_ms": float(icept)}


STEPS = (1, 10, 20, 40, 80)


def main(argv=None) -> int:
    from deeprecsys_tpu_torch.kernel_bench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3b_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k3b_sweep] {msg}", flush=True)

    card = card_line()
    log(f"card: {card}")
    with torch.inference_mode():
        libs, lines = build_all(log)
        res = {"card": card, "rows": sweep(libs, lines, log), "steps": step_slope(log)}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
