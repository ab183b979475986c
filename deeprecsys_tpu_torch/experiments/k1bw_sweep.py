"""K1b's ownership window: the shipped reductions against narrower ones, and
against a window test at every slot, on one card.

    python -m deeprecsys_tpu_torch.experiments.k1bw_sweep [--json PATH]

``ops/csrc/embedding_bag_backward.cu`` ships one design of a row shard's
gradient: a task a bag of a table that meets the shard and 32 of its
slots, each owned row added with 16-byte vector reductions
(``kRedFloats = 4``: 8 lanes a 128-byte row, 4 rows a warp instruction),
the window test only in the tables that straddle a shard edge. This script
writes translation units into ``build/k1bw_sweep/``, each the shipped
source with one line substituted: ``kRedFloats`` 2 (8-byte reductions) and
1 (scalar ``atomicAdd``, the parent's adds), and a unit whose every slot
takes the window test. Each is held to the window's plain version
(``backward_tolerance``) and timed (``kernel_bench.span_ms``, and each
launch's median by ``kernel_bench.measure``) in turns (ABBA over the
designs) at ``parent_turns.WINDOW_PLACES``, f32 gradients of the trainer's
batch 128 added into one kept f32 gradient.

It needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

RED = "constexpr int kRedFloats = 4;"
TESTED = "    if (window_tested(t, w)) {\n      add_slots<true"
DESIGNS = {
    "shipped (4 f32 a reduction)": [],
    "2 f32 a reduction": [(RED, "constexpr int kRedFloats = 2;")],
    "scalar atomicAdd": [(RED, "constexpr int kRedFloats = 1;")],
    "window test at every slot": [(TESTED, "    if (true) {\n      add_slots<true")],
}
ENTRY = "drs_embedding_bag_backward_window"


def units(src: Path) -> dict:
    """``{stem: source}``: the shipped source with each design's lines
    substituted (its include made absolute, since the unit is built
    elsewhere)."""
    text = src.read_text().replace('#include "window_tables.cuh"',
                                   f'#include "{src.parent / "window_tables.cuh"}"')
    out = {}
    for n, subs in enumerate(DESIGNS.values()):
        body = text
        for old, new in subs:
            if body.count(old) != 1:
                raise RuntimeError(f"the source no longer reads as the sweep expects: {old!r}")
            body = body.replace(old, new)
        out[f"k1bw_{n}"] = body
    return out


def call(lib, g, offsets, indices, row_lo: int, rows: int, grad, tr):
    """One design's window launch into ``grad`` (the wrapper's arguments)."""
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops.embedding import _DTYPE_CODES, _k1b_grid

    B, T, L = indices.shape
    _build.launch(lib, ENTRY, g.device, g.data_ptr(), _DTYPE_CODES[g.dtype], g.shape[-1],
                  offsets.data_ptr(), indices.data_ptr(), None, grad.data_ptr(), row_lo, rows,
                  *tr.kernel_args, B, T, L, _k1b_grid(indices, tr.hi - tr.lo))


def sweep(log) -> list:
    from deeprecsys_tpu_torch.experiments.parent_turns import (
        TRAIN_BATCH, WINDOW_PLACES, window_inputs)
    from deeprecsys_tpu_torch.experiments.sweep_build import build_units
    from deeprecsys_tpu_torch.kernel_bench import _us, measure, span_ms
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops import embedding as emb

    argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    built = build_units("k1bw_sweep", units(_build.CSRC / "embedding_bag_backward.cu"), ENTRY,
                        argtypes)
    libs = {}
    for label, (stem, (lib, ptxas)) in zip(DESIGNS, built.items()):
        lib.drs_cuda_error_string.restype = ctypes.c_char_p
        lib.drs_cuda_error_string.argtypes = [ctypes.c_int]
        libs[label] = lib
        log(f"{label}: ptxas " + "; ".join(x for x in ptxas if "window" in x))
    device = torch.device("cuda")
    rows_out = []
    for name, place in WINDOW_PLACES:
        inp = window_inputs(name, place, TRAIN_BATCH, device)
        cfg, lo, rows, offsets, ids = (inp[k] for k in ("cfg", "row_lo", "rows", "offsets",
                                                        "ids"))
        tr = emb.table_range_of(offsets, lo, rows)
        gen = torch.Generator(device=device).manual_seed(15)
        gs = [torch.randn((TRAIN_BATCH, cfg.num_tables, cfg.sparse_feature_size),
                          generator=gen, device=device) * 1e-2 for _ in ids]
        w = (lo, lo + rows)
        want = emb.embedding_bag_backward_reference(gs[0], offsets, ids[0], rows, window=w)
        tol = emb.backward_tolerance(gs[0], offsets, ids[0], rows, window=w)
        grad = torch.zeros_like(want)
        for label, lib in libs.items():
            grad.zero_()
            call(lib, gs[0], offsets, ids[0], lo, rows, grad, tr)
            err = (grad - want).abs()
            if not bool((err <= tol).all()):
                raise AssertionError(f"K1b's window ({label}) disagrees with its plain version "
                                     f"({name} {place}): max |err| {err.max().item():.3e}")
        del want, tol, err
        args = list(zip(gs, ids))
        fns = {label: (lambda g, i, lib=lib: call(lib, g, offsets, i, lo, rows, grad, tr))
               for label, lib in libs.items()}
        spans = {label: [] for label in fns}
        for label in list(fns) + list(fns)[::-1]:
            spans[label].append(span_ms(fns[label], args))
        for label, fn in fns.items():
            run = measure(fn, args)
            row = {"model": name, "place": place, "window": [lo, lo + rows],
                   "tables": [tr.lo, tr.hi], "design": label,
                   "span_ms": float(np.mean(spans[label])), "spans_ms": spans[label],
                   "kernel_ms": run["kernel_ms"]}
            log(f"{name} {place} rows [{lo}, {lo + rows}) tables [{tr.lo}, {tr.hi}) {label}: "
                f"span {_us(row['span_ms'])} ({', '.join(_us(x) for x in spans[label])}); "
                f"kernel {_us(row['kernel_ms'])}")
            rows_out.append(row)
        del inp, grad, gs, args, fns
        torch.cuda.empty_cache()
    return rows_out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1bw_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k1bw_sweep] {msg}", flush=True)

    from deeprecsys_tpu_torch.kernel_bench import card_line

    card = card_line()
    log(f"card: {card}")
    with torch.inference_mode():
        rows = sweep(log)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
