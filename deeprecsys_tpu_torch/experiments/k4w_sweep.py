"""K4's ownership window: the shipped zero tasks against larger and smaller
ones, the meeting bags' index arithmetic in 32 bits, and 4 rows a slot a
step at d = 32, on one card.

    python -m deeprecsys_tpu_torch.experiments.k4w_sweep [--json PATH]

``ops/csrc/embedding_bag_int8.cu`` ships one design of a row shard's
row-wise int8 lookup: ``k4_launch_plan``'s groups of G bags over the bags
of the tables that meet the shard, then zero tasks that write the other
tables' partial rows, ``kZeroBags`` bags a warp. This script writes
translation units into ``build/k4w_sweep/``, each the shipped source (its
headers inlined) with one substitution: ``kZeroBags`` 8 and 128,
``window_bag`` (``csrc/window_tables.cuh``) in 32-bit arithmetic, and the
long-bag mapping at d = 32 built and launched with U = 4 rows a slot a step
(the shipped U = 2 takes three steps of an 80-row bag). Each is
held to the window's plain version (``rowwise_tolerance``) and timed
(``kernel_bench.span_ms``, and its launch by ``kernel_bench.measure``) in
turns (ABBA over the designs) at ``parent_turns.WINDOW_PLACES``, batch 512.

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

ZERO = "constexpr int kZeroBags = 32;"
BAG64 = "  return (k / w.nt) * T + w.t_lo + k % w.nt;"
BAG32 = ("  const int k32 = (int)k;\n"
         "  return (int64_t)(k32 / w.nt) * T + w.t_lo + k32 % w.nt;")
U32 = "  constexpr int UL = D == 32 ? 2 : 3;"
DESIGNS = {  # label: (substitutions, foreign bags a zero task, long-bag U at d 32)
    "shipped (32 bags a zero task)": ([], 32, 2),
    "8 bags a zero task": ([(ZERO, "constexpr int kZeroBags = 8;")], 8, 2),
    "128 bags a zero task": ([(ZERO, "constexpr int kZeroBags = 128;")], 128, 2),
    "32-bit window_bag": ([(BAG64, BAG32)], 32, 2),
    "U 4 at d 32": ([(U32, "  constexpr int UL = D == 32 ? 4 : 3;")], 32, 4),
}
ENTRY = "drs_embedding_bag_int8_rowwise_window"


def units(csrc: Path) -> dict:
    """``{stem: source}``: the shipped source with its two headers inlined
    and each design's lines substituted."""
    text = csrc.joinpath("embedding_bag_int8.cu").read_text()
    for h in ("pooled_rows.cuh", "window_tables.cuh"):
        text = text.replace(f'#include "{h}"', csrc.joinpath(h).read_text())
    out = {}
    for n, (subs, *_) in enumerate(DESIGNS.values()):
        body = text
        for old, new in subs:
            if body.count(old) != 1:
                raise RuntimeError(f"the source no longer reads as the sweep expects: {old!r}")
            body = body.replace(old, new)
        out[f"k4w_{n}"] = body
    return out


def call(lib, zero_bags: int, u32: int, shard, offsets, indices, row_lo: int, tr):
    """One design's window launch (the wrapper's arguments, its plan's
    groups, ``zero_bags`` foreign bags a zero task and ``u32`` rows a slot
    a step for long bags at d = 32); returns the partial."""
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops.embedding import K1_WARPS_PER_BLOCK, k4_launch_plan

    B, T, L = indices.shape
    d = shard.shape[1] - 4
    nt = tr.hi - tr.lo
    plan = k4_launch_plan(B * nt, L, d)
    u = u32 if d == 32 and L > 8 else plan.rows_per_lane
    tasks = plan.tasks + -(-B * (T - nt) // zero_bags)
    out = torch.empty((B, T, d), dtype=torch.float32, device=shard.device)
    _build.launch(lib, ENTRY, shard.device, shard.data_ptr(), d, offsets.data_ptr(),
                  indices.data_ptr(), None, out.data_ptr(), row_lo, shard.shape[0],
                  *tr.kernel_args, B * T, T, L, plan.bags_per_warp, u,
                  max(1, -(-tasks // K1_WARPS_PER_BLOCK)))
    return out


def sweep(log) -> list:
    from deeprecsys_tpu_torch.experiments.parent_turns import (
        BATCH, WINDOW_PLACES, k4w_call, window_inputs)
    from deeprecsys_tpu_torch.experiments.sweep_build import build_units
    from deeprecsys_tpu_torch.kernel_bench import _us, measure, span_ms
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops import embedding as emb

    argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                + [ctypes.c_int64, ctypes.c_int64] + [ctypes.c_int] * 4
                + [ctypes.c_int64, ctypes.c_int, ctypes.c_int] + [ctypes.c_int] * 3
                + [ctypes.c_void_p])
    built = build_units("k4w_sweep", units(_build.CSRC), ENTRY, argtypes)
    libs = {}
    for label, (lib, ptxas) in zip(DESIGNS, built.values()):
        lib.drs_cuda_error_string.restype = ctypes.c_char_p
        lib.drs_cuda_error_string.argtypes = [ctypes.c_int]
        libs[label] = lib
        log(f"{label}: ptxas " + "; ".join(x for x in ptxas if "rowwise_kernel" in x
                                          and x.split(":")[0].endswith("1>")))
    device = torch.device("cuda")
    rows_out = []
    for name, place in WINDOW_PLACES:
        inp = window_inputs(name, place, BATCH, device)
        lo, rows, offsets, ids = (inp[k] for k in ("row_lo", "rows", "offsets", "ids"))
        _, _, _, shard = k4w_call(inp, device)
        tr = emb.table_range_of(offsets, lo, rows)
        w = (lo, lo + rows)
        want = emb.embedding_bag_int8_rowwise_reference(shard, offsets, ids[0], window=w)
        for label, lib in libs.items():
            got = call(lib, *DESIGNS[label][1:], shard, offsets, ids[0], lo, tr)
            tol = emb.rowwise_tolerance(got, want, shard, offsets, ids[0], window=w)
            if not bool(((got - want).abs() <= tol).all()):
                raise AssertionError(f"K4's window ({label}) disagrees with its plain version "
                                     f"({name} {place})")
        del want, got, tol
        args = [(i,) for i in ids]
        fns = {label: (lambda i, lib=lib, des=DESIGNS[label][1:]:
                       call(lib, *des, shard, offsets, i, lo, tr))
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
        del inp, shard, args, fns
        torch.cuda.empty_cache()
    return rows_out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4w_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k4w_sweep] {msg}", flush=True)

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
