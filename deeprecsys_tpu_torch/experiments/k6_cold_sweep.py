"""Where the time of K6's cold-only route goes, on one card.

    python -m deeprecsys_tpu_torch.experiments.k6_cold_sweep [--json PATH]

``ops/csrc/embedding_bag_hotcold.cu`` ships the cold-only instance (a warp
a chunk of the cold stream; the pad-only chunks find the first pad by a
search and zero their share of the bags past the last real entry). This
script builds that source and copies of it with one step taken out or
cut down or laid out otherwise (``VARIANTS``: the first-pad search, the
zero stores, the whole body, the pad-only chunks' share inline, a chunk's
analysis out of line, the registers, the row loads, the rows in flight,
the id loads)
into
``build/k6_cold_sweep/``, and times each (the kernel's median) at the 1x4
hot/cold mesh's shard 1 of rm1 and of rm2 on batches after the one the hot
set was fitted on (``kernel_bench.hotcold_shard_inputs``, bf16 tables, f32
partials),
beside the shipped wrapper; the shipped copy is held to the plain version.
A variant with a step taken out computes something else: it is timed,
never checked.

It needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

import torch

# Each variant: the source with one substitution (pattern, replacement),
# made wherever the pattern matches.
VARIANTS = {
    "shipped": None,
    "no first-pad search": (r"first_pad\(cold_seg, c0 - 1, n_bags,\s*lane\)", "0"),
    "no zero stores": (r"for \(int64_t w = lane; w < n; w \+= 32\) p\[w\] = make_uint4"
                       r"\(0u, 0u, 0u, 0u\);", "(void)p; (void)n;"),
    "empty body": (r"(embedding_bag_cold_partial_kernel\(const TIn\* __restrict__ table,[^{]*\{)",
                   r"\1\n  if (n_bags > 0) return;"),
    # The pad-only chunks' share inline; a chunk's analysis out of line.
    "pad share inline": (r"__device__ __noinline__ BagRange pad_share",
                         "__device__ __forceinline__ BagRange pad_share"),
    "begun bags out of line": (r"__device__ __forceinline__ void begun_bags",
                               "__device__ __noinline__ void begun_bags"),
    # Registers: one block an SM (255 registers a thread, no spills), not four.
    "one block an SM": (r"__launch_bounds__\(kWarpsPerBlock \* 32, kMinBlocksPerSm\)\n"
                        r"embedding_bag_cold_partial_kernel",
                        "__launch_bounds__(kWarpsPerBlock * 32, 1)\n"
                        "embedding_bag_cold_partial_kernel"),
    "no row loads": (r"add_rows<M, TIn, TC, D, V, H>\(acc, table, table, code, lane\);",
                     "(void)code;"),
    "one row a step": (r"constexpr int U = M == kRowwise \? kColdRows / 2 : kColdRows;",
                       "constexpr int U = 1;"),
    "no id loads": (r"c.id\[0\] = i0 < c_pad \? __ldg\(cold_ids \+ i0\) : 0;",
                    "c.id[0] = 0;"),
}
MODELS = ("rm1", "rm2")
ARGTYPES = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_void_p,
                                                           ctypes.c_int, ctypes.c_int64,
                                                           ctypes.c_int, ctypes.c_void_p])


def units(src: Path) -> dict:
    """``{variant stem: source}``: the shipped source, then each
    substitution applied."""
    text = src.read_text()
    out = {}
    for n, (name, sub) in enumerate(VARIANTS.items()):
        body = text
        if sub is not None:
            body, count = re.subn(sub[0], sub[1], text)
            if count == 0:
                raise RuntimeError(f"variant {name!r} no longer matches the source")
        out[f"k6_cold_{n}"] = body.replace('#include "pooled_rows.cuh"',
                                           f'#include "{src.parent / "pooled_rows.cuh"}"')
    return out


def _call(lib, shard, split: dict):
    from deeprecsys_tpu_torch.ops.embedding import k6_cold_grid

    B, T = split["bags"]
    out = torch.empty((B, T, shard.shape[1]), dtype=torch.float32, device=shard.device)
    err = lib.drs_embedding_bag_cold_partial(
        0, 1, shard.shape[1], shard.data_ptr(), split["cold_ids"].data_ptr(),
        split["cold_seg"].data_ptr(), split["cold_ids"].numel(), out.data_ptr(), 1, B * T,
        k6_cold_grid(split["cold_ids"].numel()), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"the cold-only instance failed to launch ({err})")
    return out


def sweep(log) -> list:
    from deeprecsys_tpu_torch.experiments.sweep_build import build_units
    from deeprecsys_tpu_torch.kernel_bench import hotcold_shard_inputs, measure
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops.embedding import (
        cold_tolerance, embedding_bag_cold_partial_reference, embedding_bag_hotcold_shard)

    built = build_units("k6_cold_sweep", units(_build.CSRC / "embedding_bag_hotcold.cu"),
                        "drs_embedding_bag_cold_partial", ARGTYPES)
    rows = []
    for name in MODELS:
        inp = hotcold_shard_inputs(name, "none", torch.device("cuda"))
        shard = inp["shards"][1]
        splits = [{k: s[1][k] for k in ("cold_ids", "cold_seg", "bags")} for s in inp["splits"]]
        row = {"model": name, "c_pad": splits[0]["cold_ids"].numel(),
               "n_cold": sum(n[1] for n in inp["n_cold"]) / len(inp["n_cold"])}
        want = embedding_bag_cold_partial_reference(shard, splits[0],
                                                    compute_dtype=torch.bfloat16)
        for (variant, (lib, _)) in zip(VARIANTS, built.values()):
            if variant == "shipped":
                got = _call(lib, shard, splits[0])
                if not bool(((got - want).abs()
                             <= cold_tolerance(got, want, shard, splits[0])).all()):
                    raise AssertionError(f"the cold-only instance disagrees at {name}")
            run = measure(lambda s, lib=lib: _call(lib, shard, s), [(s,) for s in splits])
            row[variant] = run["kernel_ms"]
        row["wrapper"] = measure(lambda s: embedding_bag_hotcold_shard(
            None, shard, s, compute_dtype=torch.bfloat16), [(s,) for s in splits])["kernel_ms"]
        log(f"{name} shard 1/4 (C_pad {row['c_pad']}, {row['n_cold']:.0f} cold a batch): "
            + "; ".join(f"{k} {v * 1e3:.2f} us" for k, v in row.items()
                        if k in VARIANTS or k == "wrapper"))
        rows.append(row)
        del inp
        torch.cuda.empty_cache()
    for (lib, ptx) in built.values():
        log("ptxas " + "; ".join(x for x in ptx if "cold_partial_kernel" in x))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k6_cold_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k6_cold_sweep] {msg}", flush=True)

    with torch.inference_mode():
        rows = sweep(log)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
