"""Design sweep of K1's ownership window (a row shard's lookup) on one card.

    python -m deeprecsys_tpu_torch.experiments.k1w_sweep [--json PATH]

``ops/csrc/embedding_bag.cu`` ships two window designs, which
``ops.embedding.k1_window_plan`` picks between: the direct mapping's window
(a warp a bag, U rows a slot a step, every slot walked and tested where
its row is loaded) and the compacted gather (a warp reads 128 of its bag's
ids at once, packs the owned ones into shared memory by a ballot and a
prefix count, then gathers only those, U rows a slot a step). This script
writes a translation unit into ``build/k1w_sweep/`` that includes that
source and adds one C entry point over both designs at more U than ship
(``K1W_SWEEP``), builds it (``experiments.sweep_build``), holds each to
the window's plain version and times it (the kernel's median) at
``kernel_bench``'s K1 window cells (rm1 and rm2, shard 1 of 1x4 and of
2x2, bf16 tables, f32 partials), with each instance's ptxas line.

At each cell it then times what a shard that owns no row costs, the
floor of any design that reads the ids the shard is given: the direct
window (U = 4) and the compacted gather (U = 8) on an empty window, and a
minimal kernel of the same grid (a warp a bag, the bag's ids in 4
coalesced 4-byte loads a lane at once, the ownership test) that writes
the bag's partial, or writes nothing and only reads the ids.

It needs a CUDA card and exits non-zero without one. It imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

# The sweep's instances: the direct mapping's window (a warp a bag, U rows
# a slot a step, every slot walked) and the compacted gather at U rows a
# slot; then the floors, which gather no row.
K1W_SWEEP = (("direct", 4), ("direct", 8), ("compact", 2), ("compact", 4), ("compact", 8))
DESIGNS = {"direct": 0, "compact": 1, "ids_partial": 2, "ids_only": 3}
WIDTHS = (32, 64)  # the long-bag models' d (rm1 32, rm2 64)
ARGTYPES = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 3 + \
    [ctypes.c_int] * 3 + [ctypes.c_void_p]

_FLOOR = """
// A window design's floor on a shard that owns no row (not shipped): a warp
// a bag reads the bag's ids in windows of kCompactIds (kCompactIds / 32
// coalesced 4-byte loads a lane at once, as the compacted gather does) and
// tests each against the window; with `partial` it writes the bag's (D,)
// f32 partial (zeros on such a shard), else it writes only where an id was
// owned (never, on such a shard), so it only reads the ids.
template <int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
k1w_floor_kernel(const int32_t* __restrict__ offsets, const int32_t* __restrict__ indices,
                 float* __restrict__ out, int64_t n_bags, int T, int L, int64_t row_lo,
                 int64_t n_rows, int partial) {
  constexpr int NI = kCompactIds / 32;
  const int lane = threadIdx.x & 31;
  for (int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); bag < n_bags;
       bag += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t base = (int64_t)__ldg(offsets + bag % T) - row_lo;
    bool owned = false;
    for (int w0 = 0; w0 < L; w0 += kCompactIds) {
      int32_t ids[NI];
#pragma unroll
      for (int r = 0; r < NI; ++r) {
        const int l = w0 + r * 32 + lane;
        ids[r] = l < L ? __ldg(indices + bag * L + l) : -1;
      }
#pragma unroll
      for (int r = 0; r < NI; ++r)
        owned |= ids[r] >= 0 && (uint64_t)(base + ids[r]) < (uint64_t)n_rows;
    }
    owned = __any_sync(0xffffffffu, owned);
    if (partial || owned) {
      for (int c = lane; c < D / 4; c += 32)
        reinterpret_cast<float4*>(out + bag * D)[c] = make_float4(owned ? 1.f : 0.f, 0.f, 0.f, 0.f);
    }
  }
}
"""


def unit(src: Path) -> str:
    """A translation unit over the shipped K1 source with one entry point
    that launches a window design at a given U (bf16 table, f32 partial,
    d 32 or 64), or a floor kernel (``DESIGNS``; U ignored)."""
    cases = []
    for d in WIDTHS:
        for design, u in K1W_SWEEP:
            kernel = (f"embedding_bag_compact_kernel<__nv_bfloat16, float, {d}, {u}>"
                      if design == "compact" else
                      f"embedding_bag_kernel<__nv_bfloat16, float, {d}, 1, {u}, float, true>")
            cases.append(f"  if (design == {DESIGNS[design]} && U == {u} && d == {d}) {{\n"
                         f"    {kernel}<<<grid, kWarpsPerBlock * 32, 0, s>>>(\n"
                         f"        static_cast<const __nv_bfloat16*>(table), off, idx, nullptr,\n"
                         f"        static_cast<float*>(out), n_bags, T, L, row_lo, n_rows);\n"
                         f"    return (int)cudaGetLastError();\n  }}")
        cases.append(f"  if (design >= {DESIGNS['ids_partial']} && d == {d}) {{\n"
                     f"    k1w_floor_kernel<{d}><<<grid, kWarpsPerBlock * 32, 0, s>>>(\n"
                     f"        off, idx, static_cast<float*>(out), n_bags, T, L, row_lo, n_rows,\n"
                     f"        design == {DESIGNS['ids_partial']});\n"
                     f"    return (int)cudaGetLastError();\n  }}")
    body = "\n".join(cases)
    return f"""#include "{src}"
namespace {{
{_FLOOR}
}}  // namespace

extern "C" int drs_k1w_sweep(int design, int U, int d, const void* table, const void* offsets,
                             const void* indices, void* out, int64_t row_lo, int64_t n_rows,
                             int64_t n_bags, int T, int L, int grid, void* stream) {{
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
{body}
  return (int)cudaErrorInvalidValue;
}}
"""


def sweep(log) -> list:
    """Each (design, U) of K1W_SWEEP, then the empty-window floors, at
    ``kernel_bench``'s K1 window cells; returns a row for each."""
    from deeprecsys_tpu_torch.experiments.sweep_build import build_units, ptxas_of
    from deeprecsys_tpu_torch.kernel_bench import (
        K1W_CELLS, K1W_MODELS, _k1w_check, _us, k1w_inputs, measure, window_bound)
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops.embedding import K1_WARPS_PER_BLOCK

    lib, lines = build_units("k1w_sweep", {"k1w": unit(_build.CSRC / "embedding_bag.cu")},
                             "drs_k1w_sweep", ARGTYPES)["k1w"]
    device = torch.device("cuda")
    rows = []
    for name in K1W_MODELS:
        for M, B in K1W_CELLS:
            inp = k1w_inputs(name, M, B, device)
            shard, lo, offsets = inp["shard"], inp["row_lo"], inp["offsets"]
            d = shard.shape[1]
            bound = window_bound(shard, lo, offsets, inp["ids"][0], d)

            def call(i, design, u, n_rows=shard.shape[0]):
                Bi, T, L = i.shape
                out = torch.empty((Bi, T, d), dtype=torch.float32, device=device)
                grid = -(-Bi * T // K1_WARPS_PER_BLOCK)
                _build.launch(lib, "drs_k1w_sweep", device, DESIGNS[design], u, d,
                              shard.data_ptr(), offsets.data_ptr(), i.data_ptr(), out.data_ptr(),
                              lo, n_rows, Bi * T, T, L, grid)
                return out

            args = [(i,) for i in inp["ids"]]
            cell = {"model": name, "shard": f"1/{M}", "bound_ms": bound["bound_ms"]}
            for design, u in K1W_SWEEP:
                _k1w_check(call(inp["ids"][0], design, u), inp, inp["ids"][0], f"{design} U={u}")
                run = measure(lambda i, design=design, u=u: call(i, design, u), args)
                kernel = ("embedding_bag_compact_kernel" if design == "compact"
                          else "embedding_bag_kernel")
                row = {**cell, "design": design, "U": u, "ms": run["kernel_ms"],
                       "ptxas": ptxas_of(lines, f"{kernel}<bf16, f32, {d}, "
                                         + (f"{u}>" if design == "compact" else f"1, {u}, f32, 1>"))}
                log(f"{name} shard 1/{M}: {design} U={u}: {_us(row['ms'])} "
                    f"({100 * row['bound_ms'] / row['ms']:.1f}% of the bound "
                    f"{_us(row['bound_ms'])}); ptxas {row['ptxas']}")
                rows.append(row)
            for design, u in (("direct", 4), ("compact", 8), ("ids_partial", 0),
                              ("ids_only", 0)):
                if design != "ids_only" and torch.count_nonzero(
                        call(inp["ids"][0], design, u, n_rows=0)):
                    raise AssertionError(f"{design} wrote a nonzero partial on an empty window")
                run = measure(lambda i, design=design, u=u: call(i, design, u, n_rows=0), args)
                row = {**cell, "design": f"{design} on an empty window", "U": u,
                       "ms": run["kernel_ms"]}
                log(f"{name} shard 1/{M}: {row['design']}"
                    + (f" U={u}" if u else "") + f": {_us(row['ms'])}")
                rows.append(row)
            del inp, shard
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    from deeprecsys_tpu_torch.kernel_bench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1w_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k1w_sweep] {msg}", flush=True)

    card = card_line()
    log(f"card: {card}")
    with torch.inference_mode():
        res = {"card": card, "rows": sweep(log)}
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
