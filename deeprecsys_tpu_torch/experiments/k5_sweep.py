"""Design sweep of the sparse row-wise AdaGrad step K5 on one card.

    python -m deeprecsys_tpu_torch.experiments.k5_sweep [--json PATH] [--mean_order]

``ops/csrc/sparse_adagrad.cu`` ships one design (``Shipped`` there):
launch 1 on ``k5_launch_plan``'s lanes a bag, launch 2 with 16-byte vector
atomic adds and programmatic dependent launch (PDL). This script measures
each of those steps: it writes a translation unit into ``build/k5_sweep/``
that includes that source and adds one C entry point over launch 2's add
widths (4, 8 and 16 bytes a lane: scalar f32 adds or bf16x2 pairs, then
vectors; ``instances``), each with launch 1 on the plan's lanes a bag or
on a whole warp a bag, with PDL on and off (``variants``), builds it
(``experiments.sweep_build``), holds every variant to the plain version
within ``sparse_adagrad_tolerance`` and times it at the trainer's two
sparse shapes (``kernel_bench.K5_MODELS``: rm1 B 128, T 8, L 80; dien
B 128, T 43, L 1; d 32, full-size tables, f32 gradients) with f32 and bf16 tables, beside the
shipped wrapper. A variant's time is its span (``kernel_bench.span_ms``:
the device time from launch 1's start to launch 2's end, gaps and overlap
included) and the sum of its two launches' medians.

``--mean_order`` first finds the order in which ``torch.mean`` adds a row
of 32 and of 64 f32 squares on the card (``mean_orders``: each candidate
order written as elementwise tensor adds, held to ``torch.mean`` on 2^20
random rows): launch 1 sums a bag's squares in that order, so that the
plain version's accumulator is the kernel's bit for bit.

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

ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
            + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
T_TYPES = {torch.float32: "float", torch.bfloat16: "__nv_bfloat16"}
SHIPPED_PREFETCH = 0       # Shipped::kPrefetch in the source
SHIPPED_MAPPING = "flat"   # the source's apply_kernel; "window" is WINDOW_KERNEL here
D = 32  # the sparse steps' width (kernel_bench.K5_MODELS: rm1 and dien)


def instances() -> list:
    """Launch 2's bytes a lane's atomic add: 4 (the parent's scalar f32
    adds; bf16x2 pairs for bf16 tables), 8 and 16 (vector adds)."""
    return [4, 8, 16]


MAPPINGS = ("flat", "window")  # launch 2: a group of lanes a slot, or a warp a window of 32


def keys() -> list:
    """``(table dtype, bytes an add, mapping, prefetch)``: every add width
    and mapping with the shipped prefetch, and every prefetch at 16 bytes."""
    return list(dict.fromkeys(
        [(tt, vb, m, SHIPPED_PREFETCH) for tt in T_TYPES for vb in instances() for m in MAPPINGS]
        + [(tt, 16, m, pf) for tt in T_TYPES for m in MAPPINGS for pf in PREFETCH]))


PREFETCH = {0: "none", 1: "rows", 2: "acc", 3: "rows+acc"}  # launch 1's L2 prefetches


def variants(L: int, key: tuple) -> list:
    """``(lanes a bag in launch 1, pdl)`` for instance ``key``: the plan's
    lanes with PDL on and off; at the shipped add width, mapping and
    prefetch also a warp a bag's window (the parent's launch 1) with PDL."""
    from deeprecsys_tpu_torch.ops.sparse_adagrad import k5_launch_plan

    plan = k5_launch_plan(1, L, D, torch.float32).lanes_per_bag
    out = [(plan, True), (plan, False)]
    if key[1:] == (16, SHIPPED_MAPPING, SHIPPED_PREFETCH):
        out += [(32, True)]
    return list(dict.fromkeys(out))


# Launch 2 mapped a warp a window of 32 slots: the other mapping the sweep
# measures (``MAPPINGS``), kept out of the shipped source.
WINDOW_KERNEL = """// Launch 2, mapped a warp a window of 32 consecutive slots (flat over the
// B*T*L slots, so a window may hold several short bags): each lane loads
// one slot's id and, after the wait, its accumulator, then the warp walks
// the window R slots an instruction (R = 32 / S lanes a slot), each group
// of S lanes taking its slot's row and scale by shuffles, loading the
// bag's gradient values and adding them to the row.
template <typename TT, typename TG, int D, int VB>
__global__ void __launch_bounds__(kThreads)
apply_window_kernel(TT* __restrict__ table, const float* __restrict__ acc,
                    const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ indices, int64_t n_slots, int T, int L,
                    float neg_lr, float eps) {
  constexpr int E = VB / (int)sizeof(TT);
  constexpr int P = D / E;
  constexpr int S = P < 32 ? P : 32;
  constexpr int K = P / S;
  constexpr int R = 32 / S;
  const int lane = threadIdx.x & 31;
  const int64_t first = ((int64_t)blockIdx.x * kThreads + threadIdx.x) - lane;
  const int64_t slot = first + lane;
  int64_t row = -1, bag = 0;
  if (slot < n_slots) {
    bag = slot / L;
    row = (int64_t)__ldg(offsets + bag % T) + __ldg(indices + slot);
  }
  wait_accumulated();
  const float s = row >= 0 ? rsqrtf(__ldcg(acc + row) + eps) : 0.f;
  const int j = lane % S;
#pragma unroll
  for (int step = 0; step < 32 / R; ++step) {
    const int q = step * R + lane / S;
    const int64_t r = __shfl_sync(0xffffffffu, row, q);
    const float sc = __shfl_sync(0xffffffffu, s, q);
    const int64_t b = __shfl_sync(0xffffffffu, bag, q);
    if (r < 0) continue;
    float v[K][E];
#pragma unroll
    for (int k = 0; k < K; ++k) load_g<TG, E>(g + b * D + (j + k * S) * E, v[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[k][e] = neg_lr * (v[k][e] * sc);
      red_add<TT, E>(table + r * D + (j + k * S) * E, v[k]);
    }
  }
}

template <typename TT, typename TG, int D, int VB, int PF>
int launch_window(const Args& a, int lanes_per_bag, bool pdl) {
  const int err = accumulate<TG, D, PF>(a, D * (int)sizeof(TT), lanes_per_bag);
  if (err != 0) return err;
  return launch_apply(apply_window_kernel<TT, TG, D, VB>, a, (a.n_bags * a.L + 31) / 32 * 32,
                      pdl);
}
"""


def _source(src: Path, group: list) -> str:
    cases = "\n".join(
        f"    case {n}: return {'launch_window' if m == 'window' else 'launch'}"
        f"<{T_TYPES[tt]}, float, {D}, {vb}, {pf}>(a, lanes_per_bag, pdl);"
        for n, (tt, vb, m, pf) in enumerate(group))
    return f"""#include "{src}"
namespace {{
{WINDOW_KERNEL}
}}  // namespace
extern "C" int drs_k5_sweep(int key, void* table, void* acc, const void* g, const void* offsets,
                            const void* indices, int64_t n_bags, int T, int L, float neg_lr,
                            float eps, int lanes_per_bag, int pdl, void* stream) {{
  const Args a = {{table, static_cast<float*>(acc), g, static_cast<const int32_t*>(offsets),
                  static_cast<const int32_t*>(indices), n_bags, T, L, neg_lr, eps,
                  static_cast<cudaStream_t>(stream)}};
  switch (key) {{
{cases}
    default: return (int)cudaErrorInvalidValue;
  }}
}}

// Probes, for measurement only: launch 1 as shipped, then launch 2 (f32
// table, no PDL) with plain 16-byte read-modify-writes where the step has
// atomic adds (mode 0: loses an add where a row repeats in the batch), or
// with atomic adds and no accumulator read (mode 1: scale 1).
template <int D, int MODE>
__global__ void __launch_bounds__(kThreads)
probe_apply_kernel(float* __restrict__ table, const float* __restrict__ acc,
                   const float* __restrict__ g, const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ indices, int64_t n_slots, int T, int L,
                   float neg_lr, float eps) {{
  constexpr int S = D / 4;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t slot = t / S;
  const int j = (int)(t % S);
  if (slot >= n_slots) return;
  const int64_t bag = slot / L;
  const int64_t row = (int64_t)__ldg(offsets + bag % T) + __ldg(indices + slot);
  float v[4];
  load_g<float, 4>(g + bag * D + j * 4, v);
  const float s = MODE == 1 ? 1.f : rsqrtf(__ldcg(acc + row) + eps);
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = neg_lr * (v[e] * s);
  float* dst = table + row * D + j * 4;
  if constexpr (MODE == 0) {{
    float4 x = *reinterpret_cast<float4*>(dst);
    x.x += v[0]; x.y += v[1]; x.z += v[2]; x.w += v[3];
    *reinterpret_cast<float4*>(dst) = x;
  }} else {{
    red_add<float, 4>(dst, v);
  }}
}}

extern "C" int drs_k5_probe(int mode, void* table, void* acc, const void* g, const void* offsets,
                            const void* indices, int64_t n_bags, int T, int L, float neg_lr,
                            float eps, int lanes_per_bag, void* stream) {{
  const Args a = {{table, static_cast<float*>(acc), g, static_cast<const int32_t*>(offsets),
                  static_cast<const int32_t*>(indices), n_bags, T, L, neg_lr, eps,
                  static_cast<cudaStream_t>(stream)}};
  int err;
  switch (lanes_per_bag) {{
    case 8: err = launch_accumulate<float, {D}, 8, 0>(a, {D} * 4); break;
    case 32: err = launch_accumulate<float, {D}, 32, 0>(a, {D} * 4); break;
    default: return (int)cudaErrorInvalidValue;
  }}
  if (err != 0) return err;
  const int64_t n_slots = n_bags * L;
  const unsigned blocks = (unsigned)((n_slots * ({D} / 4) + kThreads - 1) / kThreads);
  if (mode == 0)
    probe_apply_kernel<{D}, 0><<<blocks, kThreads, 0, a.stream>>>(
        static_cast<float*>(table), a.acc, static_cast<const float*>(g), a.offsets, a.indices,
        n_slots, T, L, neg_lr, eps);
  else
    probe_apply_kernel<{D}, 1><<<blocks, kThreads, 0, a.stream>>>(
        static_cast<float*>(table), a.acc, static_cast<const float*>(g), a.offsets, a.indices,
        n_slots, T, L, neg_lr, eps);
  return (int)cudaGetLastError();
}}
"""


def build_all(log) -> tuple:
    """Every instance, four translation units compiled in parallel:
    ({key: (CDLL, case)}, ptxas lines)."""
    from deeprecsys_tpu_torch.ops import _build

    src, ks = _build.CSRC / "sparse_adagrad.cu", keys()
    groups = [g for g in (ks[i::4] for i in range(4)) if g]
    built = build_units("k5_sweep", {f"k5_sweep_{n}": _source(src, g)
                                     for n, g in enumerate(groups)}, "drs_k5_sweep", ARGTYPES)
    libs, lines = {}, []
    for group, (lib, ptx) in zip(groups, built.values()):
        # The probes' arguments: the sweep's without pdl.
        lib.drs_k5_probe.restype = ctypes.c_int
        lib.drs_k5_probe.argtypes = ARGTYPES[:-2] + [ctypes.c_void_p]
        for i, key in enumerate(group):
            libs[key] = (lib, i)
        lines += ptx
    log(f"{len(ks)} instances; ptxas " + "; ".join(lines))
    return libs, lines


def _call(lib_i, variant: tuple, table, acc, offsets, indices, g, lr: float = 0.1,
          eps: float = 1e-8):
    lib, i = lib_i
    lanes, pdl = variant
    B, T, L = indices.shape
    err = lib.drs_k5_sweep(i, table.data_ptr(), acc.data_ptr(), g.data_ptr(), offsets.data_ptr(),
                           indices.data_ptr(), B * T, T, L, -lr, eps, lanes, int(pdl),
                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sweep instance {i} failed to launch ({err})")


def _ptxas_of(lines: list, key) -> str:
    tt, vb, m, _ = key
    kernel = "apply_window_kernel" if m == "window" else "apply_kernel"
    return ptxas_of(lines, f"{kernel}<{'f32' if tt == torch.float32 else 'bf16'}, f32, {D}, {vb}>")


def _probe(lib, mode: int, lanes: int, table, acc, offsets, indices, g):
    B, T, L = indices.shape
    err = lib.drs_k5_probe(mode, table.data_ptr(), acc.data_ptr(), g.data_ptr(),
                           offsets.data_ptr(), indices.data_ptr(), B * T, T, L, -0.1, 1e-8,
                           lanes, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"probe {mode} failed to launch ({err})")


PROBES = {0: "plain 16-byte read-modify-writes, no atomics", 1: "atomic adds, no accumulator read"}


def time_k5(fn, inp: dict, tdt: torch.dtype, iters: int = 100) -> dict:
    """``fn(table, acc, offsets, indices, g)``'s span, the sum of its
    launches' medians and each launch's median over the batches, on a
    random table of ``tdt`` and a zero accumulator."""
    from deeprecsys_tpu_torch.kernel_bench import k5_tables, measure, named_kernel_ms, span_ms

    table, acc = k5_tables(inp, tdt)
    offsets, args = inp["offsets"], list(zip(inp["ids"], inp["gs"]))

    def call(i, g):
        fn(table, acc, offsets, i, g)
    run = measure(call, args, iters)
    return {"span_ms": span_ms(call, args, iters), "launch_sum_ms": run["launch_sum_ms"],
            "accumulate_ms": named_kernel_ms(run, "accumulate"),
            "apply_ms": named_kernel_ms(run, "apply"), "wall_ms": run["wall_ms"]}


def sweep(libs: dict, lines: list, log) -> list:
    from deeprecsys_tpu_torch.kernel_bench import K5_MODELS, _us, k5_check, k5_inputs
    from deeprecsys_tpu_torch.ops import sparse_adagrad_step

    device = torch.device("cuda")
    rows = []
    for name in K5_MODELS:
        inp = k5_inputs(name, device)
        L = inp["ids"][0].shape[2]
        for tdt in T_TYPES:
            shipped = time_k5(lambda t, a, o, i, g: sparse_adagrad_step(t, a, o, i, g, 0.1),
                              inp, tdt)
            for key in [k for k in keys() if k[0] == tdt]:
                for var in variants(L, key):
                    lanes, pdl = var

                    def fn(t, a, o, i, g, key=key, var=var):
                        _call(libs[key], var, t, a, o, i, g)
                    try:
                        chk, fails = k5_check(fn, inp, tdt), None
                    except AssertionError as e:  # recorded: such a variant is never shipped
                        chk, fails = {"max_abs_err": float("nan")}, str(e)
                    got = time_k5(fn, inp, tdt)
                    row = {"model": name, "L": L, "table_dtype": str(tdt)[6:], "vec_bytes": key[1],
                           "mapping": key[2], "lanes_per_bag": lanes, "pdl": pdl,
                           "prefetch": PREFETCH[key[3]], **got, "shipped_span_ms": shipped["span_ms"],
                           "shipped_launch_sum_ms": shipped["launch_sum_ms"],
                           **chk, "fails": fails, "ptxas": _ptxas_of(lines, key)}
                    rows.append(row)
                    log(f"{name} L={L} table {row['table_dtype']} add {key[1]} B {key[2]}, {lanes} "
                        f"lanes a bag, pdl {int(pdl)}, prefetch {PREFETCH[key[3]]}: span "
                        f"{_us(got['span_ms'])}, launches {_us(got['launch_sum_ms'])} (accumulate "
                        f"{_us(got['accumulate_ms'])}, apply {_us(got['apply_ms'])}; shipped "
                        f"{_us(shipped['span_ms'])}, {_us(shipped['launch_sum_ms'])}); "
                        + (f"FAILS THE TOLERANCE: {fails}" if fails else
                           f"max |err| {chk['max_abs_err']:.2e}, accumulator unequal in "
                           f"{chk['acc_differ_once']} of {chk['rows_once']} rows of one add")
                        + f"; {row['ptxas']}")
            if tdt == torch.float32:
                lib = next(iter(libs.values()))[0]
                for mode, what in PROBES.items():
                    got = time_k5(lambda t, a, o, i, g, mode=mode: _probe(
                        lib, mode, variants(L, keys()[0])[0][0], t, a, o, i, g), inp, tdt)
                    rows.append({"model": name, "L": L, "table_dtype": "float32",
                                 "probe": what, **got})
                    log(f"{name} L={L} table float32 probe ({what}): span "
                        f"{_us(got['span_ms'])}, accumulate {_us(got['accumulate_ms'])}, "
                        f"launch 2 {_us(got['apply_ms'])}")
        del inp
        torch.cuda.empty_cache()
    return rows


def _halving(x: torch.Tensor) -> torch.Tensor:
    while x.shape[-1] > 1:
        n = x.shape[-1] // 2
        x = x[..., :n] + x[..., n:]
    return x[..., 0]


def _neighbours(x: torch.Tensor) -> torch.Tensor:
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _in_turn(x: torch.Tensor) -> torch.Tensor:
    s = x[..., 0]
    for i in range(1, x.shape[-1]):
        s = s + x[..., i]
    return s


MEAN_ORDERS = {"halving (t + D/2 onto t, then t + D/4, ...)": _halving,
               "neighbours ((x0 + x1) + (x2 + x3)) + ...": _neighbours,
               "in turn": _in_turn,
               "4 in turn, then halving": lambda x: _halving(_in_turn(x.unflatten(-1, (-1, 4)))),
               "4 in turn, then neighbours": lambda x: _neighbours(
                   _in_turn(x.unflatten(-1, (-1, 4))))}


def mean_orders(log, rows: int = 1 << 20) -> dict:
    """For D 32 and 64: in how many of ``rows`` random rows of f32 squares
    each order of ``MEAN_ORDERS`` (over D, divided by D) differs from
    ``torch.mean`` on the card."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for d in (32, 64):
        sq = (torch.randn((rows, d), generator=gen, device="cuda") * 1e-2) ** 2
        want = torch.mean(sq, dim=-1)
        out[d] = {name: int(((fn(sq) / d) != want).sum()) for name, fn in MEAN_ORDERS.items()}
        log(f"torch.mean over {rows} rows of {d} f32 squares, rows where an order differs: "
            + "; ".join(f"{k} {v}" for k, v in out[d].items()))
    return out


def main(argv=None) -> int:
    from deeprecsys_tpu_torch.kernel_bench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    p.add_argument("--mean_order", action="store_true",
                   help="first find the order of torch.mean's adds (mean_orders)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k5_sweep] {msg}", flush=True)

    card = card_line()
    log(f"card: {card}")
    res = {"card": card}
    with torch.inference_mode():
        if args.mean_order:
            res["mean_orders"] = mean_orders(log)
        libs, lines = build_all(log)
        res["rows"] = sweep(libs, lines, log)
    if args.json is not None:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
