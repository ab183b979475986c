"""K5's ownership window: the shipped design against a bag a task in
launch 1, with and without a list of the owned slots, and without
programmatic dependent launch, on one card.

    python -m deeprecsys_tpu_torch.experiments.k5w_sweep [--json PATH]

``ops/csrc/sparse_adagrad.cu`` ships one design of a row shard's step:
launch 1 a lane a slot, S lanes a window of a bag (an 80-slot bag is three
windows, each of which loads the bag's gradient row and computes its mean
g^2), and launch 2 over every slot of the stream (the direct plan). This
script writes translation units into ``build/k5w_sweep/`` that include that
source (one with ``Shipped::kPdl`` false) and add a second launch 1 that
takes a bag a task (a bag of up to 32 slots a segment of a warp, a longer
one a warp, 32 slots a round: its ids and gradient row read once, its mean
computed once), which on the list plan also appends each owned slot's
(row, bag) to a list (a ballot a round, one atomic add a warp for up to
``ROUNDS`` rounds) that a second launch 2 walks alone, on at most the
card's resident blocks. Each design is held to the window's plain version
(``sparse_adagrad_tolerance``) and its span timed (``kernel_bench.span_ms``)
in turns (ABBA over the designs) at ``CELLS``, f32 and bf16 shards (d 32
and 64, f32 gradients), with each launch's median (``kernel_bench.measure``).

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

CELLS = (("rm1", 4), ("rm1", 2), ("rm1", 1), ("rm2", 4))  # (model, model axis M)
PDL = ("static constexpr bool kPdl = true;", "static constexpr bool kPdl = false;")
ROUNDS = 4  # a warp's rounds of 32 slots between two appends
DESIGNS = ("shipped", "shipped, PDL off", "bag a task, direct", "bag a task, list")
ARGTYPES = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
             ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
             ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int64]
            + [ctypes.c_void_p] * 4)

_BAG = r"""
// The measured design (not shipped): launch 1 a bag a task, and the list.
constexpr int kBagRounds = %(rounds)d;

struct BagWindow {
  int64_t row_lo, n_rows;
  int lanes;        // lanes a bag (a power of two <= 32; 32 for a bag of more than 32 slots)
  int32_t* counts;  // [0] listed slots, [1] claimed entries: zero when the call starts
  int32_t* other;   // the previous call's pair, zeroed by launch 1
  int2* list;       // each owned slot's (row, bag), or null (launch 2 walks every slot)
  int32_t* entry;   // bf16: each listed slot's entry (list) or each slot's (-1: not owned)
  int32_t* keys;
  int64_t n_keys;
  int32_t* claimed;
  float* merged;
};

// Where the lanes that `take` one land in a list that grows by one atomic
// add a warp for all N rounds.
template <int N>
__device__ __forceinline__ void append_rounds(int32_t* count, const bool (&take)[N],
                                              int (&at)[N]) {
  const int lane = threadIdx.x & 31;
  unsigned ball[N];
  int total = 0;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    ball[r] = __ballot_sync(kFull, take[r]);
    total += __popc(ball[r]);
  }
  int base = 0;
  if (total != 0) {
    if (lane == 0) base = atomicAdd(count, total);
    base = __shfl_sync(kFull, base, 0);
  }
#pragma unroll
  for (int r = 0; r < N; ++r) {
    at[r] = take[r] ? base + __popc(ball[r] & ((1u << lane) - 1u)) : -1;
    base += __popc(ball[r]);
  }
}

template <typename TG, int D>
__global__ void __launch_bounds__(kThreads)
bag_accumulate_kernel(const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                      const int32_t* __restrict__ indices, float* __restrict__ acc,
                      int64_t n_bags, int T, int L, BagWindow w) {
  asm volatile("griddepcontrol.launch_dependents;");
  if (blockIdx.x == 0 && threadIdx.x < 2) w.other[threadIdx.x] = 0;
  const int S = w.lanes;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t bag = t / S;
  const int j = (int)(t %% S);
  const bool real = bag < n_bags;
  constexpr int kE = 16 / (int)sizeof(TG);
  constexpr int kChunks = D / kE;
  float v[kE] = {};
  if (real && j < kChunks) {
    load_g<TG, kE>(g + bag * D + j * kE, v);
#pragma unroll
    for (int k = 0; k < kE; ++k) v[k] = __fmul_rn(v[k], v[k]);
  }
#pragma unroll
  for (int off = kChunks / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kE; ++k) v[k] = __fadd_rn(v[k], __shfl_xor_sync(kFull, v[k], off));
  }
  const float mean_sq = __shfl_sync(kFull, halving_sum(v), 0, S) / (float)D;
  const int64_t base = real ? (int64_t)__ldg(offsets + bag %% T) - w.row_lo : 0;
  const int32_t* ids = indices + bag * L;
  const bool merge = w.keys != nullptr;
  for (int c = 0; c < L; c += kBagRounds * S) {
    int32_t row[kBagRounds];
    bool own[kBagRounds], claim[kBagRounds];
    int32_t ent[kBagRounds];
    int at[kBagRounds];
#pragma unroll
    for (int r = 0; r < kBagRounds; ++r) {
      const int l = c + r * S + j;
      const int64_t x = real && l < L ? base + __ldg(ids + l) : -1;
      row[r] = x >= 0 && (uint64_t)x < (uint64_t)w.n_rows ? (int32_t)x : -1;
    }
#pragma unroll
    for (int r = 0; r < kBagRounds; ++r) {
      own[r] = row[r] >= 0;
      claim[r] = false;
      ent[r] = -1;
      if (own[r]) {
        atomicAdd(acc + row[r], mean_sq);
        if (merge) ent[r] = insert_row(w.keys, w.n_keys, row[r], claim[r]);
      }
    }
    if (merge) {
      append_rounds<kBagRounds>(w.counts + 1, claim, at);
#pragma unroll
      for (int r = 0; r < kBagRounds; ++r) {
        if (!claim[r]) continue;
        float* m = w.merged + (int64_t)ent[r] * D;
        for (int x = 0; x < D; x += 4)
          *reinterpret_cast<float4*>(m + x) = make_float4(0.f, 0.f, 0.f, 0.f);
        w.claimed[at[r]] = ent[r];
      }
    }
    if (w.list != nullptr) {
      append_rounds<kBagRounds>(w.counts, own, at);
#pragma unroll
      for (int r = 0; r < kBagRounds; ++r) {
        if (!own[r]) continue;
        w.list[at[r]] = make_int2(row[r], (int32_t)bag);
        if (merge) w.entry[at[r]] = ent[r];
      }
    } else if (merge) {
#pragma unroll
      for (int r = 0; r < kBagRounds; ++r) {
        const int l = c + r * S + j;
        if (real && l < L) w.entry[bag * L + l] = ent[r];
      }
    }
  }
}

// Launch 2 over the list: S lanes a slot, a grid of at most the card's
// resident blocks striding over the list two slots a lane at once.
template <typename TT, typename TG, int D, int VB, bool kMerge>
__global__ void __launch_bounds__(kThreads)
apply_list_kernel(TT* __restrict__ table, const float* __restrict__ acc, const TG* __restrict__ g,
                  float neg_lr, float eps, BagWindow w) {
  using TD = typename std::conditional<kMerge, float, TT>::type;
  constexpr int E = VB / (int)sizeof(TD);
  constexpr int P = D / E;
  constexpr int S = P < 32 ? P : 32;
  constexpr int K = P / S;
  constexpr int kAtOnce = 2;
  wait_accumulated();
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int j = (int)(t %% S);
  const int64_t step = (int64_t)gridDim.x * (kThreads / S);
  const int64_t n = __ldcg(w.counts);
  for (int64_t i0 = t / S; i0 < n; i0 += kAtOnce * step) {
    int2 e[kAtOnce];
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u)
      e[u] = i0 + u * step < n ? __ldcg(w.list + i0 + u * step) : make_int2(-1, 0);
    float v[kAtOnce][K][E], s[kAtOnce];
    int32_t r[kAtOnce];
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      if (e[u].x < 0) continue;
#pragma unroll
      for (int k = 0; k < K; ++k)
        load_g<TG, E>(g + (int64_t)e[u].y * D + (j + k * S) * E, v[u][k]);
      s[u] = __ldcg(acc + e[u].x);
      if constexpr (kMerge) r[u] = __ldcg(w.entry + i0 + u * step);
    }
#pragma unroll
    for (int u = 0; u < kAtOnce; ++u) {
      if (e[u].x < 0) continue;
      const float sc = rsqrtf(s[u] + eps);
      TD* dst;
      if constexpr (kMerge) {
        dst = w.merged + (int64_t)r[u] * D;
      } else {
        dst = table + (int64_t)e[u].x * D;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int x = 0; x < E; ++x) v[u][k][x] = neg_lr * (v[u][k][x] * sc);
        red_add<TD, E>(dst + (j + k * S) * E, v[u][k]);
      }
    }
  }
}

template <typename TT, int D>
int launch_bag(const Args& a, const BagWindow& w) {
  constexpr int VB = Shipped::kVecBytes;
  const bool merge = w.keys != nullptr;
  const int64_t n_slots = a.n_bags * a.L;
  const int64_t t1 = a.n_bags * w.lanes;
  bag_accumulate_kernel<float, D><<<(unsigned)((t1 + kThreads - 1) / kThreads), kThreads, 0,
                                    a.stream>>>(static_cast<const float*>(a.g), a.offsets,
                                                a.indices, a.acc, a.n_bags, a.T, a.L, w);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  constexpr int PT = D * (int)sizeof(TT) / VB, PF = D * (int)sizeof(float) / VB;
  constexpr int ST = PT < 32 ? PT : 32, SF = PF < 32 ? PF : 32;
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = (int64_t)sms * (2048 / kThreads) * kThreads;
  const float* acc = a.acc;
  const float* g = static_cast<const float*>(a.g);
  if (w.list != nullptr) {
    const int64_t threads = n_slots * (merge ? SF : ST);
    if (merge) {
      err = launch_pdl(apply_list_kernel<TT, float, D, VB, true>, a, threads < cap ? threads : cap,
                       true, static_cast<TT*>(a.table), acc, g, a.neg_lr, a.eps, w);
    } else {
      return launch_pdl(apply_list_kernel<TT, float, D, VB, false>, a,
                        threads < cap ? threads : cap, true, static_cast<TT*>(a.table), acc, g,
                        a.neg_lr, a.eps, w);
    }
  } else if (merge) {
    err = launch_pdl(apply_merged_kernel<float, D, VB>, a, n_slots * SF, true, w.merged,
                     static_cast<const int32_t*>(w.entry), acc, g, a.offsets, a.indices, n_slots,
                     a.T, a.L, a.neg_lr, a.eps, w.row_lo);
  } else {
    return launch_pdl(apply_shard_kernel<TT, float, D, VB>, a, n_slots * ST, true,
                      static_cast<TT*>(a.table), acc, g, a.offsets, a.indices, n_slots, a.T, a.L,
                      a.neg_lr, a.eps, w.row_lo, w.n_rows);
  }
  if (err != 0) return err;
  const Window m = {w.row_lo, w.n_rows, w.lanes, w.counts + 1, w.entry, w.keys, w.n_keys,
                    w.claimed, w.merged};
  return launch_merge_rows<TT>(a, D, m);
}
"""

_ENTRY = r"""
extern "C" int drs_k5w_bag(int list, void* table, int table_dtype, int d, void* acc,
                           const void* g, const void* offsets, const void* indices,
                           int64_t row_lo, int64_t n_rows, int64_t n_bags, int T, int L,
                           float neg_lr, float eps, int lanes, void* counts, void* other,
                           void* list_buf, void* keys, int64_t n_keys, void* entry,
                           void* claimed, void* merged, void* stream) {
  const Args a = {table, static_cast<float*>(acc), g, static_cast<const int32_t*>(offsets),
                  static_cast<const int32_t*>(indices), n_bags, T, L, neg_lr, eps,
                  static_cast<cudaStream_t>(stream), row_lo, n_rows};
  const BagWindow w = {row_lo, n_rows, lanes, static_cast<int32_t*>(counts),
                       static_cast<int32_t*>(other), list ? static_cast<int2*>(list_buf) : nullptr,
                       static_cast<int32_t*>(entry), static_cast<int32_t*>(keys), n_keys,
                       static_cast<int32_t*>(claimed), static_cast<float*>(merged)};
  if (table_dtype == 0 && d == 32) return launch_bag<float, 32>(a, w);
  if (table_dtype == 0 && d == 64) return launch_bag<float, 64>(a, w);
  if (table_dtype == 1 && d == 32) return launch_bag<__nv_bfloat16, 32>(a, w);
  if (table_dtype == 1 && d == 64) return launch_bag<__nv_bfloat16, 64>(a, w);
  return (int)cudaErrorInvalidValue;
}
"""


def units(src: Path) -> dict:
    """``{stem: source}``: the shipped source with the bag-a-task design
    and its entry point added, and the same with ``Shipped::kPdl`` false."""
    text = src.read_text()
    if PDL[0] not in text:
        raise RuntimeError("the source's kPdl no longer reads as the sweep expects")
    marker = "}  // namespace\n"
    if text.count(marker) != 1:
        raise RuntimeError("the source's anonymous namespace no longer reads as expected")
    body = ("#include <type_traits>\n" + text.replace(marker, _BAG % {"rounds": ROUNDS} + marker)
            + _ENTRY)
    return {"k5w_pdl": body, "k5w_no_pdl": body.replace(*PDL)}


class BagScratch:
    """The bag-a-task design's scratch, kept from call to call (the
    shipped window's is each call's own): two pairs of counts (list,
    claimed) alternated, each call's launch 1 zeroing the other pair; the
    list and entries; the hash keys, which the merge frees."""

    def __init__(self, device, n_slots: int):
        self.counts = torch.zeros((4,), dtype=torch.int32, device=device)
        self.work = torch.empty((4 * n_slots,), dtype=torch.int32, device=device)
        self.keys = torch.full((1 << (2 * n_slots - 1).bit_length(),), -1, dtype=torch.int32,
                               device=device)
        self.calls = 0


def bag_call(lib, scratch: BagScratch, list_plan: bool, shard, acc, offsets, indices, g, lo,
             lr: float = 0.1, eps: float = 1e-8):
    """The bag-a-task design on ``shard`` (f32 gradient, d 32 or 64)."""
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops.sparse_adagrad import k5_window_plan

    B, T, L = indices.shape
    n_slots = B * T * L
    d = shard.shape[1]
    lanes = k5_window_plan(B * T, L, d, shard.dtype, g.dtype).lanes_per_bag
    pair = scratch.calls % 2
    scratch.calls += 1
    c, w = scratch.counts.data_ptr(), scratch.work.data_ptr()
    merge = shard.dtype != torch.float32
    merged = (torch.empty((scratch.keys.numel(), d), dtype=torch.float32, device=shard.device)
              if merge else None)
    _build.launch(lib, "drs_k5w_bag", shard.device, int(list_plan), shard.data_ptr(),
                  int(merge), d, acc.data_ptr(), g.data_ptr(), offsets.data_ptr(),
                  indices.data_ptr(), lo, shard.shape[0], B * T, T, L, -lr, eps, lanes,
                  c + 8 * pair, c + 8 * (1 - pair), w,
                  scratch.keys.data_ptr() if merge else None,
                  scratch.keys.numel(), w + 8 * n_slots, w + 12 * n_slots,
                  None if merged is None else merged.data_ptr())


def sweep(log) -> list:
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.data import RecDataGenerator
    from deeprecsys_tpu_torch.experiments.sweep_build import build_units
    from deeprecsys_tpu_torch.kernel_bench import _by_kernel, _us, measure, span_ms
    from deeprecsys_tpu_torch.models.base import table_offsets
    from deeprecsys_tpu_torch.ops import _build
    from deeprecsys_tpu_torch.ops import sparse_adagrad as sa

    built = build_units("k5w_sweep", units(_build.CSRC / "sparse_adagrad.cu"), "drs_k5w_bag",
                        ARGTYPES)
    libs = {}
    for stem, (lib, _) in built.items():
        lib.drs_cuda_error_string.restype = ctypes.c_char_p
        lib.drs_cuda_error_string.argtypes = [ctypes.c_int]
        sa._declare_window(lib)
        libs[stem] = lib
    device = torch.device("cuda")
    rows = []
    for name, M in CELLS:
        cfg = zoo.get_config(name)
        rps = cfg.total_rows // M
        lo = rps if M > 1 else 0
        d = cfg.sparse_feature_size
        offsets = table_offsets(cfg, device)
        g = torch.Generator(device=device).manual_seed(15)
        ids = [b.to(device).indices for b in
               RecDataGenerator(cfg, seed=13).generate_batches(8, 128)]
        gs = [torch.randn((128, cfg.num_tables, d), generator=g, device=device) * 1e-2
              for _ in ids]
        B, T, L = ids[0].shape
        scratch = BagScratch(device, B * T * L)
        for dt in (torch.float32, torch.bfloat16):
            shard = ((torch.rand((rps, d), generator=g, device=device) - 0.5) * 0.1).to(dt)
            acc = torch.zeros((rps,), dtype=torch.float32, device=device)
            plan = sa.k5_window_plan(B * T, L, d, dt, torch.float32)

            def design(label):
                if label.startswith("shipped"):
                    lib = libs["k5w_pdl" if label == "shipped" else "k5w_no_pdl"]
                    return lambda t_, a_, gr, i: sa._window_launch(t_, a_, offsets, i, gr, lo,
                                                                   0.1, 1e-8, plan, lib)
                return lambda t_, a_, gr, i: bag_call(libs["k5w_pdl"], scratch,
                                                      label.endswith("list"), t_, a_, offsets,
                                                      i, gr, lo)

            calls = {label: design(label) for label in DESIGNS}
            args = list(zip(gs, ids))
            for label, fn in calls.items():
                for what, i in (("ids", ids[0]), ("ids on 256 rows a table", ids[0] % 256)):
                    got_t, got_a = shard.clone(), acc.clone()
                    want_t, want_a = shard.clone(), acc.clone()
                    fn(got_t, got_a, gs[0], i)
                    sa.sparse_adagrad_step_reference(want_t, want_a, offsets, i, gs[0], 0.1,
                                                     window=(lo, lo + rps))
                    tol, acc_tol = sa.sparse_adagrad_tolerance(shard, acc, offsets, i, gs[0],
                                                               0.1, window=(lo, lo + rps))
                    err = (got_t.float() - want_t.float()).abs()
                    if not (bool((err <= tol).all())
                            and bool(((got_a - want_a).abs() <= acc_tol).all())):
                        raise AssertionError(f"K5's window ({label}) disagrees with its plain "
                                             f"version ({name} 1/{M}, {dt}, {what}): max |err| "
                                             f"table {err.max().item():.3e}")
            spans = {label: [] for label in calls}
            for label in list(calls) + list(calls)[::-1]:
                spans[label].append(span_ms(
                    lambda gr, i, fn=calls[label]: fn(shard, acc, gr, i), args))
            for label, fn in calls.items():
                run = measure(lambda gr, i, fn=fn: fn(shard, acc, gr, i), args)
                row = {"model": name, "shard": f"1/{M}", "dtype": str(dt)[6:], "design": label,
                       "span_ms": float(np.mean(spans[label])), "spans_ms": spans[label],
                       "launch_sum_ms": run["launch_sum_ms"], "by_kernel": run["us_by_kernel"]}
                log(f"{name} shard 1/{M} {row['dtype']} {label}: span {_us(row['span_ms'])} ("
                    f"{', '.join(_us(x) for x in spans[label])}); launches' medians summed "
                    f"{_us(row['launch_sum_ms'])} ({_by_kernel(row['by_kernel'])})")
                rows.append(row)
            del shard, acc
            torch.cuda.empty_cache()
        del scratch
    for stem, (_, ptx) in built.items():
        log(f"{stem} ptxas " + "; ".join(x for x in ptx if "bag_accumulate" in x
                                         or "apply_list" in x or "accumulate_kernel<f32, 32" in x))
    return rows


def main(argv=None) -> int:
    from deeprecsys_tpu_torch.kernel_bench import card_line

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--json", type=Path, default=None, help="write the results here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("k5w_sweep: no CUDA card is available", file=sys.stderr)
        return 1

    def log(msg):
        print(f"[k5w_sweep] {msg}", flush=True)

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
