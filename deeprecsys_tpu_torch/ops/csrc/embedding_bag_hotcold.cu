// K6: hot/cold-split pooled lookup for Hopper (sm_90a), over float, per-table
// int8 and row-wise int8 tables.
//
// What it replaces: the TPU package's XLA op for a hot/cold-split lookup,
// deeprecsys_tpu/ops/embedding.py::_embedding_bag_hotcold_impl (:518), behind
// embedding_bag_hotcold (:542), embedding_bag_hotcold_int8 (:737) and
// embedding_bag_hotcold_int8_rowwise (:759): a masked pool of (K, .) hot rows
// by hot_sel, a gather of the compacted cold ids segment-summed by cold_seg
// into B*T + 1 bags with the last (the pads') dropped, and the two added.
//
// Contract (ops/embedding.py checks it):
//   hot        (K, W)      the hot rows, in the table's layout (K may be 0)
//   table      (R, W)      bf16 or f32 (W = D), int8 (W = D), or row-wise
//                          int8 (W = D + 4: D values, then the row's f32 scale)
//   scale      (T,)        f32 per-table scales (per-table int8 only)
//   hot_sel    (B, T, L)   int32 position in the hot set (0 where not hot)
//   hot_mask   (B, T, L)   uint8/bool: the slot is a hot hit
//   cold_ids   (C_pad,)    int32 fused row ids of the cold lookups
//   cold_seg   (C_pad,)    int32 bag b*T + t of each; non-decreasing, pads
//                          (bag B*T) last: ops/hotcold.py::split_hot_cold's
//                          order, which the kernel relies on and does not check
//   cold_start (B*T + 1,)  int32 scratch, written by K6's first launch
//   out        (B, T, D)   f32 or bf16
//
// Numerics, so that a hot/cold engine scores what the direct one does:
//   float: each row converted to the compute dtype, hot and cold rows summed
//     in one f32 accumulator, rounded once (K1's, csrc/embedding_bag.cu);
//   per-table int8: hot and cold rows summed in int32 (exact), then one f32
//     multiply (__fmul_rn) by the table's scale and one rounding: the JAX
//     op's bits;
//   row-wise int8: each value times its row's scale (__fmul_rn, never fused
//     into the add), an f32 sum, one rounding (K4's).
// No atomics: the order of every sum is fixed, so the result is
// deterministic. Pads (bag B*T) fall in no stored bag. Addresses are 64-bit.
//
// What bounds it: the same random row reads as K1 (~21-24 G rows/s from
// DRAM on an H100, PERF.md), with the hot rows from a K-row table that the
// L2 (50 MB) holds once warm. At the zoo's shapes every bag of a batch fits
// in one wave of warps, so a bag's time is the length of its chain of
// dependent memory round trips. K1's chain is one round trip for the ids,
// then one a step of rows. The design keeps K6's chain one round trip
// longer than that, and no more:
//
// K6 is two launches on the caller's stream.
//   1. cold_starts_kernel builds cold_start, the CSR row pointer of the cold
//      stream: cold_start[g] is the lower bound of g in cold_seg and
//      cold_start[B*T] the first pad. Entry i writes i into every g in
//      (cold_seg[i - 1], cold_seg[i]] (cold_seg[-1] = -1, cold_seg[C_pad] =
//      B*T, clamped to [0, B*T]): every g is written once, coalesced, in
//      O(C_pad + B*T). A long range (bags with no cold lookup) is written
//      by the entry's warp, a very long one by its block.
//   2. The pooling kernel is launched with programmatic dependent launch
//      (cudaLaunchAttributeProgrammaticStreamSerialization): launch 1
//      triggers it at its start, and a warp waits for launch 1
//      (griddepcontrol.wait, what cudaGridDependencySynchronize() issues)
//      only after it has issued its hot loads, just before it reads
//      cold_start. Launched without it, K6 takes as long in sum and its
//      span is longer (experiments/k6_sweep.py --pdl_only, PERF.md).
//
// A bag's cold lookups are its non-hot valid slots in order. The kernel
// cannot see the slot mask, so the non-hot slot of rank r in its bag takes
// cold entry cold_start[g] + r while r < cold_start[g + 1] - cold_start[g],
// and nothing after: a ragged bag's padding slots load nothing, and every
// cold entry is read once, by its own bag, whichever slot reads it.
// Hot ids do not wait on the mask: hot_mask and hot_sel are loaded side by
// side (hot_sel is a full (B, T, L) array) and a slot's id is mask ? sel :
// none. Each slot's row then comes from `hot` or from `table` by one code:
// c >= 0 is table row c, c <= -2 hot row -2 - c, -1 nothing.
//
// Mapping. A lane holds V values of a row (16 bytes for float and per-table
// int8 rows; row-wise rows start on 4-byte boundaries only and are loaded as
// K4 loads them, below), so P = D / V lanes cover a row and a warp has S =
// 32 / P row slots. The plan (ops/embedding.py::k6_launch_plan) follows L:
//   * L > 8: a warp a bag g = b*T + t, grid-stride. Round trip 1 loads the
//     bag's hot_mask and hot_sel, NI a lane for a window of 32 * NI slots
//     (the whole bag up to L = 128), and cold_start[g], cold_start[g + 1].
//     Ranks of the non-hot slots come from __ballot_sync and __popc below
//     the lane; round trip 2 loads each lane's cold ids, coalesced. Then
//     the steps walk the L slots as K1 does, CH = S * U slots a step, each
//     slot with U rows in flight drawn from either table by its code:
//     ceil(L / CH) steps. The bag's slots are combined by K1-int8's
//     reduce-scatter (pooled_rows.cuh) and every lane stores its share.
//   * L <= 8: a slot a bag, S consecutive bags a warp, each slot with all of
//     its bag's rows in flight (UB = the power of two >= L). Round trip 1
//     loads the task's S * L hot entries and its S + 1 starts; round trip 2
//     the cold window [cold_start[bag0], cold_start[bag0 + S]) (at most
//     S * L entries), coalesced; a slot picks its entries by shuffles, and
//     its UB rows, hot or cold, load in one round trip. No combining step.
//
// Row-wise rows (D + 4 bytes, 36 or 68, on 4-byte boundaries only) load as
// K4 loads them (pooled_rows.cuh, shared with embedding_bag_int8.cu): each
// lane the 16-byte-aligned chunks over its words, picked by the row's
// phase, the scale handed from the row's last lane by __shfl_sync.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "pooled_rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;    // ops/embedding.py::K6_WARPS_PER_BLOCK
constexpr int kMinBlocksPerSm = 4;
constexpr int kStartThreads = 256;   // cold_starts_kernel's block
constexpr int kWarpRange = 8;        // ranges of cold_start a warp writes, from this long
constexpr int kBlockRange = 256;     // and a block
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kFloat = 0, kInt8 = 1, kRowwise = 2 };

// The shipped mapping of a layout (ops/embedding.py::k6_geometry mirrors
// it): V values a lane, U rows a slot a step (a warp a bag), H the load
// hint (load_row16), for long bags (kShort false) or a slot a bag.
// Chosen by measurement on an H100 at rm1's, rm2's and din's shapes
// (experiments/k6_sweep.py, PERF.md): float (bf16) rows take D / 2 slots a
// step (2 rows a slot at D = 32, 8 at D = 64); row-wise rows 16 values a
// lane and 16 slots a step (1 row a slot at D = 32, 2 at D = 64). Cold
// rows of at most 64 bytes (and row-wise rows) load with the hint (H = 2:
// they come from DRAM and are rarely read again, while hot rows repeat and
// the L1 keeps them; the hint on every row cost 5-60% on these zipf ids;
// on 128-byte rows its 64-byte L2 fetch cost 6%); float short bags load
// every row with it (H = 1); per-table int8 keeps the mapping of K6's first
// design (16 bytes a lane, at most 4 rows a slot, 32 slots a step, no hint).
template <int M, typename TIn, int D, bool kShort>
struct Shipped {
  static constexpr int V = M == kRowwise ? 16 : 16 / (int)sizeof(TIn);
  static constexpr int S = 32 / (D / V);
  static constexpr int U = M == kRowwise ? 16 / S
                           : M == kInt8  ? (32 / S < 4 ? 32 / S : 4)
                                         : (D / 2 / S < 8 ? D / 2 / S : 8);
  static constexpr int H = M == kInt8                        ? 0
                           : M == kRowwise                   ? 2
                           : kShort                          ? 1
                           : D * (int)sizeof(TIn) <= 64      ? 2
                                                             : 0;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TC>
__device__ __forceinline__ float as_compute(float x);
template <>
__device__ __forceinline__ float as_compute<float>(float x) { return x; }
template <>
__device__ __forceinline__ float as_compute<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// 16 bytes of a row of either source; kHint 0: no hint, 1: every row with
// load16's hint, 2: only rows of `table` (cold rows, from DRAM; the L1 keeps
// hot rows, which repeat).
template <int kHint>
__device__ __forceinline__ uint4 load_row16(const void* p, bool cold) {
  if constexpr (kHint == 2) {
    return cold ? load16<true>(p) : load16<false>(p);
  } else {
    return load16<kHint == 1>(p);
  }
}

// Waits for launch 1 (cudaGridDependencySynchronize()); a no-op when K6 was
// launched without programmatic dependent launch.
__device__ __forceinline__ void wait_cold_starts() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch 1: cold_start[g], g in [0, n_bags], the first i with cold_seg[i] >= g
// (c_pad if none). A thread an entry; a range of kWarpRange or more bags is
// written by the thread's warp, one of kBlockRange or more by its block (a
// batch with few cold entries has long runs of bags with none: with every
// id hot, one range holds every bag).
__global__ void __launch_bounds__(kStartThreads)
cold_starts_kernel(const int32_t* __restrict__ cold_seg, int64_t c_pad, int64_t n_bags,
                   int32_t* __restrict__ cold_start) {
  // K6 may start now: what it loads before its wait is not written here
  // (cudaTriggerProgrammaticLaunchCompletion()).
  asm volatile("griddepcontrol.launch_dependents;");
  __shared__ long long block_lo[kStartThreads], block_hi[kStartThreads];
  __shared__ int block_value[kStartThreads];
  __shared__ int n_block;
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kStartThreads + threadIdx.x;
  if (threadIdx.x == 0) n_block = 0;
  int64_t lo = 0, hi = -1;  // entry i writes cold_start[lo..hi]
  if (i <= c_pad) {
    const int64_t prev = i == 0 ? -1 : (int64_t)__ldg(cold_seg + i - 1);
    const int64_t cur = i == c_pad ? n_bags : (int64_t)__ldg(cold_seg + i);
    lo = prev + 1 > 0 ? prev + 1 : 0;
    hi = cur < n_bags ? cur : n_bags;
  }
  const int64_t len = hi - lo + 1;
  __syncthreads();
  if (len >= kBlockRange) {
    const int k = atomicAdd(&n_block, 1);  // the list's order does not matter: ranges are disjoint
    block_lo[k] = lo;
    block_hi[k] = hi;
    block_value[k] = (int)i;
  } else if (len < kWarpRange) {
    for (int64_t g = lo; g <= hi; ++g) cold_start[g] = (int32_t)i;
  }
  const bool wide = len >= kWarpRange && len < kBlockRange;
  for (unsigned ball = __ballot_sync(kFull, wide); ball != 0u; ball &= ball - 1u) {
    const int src = __ffs(ball) - 1;
    const long long wl = __shfl_sync(kFull, (long long)lo, src);
    const long long wh = __shfl_sync(kFull, (long long)hi, src);
    const int32_t value = (int32_t)__shfl_sync(kFull, (long long)i, src);
    for (long long g = wl + lane; g <= wh; g += 32) cold_start[g] = value;
  }
  __syncthreads();
  for (int k = 0; k < n_block; ++k) {
    for (long long g = block_lo[k] + threadIdx.x; g <= block_hi[k]; g += kStartThreads)
      cold_start[g] = block_value[k];
  }
}

// Adds the rows of codes c[0..NR) (table row c >= 0, hot row -2 - c, none
// -1) to this lane's V columns of acc.
template <int M, typename TIn, typename TC, int D, int V, int H, int NR, typename Acc>
__device__ __forceinline__ void add_rows(Acc (&acc)[V], const TIn* __restrict__ hot,
                                         const TIn* __restrict__ table,
                                         const int32_t (&c)[NR], int lane) {
  constexpr int P = D / V;
  if constexpr (M == kRowwise) {
    constexpr int NW = V / 4;
    constexpr int NC = RowChunks<NW>::NC;
    const int c0 = (lane % P) * NW;
    uint4 win[NR][NC];
    uint32_t e[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u) {
#pragma unroll
      for (int k = 0; k < NC; ++k) win[u][k] = make_uint4(0u, 0u, 0u, 0u);
      e[u] = 0u;
      if (c[u] != -1) {
        const bool cold = c[u] >= 0;
        const int64_t row = cold ? (int64_t)c[u] : -2 - (int64_t)c[u];
        const uint4* chunk =
            row_window(reinterpret_cast<uintptr_t>(cold ? table : hot) + row * (D + 4), c0, e[u]);
#pragma unroll
        for (int k = 0; k < NC; ++k) win[u][k] = load_row16<H>(chunk + k, cold);
      }
    }
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      uint32_t x[NW + 1];
      pick_words<NW>(win[u], e[u], x);
      float row_scale = __uint_as_float(x[NW]);
      if constexpr (P > 1) row_scale = __shfl_sync(kFull, row_scale, lane | (P - 1));
      add_scaled<NW>(acc, x, row_scale);
    }
  } else {
    static_assert(V * sizeof(TIn) == 16, "float and int8 lanes load 16 bytes");
    const int col = (lane % P) * V;
    uint4 v[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      v[u] = make_uint4(0u, 0u, 0u, 0u);  // zero bits: +0.0 in f32 and bf16, 0 in int8
      if (c[u] != -1) {
        const bool cold = c[u] >= 0;
        const int64_t row = cold ? (int64_t)c[u] : -2 - (int64_t)c[u];
        v[u] = load_row16<H>((cold ? table : hot) + row * D + col, cold);
      }
    }
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      if constexpr (M == kInt8) {
        const uint32_t w4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * k + j] += byte_at(w4[k], j);
        }
      } else {
        const TIn* x = reinterpret_cast<const TIn*>(&v[u]);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] += as_compute<TC>(to_float(x[i]));
      }
    }
  }
}

// N values of bag `bag` at dst (per-table int8: times its table's scale),
// rounded once to TC (store_row).
template <int M, typename TC, int N, typename Acc>
__device__ __forceinline__ void store_vals(TC* dst, const Acc* a, const float* __restrict__ scale,
                                           int64_t bag, int T) {
  float o[N];
  if constexpr (M == kInt8) {
    const float sc = __ldg(scale + bag % T);
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = __fmul_rn(static_cast<float>(a[i]), sc);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = a[i];
  }
  store_row<TC>(dst, o);
}

// Launch 2. UB = 0: a warp a bag (L > 8), windows of 32 * NI slots. UB in
// {1, 2, 4, 8} (L <= UB): a slot a bag, S bags a warp.
template <int M, typename TIn, typename TC, int D, int V, int U, int H, int UB, int NI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_hotcold_kernel(const TIn* __restrict__ hot, const TIn* __restrict__ table,
                             const float* __restrict__ scale,
                             const int32_t* __restrict__ hot_sel,
                             const uint8_t* __restrict__ hot_mask,
                             const int32_t* __restrict__ cold_ids,
                             const int32_t* cold_start,  // launch 1's: read past the wait only
                             TC* __restrict__ out, int64_t n_bags, int T, int L) {
  constexpr int P = D / V;   // lanes a row
  constexpr int S = 32 / P;  // row slots a warp
  using Acc = typename std::conditional<M == kInt8, int, float>::type;
  static_assert(D % V == 0 && 32 % P == 0 && V % S == 0, "unsupported mapping");
  const int lane = threadIdx.x & 31;
  const int slot = lane / P;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  bool waited = false;

  if constexpr (UB == 0) {
    constexpr int CH = S * U;      // slots of the bag a step
    constexpr int WIN = 32 * NI;   // slots a window
    static_assert(WIN % CH == 0, "a window is whole steps");
    const unsigned below = (1u << lane) - 1u;
    for (int64_t bag = warp; bag < n_bags; bag += warps) {
      Acc acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0;
      const int64_t h0 = bag * L;
      int64_t lo = 0;
      int n_cold = 0, carry = 0;  // the bag's cold entries; non-hot slots of earlier windows
      for (int w0 = 0; w0 < L; w0 += WIN) {
        // Round trip 1: the window's masks and hot ids side by side, and
        // (first window) the bag's cold range.
        bool in[NI], hit[NI];
        int32_t sel[NI], code[NI];
#pragma unroll
        for (int r = 0; r < NI; ++r) {
          const int l = w0 + r * 32 + lane;
          in[r] = l < L;
          hit[r] = in[r] && __ldg(hot_mask + h0 + l) != 0;
          sel[r] = in[r] ? __ldg(hot_sel + h0 + l) : 0;
        }
        if (w0 == 0) {
          wait_cold_starts();
          waited = true;
          const int32_t a = __ldcg(cold_start + bag), b = __ldcg(cold_start + bag + 1);
          lo = a;
          n_cold = b - a;
        }
        // Round trip 2: the cold id of each non-hot slot of rank < n_cold.
#pragma unroll
        for (int r = 0; r < NI; ++r) {
          const unsigned cold_ball = __ballot_sync(kFull, in[r] && !hit[r]);
          const int rank = carry + __popc(cold_ball & below);
          carry += __popc(cold_ball);
          const bool cold = in[r] && !hit[r] && rank < n_cold;
          code[r] = cold ? __ldg(cold_ids + lo + rank) : -1;
        }
#pragma unroll
        for (int r = 0; r < NI; ++r) code[r] = hit[r] ? -2 - sel[r] : code[r];
        // The steps: row u of a slot is the step's slot u * S + slot.
#pragma unroll
        for (int k = 0; k < WIN / CH; ++k) {
          if (w0 + k * CH >= L) break;
          int32_t rid[U];
#pragma unroll
          for (int u = 0; u < U; ++u)
            rid[u] = __shfl_sync(kFull, code[(k * CH + u * S) >> 5], (k * CH + u * S + slot) & 31);
          add_rows<M, TIn, TC, D, V, H>(acc, hot, table, rid, lane);
        }
      }
      reduce_scatter<P, 32, V / 2>(acc, lane);
      store_vals<M, TC, V / S>(out + bag * D + (lane % P) * V + slot_share<V, S>(slot), acc,
                               scale, bag, T);
    }
  } else {
    // S bags a task, slot s holding bag bag0 + s.
    constexpr int NW = S * UB;
    constexpr int NJ = (NW + 31) / 32;
    const int64_t n_tasks = (n_bags + S - 1) / S;
    for (int64_t task = warp; task < n_tasks; task += warps) {
      const int64_t bag0 = task * S;
      const int64_t bag = bag0 + slot;
      const int nb = n_bags - bag0 < S ? (int)(n_bags - bag0) : S;
      const int window = nb * L;
      // Round trip 1: the task's S * L hot entries and its S + 1 starts.
      int32_t hcode[NJ], cw[NJ];
#pragma unroll
      for (int r = 0; r < NJ; ++r) {
        const int k = r * 32 + lane;
        const int64_t at = bag0 * L + k;
        const bool hit = k < window && __ldg(hot_mask + at) != 0;
        const int32_t sel = k < window ? __ldg(hot_sel + at) : 0;
        hcode[r] = hit ? -2 - sel : -1;
      }
      wait_cold_starts();
      waited = true;
      const int32_t st = __ldcg(cold_start + bag0 + (lane < nb ? lane : nb));
      const int32_t end = __ldcg(cold_start + bag0 + nb);
      const int32_t lo0 = __shfl_sync(kFull, st, 0);
      const int32_t first = __shfl_sync(kFull, st, slot);
      const int32_t next = __shfl_sync(kFull, st, (slot + 1) & 31);
      const int32_t last = slot + 1 < nb ? next : (slot < nb ? end : first);
      // Round trip 2: the cold window [lo0, end), at most S * L entries.
#pragma unroll
      for (int r = 0; r < NJ; ++r) {
        const int k = r * 32 + lane;
        cw[r] = lo0 + k < end ? __ldg(cold_ids + lo0 + k) : -1;
      }
      // Slot position u: its hot id, or the bag's next cold entry.
      int32_t code[UB];
      int rank = first - lo0;
      const int stop = last - lo0;
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int32_t h = id_of<NJ>(hcode, slot * L + u < NW ? slot * L + u : NW - 1);
        const int32_t c = id_of<NJ>(cw, rank < NW ? rank : NW - 1);
        const bool live = u < L;
        code[u] = !live ? -1 : h != -1 ? h : rank < stop ? c : -1;
        rank += live && h == -1;
      }
      Acc acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0;
      add_rows<M, TIn, TC, D, V, H>(acc, hot, table, code, lane);
      if (bag < n_bags) store_vals<M, TC, V>(out + bag * D + (lane % P) * V, acc, scale, bag, T);
    }
  }
  // A warp with no task still waits, so K6 never ends before launch 1.
  if (!waited) wait_cold_starts();
}

struct Args {
  const void* hot;
  const void* table;
  const float* scale;
  const int32_t* hot_sel;
  const uint8_t* hot_mask;
  const int32_t* cold_ids;
  const int32_t* cold_seg;
  int64_t c_pad;
  int32_t* cold_start;
  void* out;
  int64_t n_bags;
  int T, L, grid;
  cudaStream_t stream;
};

int launch_cold_starts(const Args& a) {
  const int64_t blocks = (a.c_pad + 1 + kStartThreads - 1) / kStartThreads;
  cold_starts_kernel<<<(unsigned)blocks, kStartThreads, 0, a.stream>>>(a.cold_seg, a.c_pad,
                                                                     a.n_bags, a.cold_start);
  return (int)cudaGetLastError();
}

// Launch 2 with mapping (V, U, H) and plan (UB, NI), with programmatic
// dependent launch unless the caller says otherwise (the sweep measures both).
template <int M, typename TIn, typename TC, int D, int V, int U, int H, int UB, int NI>
int launch(const Args& a, bool pdl = true) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.grid);
  cfg.blockDim = dim3(kWarpsPerBlock * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(
      &cfg, embedding_bag_hotcold_kernel<M, TIn, TC, D, V, U, H, UB, NI>,
      static_cast<const TIn*>(a.hot), static_cast<const TIn*>(a.table), a.scale, a.hot_sel,
      a.hot_mask, a.cold_ids, static_cast<const int32_t*>(a.cold_start), static_cast<TC*>(a.out),
      a.n_bags, a.T, a.L);
}

// The plans ops/embedding.py::k6_launch_plan picks: rows_per_slot 0 (a warp
// a bag) for L > 8 with NI in {1, 2, 4}, else the power of two >= L; each
// with the layout's shipped mapping (the hint only where a slot loads more
// than one row).
template <int M, typename TIn, typename TC, int D>
int launch_plan(int rows_per_slot, int ids_per_lane, const Args& a) {
  using LB = Shipped<M, TIn, D, false>;
  using SB = Shipped<M, TIn, D, true>;
  constexpr int kMinNI = LB::S * LB::U / 32 > 1 ? LB::S * LB::U / 32 : 1;  // a step in a window
  if (rows_per_slot == 0) {
    switch (ids_per_lane) {
      case 1: return launch<M, TIn, TC, D, LB::V, LB::U, LB::H, 0, kMinNI>(a);
      case 2: return launch<M, TIn, TC, D, LB::V, LB::U, LB::H, 0, (kMinNI > 2 ? kMinNI : 2)>(a);
      case 4: return launch<M, TIn, TC, D, LB::V, LB::U, LB::H, 0, 4>(a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  switch (rows_per_slot) {
    case 1: return launch<M, TIn, TC, D, SB::V, 1, 0, 1, 1>(a);  // one row: no hint, as K1
    case 2: return launch<M, TIn, TC, D, SB::V, 1, SB::H, 2, 1>(a);
    case 4: return launch<M, TIn, TC, D, SB::V, 1, SB::H, 4, 1>(a);
    case 8: return launch<M, TIn, TC, D, SB::V, 1, SB::H, 8, 1>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int M, typename TIn, typename TC>
int launch_width(int d, int rows_per_slot, int ids_per_lane, const Args& a) {
  if (d == 32) return launch_plan<M, TIn, TC, 32>(rows_per_slot, ids_per_lane, a);
  if (d == 64) return launch_plan<M, TIn, TC, 64>(rows_per_slot, ids_per_lane, a);
  return (int)cudaErrorInvalidValue;
}

template <int M, typename TIn>
int launch_out(int out_dtype, int d, int rows_per_slot, int ids_per_lane, const Args& a) {
  if (out_dtype == 0) return launch_width<M, TIn, float>(d, rows_per_slot, ids_per_lane, a);
  if (out_dtype == 1)
    return launch_width<M, TIn, __nv_bfloat16>(d, rows_per_slot, ids_per_lane, a);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* hot, const void* table, const void* scale, const void* hot_sel,
               const void* hot_mask, const void* cold_ids, const void* cold_seg, int64_t c_pad,
               void* cold_start, void* out, int64_t n_bags, int T, int L, int grid,
               void* stream) {
  return Args{hot, table, static_cast<const float*>(scale),
              static_cast<const int32_t*>(hot_sel), static_cast<const uint8_t*>(hot_mask),
              static_cast<const int32_t*>(cold_ids), static_cast<const int32_t*>(cold_seg),
              c_pad, static_cast<int32_t*>(cold_start), out, n_bags, T, L, grid,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// Both of K6's launches. mode: 0 float table (table_dtype 0 = f32, 1 =
// bf16), 1 per-table int8, 2 row-wise int8. out_dtype: 0 = f32, 1 = bf16.
// (rows_per_slot, ids_per_lane, grid): ops/embedding.py::k6_launch_plan's.
// Launch 2 depends on launch 1 by programmatic dependent launch.
// cold_start: (n_bags + 1) int32 scratch. Returns the first nonzero
// cudaError_t of the two launches (0 = success). The caller validates
// shapes, alignment and the cold stream's order.
int drs_embedding_bag_hotcold(int mode, int table_dtype, int d, const void* hot,
                              const void* table, const void* scale, const void* hot_sel,
                              const void* hot_mask, const void* cold_ids, const void* cold_seg,
                              int64_t c_pad, void* cold_start, void* out, int out_dtype,
                              int64_t n_bags, int T, int L, int rows_per_slot,
                              int ids_per_lane, int grid, void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0 || c_pad < 0 || (rows_per_slot > 0 && L > rows_per_slot))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(hot, table, scale, hot_sel, hot_mask, cold_ids, cold_seg, c_pad,
                           cold_start, out, n_bags, T, L, grid, stream);
  const int err = launch_cold_starts(a);
  if (err != 0) return err;
  const int u = rows_per_slot, ni = ids_per_lane;
  if (mode == kFloat && table_dtype == 0) return launch_out<kFloat, float>(out_dtype, d, u, ni, a);
  if (mode == kFloat && table_dtype == 1)
    return launch_out<kFloat, __nv_bfloat16>(out_dtype, d, u, ni, a);
  if (mode == kInt8) return launch_out<kInt8, int8_t>(out_dtype, d, u, ni, a);
  if (mode == kRowwise) return launch_out<kRowwise, int8_t>(out_dtype, d, u, ni, a);
  return (int)cudaErrorInvalidValue;
}

// Launch 1 alone, for checks: cold_start (n_bags + 1) of cold_seg (c_pad).
int drs_hotcold_cold_starts(const void* cold_seg, int64_t c_pad, void* cold_start,
                            int64_t n_bags, void* stream) {
  if (n_bags < 0 || c_pad < 0) return (int)cudaErrorInvalidValue;
  Args a{};
  a.cold_seg = static_cast<const int32_t*>(cold_seg);
  a.c_pad = c_pad;
  a.cold_start = static_cast<int32_t*>(cold_start);
  a.n_bags = n_bags;
  a.stream = static_cast<cudaStream_t>(stream);
  return launch_cold_starts(a);
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
