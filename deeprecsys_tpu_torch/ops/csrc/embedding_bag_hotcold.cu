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
// On one row shard of a table split over a mesh's "model" axis
// (drs_embedding_bag_hotcold_partial, TO the type the kernel sums in): the
// caller gives the shard as `table` and that shard's cold stream, whose
// ids the host splitter already made shard-local (ops/hotcold.py::
// split_hot_cold_hybrid), so no window is needed; the hot hits are counted
// on one shard only, the first, and every other shard pools its cold
// stream alone in the cold-only instance (drs_embedding_bag_cold_partial,
// below). The partial leaves unscaled and unrounded: f32 for float and
// row-wise tables, the exact int32 pool for per-table int8, so that the
// shards' partials add exactly as the single-device sums do and the scale
// and rounding come once, after the combine.
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
//   * L > 8: G bags a warp (a task), grid-stride; bag bi of a task owns the
//     32 / G lanes from bi * 32 / G, which are S / G row slots (G = 1 but
//     for per-table int8 rows at D = 64). Round trip 1 loads each bag's
//     hot_mask and hot_sel, NI a lane for a window of 32 / G * NI slots of
//     the bag, and cold_start[g], cold_start[g + 1]. Ranks of the non-hot
//     slots come from one __ballot_sync masked to the bag's lanes and __popc
//     below the lane, the rank carried across windows kept per bag; round
//     trip 2 loads each lane's cold ids, coalesced. Then the steps walk the
//     L slots as K1 does, CH = S / G * U slots of the bag a step, each slot
//     with U rows in flight drawn from either table by its code: ceil(L /
//     CH) steps. A bag's slots are combined by K1-int8's reduce-scatter over
//     the bag's lanes (pooled_rows.cuh) and every lane stores its share.
//     Per-table int8 rows (64 bytes at most) make the front end a large
//     share of a bag's chain, so there it is pipelined across windows of
//     one step: a window's rows load while the next window's cold ids and
//     the one after's masks and hot ids are in flight, as K1-int8 loads a
//     step's ids while the step before it pools (without it, K1-int8's
//     mappings gained nothing over a warp a bag at rm2's shape on an H100:
//     experiments/k6_sweep.py, PERF.md).
//   * L <= 8: a slot a bag, S consecutive bags a warp, each slot with its
//     bag's rows (UB = the power of two >= L) loaded U a step. Round trip 1
//     loads the task's S * L hot entries and its S + 1 starts; round trip 2
//     the cold window [cold_start[bag0], cold_start[bag0 + S]) (at most
//     S * L entries), coalesced; a slot picks its entries by shuffles, and
//     its rows, hot or cold, load U at a time. No combining step.
//
// Widths. The mappings above are built for D = 32 and 64. Any other width
// takes the general instance (embedding_bag_hotcold_general_kernel, launched
// the same way after launch 1): the width a runtime argument, a warp a bag,
// lane c the columns c, c + 32, ... of a chunk of 32 * kGeneralCols, one
// element a load; the bag's slots walked in order, each hot hit from `hot`
// and each non-hot slot of rank r from cold entry cold_start[g] + r while
// r < cold_start[g + 1] - cold_start[g], as above; the same numerics and
// outputs (a row-wise row's scale read a byte at a time: a row of D + 4
// bytes need not start on a 4-byte boundary); correct, not tuned.
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
// it): V values a lane; on long bags G bags a warp, U rows a slot a step,
// windows of at most NI ids a lane; on short bags (kShort, a slot a bag) at
// most U of the bag's rows a step; H the load hint (load_row16).
// Chosen by measurement on an H100 at rm1's, rm2's and din's shapes
// (experiments/k6_sweep.py, PERF.md): float (bf16) rows take D / 2 slots a
// step (2 rows a slot at D = 32, 8 at D = 64); row-wise rows 16 values a
// lane and 16 slots a step (1 row a slot at D = 32, 2 at D = 64). Cold
// rows of at most 64 bytes (and row-wise rows) load with the hint (H = 2:
// they come from DRAM and are rarely read again, while hot rows repeat and
// the L1 keeps them; the hint on every row cost 5-60% on these zipf ids;
// on 128-byte rows its 64-byte L2 fetch cost 6%); float short bags load
// every row with it (H = 1). Per-table int8 rows load 16 bytes a lane,
// with the hint on cold rows; their long bags take a window of one step
// (pipelined, NI = 1) with U = 2 at D = 32 and 4 bags a warp with U = 4 at
// D = 64, as K1-int8 does; short bags load every row at once.
template <int M, typename TIn, int D, bool kShort>
struct Shipped {
  static constexpr int V = M == kRowwise ? 16 : 16 / (int)sizeof(TIn);
  static constexpr int S = 32 / (D / V);
  static constexpr int G = M == kInt8 && !kShort && D == 64 ? 4 : 1;
  static constexpr int U = kShort          ? 8
                           : M == kInt8    ? (D == 64 ? 4 : 2)
                           : M == kRowwise ? 16 / S
                                           : (D / 2 / S < 8 ? D / 2 / S : 8);
  static constexpr int NI = M == kInt8 ? 1 : 4;
  static constexpr int H = M != kFloat                  ? 2
                           : kShort                     ? 1
                           : D * (int)sizeof(TIn) <= 64 ? 2
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
// rounded once to TC (store_row); a per-table int8 partial (TC = int32_t)
// as its exact int32 sums.
template <int M, typename TC, int N, typename Acc>
__device__ __forceinline__ void store_vals(TC* dst, const Acc* a, const float* __restrict__ scale,
                                           int64_t bag, int T) {
  if constexpr (std::is_same<TC, int32_t>::value) {
    int o[N];
#pragma unroll
    for (int i = 0; i < N; ++i) o[i] = a[i];
    store_row<TC>(dst, o);
  } else {
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
}

// Per-table int8 long bags, stage 1 of a window from slot w0 of bag h0 / L:
// the masks and hot ids of its NI * LB slots, slot w0 + r * LB + l of the
// bag being its lane l's r-th (none past L or past the last bag).
template <int NI, int LB>
__device__ __forceinline__ void load_front(uint8_t (&m)[NI], int32_t (&sel)[NI],
                                           const uint8_t* __restrict__ hot_mask,
                                           const int32_t* __restrict__ hot_sel, int64_t h0,
                                           int w0, int L, bool real, int lane) {
#pragma unroll
  for (int r = 0; r < NI; ++r) {
    const int l = w0 + r * LB + lane % LB;
    const bool in = real && l < L;
    m[r] = in ? __ldg(hot_mask + h0 + l) : 0;
    sel[r] = in ? __ldg(hot_sel + h0 + l) : 0;
  }
}

// Stage 2 of that window: each slot's code (hot row -2 - sel, cold entry
// lo + rank while rank < n_cold, else -1), the rank of a non-hot slot
// counted over the bag's lanes (seg) of one ballot and carried across
// windows in `carry`; the cold ids load here.
template <int NI, int LB>
__device__ __forceinline__ void front_codes(int32_t (&code)[NI], const uint8_t (&m)[NI],
                                            const int32_t (&sel)[NI],
                                            const int32_t* __restrict__ cold_ids, int w0,
                                            int L, bool real, int lane, unsigned seg,
                                            int& carry, int64_t lo, int n_cold) {
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int r = 0; r < NI; ++r) {
    const int l = w0 + r * LB + lane % LB;
    const bool in = real && l < L;
    const bool hit = in && m[r] != 0;
    const unsigned cold_ball = __ballot_sync(kFull, in && !hit) & seg;
    const int rank = carry + __popc(cold_ball & below);
    carry += __popc(cold_ball);
    code[r] = hit ? -2 - sel[r] : in && rank < n_cold ? __ldg(cold_ids + lo + rank) : -1;
  }
}

// Launch 2. UB = 0: G bags a warp (L > 8), windows of 32 / G * NI slots a
// bag. UB in {1, 2, 4, 8} (L <= UB): a slot a bag, S bags a warp, U of its
// UB rows loaded a step.
template <int M, typename TIn, typename TC, int D, int V, int G, int U, int H, int UB, int NI,
          typename TO = TC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_hotcold_kernel(const TIn* __restrict__ hot, const TIn* __restrict__ table,
                             const float* __restrict__ scale,
                             const int32_t* __restrict__ hot_sel,
                             const uint8_t* __restrict__ hot_mask,
                             const int32_t* __restrict__ cold_ids,
                             const int32_t* cold_start,  // launch 1's: read past the wait only
                             TO* __restrict__ out, int64_t n_bags, int T, int L) {
  constexpr int P = D / V;   // lanes a row
  constexpr int S = 32 / P;  // row slots a warp
  using Acc = typename std::conditional<M == kInt8, int, float>::type;
  static_assert(D % V == 0 && 32 % P == 0 && V % S == 0, "unsupported mapping");
  const int lane = threadIdx.x & 31;
  const int slot = lane / P;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  bool waited = false;

  if constexpr (UB == 0 && M == kInt8) {
    // Per-table int8 long bags: the front end pipelined across windows.
    // While window w's rows load, window w + 1's cold ids (stage 2) and
    // window w + 2's masks and hot ids (stage 1) are in flight, so a window
    // waits for one round trip (its rows) where it waited for three. The
    // codes, and so the rows read and the sums, are those of the windows
    // taken one after another.
    constexpr int SPB = S / G;
    constexpr int LB = 32 / G;
    constexpr int CH = SPB * U;
    constexpr int WIN = LB * NI;
    static_assert(S % G == 0 && WIN % CH == 0, "a bag owns whole slots; a window is whole steps");
    const int bi = lane / LB;
    const int s = slot % SPB;
    const unsigned seg = G == 1 ? kFull : ((1u << (LB % 32)) - 1u) << (bi * LB);
    const int64_t n_tasks = (n_bags + G - 1) / G;
    for (int64_t task = warp; task < n_tasks; task += warps) {
      const int64_t bag = task * G + bi;
      const bool real = G == 1 || bag < n_bags;
      const int64_t h0 = bag * L;
      Acc acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0;
      uint8_t m0[NI], m1[NI];
      int32_t sel0[NI], sel1[NI], c0[NI], c1[NI];
      load_front<NI, LB>(m0, sel0, hot_mask, hot_sel, h0, 0, L, real, lane);
      load_front<NI, LB>(m1, sel1, hot_mask, hot_sel, h0, WIN, L, real, lane);
      wait_cold_starts();
      waited = true;
      int64_t lo = 0;
      int n_cold = 0, carry = 0;
      if (real) {
        const int32_t a = __ldcg(cold_start + bag), b = __ldcg(cold_start + bag + 1);
        lo = a;
        n_cold = b - a;
      }
      front_codes<NI, LB>(c0, m0, sel0, cold_ids, 0, L, real, lane, seg, carry, lo, n_cold);
      for (int w0 = 0; w0 < L; w0 += WIN) {
        front_codes<NI, LB>(c1, m1, sel1, cold_ids, w0 + WIN, L, real, lane, seg, carry, lo,
                            n_cold);
        load_front<NI, LB>(m1, sel1, hot_mask, hot_sel, h0, w0 + 2 * WIN, L, real, lane);
#pragma unroll
        for (int k = 0; k < WIN / CH; ++k) {
          if (w0 + k * CH >= L) break;
          int32_t rid[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int p0 = k * CH + u * SPB;  // a multiple of SPB: p0 % LB + s < LB
            rid[u] = __shfl_sync(kFull, c0[p0 / LB], bi * LB + p0 % LB + s);
          }
          add_rows<M, TIn, TC, D, V, H>(acc, hot, table, rid, lane);
        }
#pragma unroll
        for (int r = 0; r < NI; ++r) c0[r] = c1[r];
      }
      reduce_scatter<P, P * SPB, V / 2>(acc, lane);  // over the bag's slots
      if (real)
        store_vals<M, TO, V / SPB>(out + bag * D + (lane % P) * V + slot_share<V, SPB>(s), acc,
                                   scale, bag, T);
    }
  } else if constexpr (UB == 0) {
    constexpr int SPB = S / G;     // slots a bag
    constexpr int LB = 32 / G;     // lanes a bag: bag bi of a task owns lanes [bi * LB, (bi + 1) * LB)
    constexpr int CH = SPB * U;    // slots of a bag a step
    constexpr int WIN = LB * NI;   // slots of a bag a window
    static_assert(S % G == 0 && WIN % CH == 0, "a bag owns whole slots; a window is whole steps");
    const int bi = G == 1 ? 0 : lane / LB;
    const int s = G == 1 ? slot : slot % SPB;  // the lane's slot in its bag
    const unsigned below = (1u << lane) - 1u;
    const unsigned seg = G == 1 ? kFull : ((1u << (LB % 32)) - 1u) << (bi * LB);  // the bag's lanes
    const int64_t n_tasks = (n_bags + G - 1) / G;
    for (int64_t task = warp; task < n_tasks; task += warps) {
      const int64_t bag = task * G + bi;
      const bool real = G == 1 || bag < n_bags;  // the last task may hold fewer than G bags
      Acc acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0;
      const int64_t h0 = bag * L;
      int64_t lo = 0;
      int n_cold = 0, carry = 0;  // the bag's cold entries; its non-hot slots of earlier windows
      for (int w0 = 0; w0 < L; w0 += WIN) {
        // Round trip 1: the window's masks and hot ids side by side, and
        // (first window) the bag's cold range; slot w0 + r * LB + l of the
        // bag is its lane l's r-th.
        bool in[NI], hit[NI];
        int32_t sel[NI], code[NI];
#pragma unroll
        for (int r = 0; r < NI; ++r) {
          const int l = w0 + r * LB + lane % LB;
          in[r] = real && l < L;
          hit[r] = in[r] && __ldg(hot_mask + h0 + l) != 0;
          sel[r] = in[r] ? __ldg(hot_sel + h0 + l) : 0;
        }
        if (w0 == 0) {
          wait_cold_starts();
          waited = true;
          if (real) {
            const int32_t a = __ldcg(cold_start + bag), b = __ldcg(cold_start + bag + 1);
            lo = a;
            n_cold = b - a;
          }
        }
        // Round trip 2: the cold id of each non-hot slot of rank < n_cold,
        // its rank counted over the bag's lanes of one ballot.
#pragma unroll
        for (int r = 0; r < NI; ++r) {
          const unsigned cold_ball = __ballot_sync(kFull, in[r] && !hit[r]) & seg;
          const int rank = carry + __popc(cold_ball & below);
          carry += __popc(cold_ball);
          const bool cold = in[r] && !hit[r] && rank < n_cold;
          code[r] = cold ? __ldg(cold_ids + lo + rank) : -1;
        }
#pragma unroll
        for (int r = 0; r < NI; ++r) code[r] = hit[r] ? -2 - sel[r] : code[r];
        // The steps: row u of a slot is the bag's step slot u * SPB + s,
        // held by the bag's lane (k * CH + u * SPB) % LB + s.
#pragma unroll
        for (int k = 0; k < WIN / CH; ++k) {
          if (w0 + k * CH >= L) break;
          int32_t rid[U];
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int p0 = k * CH + u * SPB;  // a multiple of SPB: p0 % LB + s < LB
            const int src = G == 1 ? (p0 + slot) & 31 : bi * LB + p0 % LB + s;
            rid[u] = __shfl_sync(kFull, code[p0 / LB], src);
          }
          add_rows<M, TIn, TC, D, V, H>(acc, hot, table, rid, lane);
        }
      }
      reduce_scatter<P, P * SPB, V / 2>(acc, lane);  // over the bag's slots
      if (real)
        store_vals<M, TO, V / SPB>(out + bag * D + (lane % P) * V + slot_share<V, SPB>(s), acc,
                                   scale, bag, T);
    }
  } else {
    // S bags a task, slot s holding bag bag0 + s.
    constexpr int NW = S * UB;
    constexpr int NJ = (NW + 31) / 32;
    static_assert(UB % U == 0, "a bag is whole steps");
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
      if constexpr (U == UB) {
        add_rows<M, TIn, TC, D, V, H>(acc, hot, table, code, lane);
      } else {
#pragma unroll
        for (int k = 0; k < UB / U; ++k) {
          int32_t rid[U];
#pragma unroll
          for (int u = 0; u < U; ++u) rid[u] = code[k * U + u];
          add_rows<M, TIn, TC, D, V, H>(acc, hot, table, rid, lane);
        }
      }
      if (bag < n_bags) store_vals<M, TO, V>(out + bag * D + (lane % P) * V, acc, scale, bag, T);
    }
  }
  // A warp with no task still waits, so K6 never ends before launch 1.
  if (!waited) wait_cold_starts();
}

constexpr int kGeneralCols = 4;

// One element of a row at p (column c of a row of `d` values) as the value
// the bag sums: float rows converted to the compute dtype, per-table int8
// as an exact int, row-wise int8 times the row's scale.
template <int M, typename TC, typename TIn>
__device__ __forceinline__ float general_value(const TIn* p, int c, float row_scale) {
  if constexpr (M == kFloat) {
    return as_compute<TC>(to_float(__ldg(p + c)));
  } else {
    return __fmul_rn(static_cast<float>(__ldg(p + c)), row_scale);
  }
}

// Launch 2 at any width: a warp a bag (grid-stride), the slots in order.
template <int M, typename TIn, typename TC, typename TO>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_hotcold_general_kernel(const TIn* __restrict__ hot, const TIn* __restrict__ table,
                                     const float* __restrict__ scale,
                                     const int32_t* __restrict__ hot_sel,
                                     const uint8_t* __restrict__ hot_mask,
                                     const int32_t* __restrict__ cold_ids,
                                     const int32_t* cold_start,  // launch 1's, past the wait
                                     TO* __restrict__ out, int d, int64_t n_bags, int T, int L) {
  using Acc = typename std::conditional<M == kInt8, int, float>::type;
  const int lane = threadIdx.x & 31;
  const int64_t rb = M == kRowwise ? d + 4 : d;  // a row's elements (bytes for int8)
  wait_cold_starts();
  for (int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); bag < n_bags;
       bag += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t lo = cold_start[bag];
    const int64_t n_cold = cold_start[bag + 1] - lo;
    for (int c0 = 0; c0 < d; c0 += 32 * kGeneralCols) {
      Acc acc[kGeneralCols] = {};
      int64_t rank = 0;  // non-hot slots so far
      for (int l0 = 0; l0 < L; l0 += 32) {
        uint8_t m = 0;
        int32_t sel = 0;
        if (l0 + lane < L) {
          m = __ldg(hot_mask + bag * L + l0 + lane);
          sel = __ldg(hot_sel + bag * L + l0 + lane);
        }
        const int n = min(32, L - l0);
        for (int j = 0; j < n; ++j) {  // every value below is the same in every lane
          const bool hit = __shfl_sync(kFull, (int)m, j) != 0;
          const int32_t sj = __shfl_sync(kFull, sel, j);
          const TIn* row;
          if (hit) {
            row = hot + (int64_t)sj * rb;
          } else {
            if (rank >= n_cold) continue;
            row = table + (int64_t)__ldg(cold_ids + lo + rank) * rb;
            ++rank;
          }
          float row_scale = 1.f;
          if constexpr (M == kRowwise) {
            const uint8_t* b = reinterpret_cast<const uint8_t*>(row) + d;
            row_scale = __uint_as_float((uint32_t)__ldg(b) | ((uint32_t)__ldg(b + 1) << 8) |
                                        ((uint32_t)__ldg(b + 2) << 16) |
                                        ((uint32_t)__ldg(b + 3) << 24));
          }
#pragma unroll
          for (int k = 0; k < kGeneralCols; ++k) {
            const int c = c0 + lane + 32 * k;
            if (c >= d) continue;
            if constexpr (M == kInt8) {
              acc[k] += (int)__ldg(row + c);
            } else {
              acc[k] += general_value<M, TC>(row, c, row_scale);
            }
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kGeneralCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c >= d) continue;
        TO* dst = out + bag * d + c;
        if constexpr (std::is_same<TO, int32_t>::value) {
          to_out(acc[k], dst);
        } else if constexpr (M == kInt8) {
          to_out(__fmul_rn(static_cast<float>(acc[k]), __ldg(scale + bag % T)), dst);
        } else {
          to_out(acc[k], dst);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The cold-only instance: K6 on a row shard that counts no hot hit (every
// shard of a mesh but the first). It computes the TPU package's shard body
// (deeprecsys_tpu/parallel/sharding.py:212-216 and :263-270, local_fn): the
// shard's compacted cold rows segment-summed by cold_seg into the (B*T, D)
// partial, the pads' bag (B*T) dropped, bags with no cold entry zero. It
// reads no hot_sel, hot_mask or hot row and builds no cold_start: one
// launch, no atomics, every output row written once.
//
// A warp owns kColdChunk consecutive cold entries [c0, c1) and the bags
// (cold_seg[c0 - 1], cold_seg[c1 - 1]] (cold_seg[-1] = -1; the last chunk's
// run to B*T - 1), so the chunks' bags tile [0, B*T) since cold_seg does not
// decrease. Every bag it owns that has entries begins inside its chunk (a
// bag's first entry is the first with cold_seg >= it), and it finishes each
// of them, reading past c1 for the last; the entries before its first
// begun bag belong to the warp before. Round trip 1 loads the chunk's ids
// and segments and the next chunk's (a lane two of each) and the segment
// before the chunk; the bags begun are the lanes whose segment differs from
// the one before (one ballot). The owned bags before the first begun one
// and after the last have no entry: the warp stores their zeros as one
// contiguous run, 16 bytes a lane. The begun bags go a slot a bag (K6's
// short-bag mapping: V values a lane, P lanes a row, S = 32 / P slots), S
// of them a round: a slot finds its bag's entries [start, end) from the
// begin ballot (__fns), takes their ids from the lanes that hold them (past
// the 64 held, from cold_ids) and loads U rows a step (round trip 2), then
// stores the bag's V values and zeroes the run of bags with no entry after
// it (a sparse stream's chunk spans many such bags). Rows
// load as K6's cold rows do (load_row16 with the layout's hint, row-wise
// rows as K4 loads them).
constexpr int kColdChunk = 32;  // cold entries a warp (ops/embedding.py::K6_COLD_CHUNK)
constexpr int kColdRows = 8;    // rows a slot loads at once (U; row-wise rows half as many)

// What a warp knows of its chunk after round trip 1.
struct ColdChunk {
  int32_t seg;        // this lane's entry's segment (n_bags past the stream)
  int32_t id[2];      // this lane's entries c0 + lane and c0 + 32 + lane (0 past the stream)
  unsigned begins;    // lanes whose entry begins a real bag
  int nb;             // bags begun in the chunk
  int64_t lo, hi;     // the bags the warp owns, [lo, hi]
  int32_t first, last;  // the first and the last begun bag
  int64_t last_end;   // one past the last begun bag's entries
};

// The first pad (segment >= n_bags) in [0, hi], cold_seg[hi] being one: a
// search of 32 probes a round (each round a dependent load; about
// log32(hi) of them).
__device__ __forceinline__ int64_t first_pad(const int32_t* __restrict__ cold_seg, int64_t hi,
                                             int32_t n_bags, int lane) {
  int64_t lo = 0;  // every entry below lo is real
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const unsigned m = __ballot_sync(kFull, p >= hi || __ldg(cold_seg + p) >= n_bags);
    if (m == 0u) {
      lo += 31 * step + 1;
      continue;
    }
    const int j = __ffs(m) - 1;
    hi = min(lo + j * step, hi);
    if (j > 0) lo += (j - 1) * step + 1;
  }
  return lo;
}

// A chunk of real entries owns the bags (cold_seg[c0 - 1], the last real
// segment in it]; the last chunk's run to n_bags - 1. The bags past the
// last real entry of the stream (every bag, at a shard that owns no cold
// entry) are the pad-only chunks' (those from the first pad on), split
// among them evenly: each finds the first pad, and so the last real
// segment, by first_pad (pad_share, kept out of line: the chunks of real
// entries never run it).
struct BagRange {
  int64_t lo, hi;
};

__device__ __noinline__ BagRange pad_share(const int32_t* __restrict__ cold_seg, int64_t chunk,
                                           int64_t n_chunks, int32_t n_bags, int32_t before,
                                           int lane) {
  const int64_t c0 = chunk * kColdChunk;
  const int64_t pad = c0 == 0 ? 0 : before < n_bags ? c0 : first_pad(cold_seg, c0 - 1, n_bags,
                                                                     lane);
  const int64_t last_real = pad == 0 ? -1 : (int64_t)min(__ldg(cold_seg + pad - 1), n_bags);
  const int64_t pad_chunk0 = (pad + kColdChunk - 1) / kColdChunk;
  const int64_t share = (n_bags - 1 - last_real + n_chunks - pad_chunk0 - 1) /
                        (n_chunks - pad_chunk0);
  const int64_t lo = last_real + 1 + (chunk - pad_chunk0) * share;
  return {lo, (lo + share < n_bags ? lo + share : n_bags) - 1};
}

// A chunk of real entries: its begun bags, the bags it owns, its last
// bag's end (past the chunk where that bag runs on).
__device__ __forceinline__ void begun_bags(ColdChunk& c, const int32_t* __restrict__ cold_seg,
                                           int64_t c_pad, int64_t c0, int32_t seg1,
                                           int32_t before, int32_t n_bags, int lane) {
  const int32_t up = __shfl_up_sync(kFull, c.seg, 1);
  c.begins = __ballot_sync(kFull, c.seg != (lane == 0 ? before : up) && c.seg < n_bags);
  c.nb = __popc(c.begins);
  c.lo = before + 1;
  const unsigned real = __ballot_sync(kFull, c.seg < n_bags);
  c.hi = c0 + kColdChunk >= c_pad ? n_bags - 1
                                  : (int64_t)__shfl_sync(kFull, c.seg, 31 - __clz(real));
  if (c.nb == 0) return;
  const int pl = 31 - __clz(c.begins);
  c.first = __shfl_sync(kFull, c.seg, __ffs(c.begins) - 1);
  c.last = __shfl_sync(kFull, c.seg, pl);
  // The last begun bag's end: the first entry after it of another segment.
  unsigned m = __ballot_sync(kFull, c.seg != c.last) & (pl == 31 ? 0u : ~0u << (pl + 1));
  if (m != 0u) {
    c.last_end = c0 + __ffs(m) - 1;
  } else if ((m = __ballot_sync(kFull, seg1 != c.last)) != 0u) {
    c.last_end = c0 + 32 + __ffs(m) - 1;
  } else {
    for (int64_t base = c0 + 64;; base += 32) {  // a bag longer than the two chunks held
      const int64_t i = base + lane;
      const int32_t s = i < c_pad ? min(__ldg(cold_seg + i), n_bags) : n_bags;
      m = __ballot_sync(kFull, s != c.last);
      if (m != 0u) {
        c.last_end = base + __ffs(m) - 1;
        break;
      }
    }
  }
}

__device__ __forceinline__ ColdChunk cold_chunk(const int32_t* __restrict__ cold_ids,
                                                const int32_t* __restrict__ cold_seg,
                                                int64_t c_pad, int64_t chunk, int64_t n_chunks,
                                                int32_t n_bags, int lane) {
  ColdChunk c;
  const int64_t c0 = chunk * kColdChunk;
  const int64_t i0 = c0 + lane, i1 = i0 + 32;
  c.seg = i0 < c_pad ? min(__ldg(cold_seg + i0), n_bags) : n_bags;
  const int32_t seg1 = i1 < c_pad ? min(__ldg(cold_seg + i1), n_bags) : n_bags;
  c.id[0] = i0 < c_pad ? __ldg(cold_ids + i0) : 0;
  c.id[1] = i1 < c_pad ? __ldg(cold_ids + i1) : 0;
  const int32_t before = c0 == 0 ? -1 : min(__ldg(cold_seg + c0 - 1), n_bags);
  c.nb = 0;
  c.begins = 0u;
  c.first = c.last = 0;
  c.last_end = c0;
  if (__shfl_sync(kFull, c.seg, 0) >= n_bags) {  // a pad-only chunk
    const BagRange r = pad_share(cold_seg, chunk, n_chunks, n_bags, before, lane);
    c.lo = r.lo;
    c.hi = r.hi;
  } else {
    begun_bags(c, cold_seg, c_pad, c0, seg1, before, n_bags, lane);
  }
  return c;
}

// Entry e's id: held by a lane (e - c0 < 64) or loaded. Every lane calls it.
__device__ __forceinline__ int32_t cold_id(const ColdChunk& c, const int32_t* __restrict__ cold_ids,
                                           int64_t c0, int64_t e, bool live) {
  const int64_t r = e - c0;
  const int32_t held = id_of<2>(c.id, r >= 0 && r < 64 ? (int)r : 0);
  return !live ? -1 : r < 64 ? held : __ldg(cold_ids + e);
}

// Zeros over the partial's bags [lo, hi] (one contiguous run), 16 bytes a lane.
template <typename TO, int D>
__device__ __forceinline__ void zero_bags(TO* __restrict__ out, int64_t lo, int64_t hi, int lane) {
  static_assert(D * sizeof(TO) % 16 == 0, "a bag's partial is whole 16-byte words");
  uint4* p = reinterpret_cast<uint4*>(out + lo * D);
  const int64_t n = (hi - lo + 1) * D * (int64_t)sizeof(TO) / 16;
  for (int64_t w = lane; w < n; w += 32) p[w] = make_uint4(0u, 0u, 0u, 0u);
}

template <int M, typename TIn, typename TC, typename TO, int D, int H>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_cold_partial_kernel(const TIn* __restrict__ table,
                                  const int32_t* __restrict__ cold_ids,
                                  const int32_t* __restrict__ cold_seg, int64_t c_pad,
                                  TO* __restrict__ out, int64_t n_bags) {
  constexpr int V = M == kRowwise ? 16 : 16 / (int)sizeof(TIn);
  constexpr int P = D / V;   // lanes a row
  constexpr int S = 32 / P;  // bags a round
  constexpr int U = M == kRowwise ? kColdRows / 2 : kColdRows;  // row-wise: two chunks a row
  using Acc = typename std::conditional<M == kInt8, int, float>::type;
  const int lane = threadIdx.x & 31;
  const int slot = lane / P;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n_chunks = c_pad > 0 ? (c_pad + kColdChunk - 1) / kColdChunk : 1;
  for (int64_t chunk = warp; chunk < n_chunks; chunk += warps) {
    const int64_t c0 = chunk * kColdChunk;
    const ColdChunk c = cold_chunk(cold_ids, cold_seg, c_pad, chunk, n_chunks, (int32_t)n_bags,
                                   lane);
    zero_bags<TO, D>(out, c.lo, c.nb != 0 ? c.first - 1 : c.hi, lane);
    // S begun bags a round, slot s the round's s-th: its entries
    // [start, start + n) pooled, then the zero run up to the next begun bag
    // (the last one's up to hi) by the slot's P lanes.
    for (int k0 = 0; k0 < c.nb; k0 += S) {
      const int k = k0 + slot;  // the slot's bag's rank among the chunk's begun bags
      const bool live = k < c.nb;
      const int p = live ? (int)__fns(c.begins, 0, k + 1) : 0;
      const int pn = k + 1 < c.nb ? (int)__fns(c.begins, 0, k + 2) : 0;
      const int64_t bag = __shfl_sync(kFull, c.seg, p);
      const int32_t next_seg = __shfl_sync(kFull, c.seg, pn);
      const int64_t start = c0 + p;
      const int n = !live ? 0 : (int)((k + 1 < c.nb ? c0 + pn : c.last_end) - start);
      const int64_t next = k + 1 < c.nb ? (int64_t)next_seg : c.hi + 1;
      const int steps = __reduce_max_sync(kFull, n);
      Acc acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0;
      for (int e0 = 0; e0 < steps; e0 += U) {
        int32_t code[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          code[u] = cold_id(c, cold_ids, c0, start + e0 + u, e0 + u < n);
        add_rows<M, TIn, TC, D, V, H>(acc, table, table, code, lane);
      }
      if (!live) continue;
      store_vals<M, TO, V>(out + bag * D + (lane % P) * V, acc, nullptr, bag, 1);
      constexpr int kWords = D * (int)sizeof(TO) / 16;  // 16-byte words a bag
      uint4* run = reinterpret_cast<uint4*>(out);
      for (int64_t w = (bag + 1) * kWords + lane % P; w < next * kWords; w += P)
        run[w] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The cold-only instance at any width: the same chunks and bags, a warp a
// bag in order, lane c the columns c, c + 32, ... as the general instance.
template <int M, typename TIn, typename TC, typename TO>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_cold_partial_general_kernel(const TIn* __restrict__ table,
                                          const int32_t* __restrict__ cold_ids,
                                          const int32_t* __restrict__ cold_seg, int64_t c_pad,
                                          TO* __restrict__ out, int d, int64_t n_bags) {
  using Acc = typename std::conditional<M == kInt8, int, float>::type;
  const int lane = threadIdx.x & 31;
  const int64_t rb = M == kRowwise ? d + 4 : d;  // a row's elements (bytes for int8)
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  const int64_t n_chunks = c_pad > 0 ? (c_pad + kColdChunk - 1) / kColdChunk : 1;
  auto zero = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo * d + lane; i < (hi + 1) * d; i += 32) out[i] = TO(0);
  };
  for (int64_t chunk = warp; chunk < n_chunks; chunk += warps) {
    const int64_t c0 = chunk * kColdChunk;
    const ColdChunk c = cold_chunk(cold_ids, cold_seg, c_pad, chunk, n_chunks, (int32_t)n_bags,
                                   lane);
    zero(c.lo, c.nb != 0 ? c.first - 1 : c.hi);
    if (c.nb == 0) continue;
    zero((int64_t)c.last + 1, c.hi);
    int64_t done = c.first;  // bags below it are written
    for (int k = 0; k < c.nb; ++k) {
      const int p = (int)__fns(c.begins, 0, k + 1);
      const int64_t bag = __shfl_sync(kFull, c.seg, p);
      zero(done, bag - 1);
      const int64_t start = c0 + p;
      const int64_t end = k + 1 < c.nb ? c0 + __fns(c.begins, 0, k + 2) : c.last_end;
      for (int col0 = 0; col0 < d; col0 += 32 * kGeneralCols) {
        Acc acc[kGeneralCols] = {};
        for (int64_t e = start; e < end; ++e) {  // every value below is the same in every lane
          const TIn* row = table + (int64_t)cold_id(c, cold_ids, c0, e, true) * rb;
          float row_scale = 1.f;
          if constexpr (M == kRowwise) {
            const uint8_t* b = reinterpret_cast<const uint8_t*>(row) + d;
            row_scale = __uint_as_float((uint32_t)__ldg(b) | ((uint32_t)__ldg(b + 1) << 8) |
                                        ((uint32_t)__ldg(b + 2) << 16) |
                                        ((uint32_t)__ldg(b + 3) << 24));
          }
#pragma unroll
          for (int j = 0; j < kGeneralCols; ++j) {
            const int col = col0 + lane + 32 * j;
            if (col >= d) continue;
            if constexpr (M == kInt8) {
              acc[j] += (int)__ldg(row + col);
            } else {
              acc[j] += general_value<M, TC>(row, col, row_scale);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kGeneralCols; ++j) {
          const int col = col0 + lane + 32 * j;
          if (col < d) to_out(acc[j], out + bag * d + col);
        }
      }
      done = bag + 1;
    }
  }
}

// The cold-only launch: the tuned mapping at D = 32 and 64 (K6's hint of a
// long bag's cold rows), the general instance at any other width.
template <int M, typename TIn, typename TC, typename TO>
int launch_cold(int d, const TIn* table, const int32_t* cold_ids, const int32_t* cold_seg,
                int64_t c_pad, TO* out, int64_t n_bags, int grid, cudaStream_t stream) {
  const dim3 g((unsigned)grid), b(kWarpsPerBlock * 32);
  if (d == 32) {
    embedding_bag_cold_partial_kernel<M, TIn, TC, TO, 32, Shipped<M, TIn, 32, false>::H>
        <<<g, b, 0, stream>>>(table, cold_ids, cold_seg, c_pad, out, n_bags);
  } else if (d == 64) {
    embedding_bag_cold_partial_kernel<M, TIn, TC, TO, 64, Shipped<M, TIn, 64, false>::H>
        <<<g, b, 0, stream>>>(table, cold_ids, cold_seg, c_pad, out, n_bags);
  } else {
    embedding_bag_cold_partial_general_kernel<M, TIn, TC, TO>
        <<<g, b, 0, stream>>>(table, cold_ids, cold_seg, c_pad, out, d, n_bags);
  }
  return (int)cudaGetLastError();
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

// Launch 2 with mapping (V, G, U, H) and plan (UB, NI), with programmatic
// dependent launch unless the caller says otherwise (the sweep measures both).
template <int M, typename TIn, typename TC, int D, int V, int G, int U, int H, int UB, int NI,
          typename TO = TC>
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
      &cfg, embedding_bag_hotcold_kernel<M, TIn, TC, D, V, G, U, H, UB, NI, TO>,
      static_cast<const TIn*>(a.hot), static_cast<const TIn*>(a.table), a.scale, a.hot_sel,
      a.hot_mask, a.cold_ids, static_cast<const int32_t*>(a.cold_start), static_cast<TO*>(a.out),
      a.n_bags, a.T, a.L);
}

// ids_per_lane of a long-bag window: the power of two >= p (the bag's
// slots over its lanes, rounded up) capped at NI, then rounded up to whole
// steps (P * NI a multiple of U). ops/embedding.py::k6_launch_plan's rule.
__host__ __device__ constexpr int gcd_of(int a, int b) { return b == 0 ? a : gcd_of(b, a % b); }
template <int P, int U, int NI>
__host__ __device__ constexpr int window_ids(int p) {
  return ((p < NI ? p : NI) + U / gcd_of(U, P) - 1) / (U / gcd_of(U, P)) * (U / gcd_of(U, P));
}

// The plans ops/embedding.py::k6_launch_plan picks: rows_per_slot 0 (G bags
// a warp) for L > 8 with ids_per_lane window_ids(1 .. NI); else the power of
// two >= L, U of its rows a step; each with the layout's shipped mapping
// (no hint on bags of one row).
template <int M, typename TIn, typename TC, int D, typename TO = TC>
int launch_plan(int rows_per_slot, int ids_per_lane, const Args& a) {
  using LB = Shipped<M, TIn, D, false>;
  using SB = Shipped<M, TIn, D, true>;
  constexpr int P = D / LB::V;
  if (rows_per_slot == 0) {
    constexpr int n1 = window_ids<P, LB::U, LB::NI>(1), n2 = window_ids<P, LB::U, LB::NI>(2),
                  n4 = window_ids<P, LB::U, LB::NI>(4), n8 = window_ids<P, LB::U, LB::NI>(8),
                  n16 = window_ids<P, LB::U, LB::NI>(16);
    if (ids_per_lane == n1)
      return launch<M, TIn, TC, D, LB::V, LB::G, LB::U, LB::H, 0, n1, TO>(a);
    if (ids_per_lane == n2)
      return launch<M, TIn, TC, D, LB::V, LB::G, LB::U, LB::H, 0, n2, TO>(a);
    if (ids_per_lane == n4)
      return launch<M, TIn, TC, D, LB::V, LB::G, LB::U, LB::H, 0, n4, TO>(a);
    if constexpr (LB::NI >= 8) {
      if (ids_per_lane == n8)
        return launch<M, TIn, TC, D, LB::V, LB::G, LB::U, LB::H, 0, n8, TO>(a);
    }
    if constexpr (LB::NI >= 16) {
      if (ids_per_lane == n16)
        return launch<M, TIn, TC, D, LB::V, LB::G, LB::U, LB::H, 0, n16, TO>(a);
    }
    return (int)cudaErrorInvalidValue;
  }
  constexpr int U2 = SB::U < 2 ? SB::U : 2, U4 = SB::U < 4 ? SB::U : 4, U8 = SB::U < 8 ? SB::U : 8;
  switch (rows_per_slot) {
    case 1: return launch<M, TIn, TC, D, SB::V, 1, 1, 0, 1, 1, TO>(a);  // one row: no hint
    case 2: return launch<M, TIn, TC, D, SB::V, 1, U2, SB::H, 2, 1, TO>(a);
    case 4: return launch<M, TIn, TC, D, SB::V, 1, U4, SB::H, 4, 1, TO>(a);
    case 8: return launch<M, TIn, TC, D, SB::V, 1, U8, SB::H, 8, 1, TO>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch 2 of the general instance, as launch() launches the others.
template <int M, typename TIn, typename TC, typename TO>
int launch_general(int d, const Args& a) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.grid);
  cfg.blockDim = dim3(kWarpsPerBlock * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(
      &cfg, embedding_bag_hotcold_general_kernel<M, TIn, TC, TO>,
      static_cast<const TIn*>(a.hot), static_cast<const TIn*>(a.table), a.scale, a.hot_sel,
      a.hot_mask, a.cold_ids, static_cast<const int32_t*>(a.cold_start), static_cast<TO*>(a.out),
      d, a.n_bags, a.T, a.L);
}

// rows_per_slot < 0: the general instance at any width; else the plan's
// mapping at D = 32 or 64.
template <int M, typename TIn, typename TC, typename TO = TC>
int launch_width(int d, int rows_per_slot, int ids_per_lane, const Args& a) {
  if (rows_per_slot < 0) return launch_general<M, TIn, TC, TO>(d, a);
  if (d == 32) return launch_plan<M, TIn, TC, 32, TO>(rows_per_slot, ids_per_lane, a);
  if (d == 64) return launch_plan<M, TIn, TC, 64, TO>(rows_per_slot, ids_per_lane, a);
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

// Both launches on one row shard: out is the partial, f32 for float and
// row-wise tables, int32 for per-table int8 (compute_dtype, 0 = f32 and 1 =
// bf16, is the type a float row is converted to before its f32 sum; a bf16
// row is already a bf16 value, so a bf16 table takes the f32 instance).
// The other arguments as drs_embedding_bag_hotcold's; scale is not read.
int drs_embedding_bag_hotcold_partial(int mode, int table_dtype, int d, const void* hot,
                                      const void* table, const void* hot_sel,
                                      const void* hot_mask, const void* cold_ids,
                                      const void* cold_seg, int64_t c_pad, void* cold_start,
                                      void* out, int compute_dtype, int64_t n_bags, int T, int L,
                                      int rows_per_slot, int ids_per_lane, int grid,
                                      void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0 || c_pad < 0 || (rows_per_slot > 0 && L > rows_per_slot))
    return (int)cudaErrorInvalidValue;
  const Args a = make_args(hot, table, nullptr, hot_sel, hot_mask, cold_ids, cold_seg, c_pad,
                           cold_start, out, n_bags, T, L, grid, stream);
  const int err = launch_cold_starts(a);
  if (err != 0) return err;
  const int u = rows_per_slot, ni = ids_per_lane;
  if (mode == kFloat && table_dtype == 1 && (compute_dtype == 0 || compute_dtype == 1))
    return launch_width<kFloat, __nv_bfloat16, float, float>(d, u, ni, a);
  if (mode == kFloat && table_dtype == 0 && compute_dtype == 0)
    return launch_width<kFloat, float, float, float>(d, u, ni, a);
  if (mode == kFloat && table_dtype == 0 && compute_dtype == 1)
    return launch_width<kFloat, float, __nv_bfloat16, float>(d, u, ni, a);
  if (mode == kInt8) return launch_width<kInt8, int8_t, float, int32_t>(d, u, ni, a);
  if (mode == kRowwise) return launch_width<kRowwise, int8_t, float, float>(d, u, ni, a);
  return (int)cudaErrorInvalidValue;
}

// The cold-only instance on one row shard (one launch): out is the
// (n_bags, d) partial of the shard's cold stream, f32 for float and row-wise
// tables, int32 for per-table int8; mode, table_dtype and compute_dtype as
// drs_embedding_bag_hotcold_partial's. grid: ops/embedding.py::
// k6_cold_grid's (any grid covers the stream: the warps stride over it).
int drs_embedding_bag_cold_partial(int mode, int table_dtype, int d, const void* table,
                                   const void* cold_ids, const void* cold_seg, int64_t c_pad,
                                   void* out, int compute_dtype, int64_t n_bags, int grid,
                                   void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0 || c_pad < 0 || d < 1 || n_bags >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  const auto ids = static_cast<const int32_t*>(cold_ids);
  const auto seg = static_cast<const int32_t*>(cold_seg);
  const auto s = static_cast<cudaStream_t>(stream);
  float* f = static_cast<float*>(out);
  if (mode == kFloat && table_dtype == 1 && (compute_dtype == 0 || compute_dtype == 1))
    return launch_cold<kFloat, __nv_bfloat16, float>(
        d, static_cast<const __nv_bfloat16*>(table), ids, seg, c_pad, f, n_bags, grid, s);
  if (mode == kFloat && table_dtype == 0 && compute_dtype == 0)
    return launch_cold<kFloat, float, float>(d, static_cast<const float*>(table), ids, seg, c_pad,
                                             f, n_bags, grid, s);
  if (mode == kFloat && table_dtype == 0 && compute_dtype == 1)
    return launch_cold<kFloat, float, __nv_bfloat16>(d, static_cast<const float*>(table), ids,
                                                     seg, c_pad, f, n_bags, grid, s);
  if (mode == kInt8)
    return launch_cold<kInt8, int8_t, float>(d, static_cast<const int8_t*>(table), ids, seg,
                                             c_pad, static_cast<int32_t*>(out), n_bags, grid, s);
  if (mode == kRowwise)
    return launch_cold<kRowwise, int8_t, float>(d, static_cast<const int8_t*>(table), ids, seg,
                                                c_pad, f, n_bags, grid, s);
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
