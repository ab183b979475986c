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
//   hot      (K, W)     the hot rows, in the table's layout (K may be 0)
//   table    (R, W)     bf16 or f32 (W = D), int8 (W = D), or row-wise int8
//                       (W = D + 4: D values, then the row's f32 scale)
//   scale    (T,)       f32 per-table scales (per-table int8 only)
//   hot_sel  (B, T, L)  int32 position in the hot set; read where hot_mask
//   hot_mask (B, T, L)  uint8/bool: the slot is a hot hit
//   cold_ids (C_pad,)   int32 fused row ids of the cold lookups
//   cold_seg (C_pad,)   int32 bag b*T + t of each; non-decreasing, pads
//                       (bag B*T) last: ops/hotcold.py::split_hot_cold's
//                       order, which the kernel relies on and does not check
//   out      (B, T, D)  f32 or bf16
//
// Numerics, so that a hot/cold engine scores what the direct one does:
//   float: each row converted to the compute dtype, hot and cold rows summed
//     in one f32 accumulator, rounded once (K1's, csrc/embedding_bag.cu);
//   per-table int8: hot and cold rows summed in int32 (exact), then one f32
//     multiply (__fmul_rn) by the table's scale and one rounding: the JAX
//     op's bits;
//   row-wise int8: each value times its row's scale (__fmul_rn, never fused
//     into the add), an f32 sum, one rounding (K4's).
//
// Mapping. A lane loads 16 bytes of a row (4 for row-wise rows, which start
// on 4-byte boundaries only), so P lanes cover a row and a warp has S = 32 / P
// row slots. The plan (ops/embedding.py::k6_launch_plan) follows L:
//   * L > 8: a warp a bag g = b*T + t, grid-stride. Each slot has U rows in
//     flight a step, and a step reads CH = S * U <= 32 slots of the bag: the
//     step's hot_sel/hot_mask pairs (or cold ids) come in one coalesced load,
//     one a lane, and reach their slots by __shfl_sync (a missing or
//     masked-out one is -1 and loads nothing). The cold range [lo, hi) of
//     bag g is the lower bounds of g and g + 1 in the sorted cold_seg, found
//     by one warp-wide search, a half-warp each, 16 probes a step (five
//     dependent steps at 327,680 cold slots). At the end the slots are
//     combined with __shfl_xor_sync and slot 0 writes the row.
//   * L <= 8: a slot a bag, S consecutive bags a warp, each slot with all of
//     its bag's rows in flight (UB = the power of two >= L). The S bags' hot
//     slots are S * L consecutive entries; their cold lookups, at most S * L,
//     are a window of the sorted stream from the first bag's lower bound
//     (one search a warp, not a bag): both windows are loaded coalesced and
//     a slot finds its bag's part of the cold window by ballots over the
//     entries' bags. No combining step: a slot holds its whole bag.
// Row-wise: a slot's first lane also loads the row's scale and hands it to
// the slot by __shfl_sync. No atomics: the sum's order is fixed, so the
// result is deterministic. Pads (bag B*T) fall in no bag. Addresses are
// 64-bit.
//
// What bounds it: K1's random row reads (~21-24 G rows/s on an H100, PERF.md),
// plus one byte a slot for the mask: its bytes are K1's with a 1-byte mask
// beside each 4-byte id. Hot rows come from a K-row table that the L2 (50 MB)
// holds once warm, so at high coverage most rows are L2 hits; the design
// keeps U rows a lane in flight from either source, as K1 does, and reads
// the split arrays coalesced.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;  // ops/embedding.py::K6_WARPS_PER_BLOCK
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kFloat = 0, kInt8 = 1, kRowwise = 2 };

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

__device__ __forceinline__ void to_out(float x, float* p) { *p = x; }
__device__ __forceinline__ void to_out(float x, __nv_bfloat16* p) { *p = __float2bfloat16_rn(x); }

// Byte j of w, sign-extended.
__device__ __forceinline__ int byte_at(uint32_t w, int j) {
  return static_cast<int>(w << (24 - 8 * j)) >> 24;
}

template <int M, typename TIn, int D>
struct Geometry {
  static constexpr int kLoad = M == kRowwise ? 4 : 16;       // bytes a lane loads
  static constexpr int kElems = kLoad / (int)sizeof(TIn);    // values a lane loads
  static constexpr int P = D / kElems;                       // lanes a row
  static constexpr int S = 32 / P;                           // row slots a warp
  static constexpr int kMaxU = M == kRowwise ? 8 : 4;
  static constexpr int U = 32 / S < kMaxU ? 32 / S : kMaxU;  // rows a slot a step
  static constexpr int CH = S * U;                           // slots of the bag a step
  static constexpr int W = M == kRowwise ? D + 4 : D;        // row stride, elements
  static_assert(D % kElems == 0 && 32 % P == 0 && CH <= 32, "unsupported width");
};

// The first index in [0, n) of seg with seg[i] >= g (lanes 0-15) or
// >= g + 1 (lanes 16-31), n if none: a 16-ary search a half-warp. Invariant:
// the answer lies in [lo, hi].
__device__ __forceinline__ int64_t lower_bounds(const int32_t* __restrict__ seg, int64_t n,
                                                int64_t g, int lane) {
  const int half = lane >> 4;
  const int j = lane & 15;
  const int64_t key = g + half;
  int64_t lo = 0, hi = n;
  while (__any_sync(kFull, hi > lo)) {
    const int64_t len = hi - lo;
    const int64_t stride = len > 16 ? (len + 15) / 16 : 1;
    const int64_t p = lo + (j + 1) * stride - 1;  // probe j
    const bool below = len > 0 && p < hi && (int64_t)__ldg(seg + p) < key;
    const unsigned ball = __ballot_sync(kFull, below);
    const int c = __popc((ball >> (16 * half)) & 0xffffu);  // probes below key
    // Probes below key are a prefix: the answer is past probe c - 1 and
    // at or before probe c.
    const int64_t new_lo = lo + (int64_t)c * stride;
    const int64_t probe_c = lo + (int64_t)(c + 1) * stride - 1;
    hi = c < 16 && probe_c < hi ? probe_c : hi;
    lo = new_lo < hi ? new_lo : hi;
  }
  return lo;
}

// Adds rows rid[0..NR) (-1 for none) of `rows` (stride Geometry::W) to
// this lane's columns of acc.
template <int M, typename TIn, typename TC, int D, int NR, typename Acc>
__device__ __forceinline__ void add_rows(Acc (&acc)[Geometry<M, TIn, D>::kElems],
                                         const TIn* __restrict__ rows, const int32_t (&rid)[NR],
                                         int lane) {
  using G = Geometry<M, TIn, D>;
  const int slot = lane / G::P;
  const int col = (lane % G::P) * G::kElems;
  if constexpr (M == kRowwise) {
    const int leader = slot * G::P;
    uint32_t w[NR];
    float sc[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      w[u] = 0u;
      sc[u] = 0.f;
      if (rid[u] >= 0) {
        const int8_t* row = reinterpret_cast<const int8_t*>(rows) + (int64_t)rid[u] * G::W;
        w[u] = __ldg(reinterpret_cast<const uint32_t*>(row + col));
        if (lane == leader) sc[u] = __ldg(reinterpret_cast<const float*>(row + D));
      }
    }
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      const float row_scale = __shfl_sync(kFull, sc[u], leader);
#pragma unroll
      for (int j = 0; j < G::kElems; ++j)
        acc[j] += __fmul_rn(static_cast<float>(byte_at(w[u], j)), row_scale);
    }
  } else {
    uint4 v[NR];
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      v[u] = make_uint4(0u, 0u, 0u, 0u);  // zero bits: +0.0 in f32 and bf16, 0 in int8
      if (rid[u] >= 0)
        v[u] = __ldg(reinterpret_cast<const uint4*>(rows + (int64_t)rid[u] * G::W + col));
    }
#pragma unroll
    for (int u = 0; u < NR; ++u) {
      if constexpr (M == kInt8) {
        const uint32_t w4[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * c + j] += byte_at(w4[c], j);
        }
      } else {
        const TIn* e = reinterpret_cast<const TIn*>(&v[u]);
#pragma unroll
        for (int i = 0; i < G::kElems; ++i) acc[i] += as_compute<TC>(to_float(e[i]));
      }
    }
  }
}

// Entry k (0 <= k < 32 * NI) of a window held one a lane: lane k % 32's
// ids[k / 32]. Every lane takes part.
template <int NI>
__device__ __forceinline__ int32_t id_of(const int32_t (&ids)[NI], int k) {
  int32_t id = __shfl_sync(kFull, ids[0], k & 31);
#pragma unroll
  for (int r = 1; r < NI; ++r) {
    const int32_t other = __shfl_sync(kFull, ids[r], k & 31);
    if ((k >> 5) == r) id = other;
  }
  return id;
}

// Writes this lane's columns of bag's pooled row, finished (per-table int8:
// times the table's scale) and rounded once to TC.
template <int M, typename TIn, typename TC, int D, typename Acc>
__device__ __forceinline__ void store_bag(const Acc (&acc)[Geometry<M, TIn, D>::kElems],
                                          TC* __restrict__ out, const float* __restrict__ scale,
                                          int64_t bag, int T, int col) {
  using G = Geometry<M, TIn, D>;
  float o[G::kElems];
  if constexpr (M == kInt8) {
    const float sc = __ldg(scale + bag % T);
#pragma unroll
    for (int i = 0; i < G::kElems; ++i) o[i] = __fmul_rn(static_cast<float>(acc[i]), sc);
  } else {
#pragma unroll
    for (int i = 0; i < G::kElems; ++i) o[i] = acc[i];
  }
  // kElems * sizeof(TC) is 64, 32, 16 or 8 bytes and col starts a run of
  // that many: whole 16-byte stores, or one 8-byte store.
  __align__(16) TC ov[G::kElems];
#pragma unroll
  for (int i = 0; i < G::kElems; ++i) to_out(o[i], ov + i);
  TC* dst = out + bag * D + col;
  if constexpr (G::kElems * sizeof(TC) >= 16) {
#pragma unroll
    for (int c = 0; c < (int)(G::kElems * sizeof(TC) / 16); ++c)
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(ov)[c];
  } else {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(ov);
  }
}

// UB = 0: a warp a bag (L > 8). UB in {1, 2, 4, 8} (L <= UB): a slot a bag,
// S bags a warp, each slot with all of its bag's rows in flight.
template <int M, typename TIn, typename TC, int D, int UB>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_hotcold_kernel(const TIn* __restrict__ hot, const TIn* __restrict__ table,
                             const float* __restrict__ scale,
                             const int32_t* __restrict__ hot_sel,
                             const uint8_t* __restrict__ hot_mask,
                             const int32_t* __restrict__ cold_ids,
                             const int32_t* __restrict__ cold_seg, int64_t c_pad,
                             TC* __restrict__ out, int64_t n_bags, int T, int L) {
  using G = Geometry<M, TIn, D>;
  using Acc = typename std::conditional<M == kInt8, int, float>::type;
  const int lane = threadIdx.x & 31;
  const int slot = lane / G::P;
  const int col = (lane % G::P) * G::kElems;
  const int64_t warp = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;

  if constexpr (UB == 0) {
    for (int64_t bag = warp; bag < n_bags; bag += warps) {
      Acc acc[G::kElems];
#pragma unroll
      for (int i = 0; i < G::kElems; ++i) acc[i] = 0;
      int32_t rid[G::U];

      // Hot hits: the bag's L slots, CH a step; row u of a slot is the
      // step's entry u * S + slot.
      const int64_t h0 = bag * L;
      for (int c0 = 0; c0 < L; c0 += G::CH) {
        int32_t id = -1;
        if (lane < G::CH && c0 + lane < L && __ldg(hot_mask + h0 + c0 + lane) != 0)
          id = __ldg(hot_sel + h0 + c0 + lane);
#pragma unroll
        for (int u = 0; u < G::U; ++u) rid[u] = __shfl_sync(kFull, id, u * G::S + slot);
        add_rows<M, TIn, TC, D>(acc, hot, rid, lane);
      }

      // Cold lookups: the bag's contiguous range of the sorted stream.
      const int64_t bounds = lower_bounds(cold_seg, c_pad, bag, lane);
      const int64_t lo = __shfl_sync(kFull, bounds, 0);
      const int64_t hi = __shfl_sync(kFull, bounds, 16);
      for (int64_t c0 = lo; c0 < hi; c0 += G::CH) {
        int32_t id = -1;
        if (lane < G::CH && c0 + lane < hi) id = __ldg(cold_ids + c0 + lane);
#pragma unroll
        for (int u = 0; u < G::U; ++u) rid[u] = __shfl_sync(kFull, id, u * G::S + slot);
        add_rows<M, TIn, TC, D>(acc, table, rid, lane);
      }

#pragma unroll
      for (int off = G::P; off < 32; off <<= 1) {
#pragma unroll
        for (int i = 0; i < G::kElems; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
      }
      if (slot == 0) store_bag<M, TIn, TC, D>(acc, out, scale, bag, T, col);
    }
  } else {
    // S bags a task, slot s holding bag bag0 + s. Their hot slots are the
    // task's S * L consecutive entries, and their cold lookups a window of
    // at most S * L entries of the sorted stream from the first bag's lower
    // bound: both loaded coalesced, a window of NI ids a lane.
    constexpr int NW = G::S * UB;
    constexpr int NI = (NW + 31) / 32;
    const int64_t n_tasks = (n_bags + G::S - 1) / G::S;
    for (int64_t task = warp; task < n_tasks; task += warps) {
      const int64_t bag0 = task * G::S;
      const int64_t bag = bag0 + slot;
      Acc acc[G::kElems];
#pragma unroll
      for (int i = 0; i < G::kElems; ++i) acc[i] = 0;
      int32_t ids[NI], rid[UB];

      const int64_t window = (n_bags - bag0 < G::S ? n_bags - bag0 : G::S) * L;
#pragma unroll
      for (int r = 0; r < NI; ++r) {
        const int k = r * 32 + lane;
        const int64_t at = bag0 * L + k;
        ids[r] = k < window && __ldg(hot_mask + at) != 0 ? __ldg(hot_sel + at) : -1;
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int32_t id = id_of<NI>(ids, slot * L + u);
        rid[u] = u < L ? id : -1;
      }
      add_rows<M, TIn, TC, D>(acc, hot, rid, lane);

      const int64_t lo = __shfl_sync(kFull, lower_bounds(cold_seg, c_pad, bag0, lane), 0);
      int32_t offs[NI];  // each window entry's bag within the task; S past it
#pragma unroll
      for (int r = 0; r < NI; ++r) {
        const int64_t at = lo + r * 32 + lane;
        const bool in = r * 32 + lane < NW && at < c_pad;
        const int64_t off = in ? (int64_t)__ldg(cold_seg + at) - bag0 : G::S;
        offs[r] = off < G::S ? (int)off : G::S;
        ids[r] = in ? __ldg(cold_ids + at) : -1;
      }
      // This slot's bag's entries are [first, last) of the window: the
      // entries of the bags before it, and of it.
      int first = 0, last = 0;
#pragma unroll
      for (int b = 1; b <= G::S; ++b) {
        int below = 0;
#pragma unroll
        for (int r = 0; r < NI; ++r) below += __popc(__ballot_sync(kFull, offs[r] < b));
        if (b == slot) first = below;
        if (b == slot + 1) last = below;
      }
#pragma unroll
      for (int u = 0; u < UB; ++u) {
        const int32_t id = id_of<NI>(ids, first + u);
        rid[u] = first + u < last ? id : -1;
      }
      add_rows<M, TIn, TC, D>(acc, table, rid, lane);

      if (bag < n_bags) store_bag<M, TIn, TC, D>(acc, out, scale, bag, T, col);
    }
  }
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
  void* out;
  int64_t n_bags;
  int T, L, grid;
  cudaStream_t stream;
};

template <int M, typename TIn, typename TC, int D, int UB>
int launch(const Args& a) {
  embedding_bag_hotcold_kernel<M, TIn, TC, D, UB><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
      static_cast<const TIn*>(a.hot), static_cast<const TIn*>(a.table), a.scale, a.hot_sel,
      a.hot_mask, a.cold_ids, a.cold_seg, a.c_pad, static_cast<TC*>(a.out), a.n_bags, a.T, a.L);
  return (int)cudaGetLastError();
}

// The plans ops/embedding.py::k6_launch_plan picks: rows_per_slot 0 (a warp
// a bag) for L > 8, else the power of two >= L.
template <int M, typename TIn, typename TC, int D>
int launch_plan(int rows_per_slot, const Args& a) {
  switch (rows_per_slot) {
    case 0: return launch<M, TIn, TC, D, 0>(a);
    case 1: return launch<M, TIn, TC, D, 1>(a);
    case 2: return launch<M, TIn, TC, D, 2>(a);
    case 4: return launch<M, TIn, TC, D, 4>(a);
    case 8: return launch<M, TIn, TC, D, 8>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int M, typename TIn, typename TC>
int launch_width(int d, int rows_per_slot, const Args& a) {
  if (d == 32) return launch_plan<M, TIn, TC, 32>(rows_per_slot, a);
  if (d == 64) return launch_plan<M, TIn, TC, 64>(rows_per_slot, a);
  return (int)cudaErrorInvalidValue;
}

template <int M, typename TIn>
int launch_out(int out_dtype, int d, int rows_per_slot, const Args& a) {
  if (out_dtype == 0) return launch_width<M, TIn, float>(d, rows_per_slot, a);
  if (out_dtype == 1) return launch_width<M, TIn, __nv_bfloat16>(d, rows_per_slot, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// mode: 0 float table (table_dtype 0 = f32, 1 = bf16), 1 per-table int8,
// 2 row-wise int8. out_dtype: 0 = f32, 1 = bf16. (rows_per_slot, grid):
// ops/embedding.py::k6_launch_plan's. Returns the cudaError_t of the launch
// (0 = success). The caller validates shapes, alignment and the cold
// stream's order.
int drs_embedding_bag_hotcold(int mode, int table_dtype, int d, const void* hot,
                              const void* table, const void* scale, const void* hot_sel,
                              const void* hot_mask, const void* cold_ids, const void* cold_seg,
                              int64_t c_pad, void* out, int out_dtype, int64_t n_bags, int T,
                              int L, int rows_per_slot, int grid, void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0 || (rows_per_slot > 0 && L > rows_per_slot)) return (int)cudaErrorInvalidValue;
  const Args a{hot, table, static_cast<const float*>(scale),
               static_cast<const int32_t*>(hot_sel), static_cast<const uint8_t*>(hot_mask),
               static_cast<const int32_t*>(cold_ids), static_cast<const int32_t*>(cold_seg),
               c_pad, out, n_bags, T, L, grid, static_cast<cudaStream_t>(stream)};
  const int u = rows_per_slot;
  if (mode == kFloat && table_dtype == 0) return launch_out<kFloat, float>(out_dtype, d, u, a);
  if (mode == kFloat && table_dtype == 1)
    return launch_out<kFloat, __nv_bfloat16>(out_dtype, d, u, a);
  if (mode == kInt8) return launch_out<kInt8, int8_t>(out_dtype, d, u, a);
  if (mode == kRowwise) return launch_out<kRowwise, int8_t>(out_dtype, d, u, a);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
