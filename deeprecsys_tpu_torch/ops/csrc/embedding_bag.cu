// K1: fused multi-table pooled embedding lookup for Hopper (sm_90a).
//
// What it replaces: the TPU package's fused gather + sum over the pooling
// axis, deeprecsys_tpu/ops/embedding.py::embedding_bag (:770-800, the XLA
// gather at :794), which earlier hand-written Pallas kernels also computed
// (ops/pallas/embedding_kernel.py::pallas_embedding_bag and
// ::pallas_embedding_bag_coalesced, removed in commit 5ad96f1).
//
// Contract (same as the JAX op):
//   table   (R, D)    bf16 or f32, row-major, contiguous, 16-byte aligned
//   offsets (T,)      int32 first fused row of each table
//   indices (B, T, L) int32 table-local ids, 0 <= id < rows[t] (not checked)
//   mask    (B, T, L) uint8/bool or null: slot contributes iff mask != 0
//   out     (B, T, D) in the compute dtype: each row is converted to the
//           compute dtype, the L rows are summed in f32, and the sum is
//           rounded once.
//
// What bounds it: random row reads. Every row is a random 64- or 128-byte
// read with no reuse. The byte bound (3.35 TB/s) is not the ceiling: on an
// H100 the kernel reaches ~21-24 G random rows/s whether a row is 64 or
// 128 bytes (PERF.md, kernel_bench.py), so rm1's 64-byte rows stop near
// half the byte bound. The kernel keeps enough independent row loads in
// flight to reach that rate, and wastes no lane doing it:
//   * A lane loads 16 bytes of a row; P = D * sizeof(TIn) / 16 lanes cover
//     a row, so a warp has S = 32 / P row slots (8 for bf16 D = 32).
//   * A warp pools G bags at once, SPB = S / G slots a bag, and each slot
//     issues U independent row loads a step (rows step0 + u*SPB + s). The
//     caller picks (G, U) from L (ops/embedding.py::k1_launch_plan): at
//     L <= 8 one slot a bag (G = S) and U >= L, so every lane has every
//     row of its bag in flight at once; at larger L a warp a bag and U = 4.
//   * The ids of a step (G * SPB * U of them, bags contiguous in memory)
//     come in one coalesced load, a masked-out slot already folded in as
//     id -1, and reach their slots by __shfl_sync; the next step's ids are
//     loaded before this step's rows are summed.
//   * f32 accumulators stay in registers; a bag's slots are combined with
//     __shfl_xor_sync, and one slot writes the row with 16-byte stores.
//   * __launch_bounds__ keeps kMinBlocksPerSm blocks an SM resident (64
//     registers a thread); a grid-stride loop over warp tasks takes any
//     grid, and the caller's covers every task once (capping it at the
//     resident blocks measured no faster).
// Addresses are computed in 64 bits: tables of more than 2^31 bytes are
// normal (din's fused table has 46 M rows).
//
// The ownership window (kWindow, drs_embedding_bag_window): the lookup of
// one row shard of a table split over a mesh's "model" axis, the TPU
// package's shard_local_indices and masked gather
// (deeprecsys_tpu/parallel/sharding.py:102-130). `table` is the shard,
// rows [row_lo, row_lo + n_rows) of the fused table; a slot whose fused row
// offsets[t] + id falls outside them adds nothing, and one inside reads
// table[offsets[t] + id - row_lo]. The test sits where the row is loaded,
// on the bag's base already moved by row_lo: no pass over the ids, no
// extra load. The shard's pool leaves in f32 (TO = float), each row
// converted to the compute dtype and summed as above but not rounded: the
// caller sums the shards' partials and rounds once. The direct path
// (kWindow false) is compiled without the test.
//
// Widths. The mapping above runs at every row of 16 * 2^k bytes up to a
// warp's 512 (bf16 D 8 to 256, f32 D 4 to 128), each width its own
// instance; D = 32 and 64 keep the instances (and code) they had. Any other
// width takes the general instance (embedding_bag_general_kernel): the
// width a runtime argument, a warp a bag, a lane an element of the row (a
// chunk of 32 * kGeneralCols columns at a time), the bag's 32-id chunks in
// one coalesced load each, the rows walked in order; correct, not tuned.
//
// The window's long walks (bags the direct mapping takes more than
// K1W_DIRECT_STEPS steps over) take the compacted gather
// (embedding_bag_compact_kernel; ops/embedding.py::k1_window_plan): on an
// M-way shard only about 1/M of a bag's slots own their row, so the direct
// mapping's steps keep about 1/M of its rows in flight. Instead a warp
// reads up to kCompactIds of its bag's ids at once (4 coalesced loads a
// lane), takes a __ballot_sync of which rows the shard owns, and packs the
// owned ids into its own kCompactIds ints of shared memory at the rank
// __popc of the ballot below the lane gives; then its S slots gather only
// the packed rows, U a slot a step with the 16-byte lanes and the load
// hint, so every row load the warp issues is one that adds. Measured on an
// H100 (kernel_bench --only k1w_sweep, PERF.md): at rm2's shards (7.5 steps
// a bag) U = 8 ran 24% (1/4 shard) and 6% (1/2) under the direct window;
// at rm1's (2.5 steps) no design moved the time (6.2-6.5 us), which the
// ids' pass, the launch and the random-row rate hold, so rm1 keeps the
// direct mapping.
//
// Where a lane has several rows in flight (U > 1), rows load with
// ld.global.nc.L1::no_allocate.L2::64B: no L1 line for a row that is never
// read again, and no L2 prefetch past 64 bytes (a bf16 d = 32 row is 64
// bytes). Measured on an H100 (PERF.md): din 16.4 us with it vs 19.6
// without, rm1 -4%, rm2 -3%; at U = 1 (one row a lane, L = 1) it measured
// 0.1-0.7 us slower, so those load with plain __ldg.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;   // ops/embedding.py::K1_WARPS_PER_BLOCK
constexpr int kMinBlocksPerSm = 4;  // ops/embedding.py::K1_BLOCKS_PER_SM

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// Value of x after conversion to the compute dtype TC, widened to f32.
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

template <bool kHint>
__device__ __forceinline__ uint4 load_row(const void* p) {
  if constexpr (kHint) {
    uint4 v;
    asm volatile("ld.global.nc.L1::no_allocate.L2::64B.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(p));
    return v;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename TIn, typename TC, int D, int G, int U, typename TO = TC, bool kWindow = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_kernel(const TIn* __restrict__ table,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices,
                     const uint8_t* __restrict__ mask,
                     TO* __restrict__ out,
                     int64_t n_bags, int T, int L, int64_t row_lo = 0, int64_t n_rows = 0) {
  constexpr int kElems = 16 / sizeof(TIn);  // elements a lane loads
  constexpr int P = D / kElems;             // lanes covering one row
  constexpr int S = 32 / P;                 // row slots a warp
  constexpr int SPB = S / G;                // slots a bag
  constexpr int RPS = SPB * U;              // rows of a bag a step
  constexpr int IDS = G * RPS;              // ids a warp reads a step
  constexpr int NI = (IDS + 31) / 32;       // id registers a lane
  static_assert(D % kElems == 0 && 32 % P == 0 && S % G == 0, "unsupported mapping");

  const int lane = threadIdx.x & 31;
  const int group = lane / P;
  const int bi = group / SPB;  // this slot's bag within the warp's G
  const int s = group % SPB;   // this slot within its bag
  const int col = (lane % P) * kElems;
  const int64_t n_tasks = (n_bags + G - 1) / G;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag0 = task * G;
    const int64_t bag = bag0 + bi;
    const int64_t base =
        (bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0) - (kWindow ? row_lo : 0);

    // The ids of step `step0` for all G bags, id -1 where a slot is past
    // L, past the last bag, or masked out; id k of the step is
    // (bag0 + k / RPS, row step0 + k % RPS), held by lane k % 32 in ids[k / 32].
    int32_t ids[NI];
    auto load_ids = [&](int step0) {
#pragma unroll
      for (int r = 0; r < NI; ++r) {
        const int k = r * 32 + lane;
        const int64_t kb = bag0 + k / RPS;
        const int l = step0 + k % RPS;
        int32_t id = -1;
        if (k < IDS && kb < n_bags && l < L) {
          const int64_t at = kb * L + l;
          id = __ldg(indices + at);
          if (mask != nullptr && __ldg(mask + at) == 0) id = -1;
        }
        ids[r] = id;
      }
    };

    float acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = 0.f;

    load_ids(0);
    for (int step0 = 0; step0 < L; step0 += RPS) {
      int32_t rid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = bi * RPS + u * SPB + s;
        int32_t id = __shfl_sync(0xffffffffu, ids[0], k & 31);
#pragma unroll
        for (int r = 1; r < NI; ++r) {
          const int32_t other = __shfl_sync(0xffffffffu, ids[r], k & 31);
          if ((k >> 5) == r) id = other;
        }
        rid[u] = id;
      }
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = make_uint4(0u, 0u, 0u, 0u);  // zero bits: +0.0 in f32 and bf16
        const int64_t row = base + rid[u];
        // In the window iff 0 <= row < n_rows (one unsigned compare).
        if (rid[u] >= 0 && (!kWindow || (uint64_t)row < (uint64_t)n_rows))
          v[u] = load_row<(U > 1)>(table + row * D + col);
      }
      if (step0 + RPS < L) load_ids(step0 + RPS);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const TIn* e = reinterpret_cast<const TIn*>(&v[u]);
#pragma unroll
        for (int i = 0; i < kElems; ++i) acc[i] += as_compute<TC>(to_float(e[i]));
      }
    }

#pragma unroll
    for (int off = P; off < P * SPB; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }

    if (s == 0 && bag < n_bags) {
      // kElems * sizeof(TO) is 32, 16 or 8 bytes, and col starts a run of
      // that many bytes: whole 16-byte stores, or one 8-byte store.
      __align__(16) TO o[kElems];
#pragma unroll
      for (int i = 0; i < kElems; ++i) to_out(acc[i], o + i);
      TO* dst = out + bag * D + col;
      if constexpr (kElems * sizeof(TO) >= 16) {
#pragma unroll
        for (int c = 0; c < (int)(kElems * sizeof(TO) / 16); ++c)
          reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(o)[c];
      } else {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
      }
    }
  }
}

// The general instance: any width d, a warp a bag, lane c of the warp the
// columns c, c + 32, ... of a chunk of 32 * kGeneralCols, summed in f32 in
// the bag's slot order; with kWindow the window's test at each row.
constexpr int kGeneralCols = 4;

template <typename TIn, typename TC, typename TO, bool kWindow>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_general_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ indices,
                             const uint8_t* __restrict__ mask, TO* __restrict__ out, int d,
                             int64_t n_bags, int T, int L, int64_t row_lo, int64_t n_rows) {
  const int lane = threadIdx.x & 31;
  for (int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); bag < n_bags;
       bag += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t base = (int64_t)__ldg(offsets + bag % T) - (kWindow ? row_lo : 0);
    for (int c0 = 0; c0 < d; c0 += 32 * kGeneralCols) {
      float acc[kGeneralCols];
#pragma unroll
      for (int k = 0; k < kGeneralCols; ++k) acc[k] = 0.f;
      for (int l0 = 0; l0 < L; l0 += 32) {
        int32_t id = -1;
        if (l0 + lane < L) {
          const int64_t at = bag * L + l0 + lane;
          id = __ldg(indices + at);
          if (mask != nullptr && __ldg(mask + at) == 0) id = -1;
        }
        const int n = min(32, L - l0);
        for (int j = 0; j < n; ++j) {
          const int32_t r = __shfl_sync(0xffffffffu, id, j);  // the same in every lane
          if (r < 0) continue;
          const int64_t row = base + r;
          if (kWindow && (uint64_t)row >= (uint64_t)n_rows) continue;
          const TIn* p = table + row * d;
#pragma unroll
          for (int k = 0; k < kGeneralCols; ++k) {
            const int c = c0 + lane + 32 * k;
            if (c < d) acc[k] += as_compute<TC>(to_float(__ldg(p + c)));
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kGeneralCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < d) to_out(acc[k], out + bag * d + c);
      }
    }
  }
}

// The window's compacted gather (long bags): a warp a bag; each window of
// kCompactIds of the bag's slots is read at once, the ids whose rows the
// shard owns packed into the warp's shared ints by a ballot and a prefix
// count, then gathered by the S slots of P lanes, U rows a slot a step.
// The partial leaves in f32, not rounded.
constexpr int kCompactIds = 128;

template <typename TIn, typename TC, int D, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_compact_kernel(const TIn* __restrict__ table, const int32_t* __restrict__ offsets,
                             const int32_t* __restrict__ indices,
                             const uint8_t* __restrict__ mask, float* __restrict__ out,
                             int64_t n_bags, int T, int L, int64_t row_lo, int64_t n_rows) {
  constexpr int kElems = 16 / sizeof(TIn);  // elements a lane loads
  constexpr int P = D / kElems;             // lanes covering one row
  constexpr int S = 32 / P;                 // row slots a warp
  constexpr int RPS = S * U;                // packed rows a step
  constexpr int NI = kCompactIds / 32;      // ids a lane a window
  static_assert(D % kElems == 0 && 32 % P == 0, "unsupported mapping");
  __shared__ int32_t packed[kWarpsPerBlock][kCompactIds];

  const int lane = threadIdx.x & 31;
  const int s = lane / P;
  const int col = (lane % P) * kElems;
  const unsigned below = (1u << lane) - 1u;
  int32_t* own = packed[threadIdx.x >> 5];

  for (int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); bag < n_bags;
       bag += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t base = (int64_t)__ldg(offsets + bag % T) - row_lo;
    float acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = 0.f;

    for (int w0 = 0; w0 < L; w0 += kCompactIds) {
      int32_t ids[NI];
#pragma unroll
      for (int r = 0; r < NI; ++r) {
        const int l = w0 + r * 32 + lane;
        int32_t id = -1;
        if (l < L) {
          const int64_t at = bag * L + l;
          id = __ldg(indices + at);
          if (mask != nullptr && __ldg(mask + at) == 0) id = -1;
        }
        ids[r] = id;
      }
      int n = 0;  // owned ids packed so far, the same in every lane
#pragma unroll
      for (int r = 0; r < NI; ++r) {
        const bool owned = ids[r] >= 0 && (uint64_t)(base + ids[r]) < (uint64_t)n_rows;
        const unsigned ballot = __ballot_sync(0xffffffffu, owned);
        if (owned) own[n + __popc(ballot & below)] = ids[r];
        n += __popc(ballot);
      }
      __syncwarp();
      for (int k0 = 0; k0 < n; k0 += RPS) {
        uint4 v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int k = k0 + u * S + s;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (k < n) v[u] = load_row<true>(table + (base + own[k]) * D + col);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const TIn* e = reinterpret_cast<const TIn*>(&v[u]);
#pragma unroll
          for (int i = 0; i < kElems; ++i) acc[i] += as_compute<TC>(to_float(e[i]));
        }
      }
      __syncwarp();  // every lane has read the packed ids before the next window's
    }

#pragma unroll
    for (int off = P; off < 32; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }
    if (s == 0) {
      float* dst = out + bag * D + col;
#pragma unroll
      for (int c = 0; c < kElems / 4; ++c)
        reinterpret_cast<float4*>(dst)[c] =
            make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2], acc[4 * c + 3]);
    }
  }
}

template <typename TIn, typename TC, int D, int G, int U, typename TO, bool kWindow>
int launch(const void* table, const int32_t* offsets, const int32_t* indices,
           const uint8_t* mask, void* out, int64_t n_bags, int T, int L, int grid,
           cudaStream_t stream, int64_t row_lo, int64_t n_rows) {
  embedding_bag_kernel<TIn, TC, D, G, U, TO, kWindow><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TIn*>(table), offsets, indices, mask, static_cast<TO*>(out),
      n_bags, T, L, row_lo, n_rows);
  return (int)cudaGetLastError();
}

// The (G, U) instances k1_launch_plan picks: one slot a bag (G = S) with
// U in {1, 2, 4, 8} for L <= 8; for longer bags a warp a bag with U = 4.
template <typename TIn, typename TC, int D, typename TO, bool kWindow>
int launch_mapping(int G, int U, const void* table, const int32_t* offsets,
                   const int32_t* indices, const uint8_t* mask, void* out, int64_t n_bags,
                   int T, int L, int grid, cudaStream_t stream, int64_t row_lo, int64_t n_rows) {
  constexpr int S = 32 / (D * (int)sizeof(TIn) / 16);
#define DRS_K1_CASE(g, u)                                                                   \
  if (G == (g) && U == (u))                                                                 \
    return launch<TIn, TC, D, (g), (u), TO, kWindow>(table, offsets, indices, mask, out,    \
                                                     n_bags, T, L, grid, stream, row_lo,    \
                                                     n_rows);
  DRS_K1_CASE(S, 1) DRS_K1_CASE(S, 2) DRS_K1_CASE(S, 4) DRS_K1_CASE(S, 8)
  DRS_K1_CASE(1, 4)
#undef DRS_K1_CASE
  return (int)cudaErrorInvalidValue;
}

// The rows per slot a step of the compacted gather that k1_window_plan
// picks (ops/embedding.py::K1W_ROWS_PER_SLOT).
constexpr int kCompactU = 8;

template <typename TIn, typename TC, int D>
int launch_compact(int U, const void* table, const int32_t* offsets, const int32_t* indices,
                   const uint8_t* mask, void* out, int64_t n_bags, int T, int L, int grid,
                   cudaStream_t stream, int64_t row_lo, int64_t n_rows) {
  if (U != kCompactU) return (int)cudaErrorInvalidValue;
  embedding_bag_compact_kernel<TIn, TC, D, kCompactU><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TIn*>(table), offsets, indices, mask, static_cast<float*>(out), n_bags,
      T, L, row_lo, n_rows);
  return (int)cudaGetLastError();
}

template <typename TIn, typename TC, typename TO, bool kWindow>
int launch_general(int d, const void* table, const int32_t* offsets, const int32_t* indices,
                   const uint8_t* mask, void* out, int64_t n_bags, int T, int L, int grid,
                   cudaStream_t stream, int64_t row_lo, int64_t n_rows) {
  embedding_bag_general_kernel<TIn, TC, TO, kWindow><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TIn*>(table), offsets, indices, mask, static_cast<TO*>(out), d, n_bags,
      T, L, row_lo, n_rows);
  return (int)cudaGetLastError();
}

// G = 0: the general instance at any d. Else the 16-byte-lane mapping
// (G, U) at a row of 16 * 2^k bytes up to 512, each width its instance;
// compact: the window's compacted gather (kWindow only).
template <typename TIn, typename TC, typename TO = TC, bool kWindow = false>
int launch_width(int d, int G, int U, const void* table, const int32_t* offsets,
                 const int32_t* indices, const uint8_t* mask, void* out, int64_t n_bags,
                 int T, int L, int grid, cudaStream_t stream, int64_t row_lo = 0,
                 int64_t n_rows = 0, bool compact = false) {
  if (G == 0)
    return launch_general<TIn, TC, TO, kWindow>(d, table, offsets, indices, mask, out, n_bags,
                                                T, L, grid, stream, row_lo, n_rows);
  constexpr int E = 16 / (int)sizeof(TIn);  // elements of 16 bytes
#define DRS_K1_WIDTH(w)                                                                      \
  if (d == (w)) {                                                                            \
    if constexpr (kWindow) {                                                                 \
      if (compact)                                                                           \
        return launch_compact<TIn, TC, (w)>(U, table, offsets, indices, mask, out, n_bags, T, \
                                            L, grid, stream, row_lo, n_rows);                \
    }                                                                                        \
    return launch_mapping<TIn, TC, (w), TO, kWindow>(G, U, table, offsets, indices, mask,    \
                                                     out, n_bags, T, L, grid, stream,        \
                                                     row_lo, n_rows);                        \
  }
  DRS_K1_WIDTH(E) DRS_K1_WIDTH(2 * E) DRS_K1_WIDTH(4 * E) DRS_K1_WIDTH(8 * E)
  DRS_K1_WIDTH(16 * E) DRS_K1_WIDTH(32 * E)
#undef DRS_K1_WIDTH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. (bags_per_warp, rows_per_lane,
// grid) is ops/embedding.py::k1_launch_plan's (bags_per_warp 0: the general
// instance). Returns the cudaError_t of the launch (0 = success). The
// caller validates shapes and alignment.
int drs_embedding_bag(const void* table, int table_dtype, int d,
                      const void* offsets, const void* indices, const void* mask,
                      void* out, int out_dtype, int64_t n_bags, int T, int L,
                      int bags_per_warp, int rows_per_lane, int grid, void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  const uint8_t* msk = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = bags_per_warp, U = rows_per_lane;
  if (table_dtype == 1 && out_dtype == 1)
    return launch_width<__nv_bfloat16, __nv_bfloat16>(d, G, U, table, off, idx, msk, out,
                                                      n_bags, T, L, grid, s);
  if (table_dtype == 1 && out_dtype == 0)
    return launch_width<__nv_bfloat16, float>(d, G, U, table, off, idx, msk, out, n_bags, T,
                                              L, grid, s);
  if (table_dtype == 0 && out_dtype == 0)
    return launch_width<float, float>(d, G, U, table, off, idx, msk, out, n_bags, T, L, grid,
                                      s);
  if (table_dtype == 0 && out_dtype == 1)
    return launch_width<float, __nv_bfloat16>(d, G, U, table, off, idx, msk, out, n_bags, T,
                                              L, grid, s);
  return (int)cudaErrorInvalidValue;
}

// The lookup of one row shard (kWindow): `table` holds fused rows
// [row_lo, row_lo + n_rows); out is the f32 partial (B, T, d), each row
// converted to the compute dtype (compute_dtype: 0 = f32, 1 = bf16) and
// summed in f32, not rounded. A bf16 row is already a bf16 value, so a
// bf16 table takes the f32 instance: the same sums. The plan is
// ops/embedding.py::k1_window_plan's (compact: the compacted gather).
int drs_embedding_bag_window(const void* table, int table_dtype, int d, const void* offsets,
                             const void* indices, const void* mask, void* out,
                             int compute_dtype, int64_t row_lo, int64_t n_rows,
                             int64_t n_bags, int T, int L, int bags_per_warp,
                             int rows_per_lane, int grid, int compact, void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0 || row_lo < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  const uint8_t* msk = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = bags_per_warp, U = rows_per_lane;
  const bool c = compact != 0;
  if (table_dtype == 1 && (compute_dtype == 0 || compute_dtype == 1))
    return launch_width<__nv_bfloat16, float, float, true>(d, G, U, table, off, idx, msk, out,
                                                           n_bags, T, L, grid, s, row_lo, n_rows,
                                                           c);
  if (table_dtype == 0 && compute_dtype == 0)
    return launch_width<float, float, float, true>(d, G, U, table, off, idx, msk, out, n_bags, T,
                                                   L, grid, s, row_lo, n_rows, c);
  if (table_dtype == 0 && compute_dtype == 1)
    return launch_width<float, __nv_bfloat16, float, true>(d, G, U, table, off, idx, msk, out,
                                                           n_bags, T, L, grid, s, row_lo, n_rows,
                                                           c);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
