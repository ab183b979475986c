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

template <typename TIn, typename TC, int D, int G, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_kernel(const TIn* __restrict__ table,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices,
                     const uint8_t* __restrict__ mask,
                     TC* __restrict__ out,
                     int64_t n_bags, int T, int L) {
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
    const int64_t base = bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0;

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
        if (rid[u] >= 0) v[u] = load_row<(U > 1)>(table + (base + rid[u]) * D + col);
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
      // kElems * sizeof(TC) is 32, 16 or 8 bytes, and col starts a run of
      // that many bytes: whole 16-byte stores, or one 8-byte store.
      __align__(16) TC o[kElems];
#pragma unroll
      for (int i = 0; i < kElems; ++i) to_out(acc[i], o + i);
      TC* dst = out + bag * D + col;
      if constexpr (kElems * sizeof(TC) >= 16) {
#pragma unroll
        for (int c = 0; c < (int)(kElems * sizeof(TC) / 16); ++c)
          reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(o)[c];
      } else {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
      }
    }
  }
}

template <typename TIn, typename TC, int D, int G, int U>
int launch(const void* table, const int32_t* offsets, const int32_t* indices,
           const uint8_t* mask, void* out, int64_t n_bags, int T, int L, int grid,
           cudaStream_t stream) {
  embedding_bag_kernel<TIn, TC, D, G, U><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TIn*>(table), offsets, indices, mask, static_cast<TC*>(out),
      n_bags, T, L);
  return (int)cudaGetLastError();
}

// The (G, U) instances k1_launch_plan picks: one slot a bag (G = S) with
// U in {1, 2, 4, 8} for L <= 8; for longer bags a warp a bag with U = 4.
template <typename TIn, typename TC, int D>
int launch_mapping(int G, int U, const void* table, const int32_t* offsets,
                   const int32_t* indices, const uint8_t* mask, void* out, int64_t n_bags,
                   int T, int L, int grid, cudaStream_t stream) {
  constexpr int S = 32 / (D * (int)sizeof(TIn) / 16);
#define DRS_K1_CASE(g, u)                                                              \
  if (G == (g) && U == (u))                                                            \
    return launch<TIn, TC, D, (g), (u)>(table, offsets, indices, mask, out, n_bags, T, \
                                        L, grid, stream);
  DRS_K1_CASE(S, 1) DRS_K1_CASE(S, 2) DRS_K1_CASE(S, 4) DRS_K1_CASE(S, 8)
  DRS_K1_CASE(1, 4)
#undef DRS_K1_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename TIn, typename TC>
int launch_width(int d, int G, int U, const void* table, const int32_t* offsets,
                 const int32_t* indices, const uint8_t* mask, void* out, int64_t n_bags,
                 int T, int L, int grid, cudaStream_t stream) {
  if (d == 32)
    return launch_mapping<TIn, TC, 32>(G, U, table, offsets, indices, mask, out, n_bags, T, L,
                                       grid, stream);
  if (d == 64)
    return launch_mapping<TIn, TC, 64>(G, U, table, offsets, indices, mask, out, n_bags, T, L,
                                       grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. (bags_per_warp, rows_per_lane,
// grid) is ops/embedding.py::k1_launch_plan's. Returns the cudaError_t of
// the launch (0 = success). The caller validates shapes and alignment.
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

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
