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
// What bounds it: HBM bytes. rm1 (B=512, T=8, L=80, D=32 bf16) reads
// 327,680 random 64-byte rows, ~21 MB a batch, from a 2.05 GB table: about
// 6 us at the published 3.35 TB/s of an H100 SXM at its 700 W limit. There
// is no reuse to exploit for uniform ids, so the design aims only at
// keeping many independent row loads in flight:
//   * one warp per bag (b, t); each lane loads 16 bytes of a row, so a warp
//     reads 32*16/(D*sizeof) rows per step (8 rows for bf16 D=32), fully
//     using each 32-byte sector it touches;
//   * the loop over L is unrolled so each lane has several loads in flight;
//   * f32 accumulators stay in registers and row groups are combined with
//     __shfl_xor_sync at the end: no shared memory, no atomics, one write.
// Measured at rm1's shape on an H100 80GB HBM3 at 700 W: 15-16 us of device
// time, 42% of that peak (PERF.md), so it is latency-bound, not yet
// bandwidth-bound.
// Addresses are computed in 64 bits: tables of more than 2^31 bytes are
// normal (din's fused table has 46 M rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename TIn, typename TC, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_kernel(const TIn* __restrict__ table,
                     const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices,
                     const uint8_t* __restrict__ mask,
                     TC* __restrict__ out,
                     int64_t n_bags, int T, int L) {
  constexpr int kElems = 16 / sizeof(TIn);          // elements a lane loads
  constexpr int kLanesPerRow = D / kElems;          // lanes covering one row
  constexpr int kRowsPerStep = 32 / kLanesPerRow;   // rows a warp reads at once
  static_assert(D % kElems == 0 && 32 % kLanesPerRow == 0, "unsupported width");

  const int lane = threadIdx.x & 31;
  const int64_t bag = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (bag >= n_bags) return;  // the whole warp leaves together

  const int group = lane / kLanesPerRow;
  const int col = (lane % kLanesPerRow) * kElems;
  const int64_t base = offsets[bag % T];
  const int32_t* ids = indices + bag * L;
  const uint8_t* m = mask ? mask + bag * L : nullptr;

  float acc[kElems];
#pragma unroll
  for (int i = 0; i < kElems; ++i) acc[i] = 0.f;

#pragma unroll 4
  for (int l = group; l < L; l += kRowsPerStep) {
    if (m != nullptr && m[l] == 0) continue;
    const int64_t row = base + (int64_t)__ldg(ids + l);
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(table + row * D + col));
    const TIn* e = reinterpret_cast<const TIn*>(&v);
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] += as_compute<TC>(to_float(e[i]));
  }

#pragma unroll
  for (int off = kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
  }

  if (group == 0) {
    TC* o = out + bag * D + col;
#pragma unroll
    for (int i = 0; i < kElems; ++i) store(o + i, acc[i]);
  }
}

template <typename TIn, typename TC, int D>
void launch(const void* table, const int32_t* offsets, const int32_t* indices,
            const uint8_t* mask, void* out, int64_t n_bags, int T, int L,
            cudaStream_t stream) {
  const int64_t blocks = (n_bags + kWarpsPerBlock - 1) / kWarpsPerBlock;
  embedding_bag_kernel<TIn, TC, D><<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TIn*>(table), offsets, indices, mask, static_cast<TC*>(out),
      n_bags, T, L);
}

template <typename TIn, typename TC>
int launch_width(int d, const void* table, const int32_t* offsets, const int32_t* indices,
                 const uint8_t* mask, void* out, int64_t n_bags, int T, int L,
                 cudaStream_t stream) {
  if (d == 32) {
    launch<TIn, TC, 32>(table, offsets, indices, mask, out, n_bags, T, L, stream);
  } else if (d == 64) {
    launch<TIn, TC, 64>(table, offsets, indices, mask, out, n_bags, T, L, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 = success). The caller validates shapes and alignment.
int drs_embedding_bag(const void* table, int table_dtype, int d,
                      const void* offsets, const void* indices, const void* mask,
                      void* out, int out_dtype, int64_t n_bags, int T, int L,
                      void* stream) {
  if (n_bags <= 0) return 0;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  const uint8_t* msk = static_cast<const uint8_t*>(mask);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 1 && out_dtype == 1)
    return launch_width<__nv_bfloat16, __nv_bfloat16>(d, table, off, idx, msk, out, n_bags, T, L, s);
  if (table_dtype == 1 && out_dtype == 0)
    return launch_width<__nv_bfloat16, float>(d, table, off, idx, msk, out, n_bags, T, L, s);
  if (table_dtype == 0 && out_dtype == 0)
    return launch_width<float, float>(d, table, off, idx, msk, out, n_bags, T, L, s);
  if (table_dtype == 0 && out_dtype == 1)
    return launch_width<float, __nv_bfloat16>(d, table, off, idx, msk, out, n_bags, T, L, s);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
