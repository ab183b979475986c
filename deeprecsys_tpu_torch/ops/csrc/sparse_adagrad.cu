// K5: the sparse row-wise AdaGrad step of the embedding table, for Hopper
// (sm_90a).
//
// What it replaces: the sparse half of deeprecsys_tpu/train.py::
// make_sparse_table_step (:258-278), three XLA scatters and a gather:
//
//   flat       = indices + offsets[t]                  (B*T*L touched rows)
//   g_rows     = g_pooled[b, t] broadcast over l, in f32
//   acc[flat] += mean(g_rows^2, axis=-1)               (every add first ...)
//   scale      = rsqrt(acc[flat] + eps)                (... then every read)
//   table[flat] += cast_table(-lr * (g_rows * scale))
//
// Duplicate rows each add their own g^2 and their own update, and every
// accumulator add lands before any scale is read. So the step is two
// launches on one stream (launch 2 starts after launch 1 has ended), never
// one kernel that interleaves them.
//
// Contract:
//   table   (R, D) f32 or bf16, updated in place
//   acc     (R,)   f32, updated in place
//   offsets (T,)   int32; indices (B, T, L) int32 table-local ids
//   g       (B, T, D) f32 or bf16: the gradient of the pooled output
//
// What bounds it: the touched rows. At rm1's training shape (B = 128,
// T = 8, L = 80, D = 32, f32) launch 1 adds 81,920 accumulator floats and
// launch 2 reads 81,920 of them and read-modify-writes 81,920 table rows of
// 128 bytes: ~22 MB, ~7 us at 3.35 TB/s. The design follows K1b's (a warp
// a bag and up to 32 of its slots; one coalesced load of the ids):
//   * launch 1 (accumulate): the warp reduces the bag's mean g^2 by
//     shuffles, once for all its slots; lane j adds it to slot j's row with
//     one atomicAdd, so 32 rows' adds go out at once;
//   * launch 2 (apply): lane j reads slot j's accumulator and forms its
//     scale, 1 / sqrtf(acc + eps) (IEEE sqrt and division); the bag's
//     gradient row sits in registers; for each slot the warp adds the
//     update, cast to the table dtype, with one atomicAdd a lane (a
//     coalesced 128-byte request for an f32 D = 32 row; bf16 rows use the
//     native bf16 atomicAdd of sm_80 and later).
// The order of the atomic adds changes from run to run, so results agree
// with a sequential scatter to within the rounding of the adds to a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void add_to(float* p, float x) { atomicAdd(p, x); }
__device__ __forceinline__ void add_to(__nv_bfloat16* p, float x) {
  atomicAdd(p, __float2bfloat16_rn(x));
}

// The ids of one task (a bag and up to 32 of its slots): lane j holds slot
// l0 + j's fused row, or -1 past L.
__device__ __forceinline__ int64_t task_row(const int32_t* __restrict__ offsets,
                                            const int32_t* __restrict__ indices, int64_t bag,
                                            int l0, int n, int T, int L, int lane) {
  if (lane >= n) return -1;
  return (int64_t)__ldg(offsets + bag % T) + __ldg(indices + bag * L + l0 + lane);
}

template <typename TG, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
accumulate_kernel(const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ indices, float* __restrict__ acc, int64_t n_bags,
                  int T, int L) {
  constexpr int kPerLane = D / 32;
  const int lane = threadIdx.x & 31;
  const int chunks = (L + 31) / 32;
  const int64_t n_tasks = n_bags * chunks;
  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag = task / chunks;
    const int l0 = (int)(task % chunks) * 32;
    const int n = min(32, L - l0);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) {
      const float x = to_float(g[bag * D + i * 32 + lane]);
      sq += x * x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const int64_t row = task_row(offsets, indices, bag, l0, n, T, L, lane);
    if (row >= 0) atomicAdd(acc + row, sq / (float)D);
  }
}

template <typename TT, typename TG, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
apply_kernel(TT* __restrict__ table, const float* __restrict__ acc, const TG* __restrict__ g,
             const int32_t* __restrict__ offsets, const int32_t* __restrict__ indices,
             int64_t n_bags, int T, int L, float neg_lr, float eps) {
  constexpr int kPerLane = D / 32;
  const int lane = threadIdx.x & 31;
  const int chunks = (L + 31) / 32;
  const int64_t n_tasks = n_bags * chunks;
  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag = task / chunks;
    const int l0 = (int)(task % chunks) * 32;
    const int n = min(32, L - l0);
    const int64_t row = task_row(offsets, indices, bag, l0, n, T, L, lane);
    const float scale = row >= 0 ? 1.f / sqrtf(__ldcg(acc + row) + eps) : 0.f;
    float v[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = to_float(g[bag * D + i * 32 + lane]);
    for (int j = 0; j < n; ++j) {
      const int64_t r = __shfl_sync(0xffffffffu, row, j);
      const float s = __shfl_sync(0xffffffffu, scale, j);
      TT* dst = table + r * D + lane;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) add_to(dst + i * 32, neg_lr * (v[i] * s));
    }
  }
}

template <typename TT, typename TG, int D>
int launch(void* table, float* acc, const void* g, const int32_t* offsets,
           const int32_t* indices, int64_t n_bags, int T, int L, float neg_lr, float eps,
           int grid, cudaStream_t stream) {
  accumulate_kernel<TG, D><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TG*>(g), offsets, indices, acc, n_bags, T, L);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  apply_kernel<TT, TG, D><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<TT*>(table), acc, static_cast<const TG*>(g), offsets, indices, n_bags, T, L,
      neg_lr, eps);
  return (int)cudaGetLastError();
}

template <typename TT, typename TG>
int launch_width(int d, void* table, float* acc, const void* g, const int32_t* offsets,
                 const int32_t* indices, int64_t n_bags, int T, int L, float neg_lr, float eps,
                 int grid, cudaStream_t stream) {
  if (d == 32)
    return launch<TT, TG, 32>(table, acc, g, offsets, indices, n_bags, T, L, neg_lr, eps, grid,
                              stream);
  if (d == 64)
    return launch<TT, TG, 64>(table, acc, g, offsets, indices, n_bags, T, L, neg_lr, eps, grid,
                              stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. neg_lr is -learning_rate. grid:
// blocks of kWarpsPerBlock warps for both launches
// (ops/sparse_adagrad.py::K5_WARPS_PER_BLOCK). Returns the first nonzero
// cudaError_t of the two launches (0 = success). The caller validates shapes.
int drs_sparse_adagrad(void* table, int table_dtype, int d, void* acc, const void* g,
                       int g_dtype, const void* offsets, const void* indices, int64_t n_bags,
                       int T, int L, float neg_lr, float eps, int grid, void* stream) {
  if (n_bags <= 0 || L <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  float* a = static_cast<float*>(acc);
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (table_dtype == 0 && g_dtype == 0)
    return launch_width<float, float>(d, table, a, g, off, idx, n_bags, T, L, neg_lr, eps,
                                      grid, s);
  if (table_dtype == 0 && g_dtype == 1)
    return launch_width<float, __nv_bfloat16>(d, table, a, g, off, idx, n_bags, T, L, neg_lr,
                                              eps, grid, s);
  if (table_dtype == 1 && g_dtype == 0)
    return launch_width<__nv_bfloat16, float>(d, table, a, g, off, idx, n_bags, T, L, neg_lr,
                                              eps, grid, s);
  if (table_dtype == 1 && g_dtype == 1)
    return launch_width<__nv_bfloat16, __nv_bfloat16>(d, table, a, g, off, idx, n_bags, T, L,
                                                       neg_lr, eps, grid, s);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
