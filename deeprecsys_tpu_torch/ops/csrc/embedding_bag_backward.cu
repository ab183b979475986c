// K1b: the backward of the fused pooled lookup (K1) with respect to the
// table, for Hopper (sm_90a).
//
// What it replaces: the VJP of deeprecsys_tpu/ops/embedding.py::
// embedding_bag (:770-800) that XLA derives under jax.value_and_grad in the
// dense trainer (deeprecsys_tpu/train.py:357-361): the transpose of the
// gather, a scatter-add of each bag's pooled-output gradient into every row
// the bag read.
//
// Contract:
//   g       (B, T, D) f32 or bf16: the gradient of the pooled output
//   offsets (T,)      int32 first fused row of each table
//   indices (B, T, L) int32 table-local ids (range not checked, as in K1)
//   mask    (B, T, L) uint8/bool or null: a slot contributes iff mask != 0
//   grad    (R, D)    f32, accumulated into: grad[offsets[t] + id] += g[b, t]
//           for every live slot (b, t, l). The caller zero-fills it (and
//           casts it to a bf16 table's dtype afterwards).
//
// What bounds it: the read-modify-write of every touched row. At rm1's
// training shape (B = 128, T = 8, L = 80, D = 32, f32) that is 81,920 rows
// of 128 bytes, ~21 MB of traffic, ~6 us at 3.35 TB/s. Rows repeat within a
// batch, so the adds are atomic, and their order (hence the f32 rounding)
// changes from run to run. The design issues the adds as fast as the
// memory system takes them:
//   * a warp owns one bag and up to 32 of its slots (a task): one
//     coalesced load brings the 32 ids (a masked-out slot folded in as
//     id -1), and the bag's gradient row sits in registers, D / 32 values a
//     lane, read once for all its slots;
//   * for each live slot the warp adds the row with one atomicAdd a lane
//     (the result is unused, so it compiles to a fire-and-forget RED): a
//     128-byte f32 row is one coalesced request of 32 lanes;
//   * a grid-stride loop over tasks; B * T * ceil(L / 32) tasks (3,072 at
//     rm1's shape) keep every SM busy.
// Addresses are computed in 64 bits (fused tables pass 2^31 bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TG, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_backward_kernel(const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                              const int32_t* __restrict__ indices,
                              const uint8_t* __restrict__ mask, float* __restrict__ grad,
                              int64_t n_bags, int T, int L) {
  constexpr int kPerLane = D / 32;
  static_assert(D % 32 == 0, "D must be a multiple of 32");
  const int lane = threadIdx.x & 31;
  const int chunks = (L + 31) / 32;
  const int64_t n_tasks = n_bags * chunks;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag = task / chunks;
    const int l0 = (int)(task % chunks) * 32;
    const int n = min(32, L - l0);
    const int64_t slot0 = bag * L + l0;
    int32_t id = -1;
    if (lane < n) {
      id = __ldg(indices + slot0 + lane);
      if (mask != nullptr && __ldg(mask + slot0 + lane) == 0) id = -1;
    }
    const int64_t base = (int64_t)__ldg(offsets + bag % T);
    float v[kPerLane];
#pragma unroll
    for (int i = 0; i < kPerLane; ++i) v[i] = to_float(g[bag * D + i * 32 + lane]);
    for (int j = 0; j < n; ++j) {
      const int32_t r = __shfl_sync(0xffffffffu, id, j);
      if (r < 0) continue;
      float* dst = grad + (base + r) * D + lane;
#pragma unroll
      for (int i = 0; i < kPerLane; ++i) atomicAdd(dst + i * 32, v[i]);
    }
  }
}

template <typename TG, int D>
int launch(const void* g, const int32_t* offsets, const int32_t* indices, const uint8_t* mask,
           float* grad, int64_t n_bags, int T, int L, int grid, cudaStream_t stream) {
  embedding_bag_backward_kernel<TG, D><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const TG*>(g), offsets, indices, mask, grad, n_bags, T, L);
  return (int)cudaGetLastError();
}

template <typename TG>
int launch_width(int d, const void* g, const int32_t* offsets, const int32_t* indices,
                 const uint8_t* mask, float* grad, int64_t n_bags, int T, int L, int grid,
                 cudaStream_t stream) {
  if (d == 32) return launch<TG, 32>(g, offsets, indices, mask, grad, n_bags, T, L, grid, stream);
  if (d == 64) return launch<TG, 64>(g, offsets, indices, mask, grad, n_bags, T, L, grid, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// g dtype code: 0 = float32, 1 = bfloat16. grid: blocks of kWarpsPerBlock
// warps (ops/embedding.py::K1B_WARPS_PER_BLOCK). Returns the cudaError_t of
// the launch (0 = success). The caller validates shapes and devices.
int drs_embedding_bag_backward(const void* g, int g_dtype, int d, const void* offsets,
                               const void* indices, const void* mask, void* grad,
                               int64_t n_bags, int T, int L, int grid, void* stream) {
  if (n_bags <= 0 || L <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  const int32_t* off = static_cast<const int32_t*>(offsets);
  const int32_t* idx = static_cast<const int32_t*>(indices);
  const uint8_t* msk = static_cast<const uint8_t*>(mask);
  float* out = static_cast<float*>(grad);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (g_dtype == 0)
    return launch_width<float>(d, g, off, idx, msk, out, n_bags, T, L, grid, s);
  if (g_dtype == 1)
    return launch_width<__nv_bfloat16>(d, g, off, idx, msk, out, n_bags, T, L, grid, s);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
