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
//
// The ownership window (drs_embedding_bag_backward_window): the gradient
// of one row shard of the fused table, rows [row_lo, row_lo + n_rows),
// which replaces the VJP of the shard's masked gather + pool
// (deeprecsys_tpu/parallel/sharding.py:102-130) under the dense mesh step's
// jax.value_and_grad. A slot adds into grad[offsets[t] + id - row_lo] iff
// that row lies in the shard. A shard is a contiguous range of fused rows,
// so the tables that meet it are a contiguous range [t_lo, t_lo + nt)
// known on the host (window_tables.cuh): the window's kernel
// (embedding_bag_backward_window_kernel) maps its tasks onto the bags of
// those tables only, B * nt * ceil(L / 32) of them (768 at rm1's 1/4 shard
// against the direct mapping's 3,072), so a bag of a table the shard does
// not hold reads no id and no gradient row. A slot of a table wholly inside
// the shard adds with no window test; only the range's first and last
// tables, where they straddle a shard edge, test each slot's row. An owned
// row is added with Hopper's vector reductions (red.global.add.v4.f32,
// kRedFloats f32 a lane): at D = 32, 8 lanes add a 128-byte row, so one
// warp instruction adds 4 slots' rows where 32 scalar reductions added one.
// Each element's add stays atomic, so repeated rows add as before. The
// direct kernel is untouched by any of this.
//
// Widths. The mappings above are built at D = 32, 64, 128 and 256, each
// width its instance; any other width takes the general instances
// (embedding_bag_backward_general_kernel, and its window form over the
// meeting tables): the width a runtime argument, lane c the columns c,
// c + 32, ... of a chunk of 32 * kGeneralCols, scalar atomic adds into the
// same f32 gradient; correct, not tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "window_tables.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
// f32 elements a lane adds with one reduction in the window's kernel
// (red.global.add.v4.f32; experiments/k1bw_sweep.py builds 1 and 2).
constexpr int kRedFloats = 4;

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

// E f32 at p added atomically, element by element, in one reduction
// (E = 4 and 2: 16- and 8-byte aligned p; vector reductions need sm_90).
template <int E>
__device__ __forceinline__ void red_add(float* p, const float* v) {
  if constexpr (E == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(v[0]), "f"(v[1]),
                 "f"(v[2]), "f"(v[3])
                 : "memory");
  } else if constexpr (E == 2) {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(v[0]), "f"(v[1])
                 : "memory");
  } else {
    static_assert(E == 1, "a reduction adds 1, 2 or 4 f32");
    atomicAdd(p, v[0]);
  }
}

// The slots [0, n) of a task whose ids lane j holds (id -1: adds nothing),
// kRows rows at once: lane group `sub` adds the row of slot j0 + sub, its
// CPL chunks of E f32 at dst's chunk offsets. kTest: the table straddles a
// shard edge, so each row is tested against the window first.
template <bool kTest, int D, int E, int LPR, int CPL>
__device__ __forceinline__ void add_slots(float* __restrict__ grad, int32_t id, int n,
                                          int64_t base, const Window& w, int sub, int col,
                                          const float (&v)[CPL][E]) {
  constexpr int kRows = 32 / LPR;
  for (int j0 = 0; j0 < n; j0 += kRows) {
    const int32_t r = __shfl_sync(0xffffffffu, id, j0 + sub);
    if (r < 0) continue;
    if constexpr (kTest) {
      if (!in_window(base, r, w)) continue;
    }
    float* dst = grad + (base + r) * D + col;
#pragma unroll
    for (int c = 0; c < CPL; ++c) red_add<E>(dst + c * LPR * E, v[c]);
  }
}

// The window's kernel: a task is a bag of a meeting table and up to 32 of
// its slots (bag window_bag(k)); LPR lanes add a row, E f32 a reduction.
template <typename TG, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_backward_window_kernel(const TG* __restrict__ g,
                                     const int32_t* __restrict__ offsets,
                                     const int32_t* __restrict__ indices,
                                     const uint8_t* __restrict__ mask, float* __restrict__ grad,
                                     int64_t B, int T, int L, Window w) {
  constexpr int E = kRedFloats;
  constexpr int LPR = D / E < 32 ? D / E : 32;  // lanes a row
  constexpr int CPL = D / E / LPR;              // chunks of E f32 a lane
  static_assert(D % (E * LPR) == 0 && 32 % LPR == 0, "unsupported width");
  const int lane = threadIdx.x & 31;
  const int sub = lane / LPR;
  const int col = (lane % LPR) * E;
  const int chunks = (L + 31) / 32;
  const int64_t n_tasks = B * w.nt * chunks;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t k = task / chunks;
    const int l0 = (int)(task % chunks) * 32;
    const int n = min(32, L - l0);
    const int t = w.t_lo + (int)(k % w.nt);
    const int64_t bag = window_bag(k, T, w);
    const int64_t slot0 = bag * L + l0;
    int32_t id = -1;
    if (lane < n) {
      id = __ldg(indices + slot0 + lane);
      if (mask != nullptr && __ldg(mask + slot0 + lane) == 0) id = -1;
    }
    const int64_t base = (int64_t)__ldg(offsets + t) - w.row_lo;
    float v[CPL][E];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[c][e] = to_float(g[bag * D + c * LPR * E + col + e]);
    }
    if (window_tested(t, w)) {
      add_slots<true, D, E, LPR, CPL>(grad, id, n, base, w, sub, col, v);
    } else {
      add_slots<false, D, E, LPR, CPL>(grad, id, n, base, w, sub, col, v);
    }
  }
}

constexpr int kGeneralCols = 4;

// The general instance's task at any width: bag `bag` of table t and its
// slots [l0, l0 + n), into grad rows base + id, each row tested against the
// window first where `tested`.
template <typename TG>
__device__ __forceinline__ void general_task(const TG* __restrict__ g,
                                             const int32_t* __restrict__ indices,
                                             const uint8_t* __restrict__ mask,
                                             float* __restrict__ grad, int d, int L, int64_t bag,
                                             int l0, int64_t base, bool tested, const Window& w) {
  const int lane = threadIdx.x & 31;
  const int n = min(32, L - l0);
  const int64_t slot0 = bag * L + l0;
  int32_t id = -1;
  if (lane < n) {
    id = __ldg(indices + slot0 + lane);
    if (mask != nullptr && __ldg(mask + slot0 + lane) == 0) id = -1;
  }
  for (int c0 = 0; c0 < d; c0 += 32 * kGeneralCols) {
    float v[kGeneralCols];
#pragma unroll
    for (int k = 0; k < kGeneralCols; ++k) {
      const int c = c0 + lane + 32 * k;
      v[k] = c < d ? to_float(g[bag * d + c]) : 0.f;
    }
    for (int j = 0; j < n; ++j) {
      const int32_t r = __shfl_sync(0xffffffffu, id, j);  // the same in every lane
      if (r < 0 || (tested && !in_window(base, r, w))) continue;
      float* dst = grad + (base + r) * d;
#pragma unroll
      for (int k = 0; k < kGeneralCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < d) atomicAdd(dst + c, v[k]);
      }
    }
  }
}

template <typename TG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_backward_general_kernel(const TG* __restrict__ g,
                                      const int32_t* __restrict__ offsets,
                                      const int32_t* __restrict__ indices,
                                      const uint8_t* __restrict__ mask, float* __restrict__ grad,
                                      int d, int64_t n_bags, int T, int L) {
  const int chunks = (L + 31) / 32;
  const int64_t n_tasks = n_bags * chunks;
  const Window none{};
  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag = task / chunks;
    general_task(g, indices, mask, grad, d, L, bag, (int)(task % chunks) * 32,
                 (int64_t)__ldg(offsets + bag % T), false, none);
  }
}

// The general instance over the window's meeting tables.
template <typename TG>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_backward_general_window_kernel(const TG* __restrict__ g,
                                             const int32_t* __restrict__ offsets,
                                             const int32_t* __restrict__ indices,
                                             const uint8_t* __restrict__ mask,
                                             float* __restrict__ grad, int d, int64_t B, int T,
                                             int L, Window w) {
  const int chunks = (L + 31) / 32;
  const int64_t n_tasks = B * w.nt * chunks;
  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t k = task / chunks;
    const int t = w.t_lo + (int)(k % w.nt);
    general_task(g, indices, mask, grad, d, L, window_bag(k, T, w), (int)(task % chunks) * 32,
                 (int64_t)__ldg(offsets + t) - w.row_lo, window_tested(t, w), w);
  }
}

struct Args {
  const void* g;
  const int32_t* offsets;
  const int32_t* indices;
  const uint8_t* mask;
  float* grad;
  int64_t n;  // bags (direct) or batch rows B (window)
  int T, L, grid;
  cudaStream_t stream;
};

template <typename TG, int D>
void launch_width(const Args& a, const Window* w) {
  const TG* g = static_cast<const TG*>(a.g);
  if (w == nullptr) {
    embedding_bag_backward_kernel<TG, D><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
        g, a.offsets, a.indices, a.mask, a.grad, a.n, a.T, a.L);
  } else {
    embedding_bag_backward_window_kernel<TG, D><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
        g, a.offsets, a.indices, a.mask, a.grad, a.n, a.T, a.L, *w);
  }
}

template <typename TG>
int launch_dtype(int d, const Args& a, const Window* w) {
  switch (d) {
    case 32: launch_width<TG, 32>(a, w); break;
    case 64: launch_width<TG, 64>(a, w); break;
    case 128: launch_width<TG, 128>(a, w); break;
    case 256: launch_width<TG, 256>(a, w); break;
    default: {
      const TG* g = static_cast<const TG*>(a.g);
      if (w == nullptr) {
        embedding_bag_backward_general_kernel<TG><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
            g, a.offsets, a.indices, a.mask, a.grad, d, a.n, a.T, a.L);
      } else {
        embedding_bag_backward_general_window_kernel<TG>
            <<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(g, a.offsets, a.indices, a.mask,
                                                           a.grad, d, a.n, a.T, a.L, *w);
      }
    }
  }
  return (int)cudaGetLastError();
}

int launch(const void* g, int g_dtype, int d, const void* offsets, const void* indices,
           const void* mask, void* grad, int64_t n, int T, int L, int grid, void* stream,
           const Window* w) {
  if (n <= 0 || L <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  const Args a{g,    static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(indices),
               static_cast<const uint8_t*>(mask), static_cast<float*>(grad), n, T, L, grid,
               static_cast<cudaStream_t>(stream)};
  if (g_dtype == 0) return launch_dtype<float>(d, a, w);
  if (g_dtype == 1) return launch_dtype<__nv_bfloat16>(d, a, w);
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
  return launch(g, g_dtype, d, offsets, indices, mask, grad, n_bags, T, L, grid, stream,
                nullptr);
}

// The gradient of one row shard: grad is the shard's (n_rows, D) f32
// gradient, rows [row_lo, row_lo + n_rows) of the fused table (16-byte
// aligned at D = 32, 64, 128, 256); tables [t_lo, t_lo + nt) meet it
// (ops/embedding.py::table_range), test_lo / test_hi where the first / last
// of them straddles a shard edge. A slot whose fused row lies outside adds
// nothing; the bags of the other tables are not read.
int drs_embedding_bag_backward_window(const void* g, int g_dtype, int d, const void* offsets,
                                      const void* indices, const void* mask, void* grad,
                                      int64_t row_lo, int64_t n_rows, int t_lo, int nt,
                                      int test_lo, int test_hi, int64_t B, int T, int L,
                                      int grid, void* stream) {
  if (row_lo < 0 || n_rows < 0 || t_lo < 0 || nt < 0 || t_lo + nt > T)
    return (int)cudaErrorInvalidValue;
  if (nt == 0) return 0;
  const Window w{row_lo, n_rows, t_lo, nt, test_lo, test_hi};
  return launch(g, g_dtype, d, offsets, indices, mask, grad, B, T, L, grid, stream, &w);
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
