// K1-int8 and K4: fused multi-table pooled lookups over int8 tables, for
// Hopper (sm_90a).
//
// What they replace: the TPU package's XLA ops for quantized tables.
//   K1-int8: the per-table int8 pool, deeprecsys_tpu/models/base.py:178-182
//     (packed layout :163-171, ops/embedding.py:191-208): an int8 gather,
//     an exact int32 sum over L, a multiply by the table's f32 scale, a
//     cast to the compute dtype.
//   K4: deeprecsys_tpu/ops/embedding.py::embedding_bag_int8_rowwise (:262),
//     with dequant_packed_rows (:251): a gather of (R, d + 4) int8 rows,
//     each value times its row's f32 scale (the row's last 4 bytes), an
//     f32 sum over L, one cast.
//
// Contract (ops/embedding.py checks it):
//   q       (R, D)     int8, row-major, contiguous, 16-byte aligned (K1-int8)
//   scale   (T,)       f32 per-table scales (K1-int8)
//   qrows   (R, D + 4) int8, row-major, contiguous, 4-byte aligned (K4)
//   offsets (T,)       int32 first fused row of each table
//   indices (B, T, L)  int32 table-local ids, 0 <= id < rows[t] (not checked)
//   mask    (B, T, L)  uint8/bool or null: slot contributes iff mask != 0
//   out     (B, T, D)  f32 or bf16
//
// Numerics. K1-int8 sums in int32, which is exact (|sum| <= L * 127), and
// then applies one f32 multiply (__fmul_rn) and one rounding to the output
// dtype: the same bits as the JAX op, in any order of the sum. K4 forms
// each product with __fmul_rn, so nvcc cannot contract it into the
// accumulator's add as an FMA; it then differs from the JAX op only in the
// order of the f32 sum (ops/embedding.py::rowwise_tolerance).
//
// What bounds them: random row reads, as for K1 (embedding_bag.cu): every
// row is a random 32- to 68-byte read with no reuse, and K1 measured a
// ceiling of ~21-24 G random rows/s on an H100 whatever the row's width.
// So the design is K1's: many independent row loads in flight a lane, the
// ids of a step in one coalesced load shared by __shfl_sync (a masked-out
// slot arrives as id -1), accumulators in registers, a bag's slots combined
// with __shfl_xor_sync, a grid-stride loop over warp tasks. The mappings
// (bags a warp G, rows a lane a step U) come from ops/embedding.py:
// k1_launch_plan(..., torch.int8) for K1-int8, k4_launch_plan for K4.
//   * K1-int8: a lane loads 16 int8 values (16 bytes), so a d = 32 row
//     takes 2 lanes and a warp has 16 row slots.
//   * K4: rows start on 4-byte boundaries only ((base + id) * (D + 4)
//     bytes), so a lane loads one 4-byte word: D / 4 lanes a row (8 at
//     D = 32), 4 slots a warp at D = 32. The slot's first lane also loads
//     the row's scale word, and __shfl_sync hands it to the slot's lanes.
//     A 36-byte row spans two 32-byte sectors, a 68-byte one three.
// Addresses are computed in 64 bits: (base + id) * (D + 4) passes 2^31 at
// 59 M rows of D = 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;   // ops/embedding.py::K1_WARPS_PER_BLOCK
constexpr int kMinBlocksPerSm = 4;

__device__ __forceinline__ void to_out(float x, float* p) { *p = x; }
__device__ __forceinline__ void to_out(float x, __nv_bfloat16* p) { *p = __float2bfloat16_rn(x); }

// Byte j of w, sign-extended.
__device__ __forceinline__ int byte_at(uint32_t w, int j) {
  return static_cast<int>(w << (24 - 8 * j)) >> 24;
}

// The ids of step `step0` for the warp's G bags, id -1 where a slot is past
// L, past the last bag, or masked out; id k of the step is (bag0 + k / RPS,
// row step0 + k % RPS), held by lane k % 32 in ids[k / 32].
template <int G, int RPS, int NI>
__device__ __forceinline__ void load_ids(int32_t (&ids)[NI], const int32_t* __restrict__ indices,
                                         const uint8_t* __restrict__ mask, int64_t bag0,
                                         int64_t n_bags, int L, int step0, int lane) {
#pragma unroll
  for (int r = 0; r < NI; ++r) {
    const int k = r * 32 + lane;
    const int64_t kb = bag0 + k / RPS;
    const int l = step0 + k % RPS;
    int32_t id = -1;
    if (k < G * RPS && kb < n_bags && l < L) {
      const int64_t at = kb * L + l;
      id = __ldg(indices + at);
      if (mask != nullptr && __ldg(mask + at) == 0) id = -1;
    }
    ids[r] = id;
  }
}

// Id k of the step, from the lane that loaded it (every lane takes part).
template <int NI>
__device__ __forceinline__ int32_t id_of(const int32_t (&ids)[NI], int k) {
  int32_t id = __shfl_sync(0xffffffffu, ids[0], k & 31);
#pragma unroll
  for (int r = 1; r < NI; ++r) {
    const int32_t other = __shfl_sync(0xffffffffu, ids[r], k & 31);
    if ((k >> 5) == r) id = other;
  }
  return id;
}

// N output values at dst, rounded once to TC: N * sizeof(TC) is 64, 32,
// 16 or 8 bytes, and dst starts a run of that many bytes.
template <typename TC, int N>
__device__ __forceinline__ void store_row(TC* dst, const float (&v)[N]) {
  __align__(16) TC o[N];
#pragma unroll
  for (int i = 0; i < N; ++i) to_out(v[i], o + i);
  if constexpr (N * sizeof(TC) >= 16) {
#pragma unroll
    for (int c = 0; c < (int)(N * sizeof(TC) / 16); ++c)
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(o)[c];
  } else {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
  }
}

// K1-int8.
template <typename TC, int D, int G, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ indices,
                          const uint8_t* __restrict__ mask, TC* __restrict__ out,
                          int64_t n_bags, int T, int L) {
  constexpr int kElems = 16;          // int8 values a lane loads
  constexpr int P = D / kElems;       // lanes covering one row
  constexpr int S = 32 / P;           // row slots a warp
  constexpr int SPB = S / G;          // slots a bag
  constexpr int RPS = SPB * U;        // rows of a bag a step
  constexpr int NI = (G * RPS + 31) / 32;
  static_assert(D % kElems == 0 && 32 % P == 0 && S % G == 0, "unsupported mapping");

  const int lane = threadIdx.x & 31;
  const int group = lane / P;
  const int bi = group / SPB;
  const int s = group % SPB;
  const int col = (lane % P) * kElems;
  const int64_t n_tasks = (n_bags + G - 1) / G;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag0 = task * G;
    const int64_t bag = bag0 + bi;
    const int64_t base = bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0;

    int32_t ids[NI];
    int acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = 0;

    load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, 0, lane);
    for (int step0 = 0; step0 < L; step0 += RPS) {
      int32_t rid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) rid[u] = id_of<NI>(ids, bi * RPS + u * SPB + s);
      uint4 v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (rid[u] >= 0)
          v[u] = __ldg(reinterpret_cast<const uint4*>(q + (base + rid[u]) * D + col));
      }
      if (step0 + RPS < L) load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L,
                                                 step0 + RPS, lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[4 * c + j] += byte_at(w[c], j);
        }
      }
    }

#pragma unroll
    for (int off = P; off < P * SPB; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }

    if (s == 0 && bag < n_bags) {
      const float sc = __ldg(scale + bag % T);
      float o[kElems];
#pragma unroll
      for (int i = 0; i < kElems; ++i) o[i] = __fmul_rn(static_cast<float>(acc[i]), sc);
      store_row<TC, kElems>(out + bag * D + col, o);
    }
  }
}

// K4.
template <typename TC, int D, int G, int U>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_int8_rowwise_kernel(const int8_t* __restrict__ qrows,
                                  const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ indices,
                                  const uint8_t* __restrict__ mask, TC* __restrict__ out,
                                  int64_t n_bags, int T, int L) {
  constexpr int RB = D + 4;           // bytes a row: D values, then the f32 scale
  constexpr int kElems = 4;           // int8 values a lane loads (one word)
  constexpr int P = D / kElems;       // lanes covering one row
  constexpr int S = 32 / P;           // row slots a warp
  constexpr int SPB = S / G;
  constexpr int RPS = SPB * U;
  constexpr int NI = (G * RPS + 31) / 32;
  static_assert(D % kElems == 0 && 32 % P == 0 && S % G == 0, "unsupported mapping");

  const int lane = threadIdx.x & 31;
  const int group = lane / P;
  const int leader = group * P;       // the slot's first lane: it loads the scale
  const int bi = group / SPB;
  const int s = group % SPB;
  const int col = (lane % P) * kElems;
  const int64_t n_tasks = (n_bags + G - 1) / G;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag0 = task * G;
    const int64_t bag = bag0 + bi;
    const int64_t base = bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0;

    int32_t ids[NI];
    float acc[kElems];
#pragma unroll
    for (int i = 0; i < kElems; ++i) acc[i] = 0.f;

    load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, 0, lane);
    for (int step0 = 0; step0 < L; step0 += RPS) {
      int32_t rid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) rid[u] = id_of<NI>(ids, bi * RPS + u * SPB + s);
      uint32_t w[U];
      float sc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        w[u] = 0u;
        sc[u] = 0.f;
        if (rid[u] >= 0) {
          const int8_t* row = qrows + (base + rid[u]) * RB;
          w[u] = __ldg(reinterpret_cast<const uint32_t*>(row + col));
          if (lane == leader) sc[u] = __ldg(reinterpret_cast<const float*>(row + D));
        }
      }
      if (step0 + RPS < L) load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L,
                                                 step0 + RPS, lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float row_scale = __shfl_sync(0xffffffffu, sc[u], leader);
#pragma unroll
        for (int j = 0; j < kElems; ++j)
          acc[j] += __fmul_rn(static_cast<float>(byte_at(w[u], j)), row_scale);
      }
    }

#pragma unroll
    for (int off = P; off < P * SPB; off <<= 1) {
#pragma unroll
      for (int i = 0; i < kElems; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);
    }

    if (s == 0 && bag < n_bags) store_row<TC, kElems>(out + bag * D + col, acc);
  }
}

struct Args {
  const int32_t* offsets;
  const int32_t* indices;
  const uint8_t* mask;
  void* out;
  int64_t n_bags;
  int T, L, grid;
  cudaStream_t stream;
};

template <typename TC, int D, int G, int U>
int launch_int8(const void* q, const void* scale, const Args& a) {
  embedding_bag_int8_kernel<TC, D, G, U><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scale), a.offsets, a.indices,
      a.mask, static_cast<TC*>(a.out), a.n_bags, a.T, a.L);
  return (int)cudaGetLastError();
}

template <typename TC, int D, int G, int U>
int launch_rowwise(const void* qrows, const Args& a) {
  embedding_bag_int8_rowwise_kernel<TC, D, G, U><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
      static_cast<const int8_t*>(qrows), a.offsets, a.indices, a.mask,
      static_cast<TC*>(a.out), a.n_bags, a.T, a.L);
  return (int)cudaGetLastError();
}

// The (G, U) instances k1_launch_plan(..., torch.int8) picks: one slot a bag
// (G = S, S = 16 at D = 32) with U in {1, 2, 4, 8} for L <= 8, else a warp a
// bag with U = 4.
template <typename TC, int D>
int mapping_int8(int G, int U, const void* q, const void* scale, const Args& a) {
  constexpr int S = 32 / (D / 16);
#define DRS_K1I8_CASE(g, u) \
  if (G == (g) && U == (u)) return launch_int8<TC, D, (g), (u)>(q, scale, a);
  DRS_K1I8_CASE(S, 1) DRS_K1I8_CASE(S, 2) DRS_K1I8_CASE(S, 4) DRS_K1I8_CASE(S, 8)
  DRS_K1I8_CASE(1, 4)
#undef DRS_K1I8_CASE
  return (int)cudaErrorInvalidValue;
}

// The (G, U) instances k4_launch_plan picks: G = S (4 at D = 32) with U in
// {1, 2, 4, 8} for L <= 8, else a warp a bag with U = 8.
template <typename TC, int D>
int mapping_rowwise(int G, int U, const void* qrows, const Args& a) {
  constexpr int S = 32 / (D / 4);
#define DRS_K4_CASE(g, u) \
  if (G == (g) && U == (u)) return launch_rowwise<TC, D, (g), (u)>(qrows, a);
  DRS_K4_CASE(S, 1) DRS_K4_CASE(S, 2) DRS_K4_CASE(S, 4) DRS_K4_CASE(S, 8)
  DRS_K4_CASE(1, 8)
#undef DRS_K4_CASE
  return (int)cudaErrorInvalidValue;
}

template <typename TC>
int width_int8(int d, int G, int U, const void* q, const void* scale, const Args& a) {
  if (d == 32) return mapping_int8<TC, 32>(G, U, q, scale, a);
  if (d == 64) return mapping_int8<TC, 64>(G, U, q, scale, a);
  return (int)cudaErrorInvalidValue;
}

template <typename TC>
int width_rowwise(int d, int G, int U, const void* qrows, const Args& a) {
  if (d == 32) return mapping_rowwise<TC, 32>(G, U, qrows, a);
  if (d == 64) return mapping_rowwise<TC, 64>(G, U, qrows, a);
  return (int)cudaErrorInvalidValue;
}

Args make_args(const void* offsets, const void* indices, const void* mask, void* out,
               int64_t n_bags, int T, int L, int grid, void* stream) {
  return Args{static_cast<const int32_t*>(offsets), static_cast<const int32_t*>(indices),
              static_cast<const uint8_t*>(mask), out, n_bags, T, L, grid,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// out_dtype: 0 = float32, 1 = bfloat16. (bags_per_warp, rows_per_lane,
// grid) is ops/embedding.py::k1_launch_plan(..., torch.int8)'s. Returns the
// cudaError_t of the launch (0 = success). The caller validates shapes and
// alignment.
int drs_embedding_bag_int8(const void* q, const void* scale, int d, const void* offsets,
                           const void* indices, const void* mask, void* out, int out_dtype,
                           int64_t n_bags, int T, int L, int bags_per_warp, int rows_per_lane,
                           int grid, void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(offsets, indices, mask, out, n_bags, T, L, grid, stream);
  if (out_dtype == 0) return width_int8<float>(d, bags_per_warp, rows_per_lane, q, scale, a);
  if (out_dtype == 1)
    return width_int8<__nv_bfloat16>(d, bags_per_warp, rows_per_lane, q, scale, a);
  return (int)cudaErrorInvalidValue;
}

// As above for K4 over (R, d + 4) rows; the plan is k4_launch_plan's.
int drs_embedding_bag_int8_rowwise(const void* qrows, int d, const void* offsets,
                                   const void* indices, const void* mask, void* out,
                                   int out_dtype, int64_t n_bags, int T, int L,
                                   int bags_per_warp, int rows_per_lane, int grid,
                                   void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(offsets, indices, mask, out, n_bags, T, L, grid, stream);
  if (out_dtype == 0) return width_rowwise<float>(d, bags_per_warp, rows_per_lane, qrows, a);
  if (out_dtype == 1)
    return width_rowwise<__nv_bfloat16>(d, bags_per_warp, rows_per_lane, qrows, a);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
