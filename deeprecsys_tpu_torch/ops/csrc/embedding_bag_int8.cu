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
// Numerics. K1-int8 sums in int32, which is exact (|sum| <= L * 128), and
// then applies one f32 multiply (__fmul_rn) and one rounding to the output
// dtype: the same bits as the JAX op, in any order of the sum. K4 forms
// each product with __fmul_rn of the exact value and the row's scale, so
// nvcc cannot contract it into the accumulator's add as an FMA; it then
// differs from the JAX op only in the order of the f32 sum
// (ops/embedding.py::rowwise_tolerance).
//
// What bounds them: random row reads, as for K1 (embedding_bag.cu), at
// ~24 G rows/s from DRAM on an H100; rows that sit in the L2 come faster.
// The frame is K1's: many independent row loads in flight a lane, the ids
// of a step in one coalesced load shared by __shfl_sync (a masked-out slot
// arrives as id -1), accumulators in registers, a grid-stride loop over
// warp tasks. LPR lanes cover a row, so a warp has S = 32 / LPR row slots;
// it pools G bags at once, SPB = S / G slots a bag, U rows a slot a step.
// The mappings (LPR, G, U, load hint) come from ops/embedding.py:
// k1_launch_plan(..., torch.int8) for K1-int8, k4_launch_plan for K4, each
// chosen by measurement at the zoo's shapes on uniform and zipf(1.2) ids
// (experiments/int8_sweep.py, PERF.md). Lanes of more than 16 values of a
// row ran out of registers (64 a thread at 4 blocks an SM) before they
// kept enough rows in flight. load16's hint pays only where a slot owns
// its bag and loads two rows a step: at din it saves 3 us of 19-23 on
// uniform ids, while on long bags it costs 25-60% on zipf(1.2) ids, whose
// head rows the L1 holds. A bag's slots are combined by a
// reduce-scatter (reduce_scatter, pooled_rows.cuh): each of log2(SPB) exchanges halves
// the columns a lane holds, so a lane of CPL columns spends CPL - CPL / SPB
// shuffles instead of CPL * log2(SPB), and every lane stores its share.
//
// K1-int8: a lane loads 16 bytes of a row and adds each byte, sign-
// extended, into an int32 of its column. (Offset-binary sums, two bytes a
// 32-bit add in 16-bit halves flushed every 257 rows, measured slower on an
// H100 at every zoo shape: a lane adds 5 to 15 rows of a bag there, too few
// to repay unpacking 16 halves and correcting the offset; PERF.md.)
//
// K4: rows are (D + 4) bytes, 36 or 68, and start on 4-byte boundaries
// only ((base + id) * (D + 4) bytes). Lane r owns words c0 = r * NW ..
// c0 + NW - 1 of a row (NW = D / LPR / 4) and loads the 16-byte-aligned
// chunks that hold them at any of the four phases (addr & 15) / 4, from the
// row's address rounded down to 16 plus the chunk of word c0. Every such
// chunk holds a byte of the row, so it never crosses into a page the table
// does not own; the bytes outside the row are never used. The lane's words
// start e = phase + c0 % 4 words into its window and are picked as whole
// 32-bit words (selects by 4, 2 and 1 words), so no byte shuffles are
// needed; the row's last lane finds the scale word right after its values
// and one __shfl_sync hands it to the row's other lanes. A value is made
// exact in f32 without a conversion instruction: its offset-binary byte
// (x ^ 0x80) under the exponent of 2^23, minus 2^23 + 128.
// On uniform ids K4 stays above K1-int8 because of the layout it keeps: a
// 36-byte row crosses a 64-byte boundary of the table for half of the
// rows, and such rows cost two DRAM accesses. Measured on an H100 (PERF.md,
// experiments/int8_sweep.py --probe): rm1's ids moved onto rows inside one
// 64-byte block run K4 as fast as K1-int8; onto rows that cross, 37% slower.
//
// Addresses are computed in 64 bits: (base + id) * (D + 4) passes 2^31 at
// 59 M rows of D = 32.
//
// The ownership window (kWindow; drs_embedding_bag_int8_window and
// drs_embedding_bag_int8_rowwise_window): the lookup of one row shard of a
// table split over a mesh's "model" axis, as K1's (embedding_bag.cu). The
// shard holds fused rows [row_lo, row_lo + n_rows); a slot whose fused row
// falls outside adds nothing, one inside reads shard row offsets[t] + id -
// row_lo, tested where the row is loaded. The partial leaves in the type
// the kernel sums in: K1-int8 the exact int32 pool before the scale
// (TC = int32_t), so that the shards' partials add exactly and the scale
// and rounding come once, after the combine, as the TPU package's psum of
// int32 partials does; K4 the f32 sum before the cast (TC = float).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pooled_rows.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;   // ops/embedding.py::K1_WARPS_PER_BLOCK
constexpr int kMinBlocksPerSm = 4;

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

// Whether the slot of id `id` reads a row: not masked out (id >= 0) and,
// with the window, its row base + id inside the shard's [0, n_rows).
template <bool kWindow>
__device__ __forceinline__ bool owned(int32_t id, int64_t base, int64_t n_rows) {
  if constexpr (kWindow) {
    return id >= 0 && (uint64_t)(base + id) < (uint64_t)n_rows;
  } else {
    return id >= 0;
  }
}

// K1-int8.
template <typename TC, int D, int LPR, int G, int U, bool H, bool kWindow = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ indices,
                          const uint8_t* __restrict__ mask, TC* __restrict__ out,
                          int64_t n_bags, int T, int L, int64_t row_lo, int64_t n_rows) {
  constexpr int CPL = D / LPR;        // int8 values (bytes) a lane a row
  constexpr int NV = CPL / 16;        // its 16-byte loads
  constexpr int S = 32 / LPR;         // row slots a warp
  constexpr int SPB = S / G;          // slots a bag
  constexpr int RPS = SPB * U;        // rows of a bag a step
  constexpr int NI = (G * RPS + 31) / 32;
  static_assert(CPL % 16 == 0 && 32 % LPR == 0 && S % G == 0 && CPL % SPB == 0,
                "unsupported mapping");

  const int lane = threadIdx.x & 31;
  const int group = lane / LPR;
  const int bi = group / SPB;
  const int s = group % SPB;
  const int col = (lane % LPR) * CPL;
  const int64_t n_tasks = (n_bags + G - 1) / G;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag0 = task * G;
    const int64_t bag = bag0 + bi;
    const int64_t base =
        (bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0) - (kWindow ? row_lo : 0);

    int32_t ids[NI];
    int acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0;

    load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, 0, lane);
    for (int step0 = 0; step0 < L; step0 += RPS) {
      int32_t rid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) rid[u] = id_of<NI>(ids, bi * RPS + u * SPB + s);
      uint4 v[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < NV; ++c) v[u][c] = make_uint4(0u, 0u, 0u, 0u);
        if (owned<kWindow>(rid[u], base, n_rows)) {
          const int8_t* row = q + (base + rid[u]) * D + col;
#pragma unroll
          for (int c = 0; c < NV; ++c) v[u][c] = load16<H>(row + 16 * c);
        }
      }
      if (step0 + RPS < L) load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L,
                                                 step0 + RPS, lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const uint32_t x[4] = {v[u][c].x, v[u][c].y, v[u][c].z, v[u][c].w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[16 * c + 4 * j + b] += byte_at(x[j], b);
          }
        }
      }
    }

    reduce_scatter<LPR, LPR * SPB, CPL / 2>(acc, lane);
    if (bag < n_bags) {
      constexpr int M = CPL / SPB;
      TC* dst = out + bag * D + col + slot_share<CPL, SPB>(s);
      if constexpr (kWindow) {
        int o[M];  // the exact int32 pool: the scale comes after the combine
#pragma unroll
        for (int i = 0; i < M; ++i) o[i] = acc[i];
        store_row<TC>(dst, o);
      } else {
        const float sc = __ldg(scale + bag % T);
        float o[M];
#pragma unroll
        for (int i = 0; i < M; ++i) o[i] = __fmul_rn(static_cast<float>(acc[i]), sc);
        store_row<TC>(dst, o);
      }
    }
  }
}

// K4.
template <typename TC, int D, int LPR, int G, int U, bool H, bool kWindow = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_int8_rowwise_kernel(const int8_t* __restrict__ qrows,
                                  const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ indices,
                                  const uint8_t* __restrict__ mask, TC* __restrict__ out,
                                  int64_t n_bags, int T, int L, int64_t row_lo, int64_t n_rows) {
  constexpr int RB = D + 4;           // bytes a row: D values, then the f32 scale
  constexpr int CPL = D / LPR;        // values a lane
  constexpr int NW = CPL / 4;         // their words, from word c0 = r * NW of the row
  constexpr int NC = RowChunks<NW>::NC;  // the chunks that hold them at any phase
  constexpr int S = 32 / LPR;
  constexpr int SPB = S / G;
  constexpr int RPS = SPB * U;
  constexpr int NI = (G * RPS + 31) / 32;
  static_assert(CPL % 4 == 0 && 32 % LPR == 0 && S % G == 0 && CPL % SPB == 0,
                "unsupported mapping");

  const int lane = threadIdx.x & 31;
  const int group = lane / LPR;
  const int bi = group / SPB;
  const int s = group % SPB;
  const int r = lane % LPR;
  const int c0 = r * NW;
  const int last = lane | (LPR - 1);  // the row's last lane: its window holds the scale
  const int64_t n_tasks = (n_bags + G - 1) / G;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_tasks; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    const int64_t bag0 = task * G;
    const int64_t bag = bag0 + bi;
    const int64_t base =
        (bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0) - (kWindow ? row_lo : 0);

    int32_t ids[NI];
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.f;

    load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, 0, lane);
    for (int step0 = 0; step0 < L; step0 += RPS) {
      int32_t rid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) rid[u] = id_of<NI>(ids, bi * RPS + u * SPB + s);
      // The lane's window: NC aligned chunks from the row's address rounded
      // down to 16, plus its chunk offset; zeros (values 0, scale 0) where
      // the slot adds nothing.
      uint4 win[U][NC];
      uint32_t e[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < NC; ++c) win[u][c] = make_uint4(0u, 0u, 0u, 0u);
        e[u] = 0u;
        if (owned<kWindow>(rid[u], base, n_rows)) {
          const uint4* chunk = row_window(
              reinterpret_cast<uintptr_t>(qrows) + (base + rid[u]) * RB, c0, e[u]);
#pragma unroll
          for (int c = 0; c < NC; ++c) win[u][c] = load16<H>(chunk + c);
        }
      }
      if (step0 + RPS < L) load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L,
                                                 step0 + RPS, lane);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        uint32_t x[NW + 1];
        pick_words<NW>(win[u], e[u], x);
        float row_scale = __uint_as_float(x[NW]);
        if constexpr (LPR > 1) row_scale = __shfl_sync(0xffffffffu, row_scale, last);
        add_scaled<NW>(acc, x, row_scale);
      }
    }

    reduce_scatter<LPR, LPR * SPB, CPL / 2>(acc, lane);
    if (bag < n_bags) {
      constexpr int M = CPL / SPB;
      float o[M];
#pragma unroll
      for (int i = 0; i < M; ++i) o[i] = acc[i];
      store_row<TC>(out + bag * D + r * CPL + slot_share<CPL, SPB>(s), o);
    }
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
  int64_t row_lo = 0, n_rows = 0;  // the window (kWindow instances only)
};

template <typename TC, int D, int LPR, int G, int U, bool H, bool kWindow = false>
int launch_int8(const void* q, const void* scale, const Args& a) {
  embedding_bag_int8_kernel<TC, D, LPR, G, U, H, kWindow>
      <<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(scale), a.offsets,
          a.indices, a.mask, static_cast<TC*>(a.out), a.n_bags, a.T, a.L, a.row_lo, a.n_rows);
  return (int)cudaGetLastError();
}

template <typename TC, int D, int LPR, int G, int U, bool H, bool kWindow = false>
int launch_rowwise(const void* qrows, const Args& a) {
  embedding_bag_int8_rowwise_kernel<TC, D, LPR, G, U, H, kWindow>
      <<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
          static_cast<const int8_t*>(qrows), a.offsets, a.indices, a.mask,
          static_cast<TC*>(a.out), a.n_bags, a.T, a.L, a.row_lo, a.n_rows);
  return (int)cudaGetLastError();
}

// The instances k1_launch_plan(..., torch.int8) picks: a lane 16 bytes of a
// row (LPR = D / 16: S = 16 slots at D = 32, 8 at D = 64); one slot a bag
// (G = S) with U 1, or 2 and load16's hint, for L <= 8; else a warp a bag with
// U = 2 at D = 32, 4 bags a warp with U = 4 at D = 64.
template <typename TC, int D, bool kWindow = false>
int mapping_int8(int G, int U, const void* q, const void* scale, const Args& a) {
  constexpr int LPR = D / 16;
  constexpr int S = 32 / LPR;
  constexpr int GL = D == 32 ? 1 : 4;
  constexpr int UL = D == 32 ? 2 : 4;
  if (G == S && U == 1) return launch_int8<TC, D, LPR, S, 1, false, kWindow>(q, scale, a);
  if (G == S && U == 2) return launch_int8<TC, D, LPR, S, 2, true, kWindow>(q, scale, a);
  if (G == GL && U == UL) return launch_int8<TC, D, LPR, GL, UL, false, kWindow>(q, scale, a);
  return (int)cudaErrorInvalidValue;
}

// The instances k4_launch_plan picks: for L <= 1 a slot a bag of 8 values a
// lane (LPR = D / 8), one row; for 2 <= L <= 8 a slot a bag of 16 values a
// lane (LPR = D / 16), two rows a step with the hint; else 16 values a lane
// with a warp a bag and U = 2 at D = 32, 4 bags a warp and U = 3 at D = 64.
template <typename TC, int D, bool kWindow = false>
int mapping_rowwise(int G, int U, const void* qrows, const Args& a) {
  constexpr int S8 = 256 / D;   // slots a warp at 8 values a lane
  constexpr int S16 = 512 / D;  // at 16
  constexpr int GL = D == 32 ? 1 : 4;
  constexpr int UL = D == 32 ? 2 : 3;
  if (G == S8 && U == 1) return launch_rowwise<TC, D, D / 8, S8, 1, false, kWindow>(qrows, a);
  if (G == S16 && U == 2) return launch_rowwise<TC, D, D / 16, S16, 2, true, kWindow>(qrows, a);
  if (G == GL && U == UL) return launch_rowwise<TC, D, D / 16, GL, UL, false, kWindow>(qrows, a);
  return (int)cudaErrorInvalidValue;
}

template <typename TC, bool kWindow = false>
int width_int8(int d, int G, int U, const void* q, const void* scale, const Args& a) {
  if (d == 32) return mapping_int8<TC, 32, kWindow>(G, U, q, scale, a);
  if (d == 64) return mapping_int8<TC, 64, kWindow>(G, U, q, scale, a);
  return (int)cudaErrorInvalidValue;
}

template <typename TC, bool kWindow = false>
int width_rowwise(int d, int G, int U, const void* qrows, const Args& a) {
  if (d == 32) return mapping_rowwise<TC, 32, kWindow>(G, U, qrows, a);
  if (d == 64) return mapping_rowwise<TC, 64, kWindow>(G, U, qrows, a);
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

// The lookup of one row shard (the window): q holds fused rows [row_lo,
// row_lo + n_rows); out is the (B, T, d) int32 pool before the scale.
int drs_embedding_bag_int8_window(const void* q, int d, const void* offsets,
                                  const void* indices, const void* mask, void* out,
                                  int64_t row_lo, int64_t n_rows, int64_t n_bags, int T, int L,
                                  int bags_per_warp, int rows_per_lane, int grid, void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0 || row_lo < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  Args a = make_args(offsets, indices, mask, out, n_bags, T, L, grid, stream);
  a.row_lo = row_lo;
  a.n_rows = n_rows;
  return width_int8<int32_t, true>(d, bags_per_warp, rows_per_lane, q, nullptr, a);
}

// As above for K4: out is the (B, T, d) f32 sum before the cast.
int drs_embedding_bag_int8_rowwise_window(const void* qrows, int d, const void* offsets,
                                          const void* indices, const void* mask, void* out,
                                          int64_t row_lo, int64_t n_rows, int64_t n_bags, int T,
                                          int L, int bags_per_warp, int rows_per_lane, int grid,
                                          void* stream) {
  if (n_bags <= 0) return 0;
  if (grid <= 0 || row_lo < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  Args a = make_args(offsets, indices, mask, out, n_bags, T, L, grid, stream);
  a.row_lo = row_lo;
  a.n_rows = n_rows;
  return width_rowwise<float, true>(d, bags_per_warp, rows_per_lane, qrows, a);
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
