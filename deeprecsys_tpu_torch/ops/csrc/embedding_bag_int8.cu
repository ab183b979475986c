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
// row_lo. The partial leaves in the type the kernel sums in: K1-int8 the
// exact int32 pool before the scale (TC = int32_t), so that the shards'
// partials add exactly and the scale and rounding come once, after the
// combine, as the TPU package's psum of int32 partials does; K4 the f32 sum
// before the cast (TC = float).
// Both windows map their warps onto the bags of the tables that meet the
// shard only (window_tables.cuh): the G-bag groups are formed over those
// bags, so a group never mixes an owned table with a foreign one, and a
// bag of a table wholly inside the shard reads its rows with no window
// test (only the range's first and last tables, where they straddle a
// shard edge, test each slot). The partial keeps its (B, T, D) shape,
// since the shards' partials are added whole: the same launch writes the
// other tables' bags as zeros, kZeroBags bags a warp in 16-byte stores,
// after the groups' tasks, without reading an id or a row. At rm1's 1/4
// shard that spares three quarters of the batch's 1.31 MB of ids.
//
// Widths. The mappings above are built for D = 32 and 64. Any other width
// takes the general instances (embedding_bag_int8_general_kernel and
// embedding_bag_rowwise_general_kernel): the width a runtime argument, a
// warp a bag, lane c the columns c, c + 32, ... of a chunk of
// 32 * kGeneralCols, one byte a load, the bag's slots in order, the same
// numerics (K1-int8 exact in int32, then one __fmul_rn by the table's
// scale; K4 each value times its row's scale, read byte by byte since a
// row of D + 4 bytes need not start on a 4-byte boundary, summed in f32)
// and the same window; correct, not tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "pooled_rows.cuh"
#include "window_tables.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;   // ops/embedding.py::K1_WARPS_PER_BLOCK
constexpr int kMinBlocksPerSm = 4;
// Foreign bags a warp of K1-int8's and K4's windows zeroes
// (ops/embedding.py::K4W_ZERO_BAGS): of 2, 8, 32 and 128, 32 measured
// fastest for K4 (experiments/k4w_sweep.py, PERF.md).
constexpr int kZeroBags = 32;

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

// load_ids over the window's meeting bags: at[r] is the first slot
// (bag * L) of the batch bag that id register r's lane serves, -1 where that
// is past the group's bags (window_slots).
template <int RPS, int NI>
__device__ __forceinline__ void load_window_ids(int32_t (&ids)[NI], const int64_t (&at)[NI],
                                                const int32_t* __restrict__ indices,
                                                const uint8_t* __restrict__ mask, int L,
                                                int step0, int lane) {
#pragma unroll
  for (int r = 0; r < NI; ++r) {
    const int l = step0 + (r * 32 + lane) % RPS;
    int32_t id = -1;
    if (at[r] >= 0 && l < L) {
      id = __ldg(indices + at[r] + l);
      if (mask != nullptr && __ldg(mask + at[r] + l) == 0) id = -1;
    }
    ids[r] = id;
  }
}

// The first slots of the bags the id registers of a task of G meeting bags
// (from meeting bag k0, of n_own) serve, for load_window_ids.
template <int G, int RPS, int NI>
__device__ __forceinline__ void window_slots(int64_t (&at)[NI], int64_t k0, int64_t n_own,
                                             int T, int L, const Window& w, int lane) {
#pragma unroll
  for (int r = 0; r < NI; ++r) {
    const int k = r * 32 + lane;
    const int64_t kb = k0 + k / RPS;
    at[r] = (k < G * RPS && kb < n_own) ? window_bag(kb, T, w) * L : -1;
  }
}

// Zeroes the partial rows of the bags of the tables that do not meet the
// window: zero task z covers the foreign bags [z * kZeroBags, (z + 1) *
// kZeroBags) of the B * (T - nt), in 16-byte stores; D * sizeof(TC) is a
// multiple of 16 at the tuned widths.
template <typename TC, int D>
__device__ __forceinline__ void zero_foreign(TC* __restrict__ out, int64_t z, int64_t n_foreign,
                                             int T, const Window& w, int lane) {
  constexpr int kChunks = D * (int)sizeof(TC) / 16;  // 16-byte chunks a row
  const int nf = T - w.nt;
  for (int e = lane; e < kZeroBags * kChunks; e += 32) {
    const int64_t f = z * kZeroBags + e / kChunks;
    if (f >= n_foreign) break;
    const int j = (int)(f % nf);
    const int64_t bag = (f / nf) * T + (j < w.t_lo ? j : j + w.nt);
    reinterpret_cast<uint4*>(out + bag * D)[e % kChunks] = make_uint4(0u, 0u, 0u, 0u);
  }
}

// K1-int8.
template <typename TC, int D, int LPR, int G, int U, bool H, bool kWindow = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSm)
embedding_bag_int8_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                          const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ indices,
                          const uint8_t* __restrict__ mask, TC* __restrict__ out,
                          int64_t n_bags, int T, int L, Window w) {
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
  // The window's groups are over the meeting tables' n_own bags; its zero
  // tasks follow them (as K4's).
  const int64_t n_own = kWindow ? n_bags / T * w.nt : n_bags;
  const int64_t n_tasks = (n_own + G - 1) / G;
  const int64_t n_all = kWindow ? n_tasks + (n_bags - n_own + kZeroBags - 1) / kZeroBags : n_tasks;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_all; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    if constexpr (kWindow) {
      if (task >= n_tasks) {
        zero_foreign<TC, D>(out, task - n_tasks, n_bags - n_own, T, w, lane);
        continue;
      }
    }
    const int64_t bag0 = task * G;
    int64_t bag = bag0 + bi;
    bool tested = false;  // the window's test at each row load (a straddling table)
    int64_t at[NI];
    if constexpr (kWindow) {
      tested = window_tested(w.t_lo + (int)(bag % w.nt), w);
      bag = bag < n_own ? window_bag(bag, T, w) : n_bags;
      window_slots<G, RPS, NI>(at, bag0, n_own, T, L, w, lane);
    }
    const int64_t base =
        (bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0) - (kWindow ? w.row_lo : 0);

    int32_t ids[NI];
    int acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0;

    if constexpr (kWindow) {
      load_window_ids<RPS, NI>(ids, at, indices, mask, L, 0, lane);
    } else {
      load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, 0, lane);
    }
    for (int step0 = 0; step0 < L; step0 += RPS) {
      int32_t rid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) rid[u] = id_of<NI>(ids, bi * RPS + u * SPB + s);
      uint4 v[U][NV];
#pragma unroll
      for (int u = 0; u < U; ++u) {
#pragma unroll
        for (int c = 0; c < NV; ++c) v[u][c] = make_uint4(0u, 0u, 0u, 0u);
        if (rid[u] >= 0 && (!tested || in_window(base, rid[u], w))) {
          const int8_t* row = q + (base + rid[u]) * D + col;
#pragma unroll
          for (int c = 0; c < NV; ++c) v[u][c] = load16<H>(row + 16 * c);
        }
      }
      if (step0 + RPS < L) {
        if constexpr (kWindow) {
          load_window_ids<RPS, NI>(ids, at, indices, mask, L, step0 + RPS, lane);
        } else {
          load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, step0 + RPS, lane);
        }
      }
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
                                  int64_t n_bags, int T, int L, Window w) {
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
  // The window's groups are over the meeting tables' n_own bags; its zero
  // tasks follow them.
  const int64_t n_own = kWindow ? n_bags / T * w.nt : n_bags;
  const int64_t n_tasks = (n_own + G - 1) / G;
  const int64_t n_all = kWindow ? n_tasks + (n_bags - n_own + kZeroBags - 1) / kZeroBags : n_tasks;

  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
       task < n_all; task += (int64_t)gridDim.x * kWarpsPerBlock) {
    if constexpr (kWindow) {
      if (task >= n_tasks) {
        zero_foreign<TC, D>(out, task - n_tasks, n_bags - n_own, T, w, lane);
        continue;
      }
    }
    const int64_t bag0 = task * G;
    int64_t bag = bag0 + bi;
    bool tested = false;  // the window's test at each row load (a straddling table)
    int64_t at[NI];
    if constexpr (kWindow) {
      const int t = w.t_lo + (int)(bag % w.nt);
      tested = window_tested(t, w);
      bag = bag < n_own ? window_bag(bag, T, w) : n_bags;
      window_slots<G, RPS, NI>(at, bag0, n_own, T, L, w, lane);
    }
    const int64_t base =
        (bag < n_bags ? (int64_t)__ldg(offsets + bag % T) : 0) - (kWindow ? w.row_lo : 0);

    int32_t ids[NI];
    float acc[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) acc[i] = 0.f;

    if constexpr (kWindow) {
      load_window_ids<RPS, NI>(ids, at, indices, mask, L, 0, lane);
    } else {
      load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, 0, lane);
    }
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
        if (rid[u] >= 0 && (!tested || in_window(base, rid[u], w))) {
          const uint4* chunk = row_window(
              reinterpret_cast<uintptr_t>(qrows) + (base + rid[u]) * RB, c0, e[u]);
#pragma unroll
          for (int c = 0; c < NC; ++c) win[u][c] = load16<H>(chunk + c);
        }
      }
      if (step0 + RPS < L) {
        if constexpr (kWindow) {
          load_window_ids<RPS, NI>(ids, at, indices, mask, L, step0 + RPS, lane);
        } else {
          load_ids<G, RPS, NI>(ids, indices, mask, bag0, n_bags, L, step0 + RPS, lane);
        }
      }
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

constexpr int kGeneralCols = 4;

// The bag's live slots in order: f(row) for each that is not masked out,
// row = base + id, the ids fetched 32 at a time in one coalesced load; the
// row index is the same in every lane.
template <typename F>
__device__ __forceinline__ void for_each_row(const int32_t* __restrict__ indices,
                                             const uint8_t* __restrict__ mask, int64_t bag,
                                             int L, int64_t base, int lane, F f) {
  for (int l0 = 0; l0 < L; l0 += 32) {
    int32_t id = -1;
    if (l0 + lane < L) {
      const int64_t at = bag * L + l0 + lane;
      id = __ldg(indices + at);
      if (mask != nullptr && __ldg(mask + at) == 0) id = -1;
    }
    const int n = min(32, L - l0);
    for (int j = 0; j < n; ++j) {
      const int32_t r = __shfl_sync(0xffffffffu, id, j);
      if (r >= 0) f(base + r);
    }
  }
}

// A general instance's window task: a warp a bag of the meeting tables
// (task < B * nt), then a warp a foreign bag, which it zeroes. Returns the
// batch bag, and in `foreign` and `tested` which kind it is.
__device__ __forceinline__ int64_t general_window_bag(int64_t task, int64_t n_bags, int T,
                                                      const Window& w, bool& foreign,
                                                      bool& tested) {
  const int64_t n_own = n_bags / T * w.nt;
  foreign = task >= n_own;
  if (foreign) {
    const int nf = T - w.nt;
    const int64_t f = task - n_own;
    const int j = (int)(f % nf);
    return (f / nf) * T + (j < w.t_lo ? j : j + w.nt);
  }
  tested = window_tested(w.t_lo + (int)(task % w.nt), w);
  return window_bag(task, T, w);
}

// K1-int8 at any width (TC = int32_t: the window's exact pool).
template <typename TC, bool kWindow>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_int8_general_kernel(const int8_t* __restrict__ q, const float* __restrict__ scale,
                                  const int32_t* __restrict__ offsets,
                                  const int32_t* __restrict__ indices,
                                  const uint8_t* __restrict__ mask, TC* __restrict__ out, int d,
                                  int64_t n_bags, int T, int L, Window w) {
  const int lane = threadIdx.x & 31;
  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); task < n_bags;
       task += (int64_t)gridDim.x * kWarpsPerBlock) {
    int64_t bag = task;
    bool tested = false;
    if constexpr (kWindow) {
      bool foreign;
      bag = general_window_bag(task, n_bags, T, w, foreign, tested);
      if (foreign) {
        for (int c = lane; c < d; c += 32) to_out(0, out + bag * d + c);
        continue;
      }
    }
    const int64_t base = (int64_t)__ldg(offsets + bag % T) - (kWindow ? w.row_lo : 0);
    for (int c0 = 0; c0 < d; c0 += 32 * kGeneralCols) {
      int acc[kGeneralCols] = {};
      for_each_row(indices, mask, bag, L, base, lane, [&](int64_t row) {
        if (tested && (uint64_t)row >= (uint64_t)w.n_rows) return;
        const int8_t* p = q + row * d;
#pragma unroll
        for (int k = 0; k < kGeneralCols; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < d) acc[k] += (int)__ldg(p + c);
        }
      });
#pragma unroll
      for (int k = 0; k < kGeneralCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c >= d) continue;
        if constexpr (kWindow) {
          to_out(acc[k], out + bag * d + c);
        } else {
          to_out(__fmul_rn(static_cast<float>(acc[k]), __ldg(scale + bag % T)), out + bag * d + c);
        }
      }
    }
  }
}

// K4 at any width: rows of d + 4 bytes, the scale the last 4 (read a byte
// at a time: a row need not start on a 4-byte boundary).
template <typename TC, bool kWindow>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
embedding_bag_rowwise_general_kernel(const int8_t* __restrict__ qrows,
                                     const int32_t* __restrict__ offsets,
                                     const int32_t* __restrict__ indices,
                                     const uint8_t* __restrict__ mask, TC* __restrict__ out, int d,
                                     int64_t n_bags, int T, int L, Window w) {
  const int lane = threadIdx.x & 31;
  const int64_t rb = d + 4;
  for (int64_t task = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); task < n_bags;
       task += (int64_t)gridDim.x * kWarpsPerBlock) {
    int64_t bag = task;
    bool tested = false;
    if constexpr (kWindow) {
      bool foreign;
      bag = general_window_bag(task, n_bags, T, w, foreign, tested);
      if (foreign) {
        for (int c = lane; c < d; c += 32) to_out(0.f, out + bag * d + c);
        continue;
      }
    }
    const int64_t base = (int64_t)__ldg(offsets + bag % T) - (kWindow ? w.row_lo : 0);
    for (int c0 = 0; c0 < d; c0 += 32 * kGeneralCols) {
      float acc[kGeneralCols] = {};
      for_each_row(indices, mask, bag, L, base, lane, [&](int64_t row) {
        if (tested && (uint64_t)row >= (uint64_t)w.n_rows) return;
        const uint8_t* p = reinterpret_cast<const uint8_t*>(qrows) + row * rb;
        const uint32_t w = (uint32_t)__ldg(p + d) | ((uint32_t)__ldg(p + d + 1) << 8) |
                           ((uint32_t)__ldg(p + d + 2) << 16) | ((uint32_t)__ldg(p + d + 3) << 24);
        const float row_scale = __uint_as_float(w);
#pragma unroll
        for (int k = 0; k < kGeneralCols; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < d) {
            const float value = static_cast<float>(static_cast<int8_t>(__ldg(p + c)));
            acc[k] += __fmul_rn(value, row_scale);
          }
        }
      });
#pragma unroll
      for (int k = 0; k < kGeneralCols; ++k) {
        const int c = c0 + lane + 32 * k;
        if (c < d) to_out(acc[k], out + bag * d + c);
      }
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
  int t_lo = 0, nt = 0, test_lo = 0, test_hi = 0;  // and its meeting tables
};

Window window_of(const Args& a) {
  return Window{a.row_lo, a.n_rows, a.t_lo, a.nt, a.test_lo, a.test_hi};
}

template <typename TC, int D, int LPR, int G, int U, bool H, bool kWindow = false>
int launch_int8(const void* q, const void* scale, const Args& a) {
  embedding_bag_int8_kernel<TC, D, LPR, G, U, H, kWindow>
      <<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(scale), a.offsets,
          a.indices, a.mask, static_cast<TC*>(a.out), a.n_bags, a.T, a.L, window_of(a));
  return (int)cudaGetLastError();
}

template <typename TC, int D, int LPR, int G, int U, bool H, bool kWindow = false>
int launch_rowwise(const void* qrows, const Args& a) {
  embedding_bag_int8_rowwise_kernel<TC, D, LPR, G, U, H, kWindow>
      <<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
          static_cast<const int8_t*>(qrows), a.offsets, a.indices, a.mask,
          static_cast<TC*>(a.out), a.n_bags, a.T, a.L, window_of(a));
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

// G = 0: the general instance at any width; else the mapping (G, U) at
// D = 32 or 64.
template <typename TC, bool kWindow = false>
int width_int8(int d, int G, int U, const void* q, const void* scale, const Args& a) {
  if (G == 0) {
    embedding_bag_int8_general_kernel<TC, kWindow><<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale), a.offsets, a.indices,
        a.mask, static_cast<TC*>(a.out), d, a.n_bags, a.T, a.L, window_of(a));
    return (int)cudaGetLastError();
  }
  if (d == 32) return mapping_int8<TC, 32, kWindow>(G, U, q, scale, a);
  if (d == 64) return mapping_int8<TC, 64, kWindow>(G, U, q, scale, a);
  return (int)cudaErrorInvalidValue;
}

template <typename TC, bool kWindow = false>
int width_rowwise(int d, int G, int U, const void* qrows, const Args& a) {
  if (G == 0) {
    embedding_bag_rowwise_general_kernel<TC, kWindow>
        <<<a.grid, kWarpsPerBlock * 32, 0, a.stream>>>(
            static_cast<const int8_t*>(qrows), a.offsets, a.indices, a.mask,
            static_cast<TC*>(a.out), d, a.n_bags, a.T, a.L, window_of(a));
    return (int)cudaGetLastError();
  }
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

// The window's arguments: the shard [row_lo, row_lo + n_rows) and the tables
// [t_lo, t_lo + nt) that meet it (ops/embedding.py::table_range), test_lo /
// test_hi where the first / last of them straddles a shard edge.
bool window_args(Args& a, int64_t row_lo, int64_t n_rows, int t_lo, int nt, int test_lo,
                 int test_hi) {
  if (row_lo < 0 || n_rows < 0 || t_lo < 0 || nt < 0 || t_lo + nt > a.T) return false;
  a.row_lo = row_lo;
  a.n_rows = n_rows;
  a.t_lo = t_lo;
  a.nt = nt;
  a.test_lo = test_lo;
  a.test_hi = test_hi;
  return true;
}

// The lookup of one row shard (the window): q holds fused rows [row_lo,
// row_lo + n_rows); out is the (B, T, d) int32 pool before the scale, the
// bags of the tables outside [t_lo, t_lo + nt) zero. grid covers the plan's
// groups over the B * nt meeting bags and the zero tasks (k1i_window_plan).
int drs_embedding_bag_int8_window(const void* q, int d, const void* offsets,
                                  const void* indices, const void* mask, void* out,
                                  int64_t row_lo, int64_t n_rows, int t_lo, int nt, int test_lo,
                                  int test_hi, int64_t n_bags, int T, int L, int bags_per_warp,
                                  int rows_per_lane, int grid, void* stream) {
  if (n_bags <= 0) return 0;
  Args a = make_args(offsets, indices, mask, out, n_bags, T, L, grid, stream);
  if (grid <= 0 || !window_args(a, row_lo, n_rows, t_lo, nt, test_lo, test_hi))
    return (int)cudaErrorInvalidValue;
  return width_int8<int32_t, true>(d, bags_per_warp, rows_per_lane, q, nullptr, a);
}

// As above for K4: out is the (B, T, d) f32 sum before the cast; grid:
// k4_window_plan's.
int drs_embedding_bag_int8_rowwise_window(const void* qrows, int d, const void* offsets,
                                          const void* indices, const void* mask, void* out,
                                          int64_t row_lo, int64_t n_rows, int t_lo, int nt,
                                          int test_lo, int test_hi, int64_t n_bags, int T,
                                          int L, int bags_per_warp, int rows_per_lane, int grid,
                                          void* stream) {
  if (n_bags <= 0) return 0;
  Args a = make_args(offsets, indices, mask, out, n_bags, T, L, grid, stream);
  if (grid <= 0 || !window_args(a, row_lo, n_rows, t_lo, nt, test_lo, test_hi))
    return (int)cudaErrorInvalidValue;
  return width_rowwise<float, true>(d, bags_per_warp, rows_per_lane, qrows, a);
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
