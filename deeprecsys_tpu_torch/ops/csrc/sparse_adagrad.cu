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
// launches, never one kernel that interleaves them.
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
// 128 bytes: ~22 MB, ~7 us at 3.35 TB/s. At dien's sparse shape (T = 43,
// L = 1) every bag is one row. Measured, both launches are held by those
// random rows through DRAM, not by the atomics: launch 2 with plain
// read-modify-writes, or without its accumulator reads, is no faster
// (experiments/k5_sweep.py's probes, PERF.md). The design:
//   * launch 1 (accumulate): a lane a slot, S lanes a bag's window of S
//     slots, S the power of two >= L, at least a lane a 16-byte chunk of
//     the bag's gradient row and at most 32
//     (ops/sparse_adagrad.py::k5_launch_plan), so short bags share a warp
//     (4 bags of one row) and long bags take a warp a window; the lanes
//     load the bag's gradient row in 16-byte chunks, sum its squares in
//     torch.mean's order (by shuffles across the window's lanes, then in
//     registers), and each adds the mean to its slot's row with one f32
//     atomic add;
//   * launch 2 (apply): flat over the B*T*L slots, P lanes a slot, each
//     lane one 16-byte vector atomic add into its part of the row (sm_90's
//     red.global.add.v4.f32, 4 f32 elements; red.global.add.noftz
//     .v4.bf16x2, 8 bf16 elements): an f32 D = 32 row is 8 lanes, so one
//     warp instruction updates 4 rows where the parent's scalar atomics
//     updated one. Each element's add stays atomic, so duplicate rows add
//     their own terms as before;
//   * launch 2 starts early (programmatic dependent launch, as K6's pool
//     does): launch 1 lets it start at once (griddepcontrol
//     .launch_dependents), and it loads its ids and its gradient values,
//     then waits (griddepcontrol.wait) before its first accumulator read.
//     That wait returns only when launch 1 has completed and its memory
//     operations are visible, so every accumulator add still lands before
//     any scale is read. Its scale is rsqrtf(acc + eps), what ATen's rsqrt
//     computes on the card (the plain version's, bit for bit), the update
//     cast to the table dtype before it is added.
// The order of the atomic adds changes from run to run, so results agree
// with a sequential scatter to within the rounding of the adds to a row.
//
// The ownership window (drs_sparse_adagrad_window): the step of one row
// shard of the table, rows [row_lo, row_lo + n_rows), with its own
// accumulator; it replaces the shard's masked scatters of the sharded
// sparse step (deeprecsys_tpu/train.py:177-182). It is given the whole
// stream (every data slice's ids, concatenated), of which the shard owns
// about 1 / M. Launch 1 (launch 1's mapping above: a lane a slot, S lanes a
// window of a bag; column order at any width) adds each owned slot's bag's
// mean g^2 to its accumulator; launch 2 (apply_shard_kernel) walks every
// slot and a slot outside the window touches nothing, its lanes leaving
// after one id load made before launch 2's wait. Every accumulator add
// lands before any scale is read: launch 2 waits for launch 1
// (programmatic dependent launch, as above). Measured and not shipped
// (experiments/k5w_sweep.py, PERF.md): launch 1 a bag a task (its ids and
// mean once) and a list of the owned slots that launch 2 walks alone; the
// fewer warps of a bag a task hide less of launch 1's latency, and the
// list's append and its dependent loads after launch 2's wait cost more
// than the unowned lanes it spares. The update is cast to the table dtype
// before it is added, as in the single-device step, for an f32 shard. A
// bf16 shard follows the TPU package's sharded step instead (train.py:
// 177-182: the shard's updates added in f32, each row rounded once), with
// a merge inside the window: launch 1 (window_accumulate_kernel) also
// inserts each owned slot's row into an open-addressing hash table
// (atomicCAS, linear probing, at most half full), so each distinct touched
// row gets one entry; the slot that claims an entry zeroes its f32 row and
// lists it (one atomic add a warp). Launch 2 adds each slot's f32 update
// into its entry's row (red.global.add.v4.f32, 16 bytes a lane), and a last
// launch (merge_rows_kernel, a warp a listed entry) adds each entry's row
// into the shard, rounds it once and frees its key. No sort and nothing
// read back: the entry point zeroes the count of claimed entries (4 bytes)
// and sets every key to -1 by two memsets on the stream ahead of launch 1,
// so a call carries nothing over from the call before it, its scratch is
// the caller's temporaries (ops/sparse_adagrad.py::_window_scratch), and a
// CUDA graph can hold it (the memsets become nodes of the graph; its
// scratch lies in the graph's pool, which other graphs may use between two
// replays of this one). The merge still frees every key it set.
//
// Widths. The mapping above is built at every width up to 64 whose table
// and gradient rows are 16 * 2^k bytes, each width its instance; 32 and 64
// keep theirs. Any other width takes the general instance
// (accumulate_general_kernel, apply_general_kernel): a thread a slot, the
// bag's mean g^2 summed in column order (row_mean_sq), scalar atomic adds
// (bf16 ones cast first, as above); correct, not tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
// Launch 1's L2 prefetches (bits; the sweep's, none shipped): the slot's
// table row, for launch 2's atomic adds; the slot's accumulator, ahead of
// launch 1's own add.
constexpr int kPrefetchRows = 1, kPrefetchAcc = 2;

// The shipped mapping; experiments/k5_sweep.py builds the others.
struct Shipped {
  static constexpr int kVecBytes = 16;  // bytes of one lane's atomic add in launch 2
  static constexpr bool kPdl = true;    // launch 2 with programmatic dependent launch
  static constexpr int kPrefetch = 0;   // what launch 1 brings into the L2
};

struct Args {
  void* table;
  float* acc;
  const void* g;
  const int32_t* offsets;
  const int32_t* indices;
  int64_t n_bags;
  int T, L;
  float neg_lr, eps;
  cudaStream_t stream;
  int64_t row_lo = 0, n_rows = 0;  // the window (accumulate_kernel's kWindow instances)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// E consecutive values of g (f32 or bf16) from p, in 16-, 8- or 4-byte loads.
template <typename TG, int E>
__device__ __forceinline__ void load_g(const TG* __restrict__ p, float (&v)[E]) {
  constexpr int kBytes = E * (int)sizeof(TG);
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int w = 0; w < kBytes / 16; ++w) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + w);
      const uint32_t x[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if constexpr (sizeof(TG) == 4) {
          v[4 * w + k] = __uint_as_float(x[k]);
        } else {
          v[8 * w + 2 * k] = __uint_as_float(x[k] << 16);
          v[8 * w + 2 * k + 1] = __uint_as_float(x[k] & 0xffff0000u);
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < E; ++k) v[k] = to_float(__ldg(p + k));
  }
}

template <typename TT>
__device__ __forceinline__ TT from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// One atomic add of x, cast to the table dtype first.
__device__ __forceinline__ void atomic_add_as(float* p, float x) { atomicAdd(p, x); }
__device__ __forceinline__ void atomic_add_as(__nv_bfloat16* p, float x) {
  atomicAdd(p, __float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// Atomically adds E values (cast to the table dtype) to p[0 .. E), one
// vector reduction of E * sizeof(TT) bytes: each element's add is atomic.
template <typename TT, int E>
__device__ __forceinline__ void red_add(TT* p, const float (&v)[E]) {
  if constexpr (sizeof(TT) == 4) {
    static_assert(E == 1 || E == 2 || E == 4, "f32 reductions are 4, 8 or 16 bytes");
    if constexpr (E == 1) {
      atomicAdd(reinterpret_cast<float*>(p), v[0]);
    } else if constexpr (E == 2) {
      asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(v[0]), "f"(v[1])
                   : "memory");
    } else {
      asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(v[0]),
                   "f"(v[1]), "f"(v[2]), "f"(v[3])
                   : "memory");
    }
  } else {
    static_assert(E == 2 || E == 4 || E == 8, "bf16 reductions are 4, 8 or 16 bytes");
    if constexpr (E == 2) {
      asm volatile("red.global.add.noftz.bf16x2 [%0], %1;" ::"l"(p), "r"(bf16x2(v[0], v[1]))
                   : "memory");
    } else if constexpr (E == 4) {
      asm volatile("red.global.add.noftz.v2.bf16x2 [%0], {%1, %2};" ::"l"(p),
                   "r"(bf16x2(v[0], v[1])), "r"(bf16x2(v[2], v[3]))
                   : "memory");
    } else {
      asm volatile("red.global.add.noftz.v4.bf16x2 [%0], {%1, %2, %3, %4};" ::"l"(p),
                   "r"(bf16x2(v[0], v[1])), "r"(bf16x2(v[2], v[3])), "r"(bf16x2(v[4], v[5])),
                   "r"(bf16x2(v[6], v[7]))
                   : "memory");
    }
  }
}

// The sum of x[0 .. N), N a power of two, halving: x[i] + x[i + N / 2],
// then again on the first half; rounded adds, no FMA.
template <int N>
__device__ __forceinline__ float halving_sum(float (&x)[N]) {
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) x[i] = __fadd_rn(x[i], x[i + w]);
  }
  return x[0];
}

// Launch 1: a task is a bag's window of S slots (S divides 32, so a task's
// lanes are one aligned segment of a warp), a lane a slot, and S is at
// least the gradient row's 16-byte chunks, a lane loading one. A bag's sum
// of squares is added in the order of torch.mean over a row of 32 or 64 on
// the card, halving: element t + D / 2 onto t, then t + D / 4, ...
// (measured: every one of 2^20 rows equal, experiments/k5_sweep.py
// --mean_order). Across a lane's chunk that is a shuffle of each square,
// within it a halving sum; the segment's first lane then hands the sum to
// all. The plain version's accumulator and scales are then the kernel's
// bit for bit on rows that take one add, so no term's bf16 rounding flips
// between them; a sum in another order strays further than the
// tolerance's order argument allows.
template <typename TG, int D, int S, int PF, bool kWindow>
__global__ void __launch_bounds__(kThreads)
accumulate_kernel(const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                  const int32_t* __restrict__ indices, float* __restrict__ acc,
                  const char* __restrict__ table, int row_bytes, int64_t n_bags, int T,
                  int L, int64_t row_lo, int64_t n_rows) {
  // Launch 2 may start now: what it reads before its wait is not written
  // here (cudaTriggerProgrammaticLaunchCompletion()).
  asm volatile("griddepcontrol.launch_dependents;");
  constexpr int kE = 16 / (int)sizeof(TG);  // g values a 16-byte chunk
  constexpr int kChunks = D / kE;
  static_assert(S >= kChunks, "a lane a chunk of the gradient row");
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int windows = (L + S - 1) / S;
  const int64_t task = t / S;
  const int64_t bag = task / windows;
  const int j = (int)(t % S);
  const int l = (int)(task % windows) * S + j;
  if (bag >= n_bags) return;  // the whole segment: it shares the task
  int64_t row = l < L ? (int64_t)__ldg(offsets + bag % T) + __ldg(indices + bag * L + l) : -1;
  if constexpr (kWindow) {
    if (row >= 0) row = (uint64_t)(row - row_lo) < (uint64_t)n_rows ? row - row_lo : -1;
  }
  if constexpr ((PF & kPrefetchRows) != 0) {
    if (row >= 0)
      asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(table + row * row_bytes),
                   "r"(row_bytes) : "memory");
  }
  if constexpr ((PF & kPrefetchAcc) != 0) {
    if (row >= 0) asm volatile("prefetch.global.L2 [%0];" ::"l"(acc + row) : "memory");
  }
  const int lane = threadIdx.x & 31;
  const unsigned seg = S == 32 ? 0xffffffffu : ((1u << S) - 1u) << (lane & ~(S - 1));
  float v[kE] = {};
  if (j < kChunks) {
    load_g<TG, kE>(g + bag * D + j * kE, v);
#pragma unroll
    for (int k = 0; k < kE; ++k) v[k] = __fmul_rn(v[k], v[k]);
  }
#pragma unroll
  for (int off = kChunks / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kE; ++k) v[k] = __fadd_rn(v[k], __shfl_xor_sync(seg, v[k], off));
  }
  const float sq = __shfl_sync(seg, halving_sum(v), 0, S);
  const float mean_sq = sq / (float)D;
  if (row >= 0) atomicAdd(acc + row, mean_sq);
}

// Waits for launch 1 (cudaGridDependencySynchronize()); a no-op when launch
// 2 was launched without programmatic dependent launch.
__device__ __forceinline__ void wait_accumulated() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch 2: a slot (bag, l) a group of S lanes, each lane K adds of E
// elements (P = D / E lanes a row; an f32 D = 64 row at 4 bytes a lane is
// 64 parts, two a lane).
template <typename TT, typename TG, int D, int VB, bool kWindow>
__device__ __forceinline__ void apply_body(TT* __restrict__ table, const float* __restrict__ acc,
                                           const TG* __restrict__ g,
                                           const int32_t* __restrict__ offsets,
                                           const int32_t* __restrict__ indices, int64_t n_slots,
                                           int T, int L, float neg_lr, float eps, int64_t row_lo,
                                           int64_t n_rows) {
  constexpr int E = VB / (int)sizeof(TT);
  constexpr int P = D / E;
  constexpr int S = P < 32 ? P : 32;
  constexpr int K = P / S;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t slot = t / S;
  const int j = (int)(t % S);
  if (slot >= n_slots) return;
  const int64_t bag = slot / L;
  int64_t row = (int64_t)__ldg(offsets + bag % T) + __ldg(indices + slot);
  if constexpr (kWindow) {
    row -= row_lo;
    if ((uint64_t)row >= (uint64_t)n_rows) return;  // another shard's row
  }
  float v[K][E];
#pragma unroll
  for (int k = 0; k < K; ++k) load_g<TG, E>(g + bag * D + (j + k * S) * E, v[k]);
  wait_accumulated();
  const float s = rsqrtf(__ldcg(acc + row) + eps);
  TT* dst = table + row * D;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[k][e] = neg_lr * (v[k][e] * s);
    red_add<TT, E>(dst + (j + k * S) * E, v[k]);
  }
}

template <typename TT, typename TG, int D, int VB>
__global__ void __launch_bounds__(kThreads)
apply_kernel(TT* __restrict__ table, const float* __restrict__ acc, const TG* __restrict__ g,
             const int32_t* __restrict__ offsets, const int32_t* __restrict__ indices,
             int64_t n_slots, int T, int L, float neg_lr, float eps) {
  apply_body<TT, TG, D, VB, false>(table, acc, g, offsets, indices, n_slots, T, L, neg_lr, eps,
                                   0, 0);
}

// Launch 2 of one row shard on the direct plan: apply_kernel's slots, the
// window's only.
template <typename TT, typename TG, int D, int VB>
__global__ void __launch_bounds__(kThreads)
apply_shard_kernel(TT* __restrict__ table, const float* __restrict__ acc,
                   const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ indices, int64_t n_slots, int T, int L,
                   float neg_lr, float eps, int64_t row_lo, int64_t n_rows) {
  apply_body<TT, TG, D, VB, true>(table, acc, g, offsets, indices, n_slots, T, L, neg_lr, eps,
                                  row_lo, n_rows);
}

// Launch 2 of a bf16 window on the direct plan: apply_body's slots, each
// owned slot's f32 update added (VB-byte f32 reductions) into the f32 row
// of the entry launch 1 gave it (read after the wait: launch 1 wrote it).
template <typename TG, int D, int VB>
__global__ void __launch_bounds__(kThreads)
apply_merged_kernel(float* __restrict__ merged, const int32_t* __restrict__ entry,
                    const float* __restrict__ acc, const TG* __restrict__ g,
                    const int32_t* __restrict__ offsets, const int32_t* __restrict__ indices,
                    int64_t n_slots, int T, int L, float neg_lr, float eps, int64_t row_lo) {
  constexpr int E = VB / (int)sizeof(float);
  constexpr int P = D / E;
  constexpr int S = P < 32 ? P : 32;
  constexpr int K = P / S;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t slot = t / S;
  const int j = (int)(t % S);
  if (slot >= n_slots) return;
  const int64_t bag = slot / L;
  const int64_t row = (int64_t)__ldg(offsets + bag % T) + __ldg(indices + slot) - row_lo;
  float v[K][E];
#pragma unroll
  for (int k = 0; k < K; ++k) load_g<TG, E>(g + bag * D + (j + k * S) * E, v[k]);
  wait_accumulated();
  const int32_t r = __ldcg(entry + slot);
  if (r < 0) return;  // another shard's row
  const float s = rsqrtf(__ldcg(acc + row) + eps);
  float* dst = merged + (int64_t)r * D;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[k][e] = neg_lr * (v[k][e] * s);
    red_add<float, E>(dst + (j + k * S) * E, v[k]);
  }
}

// A row's mean of squares, summed in column order and multiplied by
// f32(1 / d). torch.mean adds in another order, which
// ops/sparse_adagrad.py::sparse_adagrad_tolerance bounds for this instance.
template <typename TG>
__device__ float row_mean_sq(const TG* __restrict__ row, int d) {
  float sum = 0.f;
  for (int j = 0; j < d; ++j) {
    const float v = to_float(__ldg(row + j));
    sum = __fadd_rn(sum, __fmul_rn(v, v));
  }
  return __fmul_rn(sum, __fdiv_rn(1.f, (float)d));
}

// The general instance's launch 1: a thread a slot; the slot's bag's mean
// g^2 (row_mean_sq), one f32 atomic add into the slot's row.
template <typename TG>
__global__ void __launch_bounds__(kThreads)
accumulate_general_kernel(const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                          const int32_t* __restrict__ indices, float* __restrict__ acc, int d,
                          int64_t n_slots, int T, int L) {
  const int64_t slot = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (slot >= n_slots) return;
  const int64_t bag = slot / L;
  const int64_t row = (int64_t)__ldg(offsets + bag % T) + __ldg(indices + slot);
  atomicAdd(acc + row, row_mean_sq(g + bag * d, d));
}

// The general instance's launch 2 (stream-ordered after launch 1): a thread
// a slot, one scalar atomic add an element, the update cast to the table
// dtype first; or, with a rank (the bf16 window's merge on the direct
// plan), the f32 update added into the f32 row of the slot's entry.
template <typename TT, typename TG, bool kWindow>
__global__ void __launch_bounds__(kThreads)
apply_general_kernel(TT* __restrict__ table, float* __restrict__ merged,
                     const int32_t* __restrict__ rank, const float* __restrict__ acc,
                     const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ indices, int d, int64_t n_slots, int T, int L,
                     float neg_lr, float eps, int64_t row_lo, int64_t n_rows) {
  const int64_t slot = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (slot >= n_slots) return;
  const int64_t bag = slot / L;
  int64_t row = (int64_t)__ldg(offsets + bag % T) + __ldg(indices + slot);
  if constexpr (kWindow) {
    row -= row_lo;
    if ((uint64_t)row >= (uint64_t)n_rows) return;
  }
  const float s = rsqrtf(__ldcg(acc + row) + eps);
  const int32_t r = rank != nullptr ? __ldg(rank + slot) : -1;
  for (int k = 0; k < d; ++k) {
    const float u = neg_lr * (to_float(__ldg(g + bag * d + k)) * s);
    if (rank != nullptr) {
      atomicAdd(merged + (int64_t)r * d + k, u);
    } else {
      atomic_add_as(table + row * d + k, u);
    }
  }
}

// ---------------------------------------------------------------------------
// The bf16 window's merge.

// A window's state beside its shard (ops/sparse_adagrad.py::_window_launch).
struct Window {
  int64_t row_lo, n_rows;  // the shard's fused rows [row_lo, row_lo + n_rows)
  int lanes;               // launch 1's lanes a window of a bag (a power of two <= 32)
  // bf16 merge: this call's count of claimed entries, zeroed by the entry
  // point's memset ahead of launch 1.
  int32_t* count;
  int32_t* entry;    // bf16 merge: each slot's entry (-1 for another shard's row)
  int32_t* keys;     // bf16 merge: the hash table's n_keys keys, -1 where free (set so by
                     // the entry point's memset); null for an f32 shard
  int64_t n_keys;
  int32_t* claimed;  // bf16 merge: the claimed entries, *count of them
  float* merged;     // bf16 merge: each entry's (d,) f32 sum of updates
};

// Row `key`'s entry in the hash table (linear probing from a
// multiplicative hash; at most half full), claimed if it was free.
__device__ __forceinline__ int32_t insert_row(int32_t* keys, int64_t n_keys, int32_t key,
                                              bool& claimed) {
  const uint64_t mask = (uint64_t)n_keys - 1;
  uint64_t h = ((uint32_t)key * 2654435761u) & mask;
  for (;;) {
    const int32_t prev = atomicCAS(keys + h, -1, key);
    if (prev == -1 || prev == key) {
      claimed = prev == -1;
      return (int32_t)h;
    }
    h = (h + 1) & mask;
  }
}

// The index this lane's slot takes in a list that grows by one atomic add a
// warp (its lanes that `take` it), or -1.
__device__ __forceinline__ int warp_append(int32_t* count, bool take) {
  const unsigned ball = __ballot_sync(kFull, take);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == __ffs(ball) - 1) base = atomicAdd(count, __popc(ball));
  base = __shfl_sync(kFull, base, ball != 0u ? __ffs(ball) - 1 : 0);
  return take ? base + __popc(ball & ((1u << lane) - 1u)) : -1;
}

// Launch 1 of a bf16 window (and of an f32 one at the general instance's
// widths), on accumulate_kernel's mapping: a task is a window of w.lanes
// slots of a bag (a lane a slot; w.lanes at least the gradient row's
// 16-byte chunks for D > 0), the bag's mean g^2 computed as
// accumulate_kernel computes it (D > 0: torch.mean's order; D = 0, any
// width d: column order, row_mean_sq, by the window's first lane). An owned
// slot adds the mean to its row's accumulator and, on a bf16 shard,
// inserts its row into the hash table (a claimer zeroes its entry's f32
// row and lists the entry, one atomic add a warp); each slot records its
// entry (-1 where another shard owns its row).
template <typename TG, int D>
__global__ void __launch_bounds__(kThreads)
window_accumulate_kernel(const TG* __restrict__ g, const int32_t* __restrict__ offsets,
                         const int32_t* __restrict__ indices, float* __restrict__ acc, int d,
                         int64_t n_bags, int T, int L, Window w) {
  // Launch 2 may start now: it reads nothing before its wait.
  asm volatile("griddepcontrol.launch_dependents;");
  const bool merge = w.keys != nullptr;
  const int S = w.lanes;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int windows = (L + S - 1) / S;
  const int64_t task = t / S;
  const int64_t bag = task / windows;
  const int j = (int)(t % S);
  const int l = (int)(task % windows) * S + j;
  const bool real = bag < n_bags;  // a warp's tasks run past the last bag together
  float mean_sq;
  if constexpr (D > 0) {
    constexpr int kE = 16 / (int)sizeof(TG);  // g values a 16-byte chunk
    constexpr int kChunks = D / kE;
    float v[kE] = {};
    if (real && j < kChunks) {
      load_g<TG, kE>(g + bag * D + j * kE, v);
#pragma unroll
      for (int k = 0; k < kE; ++k) v[k] = __fmul_rn(v[k], v[k]);
    }
#pragma unroll
    for (int off = kChunks / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int k = 0; k < kE; ++k) v[k] = __fadd_rn(v[k], __shfl_xor_sync(kFull, v[k], off));
    }
    mean_sq = __shfl_sync(kFull, halving_sum(v), 0, S) / (float)D;
  } else {
    const float m = real && j == 0 ? row_mean_sq(g + bag * d, d) : 0.f;
    mean_sq = __shfl_sync(kFull, m, 0, S);
  }
  int64_t r = -1;
  if (real && l < L)
    r = (int64_t)__ldg(offsets + bag % T) + __ldg(indices + bag * L + l) - w.row_lo;
  const bool own = r >= 0 && (uint64_t)r < (uint64_t)w.n_rows;
  const int32_t row = (int32_t)r;
  if (own) atomicAdd(acc + row, mean_sq);
  if (!merge) return;  // an f32 shard at the general instance's widths
  int32_t ent = -1;
  {
    bool claim = false;
    if (own) ent = insert_row(w.keys, w.n_keys, row, claim);
    const int at = warp_append(w.count, claim);
    if (claim) {
      const int dd = D > 0 ? D : d;
      float* m = w.merged + (int64_t)ent * dd;
      if (dd % 4 == 0) {
        for (int c = 0; c < dd; c += 4) *reinterpret_cast<float4*>(m + c) = make_float4(0, 0, 0, 0);
      } else {
        for (int c = 0; c < dd; ++c) m[c] = 0.f;
      }
      w.claimed[at] = ent;
    }
  }
  if (real && l < L) w.entry[bag * L + l] = ent;
}

// The bf16 window's last launch: each claimed entry's f32 sum added into
// the shard's row and rounded once, and its key freed for the next call; a
// warp an entry (lanes over the row), grid-stride over *count.
template <typename TT>
__global__ void __launch_bounds__(kThreads)
merge_rows_kernel(TT* __restrict__ table, int d, Window w) {
  wait_accumulated();
  const int lane = threadIdx.x & 31;
  const int n = __ldcg(w.count);
  for (int64_t i = ((int64_t)blockIdx.x * kThreads + threadIdx.x) >> 5; i < n;
       i += ((int64_t)gridDim.x * kThreads) >> 5) {
    const int64_t h = __ldcg(w.claimed + i);
    TT* p = table + (int64_t)__ldcg(w.keys + h) * d;
    for (int c = lane; c < d; c += 32)
      p[c] = from_float<TT>(to_float(p[c]) + __ldcg(w.merged + h * d + c));
    __syncwarp();
    if (lane == 0) w.keys[h] = -1;
  }
}

// The general instance's two launches (one device).
template <typename TT, typename TG>
int launch_general(const Args& a, int d) {
  const int64_t n_slots = a.n_bags * a.L;
  const unsigned blocks = (unsigned)((n_slots + kThreads - 1) / kThreads);
  accumulate_general_kernel<TG><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const TG*>(a.g), a.offsets, a.indices, a.acc, d, n_slots, a.T, a.L);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  apply_general_kernel<TT, TG, false><<<blocks, kThreads, 0, a.stream>>>(
      static_cast<TT*>(a.table), nullptr, nullptr, a.acc, static_cast<const TG*>(a.g),
      a.offsets, a.indices, d, n_slots, a.T, a.L, a.neg_lr, a.eps, 0, 0);
  return (int)cudaGetLastError();
}

template <typename TG, int D, int S, int PF, bool kWindow = false>
int launch_accumulate(const Args& a, int row_bytes) {
  if constexpr (S < D * (int)sizeof(TG) / 16) {
    return (int)cudaErrorInvalidValue;  // fewer lanes than the row's chunks (k5_launch_plan)
  } else {
    const int64_t blocks = (a.n_bags * ((a.L + S - 1) / S) * S + kThreads - 1) / kThreads;
    accumulate_kernel<TG, D, S, PF, kWindow><<<(unsigned)blocks, kThreads, 0, a.stream>>>(
        static_cast<const TG*>(a.g), a.offsets, a.indices, a.acc,
        static_cast<const char*>(a.table), row_bytes, a.n_bags, a.T, a.L, a.row_lo, a.n_rows);
    return (int)cudaGetLastError();
  }
}

// Launch 1 on lanes_per_bag (1, 2, 4, 8, 16 or 32: at least a 16-byte
// chunk of the gradient row a lane) lanes a bag; the window's slots only
// when kWindow.
template <typename TG, int D, int PF, bool kWindow = false>
int accumulate(const Args& a, int row_bytes, int lanes_per_bag) {
  switch (lanes_per_bag) {
    case 1: return launch_accumulate<TG, D, 1, PF, kWindow>(a, row_bytes);
    case 2: return launch_accumulate<TG, D, 2, PF, kWindow>(a, row_bytes);
    case 4: return launch_accumulate<TG, D, 4, PF, kWindow>(a, row_bytes);
    case 8: return launch_accumulate<TG, D, 8, PF, kWindow>(a, row_bytes);
    case 16: return launch_accumulate<TG, D, 16, PF, kWindow>(a, row_bytes);
    case 32: return launch_accumulate<TG, D, 32, PF, kWindow>(a, row_bytes);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch 2: ``kernel`` (apply_kernel, or a sweep's other mapping) on
// ``threads`` threads, with programmatic dependent launch when pdl.
template <typename... KArgs, typename... Params>
int launch_pdl(void (*kernel)(KArgs...), const Args& a, int64_t threads, bool pdl,
               Params... params) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((threads + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, params...);
}

template <typename TT, typename TG>
int launch_apply(void (*kernel)(TT*, const float*, const TG*, const int32_t*, const int32_t*,
                                int64_t, int, int, float, float),
                 const Args& a, int64_t threads, bool pdl) {
  return launch_pdl(kernel, a, threads, pdl, static_cast<TT*>(a.table),
                    static_cast<const float*>(a.acc), static_cast<const TG*>(a.g), a.offsets,
                    a.indices, a.n_bags * a.L, a.T, a.L, a.neg_lr, a.eps);
}

// Both launches: launch 1 with lanes_per_bag lanes a bag and the L2
// prefetches PF, launch 2 with VB-byte atomic adds, with programmatic
// dependent launch when pdl. The wrapper builds Shipped's instance;
// experiments/k5_sweep.py the others.
template <typename TT, typename TG, int D, int VB, int PF>
int launch(const Args& a, int lanes_per_bag, bool pdl) {
  constexpr int P = D * (int)sizeof(TT) / VB;
  const int err = accumulate<TG, D, PF>(a, D * (int)sizeof(TT), lanes_per_bag);
  if (err != 0) return err;
  return launch_apply(apply_kernel<TT, TG, D, VB>, a, a.n_bags * a.L * (P < 32 ? P : 32), pdl);
}

// A bf16 window's count of claimed entries set to zero and every key to -1
// ahead of launch 1, on the stream (memset nodes in a CUDA graph, so each
// replay starts from them).
inline int zero_count(const Args& a, const Window& w) {
  int err = (int)cudaMemsetAsync(w.count, 0, sizeof(int32_t), a.stream);
  if (err == 0)
    err = (int)cudaMemsetAsync(w.keys, 0xff, (size_t)w.n_keys * sizeof(int32_t), a.stream);
  return err;
}

// The window's launch 1 on its plan's lanes a window of a bag.
template <typename TG, int D>
int launch_window_accumulate(const Args& a, int d, const Window& w) {
  const int64_t threads = a.n_bags * ((a.L + w.lanes - 1) / w.lanes) * w.lanes;
  window_accumulate_kernel<TG, D><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                                    a.stream>>>(static_cast<const TG*>(a.g), a.offsets, a.indices,
                                                a.acc, d, a.n_bags, a.T, a.L, w);
  return (int)cudaGetLastError();
}

// The bf16 merge's last launch: a warp a claimed entry at most, at most
// kMergeBlocksPerSm blocks an SM (the warps stride over the entries).
constexpr int kMergeBlocksPerSm = 8;

template <typename TT>
int launch_merge_rows(const Args& a, int d, const Window& w) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = (int64_t)sms * kMergeBlocksPerSm * kThreads;
  const int64_t threads = a.n_bags * a.L * 32;
  return launch_pdl(merge_rows_kernel<TT>, a, threads < cap ? threads : cap, Shipped::kPdl,
                    static_cast<TT*>(a.table), d, w);
}

// The window's launches at width D (Shipped's mapping): launch 1, launch 2
// over every slot, a bf16 shard's merge last.
template <typename TT, typename TG, int D, int VB>
int launch_window(const Args& a, const Window& w) {
  constexpr bool kPdl = Shipped::kPdl;
  const int64_t n_slots = a.n_bags * a.L;
  constexpr int PT = D * (int)sizeof(TT) / VB, PF = D * (int)sizeof(float) / VB;
  constexpr int ST = PT < 32 ? PT : 32, SF = PF < 32 ? PF : 32;  // lanes a slot
  if (w.keys == nullptr) {
    // An f32 shard needs no entries: the single-device launch 1 with the
    // window (accumulate_kernel's kWindow).
    const int err = accumulate<TG, D, Shipped::kPrefetch, true>(a, D * (int)sizeof(TT), w.lanes);
    if (err != 0) return err;
    return launch_pdl(apply_shard_kernel<TT, TG, D, VB>, a, n_slots * ST, kPdl,
                      static_cast<TT*>(a.table), static_cast<const float*>(a.acc),
                      static_cast<const TG*>(a.g), a.offsets, a.indices, n_slots, a.T, a.L,
                      a.neg_lr, a.eps, w.row_lo, w.n_rows);
  }
  int err = zero_count(a, w);
  if (err != 0) return err;
  err = launch_window_accumulate<TG, D>(a, D, w);
  if (err != 0) return err;
  err = launch_pdl(apply_merged_kernel<TG, D, VB>, a, n_slots * SF, kPdl, w.merged,
                   static_cast<const int32_t*>(w.entry), static_cast<const float*>(a.acc),
                   static_cast<const TG*>(a.g), a.offsets, a.indices, n_slots, a.T, a.L,
                   a.neg_lr, a.eps, w.row_lo);
  if (err != 0) return err;
  return launch_merge_rows<TT>(a, D, w);
}

// The window at any width: launch 1 (a bag's mean in column order), launch
// 2 a thread a slot (stream-ordered), a bf16 shard's merge last.
template <typename TT, typename TG>
int launch_window_general(const Args& a, int d, const Window& w) {
  const bool merge = w.keys != nullptr;
  int err = merge ? zero_count(a, w) : 0;
  if (err != 0) return err;
  err = launch_window_accumulate<TG, 0>(a, d, w);
  if (err != 0) return err;
  const int64_t n_slots = a.n_bags * a.L;
  apply_general_kernel<TT, TG, true><<<(unsigned)((n_slots + kThreads - 1) / kThreads), kThreads,
                                       0, a.stream>>>(
      static_cast<TT*>(a.table), w.merged, merge ? w.entry : nullptr, a.acc,
      static_cast<const TG*>(a.g), a.offsets, a.indices, d, n_slots, a.T, a.L, a.neg_lr, a.eps,
      w.row_lo, w.n_rows);
  err = (int)cudaGetLastError();
  if (err != 0 || !merge) return err;
  return launch_merge_rows<TT>(a, d, w);
}

// Whether width D takes the vector instance: D at most 64 (launch 1's
// halving order is torch.mean's there) and the table's and the gradient's
// rows 16 * 2^k bytes (ops/sparse_adagrad.py::k5_launch_plan's rule).
template <typename TT, typename TG, int D>
constexpr bool vector_width() {
  return D <= 64 && D * (int)sizeof(TT) >= 16 && D * (int)sizeof(TG) >= 16;
}

// lanes_per_bag 0: the general instance at any width; else the vector
// instance of width d.
template <typename TT, typename TG>
int launch_width(int d, const Args& a, int lanes_per_bag) {
  constexpr int VB = Shipped::kVecBytes;
  using K = Shipped;
  if (lanes_per_bag == 0) return launch_general<TT, TG>(a, d);
#define DRS_K5_WIDTH(w)                                                     \
  if constexpr (vector_width<TT, TG, (w)>()) {                              \
    if (d == (w)) return launch<TT, TG, (w), VB, K::kPrefetch>(a, lanes_per_bag, K::kPdl); \
  }
  DRS_K5_WIDTH(4) DRS_K5_WIDTH(8) DRS_K5_WIDTH(16) DRS_K5_WIDTH(32) DRS_K5_WIDTH(64)
#undef DRS_K5_WIDTH
  return (int)cudaErrorInvalidValue;
}

// The window at width d: the general instance, or the vector one of d.
template <typename TT, typename TG>
int launch_window_width(int d, const Args& a, const Window& w, bool general) {
  constexpr int VB = Shipped::kVecBytes;
  if (general) return launch_window_general<TT, TG>(a, d, w);
#define DRS_K5_WIDTH(x)                                                     \
  if constexpr (vector_width<TT, TG, (x)>()) {                              \
    if (d == (x)) return launch_window<TT, TG, (x), VB>(a, w);         \
  }
  DRS_K5_WIDTH(4) DRS_K5_WIDTH(8) DRS_K5_WIDTH(16) DRS_K5_WIDTH(32) DRS_K5_WIDTH(64)
#undef DRS_K5_WIDTH
  return (int)cudaErrorInvalidValue;
}

// fn<TT, TG>(...) for the (table, gradient) dtype codes.
#define DRS_K5_DTYPES(fn, ...)                                                    \
  if (table_dtype == 0 && g_dtype == 0) return fn<float, float>(__VA_ARGS__);     \
  if (table_dtype == 0 && g_dtype == 1) return fn<float, __nv_bfloat16>(__VA_ARGS__); \
  if (table_dtype == 1 && g_dtype == 0) return fn<__nv_bfloat16, float>(__VA_ARGS__); \
  if (table_dtype == 1 && g_dtype == 1)                                           \
    return fn<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);                         \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. neg_lr is -learning_rate.
// lanes_per_bag: launch 1's plan (ops/sparse_adagrad.py::k5_launch_plan).
// Returns the first nonzero cudaError_t of the two launches (0 = success).
// The caller validates shapes.
int drs_sparse_adagrad(void* table, int table_dtype, int d, void* acc, const void* g,
                       int g_dtype, const void* offsets, const void* indices, int64_t n_bags,
                       int T, int L, float neg_lr, float eps, int lanes_per_bag, void* stream) {
  if (n_bags <= 0 || L <= 0) return 0;
  const Args a = {table, static_cast<float*>(acc), g, static_cast<const int32_t*>(offsets),
                  static_cast<const int32_t*>(indices), n_bags, T, L, neg_lr, eps,
                  static_cast<cudaStream_t>(stream)};
  DRS_K5_DTYPES(launch_width, d, a, lanes_per_bag)
}

// One row shard's step: table is the shard's (n_rows, d) rows [row_lo,
// row_lo + n_rows) of the fused table and acc its (n_rows,) accumulator;
// the ids are the whole stream's table-local ids. The plan
// (ops/sparse_adagrad.py::k5_window_plan): launch 1's lanes_per_bag (a
// power of two <= 32; at least the gradient row's 16-byte chunks unless
// general) and general (any width: column order, scalar adds). A bf16
// shard's merge (required for one, null for an f32 shard): count (one
// int32, zeroed here by a memset ahead of launch 1), keys (n_keys int32, a
// power of two at least twice the slots, set to -1 here by a memset ahead
// of launch 1), entry and claimed (slots int32 each), merged ((n_keys, d)
// f32, 16-byte aligned), none of which needs setting.
int drs_sparse_adagrad_window(void* table, int table_dtype, int d, void* acc, const void* g,
                              int g_dtype, const void* offsets, const void* indices,
                              int64_t row_lo, int64_t n_rows, int64_t n_bags, int T, int L,
                              float neg_lr, float eps, int lanes_per_bag, int general,
                              void* count, void* keys, int64_t n_keys, void* entry,
                              void* claimed, void* merged, void* stream) {
  if (n_bags <= 0 || L <= 0) return 0;
  const int64_t n_slots = n_bags * L;
  const bool merge = keys != nullptr;
  if (row_lo < 0 || n_rows < 0 || n_rows >= (int64_t)1 << 31 || n_slots >= (int64_t)1 << 31 ||
      lanes_per_bag < 1 || lanes_per_bag > 32 || (lanes_per_bag & (lanes_per_bag - 1)) != 0 ||
      (table_dtype == 1) != merge ||
      (merge && (n_keys < 2 * n_slots || (n_keys & (n_keys - 1)) != 0 || count == nullptr ||
                 entry == nullptr || claimed == nullptr || merged == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a = {table, static_cast<float*>(acc), g, static_cast<const int32_t*>(offsets),
                  static_cast<const int32_t*>(indices), n_bags, T, L, neg_lr, eps,
                  static_cast<cudaStream_t>(stream), row_lo, n_rows};
  const Window w = {row_lo,
                    n_rows,
                    lanes_per_bag,
                    static_cast<int32_t*>(count),
                    static_cast<int32_t*>(entry),
                    static_cast<int32_t*>(keys),
                    n_keys,
                    static_cast<int32_t*>(claimed),
                    static_cast<float*>(merged)};
  DRS_K5_DTYPES(launch_window_width, d, a, w, general != 0)
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
