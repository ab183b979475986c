// The tables an ownership-window launch covers (K1b's window,
// embedding_bag_backward.cu; K1-int8's and K4's windows,
// embedding_bag_int8.cu).
//
// A row shard holds the fused rows [row_lo, row_lo + n_rows). Table t holds
// [offsets[t], offsets[t + 1]) (the last table runs to the end of the fused
// table), so the tables that meet the shard are a contiguous range
// [t_lo, t_lo + nt), known on the host before an id is read
// (ops/embedding.py::table_range). A launch maps its work onto the bags of
// those tables only, the k-th of them being bag (k / nt) * T + t_lo + k % nt
// of the (B, T) batch. Only the range's first and last tables can straddle a
// shard edge (test_lo, test_hi); a slot of any other table lies inside the
// shard, so its row is added or read with no window test.

#pragma once

#include <stdint.h>

namespace {

struct Window {
  int64_t row_lo;
  int64_t n_rows;
  int t_lo;     // the first table that meets the shard
  int nt;       // the number of tables that meet it
  int test_lo;  // table t_lo starts before row_lo: its slots take the test
  int test_hi;  // table t_lo + nt - 1 ends past the shard: its slots take the test
};

// The batch bag of the k-th bag of the meeting tables.
__device__ __forceinline__ int64_t window_bag(int64_t k, int T, const Window& w) {
  return (k / w.nt) * T + w.t_lo + k % w.nt;
}

// Whether table t's slots take the window test: t straddles a shard edge.
__device__ __forceinline__ bool window_tested(int t, const Window& w) {
  return (t == w.t_lo && w.test_lo) || (t == w.t_lo + w.nt - 1 && w.test_hi);
}

// Whether fused row base + id (base = offsets[t] - row_lo) lies in the shard.
__device__ __forceinline__ bool in_window(int64_t base, int32_t id, const Window& w) {
  return (uint64_t)(base + id) < (uint64_t)w.n_rows;
}

}  // namespace
