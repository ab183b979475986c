// Device helpers shared by the pooled lookups over int8 rows (K1-int8 and
// K4, embedding_bag_int8.cu) and over a hot/cold split (K6,
// embedding_bag_hotcold.cu): 16-byte row loads, the ids of a step held a
// lane each, the reduce-scatter that combines a bag's row slots, the
// output store, and K4's loads of row-wise rows (D int8 values, then the
// row's f32 scale: D + 4 bytes on 4-byte boundaries only).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void to_out(float x, float* p) { *p = x; }
__device__ __forceinline__ void to_out(float x, __nv_bfloat16* p) { *p = __float2bfloat16_rn(x); }

// 16 bytes at p; kHint: no L1 line for a row that is never read again, and
// no L2 prefetch past 64 bytes (K1's hint, embedding_bag.cu).
template <bool kHint>
__device__ __forceinline__ uint4 load16(const void* p) {
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

// Id k (0 <= k < 32 * NI) of a window held one a lane: lane k % 32's
// ids[k / 32]. Every lane takes part.
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

// A bag's sums of a[0..N) over its slots, the lanes lane ^ k * STRIDE for
// k < END / STRIDE (a power of two), by reduce-scatter: at each exchange a
// lane whose STRIDE bit is set keeps the upper half of the values it holds
// and its partner the lower half, each adding the other's copy. A lane
// ends with N * STRIDE / END sums in a[0..), those of its columns from
// slot_share on.
template <int STRIDE, int END, int H, typename V, int N>
__device__ __forceinline__ void reduce_scatter(V (&a)[N], int lane) {
  if constexpr (STRIDE < END) {
    const bool up = (lane & STRIDE) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const V send = up ? a[i] : a[i + H];
      const V keep = up ? a[i + H] : a[i];
      a[i] = keep + __shfl_xor_sync(0xffffffffu, send, STRIDE);
    }
    reduce_scatter<STRIDE * 2, END, H / 2>(a, lane);
  }
}

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// The first of the CPL / SPB columns (of a lane's CPL) that slot s of a bag
// holds after reduce_scatter over the bag's SPB slots: the exchanges halve
// by the bits of s from the lowest, so the share is s's bits reversed.
template <int CPL, int SPB>
__device__ __forceinline__ int slot_share(int s) {
  if constexpr (SPB == 1) {
    return 0;
  } else {
    constexpr int kBits = log2_of(SPB);
    return static_cast<int>(__brev(static_cast<unsigned>(s)) >> (32 - kBits)) * (CPL / SPB);
  }
}

// N output values at dst, rounded once to TC; dst starts a run of
// N * sizeof(TC) bytes (2 to 256), aligned to that size or to 16.
template <typename TC, int N>
__device__ __forceinline__ void store_row(TC* dst, const float (&v)[N]) {
  constexpr int kBytes = N * (int)sizeof(TC);
  __align__(16) TC o[N];
#pragma unroll
  for (int i = 0; i < N; ++i) to_out(v[i], o + i);
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int c = 0; c < kBytes / 16; ++c)
      reinterpret_cast<uint4*>(dst)[c] = reinterpret_cast<const uint4*>(o)[c];
  } else if constexpr (kBytes == 8) {
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(o);
  } else if constexpr (kBytes == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(o);
  } else {
    static_assert(kBytes == 2, "unsupported store");
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(o);
  }
}

// Byte j of w, sign-extended.
__device__ __forceinline__ int byte_at(uint32_t w, int j) {
  return static_cast<int>(w << (24 - 8 * j)) >> 24;
}

// Row-wise rows, as K4 loads them. Lane r of a row owns words c0 = r * NW ..
// c0 + NW - 1 and loads the 16-byte-aligned chunks that hold them at any of
// the four phases (addr & 15) / 4, from the row's address rounded down to
// 16 plus the chunk of word c0: its words start e = phase + c0 % 4 words
// into that window, and NC chunks hold them and the word after them (the
// row's scale, on the row's last lane) at any phase. Every chunk holds a
// byte of the row, so none crosses into a page the table does not own.
template <int NW>
struct RowChunks {
  static constexpr int kMaxE = 3 + (NW < 4 ? 4 - NW : 0);
  static constexpr int NC = (kMaxE + NW) / 4 + 1;
  static constexpr int W = 4 * NC;
};

// The first chunk of the window of the row at byte address `at` for the
// lane whose words start at c0, and its start e in that window.
__device__ __forceinline__ const uint4* row_window(uintptr_t at, int c0, uint32_t& e) {
  e = (static_cast<uint32_t>(at >> 2) & 3u) + (c0 & 3);
  return reinterpret_cast<const uint4*>(at & ~uintptr_t(15)) + (c0 >> 2);
}

// Words e .. e + NW of a window: by 4 (when e can reach it), by 2, by 1,
// as whole 32-bit words, so no byte shuffles are needed. A clamped index
// is one no e needs.
template <int NW>
__device__ __forceinline__ void pick_words(const uint4 (&win)[RowChunks<NW>::NC], uint32_t e,
                                           uint32_t (&x)[NW + 1]) {
  using RC = RowChunks<NW>;
  uint32_t w[RC::W];
#pragma unroll
  for (int c = 0; c < RC::NC; ++c) {
    w[4 * c + 0] = win[c].x;
    w[4 * c + 1] = win[c].y;
    w[4 * c + 2] = win[c].z;
    w[4 * c + 3] = win[c].w;
  }
  uint32_t t4[RC::W], t2[RC::W];
#pragma unroll
  for (int j = 0; j < RC::W; ++j)
    t4[j] = (RC::kMaxE >= 4 && (e & 4u)) ? w[j + 4 < RC::W ? j + 4 : RC::W - 1] : w[j];
#pragma unroll
  for (int j = 0; j < RC::W; ++j) t2[j] = (e & 2u) ? t4[j + 2 < RC::W ? j + 2 : RC::W - 1] : t4[j];
#pragma unroll
  for (int j = 0; j <= NW; ++j) x[j] = (e & 1u) ? t2[j + 1] : t2[j];
}

// acc[4 j + b] += value b of word x[j] times the row's scale, each product
// rounded (__fmul_rn: never contracted into the add). A value is made
// exact in f32 without a conversion instruction: its offset-binary byte
// (x ^ 0x80) under the exponent of 2^23, minus 2^23 + 128.
template <int NW>
__device__ __forceinline__ void add_scaled(float (&acc)[4 * NW], const uint32_t (&x)[NW + 1],
                                           float row_scale) {
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const uint32_t y = x[j] ^ 0x80808080u;  // each byte + 128, unsigned
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float value = __uint_as_float(__byte_perm(y, 0x4b000000u, 0x7540u | b)) - 8388736.0f;
      acc[4 * j + b] += __fmul_rn(value, row_scale);
    }
  }
}

}  // namespace
