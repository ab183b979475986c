// K3b: the backward of K3, the recurrence of DIEN's basic tanh RNN: the
// reverse scan, one launch per scan, for Hopper (sm_90a).
//
// What it replaces: the VJP of the jax.lax.scan in deeprecsys_tpu/ops/
// rnn.py::basic_rnn_scan (:45-91) that XLA derives when the dien trainer
// differentiates the model (deeprecsys_tpu/train.py:357-361, :250).
//
// The forward step (K3) is h_t = cast(tanh(xproj_t + h_{t-1} @ W + b)) where
// t < seq_lengths[b], else h_t = h_{t-1}. With y_t the f32 tanh value (JAX
// differentiates tanh before the cast, so 1 - y^2 uses the f32 value, not
// the stored h_t) and gh_t the gradient reaching h_t from outside the scan,
// the reverse scan carries dh, the gradient of the state:
//
//   g        = dh + gh_t
//   alive:   delta_t = (g + g * y_t) * (1 - y_t)       (JAX's tanh VJP form)
//            dh      = delta_t @ W^T
//   frozen:  delta_t = 0,  dh = g                      (h_t = h_{t-1} passes it on)
//
// and ends with dh0 = dh. delta_t is the gradient of xproj_t; the caller
// forms dW = sum_t h_{t-1}^T delta_t and db = sum_t delta_t with two large
// products outside the kernel, as the JAX package leaves them to XLA.
//
// Contract:
//   y       (T, B, H) f32: tanh(xproj_t + h_{t-1} @ W + b) recomputed in f32
//           from the stored states (teacher-forced); read only where alive
//   gh      (T, B, H) f32: the gradient of all_h (the caller adds the
//           gradient of the returned last state into gh[T-1])
//   w       (H, H)    f32 or bf16, row-major: h2h_w, (in, out)
//   seq_lengths (B,)  int32, or null (every row alive at every step)
//   delta   (T, B, H) f32 out; dh0 (B, H) f32 out
//   y, gh and w start on 16-byte boundaries (ops/rnn.py checks it).
// The gradient is carried in f32 at every step. (JAX's cotangent of a bf16
// state is bf16, rounded at each step; in f32 the two agree.)
//
// What bounds it: as K3, the chain of T dependent steps; the bytes (y, gh
// and delta, 15.7 MB at DIEN's T = 40, B = 512, H = 64) take ~4.7 us at
// 3.35 TB/s. At the trainer's B = 128 each of 128 SMs holds one block and
// nothing else, so a step's time is its chain of latencies. The design
// keeps every memory round trip off that chain:
//   * block b owns batch row b. Thread j holds hidden unit j (the shipped
//     instance), or NU units (j and j + 32: one warp a row), or KS threads
//     (adjacent lanes) share one; a thread holds
//     its share of row j of W (the weights feeding dh_j) in registers: the
//     float4 chunks c = KS * i + q of the row for thread q, so the threads
//     of a unit read adjacent 16-byte words of the delta row (no bank
//     conflict). Its part of the 64-term dot runs as kChains independent
//     FMA chains; a unit's parts are combined by __shfl_xor_sync (a + b in
//     both lanes: every thread of a unit holds the same dh bit for bit and
//     computes the same delta);
//   * W is read once, a thread its row share as 16-byte loads (8-byte for
//     bf16), issued before anything else: a lane's consecutive loads take
//     the halves of one 32-byte sector, which the L1 keeps, so W crosses
//     from the L2 once, in 16 loads a thread where the parent design
//     issued 64 scalar loads a thread, 256 bytes apart across the threads;
//   * y_t and gh_t of the alive steps stream into a ring of kRing chunks of
//     kChunk steps in shared memory by cp.async, kRing - 1 chunks ahead of
//     the chunk that reads them, so no step waits for L2 or device memory
//     and a chunk, not a step, pays the wait: a warp copies the 16-byte
//     pieces of its own units, waits for its group, and __syncwarp() makes
//     them visible to its lanes (a wait a step cost about what it hid
//     where y and gh sit in the L2);
//   * a row's frozen steps (t >= seq_lengths[b]) come first going backwards
//     and need only gh: they read it directly, unrolled, with no barrier
//     and no wait on the ring, which holds the alive steps only; each
//     alive step writes delta to a double-buffered row in shared memory,
//     one barrier (__syncwarp() where one warp holds the row, else
//     __syncthreads()), and reads it back as float4 broadcasts.
// No tensor cores and no TF32: they would change the f32 results.
//
// Hidden sizes. The design above is the instance for the zoo's H = 64. Any
// other H up to 1024 takes the general instance
// (rnn_scan_backward_general_kernel): block b owns row b and thread j unit
// j as above, W held as f32 in dynamic shared memory (row j read by thread
// j; where H * H floats pass kSharedWBytes, through the L1 from device
// memory instead), each step's y and gh loaded a step ahead from device
// memory, the dot one FMA chain; correct, not tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;  // the zoo's hidden size: the tuned instance
constexpr unsigned kFull = 0xffffffffu;

// The shipped instance: threads a hidden unit (KS), hidden units a thread
// (NU), FMA chains a unit, and the ring's chunks. Measured on an H100 at
// T = 40, B = 128 and 512, f32 and bf16 W (experiments/k3b_sweep.py,
// PERF.md): chunks of 8 steps, double-buffered, beat a wait every step by
// 5 us at B = 128 (the chunk's steps compile as one unrolled block, 118
// registers against 96); one thread a unit beat a unit's dot split over 2
// threads (the shuffle and the larger barrier cost what the shorter chain
// saves) and one warp a row holding two units a lane (64 dependent FMAs a
// lane where two warps have 32); 4 chains tie with 2.
struct Shipped {
  static constexpr int KS = 1;
  static constexpr int NU = 1;
  static constexpr int kChains = 2;
  static constexpr int kChunk = 8;
  static constexpr int kRing = 2;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four consecutive weights at p (16-byte aligned for f32, 8 for bf16) as f32.
__device__ __forceinline__ float4 load_w4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load_w4(const __nv_bfloat16* p) {
  const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

template <typename TW, int KS, int NU, int kChains, int kChunk, int kRing>
__global__ void __launch_bounds__(kH * KS / NU)
rnn_scan_backward_kernel(const float* __restrict__ y, const float* __restrict__ gh,
                         const TW* __restrict__ w, const int32_t* __restrict__ seq_lengths,
                         float* __restrict__ delta, float* __restrict__ dh0, int T, int B) {
  constexpr int kThreads = kH * KS / NU;
  constexpr int kSlots = kChunk * kRing;         // alive steps the ring holds
  constexpr int kUnitsPerWarp = 32 * NU / KS;
  constexpr int kPieces = kUnitsPerWarp / 4;     // 16-byte pieces of y (and of gh) a warp a step
  constexpr int kChunks = kH / 4 / KS;           // float4 chunks of a W row a thread holds
  static_assert((KS == 1 || KS == 2 || KS == 4) && (NU == 1 || (NU == 2 && KS == 1)) &&
                    kChunks % kChains == 0 && kRing >= 2 && 2 * kPieces <= 32,
                "unsupported instance");
  __shared__ __align__(16) float ds[2][kH];
  __shared__ __align__(16) float ry[kSlots][kH];
  __shared__ __align__(16) float rg[kSlots][kH];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int q = tid % KS;  // share of the unit's dot
  const int b = blockIdx.x;
  const int64_t step_stride = (int64_t)B * kH;
  int jn[NU];  // the thread's hidden units
#pragma unroll
  for (int u = 0; u < NU; ++u) jn[u] = tid / KS + u * (kThreads / KS);

  // Row j of W, chunks KS * i + q, for each of the thread's units: its
  // loads are issued first and overlap the ring's first fill.
  float wr[NU][4 * kChunks];
#pragma unroll
  for (int u = 0; u < NU; ++u) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const float4 v = load_w4(w + jn[u] * kH + 4 * (KS * i + q));
      wr[u][4 * i + 0] = v.x;
      wr[u][4 * i + 1] = v.y;
      wr[u][4 * i + 2] = v.z;
      wr[u][4 * i + 3] = v.w;
    }
  }
  const int len = seq_lengths != nullptr ? min(max(__ldg(seq_lengths + b), 0), T) : T;

  // Copies chunk c of the alive steps (s = len - 1 - t in [c * kChunk,
  // (c + 1) * kChunk)) of y and gh of the warp's units into their ring
  // slots s % kSlots: 2 * kPieces 16-byte pieces a step, spread over the
  // warp's lanes. Every lane commits a group, empty or not, so the group
  // counts stay uniform.
  const int unit0 = (tid >> 5) * kUnitsPerWarp;
  auto issue_chunk = [&](int c) {
    constexpr int kTotal = 2 * kPieces * kChunk;
#pragma unroll
    for (int k = 0; k < (kTotal + 31) / 32; ++k) {
      const int p = k * 32 + lane;
      const int s = c * kChunk + p / (2 * kPieces);
      const int piece = p % (2 * kPieces);
      const int t = len - 1 - s;
      if (p < kTotal && t >= 0) {
        const bool is_g = piece >= kPieces;
        const int col = unit0 + 4 * (is_g ? piece - kPieces : piece);
        float* dst = (is_g ? rg[s % kSlots] : ry[s % kSlots]) + col;
        cp_async16(dst, (is_g ? gh : y) + t * step_stride + (int64_t)b * kH + col);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kRing - 1; ++c) issue_chunk(c);

  // The frozen steps: gh read directly, no barrier.
  float dh[NU];
#pragma unroll
  for (int u = 0; u < NU; ++u) dh[u] = 0.f;
#pragma unroll 4
  for (int t = T - 1; t >= len; --t) {
#pragma unroll
    for (int u = 0; u < NU; ++u) {
      const int64_t at = t * step_stride + (int64_t)b * kH + jn[u];
      dh[u] = dh[u] + __ldg(gh + at);
      if (q == 0) delta[at] = 0.f;
    }
  }

  for (int c = 0; c * kChunk < len; ++c) {
    cp_async_wait<kRing - 2>();  // this lane's pieces of chunk c have landed
    __syncwarp();                // ... and the warp's, and every lane is past chunk c - 1
    issue_chunk(c + kRing - 1);  // into the slots of chunk c - 1
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int s = c * kChunk + i;
      if (s >= len) break;
      const int t = len - 1 - s;
      float d[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        const float yt = ry[s % kSlots][jn[u]];
        const float g = dh[u] + rg[s % kSlots][jn[u]];
        d[u] = (g + g * yt) * (1.f - yt);
      }
      if (q == 0) {
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          delta[t * step_stride + (int64_t)b * kH + jn[u]] = d[u];
          ds[t & 1][jn[u]] = d[u];
        }
      }
      if constexpr (kThreads == 32) {
        __syncwarp();  // one warp a row: the warp's barrier is the block's
      } else {
        __syncthreads();
      }
      const float4* dv = reinterpret_cast<const float4*>(ds[t & 1]);
      float acc[NU][kChains];
#pragma unroll
      for (int u = 0; u < NU; ++u) {
#pragma unroll
        for (int k = 0; k < kChains; ++k) acc[u][k] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < kChunks; ++k) {
        const float4 v = dv[KS * k + q];
#pragma unroll
        for (int u = 0; u < NU; ++u) {
          float& a = acc[u][k % kChains];
          a = fmaf(v.x, wr[u][4 * k + 0], a);
          a = fmaf(v.y, wr[u][4 * k + 1], a);
          a = fmaf(v.z, wr[u][4 * k + 2], a);
          a = fmaf(v.w, wr[u][4 * k + 3], a);
        }
      }
#pragma unroll
      for (int u = 0; u < NU; ++u) {
#pragma unroll
        for (int n = kChains / 2; n >= 1; n /= 2) {
#pragma unroll
          for (int k = 0; k < n; ++k) acc[u][k] = acc[u][k] + acc[u][k + n];
        }
        float part = acc[u][0];
#pragma unroll
        for (int m = 1; m < KS; m *= 2) part = part + __shfl_xor_sync(kFull, part, m);
        dh[u] = part;
      }
    }
  }
  cp_async_wait<0>();  // leave no copy in flight into a block's freed shared memory
  if (q == 0) {
#pragma unroll
    for (int u = 0; u < NU; ++u) dh0[(int64_t)b * kH + jn[u]] = dh[u];
  }
}

constexpr int kSharedWBytes = 200 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TW>
__global__ void __launch_bounds__(1024)
rnn_scan_backward_general_kernel(const float* __restrict__ y, const float* __restrict__ gh,
                                 const TW* __restrict__ w, const int32_t* __restrict__ seq_lengths,
                                 float* __restrict__ delta, float* __restrict__ dh0, int T, int B,
                                 int H, int w_shared) {
  extern __shared__ __align__(16) float smem[];
  float* ds = smem;          // [2][H]
  float* ws = smem + 2 * H;  // [H][H], row-major as w, where w_shared
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t step_stride = (int64_t)B * H;
  if (w_shared) {
    for (int i = j; i < H * H; i += H) ws[i] = to_float(w[i]);
    __syncthreads();
  }
  const int len = seq_lengths != nullptr ? min(max(__ldg(seq_lengths + b), 0), T) : T;
  float dh = 0.f;
  for (int t = T - 1; t >= len; --t) {  // frozen steps: dh passes on
    const int64_t at = t * step_stride + (int64_t)b * H + j;
    dh = dh + __ldg(gh + at);
    delta[at] = 0.f;
  }
  // Step t's y and gh, loaded a step ahead.
  const int64_t at0 = (int64_t)max(len - 1, 0) * step_stride + (int64_t)b * H + j;
  float yt = len > 0 ? __ldg(y + at0) : 0.f, ght = len > 0 ? __ldg(gh + at0) : 0.f;
  for (int t = len - 1; t >= 0; --t) {
    const int64_t at = t * step_stride + (int64_t)b * H + j;
    const float y_next = t > 0 ? __ldg(y + at - step_stride) : 0.f;
    const float gh_next = t > 0 ? __ldg(gh + at - step_stride) : 0.f;
    const float g = dh + ght;
    const float d = (g + g * yt) * (1.f - yt);
    delta[at] = d;
    float* dv = ds + (t & 1) * H;
    dv[j] = d;
    __syncthreads();
    float acc = 0.f;
    if (w_shared) {
      for (int k = 0; k < H; ++k) acc = fmaf(dv[k], ws[j * H + k], acc);
    } else {
      for (int k = 0; k < H; ++k) acc = fmaf(dv[k], to_float(__ldg(w + (int64_t)j * H + k)), acc);
    }
    dh = acc;
    yt = y_next;
    ght = gh_next;
  }
  dh0[(int64_t)b * H + j] = dh;
}

template <typename TW>
int launch_general(const float* y, const float* gh, const void* w, const int32_t* seq_lengths,
                   float* delta, float* dh0, int T, int B, int H, cudaStream_t stream) {
  const int with_w = (2 * H + H * H) * (int)sizeof(float);
  const int w_shared = with_w <= kSharedWBytes;
  const int bytes = w_shared ? with_w : 2 * H * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnn_scan_backward_general_kernel<TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  rnn_scan_backward_general_kernel<TW><<<B, H, bytes, stream>>>(
      y, gh, static_cast<const TW*>(w), seq_lengths, delta, dh0, T, B, H, w_shared);
  return (int)cudaGetLastError();
}

template <typename TW, int KS, int NU, int kChains, int kChunk, int kRing>
int launch(const float* y, const float* gh, const void* w, const int32_t* seq_lengths,
           float* delta, float* dh0, int T, int B, cudaStream_t stream) {
  rnn_scan_backward_kernel<TW, KS, NU, kChains, kChunk, kRing><<<B, kH * KS / NU, 0, stream>>>(
      y, gh, static_cast<const TW*>(w), seq_lengths, delta, dh0, T, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w dtype code: 0 = float32, 1 = bfloat16. Launches one block a batch row
// (H = 64 the tuned instance, any other H up to 1024 the general one).
// Returns the cudaError_t of the launch (0 = success). The caller validates
// shapes, dtypes, devices and alignment.
int drs_rnn_scan_backward(const void* y, const void* gh, const void* w, int w_dtype,
                          const void* seq_lengths, void* delta, void* dh0, int T, int B, int H,
                          void* stream) {
  if (H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0) return 0;
  const float* yy = static_cast<const float*>(y);
  const float* g = static_cast<const float*>(gh);
  const int32_t* lens = static_cast<const int32_t*>(seq_lengths);
  float* d = static_cast<float*>(delta);
  float* h = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H != kH) {
    if (w_dtype == 0) return launch_general<float>(yy, g, w, lens, d, h, T, B, H, s);
    if (w_dtype == 1) return launch_general<__nv_bfloat16>(yy, g, w, lens, d, h, T, B, H, s);
    return (int)cudaErrorInvalidValue;
  }
  using S = Shipped;
  if (w_dtype == 0)
    return launch<float, S::KS, S::NU, S::kChains, S::kChunk, S::kRing>(yy, g, w, lens, d, h, T,
                                                                       B, s);
  if (w_dtype == 1)
    return launch<__nv_bfloat16, S::KS, S::NU, S::kChains, S::kChunk, S::kRing>(yy, g, w, lens,
                                                                               d, h, T, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
