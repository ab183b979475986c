// K3: the recurrence of DIEN's basic tanh RNN, one launch per scan, for
// Hopper (sm_90a).
//
// What it replaces: the jax.lax.scan of deeprecsys_tpu/ops/rnn.py::
// basic_rnn_scan (:45-91), run twice per DIEN forward. The input projection
// is hoisted out of the scan (one large matmul, done by the caller), so the
// kernel runs only the serial part:
//
//   h_t = cast(tanh((xproj_t + h_{t-1} @ W) + b))       (alive rows)
//   h_t = h_{t-1}                                      (t >= seq_lengths[b])
//
// in JAX's order of operations: the f32 dot, plus xproj, plus the f32 bias,
// tanh in f32, then the cast to the compute dtype, which is also the dtype
// the hidden state is carried in.
//
// Contract:
//   xproj       (T, B, H) f32: x_t @ i2h_w + i2h_b, 16-byte aligned
//   w           (H, H)    f32 or bf16, row-major: h2h_w, (in, out)
//   bias        (H,)      same dtype as w: h2h_b
//   h0          (B, H)    f32 holding compute-dtype values, or null (zeros)
//   seq_lengths (B,)      int32, or null (every row alive at every step)
//   all_h       (T, B, H) in the compute dtype: h after each step
// The last hidden state is all_h[T-1] (a frozen row keeps its state).
//
// What bounds it: the chain of T dependent steps. At DIEN's shape (T = 40,
// B = 512, H = 64) a scan does 168 MFLOP and moves 7.9 MB, about 2.5 us of
// the card, but each step of a row waits for the whole previous step, and
// B = 512 rows give an SM only about 4 rows to work on. A step is a chain
// of latencies (h from shared memory, the dot, tanhf, the store, the
// barrier): measured on an H100 (PERF.md), about 0.27 us a
// step at B = 512 and 0.2 us with one row an SM, plus about 2.7 us of
// launch and set-up. So the design keeps the step short and the SMs busy:
//   * block b owns batch row b (512 blocks of 2 warps on the 132 SMs at
//     DIEN's shape, about 4 an SM, so a step's barrier waits for 2 warps;
//     2 and 4 rows a block measured slower, PERF.md); thread j owns output column j, with column j
//     of W in 64 registers for the whole scan;
//   * the dot runs as kChains = 2 independent chains of 32 FMAs (float4 k
//     of h feeds chain k % 2), summed c0 + c1: two FMAs in flight instead
//     of one chain of 64 (2 measured fastest of 1, 2, 4 and 8 chains);
//   * the h row lives in shared memory as f32, double-buffered: one
//     __syncthreads() a step; a thread reads h as 16 float4 broadcasts;
//   * the row's xproj streams into a ring of kRing chunks of kChunk steps
//     in shared memory by cp.async, kRing - 1 chunks ahead of the step
//     that reads them, so no step waits for device memory.
// No tensor cores: TF32 would change the f32 results, and tanhf (not
// tanh.approx) keeps JAX's values.
//
// Hidden sizes. The design above is the instance for the zoo's H = 64. Any
// other H up to 1024 (the card's block) takes the general instance
// (rnn_scan_general_kernel): block b still owns batch row b and thread j
// unit j, but W is held as f32 in dynamic shared memory (each thread reads
// its column there; where H * H floats pass kSharedWBytes, through the L1
// from device memory instead), each step's xproj is loaded a step ahead
// from device memory, and the dot is one FMA chain; correct, not tuned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;      // the zoo's hidden size: the tuned instance
constexpr int kChains = 2;  // independent partial sums of the dot
constexpr int kChunk = 8;   // steps a cp.async group
constexpr int kRing = 4;    // chunks in flight or held

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to the compute dtype TC, widened back to f32.
template <typename TC>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename TW, typename TC>
__global__ void __launch_bounds__(kH)
rnn_scan_kernel(const float* __restrict__ xproj, const TW* __restrict__ w,
                const TW* __restrict__ bias, const float* __restrict__ h0,
                const int32_t* __restrict__ seq_lengths, TC* __restrict__ all_h,
                int T, int B) {
  __shared__ __align__(16) float hs[2][kH];
  __shared__ __align__(16) float xs[kRing * kChunk][kH];

  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t step_stride = (int64_t)B * kH;
  const float* xrow = xproj + (int64_t)b * kH;

  // Copy chunk c of the row's xproj into its ring slot: kChunk steps x 16
  // pieces of 16 bytes, two pieces a thread. Every thread commits a group,
  // empty or not, so the group counts stay uniform.
  auto issue_chunk = [&](int c) {
    constexpr int kPieces = kChunk * (kH / 4);
#pragma unroll
    for (int p = j; p < kPieces; p += kH) {
      const int t = c * kChunk + p / (kH / 4);
      const int part = p % (kH / 4);
      if (t < T) cp_async16(&xs[t % (kRing * kChunk)][part * 4], xrow + t * step_stride + part * 4);
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kRing; ++c) issue_chunk(c);

  float wcol[kH];  // column j of W
#pragma unroll
  for (int k = 0; k < kH; ++k) wcol[k] = to_float(w[k * kH + j]);
  const float bj = to_float(bias[j]);
  const int len = seq_lengths != nullptr ? seq_lengths[b] : T;

  float h = h0 != nullptr ? h0[(int64_t)b * kH + j] : 0.f;
  hs[0][j] = h;

  for (int c = 0; c * kChunk < T; ++c) {
    cp_async_wait<kRing - 1>();  // this thread's pieces of chunk c have landed
    __syncthreads();             // ... and everyone's (and h's first row)
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = c * kChunk + u;
      if (t >= T) break;
      const float4* hv = reinterpret_cast<const float4*>(hs[t & 1]);
      float acc[kChains];
#pragma unroll
      for (int i = 0; i < kChains; ++i) acc[i] = 0.f;
#pragma unroll
      for (int k = 0; k < kH / 4; ++k) {
        const float4 v = hv[k];
        float& a = acc[k % kChains];
        a = fmaf(v.x, wcol[4 * k + 0], a);
        a = fmaf(v.y, wcol[4 * k + 1], a);
        a = fmaf(v.z, wcol[4 * k + 2], a);
        a = fmaf(v.w, wcol[4 * k + 3], a);
      }
      const float dot = acc[0] + acc[1];
      const float xp = xs[t % (kRing * kChunk)][j];
      if (t < len) h = round_to<TC>(tanhf((xp + dot) + bj));
      hs[(t + 1) & 1][j] = h;
      store(all_h + t * step_stride + (int64_t)b * kH + j, h);
      __syncthreads();
    }
    issue_chunk(c + kRing);  // chunk c's slot is free: every step of it is past a barrier
  }
  cp_async_wait<0>();  // leave no copy in flight into a block's freed shared memory
}

// The general instance's shared memory: h's two rows, then W where it fits.
constexpr int kSharedWBytes = 200 * 1024;

template <typename TW, typename TC>
__global__ void __launch_bounds__(1024)
rnn_scan_general_kernel(const float* __restrict__ xproj, const TW* __restrict__ w,
                        const TW* __restrict__ bias, const float* __restrict__ h0,
                        const int32_t* __restrict__ seq_lengths, TC* __restrict__ all_h, int T,
                        int B, int H, int w_shared) {
  extern __shared__ __align__(16) float smem[];
  float* hs = smem;          // [2][H]
  float* ws = smem + 2 * H;  // [H][H], row-major as w, where w_shared
  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t step_stride = (int64_t)B * H;
  if (w_shared) {
    for (int i = j; i < H * H; i += H) ws[i] = to_float(w[i]);
  }
  const float bj = to_float(bias[j]);
  const int len = seq_lengths != nullptr ? seq_lengths[b] : T;
  float h = h0 != nullptr ? h0[(int64_t)b * H + j] : 0.f;
  hs[j] = h;
  __syncthreads();
  float xp = __ldg(xproj + (int64_t)b * H + j);  // step t's, loaded a step ahead
  for (int t = 0; t < T; ++t) {
    const int64_t at = t * step_stride + (int64_t)b * H + j;
    const float xp_next = t + 1 < T ? __ldg(xproj + at + step_stride) : 0.f;
    const float* hv = hs + (t & 1) * H;
    float dot = 0.f;
    if (w_shared) {
      for (int k = 0; k < H; ++k) dot = fmaf(hv[k], ws[k * H + j], dot);
    } else {
      for (int k = 0; k < H; ++k) dot = fmaf(hv[k], to_float(__ldg(w + k * H + j)), dot);
    }
    if (t < len) h = round_to<TC>(tanhf((xp + dot) + bj));
    xp = xp_next;
    hs[((t + 1) & 1) * H + j] = h;
    store(all_h + at, h);
    __syncthreads();
  }
}

template <typename TW, typename TC>
int launch_general(const float* xproj, const void* w, const void* bias, const float* h0,
                   const int32_t* seq_lengths, void* all_h, int T, int B, int H,
                   cudaStream_t stream) {
  const int with_w = (2 * H + H * H) * (int)sizeof(float);
  const int w_shared = with_w <= kSharedWBytes;
  const int bytes = w_shared ? with_w : 2 * H * (int)sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rnn_scan_general_kernel<TW, TC>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  rnn_scan_general_kernel<TW, TC><<<B, H, bytes, stream>>>(
      xproj, static_cast<const TW*>(w), static_cast<const TW*>(bias), h0, seq_lengths,
      static_cast<TC*>(all_h), T, B, H, w_shared);
  return (int)cudaGetLastError();
}

template <typename TW, typename TC>
int launch(const float* xproj, const void* w, const void* bias, const float* h0,
           const int32_t* seq_lengths, void* all_h, int T, int B, int H, cudaStream_t stream) {
  if (H != kH)
    return launch_general<TW, TC>(xproj, w, bias, h0, seq_lengths, all_h, T, B, H, stream);
  rnn_scan_kernel<TW, TC><<<B, kH, 0, stream>>>(
      xproj, static_cast<const TW*>(w), static_cast<const TW*>(bias), h0, seq_lengths,
      static_cast<TC*>(all_h), T, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Launches one block a batch row
// (H = 64 the tuned instance, any other H up to 1024 the general one).
// Returns the cudaError_t of the launch (0 = success). The caller validates
// shapes, dtypes, devices and alignment.
int drs_rnn_scan(const void* xproj, const void* w, const void* bias, int w_dtype,
                 const void* h0, const void* seq_lengths, void* all_h, int out_dtype,
                 int T, int B, int H, void* stream) {
  if (H < 1 || H > 1024) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0) return 0;
  const float* x = static_cast<const float*>(xproj);
  const float* h = static_cast<const float*>(h0);
  const int32_t* lens = static_cast<const int32_t*>(seq_lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, w, bias, h, lens, all_h, T, B, H, s);
  if (w_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, bias, h, lens, all_h, T, B, H, s);
  if (w_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, bias, h, lens, all_h, T, B, H, s);
  if (w_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, h, lens, all_h, T, B, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
