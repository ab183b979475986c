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
//   xproj       (T, B, H) f32: x_t @ i2h_w + i2h_b
//   w           (H, H)    f32 or bf16, row-major: h2h_w, (in, out)
//   bias        (H,)      same dtype as w: h2h_b
//   h0          (B, H)    f32 holding compute-dtype values, or null (zeros)
//   seq_lengths (B,)      int32, or null (every row alive at every step)
//   all_h       (T, B, H) in the compute dtype: h after each step
// The last hidden state is all_h[T-1] (a frozen row keeps its state).
//
// What bounds it: the chain of T dependent steps, not bytes or FLOPs. At
// DIEN's shape (T = 40, B = 512, H = 64) a scan reads 5.2 MB of xproj and
// does 168 MFLOP, a few microseconds of the card; in eager PyTorch the same
// scan is T steps of several launches each. So the design keeps every step
// on the SM and the step itself short:
//   * one block owns R batch rows; thread (j, r) owns output column j of row
//     r, with column j of W held in 64 registers for the whole scan;
//   * the block's h tile lives in shared memory as f32, double-buffered, so
//     one __syncthreads() a step suffices; a thread reads its row of h as
//     16 float4 broadcasts;
//   * the next step's xproj element is loaded before this step's dot.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;  // the zoo's hidden size; the wrapper rejects others
constexpr int kRows = 4;  // batch rows per block: 256 threads

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

template <typename TW, typename TC>
__global__ void __launch_bounds__(kH * kRows)
rnn_scan_kernel(const float* __restrict__ xproj, const TW* __restrict__ w,
                const TW* __restrict__ bias, const float* __restrict__ h0,
                const int32_t* __restrict__ seq_lengths, TC* __restrict__ all_h,
                int T, int B) {
  __shared__ __align__(16) float hs[2][kRows][kH];

  const int j = threadIdx.x;
  const int r = threadIdx.y;
  const int b = blockIdx.x * kRows + r;
  const bool valid = b < B;  // rows past B still take part in the barriers

  float wcol[kH];
#pragma unroll
  for (int k = 0; k < kH; ++k) wcol[k] = to_float(w[k * kH + j]);
  const float bj = to_float(bias[j]);
  const int len = !valid ? 0 : (seq_lengths != nullptr ? seq_lengths[b] : T);

  float h = (valid && h0 != nullptr) ? h0[(int64_t)b * kH + j] : 0.f;
  hs[0][r][j] = h;
  __syncthreads();

  const int64_t step = (int64_t)B * kH;
  const int64_t col = (int64_t)b * kH + j;
  float xp_next = (valid && T > 0) ? xproj[col] : 0.f;
  for (int t = 0; t < T; ++t) {
    const float xp = xp_next;
    if (valid && t + 1 < T) xp_next = xproj[(t + 1) * step + col];

    const float4* hv = reinterpret_cast<const float4*>(hs[t & 1][r]);
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < kH / 4; ++k) {
      const float4 v = hv[k];
      acc = fmaf(v.x, wcol[4 * k + 0], acc);
      acc = fmaf(v.y, wcol[4 * k + 1], acc);
      acc = fmaf(v.z, wcol[4 * k + 2], acc);
      acc = fmaf(v.w, wcol[4 * k + 3], acc);
    }
    if (t < len) h = round_to<TC>(tanhf((xp + acc) + bj));
    hs[(t + 1) & 1][r][j] = h;
    if (valid) store(all_h + t * step + col, h);
    __syncthreads();
  }
}

template <typename TW, typename TC>
int launch(const float* xproj, const void* w, const void* bias, const float* h0,
           const int32_t* seq_lengths, void* all_h, int T, int B, cudaStream_t stream) {
  const dim3 block(kH, kRows);
  const unsigned grid = (unsigned)((B + kRows - 1) / kRows);
  rnn_scan_kernel<TW, TC><<<grid, block, 0, stream>>>(
      xproj, static_cast<const TW*>(w), static_cast<const TW*>(bias), h0, seq_lengths,
      static_cast<TC*>(all_h), T, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 = success). The caller validates shapes, dtypes and devices.
int drs_rnn_scan(const void* xproj, const void* w, const void* bias, int w_dtype,
                 const void* h0, const void* seq_lengths, void* all_h, int out_dtype,
                 int T, int B, int H, void* stream) {
  if (H != kH) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0) return 0;
  const float* x = static_cast<const float*>(xproj);
  const float* h = static_cast<const float*>(h0);
  const int32_t* lens = static_cast<const int32_t*>(seq_lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, w, bias, h, lens, all_h, T, B, s);
  if (w_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, w, bias, h, lens, all_h, T, B, s);
  if (w_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, w, bias, h, lens, all_h, T, B, s);
  if (w_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, w, bias, h, lens, all_h, T, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
