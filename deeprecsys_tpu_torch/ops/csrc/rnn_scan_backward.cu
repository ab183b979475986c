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
// The gradient is carried in f32 at every step. (JAX's cotangent of a bf16
// state is bf16, rounded at each step; in f32 the two agree.)
//
// What bounds it: as K3, the chain of T dependent steps; the bytes (y, gh
// and delta, 15.7 MB at DIEN's T = 40, B = 512, H = 64) take ~4.7 us at
// 3.35 TB/s. The design is K3's, reversed:
//   * block b owns batch row b, thread j owns hidden unit j, with row j of
//     W (the weights feeding dh_j) in 64 registers for the whole scan;
//   * a row's frozen steps (t >= seq_lengths[b]) come first going
//     backwards and need no barrier; each alive step writes delta to a
//     double-buffered row in shared memory, one __syncthreads(), and each
//     thread forms its dh_j from 16 float4 broadcasts as two FMA chains;
//   * the next step's y and gh are loaded before this step's chain runs,
//     so the loads overlap the dot and the barrier.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kH = 64;      // the zoo's hidden size; the wrapper rejects others
constexpr int kChains = 2;  // independent partial sums of the dot

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TW>
__global__ void __launch_bounds__(kH)
rnn_scan_backward_kernel(const float* __restrict__ y, const float* __restrict__ gh,
                         const TW* __restrict__ w, const int32_t* __restrict__ seq_lengths,
                         float* __restrict__ delta, float* __restrict__ dh0, int T, int B) {
  __shared__ __align__(16) float ds[2][kH];

  const int j = threadIdx.x;
  const int b = blockIdx.x;
  const int64_t step_stride = (int64_t)B * kH;
  const int64_t at = (int64_t)b * kH + j;

  float wrow[kH];  // row j of W
#pragma unroll
  for (int k = 0; k < kH; ++k) wrow[k] = to_float(w[j * kH + k]);
  const int len = seq_lengths != nullptr ? min(max(seq_lengths[b], 0), T) : T;

  float dh = 0.f;
  float y_next = __ldg(y + (T - 1) * step_stride + at);
  float g_next = __ldg(gh + (T - 1) * step_stride + at);
  for (int t = T - 1; t >= 0; --t) {
    const float yt = y_next;
    const float g = dh + g_next;
    if (t > 0) {
      y_next = __ldg(y + (t - 1) * step_stride + at);
      g_next = __ldg(gh + (t - 1) * step_stride + at);
    }
    float* out = delta + t * step_stride + at;
    if (t >= len) {  // uniform over the block
      *out = 0.f;
      dh = g;
      continue;
    }
    const float d = (g + g * yt) * (1.f - yt);
    *out = d;
    ds[t & 1][j] = d;
    __syncthreads();
    const float4* dv = reinterpret_cast<const float4*>(ds[t & 1]);
    float acc[kChains];
#pragma unroll
    for (int i = 0; i < kChains; ++i) acc[i] = 0.f;
#pragma unroll
    for (int k = 0; k < kH / 4; ++k) {
      const float4 v = dv[k];
      float& a = acc[k % kChains];
      a = fmaf(v.x, wrow[4 * k + 0], a);
      a = fmaf(v.y, wrow[4 * k + 1], a);
      a = fmaf(v.z, wrow[4 * k + 2], a);
      a = fmaf(v.w, wrow[4 * k + 3], a);
    }
    dh = acc[0] + acc[1];
  }
  dh0[at] = dh;
}

template <typename TW>
int launch(const float* y, const float* gh, const void* w, const int32_t* seq_lengths,
           float* delta, float* dh0, int T, int B, cudaStream_t stream) {
  rnn_scan_backward_kernel<TW><<<B, kH, 0, stream>>>(
      y, gh, static_cast<const TW*>(w), seq_lengths, delta, dh0, T, B);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w dtype code: 0 = float32, 1 = bfloat16. Launches one block a batch row.
// Returns the cudaError_t of the launch (0 = success). The caller validates
// shapes, dtypes and devices.
int drs_rnn_scan_backward(const void* y, const void* gh, const void* w, int w_dtype,
                          const void* seq_lengths, void* delta, void* dh0, int T, int B, int H,
                          void* stream) {
  if (H != kH) return (int)cudaErrorInvalidValue;
  if (T <= 0 || B <= 0) return 0;
  const float* yy = static_cast<const float*>(y);
  const float* g = static_cast<const float*>(gh);
  const int32_t* lens = static_cast<const int32_t*>(seq_lengths);
  float* d = static_cast<float*>(delta);
  float* h = static_cast<float*>(dh0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return launch<float>(yy, g, w, lens, d, h, T, B, s);
  if (w_dtype == 1) return launch<__nv_bfloat16>(yy, g, w, lens, d, h, T, B, s);
  return (int)cudaErrorInvalidValue;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
