// K10: the dense optimizer update, one fused pass over every leaf, for
// Hopper (sm_90a).
//
// What it replaces: optax's update and apply_updates inside the jitted
// train step (deeprecsys_tpu/train.py:362-363; the sparse step's dense half
// :255-256), which XLA fuses into one pass a leaf. The port's plain
// version (ops/optimizer.py::optimizer_update_reference) runs the same
// formulas as eager ops, seven a leaf for adagrad, with leaf-sized
// temporaries between them.
//
// What it computes, per element, in the plain version's order (optax 0.2.6;
// each step rounds to the leaf's dtype, as each eager op does):
//   sgd:     p = p + (g * -lr)
//   adagrad: a = a + (g * g); u = rsqrt(a + 1e-7); u = (u * g) * -lr;
//            p = p + u
//   adam:    m = (m * b1) + (g * (1 - b1)); v = (v * b2) + ((g * g) * (1 - b2));
//            u = (m / bc1) / (sqrt(v / bc2) + 1e-8); p = p + (u * -lr),
//            bc = 1 - b^count in f32 (optax's bias corrections), each
//            rounded to the leaf's dtype before it divides (optax casts it)
// Bit for bit with the plain version on the card:
//   * every product, sum, quotient and square root is written with an
//     __f*_rn intrinsic, which nvcc never contracts into an FMA (the eager
//     ops round each result; an FMA would not);
//   * rsqrt is rsqrtf, what ATen's CUDA rsqrt calls for float and, through
//     float, for bfloat16 (c10/cuda/CUDAMathCompat.h; compared bit for bit
//     with torch.rsqrt on the card);
//   * adam's step count lives on the card (an int32 the step advances
//     before the update), so a CUDA graph of the step replays with the
//     count it reaches: every thread reads it and computes the bias
//     corrections with powf, as torch.pow does for the plain version on
//     the card, and divides by them (__fdiv_rn; ATen divides by a tensor
//     on the card, where it multiplied by the reciprocal of a host float);
//   * bfloat16 leaves: each step computes in f32 from the bf16 operands and
//     rounds its result to bf16 (round to nearest even), as each eager op
//     on a bf16 tensor does.
//
// What bounds it: bytes. Each element reads p, g and the state and writes
// p and the state once: 12 bytes for sgd, 20 for adagrad, 28 for adam in
// f32. rm1's dense step holds a 32 M x 32 f32 table, 4.1 GB, so adagrad's
// pass is 20.5 GB, 6.1 ms at 3.35 TB/s; the eager ops moved about 17
// table-sized passes. The design:
//   * one launch for every leaf of one dtype: the leaves' pointers and
//     sizes go in a kernel parameter (up to kMaxLeaves a launch), each leaf
//     cut into chunks of kChunk elements, a block a chunk; a block finds
//     its leaf by a walk over the leaves' first chunks;
//   * 16-byte vector loads and stores (4 f32 or 8 bf16 elements a thread)
//     where p, g and the state all start on a 16-byte boundary, and a
//     scalar tail for the last elements of a leaf whose size is not a
//     multiple of the vector; a leaf with a pointer off 16 bytes goes
//     element by element;
//   * the chunks' loops are independent, so 2048 threads an SM each keep
//     two or more 16-byte loads in flight, far past what the card's
//     bandwidth-latency product needs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLeaves = 40;  // ops/optimizer.py::K10_MAX_LEAVES
constexpr int kThreads = 256;
constexpr int64_t kChunk = 1 << 16;  // elements a block takes; a multiple of every vector

enum Opt { kSgd = 0, kAdagrad = 1, kAdam = 2 };

// The leaves of one launch (a kernel parameter, 2.1 KB).
struct Leaves {
  void* p[kMaxLeaves];
  const void* g[kMaxLeaves];
  void* s1[kMaxLeaves];  // adagrad's accumulator, adam's mu
  void* s2[kMaxLeaves];  // adam's nu
  int64_t n[kMaxLeaves];
  int64_t first_chunk[kMaxLeaves + 1];  // first_chunk[count] = the launch's chunks
  int vec[kMaxLeaves];   // 1 if p, g, s1 and s2 all start on a 16-byte boundary
  int count;
};

struct Hyper {
  float neg_lr, b1, omb1, b2, omb2, eps;
  const int* count;  // adam's step count (on the card), null for sgd and adagrad
};

// adam's bias corrections 1 - b^count in f32, each in the leaf's dtype.
struct BiasCorrections {
  float bc1, bc2;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// The value an eager op on a T tensor stores: f32 as it is, bf16 rounded.
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (sizeof(T) == 2) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <typename T>
__device__ __forceinline__ T to_t(float x) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(x);
  else return x;
}

template <int O, typename T>
__device__ __forceinline__ BiasCorrections bias_corrections(const Hyper& h) {
  if constexpr (O != kAdam) {
    return {1.f, 1.f};
  } else {
    const float c = static_cast<float>(__ldg(h.count));
    return {rnd<T>(__fsub_rn(1.f, powf(h.b1, c))), rnd<T>(__fsub_rn(1.f, powf(h.b2, c)))};
  }
}

// One element: p, s1, s2 updated in place (f32 values of T, already rounded).
template <int O, typename T>
__device__ __forceinline__ void step(float& p, float g, float& s1, float& s2, const Hyper& h,
                                     const BiasCorrections& bc) {
  if constexpr (O == kSgd) {
    p = rnd<T>(__fadd_rn(p, rnd<T>(__fmul_rn(g, h.neg_lr))));
  } else if constexpr (O == kAdagrad) {
    s1 = rnd<T>(__fadd_rn(s1, rnd<T>(__fmul_rn(g, g))));
    float u = rnd<T>(rsqrtf(rnd<T>(__fadd_rn(s1, h.eps))));
    u = rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(u, g)), h.neg_lr));
    p = rnd<T>(__fadd_rn(p, u));
  } else {
    s1 = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(s1, h.b1)), rnd<T>(__fmul_rn(g, h.omb1))));
    s2 = rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(s2, h.b2)),
                          rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(g, g)), h.omb2))));
    const float a = rnd<T>(__fdiv_rn(s1, bc.bc1));
    const float s = rnd<T>(__fadd_rn(rnd<T>(__fsqrt_rn(rnd<T>(__fdiv_rn(s2, bc.bc2)))),
                                     h.eps));
    const float u = rnd<T>(__fmul_rn(rnd<T>(__fdiv_rn(a, s)), h.neg_lr));
    p = rnd<T>(__fadd_rn(p, u));
  }
}

template <int O, typename T>
__device__ __forceinline__ void update_one(T* __restrict__ p, const T* __restrict__ g,
                                           T* __restrict__ s1, T* __restrict__ s2, int64_t i,
                                           const Hyper& h, const BiasCorrections& bc) {
  float pv = to_float(p[i]);
  float a = O == kSgd ? 0.f : to_float(s1[i]);
  float b = O == kAdam ? to_float(s2[i]) : 0.f;
  step<O, T>(pv, to_float(g[i]), a, b, h, bc);
  p[i] = to_t<T>(pv);
  if constexpr (O != kSgd) s1[i] = to_t<T>(a);
  if constexpr (O == kAdam) s2[i] = to_t<T>(b);
}

// 16 bytes of T as f32 values and back.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  float v[kN];
  __device__ __forceinline__ void load(const T* p) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    if constexpr (sizeof(T) == 4) {
      v[0] = __uint_as_float(w.x); v[1] = __uint_as_float(w.y);
      v[2] = __uint_as_float(w.z); v[3] = __uint_as_float(w.w);
    } else {
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[2 * k] = __uint_as_float(u[k] << 16);
        v[2 * k + 1] = __uint_as_float(u[k] & 0xffff0000u);
      }
    }
  }
  __device__ __forceinline__ void store(T* p) const {
    uint4 w;
    if constexpr (sizeof(T) == 4) {
      w = make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                     __float_as_uint(v[3]));
    } else {
      uint32_t u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // The values are bf16 already (rnd): their low halves are zero.
        u[k] = (__float_as_uint(v[2 * k]) >> 16) | (__float_as_uint(v[2 * k + 1]) & 0xffff0000u);
      }
      w = make_uint4(u[0], u[1], u[2], u[3]);
    }
    *reinterpret_cast<uint4*>(p) = w;
  }
};

template <int O, typename T>
__device__ __forceinline__ void update_vec(T* __restrict__ p, const T* __restrict__ g,
                                           T* __restrict__ s1, T* __restrict__ s2, int64_t i,
                                           const Hyper& h, const BiasCorrections& bc) {
  Vec<T> pv, gv, av{}, bv{};  // av, bv: zeros where the optimizer has no such state
  pv.load(p + i);
  gv.load(g + i);
  if constexpr (O != kSgd) av.load(s1 + i);
  if constexpr (O == kAdam) bv.load(s2 + i);
#pragma unroll
  for (int k = 0; k < Vec<T>::kN; ++k) step<O, T>(pv.v[k], gv.v[k], av.v[k], bv.v[k], h, bc);
  pv.store(p + i);
  if constexpr (O != kSgd) av.store(s1 + i);
  if constexpr (O == kAdam) bv.store(s2 + i);
}

template <int O, typename T>
__global__ void __launch_bounds__(kThreads)
optimizer_update_kernel(const Leaves leaves, const Hyper h) {
  constexpr int V = Vec<T>::kN;
  const BiasCorrections bc = bias_corrections<O, T>(h);
  const int64_t n_chunks = leaves.first_chunk[leaves.count];
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int leaf = 0;
    while (leaves.first_chunk[leaf + 1] <= c) ++leaf;
    T* __restrict__ p = static_cast<T*>(leaves.p[leaf]);
    const T* __restrict__ g = static_cast<const T*>(leaves.g[leaf]);
    T* __restrict__ s1 = static_cast<T*>(leaves.s1[leaf]);
    T* __restrict__ s2 = static_cast<T*>(leaves.s2[leaf]);
    const int64_t begin = (c - leaves.first_chunk[leaf]) * kChunk;
    const int64_t end = min(begin + kChunk, leaves.n[leaf]);
    int64_t i = begin + threadIdx.x;
    if (leaves.vec[leaf]) {
      const int64_t vend = begin + (end - begin) / V * V;
      for (int64_t j = begin + (int64_t)threadIdx.x * V; j < vend; j += kThreads * V)
        update_vec<O, T>(p, g, s1, s2, j, h, bc);
      i = vend + threadIdx.x;
    }
    for (; i < end; i += kThreads) update_one<O, T>(p, g, s1, s2, i, h, bc);
  }
}

template <int O, typename T>
int launch(const Leaves& l, const Hyper& h, cudaStream_t stream) {
  const int64_t chunks = l.first_chunk[l.count];
  const int grid = (int)(chunks < (1LL << 30) ? chunks : (1LL << 30));
  optimizer_update_kernel<O, T><<<grid, kThreads, 0, stream>>>(l, h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_opt(int opt, const Leaves& l, const Hyper& h, cudaStream_t stream) {
  if (opt == kSgd) return launch<kSgd, T>(l, h, stream);
  if (opt == kAdagrad) return launch<kAdagrad, T>(l, h, stream);
  if (opt == kAdam) return launch<kAdam, T>(l, h, stream);
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// One fused update of n_leaves leaves of one dtype (0 = float32, 1 =
// bfloat16); opt 0 = sgd, 1 = adagrad, 2 = adam. p, g, s1, s2 and n are
// host arrays of n_leaves entries: the param, its gradient, the state
// (adagrad: s1 the accumulator; adam: s1 mu, s2 nu; null where the
// optimizer has none), and the leaf's elements. count: adam's step count,
// an int32 on the card, already advanced for this step (null for sgd and
// adagrad). Launches once for every kMaxLeaves leaves. Returns the first
// nonzero cudaError_t (0 = success); the caller validates shapes, dtypes
// and contiguity.
int drs_optimizer_update(int opt, int dtype, int n_leaves, void* const* p,
                         const void* const* g, void* const* s1, void* const* s2,
                         const int64_t* n, float neg_lr, float b1, float omb1, float b2,
                         float omb2, float eps, const int* count, void* stream) {
  if (opt < kSgd || opt > kAdam || dtype < 0 || dtype > 1 || n_leaves < 0 ||
      (opt == kAdam && count == nullptr))
    return (int)cudaErrorInvalidValue;
  const Hyper h = {neg_lr, b1, omb1, b2, omb2, eps, count};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int at = 0; at < n_leaves; at += kMaxLeaves) {
    Leaves l = {};
    l.first_chunk[0] = 0;
    for (int k = at; k < n_leaves && l.count < kMaxLeaves; ++k) {
      const int j = l.count++;
      l.p[j] = p[k];
      l.g[j] = g[k];
      l.s1[j] = s1[k];
      l.s2[j] = s2[k];
      l.n[j] = n[k];
      l.first_chunk[j + 1] = l.first_chunk[j] + (n[k] + kChunk - 1) / kChunk;
      l.vec[j] = aligned16(p[k]) && aligned16(g[k]) && aligned16(s1[k]) && aligned16(s2[k]);
    }
    if (l.first_chunk[l.count] == 0) continue;
    const int err = dtype == 0 ? launch_opt<float>(opt, l, h, s)
                               : launch_opt<__nv_bfloat16>(opt, l, h, s);
    if (err != 0) return err;
  }
  return 0;
}

const char* drs_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
