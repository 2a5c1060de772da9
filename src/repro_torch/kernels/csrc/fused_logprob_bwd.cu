// Gradient of the fused per-row log-prob and entropy w.r.t. the logits.
//
// Replaces: the backward that the JAX trainers get from jax.grad through
// src/repro/kernels/ref.py, ref_logprobs_from_logits and
// ref_entropy_from_logits (the Pallas kernel, fused_logprob_pallas.py
// logprobs_pallas, is forward-only).  With p = exp(x - lse) and H the
// row's entropy, both saved by the forward (fused_logprob.cu):
//
//   dx[v] = g_lp * (1[v == t] - p[v]) - g_ent * p[v] * (x[v] - lse + H)
//
// where g_lp and g_ent are the incoming gradients of logp and ent.  Either
// term is skipped when its gradient is absent (has_lp / has_ent = 0): the
// learner's loss uses no entropy by default.
//
// What bounds it on an H100: the bytes it moves, every logit read once and
// every gradient written once, 2 * N * V * sizeof(T).  At the learner's
// shape (N = 512, V = 151936, float32) that is 622 MB, ~186 us at
// 3.35 TB/s.
//
// Design: one elementwise pass.  The grid is (chunks of a row, rows); each
// thread reads 16 bytes at a time, UNROLL packs per thread, and writes the
// gradient in the logits' dtype.  The row's scalars (t, lse, H, g_lp,
// g_ent) are loaded once per thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
logprob_bwd_kernel(const T* __restrict__ logits,
                   const int* __restrict__ targets,
                   const float* __restrict__ lse,
                   const float* __restrict__ ent,
                   const float* __restrict__ g_lp,
                   const float* __restrict__ g_ent, T* __restrict__ dlogits,
                   int vocab, int has_lp, int has_ent) {
  const int row = blockIdx.y;
  const size_t base = (size_t)row * vocab;
  const int tgt = targets[row];
  const float m = lse[row];
  const float gl = has_lp ? g_lp[row] : 0.f;
  const float ge = has_ent ? g_ent[row] : 0.f;
  const float h = has_ent ? ent[row] : 0.f;
  const int n_packs = vocab / VEC;
  const Pack<T, VEC>* in =
      reinterpret_cast<const Pack<T, VEC>*>(logits + base);
  Pack<T, VEC>* out = reinterpret_cast<Pack<T, VEC>*>(dlogits + base);
  const int first = blockIdx.x * kThreads * kUnroll + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int p = first + u * kThreads;
    if (p >= n_packs) break;
    const Pack<T, VEC> xin = in[p];
    Pack<T, VEC> g;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float x = to_float(xin.v[i]);
      const float prob = expf(x - m);
      float d = gl * ((p * VEC + i == tgt ? 1.f : 0.f) - prob);
      if (has_ent) d -= ge * prob * (x - m + h);
      store(&g.v[i], d);
    }
    out[p] = g;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const int* targets, const float* lse,
                   const float* ent, const float* g_lp, const float* g_ent,
                   void* dlogits, int n, int vocab, int has_lp, int has_ent,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = vocab % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(logits) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(dlogits) % 16 == 0;
  const T* x = static_cast<const T*>(logits);
  T* dx = static_cast<T*>(dlogits);
  const int vec = vec_ok ? kVec : 1;
  const int per_block = kThreads * kUnroll;
  const dim3 grid((vocab / vec + per_block - 1) / per_block, n);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  if (vec_ok)
    logprob_bwd_kernel<T, kVec><<<grid, kThreads, 0, stream>>>(
        x, targets, lse, ent, g_lp, g_ent, dx, vocab, has_lp, has_ent);
  else
    logprob_bwd_kernel<T, 1><<<grid, kThreads, 0, stream>>>(
        x, targets, lse, ent, g_lp, g_ent, dx, vocab, has_lp, has_ent);
  return cudaGetLastError();
}

}  // namespace

// logits / dlogits [N, V] (contiguous, one dtype: float32 or bfloat16),
// targets [N] int32, lse / ent / g_lp / g_ent [N] float32 (g_lp and g_ent
// are read only when has_lp / has_ent is 1, and may be null otherwise).
// dtype 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int fused_logprob_bwd_launch(const void* logits,
                                        const void* targets, const void* lse,
                                        const void* ent, const void* g_lp,
                                        const void* g_ent, void* dlogits,
                                        int n, int vocab, int has_lp,
                                        int has_ent, int dtype, void* stream) {
  if (n <= 0 || vocab <= 0 || (has_lp && !g_lp) || (has_ent && !g_ent))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  const float* ls = static_cast<const float*>(lse);
  const float* en = static_cast<const float*>(ent);
  const float* gl = static_cast<const float*>(g_lp);
  const float* ge = static_cast<const float*>(g_ent);
  switch (dtype) {
    case 0:
      return (int)launch<float>(logits, tg, ls, en, gl, ge, dlogits, n, vocab,
                                has_lp, has_ent, s);
    case 1:
      return (int)launch<__nv_bfloat16>(logits, tg, ls, en, gl, ge, dlogits,
                                        n, vocab, has_lp, has_ent, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
