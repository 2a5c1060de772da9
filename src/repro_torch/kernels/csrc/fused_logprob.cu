// Fused per-row log-prob of a target token and softmax entropy.
//
// Replaces: src/repro/kernels/fused_logprob_pallas.py, logprobs_pallas
// (_logprob_kernel), the Pallas TPU kernel that streams the vocab axis of
// each block of rows through VMEM once with an online logsumexp, carrying
// (max, sum, target logit, entropy partial) in scratch across a
// sequential vocab grid.
//
// What bounds it on an H100: the bytes it moves.  Every logit is read once
// (N * V * sizeof(T)); the three [N] float32 outputs are negligible.  At
// the learner's shape (N = 512, V = 151936) that is 311 MB in float32,
// ~93 us at 3.35 TB/s, and half of it for bfloat16.  The arithmetic is
// ~1.25 expf and a few FMAs per logit, under the card's float32 rate.
//
// Design: one block per row.  A CUDA grid has no sequential axis to carry
// the online state across, so each thread keeps its own online triple
// (m, l = sum e^{x-m}, s = sum e^{x-m} x) over a strided slice of the row,
// reading 16 bytes per load with UNROLL loads in flight, and the block
// merges the triples: warp shuffles, then shared memory across warps.
// l and s are float64: each thread adds ~600 terms of a 151936-wide row,
// and float32 running sums lost 1.0e-5 in logp on the full-width model's
// own logits, against float64 truth, where the plain version
// (tree-reduced) lost 1.6e-6.  The exponentials stay float32; each
// 16-byte pack is summed in float32 first, so the float64 work is two
// adds per pack.  The target logit is one load of x[t].  Outputs, as in Pallas:
//   lse = m + log(max(l, 1e-30)),  logp = x[t] - lse,
//   ent = lse - s / max(l, 1e-30),
// plus lse itself for the backward pass (fused_logprob_bwd.cu).  The
// running max starts at NEG_INF = -1e30, as in Pallas, so a row padded
// with -1e30 adds exact zeros.  A target outside [0, V) gives logp = NaN.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Triple {
  float m;
  double l, s;
};

__device__ __forceinline__ Triple merge(Triple a, Triple b) {
  const float m = fmaxf(a.m, b.m);
  const double ca = expf(a.m - m), cb = expf(b.m - m);
  return {m, a.l * ca + b.l * cb, a.s * ca + b.s * cb};
}

// Folds VEC consecutive logits into the thread's triple: one rescale when
// the running max grows, then one expf per logit.
template <typename T, int VEC>
__device__ __forceinline__ void fold(Triple& t, const T* v) {
  float x[VEC];
  float mx = t.m;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    x[i] = to_float(v[i]);
    mx = fmaxf(mx, x[i]);
  }
  if (mx > t.m) {
    const double c = expf(t.m - mx);
    t.l *= c;
    t.s *= c;
    t.m = mx;
  }
  float l = 0.f, s = 0.f;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float e = expf(x[i] - t.m);
    l += e;
    s = fmaf(e, x[i], s);
  }
  t.l += l;
  t.s += s;
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
logprob_kernel(const T* __restrict__ logits, const int* __restrict__ targets,
               float* __restrict__ logp, float* __restrict__ ent,
               float* __restrict__ lse_out, int vocab) {
  const int row = blockIdx.x;
  const T* x = logits + (size_t)row * vocab;
  Triple t = {kNegInf, 0.0, 0.0};

  // Vector body: 16-byte packs, UNROLL packs loaded before any is used.
  const int n_packs = vocab / VEC;
  const Pack<T, VEC>* packs = reinterpret_cast<const Pack<T, VEC>*>(x);
  int p = threadIdx.x;
  for (; p + (kUnroll - 1) * kThreads < n_packs; p += kUnroll * kThreads) {
    Pack<T, VEC> buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) buf[u] = packs[p + u * kThreads];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) fold<T, VEC>(t, buf[u].v);
  }
  for (; p < n_packs; p += kThreads) {
    Pack<T, VEC> one = packs[p];
    fold<T, VEC>(t, one.v);
  }
  // Scalar tail (VEC == 1 takes the whole row above).
  for (int i = n_packs * VEC + threadIdx.x; i < vocab; i += kThreads)
    fold<T, 1>(t, x + i);

  // Block merge: within each warp, then warp 0 over the warps' triples.
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Triple o = {__shfl_xor_sync(0xffffffffu, t.m, off),
                __shfl_xor_sync(0xffffffffu, t.l, off),
                __shfl_xor_sync(0xffffffffu, t.s, off)};
    t = merge(t, o);
  }
  __shared__ Triple warp_t[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_t[warp] = t;
  __syncthreads();
  if (warp != 0) return;
  t = lane < kThreads / 32 ? warp_t[lane] : Triple{kNegInf, 0.0, 0.0};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Triple o = {__shfl_xor_sync(0xffffffffu, t.m, off),
                __shfl_xor_sync(0xffffffffu, t.l, off),
                __shfl_xor_sync(0xffffffffu, t.s, off)};
    t = merge(t, o);
  }
  if (lane != 0) return;
  const double l = fmax(t.l, 1e-30);
  const double lse = t.m + log(l);
  const int tgt = targets[row];
  const float xt = (tgt >= 0 && tgt < vocab) ? to_float(x[tgt]) : nanf("");
  logp[row] = (float)(xt - lse);
  ent[row] = (float)(lse - t.s / l);
  lse_out[row] = (float)lse;
}

template <typename T>
cudaError_t launch(const void* logits, const int* targets, float* logp,
                   float* ent, float* lse, int n, int vocab,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec_ok = vocab % kVec == 0 &&
                      reinterpret_cast<uintptr_t>(logits) % 16 == 0;
  const T* x = static_cast<const T*>(logits);
  if (vec_ok)
    logprob_kernel<T, kVec><<<n, kThreads, 0, stream>>>(x, targets, logp, ent,
                                                        lse, vocab);
  else
    logprob_kernel<T, 1><<<n, kThreads, 0, stream>>>(x, targets, logp, ent,
                                                     lse, vocab);
  return cudaGetLastError();
}

}  // namespace

// logits [N, V] (contiguous, float32 or bfloat16), targets [N] int32;
// writes logp, ent and lse, each [N] float32.  dtype 0 = float32,
// 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int fused_logprob_launch(const void* logits, const void* targets,
                                    void* logp, void* ent, void* lse, int n,
                                    int vocab, int dtype, void* stream) {
  if (n <= 0 || vocab <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tg = static_cast<const int*>(targets);
  float* lp = static_cast<float*>(logp);
  float* en = static_cast<float*>(ent);
  float* ls = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return (int)launch<float>(logits, tg, lp, en, ls, n, vocab, s);
    case 1:
      return (int)launch<__nv_bfloat16>(logits, tg, lp, en, ls, n, vocab, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
