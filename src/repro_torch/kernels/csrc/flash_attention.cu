// Causal (optionally sliding-window) GQA attention over one sequence, with
// an online softmax: the prefill attention of every layer.
//
// Replaces: src/repro/kernels/flash_attention_pallas.py, flash_attention
// (_flash_kernel), the Pallas TPU kernel whose grid is (batch, q head,
// q block, kv block) with the kv axis sequential, the running max, sum
// and accumulator in VMEM scratch, and kv blocks wholly outside the
// causal band or the window skipped.
//
// What it computes, per (b, head h, position p), with g = h / (H / KV):
//   s_j = (q[b,p,h] * D^-0.5) . k[b,j,g]  for keys j <= p, p - j < window
//   out[b,p,h] = sum_j softmax(s)_j v[b,j,g]
// q [B,S,H,D], k and v [B,S,KV,D], float32 or bfloat16; scores, softmax
// and accumulation float32 (no TF32); out in the inputs' dtype.  The
// running max starts at -1e30 and the denominator is clamped at 1e-30,
// as in the Pallas kernel; masked keys contribute exactly 0.  Optionally
// (lse != null, the forward of a step that will be differentiated) each
// row's float32 logsumexp of its scaled scores, lse[b, p, h] = m + log l,
// which the backward (flash_attention_bwd.cu) recomputes P from.
//
// What bounds it on an H100: operations at long S (4 D flops per
// attended (query, key) pair; 13.4 GFLOP for one hymba layer at S 2048,
// 0.20 ms at the float32 peak of 67 TFLOP/s), bytes at the serve prefill
// (B 8, S 32: 3.9 MB, 1.2 us at 3.35 TB/s).  This design runs the
// products on the FMA pipes from shared memory (one shared load per two
// FMAs), so at best about half the float32 peak.
//
// Two instantiations, chosen by the launcher from dtype and head dim
// alone: bfloat16 at D = 64 takes flash_kernel_wgmma
// (flash_attention_wgmma.cuh: tensor cores fed by TMA); float32, and
// bfloat16 at D 8, 16, 32 and 128, take flash_kernel below.  A call that asks
// for the logsumexp takes flash_kernel at every dtype and head dim (the
// wgmma kernel writes none), so the serve path's wgmma kernel is as it was.
//
// Design: GQA packing.  The G = H / KV query heads of a kv head are
// adjacent in memory at each position, so the rows (position, head) of
// one kv head form an S*G x D matrix with row r at position r / G.  One
// block of 256 threads takes 64 such rows of one (b, kv head): its Q tile
// (scaled, float32) is loaded once, then K/V tiles of 64 keys are staged
// in shared memory once and used by every query head of the tile (each
// thread's loads of a tile unrolled and 4 elements wide, so they are in
// flight together).  The key tiles run from the first key any row of the
// tile can reach (the window's start) to the last (the causal edge);
// tiles wholly outside are never loaded.  Thread (ty, tx) of a 16 x 16 grid owns rows
// 4 ty .. 4 ty + 3, keys tx + 16 c of the score tile, and dims tx + 16 c
// of the output rows: scores in registers, row max and sum reduced over
// the 16 lanes of a half-warp by shuffles, probabilities staged through
// shared memory for the value product, the accumulator in registers.
// Ragged S and rows past S * G are bounds-checked; nothing is padded.
// D is 8, 16, 32, 64 or 128.  At D 128 a block's shared memory is
// 116,992 B (Q, K, V and P tiles of 64 rows, padded), so one block fits
// an SM, and the accumulator is 32 floats a thread.  The windowed and
// global forms are separate instantiations (kWindow), so a profile tells
// them apart.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kRows = 64;       // (position, head) rows per block
constexpr int kKeys = 64;       // keys per K/V tile
constexpr float kNegInf = -1e30f;
static_assert(kKeys == kRows, "K/V tiles reuse the Q tile's load layout");

// Four consecutive elements (16 bytes of float32, 8 of bfloat16) as
// float32: one vector load.
__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  x[0] = lo.x, x[1] = lo.y, x[2] = hi.x, x[3] = hi.y;
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
struct Layout {
  static constexpr int kQ = D + 4;       // row strides in floats, padded
  static constexpr int kK = D + 1;       // against bank conflicts
  static constexpr int kP = kKeys + 4;
  static constexpr int kDims = (D + 15) / 16;   // output dims per thread
  static constexpr int kQuads = kRows * D / 4;  // 4-element loads a tile
  static constexpr int kLoads = (kQuads + kThreads - 1) / kThreads;
  static constexpr size_t kBytes =
      sizeof(float) * (kRows * kQ + kKeys * kK + kKeys * D + kRows * kP);
};

template <typename T, int D, bool kWindow>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out,
             float* __restrict__ lse, int seq, int n_heads, int n_kv,
             int window, float scale) {
  using L = Layout<D>;
  extern __shared__ float smem[];
  float* s_q = smem;                       // [kRows][kQ]
  float* s_k = s_q + kRows * L::kQ;        // [kKeys][kK]
  float* s_v = s_k + kKeys * L::kK;        // [kKeys][D]
  float* s_p = s_v + kKeys * D;            // [kRows][kP]

  const int group = n_heads / n_kv;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int n_rows = seq * group;          // rows of this (b, kv head)
  const int r0 = blockIdx.x * kRows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // Row r sits at position r / group, query head kvh * group + r % group.
  // Every load of a tile is unrolled, so a thread's loads are in flight
  // together.
#pragma unroll
  for (int it = 0; it < L::kLoads; ++it) {
    const int e = tid + it * kThreads;
    if (L::kQuads % kThreads != 0 && e >= L::kQuads) break;
    const int rr = e / (D / 4), d = (e % (D / 4)) * 4, r = r0 + rr;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < n_rows)
      load4(q + (((size_t)b * seq + r / group) * n_heads + kvh * group +
                 r % group) * D + d, x);
#pragma unroll
    for (int c = 0; c < 4; ++c) s_q[rr * L::kQ + d + c] = x[c] * scale;
  }

  int pos[4];
  bool live[4];
  float m[4], l[4], acc[4][L::kDims];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    live[i] = r < n_rows;
    pos[i] = live[i] ? r / group : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) acc[i][c] = 0.f;
  }

  // Keys any row of this block can reach: [first, last].
  const int last = (min(r0 + kRows, n_rows) - 1) / group;
  const int first = kWindow ? max(0, r0 / group - window + 1) : 0;
  const size_t kv_row = (size_t)n_kv * D;            // one position
  const size_t kv_base = (size_t)b * seq * kv_row + (size_t)kvh * D;

  for (int k0 = (first / kKeys) * kKeys; k0 <= last; k0 += kKeys) {
    float kx[L::kLoads][4], vx[L::kLoads][4];
#pragma unroll
    for (int it = 0; it < L::kLoads; ++it) {
      const int e = tid + it * kThreads;
      const int key = k0 + e / (D / 4), d = (e % (D / 4)) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) kx[it][c] = vx[it][c] = 0.f;
      if ((L::kQuads % kThreads == 0 || e < L::kQuads) && key < seq) {
        const size_t at = kv_base + (size_t)key * kv_row + d;
        load4(k + at, kx[it]);
        load4(v + at, vx[it]);
      }
    }
    __syncthreads();   // the previous tile is consumed; s_q is written
#pragma unroll
    for (int it = 0; it < L::kLoads; ++it) {
      const int e = tid + it * kThreads;
      if (L::kQuads % kThreads != 0 && e >= L::kQuads) break;
      const int kk = e / (D / 4), d = (e % (D / 4)) * 4;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s_k[kk * L::kK + d + c] = kx[it][c];
        s_v[kk * D + d + c] = vx[it][c];
      }
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(ty * 4 + i) * L::kQ + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = s_k[(tx + 16 * c) * L::kK + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + tx + 16 * c;
        ok[c] = key <= pos[i] && (!kWindow || pos[i] - key < window);
        if (ok[c]) mx = fmaxf(mx, s[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)    // the row's 16 lanes
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        sum += p;
        s_p[(ty * 4 + i) * L::kP + tx + 16 * c] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // s_p is complete

    const int n_keys = min(kKeys, seq - k0);
    for (int kk = 0; kk < n_keys; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(ty * 4 + i) * L::kP + kk];
#pragma unroll
      for (int c = 0; c < L::kDims; ++c) {
        const int d = tx + 16 * c;
        const float vv = d < D ? s_v[kk * D + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!live[i]) continue;
    const int r = r0 + ty * 4 + i;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    const size_t head_row =
        ((size_t)b * seq + pos[i]) * n_heads + kvh * group + r % group;
    T* row = out + head_row * D;
    if (lse != nullptr && tx == 0)
      lse[head_row] = m[i] + logf(fmaxf(l[i], 1e-30f));
#pragma unroll
    for (int c = 0; c < L::kDims; ++c) {
      const int d = tx + 16 * c;
      if (d < D) store(row + d, acc[i][c] * inv);
    }
  }
}

template <typename T, int D, bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int seq, int n_heads, int n_kv,
                   int window, float scale, cudaStream_t stream) {
  auto kernel = flash_kernel<T, D, kWindow>;
  const size_t bytes = Layout<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  const int rows = seq * (n_heads / n_kv);
  dim3 grid((rows + kRows - 1) / kRows, n_kv, batch);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, seq, n_heads,
      n_kv, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_w(const void* q, const void* k, const void* v, void* out,
                     float* lse, int batch, int seq, int n_heads, int n_kv,
                     int window, float scale, cudaStream_t stream) {
  if (window > 0)
    return launch<T, D, true>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                              window, scale, stream);
  return launch<T, D, false>(q, k, v, out, lse, batch, seq, n_heads, n_kv, 0,
                             scale, stream);
}

template <typename T>
cudaError_t launch_d(int dim, const void* q, const void* k, const void* v,
                     void* out, float* lse, int batch, int seq, int n_heads,
                     int n_kv, int window, float scale, cudaStream_t stream) {
  switch (dim) {
    case 8:
      return launch_w<T, 8>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                            window, scale, stream);
    case 16:
      return launch_w<T, 16>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                             window, scale, stream);
    case 32:
      return launch_w<T, 32>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                             window, scale, stream);
    case 64:
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        if (lse == nullptr)
          return wg::launch_w(q, k, v, out, batch, seq, n_heads, n_kv, window,
                              scale, stream);
      }
      return launch_w<T, 64>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                             window, scale, stream);
    case 128:
      return launch_w<T, 128>(q, k, v, out, lse, batch, seq, n_heads, n_kv,
                              window, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q [B, S, H, D], k and v [B, S, KV, D]: contiguous, one dtype (0 =
// float32, 1 = bfloat16), H a multiple of KV, D in {8, 16, 32, 64, 128};
// bfloat16 at D 64 without lse (flash_kernel_wgmma) also needs q, k, v
// 16-byte aligned and H / KV <= 64.  window > 0 limits each query to the
// keys p - window < j <= p; 0 is global causal attention.  out [B, S, H, D]
// in the inputs' dtype is written, and lse [B, S, H] float32 unless it is
// null.  Returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int batch, int seq, int n_heads,
                                      int n_kv, int dim, int window,
                                      int dtype, float scale, void* stream) {
  if (batch <= 0 || seq <= 0 || n_kv <= 0 || n_heads < n_kv ||
      n_heads % n_kv != 0 || window < 0 || batch > 65535 || n_kv > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lf = static_cast<float*>(lse);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(dim, q, k, v, out, lf, batch, seq,
                                  n_heads, n_kv, window, scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(dim, q, k, v, out, lf, batch, seq,
                                          n_heads, n_kv, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
