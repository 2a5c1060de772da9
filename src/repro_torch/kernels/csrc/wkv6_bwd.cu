// Backward of the RWKV-6 (Finch) WKV recurrence: the gradients of rwkv6's
// time-mix recurrence with respect to every input, for training.
//
// Replaces: the gradient that jax.grad takes through
// src/repro/models/rwkv6.py, wkv6_scan (the lax.scan the JAX package
// trains through; the Pallas kernel wkv6_pallas is forward-only).  The
// plain versions are kernels/ref.py: ref_wkv6_backward (step by step) and
// ref_wkv6_backward_chunked, which spells out this file's algebra.
//
// What it computes.  Forward, per (b, h), from state S_{-1} (zeros if
// absent): y_t = S_{t-1}^T r_t + (r_t . u k_t) v_t and
// S_t = diag(w_t) S_{t-1} + k_t v_t^T.  Given dy [B, S, H, V] and the
// final state's gradient G_{S-1} [B, H, K, V] (null = zeros), with
// g_t = dy_t . v_t and G_{t-1} = diag(w_t) G_t + r_t dy_t^T:
//   dr_t = S_{t-1} dy_t + u k_t g_t        dk_t = G_t v_t + u r_t g_t
//   dv_t = G_t^T k_t + (r_t . u k_t) dy_t  dw_t = rowsum(G_t * S_{t-1})
//   du = sum_{b,t} r_t k_t g_t             dstate = G_{-1}.
// r, k, w, u, dy and dr, dk, dv, dw, du in the inputs' dtype (float32 or
// bfloat16); states and their gradients float32; all arithmetic float32.
//
// The chunked form.  Within a sub-chunk of L = 16 steps from start state
// S0 and end-gradient G_end (the gradient reaching its last state), per
// key: pre_t = prod_{m<t} w_m, suf_t = prod_{t<m<L} w_m, total = prod w,
// pair_ti = prod_{i<m<t} w_m (i < t).  With A_ji = dy_j . v_i (g_t =
// A_tt), SdY_t = S0 dy_t, GV_t = G_end v_t, c = rowsum(G_end * S0) and
// the forward's scores P_jt = r_j . (pair_jt k_t) (j > t), P_tt = r_t . u
// k_t:
//   dr_t = pre_t SdY_t + sum_{i<t} pair_ti k_i A_ti + u k_t g_t
//   dk_t = suf_t GV_t + sum_{j>t} pair_jt r_j A_jt + u r_t g_t
//   dv_t = G_end^T (suf_t k_t) + sum_{j>=t} P_jt dy_j
//   dw_t = pre_t suf_t c + pre_t Z_t + suf_t W_t + X_t, where
//          Z_t = sum_{j>t} pair_jt r_j SdY_j, W_t = sum_{i<t} pair_ti k_i
//          GV_i, X_t = sum_{i<t<j} pair_ti pair_jt k_i r_j A_ji
//   G before the sub-chunk = diag(total) G_end + (r pre)^T dY
//   S after it = diag(total) S0 + (k suf)^T V.
// The products (A, SdY, GV, the G_end and P parts of dv, the G and S
// updates) run on the tensor cores: mma.m16n8k8 in 3xTF32 (mma_tf32.cuh),
// which holds float32 inputs to float32 accuracy, the correction products
// in accumulators of their own so the mma chains stay short.  The rest is
// a walk per key, four lanes a key, each lane four rows j of the
// sub-chunk: M_t^(j) = sum_{i<t} pair_ti k_i A_ji by the running
// recurrence M_{t+1} = w_t M_t + k_t A_jt (so the dr sum is M_j^(j)), then
// X_t and the dk sum by a running product of w from j down; those two
// sums go over the key's lanes by a reduce-scatter, and Z and W are
// recurrences of their own.  Nothing divides by w or by a product of w,
// and nothing takes a logarithm: w = 0 and w = 1 give exact, finite
// gradients; a product that underflows is the right answer, 0.
//
// Two instantiations, one main kernel (wkv6_bwd_chunk_kernel, a block of
// 8 warps per (b, h, segment)); the wrapper (kernels/wkv6.py:
// wkv6_bwd_impl, bwd_split_steps) picks one:
//   chunked (seg = S): one segment; the learner's shape (B x H fills
//     the card).
//   split (seg > 0, a multiple of 16): segments of seg steps in parallel,
//     for long S at a B x H that leaves SMs idle.  (1)
//     wkv6_bwd_local_kernel: every segment, from a zero state and a zero
//     end-gradient, forms its local end state (S <- diag(total) S + (k
//     suf)^T V), its local start-gradient sum_t (prod_{m<t} w_m) r_t
//     dy_t^T and its decay product; (2) wkv6_bwd_carry, a thread per
//     (b, h, k, v): segment starts forward from the initial state (the
//     forward split's algebra), segment end-gradients backward from the
//     final state's gradient; (3) the main kernel from those.
// In a segment the block (8 warps) first walks its sub-chunks forward from
// the segment's start (the state in mma accumulators), keeping each
// sub-chunk's start state in device scratch (the last one in shared
// memory), then walks them last to first, four phases a sub-chunk between
// block barriers: the rows as float32; preparation (g, the decay walks,
// A, the scores); the products; the per-key walk, while the next start
// state comes by cp.async.  The next sub-chunk's rows come by cp.async
// during the current one.
// du: g_t is formed once a step as a compensated dot product (hi + lo),
// each key's lanes sum r k g_t over the block's steps in compensated
// float32 (two_sum / two_prod), and wkv6_bwd_reduce sums the (b, segment)
// partials in a fixed pairwise tree: du stays within ~1e-7 of float64
// where it sums thousands of terms that cancel.  No atomics anywhere: two
// launches on the same inputs give bit-identical gradients.
//
// What bounds it on an H100: r, k, v, w and dy are read and dr, dk, dv
// and dw written once, 189 MB float32 at the learner's B 64 x S 40 x H 32
// x K = V = 64 (56 us at 3.35 TB/s), and the step-by-step form's ~12
// operations per state element and step are 4.0 GFLOP (60 us at float32's
// 67 TFLOP/s; this form runs its products as ~13 GFLOP of TF32 instead).
// What holds it at ~6x that (PERF.md row 7b): two blocks an SM (128
// registers, ~105 KB of shared memory a block), and a sub-chunk's phases
// in sequence, whose shared-memory loads, 3xTF32 mma and fragment splits
// the two blocks' phases share.
//
// K is 8, 16, 32 or 64 and V a multiple of 8 up to 64; rows 16-byte
// aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

using tf32::cp_async16;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::Frag;
using tf32::FragB;
using tf32::load_a;
using tf32::load_at;
using tf32::load_b;
using tf32::load_b_of;

constexpr int kSub = 16;          // steps per sub-chunk
constexpr int kDim = 64;          // K and V, padded on chip
constexpr int kThreads = 256;     // 8 warps
constexpr int kCarryThreads = 256;
constexpr int kReduceThreads = 256;
// Row pitches (floats): a row-major A operand (lane (g, t4) reads row g,
// column t4) wants 4 mod 32, a B operand (row t4, column g) 8 mod 32.
constexpr int kPA = kDim + 4;
constexpr int kPB = kDim + 8;
constexpr int kPP = kSub + 8;
enum { kR = 0, kK = 1, kW = 2, kV = 3, kDY = 4 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0,
                                       float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

// a b in 3xTF32 into two accumulators, the hi x hi products in `main` and
// the two correction products in `corr` (the caller adds them at the
// end): two dependent chains where mma3 has one, three times as long.
__device__ __forceinline__ void mma3_split(float (&main)[4],
                                           float (&corr)[4], const Frag& a,
                                           const FragB& b) {
  tf32::mma_tf32(corr, a.lo, b.hi);
  tf32::mma_tf32(corr, a.hi, b.lo);
  tf32::mma_tf32(main, a.hi, b.hi);
}

// Sum over the 16 lanes of a half-warp (every lane gets it).
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// 16 values on each of the 16 lanes of a half-warp (lane q its own x):
// afterwards x[0] on lane q is the sum over the lanes of their x[q].
__device__ __forceinline__ void half_reduce_scatter(float (&x)[16], int q) {
#pragma unroll
  for (int half = 8; half > 0; half /= 2) {
    const bool upper = q & half;
#pragma unroll
    for (int j = 0; j < half; ++j) {
      const float give = upper ? x[j] : x[j + half];
      const float keep = upper ? x[j + half] : x[j];
      x[j] = keep + __shfl_xor_sync(0xffffffffu, give, half);
    }
  }
}

// Error-free transformations (float32 arithmetic, never contracted into
// an fma): a + b = s + e exactly, a b = p + e exactly.
__device__ __forceinline__ float two_sum(float a, float b, float& e) {
  const float s = __fadd_rn(a, b), bb = __fadd_rn(s, -a);
  e = __fadd_rn(__fadd_rn(a, -__fadd_rn(s, -bb)), __fadd_rn(b, -bb));
  return s;
}
__device__ __forceinline__ float two_prod(float a, float b, float& e) {
  const float p = __fmul_rn(a, b);
  e = fmaf(a, b, -p);
  return p;
}
// (hi, lo) += (h, l).
__device__ __forceinline__ void add_pair(float& hi, float& lo, float h,
                                         float l) {
  float e;
  hi = two_sum(hi, h, e);
  lo = __fadd_rn(__fadd_rn(lo, l), e);
}

template <typename T>
struct __align__(16) Smem {
  T raw[5][kSub][kDim];          // the next sub-chunk's rows (cp.async)
  float in[5][kSub][kPA];        // r, k, w, v, dy as float32, masked
  float rpre[kSub][kPB];         // r_t pre_t (x the earlier decay: local)
  float ksuf[kSub][kPA];         // k_t suf_t
  float pre[kSub][kDim];
  float suf[kSub][kDim];
  float sdy[kSub][kPA];          // (S0 dy_t)[k]
  float gv[kSub][kPA];           // (G_end v_t)[k]
  float p[kSub][kPP];            // P[j][t], zero above the diagonal
  float a[kSub][kSub + 4];       // A[j][i] = dy_j . v_i (rows 16-byte aligned)
  float gh[kSub], gl[kSub];      // g_t = A[t][t] as hi + lo (compensated)
  float st[kDim][kPA];           // the sub-chunk's start state
  float g[kDim][kPB];            // the gradient reaching its end
  float tot[kDim];
  float cpart[2][kDim];          // rowsum(G_end * S0), two column halves
  float u[kDim];
};

// Geometry of one (b, h) in [B, S, H, dim] rows.
struct Rows {
  size_t base_k, base_v, step_k, step_v;
  int kd, vd;
};

// Issue the cp.async copies of `len` steps from t0 into raw (r and dy
// only when with_r_dy), by the n_threads threads from `first`, one group
// each.  A sub-chunk's copies take the SM's share of device memory
// bandwidth to issue (~3k cycles on an H100), so the warps that issue
// them are ones that would otherwise wait at the next barrier.  Nothing is
// written past len or past kd / vd: convert() masks those.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* __restrict__ src,
                                           size_t base, size_t step, int t0,
                                           int len, int width, int p,
                                           int n_threads) {
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = width / kPer;
  for (int e = p; e < len * pieces; e += n_threads) {
    const int t = e / pieces, c = (e - t * pieces) * kPer;
    cp_async16(dst + t * kDim + c, src + base + (size_t)(t0 + t) * step + c);
  }
}

template <typename T>
__device__ __forceinline__ void stage(Smem<T>& sm, const T* __restrict__ r,
                                      const T* __restrict__ k,
                                      const T* __restrict__ w,
                                      const T* __restrict__ v,
                                      const T* __restrict__ dy,
                                      const Rows& g, int t0, int len,
                                      bool with_r_dy, int first = 0,
                                      int n_threads = kThreads) {
  const int p = threadIdx.x - first;
  if (with_r_dy) {
    stage_rows(&sm.raw[kR][0][0], r, g.base_k, g.step_k, t0, len, g.kd, p,
               n_threads);
    stage_rows(&sm.raw[kDY][0][0], dy, g.base_v, g.step_v, t0, len, g.vd, p,
               n_threads);
  }
  stage_rows(&sm.raw[kK][0][0], k, g.base_k, g.step_k, t0, len, g.kd, p,
             n_threads);
  stage_rows(&sm.raw[kW][0][0], w, g.base_k, g.step_k, t0, len, g.kd, p,
             n_threads);
  stage_rows(&sm.raw[kV][0][0], v, g.base_v, g.step_v, t0, len, g.vd, p,
             n_threads);
  cp_async_commit();
}

// raw -> in as float32: zero past len and past kd / vd, w = 1 there (so
// decay products span the padding unchanged).
template <typename T>
__device__ __forceinline__ void convert(Smem<T>& sm, const Rows& g, int len,
                                        bool with_r_dy) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int a = 0; a < 5; ++a) {
    if (!with_r_dy && (a == kR || a == kDY)) continue;
    const int width = a >= kV ? g.vd : g.kd;
    const float pad = a == kW ? 1.f : 0.f;
#pragma unroll
    for (int i = 0; i < kSub * kDim / kThreads; ++i) {
      const int e = tid + i * kThreads, t = e / kDim, c = e % kDim;
      sm.in[a][t][c] = (t < len && c < width) ? to_float(sm.raw[a][t][c])
                                              : pad;
    }
  }
}

// The decay walks of key kk (one thread): forward (pre, r pre x `before`
// when with_r, the total, which it returns) and backward (suf, k suf).
template <typename T>
__device__ __forceinline__ float walks(Smem<T>& sm, int kk, float before,
                                       bool with_r) {
  float p = 1.f, s = 1.f;
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    const int b = kSub - 1 - t;
    sm.pre[t][kk] = p;
    if (with_r) sm.rpre[t][kk] = sm.in[kR][t][kk] * p * before;
    p *= sm.in[kW][t][kk];
    sm.suf[b][kk] = s;
    sm.ksuf[b][kk] = sm.in[kK][b][kk] * s;
    s *= sm.in[kW][b][kk];
  }
  sm.tot[kk] = p;
  return p;
}

// A[:, 8 nt .. 8 nt + 7] = dY V^T (A[j][i] = dy_j . v_i) on the tensor
// cores, one warp.
template <typename T>
__device__ __forceinline__ void dots(Smem<T>& sm, int nt, int vd) {
  const int lane = threadIdx.x & 31, g8 = lane >> 2, t4 = lane & 3;
  float acc[2][2][4] = {};
#pragma unroll
  for (int ks = 0; ks < kDim; ks += 8) {
    if (ks >= vd) break;
    const int e = (ks >> 3) & 1;
    mma3_split(acc[e][0], acc[e][1], load_a<kPA>(&sm.in[kDY][0][ks], g8, t4),
               load_b_of([&](int kk, int nn) {
                 return sm.in[kV][8 * nt + nn][ks + kk];
               }, g8, t4));
  }
  const int i = 8 * nt + 2 * t4;
  sm.a[g8][i] = (acc[0][0][0] + acc[1][0][0]) + (acc[0][1][0] + acc[1][1][0]);
  sm.a[g8][i + 1] =
      (acc[0][0][1] + acc[1][0][1]) + (acc[0][1][1] + acc[1][1][1]);
  sm.a[g8 + 8][i] =
      (acc[0][0][2] + acc[1][0][2]) + (acc[0][1][2] + acc[1][1][2]);
  sm.a[g8 + 8][i + 1] =
      (acc[0][0][3] + acc[1][0][3]) + (acc[0][1][3] + acc[1][1][3]);
}

// g_j = dy_j . v_j as hi + lo, compensated (two_prod, two_sum): the
// half-warp of j takes four columns a lane and sums the lanes by a
// butterfly (every lane gets the same pair).  du sums r k g over every
// step with heavy cancellation, so g carries float32's rounding of the
// dot product no further.
template <typename T>
__device__ __forceinline__ void gdot(Smem<T>& sm, int vd) {
  const int j = threadIdx.x >> 4, l = threadIdx.x & 15;
  float hi = 0.f, lo = 0.f;
#pragma unroll
  for (int c = 4 * l; c < 4 * l + 4; ++c) {
    if (c >= vd) break;
    float e;
    const float p = two_prod(sm.in[kDY][j][c], sm.in[kV][j][c], e);
    add_pair(hi, lo, p, e);
  }
#pragma unroll
  for (int off = 8; off > 0; off /= 2)
    add_pair(hi, lo, __shfl_xor_sync(0xffffffffu, hi, off),
             __shfl_xor_sync(0xffffffffu, lo, off));
  if (l == 0) {
    sm.gh[j] = hi;
    sm.gl[j] = lo;
  }
}

// The scores P[j][t] = sum_k r_j pair_jt k_t (j > t) and P[t][t] =
// sum_k r_t u k_t, by threads 128-255 (index p): thread (m, keys 4q ..
// 4q+3) takes rows a = m and b = 15 - m (pair counts m and 15 - m): 16
// values, row b's bonus in slot 0, its pairs (t, t - n) in slots n = 1
// .. 15 - m, row a's in the m slots after them, each pair a running
// product of w; the half-warp sums them by a butterfly that leaves slot
// q on lane q.  Row a's bonus is summed apart.
template <typename T>
__device__ __forceinline__ void scores(Smem<T>& sm, int p) {
  const int m = p >> 4, q = p & 15, ra = m, rb = kSub - 1 - m;
  const float4 uu = *reinterpret_cast<const float4*>(&sm.u[4 * q]);
  auto row4 = [&](int a, int t) {
    return *reinterpret_cast<const float4*>(&sm.in[a][t][4 * q]);
  };
  const float4 r_a = row4(kR, ra), r_b = row4(kR, rb);
  const float4 ka = row4(kK, ra), kb = row4(kK, rb);
  const float bonus_a = half_sum(r_a.x * uu.x * ka.x + r_a.y * uu.y * ka.y +
                                 r_a.z * uu.z * ka.z + r_a.w * uu.w * ka.w);
  float sx[kSub];
  sx[0] = r_b.x * uu.x * kb.x + r_b.y * uu.y * kb.y + r_b.z * uu.z * kb.z +
          r_b.w * uu.w * kb.w;
  float4 pp = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
  for (int s = 1; s < kSub; ++s) {
    const bool row_b = s <= rb;
    if (s == rb + 1) pp = make_float4(1.f, 1.f, 1.f, 1.f);
    const int i = row_b ? rb - s : kSub - 1 - s;
    const float4 rt = row_b ? r_b : r_a;
    const float4 ki = row4(kK, i), wi = row4(kW, i);
    sx[s] = rt.x * ki.x * pp.x + rt.y * ki.y * pp.y + rt.z * ki.z * pp.z +
            rt.w * ki.w * pp.w;
    pp.x *= wi.x, pp.y *= wi.y, pp.z *= wi.z, pp.w *= wi.w;
  }
  half_reduce_scatter(sx, q);
  if (q == 0) {
    sm.p[rb][rb] = sx[0];
    sm.p[ra][ra] = bonus_a;
  } else if (q <= rb) {
    sm.p[rb][rb - q] = sx[0];
  } else {
    sm.p[ra][ra - (q - rb)] = sx[0];
  }
  if (ra + 1 + q < kSub) sm.p[ra][ra + 1 + q] = 0.f;
  if (rb + 1 + q < kSub) sm.p[rb][rb + 1 + q] = 0.f;
}

// A [K, V] state in mma accumulators: warp w owns rows 16 (w / 2) ..
// +15, columns 32 (w % 2) .. +31 (four 16 x 8 tiles); acc[nt][0..1] at
// row g8, columns c + 2 t4, +1, acc[nt][2..3] at row g8 + 8.
struct Tile {
  int r0, c0, g8, t4;
  __device__ __forceinline__ Tile() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    r0 = 16 * (warp >> 1);
    c0 = 32 * (warp & 1);
    g8 = lane >> 2;
    t4 = lane & 3;
  }
  __device__ __forceinline__ int col(int nt) const {
    return c0 + 8 * nt + 2 * t4;
  }
};

// acc = diag(tot) acc + lhs^T rhs over the sub-chunk: lhs [t][k] (pitch
// P), rhs the float32 rows of array `a`.
template <int P, typename T>
__device__ __forceinline__ void state_update(float (&acc)[4][4],
                                             const Smem<T>& sm,
                                             const float (*lhs)[P], int a,
                                             const Tile& tl, bool decay) {
  if (decay) {
    const float lo = sm.tot[tl.r0 + tl.g8], hi = sm.tot[tl.r0 + tl.g8 + 8];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      acc[nt][0] *= lo, acc[nt][1] *= lo;
      acc[nt][2] *= hi, acc[nt][3] *= hi;
    }
  }
  float corr[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < kSub; ks += 8) {
    const Frag fa = load_at<P>(&lhs[ks][tl.r0], tl.g8, tl.t4);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      mma3_split(acc[nt], corr[nt], fa,
                 load_b<kPA>(&sm.in[a][ks][tl.c0 + 8 * nt], tl.g8, tl.t4));
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] += corr[nt][i];
}

// A state [kd, vd] float32 in device memory (null: zeros) <-> the
// accumulators' elements.
__device__ __forceinline__ void acc_load(float (&acc)[4][4],
                                         const float* __restrict__ src,
                                         const Tile& tl, int kd, int vd) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = tl.col(nt);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = tl.r0 + tl.g8 + 8 * hf;
      const bool ok = src != nullptr && row < kd && c < vd;
      const float2 x = ok ? *reinterpret_cast<const float2*>(
                                src + (size_t)row * vd + c)
                          : make_float2(0.f, 0.f);
      acc[nt][2 * hf] = x.x;
      acc[nt][2 * hf + 1] = x.y;
    }
  }
}

__device__ __forceinline__ void acc_store(const float (&acc)[4][4],
                                          float* __restrict__ dst,
                                          const Tile& tl, int kd, int vd) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = tl.col(nt);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = tl.r0 + tl.g8 + 8 * hf;
      if (row < kd && c < vd)
        *reinterpret_cast<float2*>(dst + (size_t)row * vd + c) =
            make_float2(acc[nt][2 * hf], acc[nt][2 * hf + 1]);
    }
  }
}

// The accumulators into a padded shared array.
template <int P>
__device__ __forceinline__ void acc_to_smem(const float (&acc)[4][4],
                                            float (*dst)[P], const Tile& tl) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int c = tl.col(nt);
    *reinterpret_cast<float2*>(&dst[tl.r0 + tl.g8][c]) =
        make_float2(acc[nt][0], acc[nt][1]);
    *reinterpret_cast<float2*>(&dst[tl.r0 + tl.g8 + 8][c]) =
        make_float2(acc[nt][2], acc[nt][3]);
  }
}

// A state [kd, vd] float32 in device memory (null: zeros) into a padded
// shared array by cp.async, zero past kd / vd (those copies read nothing
// from `any`, a valid device address), one group a thread.
template <int P>
__device__ __forceinline__ void state_async(float (*dst)[P],
                                            const float* __restrict__ src,
                                            const void* any, int kd,
                                            int vd) {
  for (int e = threadIdx.x; e < kDim * kDim / 4; e += kThreads) {
    const int row = e >> 4, col = (e & 15) * 4;
    const bool ok = src != nullptr && row < kd && col < vd;
    cp_async16(&dst[row][col], ok ? src + (size_t)row * vd + col : any,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ Rows rows_of(int b, int h, int n_steps,
                                        int n_heads, int kd, int vd) {
  Rows g;
  g.step_k = (size_t)n_heads * kd;
  g.step_v = (size_t)n_heads * vd;
  g.base_k = (size_t)b * n_steps * g.step_k + (size_t)h * kd;
  g.base_v = (size_t)b * n_steps * g.step_v + (size_t)h * vd;
  g.kd = kd;
  g.vd = vd;
  return g;
}

// The split instantiation's first pass: segment c of (b, h) from a zero
// state and a zero end-gradient, sub-chunk by sub-chunk: its local end
// state (written to ls[bh, c] for c < n_seg - 1), its local
// start-gradient (lg[bh, c - 1] for c > 0) and its decay product
// (dec[bh, c]).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_local_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const T* __restrict__ dy, float* __restrict__ ls,
                      float* __restrict__ lg, float* __restrict__ dec,
                      int n_steps, int n_heads, int kd, int vd, int seg) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int bh = blockIdx.x, c = blockIdx.y, n_seg = gridDim.y;
  const Rows g = rows_of<T>(bh / n_heads, bh % n_heads, n_steps, n_heads,
                            kd, vd);
  const int t_begin = c * seg, t_end = min(n_steps, t_begin + seg);
  const int n_sub = (t_end - t_begin + kSub - 1) / kSub;
  auto len_of = [&](int n) { return min(kSub, t_end - t_begin - n * kSub); };
  const Tile tl;
  float acc_s[4][4] = {}, acc_g[4][4] = {};
  float before = 1.f;            // walker thread kk: prod of w so far
  stage(sm, r, k, w, v, dy, g, t_begin, len_of(0), true);
  for (int n = 0; n < n_sub; ++n) {
    cp_async_wait<0>();
    __syncthreads();             // raw is in; the last products are done
    convert(sm, g, len_of(n), true);
    __syncthreads();
    if (threadIdx.x < kDim)
      before *= walks(sm, threadIdx.x, before, true);
    else if (n + 1 < n_sub)
      stage(sm, r, k, w, v, dy, g, t_begin + (n + 1) * kSub, len_of(n + 1),
            true, kDim, kThreads - kDim);
    __syncthreads();
    state_update<kPA>(acc_s, sm, sm.ksuf, kV, tl, true);
    state_update<kPB>(acc_g, sm, sm.rpre, kDY, tl, false);
  }
  const size_t cells = (size_t)kd * vd;
  const int n_carry = n_seg - 1;
  if (c < n_carry) acc_store(acc_s, ls + ((size_t)bh * n_carry + c) * cells,
                             tl, kd, vd);
  if (c > 0) acc_store(acc_g, lg + ((size_t)bh * n_carry + c - 1) * cells,
                       tl, kd, vd);
  if (threadIdx.x < kd) dec[((size_t)bh * n_seg + c) * kd + threadIdx.x] =
      before;
}

// One thread per (b, h, k, v): ls[bh, c] becomes the start state of
// segment c + 1, from the initial state (or zero) through the segments in
// order; lg[bh, c] the gradient reaching segment c's end, from the final
// state's gradient (or zero) through the segments last to first.
__global__ void __launch_bounds__(kCarryThreads)
wkv6_bwd_carry(const float* __restrict__ s0, const float* __restrict__ dsf,
               float* __restrict__ ls, float* __restrict__ lg,
               const float* __restrict__ dec, int n_bh, int kd, int vd,
               int n_seg) {
  const size_t e = (size_t)blockIdx.x * kCarryThreads + threadIdx.x;
  const size_t cells = (size_t)kd * vd;
  if (e >= (size_t)n_bh * cells) return;
  const size_t bh = e / cells, kv = e % cells;
  const int kk = (int)(kv / vd), n_carry = n_seg - 1;
  float x = s0 != nullptr ? s0[e] : 0.f;
  for (int c = 0; c < n_carry; ++c) {
    const size_t slot = (bh * n_carry + c) * cells + kv;
    x = dec[(bh * n_seg + c) * kd + kk] * x + ls[slot];
    ls[slot] = x;
  }
  float y = dsf != nullptr ? dsf[e] : 0.f;
  for (int c = n_carry - 1; c >= 0; --c) {
    const size_t slot = (bh * n_carry + c) * cells + kv;
    y = dec[(bh * n_seg + c + 1) * kd + kk] * y + lg[slot];
    lg[slot] = y;
  }
}

// Lane q's row of slot `slot` in the per-key walk: slots take rows q, 7 -
// q, 8 + q and 15 - q, so the four lanes of a key cover the 16 rows and
// slot s needs at most 4 s + 4 steps of the recurrences.
__device__ __forceinline__ int row_of(int slot, int q) {
  return slot == 0 ? q : slot == 1 ? 7 - q : slot == 2 ? 8 + q : 15 - q;
}

// The per-key walk of one prepared sub-chunk, four lanes a key (kk = 8
// warp + lane / 4, q = lane % 4), every warp: lane q takes rows j of its
// four slots: M_t^(j) (t <= j) by M_{t+1} = w_t M_t + k_t A_jt, so dr_j
// = pre_j SdY_j + M_j^(j) + u k_j g_j; then, walking t down from j with
// p = pair_jt, X_t += p r_j M_t^(j) and dk's sum += p r_j A_jt.  Those
// two sums go over the key's four lanes by a reduce-scatter (lane q
// keeps rows 4q .. 4q+3), where dk_t and dw_t are completed with Z_t and
// W_t.  Adds r_j k_j g_j of its rows to (du_hi, du_lo).
template <typename T>
__device__ __forceinline__ void key_walk(const Smem<T>& sm, int len, int kd,
                                         T* __restrict__ dr,
                                         T* __restrict__ dk,
                                         T* __restrict__ dw, size_t o,
                                         size_t step_k, float& du_hi,
                                         float& du_lo) {
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int kk = 8 * (threadIdx.x >> 5) + (lane >> 2);
  const bool emit = kk < kd;
  o += kk;
  float wv[kSub], kv[kSub];
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    wv[t] = sm.in[kW][t][kk];
    kv[t] = sm.in[kK][t][kk];
  }
  float cross[kSub], dk_in[kSub];
#pragma unroll
  for (int t = 0; t < kSub; ++t) cross[t] = dk_in[t] = 0.f;
  const float uu = sm.u[kk];
#pragma unroll
  for (int slot = 0; slot < 4; ++slot) {
    const int jm = 4 * slot + 3, j = row_of(slot, q);
    const float* arow = sm.a[j];
    float av[kSub];              // A[j][0 .. jm], four to a load
#pragma unroll
    for (int t = 0; t <= jm; t += 4) {
      const float4 x = *reinterpret_cast<const float4*>(arow + t);
      av[t] = x.x, av[t + 1] = x.y, av[t + 2] = x.z, av[t + 3] = x.w;
    }
    float m[kSub];               // M_t^(j), held at M_j^(j) past t = j
    m[0] = 0.f;
#pragma unroll
    for (int t = 0; t < jm; ++t)
      m[t + 1] = t < j ? fmaf(wv[t], m[t], kv[t] * av[t]) : m[t];
    const float rj = sm.in[kR][j][kk];
    float p = 1.f;               // pair_jt
#pragma unroll
    for (int t = jm - 1; t >= 0; --t) {
      if (t < j) {
        const float x = p * rj;
        cross[t] = fmaf(x, m[t], cross[t]);
        dk_in[t] = fmaf(x, av[t], dk_in[t]);
        p *= wv[t];
      }
    }
    const float kj = sm.in[kK][j][kk], gj = arow[j];
    if (emit && j < len)
      store(dr + o + (size_t)j * step_k,
            fmaf(sm.pre[j][kk], sm.sdy[j][kk], m[jm]) + uu * kj * gj);
    // du += r_j k_j (gh_j + gl_j), compensated.
    float e1, e2;
    const float rk = two_prod(rj, kj, e1);
    const float t1 = two_prod(rk, sm.gh[j], e2);
    add_pair(du_hi, du_lo, t1, e2 + rk * sm.gl[j] + e1 * sm.gh[j]);
  }
  // Lane q keeps rows 4q .. 4q+3 of the key's two sums: over lanes xor 2
  // (halves of 8 rows), then xor 1 (quarters).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool up = q & 2;
    const float gc = up ? cross[i] : cross[i + 8];
    const float gk = up ? dk_in[i] : dk_in[i + 8];
    cross[i] = (up ? cross[i + 8] : cross[i]) +
               __shfl_xor_sync(0xffffffffu, gc, 2);
    dk_in[i] = (up ? dk_in[i + 8] : dk_in[i]) +
               __shfl_xor_sync(0xffffffffu, gk, 2);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool up = q & 1;
    const float gc = up ? cross[i] : cross[i + 4];
    const float gk = up ? dk_in[i] : dk_in[i + 4];
    cross[i] = (up ? cross[i + 4] : cross[i]) +
               __shfl_xor_sync(0xffffffffu, gc, 1);
    dk_in[i] = (up ? dk_in[i + 4] : dk_in[i]) +
               __shfl_xor_sync(0xffffffffu, gk, 1);
  }
  // W_t = sum_{i<t} pair_ti k_i GV_i (up) and Z_t = sum_{j>t} pair_jt r_j
  // SdY_j (down), at this lane's rows.
  float wsel[4], zsel[4];
  float acc = 0.f;
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    if ((t >> 2) == q) wsel[t & 3] = acc;
    acc = fmaf(wv[t], acc, kv[t] * sm.gv[t][kk]);
  }
  acc = 0.f;
#pragma unroll
  for (int t = kSub - 1; t >= 0; --t) {
    if ((t >> 2) == q) zsel[t & 3] = acc;
    acc = fmaf(wv[t], acc, sm.in[kR][t][kk] * sm.sdy[t][kk]);
  }
  const float cc = sm.cpart[0][kk] + sm.cpart[1][kk];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = 4 * q + i;
    if (!emit || t >= len) continue;
    const float pt = sm.pre[t][kk], st = sm.suf[t][kk];
    const size_t ot = o + (size_t)t * step_k;
    store(dk + ot, fmaf(st, sm.gv[t][kk], dk_in[i]) +
                       uu * sm.in[kR][t][kk] * sm.a[t][t]);
    store(dw + ot, fmaf(pt * st, cc, fmaf(pt, zsel[i],
                                          fmaf(st, wsel[i], cross[i]))));
  }
}

// The main kernel: segment c of (b, h) (c = 0 and seg = S for chunked)
// from its start state (s0 or zeros for c = 0, ls[bh, c - 1] otherwise)
// and its end-gradient (dsf or zeros for the last segment, lg[bh, c]
// otherwise).  hs holds n_int sub-chunk starts a block; part_u [B, n_seg,
// H, K] du's partials (hi, then lo).
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
wkv6_bwd_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ w,
                      const T* __restrict__ u, const float* __restrict__ s0,
                      const T* __restrict__ dy, const float* __restrict__ dsf,
                      T* __restrict__ dr, T* __restrict__ dk,
                      T* __restrict__ dv, T* __restrict__ dw,
                      float* __restrict__ ds0, const float* __restrict__ ls,
                      const float* __restrict__ lg, float* __restrict__ hs,
                      float* __restrict__ part_u, int n_steps, int n_heads,
                      int kd, int vd, int seg, int n_int, int n_part) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
  const int bh = blockIdx.x, c = blockIdx.y, n_seg = gridDim.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x, warp = tid >> 5;
  const Rows g = rows_of<T>(b, h, n_steps, n_heads, kd, vd);
  const int t_begin = c * seg, t_end = min(n_steps, t_begin + seg);
  const int n_sub = (t_end - t_begin + kSub - 1) / kSub;
  auto len_of = [&](int n) { return min(kSub, t_end - t_begin - n * kSub); };
  const size_t cells = (size_t)kd * vd;
  const int n_carry = n_seg - 1;
  const float* start =
      c == 0 ? (s0 != nullptr ? s0 + (size_t)bh * cells : nullptr)
             : ls + ((size_t)bh * n_carry + c - 1) * cells;
  const float* g_end =
      c == n_carry ? (dsf != nullptr ? dsf + (size_t)bh * cells : nullptr)
                   : lg + ((size_t)bh * n_carry + c) * cells;
  float* starts = hs + ((size_t)bh * n_seg + c) * n_int * cells;
  // Sub-chunk n's start state: the segment's for n = 0, hs slot n - 1 for
  // 1 <= n <= n_sub - 2; the last one stays on chip.
  auto start_of = [&](int n) {
    return n == 0 ? start : starts + (size_t)(n - 1) * cells;
  };
  const Tile tl;
  if (tid < kDim) sm.u[tid] = tid < kd ? to_float(u[h * kd + tid]) : 0.f;

  // 1. Forward over sub-chunks 0 .. n_sub - 2 (k, w, v), the state in
  // accumulators.  Steps are numbered 0 .. 2 n_sub - 2: forward ones
  // first, then the backward ones (sub-chunk 2 n_sub - 2 - step).
  const int n_fwd = n_sub - 1, n_total = n_fwd + n_sub;
  auto sub_of = [&](int s) { return s < n_fwd ? s : n_total - 1 - s; };
  stage(sm, r, k, w, v, dy, g, t_begin + sub_of(0) * kSub,
        len_of(sub_of(0)), n_fwd == 0);
  float acc[4][4];
  acc_load(acc, start, tl, kd, vd);
  for (int s = 0; s < n_fwd; ++s) {
    cp_async_wait<0>();
    __syncthreads();
    convert(sm, g, len_of(s), false);
    __syncthreads();
    if (tid < kDim)
      walks(sm, tid, 1.f, false);
    else
      stage(sm, r, k, w, v, dy, g, t_begin + sub_of(s + 1) * kSub,
            len_of(sub_of(s + 1)), s + 1 >= n_fwd, kDim, kThreads - kDim);
    __syncthreads();
    state_update<kPA>(acc, sm, sm.ksuf, kV, tl, true);
    if (s + 1 < n_fwd) acc_store(acc, starts + (size_t)s * cells, tl, kd, vd);
  }
  // The last sub-chunk's start and the segment's end-gradient on chip
  // (no one reads st or g before the next barrier).
  if (n_fwd > 0) acc_to_smem<kPA>(acc, sm.st, tl);
  else state_async<kPA>(sm.st, start, r, kd, vd);
  state_async<kPB>(sm.g, g_end, r, kd, vd);

  // 2. Backward, last sub-chunk to first.
  float du_hi = 0.f, du_lo = 0.f;
  for (int s = n_fwd; s < n_total; ++s) {
    const int n = sub_of(s), len = len_of(n);
    cp_async_wait<0>();
    __syncthreads();             // raw is in; the last walk is done
    convert(sm, g, len, true);
    __syncthreads();
    gdot(sm, vd);
    if (warp < 2) walks(sm, tid, 1.f, true);
    else if (warp < 4) dots(sm, warp - 2, vd);
    else scores(sm, tid - 2 * kDim);
    // Warps 0-3 finish before the scores: they stage the next sub-chunk.
    if (warp < 4 && s + 1 < n_total)
      stage(sm, r, k, w, v, dy, g, t_begin + sub_of(s + 1) * kSub,
            len_of(sub_of(s + 1)), true, 0, 4 * 32);
    __syncthreads();
    // The tensor-core products, the corrections of 3xTF32 in their own
    // accumulators so the mma chains are short.  (a) SdY (warps 0-3) or GV
    // (4-7): 16 keys a warp, two tiles that share the A fragments.
    const int g8 = tl.g8, t4 = tl.t4;
    const int q16 = 16 * (warp & 3);
    if (q16 < kd) {
      const float(*lhs)[kPA] = warp < 4 ? sm.in[kDY] : sm.in[kV];
      const float* rhs = warp < 4 ? &sm.st[0][0] : &sm.g[0][0];
      const int pitch = warp < 4 ? kPA : kPB;
      float acc[2][2][4] = {};           // [tile][main, corr]
#pragma unroll
      for (int ks = 0; ks < kDim; ks += 8) {
        if (ks >= vd) break;
        const Frag fa = load_a<kPA>(&lhs[0][ks], g8, t4);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int k0 = q16 + 8 * nt;
          mma3_split(acc[nt][0], acc[nt][1], fa, load_b_of([&](int kk, int nn) {
            return rhs[(k0 + nn) * pitch + ks + kk]; }, g8, t4));
        }
      }
      float(*out)[kPA] = warp < 4 ? sm.sdy : sm.gv;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = q16 + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(&out[g8][col]) =
            make_float2(acc[nt][0][0] + acc[nt][1][0],
                        acc[nt][0][1] + acc[nt][1][1]);
        *reinterpret_cast<float2*>(&out[g8 + 8][col]) =
            make_float2(acc[nt][0][2] + acc[nt][1][2],
                        acc[nt][0][3] + acc[nt][1][3]);
      }
    }
    // (b) dv: warp w's 8 value columns.
    const int v0 = 8 * warp;
    if (v0 < vd) {
      float a3[2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < kDim; ks += 8) {
        if (ks >= kd) break;
        mma3_split(a3[(ks >> 3) & 1][0], a3[(ks >> 3) & 1][1],
                   load_a<kPA>(&sm.ksuf[0][ks], g8, t4),
                   load_b<kPB>(&sm.g[ks][v0], g8, t4));
      }
#pragma unroll
      for (int ks = 0; ks < kSub; ks += 8)
        mma3_split(a3[(ks >> 3) & 1][0], a3[(ks >> 3) & 1][1],
                   load_at<kPP>(&sm.p[ks][0], g8, t4),
                   load_b<kPA>(&sm.in[kDY][ks][v0], g8, t4));
      float x3[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x3[i] = (a3[0][0][i] + a3[1][0][i]) + (a3[0][1][i] + a3[1][1][i]);
      T* out = dv + g.base_v + (size_t)(t_begin + n * kSub) * g.step_v;
      const int col = v0 + 2 * t4;
      if (g8 < len) store2(out + (size_t)g8 * g.step_v + col, x3[0], x3[1]);
      if (g8 + 8 < len)
        store2(out + (size_t)(g8 + 8) * g.step_v + col, x3[2], x3[3]);
    }
    // (c) rowsum(G_end * S0) and the gradient before the sub-chunk.
    float acc_g[4][4];
    {
      float lo = 0.f, hi = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = tl.col(nt), row = tl.r0 + g8;
        const float2 gl = *reinterpret_cast<const float2*>(&sm.g[row][col]);
        const float2 gh =
            *reinterpret_cast<const float2*>(&sm.g[row + 8][col]);
        const float2 sl = *reinterpret_cast<const float2*>(&sm.st[row][col]);
        const float2 sh =
            *reinterpret_cast<const float2*>(&sm.st[row + 8][col]);
        lo = fmaf(gl.x, sl.x, fmaf(gl.y, sl.y, lo));
        hi = fmaf(gh.x, sh.x, fmaf(gh.y, sh.y, hi));
        acc_g[nt][0] = gl.x, acc_g[nt][1] = gl.y;
        acc_g[nt][2] = gh.x, acc_g[nt][3] = gh.y;
      }
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      lo += __shfl_xor_sync(0xffffffffu, lo, 2);
      hi += __shfl_xor_sync(0xffffffffu, hi, 1);
      hi += __shfl_xor_sync(0xffffffffu, hi, 2);
      if (t4 == 0) {
        sm.cpart[warp & 1][tl.r0 + g8] = lo;
        sm.cpart[warp & 1][tl.r0 + g8 + 8] = hi;
      }
    }
    state_update<kPB>(acc_g, sm, sm.rpre, kDY, tl, true);
    __syncthreads();             // every read of st and g is done
    acc_to_smem<kPB>(acc_g, sm.g, tl);
    if (n == 0 && c == 0 && ds0 != nullptr)
      acc_store(acc_g, ds0 + (size_t)bh * cells, tl, kd, vd);
    // The next sub-chunk's start state by cp.async, then the per-key walk.
    if (n > 0) state_async<kPA>(sm.st, start_of(n - 1), r, kd, vd);
    key_walk(sm, len, kd, dr, dk, dw,
             g.base_k + (size_t)(t_begin + n * kSub) * g.step_k, g.step_k,
             du_hi, du_lo);
  }
  // du's partial: the key's four lanes, then one (hi, lo) pair.
#pragma unroll
  for (int off = 1; off < 4; off *= 2)
    add_pair(du_hi, du_lo, __shfl_xor_sync(0xffffffffu, du_hi, off),
             __shfl_xor_sync(0xffffffffu, du_lo, off));
  const int kk = 8 * warp + ((tid & 31) >> 2);
  if ((tid & 3) == 0 && kk < kd) {
    const size_t e = ((size_t)b * n_seg + c) * n_heads * kd +
                     (size_t)h * kd + kk;
    part_u[e] = du_hi;
    part_u[e + (size_t)n_part * n_heads * kd] = du_lo;
  }
}

// du [H, K] from its n [H, K] partials (hi at part_u, lo n * hk
// floats on), a thread per (h, k), summed in place in a fixed tree
// (stride 1, 2, 4, ...), each pair compensated; the pairs of a level are
// loaded kTreeBatch at a time so their loads are in flight together.
constexpr int kTreeBatch = 8;
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
wkv6_bwd_reduce(float* __restrict__ part_u, T* __restrict__ du, int n,
                int hk) {
  const int e = blockIdx.x * kReduceThreads + threadIdx.x;
  if (e >= hk) return;
  float* hi = part_u + e;
  float* lo = part_u + (size_t)n * hk + e;
  for (int stride = 1; stride < n; stride *= 2) {
    for (int i0 = 0; i0 + stride < n; i0 += 2 * stride * kTreeBatch) {
      float h[kTreeBatch], l[kTreeBatch], h2[kTreeBatch], l2[kTreeBatch];
#pragma unroll
      for (int m = 0; m < kTreeBatch; ++m) {
        const int i = i0 + 2 * stride * m;
        if (i + stride >= n) break;
        h[m] = hi[(size_t)i * hk];
        l[m] = lo[(size_t)i * hk];
        h2[m] = hi[(size_t)(i + stride) * hk];
        l2[m] = lo[(size_t)(i + stride) * hk];
      }
#pragma unroll
      for (int m = 0; m < kTreeBatch; ++m) {
        const int i = i0 + 2 * stride * m;
        if (i + stride >= n) break;
        add_pair(h[m], l[m], h2[m], l2[m]);
        hi[(size_t)i * hk] = h[m];
        lo[(size_t)i * hk] = l[m];
      }
    }
  }
  store(du + e, __fadd_rn(hi[0], lo[0]));
}

// Floats of scratch at these sizes and the segment length seg (a
// multiple of 16; seg >= S: one segment): du's partials; each block's
// sub-chunk starts past the first, but for the last; and for more than
// one segment the carried states, end-gradients and decay products.
struct Layout {
  int n_seg, n_int;
  size_t part, hs, ls, lg, dec, total;
};

Layout layout_of(int batch, int n_steps, int n_heads, int kd, int vd,
                 int seg) {
  Layout l;
  if (seg <= 0 || seg > n_steps) seg = n_steps;
  l.n_seg = (n_steps + seg - 1) / seg;
  const int n_sub = (min(seg, n_steps) + kSub - 1) / kSub;
  l.n_int = n_sub > 2 ? n_sub - 2 : 0;
  const size_t n_bh = (size_t)batch * n_heads, cells = (size_t)kd * vd;
  const size_t n_carry = (size_t)l.n_seg - 1;
  l.part = 0;
  l.hs = l.part + 2 * (size_t)batch * l.n_seg * n_heads * kd;
  l.ls = l.hs + n_bh * l.n_seg * l.n_int * cells;
  l.lg = l.ls + n_bh * n_carry * cells;
  l.dec = l.lg + n_bh * n_carry * cells;
  l.total = l.dec + (n_carry > 0 ? n_bh * l.n_seg * kd : 0);
  return l;
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const float* s0,
                   const void* dy, const float* dsf, void* dr, void* dk,
                   void* dv, void* dw, void* du, float* ds0, float* scratch,
                   int batch, int n_steps, int n_heads, int kd, int vd,
                   int seg, cudaStream_t stream) {
  const size_t bytes = sizeof(Smem<T>);
  static const cudaError_t attr = [&] {   // once
    const cudaError_t e = allow_smem(wkv6_bwd_chunk_kernel<T>, bytes);
    return e != cudaSuccess ? e : allow_smem(wkv6_bwd_local_kernel<T>, bytes);
  }();
  if (attr != cudaSuccess) return attr;
  if (seg <= 0 || seg > n_steps) seg = n_steps;
  const Layout l = layout_of(batch, n_steps, n_heads, kd, vd, seg);
  const int n_bh = batch * n_heads;
  const T* tr = static_cast<const T*>(r);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tw = static_cast<const T*>(w);
  const T* tdy = static_cast<const T*>(dy);
  float* ls = scratch + l.ls;
  float* lg = scratch + l.lg;
  cudaError_t err;
  if (l.n_seg > 1) {
    float* dec = scratch + l.dec;
    wkv6_bwd_local_kernel<T><<<dim3(n_bh, l.n_seg), kThreads, bytes,
                               stream>>>(tr, tk, tv, tw, tdy, ls, lg, dec,
                                         n_steps, n_heads, kd, vd, seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const size_t cells = (size_t)n_bh * kd * vd;
    wkv6_bwd_carry<<<(unsigned)((cells + kCarryThreads - 1) / kCarryThreads),
                     kCarryThreads, 0, stream>>>(s0, dsf, ls, lg, dec, n_bh,
                                                 kd, vd, l.n_seg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  wkv6_bwd_chunk_kernel<T><<<dim3(n_bh, l.n_seg), kThreads, bytes, stream>>>(
      tr, tk, tv, tw, static_cast<const T*>(u), s0, tdy, dsf,
      static_cast<T*>(dr), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<T*>(dw), ds0, ls, lg, scratch + l.hs, scratch + l.part,
      n_steps, n_heads, kd, vd, seg, l.n_int, batch * l.n_seg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int hk = n_heads * kd;
  wkv6_bwd_reduce<T><<<(hk + kReduceThreads - 1) / kReduceThreads,
                       kReduceThreads, 0, stream>>>(
      scratch + l.part, static_cast<T*>(du), batch * l.n_seg, hk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t info(int which, int* out) {
  const size_t bytes = sizeof(Smem<T>);
  cudaFuncAttributes attr;
  int blocks = 0;
  cudaError_t err;
  if (which == 0) {
    err = allow_smem(wkv6_bwd_chunk_kernel<T>, bytes);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, wkv6_bwd_chunk_kernel<T>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wkv6_bwd_chunk_kernel<T>, kThreads, bytes);
  } else {
    err = allow_smem(wkv6_bwd_local_kernel<T>, bytes);
    if (err == cudaSuccess)
      err = cudaFuncGetAttributes(&attr, wkv6_bwd_local_kernel<T>);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, wkv6_bwd_local_kernel<T>, kThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)bytes;
  out[4] = kSub;
  return cudaSuccess;
}

bool bad_sizes(int batch, int n_steps, int n_heads, int kd, int vd,
               int seg) {
  return batch <= 0 || n_steps <= 0 || n_heads <= 0 || vd <= 0 ||
         vd > kDim || vd % 8 != 0 ||
         (kd != 8 && kd != 16 && kd != 32 && kd != 64) || seg < 0 ||
         seg % kSub != 0 ||
         (seg > 0 && (n_steps + seg - 1) / seg > 65535) ||
         (long long)batch * n_heads > 0x7fffffff;
}

}  // namespace

// r, k, w [B, S, H, K], v [B, S, H, V], u [H, K] as wkv6_launch takes
// them (one dtype: 0 = float32, 1 = bfloat16; contiguous, rows 16-byte
// aligned), state_in [B, H, K, V] float32 or null (zeros), dy [B, S, H,
// V] in the inputs' dtype and dstate_final [B, H, K, V] float32 or null
// (zeros).  Writes dr, dk, dw [B, S, H, K], dv [B, S, H, V] and du [H, K]
// in the inputs' dtype, and dstate [B, H, K, V] float32 unless it is
// null.  K is 8, 16, 32 or 64 and V a multiple of 8 up to 64.  seg 0 (or
// seg >= S) is the chunked instantiation; a positive multiple of 16 below
// S the split one with segments of seg steps.  `scratch` holds the floats
// wkv6_bwd_scratch_floats reports.  Returns the cudaError_t of the
// launches.
extern "C" int wkv6_bwd_launch(const void* r, const void* k, const void* v,
                               const void* w, const void* u,
                               const void* state_in, const void* dy,
                               const void* dstate_final, void* dr, void* dk,
                               void* dv, void* dw, void* du, void* dstate,
                               void* scratch, int batch, int n_steps,
                               int n_heads, int kd, int vd, int dtype,
                               int seg, void* stream) {
  if (bad_sizes(batch, n_steps, n_heads, kd, vd, seg) || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(state_in);
  const float* dsf = static_cast<const float*>(dstate_final);
  float* ds0 = static_cast<float*>(dstate);
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return (int)launch<float>(r, k, v, w, u, s0, dy, dsf, dr, dk, dv, dw,
                                du, ds0, sc, batch, n_steps, n_heads, kd, vd,
                                seg, s);
    case 1:
      return (int)launch<__nv_bfloat16>(r, k, v, w, u, s0, dy, dsf, dr, dk,
                                        dv, dw, du, ds0, sc, batch, n_steps,
                                        n_heads, kd, vd, seg, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// What kernel `which` (0 the main kernel, 1 the split's first pass) takes
// (dtype 0 = float32, 1 = bfloat16): out[0] registers a thread, out[1]
// local (spilled) bytes a thread, out[2] blocks resident on an SM, out[3]
// dynamic shared bytes a block, out[4] steps a sub-chunk.  Returns the
// cudaError_t of the queries.
extern "C" int wkv6_bwd_info(int dtype, int which, int* out) {
  if (out == nullptr || which < 0 || which > 1)
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      return (int)info<float>(which, out);
    case 1:
      return (int)info<__nv_bfloat16>(which, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The float32 scratch wkv6_bwd_launch takes at these sizes; -1 for sizes
// it refuses.
extern "C" long long wkv6_bwd_scratch_floats(int batch, int n_steps,
                                             int n_heads, int kd, int vd,
                                             int seg) {
  if (bad_sizes(batch, n_steps, n_heads, kd, vd, seg)) return -1;
  return (long long)layout_of(batch, n_steps, n_heads, kd, vd, seg).total;
}
