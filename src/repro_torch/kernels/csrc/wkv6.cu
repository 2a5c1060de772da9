// RWKV-6 (Finch) WKV recurrence: the output of every step and the final
// state, per (batch, head).
//
// Replaces: src/repro/kernels/wkv6_pallas.py, wkv6_pallas (_wkv6_kernel),
// the Pallas TPU kernel that runs the recurrence in its chunked parallel
// form (intra-chunk decayed score matrix on the MXU, a [K, V] state in
// VMEM scratch carried across the sequential chunk axis of its grid).
//
// What it computes, per (b, h), from state S [K, V] (zeros if absent):
//   y_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//   S[k, v] <- w_t[k] * S[k, v] + k_t[k] * v_t[v]
// for t = 0 .. S-1; the bonus term uses k_t, v_t before the update.
// r, k, w, u are [.., K], v and y [.., V]; inputs float32 or bfloat16,
// y in the inputs' dtype, the state and all arithmetic float32.
//
// What bounds it on an H100: bytes.  Each input is read once, y written
// once, the state read and written once: 18.9 MB for the serve prefill
// (B 8, S 32, H 32, K = V = 64, float32), 5.6 us at 3.35 TB/s, 8.7 MB
// (2.6 us) for one decode step, mostly the state, and 84 MB (25 us) for
// a B 1 x S 2048 layer.  The step-by-step form does ~5 float32
// operations per state element and step (0.67 GFLOP at B 1 x S 2048,
// 10 us at 67 TFLOP/s), but as a chain: one serial kernel thread per
// value column walks every step, so B 1 x S 2048 is 32 blocks of 2
// warps walking 2,048 dependent steps.
//
// Three instantiations; the wrapper (kernels/wkv6.py: wkv6_impl,
// split_steps) picks one from B, S and H and names it.
//
// serial (wkv6_kernel), for a decode step (S 1) and S under 8: one
// block per (b, h); thread v owns column S[:, v] in K float registers
// for the whole sequence, so the state touches device memory twice
// (coalesced).  Steps are staged 32 at a time in shared memory; the dot
// product over k keeps four partial sums.  K must be 8, 16, 32 or 64 and
// V at most 64.
//
// chunked (wkv6_chunk_kernel<T, true>), for prefills and long S: one
// block of 12 warps per (b, h) walks the sequence in sub-chunks of 16
// steps, the [K, V] state in shared memory.  Within a sub-chunk of L
// steps from state S, with pre_t = prod_{j<t} w_j, suf_i = prod_{j>i}
// w_j, pair_ti = prod_{i<j<t} w_j and total = prod_j w_j (over the
// sub-chunk, per key):
//   y_t = sum_{i<t} (r_t . (k_i * pair_ti)) v_i + (r_t . u k_t) v_t
//         + (r_t * pre_t) S
//   S  <- diag(total) S + (k * suf)^T v
// The terms of earlier sub-chunks reach y_t only through S: that is the
// TPU form's off-diagonal score blocks, (r_t e^{la_{t-1}-la_e}) .
// (k_i e^{la_e-la_i}), taken in the other order, which costs 2 K V
// operations a step whatever the chunk, against 2 K V plus ~(C - 16) (K
// + V) for score blocks over a chunk of C.  So the chunk is the 16-step
// sub-chunk itself, and a longer one would only add work: the state
// stays on chip, so carrying it every 16 steps moves no bytes.
// Three groups of four warps share each round (one block barrier a
// sub-chunk): each first prepares part of sub-chunk n + 1, whose r, k,
// w, v came by cp.async a round earlier (the y warps widen v; the state
// warps walk the decay products over its 16 steps, one thread per key;
// the prep warps stage n + 2 and form the 16 x 16 scores, a thread per
// (pair of rows, 4 keys) walking i down with pair_ti as a running
// product, summed over keys by a half-warp butterfly); then the y warps
// write sub-chunk n's y and the state warps advance S over it.  The
// scores, the longest part, overlap the y and state products.  Those
// products ((r * pre) S, scores v, (k * suf)^T v) run on the tensor
// cores: mma.m16n8k8 in 3xTF32 (each float32 operand split into two
// tf32 parts, three products), which holds float32 inputs to float32
// accuracy (plain TF32 would not); bfloat16 inputs are widened once, as
// prepared.
// Shared arrays are padded so that the fragments' reads hit 32 banks.
// What bounds it in practice is the sub-chunk's latency chain, not bytes
// or operations: prep, y and state share each SM's four schedulers, and
// the measured times (PERF.md) are ~3x the bytes bound at B 8 x S 512.
// Why w = 0 stays finite: decays enter only as products of w over spans
// of steps, each at most 1, computed by multiplication.  Nothing takes a
// logarithm (the TPU form's log(0) = -inf, and -inf - -inf = NaN) and
// nothing divides by a product of decays (the GPU "fla" form's overflow
// at small w); a product that underflows is the right answer, 0.
//
// split (wkv6_chunk_kernel<T, false>, wkv6_chunk_carry, then the emitting
// kernel), for long S at a B x H too small to fill the card: the steps
// of a segment compose into S_end = diag(prod w) S_start + S_local, where
// S_local is the segment's end state from zero.  (1) every segment but
// the last, in parallel, walks its sub-chunks from zero and writes its
// local end state and its decay product; (2) one thread per (b, h, k, v)
// turns those into true start states, in order from the given state; (3)
// every segment, in parallel, re-runs from its true start and writes y;
// the last one writes the final state.
//
// Any S >= 1; the chunked forms need V a multiple of 8 (16-byte rows).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;   // serial: one per value column (V <= 64)
constexpr int kMaxV = 64;
constexpr int kChunk = 32;     // serial: steps staged per pass

constexpr int kSub = 16;              // steps per sub-chunk
constexpr int kDim = 64;              // K and V, padded on chip
constexpr int kRoleThreads = 128;     // y, state and prep warps, 4 each
constexpr int kPrepThreads = kRoleThreads;
constexpr int kChunkThreads = 3 * kRoleThreads;
constexpr int kCarryThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Four consecutive staged elements as float32 (16 / 8-byte aligned).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
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
// Each round halves the values a lane keeps and swaps the other half
// with its partner: 8 + 4 + 2 + 1 shuffles, none waiting on another.
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

// Tensor-core products in float32 precision (3xTF32): each operand x is
// split into two tf32 values, hi and lo = x - hi, and a b is taken as
// a_lo b_hi + a_hi b_lo + a_hi b_hi, every sum in float32 (the a_lo b_lo
// term is below float32 rounding).  One fragment
// of mma.m16n8k8: lane (g8 = lane / 4, t4 = lane % 4).
struct Frag {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// hi is x rounded to its top 19 bits (sign, exponent, 10 mantissa bits:
// a tf32 value; half a unit rounds away from zero); lo = x - hi is exact
// in float32 and at most 2^-11 of x, and the tensor core reads its top
// 19 bits, so the dropped tail is ~2^-21 of x.  Three integer / float
// instructions, where cvt.rna.tf32 is five.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A (16 x 8) from a row-major array of pitch P at a: a[g8][t4],
// a[g8 + 8][t4], a[g8][t4 + 4], a[g8 + 8][t4 + 4].
template <int P>
__device__ __forceinline__ Frag load_a(const float* a, int g8, int t4) {
  const float x[4] = {a[g8 * P + t4], a[(g8 + 8) * P + t4],
                      a[g8 * P + t4 + 4], a[(g8 + 8) * P + t4 + 4]};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.hi[i], f.lo[i]);
  return f;
}

// A (16 x 8) as the transpose of a row-major array of pitch P at a:
// element (m, j) is a[j][m].
template <int P>
__device__ __forceinline__ Frag load_at(const float* a, int g8, int t4) {
  const float x[4] = {a[t4 * P + g8], a[t4 * P + g8 + 8],
                      a[(t4 + 4) * P + g8], a[(t4 + 4) * P + g8 + 8]};
  Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) split(x[i], f.hi[i], f.lo[i]);
  return f;
}

// B (8 x 8) from a row-major array of pitch P at b: b[t4][g8],
// b[t4 + 4][g8].
template <int P>
__device__ __forceinline__ FragB load_b(const float* b, int g8, int t4) {
  FragB f;
  split(b[t4 * P + g8], f.hi[0], f.lo[0]);
  split(b[(t4 + 4) * P + g8], f.hi[1], f.lo[1]);
  return f;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d (16 x 8: d[0], d[1] at row g8, columns 2 t4, 2 t4 + 1; d[2], d[3]
// at row g8 + 8) += a b.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a,
                                     const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// Two consecutive outputs (an even column).
__device__ __forceinline__ void store2(float* p, float x0, float x1) {
  *reinterpret_cast<float2*>(p) = make_float2(x0, x1);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x0,
                                       float x1) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x0, x1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k,
            const T* __restrict__ v, const T* __restrict__ w,
            const T* __restrict__ u, const float* __restrict__ s0,
            T* __restrict__ y, float* __restrict__ sf, int n_steps,
            int n_heads, int vd) {
  __shared__ float s_r[kChunk][K];
  __shared__ float s_k[kChunk][K];
  __shared__ float s_w[kChunk][K];
  __shared__ float s_v[kChunk][kMaxV];
  __shared__ float s_u[K];

  const int bh = blockIdx.x;              // b * H + h
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x;
  const bool owns = tid < vd;             // this thread's column exists

  float st[K];                            // S[:, tid]
  const size_t st_base = (size_t)bh * K * vd + tid;
#pragma unroll
  for (int i = 0; i < K; ++i)
    st[i] = (owns && s0 != nullptr) ? s0[st_base + (size_t)i * vd] : 0.f;
  for (int i = tid; i < K; i += kThreads) s_u[i] = to_float(u[h * K + i]);

  // Row t of (b, h) starts at ((b * S + t) * H + h) * K in r, k, w and
  // at ((b * S + t) * H + h) * V in v and y.
  const size_t step_k = (size_t)n_heads * K, step_v = (size_t)n_heads * vd;
  const size_t base_k = (size_t)b * n_steps * step_k + (size_t)h * K;
  const size_t base_v = (size_t)b * n_steps * step_v + (size_t)h * vd;

  for (int t0 = 0; t0 < n_steps; t0 += kChunk) {
    const int len = min(kChunk, n_steps - t0);
    __syncthreads();   // the previous chunk is consumed; s_u is set
    for (int e = tid; e < len * K; e += kThreads) {
      const int j = e / K, i = e % K;
      const size_t g = base_k + (size_t)(t0 + j) * step_k + i;
      s_r[j][i] = to_float(r[g]);
      s_k[j][i] = to_float(k[g]);
      s_w[j][i] = to_float(w[g]);
    }
    for (int e = tid; e < len * vd; e += kThreads) {
      const int j = e / vd, i = e % vd;
      s_v[j][i] = to_float(v[base_v + (size_t)(t0 + j) * step_v + i]);
    }
    __syncthreads();
    if (!owns) continue;
    for (int j = 0; j < len; ++j) {
      const float vv = s_v[j][tid];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < K; ++i) {
        const float kv = s_k[j][i] * vv;
        acc[i & 3] = fmaf(s_r[j][i], fmaf(s_u[i], kv, st[i]), acc[i & 3]);
        st[i] = fmaf(s_w[j][i], st[i], kv);
      }
      store(y + base_v + (size_t)(t0 + j) * step_v + tid,
            (acc[0] + acc[1]) + (acc[2] + acc[3]));
    }
  }
  if (owns) {
#pragma unroll
    for (int i = 0; i < K; ++i) sf[st_base + (size_t)i * vd] = st[i];
  }
}

// What one sub-chunk leaves for the y and state warps.
// Row pitches (floats) that put the 32 lanes' mma fragment reads on 32
// distinct banks: a row-major A operand (lane (g, t4) reads row g,
// column t4) needs a pitch of 4 mod 32, a B operand (row t4, column g)
// one of 8 mod 32.
constexpr int kPitchA = kDim + 4;      // r_pre
constexpr int kPitchB = kDim + 8;      // st, k_suf, vf
constexpr int kPitchS = kSub + 4;      // sc

struct Prepared {
  float r_pre[kSub][kPitchA];    // r_t * pre_t
  float k_suf[kSub][kPitchB];    // k_i * suf_i
  float vf[kSub][kPitchB];       // v as float32, zero past the edges
  float sc[kSub][kPitchS];       // scores, zero above the diagonal
  float tot[kDim];               // the sub-chunk's decay product
};

// Shared memory of the chunked kernels (dynamic, ~100 KB float32).
template <typename T>
struct __align__(16) ChunkSmem {
  T raw[2][4][kSub][kDim];       // r, k, w, v of two sub-chunks (cp.async)
  float st[2][kDim][kPitchB];    // the state at a sub-chunk's start
  Prepared prep[2];
  float u[kDim];
};

// Geometry of one (b, h) in [B, S, H, dim] rows.
struct Rows {
  size_t base_k, base_v, step_k, step_v;
};

// Stage `len` steps of r, k, w (kd wide) and v (vd wide) from step t0
// into raw[buf] by 16-byte cp.async, the kPrepThreads prep threads
// issuing one group: thread p copies piece p % 16 of rows p / 16, p / 16
// + 8 (a row holds at most 16 pieces).  Nothing is written past len or
// past kd / vd (the consumers mask those).
template <typename T>
__device__ __forceinline__ void stage(ChunkSmem<T>& sm, int buf, int p,
                                      const T* __restrict__ r,
                                      const T* __restrict__ k,
                                      const T* __restrict__ w,
                                      const T* __restrict__ v,
                                      const Rows& g, int t0, int len, int kd,
                                      int vd) {
  constexpr int kPer = 16 / sizeof(T);   // elements per 16-byte piece
  const int c = (p & 15) * kPer;
  for (int t = p >> 4; t < len; t += kPrepThreads / 16) {
    if (c < kd) {
      const size_t off = g.base_k + (size_t)(t0 + t) * g.step_k + c;
      cp_async16(&sm.raw[buf][0][t][c], r + off);
      cp_async16(&sm.raw[buf][1][t][c], k + off);
      cp_async16(&sm.raw[buf][2][t][c], w + off);
    }
    if (c < vd)
      cp_async16(&sm.raw[buf][3][t][c],
                 v + g.base_v + (size_t)(t0 + t) * g.step_v + c);
  }
  cp_async_commit();
}

// Preparing one staged sub-chunk of len steps (raw[buf]) into
// prep[buf] is split over the three groups of warps, 128 threads each
// (index w):
//   * prep_walks (the state warps): the decay walks, one thread per key,
//     its column loaded first so that the loads overlap: r * pre and the
//     product (forward, w < 64; returns the product, 1 for w >= 64), k *
//     suf (backward, w >= 64);
//   * prep_v (the y warps): v widened, zero past the edges;
//   * prep_scores (the prep warps, kEmit only): thread (m, group of keys
//     4q .. 4q+3) takes rows a = m and b = 15 - m, whose pairs number m
//     and 15 - m: 16 values with row b's bonus (slot 0), row b's pairs
//     (t, t - n) in slots n = 1 .. 15 - m, row a's in the m slots after
//     them, pair_ti a running product of w over (i, t); the 16 groups of
//     a half-warp sum them by a butterfly that leaves slot q's sum on
//     lane q.  Row a's bonus is summed apart.  Rows past len are formed
//     too (no y is written there).
template <typename T, bool kEmit>
__device__ __forceinline__ float prep_walks(ChunkSmem<T>& sm, int buf, int w,
                                            int len, int kd) {
  const T(*rr)[kDim] = sm.raw[buf][0];
  const T(*rk)[kDim] = sm.raw[buf][1];
  const T(*rw)[kDim] = sm.raw[buf][2];
  Prepared& pr = sm.prep[buf];
  float x[kSub], wv[kSub];
  const int kk = w & (kDim - 1);
  const bool fwd = w < kDim, col = kk < kd;
#pragma unroll
  for (int t = 0; t < kSub; ++t) {
    const bool in = t < len && col;
    x[t] = in ? to_float(fwd ? rr[t][kk] : rk[t][kk]) : 0.f;
    wv[t] = in ? to_float(rw[t][kk]) : 1.f;
  }
  if (fwd) {
    float pre = 1.f;
#pragma unroll
    for (int t = 0; t < kSub; ++t) {
      if (kEmit) pr.r_pre[t][kk] = x[t] * pre;
      pre *= wv[t];
    }
    pr.tot[kk] = pre;
    return pre;
  }
  float suf = 1.f;
#pragma unroll
  for (int t = kSub - 1; t >= 0; --t) {
    pr.k_suf[t][kk] = x[t] * suf;
    suf *= wv[t];
  }
  return 1.f;
}

template <typename T>
__device__ __forceinline__ void prep_v(ChunkSmem<T>& sm, int buf, int w,
                                       int len, int vd) {
  const T(*rv)[kDim] = sm.raw[buf][3];
  constexpr int kPerThread = kSub * kDim / kRoleThreads;
  float vx[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = w + j * kRoleThreads, t = e / kDim, cc = e % kDim;
    vx[j] = (t < len && cc < vd) ? to_float(rv[t][cc]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int e = w + j * kRoleThreads;
    sm.prep[buf].vf[e / kDim][e % kDim] = vx[j];
  }
}

template <typename T>
__device__ __forceinline__ void prep_scores(ChunkSmem<T>& sm, int buf,
                                            int p, int kd) {
  const T(*rr)[kDim] = sm.raw[buf][0];
  const T(*rk)[kDim] = sm.raw[buf][1];
  const T(*rw)[kDim] = sm.raw[buf][2];
  Prepared& pr = sm.prep[buf];
  const int m = p >> 4, q = p & 15, ra = m, rb = kSub - 1 - m;
  const bool keys = 4 * q < kd;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 uu = load4(&sm.u[4 * q]);
  const float4 r_a = keys ? load4(&rr[ra][4 * q]) : zero4;
  const float4 r_b = keys ? load4(&rr[rb][4 * q]) : zero4;
  float bonus_a;
  float sx[kSub];
  {
    const float4 ka = keys ? load4(&rk[ra][4 * q]) : zero4;
    const float4 kb = keys ? load4(&rk[rb][4 * q]) : zero4;
    bonus_a = half_sum(r_a.x * uu.x * ka.x + r_a.y * uu.y * ka.y +
                       r_a.z * uu.z * ka.z + r_a.w * uu.w * ka.w);
    sx[0] = r_b.x * uu.x * kb.x + r_b.y * uu.y * kb.y + r_b.z * uu.z * kb.z +
           r_b.w * uu.w * kb.w;
  }
  float4 pp = make_float4(1.f, 1.f, 1.f, 1.f);
#pragma unroll
  for (int s = 1; s < kSub; ++s) {
    // Slot s: row b's pair n = s while s <= rb, else row a's n = s - rb;
    // either way i = rb - s or ra - (s - rb), i.e. 15 - m - s or 15 - s.
    const bool row_b = s <= rb;
    if (s == rb + 1) pp = make_float4(1.f, 1.f, 1.f, 1.f);
    const int i = row_b ? rb - s : kSub - 1 - s;
    const float4 rt = row_b ? r_b : r_a;
    const float4 ki = keys ? load4(&rk[i][4 * q]) : zero4;
    const float4 wi = keys ? load4(&rw[i][4 * q]) : zero4;
    sx[s] = rt.x * ki.x * pp.x + rt.y * ki.y * pp.y + rt.z * ki.z * pp.z +
           rt.w * ki.w * pp.w;
    pp.x *= wi.x, pp.y *= wi.y, pp.z *= wi.z, pp.w *= wi.w;
  }
  half_reduce_scatter(sx, q);
  // Lane q's slot, and the zeros above both rows' diagonals.
  if (q == 0) {
    pr.sc[rb][rb] = sx[0];
    pr.sc[ra][ra] = bonus_a;
  } else if (q <= rb) {
    pr.sc[rb][rb - q] = sx[0];
  } else {
    pr.sc[ra][ra - (q - rb)] = sx[0];
  }
  if (ra + 1 + q < kSub) pr.sc[ra][ra + 1 + q] = 0.f;
  if (rb + 1 + q < kSub) pr.sc[rb][rb + 1 + q] = 0.f;
}

// One segment of one (b, h), in sub-chunks of 16 steps, by three groups
// of four warps.  A round (one block barrier): each group first
// does its part of preparing sub-chunk n + 1 (the y warps widen v, the
// state warps walk the decays, the prep warps stage n + 2 and form the
// scores), then the y warps write sub-chunk n's y and the state warps
// advance the state over it.  kEmit: from its
// true start state (s0 or zeros for segment 0, the carry pass's scratch
// otherwise), writing y and, for the last segment, the final state.
// !kEmit: from zero, writing only the segment's local end state and its
// decay product to scratch (hl [BH, C-1, K, V], sd [BH, C-1, K]).
template <typename T, bool kEmit>
__global__ void __launch_bounds__(kChunkThreads, 2)
wkv6_chunk_kernel(const T* __restrict__ r, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ w,
                  const T* __restrict__ u, const float* __restrict__ s0,
                  T* __restrict__ y, float* __restrict__ sf,
                  float* __restrict__ hl, float* __restrict__ sd,
                  int n_steps, int n_heads, int kd, int vd, int seg,
                  int n_carry) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChunkSmem<T>& sm = *reinterpret_cast<ChunkSmem<T>*>(smem_raw);

  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x;
  const int role = tid / kRoleThreads;   // 0 y, 1 state, 2 prep
  const int p = tid - 2 * kRoleThreads;  // prep thread index
  const int warp = tid / 32, g8 = (tid % 32) / 4, t4 = tid % 4;   // mma
  Rows g;
  g.step_k = (size_t)n_heads * kd;
  g.step_v = (size_t)n_heads * vd;
  g.base_k = (size_t)b * n_steps * g.step_k + (size_t)h * kd;
  g.base_v = (size_t)b * n_steps * g.step_v + (size_t)h * vd;
  const int t_begin = c * seg, t_end = min(n_steps, t_begin + seg);
  const int n_sub = (t_end - t_begin + kSub - 1) / kSub;
  auto sub_len = [&](int n) { return min(kSub, t_end - t_begin - n * kSub); };

  if (role == 2) {
    stage(sm, 0, p, r, k, w, v, g, t_begin, sub_len(0), kd, vd);
    if (n_sub > 1)
      stage(sm, 1, p, r, k, w, v, g, t_begin + kSub, sub_len(1), kd, vd);
  }
  // The start state into the mirror; u.
  const float* start = nullptr;
  if (kEmit)
    start = c == 0 ? (s0 != nullptr ? s0 + (size_t)bh * kd * vd : nullptr)
                   : hl + ((size_t)bh * n_carry + c - 1) * kd * vd;
  for (int e = tid; e < kDim * kDim; e += kChunkThreads) {
    const int kk = e / kDim, vv = e % kDim;
    sm.st[0][kk][vv] = (start != nullptr && kk < kd && vv < vd)
                           ? start[(size_t)kk * vd + vv] : 0.f;
  }
  if (tid < kDim) sm.u[tid] = tid < kd ? to_float(u[h * kd + tid]) : 0.f;
  if (role == 2) {
    if (n_sub > 1) cp_async_wait<1>(); else cp_async_wait<0>();
  }
  __syncthreads();   // raw[0], the mirror and u are in
  // Each group's part of preparing sub-chunk 0; in the loop, sub-chunk
  // n + 1's, before its own work on sub-chunk n.
  const int lw = tid % kRoleThreads;   // index within the group
  float dec = 1.f;   // state thread lw < 64: the segment's decay product
  if (role == 0) prep_v(sm, 0, lw, sub_len(0), vd);
  else if (role == 1) dec = prep_walks<T, kEmit>(sm, 0, lw, sub_len(0), kd);
  else if (kEmit) prep_scores(sm, 0, p, kd);

  for (int n = 0; n < n_sub; ++n) {
    const int buf = n & 1, len = sub_len(n);
    const bool more = n + 1 < n_sub;
    if (role == 2 && more) cp_async_wait<0>();   // sub-chunk n + 1
    __syncthreads();   // raw n + 1, prep[buf] and st[buf] are in
    const Prepared& pr = sm.prep[buf];
    if (role == 0) {
      if (more) prep_v(sm, buf ^ 1, lw, sub_len(n + 1), vd);
      // y: every row x the 16 columns from 16 w, two 16 x 8 tiles.
      const int c0 = 16 * warp;
      if (kEmit && c0 < vd) {
        float acc[2][4] = {};
        for (int ks = 0; ks < kd; ks += 8) {
          Frag a = load_a<kPitchA>(&pr.r_pre[0][ks], g8, t4);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3(acc[nt], a, load_b<kPitchB>(&sm.st[buf][ks][c0 + 8 * nt],
                                             g8, t4));
        }
#pragma unroll
        for (int ks = 0; ks < kSub; ks += 8) {
          Frag a = load_a<kPitchS>(&pr.sc[0][ks], g8, t4);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            mma3(acc[nt], a, load_b<kPitchB>(&pr.vf[ks][c0 + 8 * nt], g8,
                                             t4));
        }
        T* out = y + g.base_v + (size_t)(t_begin + n * kSub) * g.step_v;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = c0 + 8 * nt + 2 * t4;
          if (col >= vd) continue;
          if (g8 < len)
            store2(out + (size_t)g8 * g.step_v + col, acc[nt][0],
                   acc[nt][1]);
          if (g8 + 8 < len)
            store2(out + (size_t)(g8 + 8) * g.step_v + col, acc[nt][2],
                   acc[nt][3]);
        }
      }
    } else if (role == 1) {
      if (more)
        dec *= prep_walks<T, kEmit>(sm, buf ^ 1, lw, sub_len(n + 1), kd);
      // The state, rows 16 w' .. 16 w' + 15 (w' = warp - 4), from the
      // mirror into mma accumulators: S <- diag(tot) S + k_suf^T v.  (Kept
      // in registers across sub-chunks it would hold 32 registers in
      // every thread of the block, and two blocks an SM would spill.)
      const int r0 = 16 * (warp - 4);
      const float t_lo = pr.tot[r0 + g8], t_hi = pr.tot[r0 + g8 + 8];
      float st[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* lo = &sm.st[buf][r0 + g8][8 * nt + 2 * t4];
        const float2 a = *reinterpret_cast<const float2*>(lo);
        const float2 b = *reinterpret_cast<const float2*>(lo + 8 * kPitchB);
        st[nt][0] = a.x * t_lo, st[nt][1] = a.y * t_lo;
        st[nt][2] = b.x * t_hi, st[nt][3] = b.y * t_hi;
      }
#pragma unroll
      for (int ks = 0; ks < kSub; ks += 8) {
        Frag a = load_at<kPitchB>(&pr.k_suf[ks][r0], g8, t4);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mma3(st[nt], a, load_b<kPitchB>(&pr.vf[ks][8 * nt], g8, t4));
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float* lo = &sm.st[buf ^ 1][r0 + g8][8 * nt + 2 * t4];
        *reinterpret_cast<float2*>(lo) = make_float2(st[nt][0], st[nt][1]);
        *reinterpret_cast<float2*>(lo + 8 * kPitchB) =
            make_float2(st[nt][2], st[nt][3]);
      }
    } else if (more) {
      // raw[buf] held sub-chunk n, prepared last round: stage n + 2
      // there; then sub-chunk n + 1's scores.
      if (n + 2 < n_sub)
        stage(sm, buf, p, r, k, w, v, g, t_begin + (n + 2) * kSub,
              sub_len(n + 2), kd, vd);
      if (kEmit) prep_scores(sm, buf ^ 1, p, kd);
    }
  }
  __syncthreads();

  // The end state is in st[n_sub & 1].
  const float(*fin)[kPitchB] = sm.st[n_sub & 1];
  float* out = kEmit ? (c == gridDim.y - 1 ? sf + (size_t)bh * kd * vd
                                          : nullptr)
                     : hl + ((size_t)bh * n_carry + c) * kd * vd;
  if (out != nullptr)
    for (int e = tid; e < kd * vd; e += kChunkThreads)
      out[e] = fin[e / vd][e % vd];
  if (!kEmit && role == 1 && lw < kd)
    sd[((size_t)bh * n_carry + c) * kd + lw] = dec;
}

// One thread per (b, h, k, v): hl[bh, c] becomes the true start state
// of segment c + 1, from s0 (or zero) through the segments in order.
__global__ void __launch_bounds__(kCarryThreads)
wkv6_chunk_carry(const float* __restrict__ s0, float* __restrict__ hl,
                 const float* __restrict__ sd, int n_bh, int kd, int vd,
                 int n_carry) {
  const size_t e = (size_t)blockIdx.x * kCarryThreads + threadIdx.x;
  const size_t cells = (size_t)kd * vd;
  if (e >= (size_t)n_bh * cells) return;
  const size_t bh = e / cells, kv = e % cells;
  const int kk = (int)(kv / vd);
  float carry = s0 != nullptr ? s0[e] : 0.f;
  for (int c = 0; c < n_carry; ++c) {
    const size_t slot = bh * n_carry + c;
    carry = sd[slot * kd + kk] * carry + hl[slot * cells + kv];
    hl[slot * cells + kv] = carry;
  }
}

template <typename T, bool kEmit>
cudaError_t launch_chunk(dim3 grid, const void* r, const void* k,
                         const void* v, const void* w, const void* u,
                         const float* s0, void* y, float* sf, float* hl,
                         float* sd, int n_steps, int n_heads, int kd, int vd,
                         int seg, int n_carry, cudaStream_t stream) {
  auto kernel = wkv6_chunk_kernel<T, kEmit>;
  const size_t bytes = sizeof(ChunkSmem<T>);
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<grid, kChunkThreads, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<T*>(y), sf, hl, sd, n_steps,
      n_heads, kd, vd, seg, n_carry);
  return cudaGetLastError();
}

// seg == 0: the chunked instantiation (one segment); seg > 0: the split
// one, with segments of seg steps (a multiple of 16) and scratch for
// ceil(S / seg) - 1 carried states and decay products.
template <typename T>
cudaError_t launch_chunked(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const float* s0,
                           void* y, float* sf, float* scratch, int batch,
                           int n_steps, int n_heads, int kd, int vd, int seg,
                           cudaStream_t stream) {
  const int n_bh = batch * n_heads;
  if (seg == 0) seg = n_steps;
  const int n_seg = (n_steps + seg - 1) / seg, n_carry = n_seg - 1;
  float* hl = scratch;
  float* sd = n_carry > 0 ? scratch + (size_t)n_bh * n_carry * kd * vd
                          : nullptr;
  if (n_carry > 0) {
    cudaError_t err = launch_chunk<T, false>(
        dim3(n_bh, n_carry), r, k, v, w, u, s0, y, sf, hl, sd, n_steps,
        n_heads, kd, vd, seg, n_carry, stream);
    if (err != cudaSuccess) return err;
    const size_t cells = (size_t)n_bh * kd * vd;
    wkv6_chunk_carry<<<(unsigned)((cells + kCarryThreads - 1) /
                                  kCarryThreads),
                       kCarryThreads, 0, stream>>>(s0, hl, sd, n_bh, kd, vd,
                                                   n_carry);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_chunk<T, true>(dim3(n_bh, n_seg), r, k, v, w, u, s0, y, sf,
                               hl, sd, n_steps, n_heads, kd, vd, seg,
                               n_carry, stream);
}

template <typename T, int K>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const float* s0, void* y,
                   float* sf, int batch, int n_steps, int n_heads, int vd,
                   cudaStream_t stream) {
  wkv6_kernel<T, K><<<batch * n_heads, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(u), s0, static_cast<T*>(y), sf, n_steps, n_heads,
      vd);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int kd, const void* r, const void* k, const void* v,
                     const void* w, const void* u, const float* s0, void* y,
                     float* sf, int batch, int n_steps, int n_heads, int vd,
                     cudaStream_t stream) {
  switch (kd) {
    case 8:
      return launch<T, 8>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                          vd, stream);
    case 16:
      return launch<T, 16>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                           vd, stream);
    case 32:
      return launch<T, 32>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                           vd, stream);
    case 64:
      return launch<T, 64>(r, k, v, w, u, s0, y, sf, batch, n_steps, n_heads,
                           vd, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// r, k, w [B, S, H, K], v [B, S, H, V], u [H, K]: contiguous, one dtype
// (0 = float32, 1 = bfloat16).  state_in [B, H, K, V] float32 or null
// (zeros); y [B, S, H, V] in the inputs' dtype and state_out [B, H, K, V]
// float32 are written.  K is 8, 16, 32 or 64 and V at most 64.  impl 0
// runs the serial kernel; 1 the chunked one (V a multiple of 8); 2 the
// split one with segments of seg steps (a positive multiple of 16, V a
// multiple of 8) and `scratch` holding (ceil(S / seg) - 1) * B * H *
// (K * V + K) floats (null when that is 0).  Returns the cudaError_t of
// the launches.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u,
                           const void* state_in, void* y, void* state_out,
                           void* scratch, int batch, int n_steps,
                           int n_heads, int kd, int vd, int dtype, int impl,
                           int seg, void* stream) {
  if (batch <= 0 || n_steps <= 0 || n_heads <= 0 || vd <= 0 || vd > kMaxV ||
      (kd != 8 && kd != 16 && kd != 32 && kd != 64) || impl < 0 || impl > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* s0 = static_cast<const float*>(state_in);
  float* sf = static_cast<float*>(state_out);
  if (impl > 0) {
    if (vd % 8 != 0 || (long long)batch * n_heads > 0x7fffffff)
      return (int)cudaErrorInvalidValue;
    if (impl == 1) {
      seg = 0;
    } else if (seg <= 0 || seg % kSub != 0 ||
               (n_steps + seg - 1) / seg > 65535 ||
               (n_steps > seg && scratch == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  float* sc = static_cast<float*>(scratch);
  switch (dtype) {
    case 0:
      return impl == 0
          ? (int)launch_k<float>(kd, r, k, v, w, u, s0, y, sf, batch,
                                 n_steps, n_heads, vd, s)
          : (int)launch_chunked<float>(r, k, v, w, u, s0, y, sf, sc, batch,
                                       n_steps, n_heads, kd, vd, seg, s);
    case 1:
      return impl == 0
          ? (int)launch_k<__nv_bfloat16>(kd, r, k, v, w, u, s0, y, sf, batch,
                                         n_steps, n_heads, vd, s)
          : (int)launch_chunked<__nv_bfloat16>(r, k, v, w, u, s0, y, sf, sc,
                                               batch, n_steps, n_heads, kd,
                                               vd, seg, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
