// The bfloat16 instantiation of flash_attention.cu at D 256 (gemma3-12b):
// Hopper's tensor cores (wgmma) fed by TMA, flash_attention_wgmma.cuh's
// design at four 128-byte atoms a row.  flash_attention.cu's launcher takes
// it for every bfloat16 input at D 256, with or without the logsumexp;
// float32 there keeps flash_kernel_d256 (3xTF32 mma.sync).
//
// What bounds it on an H100: operations at long S (4 D flops per attended
// (query, key) pair: 34.4 GFLOP for a global gemma3 layer at B 1 x S 2048,
// 0.0348 ms at the bf16 tensor-core peak of 989 TFLOP/s), bytes at the
// batched prefill (B 8 x S 32: 6.3 MB, 0.0019 ms at 3.35 TB/s).
//
// Design (one warpgroup of 128 threads per block, one block an SM; grid
// (row tiles, KV, B) flattened with the last row tiles, the heaviest
// causal rows, first), as the D-128 kernel but for what D 256 changes:
// - Registers: the output accumulator of m64n256 is 128 float32 a thread,
//   the score tile 32 more and P two alternating sets of 16; Q's A
//   fragments (64 more) do not fit beside them.  So Q stays in shared
//   memory and the scores are SS products (wgmma m64n64k16, A = the Q
//   tile, B = the K tile, both K-major), as FlashAttention-3 does at head
//   dim 256; the values stay RS (P in registers, m64n256k16, V MN-major).
// - A row of 256 bf16 is four 128-byte swizzle atoms, each its own TMA
//   box and 8 KB sub-tile: Q (64 packed rows, GQA-packed as at D 128: P =
//   64 / G positions x G heads), and K and V tiles of 64 keys, 32 KB each
//   a stage, in a ring of two.  Q + K + V = 160 KB (+1 KB alignment), so
//   one block an SM.
// - One warpgroup, not two sharing each K/V stage over a 128-row tile:
//   gemma3's batched prefill has 64 rows a (b, kv head) (B 8 x S 32 at G
//   2), which would leave the second warpgroup idle, and the 128-row
//   tile's Q (64 KB) with the two-stage ring leaves no room to deepen it.
// - Per tile `it`: its scores and tile it - 1's values are issued
//   together; the scores are waited for and the softmax runs while the
//   values are on the tensor cores; a K slot is refilled once its scores
//   are done, a V slot once its values are.  The masks, the -1e30 start,
//   the skipping of tiles wholly outside the band or window, ex2 on the
//   SFU (the running max in log2 units), bf16 P (as the plain version
//   casts its probabilities to q's dtype) and the logsumexp lse = m ln 2 +
//   log l are the D-128 kernel's.
// - Registers, spills and shared memory: the build's ptxas lines
//   (chip_smoke.py's build record); G <= 64 (the launcher refuses more).
#pragma once

#include "flash_attention_wgmma.cuh"

namespace {
namespace wg256 {

using wg::desc;
using wg::ex2;
using wg::kAtom;
using wg::kAtomBytes;
using wg::kKeys;
using wg::kLn2;
using wg::kLog2e;
using wg::kNegInf;
using wg::kRows;
using wg::kStages;
using wg::kThreads;
using wg::mbar_expect_tx;
using wg::mbar_init;
using wg::mbar_wait;
using wg::pack_bf16;
using wg::reg_fence;
using wg::smem_u32;
using wg::tma_load;
using wg::wgmma_commit;
using wg::wgmma_fence;
using wg::wgmma_wait;

constexpr int D = 256;
constexpr int kAtoms = D / kAtom;                  // 4
constexpr int kTileBytes = kAtoms * kAtomBytes;    // 32 KB: 64 rows
constexpr int kSmemBytes = (1 + 2 * kStages) * kTileBytes + 1024;

// d (+)= A B at N 64, A and B from shared memory, both K-major (the
// scores: Q and K tiles); accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

#define WG256_D128 \
  "{" \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, " \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, " \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, " \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, " \
  "%124, %125, %126, %127" \
  "}"
#define WG256_OUT128(d) \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
      "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
      "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
      "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
      "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), \
      "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), \
      "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), \
      "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), \
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), \
      "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), \
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), \
      "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), \
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), \
      "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), \
      "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), \
      "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), \
      "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
// d += A B at N 256, A from registers (P), B MN-major from shared memory
// (the V tile: the leading offset steps from one 64-column atom to the
// next).
__device__ __forceinline__ void wgmma_rs256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG256_D128
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : WG256_OUT128(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
#undef WG256_D128
#undef WG256_OUT128

// Accumulator fragments as in flash_kernel_wgmma: warp w holds rows 16w ..
// 16w + 15; lane l rows 16w + l/4 (h 0) and + 8 (h 1), and of each n-block
// j of 8 columns the two columns 8j + 2(l%4) + {0, 1}: d[4j + 2h + c].
template <bool kWindow>
__global__ void __launch_bounds__(kThreads, 1)
flash_kernel_wgmma256(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int batch, int seq,
                      int n_heads, int n_kv, int pos_per_tile,
                      int n_pos_tiles, int window, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ uint64_t bars[1 + 2 * kStages];   // Q, K stages, V stages
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* s_q = base;
  auto s_k = [&](int st) { return base + (1 + st) * kTileBytes; };
  auto s_v = [&](int st) { return base + (1 + kStages + st) * kTileBytes; };

  int x = blockIdx.x;
  const int kvh = x % n_kv;
  x /= n_kv;
  const int b = x % batch;
  const int pt = n_pos_tiles - 1 - x / batch;   // heaviest first

  const int group = n_heads / n_kv;
  const int p0 = pt * pos_per_tile;
  const int n_q = pos_per_tile * group;         // rows the Q box fills
  const int last = min(p0 + pos_per_tile, seq) - 1;
  const int first = kWindow ? max(0, p0 - window + 1) : 0;
  const int t0 = first / kKeys, n_tiles = last / kKeys - t0 + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Rows n_q .. 63 of each Q sub-tile are never written by TMA: zero them
  // so that their scores stay finite.
  for (int e = n_q * 8 + tid; e < kRows * 8; e += kThreads) {
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      reinterpret_cast<uint4*>(s_q + a * kAtomBytes)[e] =
          make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) {
    for (int i = 0; i < 1 + 2 * kStages; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  uint64_t* k_bar = &bars[1];
  uint64_t* v_bar = &bars[1 + kStages];
  auto load = [&](const CUtensorMap* map, uint8_t* dst, uint64_t* bar,
                  int tile) {
    mbar_expect_tx(bar, kTileBytes);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load(dst + a * kAtomBytes, map, bar, a * kAtom, kvh, tile * kKeys,
               b);
  };
  auto wait_tile = [&](uint64_t* bars_of, int it) {
    mbar_wait(&bars_of[it % kStages], (it / kStages) & 1);
  };
  if (tid == 0) {
    mbar_expect_tx(&bars[0], n_q * D * 2);
#pragma unroll
    for (int a = 0; a < kAtoms; ++a)
      tma_load(s_q + a * kAtomBytes, &tm_q, &bars[0], a * kAtom, kvh * group,
               p0, b);
    for (int st = 0; st < kStages && st < n_tiles; ++st) {
      load(&tm_k, s_k(st), &k_bar[st], t0 + st);
      load(&tm_v, s_v(st), &v_bar[st], t0 + st);
    }
  }

  int pos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = warp * 16 + lane / 4 + 8 * h;
    pos[h] = r < n_q ? p0 + r / group : -1;   // -1: pad row, attends nothing
  }
  float o[D / 2], sc[32], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sc[i] = 0.f;
  const uint32_t q_addr = smem_u32(s_q);

  // Scores sc = Q K^T of tile `it`, D / 16 k-steps of 16 (k-step kk at
  // byte 32 (kk % 4) of atom kk / 4 of both tiles); committed.
  auto issue_scores = [&](int it) {
    const uint32_t k_addr = smem_u32(s_k(it % kStages));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t at = (kk / 4) * kAtomBytes + 32 * (kk % 4);
      wgmma_ss(sc, desc(q_addr + at, 16, 1024), desc(k_addr + at, 16, 1024),
               kk);
    }
    wgmma_commit();
  };
  // o += P V of tile `it`, P in bf16 registers (the score fragment of keys
  // 16kk .. 16kk + 15 is the A fragment of k-step kk); committed.
  auto issue_values = [&](const uint32_t (&p)[4][4], int it) {
    const uint32_t v_addr = smem_u32(s_v(it % kStages));
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
      wgmma_rs256(o, p[kk],
                  desc(v_addr + kk * 16 * kAtom * 2, kAtomBytes, 1024));
    wgmma_commit();
  };
  // The online softmax of tile `it`'s scores, as flash_kernel_wgmma's.
  auto softmax = [&](int it, float (&alpha)[2], uint32_t (&p)[4][4]) {
    const int k0 = (t0 + it) * kKeys;
    const bool edge = k0 + kKeys - 1 > p0 ||
                      (kWindow && k0 < last - window + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          float s = sc[i] * scale_log2;
          if (edge) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + c;
            const bool ok =
                key <= pos[h] && (!kWindow || pos[h] - key < window);
            s = ok ? s : -INFINITY;
          }
          sc[i] = s;
          mx = fmaxf(mx, s);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = ex2(m[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 4 * j + 2 * h + c;
          sc[i] = ex2(sc[i] - m_new);   // masked: ex2(-inf) = 0
          sum += sc[i];
        }
      l[h] = l[h] * alpha[h] + sum;   // this lane's share; summed at the end
      m[h] = m_new;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        p[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
  };

  uint32_t pa[4][4], pb[4][4];
  float alpha[2];
  // Tile `it` >= 1: p_prev holds tile it - 1's P, p_next receives this
  // tile's (the two alternate, so no register an in-flight product reads
  // is written).
  auto step = [&](const uint32_t (&p_prev)[4][4], uint32_t (&p_next)[4][4],
                  int it) {
    wait_tile(k_bar, it);
    wait_tile(v_bar, it - 1);
    wgmma_fence();
    issue_scores(it);
    issue_values(p_prev, it - 1);
    wgmma_wait<1>();   // the scores; the values stay in flight
    reg_fence(sc);
    __syncthreads();   // every warp is done with this K slot
    if (tid == 0 && it + kStages < n_tiles)
      load(&tm_k, s_k(it % kStages), &k_bar[it % kStages], t0 + it + kStages);
    softmax(it, alpha, p_next);
    wgmma_wait<0>();
    reg_fence(o);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e / 2];
    __syncthreads();   // every warp is done with V slot (it - 1) % 2
    if (tid == 0 && it + 1 < n_tiles)
      load(&tm_v, s_v((it - 1) % kStages), &v_bar[(it - 1) % kStages],
           t0 + it + 1);
  };
  mbar_wait(&bars[0], 0);
  wait_tile(k_bar, 0);
  wgmma_fence();
  issue_scores(0);
  wgmma_wait<0>();
  reg_fence(sc);
  __syncthreads();   // every warp is done with K slot 0
  if (tid == 0 && kStages < n_tiles)
    load(&tm_k, s_k(0), &k_bar[0], t0 + kStages);
  softmax(0, alpha, pa);   // o is still 0: nothing to rescale
  int it = 1;
  for (; it + 1 < n_tiles; it += 2) {
    step(pa, pb, it);
    step(pb, pa, it + 1);
  }
  if (it < n_tiles) {   // one tile left: its P lands in pb
    step(pa, pb, it);
    wait_tile(v_bar, n_tiles - 1);
    wgmma_fence();
    issue_values(pb, n_tiles - 1);
  } else {
    wait_tile(v_bar, n_tiles - 1);
    wgmma_fence();
    issue_values(pa, n_tiles - 1);
  }
  wgmma_wait<0>();
  reg_fence(o);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int r = warp * 16 + lane / 4 + 8 * h;
    if (pos[h] < 0 || pos[h] >= seq) continue;
    const float l_safe = fmaxf(l[h], 1e-30f);
    const float inv = 1.f / l_safe;
    const size_t head_row =
        ((size_t)b * seq + pos[h]) * n_heads + kvh * group + r % group;
    __nv_bfloat16* row = out + head_row * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[4 * j + 2 * h] * inv,
                                o[4 * j + 2 * h + 1] * inv);
    if (lse != nullptr && lane % 4 == 0)
      lse[head_row] = m[h] * kLn2 + logf(l_safe);
  }
}

template <bool kWindow>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int batch, int seq, int n_heads, int n_kv,
                   int window, float scale, cudaStream_t stream) {
  const int group = n_heads / n_kv;
  if (group > kRows) return cudaErrorInvalidValue;
  const int pp = kRows / group;                 // positions per row tile
  const int n_pos_tiles = (seq + pp - 1) / pp;
  const long long blocks = (long long)n_pos_tiles * n_kv * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!wg::encode(&mq, q, D, batch, seq, n_heads, group, pp) ||
      !wg::encode(&mk, k, D, batch, seq, n_kv, 1, kKeys) ||
      !wg::encode(&mv, v, D, batch, seq, n_kv, 1, kKeys))
    return cudaErrorInvalidValue;
  auto kernel = flash_kernel_wgmma256<kWindow>;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (attr != cudaSuccess) return attr;
  kernel<<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, batch, seq, n_heads,
      n_kv, pp, n_pos_tiles, window, scale * kLog2e);
  return cudaGetLastError();
}

// window > 0: the sliding-window instantiation; 0: global.  lse null
// writes none.
inline cudaError_t launch_w(const void* q, const void* k, const void* v,
                            void* out, float* lse, int batch, int seq,
                            int n_heads, int n_kv, int window, float scale,
                            cudaStream_t stream) {
  if (window > 0)
    return launch<true>(q, k, v, out, lse, batch, seq, n_heads, n_kv, window,
                        scale, stream);
  return launch<false>(q, k, v, out, lse, batch, seq, n_heads, n_kv, 0, scale,
                       stream);
}

}  // namespace wg256
}  // namespace
