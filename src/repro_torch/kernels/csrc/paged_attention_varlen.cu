// Ragged multi-row paged attention: chunked-prefill tiles, decode rows and
// verify rows of many slots in one launch.
//
// Replaces: src/repro/kernels/paged_attention_pallas.py,
// paged_attention_varlen (_paged_varlen_kernel), the Pallas TPU kernel of
// the serve engine's chunked prefill rounds
// (models/transformer.decode_step_paged_varlen).
//
// What bounds it on an H100: the K/V rows it must read, 2 * KV * ctx_b *
// D * sizeof(T) bytes per slot with ctx_b = row_start[b] + row_len[b],
// plus the query and output rows (2 * T * H * D * sizeof(T) per slot).
// The score and value products add 4 * row_len[b] * H * ctx_b * D flops.
// At the serve path's shapes (B = 4, T <= 16, KV = 2, D = 64, float32,
// contexts under 100 rows) the bytes take well under a microsecond at
// 3.35 TB/s: the call is launch-bound, and what a design can win is
// latency.  A long chunk is another matter: gemma3-12b's chunked prefill
// of a 2,048-token prompt (64 rows of 16 / 8 heads of 256 at contexts to
// 2,048) is 2.15 GFLOP against 33.6 MB, bound by operations (13.0 us at
// the 3xTF32 rate, 165 TFLOP/s).
//
// Design, D <= 128: the rows are split over blocks.  Grid (row tiles, KV,
// B): one block of 4 warps per 16 packed rows (token x group head) of one
// (slot, kv head), so the serve round's 112 rows of a slot take 7 blocks
// and the call 56.  A tile whose rows are all padding writes its zeros and
// returns.  Keys are staged 64 at a time (8 pages of 8 rows) by cp.async,
// 16 bytes a thread, each row through its own table entry, double-
// buffered; each warp owns 4 rows and spreads the keys over its lanes for
// the scores and the dims for the value product, with the row max and sum
// from warp shuffles (paged_attention_common.cuh, attend_tile).  Float32
// stays on the FMA pipes.
//
// Design, 128 < D <= 256 (gemma3's 256): varlen_d256_kernel below, on the
// tensor cores and split over the context.
// - Rows packed (token x group head) as above, 32 to a block of 8 warps:
//   two 16-row groups of four warps, one for each 64 output dims (a
//   64-row chunk's 128 rows of a slot take four blocks): the shared
//   routine of the float32 flash forward at D 256 (attention_d256.cuh:
//   3xTF32 mma.m16n8k8 in float32, mma.m16n8k16 in bfloat16 with float32
//   sums, P from the score accumulator).  Each row masks its own causal end
//   (row_start[b] + t) and, with a window, its own window start; tiles
//   inside every row's band skip the masks.
// - Grid (context splits x row blocks, KV, B).  A block's rows see keys
//   [first, last] (the oldest row's window start, the newest row's
//   position), cut into splits of chunk keys (split_chunk: span / n_splits
//   rounded up, at least min_keys, whole 32-key stages); a short context
//   takes one split and the other blocks of its group return at once.
//   n_splits comes from the host, from the geometry alone
//   (kernels/paged_attention_varlen.py, varlen_splits).
// - Keys arrive 32 a stage by 16-byte cp.async, each row through its own
//   table entry, in a ring of three stages (four in bfloat16); a key past
//   the split, past the table or
//   whose entry lies outside the pool is never read (zeros, and masked:
//   each tile's lookups are one ballot of a lane a key).
// - One split writes the output.  Otherwise each split writes its float32
//   partial (m, l, acc[D]) to scratch the wrapper allocates, and the last
//   block of a (slot, kv head, row block) to finish (an int32 ticket, which
//   it resets) merges the splits in split order: the same bits on every
//   call, no float atomics.  Padding rows and idle slots are exact zeros.
// - What holds it at 6.6x its bound: the tile routine's own work.
//   3xTF32 reached ~40 TFLOP/s of float32 products on an H100 here (the
//   flash kernel at D 256 as well), a quarter of the 165 at the wgmma
//   rate the bound is counted at; mma.sync alone runs 3xTF32 at ~108
//   there, the routine's score loop at ~67 (attention_d256.cuh).  The
//   long chunk's splits put one block on each SM, and the merge (the
//   last block's reads of every split's partial) is the tail.
#include "attention_d256.cuh"
#include "paged_attention_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(paged::kThreads)
paged_attention_varlen_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ tables,
                              const int* __restrict__ row_start,
                              const int* __restrict__ row_len,
                              T* __restrict__ out, paged::Geometry g) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  paged::attend_tile<T>(q, k_pages, v_pages, tables, out, b, kvh,
                        row_start[b], row_len[b],
                        blockIdx.x * paged::kRowTile, g);
}

template <typename T>
cudaError_t launch_narrow(const void* q, const void* k_pages,
                          const void* v_pages, const int* tables,
                          const int* row_start, const int* row_len,
                          void* out, int batch, const paged::Geometry& g,
                          cudaStream_t stream) {
  auto kernel = paged_attention_varlen_kernel<T>;
  // Raised once to what the widest head dim of the routine needs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)paged::smem_bytes<T>(paged::kNarrowMaxDim));
  if (attr != cudaSuccess) return attr;
  const int tiles = (g.T * (g.H / g.KV) + paged::kRowTile - 1) /
                    paged::kRowTile;
  kernel<<<dim3(tiles, g.KV, batch), paged::kThreads,
           paged::smem_bytes<T>(g.D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, row_start, row_len,
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 128 < D <= 256: tensor cores, split over the context.
// ---------------------------------------------------------------------------

namespace vd {

constexpr int kKeys = d256::kKeys;
constexpr int kMaxSplits = 32;   // splits a (slot, kv head, row block)
static_assert(kKeys == 32, "a tile's keys are one ballot, a lane a key");

// A block of 8 warps: two row groups of one 16-row m-tile (32 rows), Q
// in registers; float32 K/V stages (67 KB) three deep, bfloat16 (34 KB)
// four.  On an H100 this beat 64-row blocks (two m-tiles a warp, Q in
// shared memory) at chip_smoke.py phase 41's long chunks once their
// splits fill the card (PERF.md).
constexpr int kGroups = 2;                              // row groups a block
constexpr int kWarps = kGroups * d256::kWarpsPerTile;   // 8
constexpr int kThreads = 32 * kWarps;
constexpr int kM = 1;                                   // m-tiles a warp
constexpr int kRows = 16 * kM * kGroups;                // 32

template <typename T>
struct Shape {
  static constexpr int kStages = sizeof(T) == 2 ? 4 : 3;
  static constexpr size_t kRing = kStages * d256::stage_bytes<T>();
  static constexpr size_t kBytes = d256::exchange_bytes(kWarps, kM) + kRing;
  static_assert(kBytes <= 232448, "over an H100 block's shared memory");
  static_assert(sizeof(float) * (3 * kMaxSplits + 1) * kRows <= kRing,
                "the splits' merge reuses the K/V ring");
};

// Keys a non-empty split takes: the span over n_splits, at least min_keys,
// rounded up to a whole stage (kernels/paged_attention.py's split_chunk
// with stage 32, and the plain version, compute the same).
__device__ __forceinline__ int split_chunk(int span, int n_splits,
                                           int min_keys) {
  int c = (span + n_splits - 1) / n_splits;
  if (c < min_keys) c = min_keys;
  return (c + kKeys - 1) / kKeys * kKeys;
}

// part_acc [B, KV, T * G, n_splits, D] and part_ml [..., 2] float32 (read
// and written only by groups whose span takes more than one split);
// tickets [>= B * KV * row blocks] int32, all 0 between calls.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
varlen_d256_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                   const T* __restrict__ v_pages,
                   const int* __restrict__ tables,
                   const int* __restrict__ row_start,
                   const int* __restrict__ row_len, T* __restrict__ out,
                   float* __restrict__ part_acc, float* __restrict__ part_ml,
                   int* __restrict__ tickets, paged::Geometry g,
                   int n_splits, int min_keys) {
  using S = Shape<T>;
  constexpr int kK = d256::Pitch<T>::kK, kV = d256::Pitch<T>::kV;
  constexpr int kChunk = 16 / (int)sizeof(T);             // elements a copy
  constexpr int kRowChunks = d256::kMaxD / kChunk;        // copies a row
  extern __shared__ __align__(16) uint8_t smem[];
  float4* ex = reinterpret_cast<float4*>(smem);
  uint8_t* ring = smem + d256::exchange_bytes(kWarps, kM);
  auto k_stage = [&](int st) {
    return reinterpret_cast<T*>(ring + st * d256::stage_bytes<T>());
  };

  const int split = blockIdx.x % n_splits, rb = blockIdx.x / n_splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = g.H / g.KV, D = g.D, rows_total = g.T * G;
  const int r0 = rb * kRows;
  const int n_blk = min(kRows, rows_total - r0);   // the block's rows
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g8 = lane / 4, t4 = lane % 4;
  const int rg = warp / d256::kWarpsPerTile;
  const int dw = (warp % d256::kWarpsPerTile) * d256::kWarpDims;
  const bool has_window = g.window >= 0;
  const int base = row_start[b];
  const int n = min(max(row_len[b], 0), g.T);
  const int live_rows = n * G;
  // Packed row r of the slot: token r / G, head kvh * G + r % G.
  auto row_of = [&](T* p, int r) {
    return p + (((size_t)b * g.T + r / G) * g.H + kvh * G + r % G) * D;
  };
  auto at_of = [&](int r, int s) {   // a row's partial of split s
    return (((size_t)b * g.KV + kvh) * rows_total + r) * n_splits + s;
  };

  if (r0 >= live_rows) {   // only padding rows: zeros, written once
    if (split == 0)
      for (int e = tid; e < n_blk * D; e += kThreads)
        row_of(out, r0 + e / D)[e % D] = paged::from_float<T>(0.f);
    return;
  }
  // The keys the block's live rows see, [first, last]; this split's
  // [lo, hi].
  const int t_lo = r0 / G, t_hi = (min(r0 + kRows, live_rows) - 1) / G;
  const int last = base + t_hi;
  const int first = has_window ? max(0, base + t_lo - g.window + 1) : 0;
  const int span = last - first + 1;
  const int chunk = split_chunk(span, n_splits, min_keys);
  const int used = (span + chunk - 1) / chunk;   // splits that see a key
  if (split >= used) return;
  const int lo = first + split * chunk, hi = min(last, lo + chunk - 1);
  const int n_tiles = (hi - lo) / kKeys + 1;

  // Key j's page, or -1 past the split, past the table or outside the
  // pool (never read: its rows are staged as zeros and masked).
  auto page_of = [&](int j) {
    const int jp = j / g.BS;
    int page = -1;
    if (j <= hi && jp < g.M) page = tables[(size_t)b * g.M + jp];
    return page >= 0 && page < g.NB ? page : -1;
  };
  // Stage tile `it` of the split: each key row through its own table
  // entry, 16 bytes a copy, consecutive threads along a row.  Dims past D
  // are zero-filled.
  auto stage = [&](int it) {
    const int k0 = lo + it * kKeys;
    T* sk = k_stage(it % S::kStages);
    T* sv = sk + kKeys * kK;
#pragma unroll
    for (int i = 0; i < kKeys * kRowChunks / kThreads; ++i) {
      const int e = tid + i * kThreads;
      const int kk = e / kRowChunks, c = e % kRowChunks, j = k0 + kk;
      const int page = page_of(j);
      const bool real = page >= 0 && c * kChunk < D;
      const size_t at =
          real ? (((size_t)kvh * g.NB + page) * g.BS + j % g.BS) * D +
                     c * kChunk
               : 0;
      tf32::cp_async16(sk + kk * kK + c * kChunk, k_pages + at,
                       real ? 16 : 0);
      tf32::cp_async16(sv + kk * kV + c * kChunk, v_pages + at,
                       real ? 16 : 0);
    }
  };
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < n_tiles) stage(s);
    tf32::cp_async_commit();
  }

  // This row group's rows: positions [w_lo, w_hi]; a padding row has
  // position -1, a zero query, and attends nothing.
  const int wr0 = r0 + 16 * kM * rg;
  const bool group_live = wr0 < live_rows;
  const int w_lo = base + wr0 / G;
  const int w_hi = base + (min(wr0 + 16 * kM, live_rows) - 1) / G;
  int pos[kM][2];
  const T* qrow[kM][2];
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr0 + 16 * i + g8 + 8 * h;
      pos[i][h] = r < live_rows ? base + r / G : -1;
      qrow[i][h] = r < live_rows ? row_of(const_cast<T*>(q), r) : nullptr;
    }
  d256::QRegs<T, kM> qf;
  d256::load_q<T, kM>(qf, qrow, dw, D, g.scale, t4);
  d256::State<kM> st;
  d256::init(st);

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = lo + it * kKeys;
    // Bit kk: key k0 + kk was read (lane kk asks the table).
    const unsigned ok = __ballot_sync(0xffffffffu, page_of(k0 + lane) >= 0);
    const bool all_ok = ok == 0xffffffffu;
    if (it + S::kStages - 1 < n_tiles) stage(it + S::kStages - 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<S::kStages - 1>();
    __syncthreads();   // tile it is in
    // Does any row of the group see a key of the stage?  (The same answer
    // for its four warps, so all four reach d256::tile_sync.)
    if (group_live && k0 <= w_hi &&
        (!has_window || k0 + kKeys - 1 > w_lo - g.window)) {
      const bool edge = !all_ok || k0 + kKeys - 1 > w_lo ||
                        (has_window && k0 <= w_hi - g.window);
      d256::attend<T, kM>(st, qf, k_stage(it % S::kStages),
                          k_stage(it % S::kStages) + kKeys * kK, ex, warp,
                          edge, [&](int kk, int i, int h) {
                            const int key = k0 + kk;
                            return (ok >> kk & 1u) && key <= pos[i][h] &&
                                   (!has_window ||
                                    pos[i][h] - key < g.window);
                          });
    }
    __syncthreads();   // every warp is done with this stage and its scores
  }
  tf32::cp_async_wait<0>();
  d256::reduce_l(st);

  if (used == 1) {   // the one split writes the output, padding rows zeros
#pragma unroll
    for (int i = 0; i < kM; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wr0 + 16 * i + g8 + 8 * h;
        if (r < r0 + n_blk)
          d256::write_row(row_of(out, r), st, i, h, r < live_rows, dw, D,
                          t4);
      }
    return;
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wr0 + 16 * i + g8 + 8 * h;
      if (r >= live_rows) continue;
      const size_t at = at_of(r, split);
#pragma unroll
      for (int nt = 0; nt < d256::kNT; ++nt) {
        const int d = dw + 8 * nt + 2 * t4;
        if (d < D)
          d256::store2(part_acc + at * D + d, st.o[i][nt][2 * h],
                       st.o[i][nt][2 * h + 1]);
      }
      if (dw == 0 && t4 == 0)
        part_ml[2 * at] = st.m[i][h], part_ml[2 * at + 1] = st.l[i][h];
    }

  // The last block of this (slot, kv head, row block) merges the splits.
  __threadfence();
  __syncthreads();
  bool last_block = false;
  if (tid == 0) {
    int* ticket =
        tickets + ((size_t)b * g.KV + kvh) * (gridDim.x / n_splits) + rb;
    last_block = atomicAdd(ticket, 1) == used - 1;
    if (last_block) *ticket = 0;   // every used split has taken its ticket
  }
  if (!__syncthreads_or(last_block)) return;
  __threadfence();
  // Every split's (m, l) at once into shared memory (over the ring, now
  // free), each row's max, scales and sum in split order, then the
  // values: a thread takes 4 consecutive dims of a row (16-byte loads)
  // and two such runs at a time, all splits' loads of both issued before
  // any is summed (in split order): a loop whose every turn waited on one
  // L2 round trip made the merge, not the splits, the call's tail.
  const int nl = min(kRows, live_rows - r0);   // live rows of the block
  float* s_ml = reinterpret_cast<float*>(ring);   // [kMaxSplits][kRows][2]
  float* s_sc = s_ml + 2 * kMaxSplits * kRows;   // [kMaxSplits][kRows]
  float* s_lt = s_sc + kMaxSplits * kRows;       // [kRows]
  for (int e = tid; e < used * nl; e += kThreads) {
    const int s = e / nl, i = e % nl;
    const size_t at = at_of(r0 + i, s);
    s_ml[2 * (s * kRows + i)] = __ldcg(part_ml + 2 * at);
    s_ml[2 * (s * kRows + i) + 1] = __ldcg(part_ml + 2 * at + 1);
  }
  __syncthreads();
  if (tid < nl) {
    const int i = tid;
    float mb = d256::kNegInf;
    for (int s = 0; s < used; ++s)
      mb = fmaxf(mb, s_ml[2 * (s * kRows + i)]);
    float lb = 0.f;
    for (int s = 0; s < used; ++s) {
      const float sc = expf(s_ml[2 * (s * kRows + i)] - mb);
      s_sc[s * kRows + i] = sc;
      lb += s_ml[2 * (s * kRows + i) + 1] * sc;
    }
    s_lt[i] = lb;
  }
  __syncthreads();
  const int runs = D / 4;   // 4-dim runs a row
  for (int e0 = tid; e0 < n_blk * runs; e0 += 2 * kThreads) {
    float4 a[2][kMaxSplits / 4];
    int rows[2], dims[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = e0 + u * kThreads;
      rows[u] = e < n_blk * runs ? e / runs : kRows;
      dims[u] = 4 * (e % runs);
    }
    // Splits in chunks of kMaxSplits / 4, each chunk's loads together.
    float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                     make_float4(0.f, 0.f, 0.f, 0.f)};
    for (int s0 = 0; s0 < used; s0 += kMaxSplits / 4) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < kMaxSplits / 4; ++k)
          if (rows[u] < nl && s0 + k < used)
            a[u][k] = __ldcg(reinterpret_cast<const float4*>(
                part_acc + at_of(r0 + rows[u], s0 + k) * D + dims[u]));
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int k = 0; k < kMaxSplits / 4; ++k)
          if (rows[u] < nl && s0 + k < used) {
            const float sc = s_sc[(s0 + k) * kRows + rows[u]];
            acc[u].x += a[u][k].x * sc, acc[u].y += a[u][k].y * sc;
            acc[u].z += a[u][k].z * sc, acc[u].w += a[u][k].w * sc;
          }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      if (rows[u] >= n_blk) continue;
      const float inv =
          rows[u] < nl ? 1.f / fmaxf(s_lt[rows[u]], d256::kMinDenom) : 0.f;
      T* o = row_of(out, r0 + rows[u]) + dims[u];
      d256::store2(o, acc[u].x * inv, acc[u].y * inv);
      d256::store2(o + 2, acc[u].z * inv, acc[u].w * inv);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* row_start,
                   const int* row_len, void* out, float* part, int* tickets,
                   int batch, const paged::Geometry& g, int n_splits,
                   int min_keys, cudaStream_t stream) {
  if (n_splits < 1 || n_splits > kMaxSplits || min_keys < 1 ||
      (n_splits > 1 && (part == nullptr || tickets == nullptr)))
    return cudaErrorInvalidValue;
  using S = Shape<T>;
  auto kernel = varlen_d256_kernel<T>;
  static const cudaError_t attr = cudaFuncSetAttribute(   // once
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kBytes);
  if (attr != cudaSuccess) return attr;
  const int rows = g.T * (g.H / g.KV);
  const long long blocks =
      (long long)((rows + kRows - 1) / kRows) * n_splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  float* ml = part == nullptr
                  ? nullptr
                  : part + (size_t)batch * g.T * g.H * n_splits * g.D;
  kernel<<<dim3((unsigned)blocks, g.KV, batch), kThreads, S::kBytes,
           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, row_start, row_len,
      static_cast<T*>(out), part, ml, tickets, g, n_splits, min_keys);
  return cudaGetLastError();
}

}  // namespace vd

// The routine by head dim: attend_tile up to 128, the tensor-core split
// above.
template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* row_start,
                   const int* row_len, void* out, float* part, int* tickets,
                   int batch, const paged::Geometry& g, int n_splits,
                   int min_keys, cudaStream_t stream) {
  if (g.D <= paged::kNarrowMaxDim)
    return launch_narrow<T>(q, k_pages, v_pages, tables, row_start, row_len,
                            out, batch, g, stream);
  return vd::launch<T>(q, k_pages, v_pages, tables, row_start, row_len, out,
                       part, tickets, batch, g, n_splits, min_keys, stream);
}

}  // namespace

// q [B, T, H, D], pages [KV, NB, BS, D], tables [B, M] int32, row_start and
// row_len [B] int32, out [B, T, H, D]; all contiguous, q/pages/out of one
// dtype.  window < 0 means global attention.  Above head dim 128 the rows
// take n_splits context splits of at least min_keys keys; at n_splits > 1,
// part is float32 scratch of B * T * H * n_splits * (D + 2) and tickets
// int32 of B * KV * ceil(T * H / KV / 32), all 0 (the kernel leaves them
// 0).  D <= 128 reads none of the four.  Returns cudaGetLastError().
extern "C" int paged_attention_varlen_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* row_start, const void* row_len, void* out,
    void* part, void* tickets, int batch, int q_len, int heads, int kv_heads,
    int num_blocks, int block_size, int head_dim, int max_blocks, int window,
    int n_splits, int min_keys, float scale, int dtype, void* stream) {
  paged::Geometry g{q_len, heads, kv_heads, num_blocks, block_size, head_dim,
                    max_blocks, window, scale};
  cudaError_t err = paged::check_geometry(g, batch);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* rs = static_cast<const int*>(row_start);
  const int* rl = static_cast<const int*>(row_len);
  float* pf = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  switch (dtype) {
    case paged::kFloat32:
      return (int)launch<float>(q, k_pages, v_pages, tbl, rs, rl, out, pf, tk,
                                batch, g, n_splits, min_keys, s);
    case paged::kBFloat16:
      return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, tbl, rs, rl, out,
                                        pf, tk, batch, g, n_splits, min_keys,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
