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
// The score and value products add 4 * row_len[b] * H * ctx_b * D flops,
// far below the bytes' time at these sizes.  At the serve path's shapes
// (B = 4, T <= 16, KV = 2, D = 64, float32, contexts under 100 rows) the
// bytes take well under a microsecond at 3.35 TB/s: the call is
// launch-bound, and what a design can win is latency.
//
// Design: the rows are split over blocks.  Grid (row tiles, KV, B): one
// block of 4 warps per 16 packed rows (token x group head) of one (slot,
// kv head), so the serve round's 112 rows of a slot take 7 blocks and the
// call 56, not the 8 blocks (one per slot and kv head, walking its rows
// in serial passes) of the first design.  A tile whose rows are all
// padding writes its zeros and returns.  Keys are staged 64 at a time
// (8 pages of 8 rows; above head dim 128 float32 stages 32, paged::Wide)
// by cp.async, 16 bytes a thread, each row through
// its own table entry, double-buffered; each warp owns 4 rows and spreads
// the keys over its lanes for the scores and the dims for the value
// product, with the row max and sum from warp shuffles
// (paged_attention_common.cuh, attend_tile).  Float32 stays on the FMA
// pipes (no TF32).  Padding rows (t >= row_len[b]) and idle slots come
// back as exact zeros.
#include "paged_attention_common.cuh"

namespace {

template <typename T, typename Cfg>
__global__ void __launch_bounds__(paged::kThreads)
paged_attention_varlen_kernel(const T* __restrict__ q,
                              const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages,
                              const int* __restrict__ tables,
                              const int* __restrict__ row_start,
                              const int* __restrict__ row_len,
                              T* __restrict__ out, paged::Geometry g) {
  const int b = blockIdx.z, kvh = blockIdx.y;
  paged::attend_tile<T, Cfg>(q, k_pages, v_pages, tables, out, b, kvh,
                        row_start[b], row_len[b],
                        blockIdx.x * paged::kRowTile, g);
}

template <typename T, typename Cfg>
cudaError_t launch_cfg(const void* q, const void* k_pages,
                       const void* v_pages, const int* tables,
                       const int* row_start, const int* row_len, void* out,
                       int batch, const paged::Geometry& g,
                       cudaStream_t stream) {
  auto kernel = paged_attention_varlen_kernel<T, Cfg>;
  // Raised once to what the instantiation's widest head dim needs.
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)paged::smem_bytes<T, Cfg>(Cfg::kMaxDim));
  if (attr != cudaSuccess) return attr;
  const int tiles = (g.T * (g.H / g.KV) + paged::kRowTile - 1) /
                    paged::kRowTile;
  kernel<<<dim3(tiles, g.KV, batch), paged::kThreads,
           paged::smem_bytes<T, Cfg>(g.D), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, row_start, row_len,
      static_cast<T*>(out), g);
  return cudaGetLastError();
}

// The instantiation by head dim: Narrow up to 128, Wide above.
template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* row_start,
                   const int* row_len, void* out, int batch,
                   const paged::Geometry& g, cudaStream_t stream) {
  if (g.D <= paged::Narrow::kMaxDim)
    return launch_cfg<T, paged::Narrow>(q, k_pages, v_pages, tables,
                                        row_start, row_len, out, batch, g,
                                        stream);
  return launch_cfg<T, paged::Wide<T>>(q, k_pages, v_pages, tables,
                                       row_start, row_len, out, batch, g,
                                       stream);
}

}  // namespace

// q [B, T, H, D], pages [KV, NB, BS, D], tables [B, M] int32, row_start and
// row_len [B] int32, out [B, T, H, D]; all contiguous, q/pages/out of one
// dtype.  window < 0 means global attention.  Returns cudaGetLastError().
extern "C" int paged_attention_varlen_launch(
    const void* q, const void* k_pages, const void* v_pages,
    const void* tables, const void* row_start, const void* row_len, void* out,
    int batch, int q_len, int heads, int kv_heads, int num_blocks,
    int block_size, int head_dim, int max_blocks, int window, float scale,
    int dtype, void* stream) {
  paged::Geometry g{q_len, heads, kv_heads, num_blocks, block_size, head_dim,
                    max_blocks, window, scale};
  cudaError_t err = paged::check_geometry(g, batch);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(tables);
  const int* rs = static_cast<const int*>(row_start);
  const int* rl = static_cast<const int*>(row_len);
  switch (dtype) {
    case paged::kFloat32:
      return (int)launch<float>(q, k_pages, v_pages, tbl, rs, rl, out, batch,
                                g, s);
    case paged::kBFloat16:
      return (int)launch<__nv_bfloat16>(q, k_pages, v_pages, tbl, rs, rl, out,
                                        batch, g, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
