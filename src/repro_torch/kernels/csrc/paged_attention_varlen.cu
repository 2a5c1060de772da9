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
// launch-bound.
//
// Design: one block per (slot, kv head), grid (B, KV), looping over the
// slot's row_len[b] tokens x H / KV group heads in passes of up to 16 rows.
// Each live page is loaded into shared memory once per pass and serves
// every row of the pass (the Pallas grid (B, H, M) re-streams it per query
// head).  Page skipping is keyed to the oldest row's window, as in the
// Pallas kernel.  Padding rows (t >= row_len[b]) and idle slots come back
// as exact zeros without computing anything.
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
  const int b = blockIdx.x, kvh = blockIdx.y;
  paged::attend_rows<T>(q, k_pages, v_pages, tables, out, b, kvh,
                        row_start[b], row_len[b], g);
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pages, const void* v_pages,
                   const int* tables, const int* row_start,
                   const int* row_len, void* out, int batch,
                   const paged::Geometry& g, cudaStream_t stream) {
  const size_t smem = paged::smem_bytes(g.BS, g.D);
  paged_attention_varlen_kernel<T><<<dim3(batch, g.KV), paged::kThreads, smem,
                                     stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), tables, row_start, row_len,
      static_cast<T*>(out), g);
  return cudaGetLastError();
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
