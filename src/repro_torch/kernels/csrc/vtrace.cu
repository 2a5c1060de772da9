// V-trace targets and realigned advantages (paper Eqs. 14-15) in one
// time-parallel scan.
//
// Replaces: src/repro/kernels/vtrace_pallas.py, vtrace_pallas
// (_vtrace_kernel), the Pallas TPU kernel that keeps a [8, T] tile of
// each input in VMEM and runs the backward recurrence with its carry in
// vector registers, one grid step per 8 trajectories.
//
// What it computes, per trajectory b and step t (V_T and vs_T are the
// bootstrap value):
//   ratio = exp(log_ratio), rho = min(rho_bar, ratio),
//   c = lam * min(c_bar, ratio),
//   delta_t = rho_t * (r_t + d_t * V_{t+1} - V_t),
//   acc_t = delta_t + d_t * c_t * acc_{t+1},   vs_t = V_t + acc_t,
//   adv_t = r_t + d_t * vs_{t+1} - V_t,
// float32 arithmetic from float32 or bfloat16 inputs, float32 outputs.
//
// What bounds it on an H100: its bytes are few, four [B, T] inputs and
// the bootstrap read once and two [B, T] float32 outputs written once,
// 12.0 MB at the paper's B = 500, T = 1000 in float32, 3.6 us at 3.35
// TB/s.  Walked step by step, acc is a chain of T dependent
// multiply-adds per trajectory: the first design (a thread per
// trajectory, a block per 32) gave B = 500 16 blocks on 132 SMs and a
// chain of 1,000 steps, 111 us.
//
// Design: acc_t = delta_t + a_t acc_{t+1} (a = d c) is an affine map of
// acc_{t+1}, and affine maps compose associatively, so the chain is a
// scan.  One warp per trajectory (B warps, four a block); time is cut
// into tiles of 32 x seg steps (seg = min(32, ceil(T / 32)): T = 1000 is
// one tile), walked from the last, and in a tile lane j owns the seg
// consecutive steps from j x seg.  Per tile:
//   1. the warp reads the tile along t (consecutive lanes, consecutive
//      steps: coalesced; eight steps' loads issued before any is used,
//      so a tile costs a few memory latencies, not 32), computes delta
//      and a there and stores them in shared memory in step order, one
//      pad word every 32 so that the lanes' segment walks hit distinct
//      banks; steps past T are the identity map (delta 0, a 1);
//   2. each lane composes its segment's map, acc_start = A acc_in + B,
//      walking backwards;
//   3. an inclusive warp-shuffle scan from the right (offsets 1 .. 16)
//      composes the maps of lanes j .. 31, so lane j gets the acc at its
//      segment's start from the acc entering the tile; lane j's acc_in
//      is lane j + 1's start (the tile's incoming acc for lane 31);
//   4. each lane re-runs its segment from acc_in and stores every acc_t;
//   5. the warp writes vs and the advantages along t, with vs_{t+1}
//      from the neighbouring step (the next tile's first acc across the
//      tile edge, the bootstrap at T).
// The dependent chain is ~2 x seg + 5 shuffles a tile instead of T, and
// B = 500 fills the card with 500 warps.  Every input is read from
// device memory once (step 5 re-reads V, r and d from L1 / L2).  Any B
// >= 1 and T >= 1.  The reassociated sums stay within the recurrence's
// float32 rounding: ref.ref_vtrace_segmented is this algebra, plainly.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;            // trajectories per block
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxSeg = 32;          // steps a lane owns in a tile
constexpr int kBatch = 8;            // steps whose loads go out together
constexpr int kTileWords = 32 * kMaxSeg + kMaxSeg;   // one pad a 32

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Step i of a tile in shared memory: one pad word after every 32, so
// that the 32 lanes' segment walks (lane j at j * seg + m) fall on
// distinct banks for the seg values that matter (32: banks j + m).
__device__ __forceinline__ int word(int i) { return i + (i >> 5); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
vtrace_kernel(const T* __restrict__ log_ratios, const T* __restrict__ values,
              const T* __restrict__ bootstrap, const T* __restrict__ rewards,
              const T* __restrict__ discounts, float* __restrict__ vs_out,
              float* __restrict__ adv_out, int n_rows, int n_steps,
              float rho_bar, float c_bar, float lam) {
  __shared__ float s_delta[kWarps][kTileWords];   // delta, then acc
  __shared__ float s_a[kWarps][kTileWords];       // d * c

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= n_rows) return;   // whole warps only: no block barrier below
  float* sd = s_delta[warp];
  float* sa = s_a[warp];
  const size_t base = (size_t)row * n_steps;
  const T* lr_p = log_ratios + base;
  const T* v_p = values + base;
  const T* r_p = rewards + base;
  const T* d_p = discounts + base;
  const float boot = to_float(bootstrap[row]);
  const int seg = min(kMaxSeg, (n_steps + 31) / 32);
  const int tile = 32 * seg;
  const int own = lane * seg;   // this lane's first step in a tile

  float carry = 0.f;   // acc entering the tile from its right (acc_T = 0)
  for (int t0 = ((n_steps - 1) / tile) * tile; t0 >= 0; t0 -= tile) {
    const int n = min(tile, n_steps - t0);
    // 1. delta and a along t, kBatch steps' loads in flight together.
    for (int m0 = 0; m0 < seg; m0 += kBatch) {
      float lr[kBatch], val[kBatch], nxt[kBatch], rew[kBatch], dis[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = (m0 + j) * 32 + lane, t = t0 + i;
        const bool in = m0 + j < seg && i < n;
        lr[j] = in ? to_float(lr_p[t]) : 0.f;
        val[j] = in ? to_float(v_p[t]) : 0.f;
        nxt[j] = in ? (t + 1 < n_steps ? to_float(v_p[t + 1]) : boot) : 0.f;
        rew[j] = in ? to_float(r_p[t]) : 0.f;
        dis[j] = in ? to_float(d_p[t]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = (m0 + j) * 32 + lane;
        if (m0 + j >= seg) break;
        float delta = 0.f, a = 1.f;   // past T: the identity map
        if (i < n) {
          const float ratio = expf(lr[j]);
          delta = fminf(rho_bar, ratio) * (rew[j] + dis[j] * nxt[j] - val[j]);
          a = dis[j] * (lam * fminf(c_bar, ratio));
        }
        sd[word(i)] = delta;
        sa[word(i)] = a;
      }
    }
    __syncwarp();
    // 2. This lane's map over its segment, acc_start = mul acc_in + add.
    float mul = 1.f, add = 0.f;
#pragma unroll 4
    for (int m = seg - 1; m >= 0; --m) {
      const float a = sa[word(own + m)];
      add = fmaf(a, add, sd[word(own + m)]);
      mul *= a;
    }
    // 3. Compose with the lanes to the right: lane j gets lanes j .. 31.
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float mul_r = __shfl_down_sync(0xffffffffu, mul, off);
      const float add_r = __shfl_down_sync(0xffffffffu, add, off);
      if (lane + off < 32) {
        add = fmaf(mul, add_r, add);
        mul *= mul_r;
      }
    }
    const float start = fmaf(mul, carry, add);   // acc at the segment start
    float acc = __shfl_down_sync(0xffffffffu, start, 1);
    if (lane == 31) acc = carry;
    // 4. Re-run the segment from its true incoming acc.
#pragma unroll 4
    for (int m = seg - 1; m >= 0; --m) {
      const int w = word(own + m);
      acc = fmaf(sa[w], acc, sd[w]);
      sd[w] = acc;
    }
    const float next_carry = __shfl_sync(0xffffffffu, start, 0);
    __syncwarp();
    // 5. vs and the advantages along t (V, r, d again, from L1 / L2).
    for (int m0 = 0; m0 < seg; m0 += kBatch) {
      float val[kBatch], nxt[kBatch], rew[kBatch], dis[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = (m0 + j) * 32 + lane, t = t0 + i;
        const bool in = m0 + j < seg && i < n;
        val[j] = in ? to_float(v_p[t]) : 0.f;
        nxt[j] = in ? (t + 1 < n_steps ? to_float(v_p[t + 1]) : boot) : 0.f;
        rew[j] = in ? to_float(r_p[t]) : 0.f;
        dis[j] = in ? to_float(d_p[t]) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kBatch; ++j) {
        const int i = (m0 + j) * 32 + lane, t = t0 + i;
        if (m0 + j >= seg) break;
        if (i < n) {
          const float acc_next = i + 1 < n ? sd[word(i + 1)] : carry;
          vs_out[base + t] = val[j] + sd[word(i)];
          adv_out[base + t] = rew[j] + dis[j] * (nxt[j] + acc_next) - val[j];
        }
      }
    }
    __syncwarp();   // the tile's shared rows are consumed
    carry = next_carry;
  }
}

template <typename T>
cudaError_t launch(const void* log_ratios, const void* values,
                   const void* bootstrap, const void* rewards,
                   const void* discounts, float* vs, float* adv, int n_rows,
                   int n_steps, float rho_bar, float c_bar, float lam,
                   cudaStream_t stream) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  vtrace_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(log_ratios), static_cast<const T*>(values),
      static_cast<const T*>(bootstrap), static_cast<const T*>(rewards),
      static_cast<const T*>(discounts), vs, adv, n_rows, n_steps, rho_bar,
      c_bar, lam);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all five inputs alike).  Outputs are
// float32 [B, T].  Returns the cudaError_t of the launch.
extern "C" int vtrace_launch(const void* log_ratios, const void* values,
                             const void* bootstrap, const void* rewards,
                             const void* discounts, void* vs, void* adv,
                             int n_rows, int n_steps, int dtype,
                             float rho_bar, float c_bar, float lam,
                             void* stream) {
  if (n_rows <= 0 || n_steps <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* vs_f = static_cast<float*>(vs);
  float* adv_f = static_cast<float*>(adv);
  switch (dtype) {
    case 0:
      return (int)launch<float>(log_ratios, values, bootstrap, rewards,
                                discounts, vs_f, adv_f, n_rows, n_steps,
                                rho_bar, c_bar, lam, s);
    case 1:
      return (int)launch<__nv_bfloat16>(log_ratios, values, bootstrap,
                                        rewards, discounts, vs_f, adv_f,
                                        n_rows, n_steps, rho_bar, c_bar, lam,
                                        s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
