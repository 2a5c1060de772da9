// A measurement probe, on no path of the port: the rate at which one
// H100 runs the float32 products of attention_d256.cuh through
// mma.sync.m16n8k8 (chip_smoke.py --ab's ab_mma_rate lines; PERF.md).
// Every warp repeats one 64-dim score chunk's products: 8 k-steps of 8
// dims against 4 key n-tiles, 32 m16n8k8 products an iteration, each
// with its own accumulator chain as in d256::partial_scores.
//   mode 0, tf32:        one mma.sync a product, operands held as tf32
//                        in registers (the tensor pipe's own rate);
//   mode 1, 3xtf32:      tf32::mma3 (three mma.sync) a product, operands
//                        held split in registers (3xTF32's ceiling);
//   mode 2, 3xtf32_loop: d256::partial_scores' loop: A from registers as
//                        float bits, split at each use; B read from a
//                        shared-memory stage (float2, the kernel's pitch
//                        modulo 32 banks; two stages alternating) and
//                        split at each use.
// A product counts 2 * 16 * 8 * 8 = 2,048 flops in every mode.
#include "mma_tf32.cuh"

namespace {

constexpr int kThreads = 256;          // 8 warps, as the D-256 kernels
constexpr int kPitch = 72;             // = 264 (mod 32): d256's K pitch
constexpr int kStageFloats = 32 * kPitch;

// Keeps x in a register the compiler must treat as new each time.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("mov.b32 %0, %0;\n" : "+r"(x));
  return x;
}
// A float2 of shared memory, read at each use (not hoisted out of the
// loop as a load of unchanging memory could be).
__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y)
               : "r"((uint32_t)__cvta_generic_to_shared(p)));
  return v;
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
probe_mma_rate_kernel(const float* __restrict__ src, float* __restrict__ out,
                      int iters) {
  __shared__ __align__(16) float sk[2 * kStageFloats];
  for (int e = threadIdx.x; e < 2 * kStageFloats; e += kThreads)
    sk[e] = src[e % 1024];
  __syncthreads();
  const int lane = threadIdx.x % 32, g8 = lane / 4, t4 = lane % 4;
  float qv[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qv[ks][e] = src[(lane * 32 + ks * 4 + e) % 1024];
  tf32::Frag a[8];
  tf32::FragB b[4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tf32::split(qv[ks][e], a[ks].hi[e], a[ks].lo[e]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    tf32::split(src[(lane + 64 * j) % 1024], b[j].hi[0], b[j].lo[0]);
    tf32::split(src[(lane + 64 * j + 32) % 1024], b[j].hi[1], b[j].lo[1]);
  }
  float s[4][4] = {};
  for (int it = 0; it < iters; ++it) {
    const float* stage = sk + (it & 1) * kStageFloats;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      if constexpr (kMode == 2) {
        tf32::Frag x;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32::split(__uint_as_float(opaque(__float_as_uint(qv[ks][e]))),
                      x.hi[e], x.lo[e]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 y =
              lds2(stage + (8 * j + g8) * kPitch + 8 * ks + 2 * t4);
          tf32::FragB fb;
          tf32::split(y.x, fb.hi[0], fb.lo[0]);
          tf32::split(y.y, fb.hi[1], fb.lo[1]);
          tf32::mma3(s[j], x, fb);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if constexpr (kMode == 0)
            tf32::mma_tf32(s[j], a[ks].hi, b[j].hi);
          else
            tf32::mma3(s[j], a[ks], b[j]);
        }
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sum += s[j][e];
  out[blockIdx.x * kThreads + threadIdx.x] = sum;
}

template <int kMode>
cudaError_t launch(const float* src, float* out, int blocks, int iters,
                   int* active, cudaStream_t stream) {
  auto kernel = probe_mma_rate_kernel<kMode>;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      active, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, 0, stream>>>(src, out, iters);
  return cudaGetLastError();
}

}  // namespace

// src: 1,024 float32 operands; out: blocks * 256 float32.  Runs `blocks`
// blocks of 8 warps, each warp `iters` x 32 products of m16n8k8, in
// mode 0 / 1 / 2 (above); *active receives the blocks an SM can hold.
extern "C" int probe_mma_rate_launch(const void* src, void* out, int mode,
                                     int blocks, int iters, int* active,
                                     void* stream) {
  const float* s = static_cast<const float*>(src);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0:
      return (int)launch<0>(s, o, blocks, iters, active, st);
    case 1:
      return (int)launch<1>(s, o, blocks, iters, active, st);
    case 2:
      return (int)launch<2>(s, o, blocks, iters, active, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
