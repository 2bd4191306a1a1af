// Dynamic per-row int8 quantization of activations for Hopper (sm_90a): the
// activation side of the W8A8 product (w8a8_gemm.cu).
//
// Replaces no Pallas kernel: the reference computes it in XLA,
// rag_inference_pipeline_tpu/models/layers.py::quantize_act_rows (:80-89).
// For every row of x ([M, K], bf16 or f32, read as f32):
//   s = max(max_k |x|, 1e-8) / 127          (an IEEE f32 division)
//   q = clip(rint(x / s), -127, 127)        (rint: half to even)
// and it writes q [M, K] int8 and s [M] f32.
//
// Bound on the H100: the row read once and written as int8 (a decode row
// of 896 bf16 is 2.7 KB: nanoseconds at 3.35 TB/s), so a launch costs its
// latency; the plain chain is ~8 launches (cast, abs, amax, clamp, divide,
// round, clamp, cast), which in a decode step of 97 quantizations would add
// ~700 launches. Design: one block a row; the abs-max is a block reduction
// (max is exact in any order), then the same threads reread the row (from
// L1/L2) and write q. Division and rounding are __fdiv_rn and rintf, never
// a reciprocal multiply, and the file is built without -use_fast_math.
// Nothing here allocates or synchronises; the entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int K) {
  __shared__ float warp_max[kThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = q + (size_t)blockIdx.x * K;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < K; i += kThreads)
    amax = fmaxf(amax, fabsf(to_f32(xr[i])));
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) warp_max[threadIdx.x / 32] = amax;
  __syncthreads();
  amax = warp_max[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) amax = fmaxf(amax, warp_max[w]);
  const float scale = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
  if (threadIdx.x == 0) s[blockIdx.x] = scale;
  for (int i = threadIdx.x; i < K; i += kThreads) {
    const float v = rintf(__fdiv_rn(to_f32(xr[i]), scale));
    qr[i] = (int8_t)fminf(fmaxf(v, -127.0f), 127.0f);
  }
}

}  // namespace

// x [M, K] contiguous, bf16 (in_kind 1) or f32 (in_kind 0); q [M, K] int8;
// s [M] f32.
extern "C" int ragtorch_w8a8_quantize_rows(const void* x, void* q, void* s,
                                           int M, int K, int in_kind,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || (in_kind != 0 && in_kind != 1))
    return (int)cudaErrorInvalidValue;
  if (in_kind == 1)
    quantize_rows_kernel<__nv_bfloat16><<<M, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), K);
  else
    quantize_rows_kernel<float><<<M, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(s), K);
  return (int)cudaGetLastError();
}
