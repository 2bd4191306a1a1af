// Dynamic per-row int8 quantization of activations for Hopper (sm_90a): the
// activation side of the large-row W8A8 product (w8a8_wgmma.cu). Small row
// counts quantize inside their GEMM (w8a8_gemm.cu) and never come here.
//
// Replaces no Pallas kernel: the reference computes it in XLA,
// rag_inference_pipeline_tpu/models/layers.py::quantize_act_rows (:80-89).
// For every row of x ([M, K], bf16 or f32, read as f32):
//   s = max(max_k |x|, 1e-8) / 127          (an IEEE f32 division)
//   q = clip(rint(x / s), -127, 127)        (rint: half to even)
// and it writes q [M, K] int8 and s [M] f32.
//
// Bound on the H100: bytes, the row read once and written once as int8
// (4,096 x 896 bf16: 11 MB, 3.3 us at 3.35 TB/s). Design: one warp a row
// (2, 4 or 8 for a long one: at most kVecs pieces a lane), 16-byte loads,
// and the row kept in registers between the abs-max (a warp reduction,
// then across the row's warps in shared memory: max is exact in any order)
// and the quantize, so it is read once. A row longer than 8 warps hold, or
// one whose bytes are not 16-byte aligned, takes a scalar two-pass loop of
// the same arithmetic, one warp a row. The scale is an IEEE division and
// x / s rounds as an IEEE division would (w8a8_round.cuh); the file is
// built without -use_fast_math. Launched under programmatic dependent
// launch, as the GEMM after it (w8a8_wgmma.cu): the blocks wait for the
// previous kernel in the stream before they read x, then let the GEMM's
// blocks start their prologue (the GEMM waits for this grid's end before
// it reads q), so neither launch's latency adds to the other's.
// Nothing here allocates or synchronises; the entry point returns the
// launch's error.

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"
#include "w8a8_round.cuh"

namespace {

using ragtorch::w8a8::quantize_exact;
using ragtorch::w8a8::row_scale;

constexpr int kWarps = 8;  // warps a block
constexpr int kThreads = kWarps * 32;
constexpr int kVecs = 4;  // 16-byte pieces a lane holds at most

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}


// the elements of one 16-byte piece as f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_f32(e[i]);
}

// kG warps a row (kWarps / kG rows a block), the row in registers: lane l
// of the row's warp w holds pieces (32 w + l) + 32 kG j, j < kVecs.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
quantize_rows_vec(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, int M, int K) {
  ragtorch::ptx::grid_dependency_wait();  // x is the previous kernel's output
  ragtorch::ptx::launch_dependents();     // the GEMM that reads q may start
  constexpr int kE = 16 / sizeof(T);  // elements a piece
  __shared__ float part[kWarps];
  const int w = threadIdx.x / 32 % kG;  // this warp's place in its row
  const int row = blockIdx.x * (kWarps / kG) + threadIdx.x / 32 / kG;
  const int lane = threadIdx.x % 32;
  const bool live = row < M;
  const int pieces = K / kE;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(live ? row : 0) * K);
  uint4 v[kVecs];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int p = 32 * w + lane + 32 * kG * j;
    if (live && p < pieces) {
      v[j] = __ldg(xr + p);
      float f[kE];
      unpack<T>(v[j], f);
#pragma unroll
      for (int i = 0; i < kE; ++i) amax = fmaxf(amax, fabsf(f[i]));
    }
  }
  amax = warp_max(amax);
  if constexpr (kG > 1) {  // the row's warps meet in shared memory
    if (lane == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
    const int first = threadIdx.x / 32 - w;
#pragma unroll
    for (int i = 0; i < kG; ++i) amax = fmaxf(amax, part[first + i]);
  }
  if (!live) return;
  const float scale = row_scale(amax), rcp = __frcp_rn(scale);
  if (w == 0 && lane == 0) s[row] = scale;
  int8_t* qr = q + (size_t)row * K;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int p = 32 * w + lane + 32 * kG * j;
    if (p < pieces) {
      float f[kE];
      unpack<T>(v[j], f);
      uint32_t wd[kE / 4];
#pragma unroll
      for (int i = 0; i < kE / 4; ++i)
        wd[i] = (uint32_t)(uint8_t)quantize_exact(f[4 * i], scale, rcp) |
                (uint32_t)(uint8_t)quantize_exact(f[4 * i + 1], scale, rcp) << 8 |
                (uint32_t)(uint8_t)quantize_exact(f[4 * i + 2], scale, rcp) << 16 |
                (uint32_t)(uint8_t)quantize_exact(f[4 * i + 3], scale, rcp) << 24;
      if constexpr (kE == 8)
        reinterpret_cast<uint2*>(qr)[p] = make_uint2(wd[0], wd[1]);
      else
        reinterpret_cast<uint32_t*>(qr)[p] = wd[0];
    }
  }
}

// Any K and alignment: one warp a row, the row read twice (max, quantize).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_scalar(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int M, int K) {
  ragtorch::ptx::grid_dependency_wait();  // x is the previous kernel's output
  ragtorch::ptx::launch_dependents();     // the GEMM that reads q may start
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.0f;
  for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  amax = warp_max(amax);
  const float scale = row_scale(amax), rcp = __frcp_rn(scale);
  if (lane == 0) s[row] = scale;
  int8_t* qr = q + (size_t)row * K;
  for (int i = lane; i < K; i += 32) qr[i] = quantize_exact(to_f32(xr[i]), scale, rcp);
}

// a launch under programmatic dependent launch: its blocks may start while
// the previous kernel in the stream finishes (they wait for it before any
// read)
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kernel)(KArgs...), unsigned grid, cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
int launch(const void* x, void* q, void* s, int M, int K, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(s);
  constexpr int kE = 16 / sizeof(T);
  const bool vec = K % kE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int pieces = K / kE;
  // the fewest warps a row (1, 2, 4, 8) whose lanes hold it in kVecs pieces
  int g = 1;
  while (g < kWarps && pieces > 32 * kVecs * g) g *= 2;
  if (!vec || pieces > 32 * kVecs * g)
    return launch_pdl(quantize_rows_scalar<T>, (unsigned)((M + kWarps - 1) / kWarps), st,
                      xt, qt, sf, M, K);
  const unsigned grid = (unsigned)((M + kWarps / g - 1) / (kWarps / g));
  switch (g) {
    case 1:
      return launch_pdl(quantize_rows_vec<T, 1>, grid, st, xt, qt, sf, M, K);
    case 2:
      return launch_pdl(quantize_rows_vec<T, 2>, grid, st, xt, qt, sf, M, K);
    case 4:
      return launch_pdl(quantize_rows_vec<T, 4>, grid, st, xt, qt, sf, M, K);
    default:
      return launch_pdl(quantize_rows_vec<T, 8>, grid, st, xt, qt, sf, M, K);
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
  return in_kind == 1 ? launch<__nv_bfloat16>(x, q, s, M, K, st)
                      : launch<float>(x, q, s, M, K, st);
}
