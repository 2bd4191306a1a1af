// The dequant epilogue of the W8A8 product, shared by its two kernels
// (w8a8_gemm.cu for small row counts, w8a8_wgmma.cu for large ones).
//
// The reference (rag_inference_pipeline_tpu/models/layers.py::_qdense,
// :92-100, and the int8 heads of models/qwen.py::_logits, :309-327) turns
// the exact s32 sum into
//   y = (f32(acc) * xs[m]) * s[n]     two f32 multiplies, in that order
// rounded to the output type (bf16 or f32), then adds the bias in that
// type. Here: __int2float_rn, __fmul_rn twice (no contraction into an FMA),
// __float2bfloat16_rn for bf16, the bias added as f32 (__fadd_rn) and
// rounded again, as PyTorch adds two bf16 tensors. Never built with
// -use_fast_math.

#pragma once

#include <cuda_bf16.h>

namespace ragtorch {
namespace w8a8 {

enum OutKind { kOutF32 = 0, kOutBf16 = 1 };

// One weight matrix's output side: its column scales, bias (or null) and
// the [M, N] output of the kind the launch names.
struct OutSide {
  const float* ws;   // [N]
  const void* bias;  // [N] of the output type, or null
  void* out;         // [M, N]
  int N;
};

// The epilogue of one exact sum, from its row's activation scale, its
// column's scale and bias (has_bias false: none), as f32 or as bf16 (a
// bf16 bias read as f32, which is exact).
__device__ __forceinline__ float epi_f32(int acc, float xs, float ws, bool has_bias,
                                         float bias) {
  const float y = __fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws);
  return has_bias ? __fadd_rn(y, bias) : y;
}

__device__ __forceinline__ __nv_bfloat16 epi_bf16(int acc, float xs, float ws,
                                                  bool has_bias, float bias) {
  const __nv_bfloat16 v =
      __float2bfloat16_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), xs), ws));
  return has_bias ? __float2bfloat16_rn(__fadd_rn(__bfloat162float(v), bias)) : v;
}

// Column n's bias as f32 (0 without one).
__device__ __forceinline__ float bias_at(const OutSide& o, int out_kind, int n) {
  if (o.bias == nullptr) return 0.0f;
  return out_kind == kOutF32
             ? static_cast<const float*>(o.bias)[n]
             : __bfloat162float(static_cast<const __nv_bfloat16*>(o.bias)[n]);
}

}  // namespace w8a8
}  // namespace ragtorch
