// The activation quantize of the W8A8 product, shared by the kernels that
// quantize (w8a8_quant.cu, and w8a8_gemm.cu's prologue, 16 values at once).
//
// The reference (rag_inference_pipeline_tpu/models/layers.py::
// quantize_act_rows, :80-89) computes q = clip(rint(x / s), -127, 127) with
// x / s an IEEE f32 division (s = max(max|x|, 1e-8) / 127, itself an IEEE
// division). A correctly rounded division is a call of some ten dependent
// instructions and a branch; here it runs only where it can matter:
//
//   r = rcp_rn(s), y = fl(x * r).
//   y = (x / s)(1 + e1)(1 + e2) with |e1|, |e2| <= 2^-24, and
//   fl(x / s) = (x / s)(1 + e3) with |e3| <= 2^-24, so for |x / s| <= 128
//   |y - fl(x / s)| <= 128 * 3 * 2^-24 < 2.3e-5.
//   |x / s| <= 127.00001 always holds: |x| <= max|x| and s is that maximum
//   (or 1e-8, when larger) over 127, rounded.
//   So when y lies more than 4e-5 from every half-integer, y and the IEEE
//   quotient fall between the same two half-integers and neither is one:
//   rint gives the same integer. Otherwise (and for NaN, whose distance
//   compares false) the IEEE division is taken, __fdiv_rn.
//
// The kernels are never built with -use_fast_math.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ragtorch {
namespace w8a8 {

// A row's scale from its abs-max (an IEEE division).
__device__ __forceinline__ float row_scale(float amax) {
  return __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f);
}

// clip(rint(v / s), -127, 127) as int8, v / s the IEEE quotient; r is
// __frcp_rn(s).
__device__ __forceinline__ int8_t quantize_exact(float v, float s, float r) {
  const float y = __fmul_rn(v, r);
  const float ry = rintf(y);
  const float q = fabsf(__fsub_rn(y, ry)) < 0.49996f ? ry : rintf(__fdiv_rn(v, s));
  return (int8_t)fminf(fmaxf(q, -127.0f), 127.0f);
}

// 4 quantized values packed as int8 in element order (their low bytes)
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// quantize_exact on each of 16 values, packed: the rare path of
// quantize16_exact, kept out of line (its 16 divisions are most of the
// code, which the instruction cache would otherwise refetch every launch)
static __device__ __noinline__ uint4 quantize16_slow(const float* f, float s, float r) {
  int q[16];
  for (int i = 0; i < 16; ++i) q[i] = quantize_exact(f[i], s, r);
  return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

// quantize_exact of 16 values, packed as int8 in element order: the
// quotient by the reciprocal product for all 16 with one test for a
// half-integer within reach among them, then (rarely) quantize_exact on
// each. One branch for the 16, not one a value: the values' arithmetic
// overlaps. No clip on the fast path: |x / s| <= 127.00001 (see above),
// so a finite y rounds into [-127, 127]; a NaN (an infinite x, or s)
// fails the test and takes quantize_exact.
__device__ __forceinline__ uint4 quantize16_exact(const float (&f)[16], float s, float r) {
  int q[16];
  bool near = false;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float y = __fmul_rn(f[i], r);
    near |= !(fabsf(__fsub_rn(y, rintf(y))) < 0.49996f);  // NaN too
    q[i] = __float2int_rn(y);
  }
  if (near) return quantize16_slow(f, s, r);
  return make_uint4(pack4(q[0], q[1], q[2], q[3]), pack4(q[4], q[5], q[6], q[7]),
                    pack4(q[8], q[9], q[10], q[11]), pack4(q[12], q[13], q[14], q[15]));
}

}  // namespace w8a8
}  // namespace ragtorch
