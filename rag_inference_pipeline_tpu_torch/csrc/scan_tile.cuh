// Shared inner loop of the bf16/f32 scan kernels (binmax_bf16.cu,
// ivf_dedup.cu, ivf_scan.cu): one block scores a tile of kRows stored rows
// against a tile of kQ queries, both staged through shared memory.
//
// Vectors are read as 32-bit words: a word holds two bf16 values
// (kPerWord = 2, the lower index in the low half, as little-endian memory
// lays them out) or one f32 (kPerWord = 1). A bf16 value widens to f32 by
// moving its bits into the high half, so no conversion intrinsic is needed
// and a bf16 x bf16 product is exact in f32. Every thread accumulates its
// dot products with fmaf in ascending D order: a fixed order, so a result
// does not depend on the launch shape, and integer-valued inputs (|x| <= 8,
// D <= 768) give exact sums.
//
// Rows are staged in slices of kSliceWords words with coalesced loads; the
// odd row stride (kStride) keeps the column reads of a warp free of bank
// conflicts. A row or query the caller marks absent (nullptr) reads as
// zeros; its accumulators stay 0 and the caller discards them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ragtorch {

constexpr float kNegInf = -3.0e38f;  // ops/topk.py NEG_INF, not -inf
constexpr int kSliceWords = 64;
constexpr int kStride = kSliceWords + 1;

template <int kPerWord>
__device__ __forceinline__ float dot_word(uint32_t a, uint32_t b, float acc);

template <>
__device__ __forceinline__ float dot_word<1>(uint32_t a, uint32_t b,
                                             float acc) {
  return fmaf(__uint_as_float(a), __uint_as_float(b), acc);
}

template <>
__device__ __forceinline__ float dot_word<2>(uint32_t a, uint32_t b,
                                             float acc) {
  acc = fmaf(__uint_as_float(a << 16), __uint_as_float(b << 16), acc);
  return fmaf(__uint_as_float(a & 0xffff0000u),
              __uint_as_float(b & 0xffff0000u), acc);
}

// acc[k] += <row r of the tile, query qg * kQPer + k of the tile> for the
// calling thread. `row_ptr(i)` / `q_ptr(j)` give tile row i / query j as a
// word pointer, or nullptr when absent. Every thread of the block must call
// this (it synchronises).
template <int kRows, int kQ, int kQPer, int kThreads, int kPerWord,
          typename RowPtr, typename QPtr>
__device__ __forceinline__ void tile_dot(RowPtr row_ptr, QPtr q_ptr, int Dw,
                                         uint32_t* sh_rows, uint32_t* sh_q,
                                         int r, int qg, float (&acc)[kQPer]) {
  for (int w0 = 0; w0 < Dw; w0 += kSliceWords) {
    const int nw = min(kSliceWords, Dw - w0);
    for (int i = threadIdx.x; i < kRows * kSliceWords; i += kThreads) {
      const int rb = i / kSliceWords;
      const int w = i % kSliceWords;
      const uint32_t* p = row_ptr(rb);
      sh_rows[rb * kStride + w] = (w < nw && p != nullptr) ? p[w0 + w] : 0u;
    }
    for (int i = threadIdx.x; i < kQ * kSliceWords; i += kThreads) {
      const int qi = i / kSliceWords;
      const int w = i % kSliceWords;
      const uint32_t* p = q_ptr(qi);
      sh_q[qi * kStride + w] = (w < nw && p != nullptr) ? p[w0 + w] : 0u;
    }
    __syncthreads();
    for (int w = 0; w < nw; ++w) {
      const uint32_t rv = sh_rows[r * kStride + w];
#pragma unroll
      for (int k = 0; k < kQPer; ++k) {
        acc[k] = dot_word<kPerWord>(rv, sh_q[(qg * kQPer + k) * kStride + w],
                                    acc[k]);
      }
    }
    __syncthreads();
  }
}

}  // namespace ragtorch
