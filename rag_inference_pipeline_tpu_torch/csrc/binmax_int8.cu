// Per-row-scale int8 bin-max partial top-k for Hopper (sm_90a), kernel K3.
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/topk.py::
// _binmax_kernel_int8 (launched by binmax_partial_topk_int8, reached through
// fused_topk_int8). For every query b and bin j < nbins it returns the
// largest score float(q_i8 . db_i8[r]) * db_scale[r] over the rows r < N
// with r % nbins == j, compared in f32 with a strict `>` from NEG_INF, and
// the earliest such row; a bin with no row keeps NEG_INF and row -1.
//
// Exactness: `__dp4a` gives the exact int32 dot; at D=768, |dot| <=
// 127^2 * 768 < 2^24, so the convert to f32 is exact (above 2^24 it rounds
// to nearest even, as the reference's convert does), followed by one
// rounded f32 multiply by the row scale (__fmul_rn: nothing contracts into
// an FMA). The result is bit-identical to the plain version in ops/topk.py
// for any f32 scales.
//
// Bound on the H100: the N x D rows and the N f32 scales once, N*D + 4N
// bytes: 1M x 768 at 3.35 TB/s is 0.23 ms at best; the dp4a work is far
// below the int8 peak. Layout, group split and ordered merge as K1
// (binmax_int8.cuh); the row scale is one more 4-byte load per step and
// thread, shared by the four threads of a bin.

#include "binmax_int8.cuh"

extern "C" int ragtorch_binmax_int8(const void* q, const void* db,
                                    const void* scales, void* part_vals,
                                    void* part_steps, void* vals, void* idxs,
                                    int B, int D, long long ntotal, int nbins,
                                    int groups, void* stream) {
  return ragtorch_int8::launch_binmax_int8<ragtorch_int8::RowScale>(
      q, db, scales, part_vals, part_steps, vals, idxs, B, D, ntotal, nbins,
      groups, stream);
}
