// Per-row-scale int8 bin-max partial top-k for Hopper (sm_90a), kernel K3.
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/topk.py::
// _binmax_kernel_int8 (launched by binmax_partial_topk_int8, reached through
// fused_topk_int8). For every query b and bin j < nbins it returns the
// largest score float(q_i8 . db_i8[r]) * db_scale[r] over the rows r < N
// with r % nbins == j, compared in f32 with a strict `>` from NEG_INF, and
// the earliest such row; a bin with no row keeps NEG_INF and row -1.
//
// Exactness: m16n8k32 s8 mma.sync gives the exact int32 dot; at D=768,
// |dot| <= 128^2 * 768 < 2^24, so the convert to f32 is exact (above 2^24
// it rounds to nearest even, as the reference's convert does), followed by
// one rounded f32 multiply by the row scale (__fmul_rn: nothing contracts
// into an FMA). The result is bit-identical to the plain version in
// ops/topk.py for any f32 scales.
//
// Bound on the H100: the N x D rows and the N f32 scales once, N*D + 4N
// bytes: 1M x 768 at 3.35 TB/s is 0.23 ms at best; at B=8 the 1.2e10 int8
// operations are 6 us, at B=64 (fused_topk_int8's batch in chip_smoke.py)
// 9.8e10, 0.05 ms. Design as K1 (binmax_mma.cuh): a 4-stage cp.async ring
// of rows, products on the tensor cores, up to 64 queries a tile (the
// batch of 64 reads the rows once); each thread loads the scales of its
// four rows of a step with the step's first chunk and uses them at the
// step's fold.

#include "binmax_mma.cuh"

extern "C" int ragtorch_binmax_int8(const void* q, const void* db,
                                    const void* scales, void* part_vals,
                                    void* part_steps, void* vals, void* idxs,
                                    int B, int D, long long ntotal, int nbins,
                                    int groups, void* stream) {
  using namespace ragtorch_binmax;
  const ScanArgs a{q, db, static_cast<const float*>(scales), part_vals,
                   static_cast<int*>(part_steps), vals,
                   static_cast<int*>(idxs), B, D, ntotal, nbins, groups};
  return launch_binmax<RowScale>(a, stream);
}
