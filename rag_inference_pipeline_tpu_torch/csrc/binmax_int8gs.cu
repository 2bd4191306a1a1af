// Global-scale int8 bin-max partial top-k for Hopper (sm_90a), kernel K1.
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/topk.py::
// _binmax_kernel_int8gs (launched by binmax_partial_topk_int8gs). For every
// query b and bin j < nbins it returns the largest s8.s8->s32 score over the
// rows r < ntotal with r % nbins == j, and the earliest such row; a bin with
// no row keeps INT32_MIN = -(2^31)+1 and row -1.
//
// Bound on the H100: the kernel reads the N x D int8 corpus once per tile of
// kQTile queries and does B*N*D/4 dp4a, so at the serving batch (B=8, one
// query tile) it is bound by device-memory bandwidth: 1M x 768 bytes at
// 3.35 TB/s is 0.23 ms at best. The design (binmax_int8.cuh, shared with K3)
// keeps every running (max, row) pair in registers and reads no row at or
// past ntotal.

#include "binmax_int8.cuh"

extern "C" int ragtorch_binmax_int8gs(const void* q, const void* db,
                                      void* part_vals, void* part_steps,
                                      void* vals, void* idxs, int B, int D,
                                      long long ntotal, int nbins, int groups,
                                      void* stream) {
  return ragtorch_int8::launch_binmax_int8<ragtorch_int8::GlobalScale>(
      q, db, nullptr, part_vals, part_steps, vals, idxs, B, D, ntotal, nbins,
      groups, stream);
}
