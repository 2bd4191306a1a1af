// Global-scale int8 bin-max partial top-k for Hopper (sm_90a), kernel K1.
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/topk.py::
// _binmax_kernel_int8gs (launched by binmax_partial_topk_int8gs). For every
// query b and bin j < nbins it returns the largest s8.s8->s32 score over the
// rows r < ntotal with r % nbins == j, and the earliest such row; a bin with
// no row keeps INT32_MIN = -(2^31)+1 and row -1.
//
// Bound on the H100: at the serving batch (B=8, 1M x 768) the rows below
// ntotal read once, 0.768 GB at 3.35 TB/s: 0.23 ms; the 1.2e10 int8
// operations are 6 us at 1,979 TOP/s. At the kernel lab's B=128 the
// operations, 2.0e14, are 0.10 ms: still below the bytes. The design
// (binmax_mma.cuh, shared with K2 and K3): m16n8k32 s8 mma.sync with an
// exact s32 sum, rows fed by a 4-stage 16-byte cp.async ring, 128 bins by
// up to 64 queries a block, so the corpus is read once at B=8 and twice
// at B=128 (16 times with the first kernel's 8-query tiles); the running
// (max, row) pairs stay in registers and no row at or past ntotal is read.

#include "binmax_mma.cuh"

extern "C" int ragtorch_binmax_int8gs(const void* q, const void* db,
                                      void* part_vals, void* part_steps,
                                      void* vals, void* idxs, int B, int D,
                                      long long ntotal, int nbins, int groups,
                                      void* stream) {
  using namespace ragtorch_binmax;
  const ScanArgs a{q, db, nullptr, part_vals, static_cast<int*>(part_steps),
                   vals, static_cast<int*>(idxs), B, D, ntotal, nbins,
                   groups};
  return launch_binmax<GlobalScale>(a, stream);
}

// The block tile of K1, K2 and K3 (binmax_mma.cuh), from which
// ops/topk.py::_scan_groups splits the step range: bins a block, and
// queries a y-tile at most.
extern "C" int ragtorch_binmax_tile(int* bin_tile, int* max_q) {
  *bin_tile = ragtorch_binmax::kBinTile;
  *max_q = ragtorch_binmax::kMaxQ;
  return 0;
}
