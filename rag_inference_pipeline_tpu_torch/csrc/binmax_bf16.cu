// bf16 (or f32) bin-max partial top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/topk.py::
// _binmax_kernel (launched by binmax_partial_topk). For every query b and
// bin j < nbins it returns the largest f32-accumulated score over the rows
// r < nvalid with r % nbins == j, and the earliest such row (strict `>`
// while walking rows in ascending order); a bin with no row keeps NEG_INF
// (-3.0e38) and row -1. nvalid = min(ntotal, N): no row at or past it is
// read.
//
// Bound on the H100: the kernel reads the N x D corpus once per tile of
// kQTile queries; at the serving batch (B=8, one query tile) that is 1.54 GB
// for 1M x 768 bf16, 0.46 ms at 3.35 TB/s. Products are fmaf on the CUDA
// cores (2 per 32-bit word and query), not mma.sync: the first version keeps
// K1's layout and a fixed D order (scan_tile.cuh) and leaves tensor cores
// and TMA to a later change.
//
// Design, as K1 (binmax_int8gs.cu):
// - A block owns kBinTile bins x kQTile queries and walks the row groups
//   r = s*nbins + j, s = 0, 1, ...; the rows of one step are contiguous.
//   Each thread owns one bin and kQPerThread queries and keeps its running
//   (max, step) in registers.
// - The step range is split over gridDim.z groups writing to scratch; a
//   second small kernel merges the groups in ascending order with strict
//   `>`, so the earliest row keeps a tie, bit-exactly.
// - The wrapper (ops/topk.py) allocates outputs and scratch; nothing here
//   allocates or synchronises. The C entry point returns cudaGetLastError().

#include "scan_tile.cuh"

namespace {

using ragtorch::kNegInf;
using ragtorch::kStride;

constexpr int kBinTile = 64;
constexpr int kQTile = 8;
constexpr int kQPerThread = 2;
constexpr int kQGroups = kQTile / kQPerThread;
constexpr int kThreads = kBinTile * kQGroups;
constexpr int kMergeThreads = 256;

template <int kPerWord>
__global__ void __launch_bounds__(kThreads)
binmax_partial_kernel(const uint32_t* __restrict__ q,   // [B, Dw]
                      const uint32_t* __restrict__ db,  // [N, Dw]
                      float* __restrict__ part_vals,    // [G, B, nbins]
                      int* __restrict__ part_steps,     // [G, B, nbins]
                      int B, int Dw, long long nvalid, int nbins,
                      int steps_per_group, int total_steps) {
  __shared__ uint32_t rows[kBinTile * kStride];
  __shared__ uint32_t qs[kQTile * kStride];

  const int tid = threadIdx.x;
  const int bin = tid / kQGroups;
  const int qg = tid % kQGroups;
  const int bin0 = blockIdx.x * kBinTile;
  const int q0 = blockIdx.y * kQTile;
  const int g = blockIdx.z;
  const int s_begin = g * steps_per_group;
  const int s_end = min(total_steps, s_begin + steps_per_group);
  const bool bin_ok = bin0 + bin < nbins;

  float best[kQPerThread];
  int best_step[kQPerThread];
#pragma unroll
  for (int k = 0; k < kQPerThread; ++k) {
    best[k] = kNegInf;
    best_step[k] = -1;
  }
  auto q_ptr = [&](int qi) -> const uint32_t* {
    return q0 + qi < B ? q + (size_t)(q0 + qi) * Dw : nullptr;
  };

  for (int s = s_begin; s < s_end; ++s) {
    const long long row0 = (long long)s * nbins + bin0;
    auto row_ptr = [&](int rb) -> const uint32_t* {
      return (bin0 + rb < nbins && row0 + rb < nvalid)
                 ? db + (size_t)(row0 + rb) * Dw
                 : nullptr;
    };
    float acc[kQPerThread];
#pragma unroll
    for (int k = 0; k < kQPerThread; ++k) acc[k] = 0.0f;
    ragtorch::tile_dot<kBinTile, kQTile, kQPerThread, kThreads, kPerWord>(
        row_ptr, q_ptr, Dw, rows, qs, bin, qg, acc);
    if (bin_ok && row0 + bin < nvalid) {
#pragma unroll
      for (int k = 0; k < kQPerThread; ++k) {
        if (acc[k] > best[k]) {  // strict: the earliest row keeps a tie
          best[k] = acc[k];
          best_step[k] = s;
        }
      }
    }
  }

  if (!bin_ok) return;
#pragma unroll
  for (int k = 0; k < kQPerThread; ++k) {
    const int qi = q0 + qg * kQPerThread + k;
    if (qi < B) {
      const size_t o = ((size_t)g * B + qi) * nbins + bin0 + bin;
      part_vals[o] = best[k];
      part_steps[o] = best_step[k];
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
binmax_merge_kernel(const float* __restrict__ part_vals,
                    const int* __restrict__ part_steps,
                    float* __restrict__ vals, int* __restrict__ idxs, int B,
                    int nbins, int groups) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)B * nbins;
  if (i >= n) return;
  float best = kNegInf;
  int step = -1;
  for (int g = 0; g < groups; ++g) {  // ascending: earlier rows first
    const long long o = (long long)g * n + i;
    const float v = part_vals[o];
    if (v > best) {
      best = v;
      step = part_steps[o];
    }
  }
  vals[i] = best;
  idxs[i] = step >= 0 ? step * nbins + (int)(i % nbins) : -1;
}

}  // namespace

// elem_bytes: 2 = bf16, 4 = f32 (queries and db in the same type).
extern "C" int ragtorch_binmax_bf16(const void* q, const void* db,
                                    void* part_vals, void* part_steps,
                                    void* vals, void* idxs, int B, int D,
                                    long long nvalid, int nbins, int groups,
                                    int elem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const int total_steps = (int)((nvalid + nbins - 1) / nbins);
  const int steps_per_group = (total_steps + groups - 1) / groups;
  const int Dw = D * elem_bytes / 4;
  const dim3 grid((nbins + kBinTile - 1) / kBinTile, (B + kQTile - 1) / kQTile,
                  groups);
  const uint32_t* qw = static_cast<const uint32_t*>(q);
  const uint32_t* dbw = static_cast<const uint32_t*>(db);
  float* pv = static_cast<float*>(part_vals);
  int* ps = static_cast<int*>(part_steps);
  if (elem_bytes == 2) {
    binmax_partial_kernel<2><<<grid, kThreads, 0, st>>>(
        qw, dbw, pv, ps, B, Dw, nvalid, nbins, steps_per_group, total_steps);
  } else {
    binmax_partial_kernel<1><<<grid, kThreads, 0, st>>>(
        qw, dbw, pv, ps, B, Dw, nvalid, nbins, steps_per_group, total_steps);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * nbins;
  binmax_merge_kernel<<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
                        kMergeThreads, 0, st>>>(
      pv, ps, static_cast<float*>(vals), static_cast<int*>(idxs), B, nbins,
      groups);
  return (int)cudaGetLastError();
}
