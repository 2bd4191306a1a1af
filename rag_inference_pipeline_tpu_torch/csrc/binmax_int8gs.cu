// Global-scale int8 bin-max partial top-k for Hopper (sm_90a).
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/topk.py::
// _binmax_kernel_int8gs (launched by binmax_partial_topk_int8gs). For every
// query b and bin j < nbins it returns the largest s8.s8->s32 score over the
// rows r < ntotal with r % nbins == j, and the earliest such row (strict `>`
// while walking rows in ascending order); a bin with no row keeps
// INT32_MIN = -(2^31)+1 and row -1.
//
// Bound on the H100: the kernel reads the N x D int8 corpus once per tile of
// kQTile queries and does B*N*D/4 dp4a, so at the serving batch (B=8, one
// query tile) it is bound by device-memory bandwidth: 1M x 768 bytes at
// 3.35 TB/s is 0.23 ms at best. The design keeps every running (max, row)
// pair in registers and reads no row at or past ntotal.
//
// Design (simple and right first; wgmma/mma.sync, TMA and persistent blocks
// come later):
// - A block owns kBinTile bins x kQTile queries and walks the row groups
//   r = s*nbins + j, s = 0, 1, ... Rows of one step are contiguous, so a
//   step's kBinTile rows are staged through shared memory in slices of
//   kSliceWords 32-bit words with coalesced loads (odd row stride: no bank
//   conflicts). Each thread owns one bin and kQPerThread queries.
// - At B=8 and nbins=1024 the bins alone give 16 blocks for 132 SMs, so the
//   step range is split over gridDim.z groups writing to scratch; a second
//   small kernel merges the groups in ascending order with strict `>`, which
//   keeps the earliest-row tie rule bit-exact.
// - The wrapper (ops/topk.py) allocates outputs and scratch; nothing here
//   allocates or synchronises. The C entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBinTile = 64;
constexpr int kQTile = 8;
constexpr int kQPerThread = 2;
constexpr int kQGroups = kQTile / kQPerThread;
constexpr int kThreads = kBinTile * kQGroups;
constexpr int kSliceWords = 64;               // 256 bytes of D per slice
constexpr int kStride = kSliceWords + 1;      // odd: conflict-free columns
constexpr int kInt32Min = -2147483647;        // -(2^31)+1, as on the TPU
constexpr int kMergeThreads = 256;

__global__ void __launch_bounds__(kThreads)
binmax_partial_kernel(const int* __restrict__ q,      // [B, Dw] int8x4
                      const int* __restrict__ db,     // [N, Dw] int8x4
                      int* __restrict__ part_vals,    // [G, B, nbins]
                      int* __restrict__ part_steps,   // [G, B, nbins]
                      int B, int Dw, long long ntotal, int nbins,
                      int steps_per_group, int total_steps) {
  __shared__ int rows[kBinTile * kStride];
  __shared__ int qs[kQTile * kStride];

  const int tid = threadIdx.x;
  const int bin = tid / kQGroups;          // bin within the tile
  const int qg = tid % kQGroups;           // query pair within the tile
  const int bin0 = blockIdx.x * kBinTile;
  const int q0 = blockIdx.y * kQTile;
  const int g = blockIdx.z;
  const int s_begin = g * steps_per_group;
  const int s_end = min(total_steps, s_begin + steps_per_group);
  const bool bin_ok = bin0 + bin < nbins;

  int best[kQPerThread];
  int best_step[kQPerThread];
#pragma unroll
  for (int k = 0; k < kQPerThread; ++k) {
    best[k] = kInt32Min;
    best_step[k] = -1;
  }

  for (int s = s_begin; s < s_end; ++s) {
    const long long row0 = (long long)s * nbins + bin0;
    int acc[kQPerThread];
#pragma unroll
    for (int k = 0; k < kQPerThread; ++k) acc[k] = 0;

    for (int w0 = 0; w0 < Dw; w0 += kSliceWords) {
      const int nw = min(kSliceWords, Dw - w0);
      for (int i = tid; i < kBinTile * kSliceWords; i += kThreads) {
        const int rb = i / kSliceWords;
        const int w = i % kSliceWords;
        const long long r = row0 + rb;
        int v = 0;
        if (w < nw && bin0 + rb < nbins && r < ntotal) {
          v = db[r * Dw + w0 + w];
        }
        rows[rb * kStride + w] = v;
      }
      for (int i = tid; i < kQTile * kSliceWords; i += kThreads) {
        const int qi = i / kSliceWords;
        const int w = i % kSliceWords;
        int v = 0;
        if (w < nw && q0 + qi < B) {
          v = q[(long long)(q0 + qi) * Dw + w0 + w];
        }
        qs[qi * kStride + w] = v;
      }
      __syncthreads();
      for (int w = 0; w < nw; ++w) {
        const int rv = rows[bin * kStride + w];
#pragma unroll
        for (int k = 0; k < kQPerThread; ++k) {
          acc[k] = __dp4a(rv, qs[(qg * kQPerThread + k) * kStride + w], acc[k]);
        }
      }
      __syncthreads();
    }

    if (bin_ok && row0 + bin < ntotal) {
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
binmax_merge_kernel(const int* __restrict__ part_vals,
                    const int* __restrict__ part_steps,
                    int* __restrict__ vals, int* __restrict__ idxs,
                    int B, int nbins, int groups) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)B * nbins;
  if (i >= n) return;
  int best = kInt32Min;
  int step = -1;
  for (int g = 0; g < groups; ++g) {  // ascending: earlier rows first
    const long long o = (long long)g * n + i;
    const int v = part_vals[o];
    if (v > best) {
      best = v;
      step = part_steps[o];
    }
  }
  vals[i] = best;
  idxs[i] = step >= 0 ? step * nbins + (int)(i % nbins) : -1;
}

}  // namespace

extern "C" int ragtorch_binmax_int8gs(const void* q, const void* db,
                                      void* part_vals, void* part_steps,
                                      void* vals, void* idxs, int B, int D,
                                      long long ntotal, int nbins, int groups,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total_steps = (int)((ntotal + nbins - 1) / nbins);
  const int steps_per_group = (total_steps + groups - 1) / groups;
  const dim3 grid((nbins + kBinTile - 1) / kBinTile, (B + kQTile - 1) / kQTile,
                  groups);
  binmax_partial_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(q), static_cast<const int*>(db),
      static_cast<int*>(part_vals), static_cast<int*>(part_steps), B, D / 4,
      ntotal, nbins, steps_per_group, total_steps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * nbins;
  binmax_merge_kernel<<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
                        kMergeThreads, 0, st>>>(
      static_cast<const int*>(part_vals), static_cast<const int*>(part_steps),
      static_cast<int*>(vals), static_cast<int*>(idxs), B, nbins, groups);
  return (int)cudaGetLastError();
}
