// Shared body of the int8 bin-max partial top-k kernels: K1
// (binmax_int8gs.cu, one global scale, int32 compares) and K3
// (binmax_int8.cu, a f32 scale per row, f32 compares). A score policy
// gives the running best's type, the value of an empty bin and the score
// of one row from its exact int32 dot.
//
// For every query b and bin j < nbins the kernels return the largest score
// over the rows r < ntotal with r % nbins == j, and the earliest such row
// (strict `>` while walking rows in ascending order, starting from the
// empty value); a bin with no row keeps the empty value and row -1.
//
// Design (simple and right first; wgmma/mma.sync, TMA and persistent blocks
// come later):
// - A block owns kBinTile bins x kQTile queries and walks the row groups
//   r = s*nbins + j, s = 0, 1, ... Rows of one step are contiguous, so a
//   step's kBinTile rows are staged through shared memory in slices of
//   kSliceWords 32-bit words with coalesced loads (odd row stride: no bank
//   conflicts). Each thread owns one bin and kQPerThread queries and keeps
//   its running (best, step) in registers. `__dp4a` gives the exact int32
//   dot.
// - At B=8 the bins alone give 8-16 blocks for 132 SMs, so the step range
//   is split over gridDim.z groups writing to scratch; a second small
//   kernel merges the groups in ascending order with strict `>`, which
//   keeps the earliest-row tie rule bit-exact.
// - The wrapper (ops/topk.py) allocates outputs and scratch; nothing here
//   allocates or synchronises. The launcher returns cudaGetLastError().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Internal linkage: each including source gets its own instantiations.
namespace ragtorch_int8 {
namespace {

constexpr int kBinTile = 64;
constexpr int kQTile = 8;
constexpr int kQPerThread = 2;
constexpr int kQGroups = kQTile / kQPerThread;
constexpr int kThreads = kBinTile * kQGroups;
constexpr int kSliceWords = 64;               // 256 bytes of D per slice
constexpr int kStride = kSliceWords + 1;      // odd: conflict-free columns
constexpr int kMergeThreads = 256;

// K1: the int32 dot itself; an empty bin holds -(2^31)+1, as on the TPU.
struct GlobalScale {
  using T = int;
  __device__ static T empty() { return -2147483647; }
  __device__ static T score(int dot, const float*, long long) { return dot; }
};

// K3: the dot converted to f32 (exact below 2^24; round to nearest even
// above, as the reference's convert), times the row's f32 scale in one
// rounded multiply; an empty bin holds NEG_INF = -3.0e38. A NaN score
// never passes the strict `>`.
struct RowScale {
  using T = float;
  __device__ static T empty() { return -3.0e38f; }
  __device__ static T score(int dot, const float* scales, long long r) {
    return __fmul_rn(__int2float_rn(dot), scales[r]);
  }
};

template <typename P>
__global__ void __launch_bounds__(kThreads)
binmax_partial_kernel(const int* __restrict__ q,        // [B, Dw] int8x4
                      const int* __restrict__ db,       // [N, Dw] int8x4
                      const float* __restrict__ scales,  // [N] or nullptr
                      typename P::T* __restrict__ part_vals,  // [G, B, nbins]
                      int* __restrict__ part_steps,            // [G, B, nbins]
                      int B, int Dw, long long ntotal, int nbins,
                      int steps_per_group, int total_steps) {
  using T = typename P::T;
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

  T best[kQPerThread];
  int best_step[kQPerThread];
#pragma unroll
  for (int k = 0; k < kQPerThread; ++k) {
    best[k] = P::empty();
    best_step[k] = -1;
  }

  for (int s = s_begin; s < s_end; ++s) {
    const long long row0 = (long long)s * nbins + bin0;
    const bool row_ok = bin_ok && row0 + bin < ntotal;
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

    if (row_ok) {
#pragma unroll
      for (int k = 0; k < kQPerThread; ++k) {
        const T sc = P::score(acc[k], scales, row0 + bin);
        if (sc > best[k]) {  // strict: the earliest row keeps a tie
          best[k] = sc;
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

template <typename P>
__global__ void __launch_bounds__(kMergeThreads)
binmax_merge_kernel(const typename P::T* __restrict__ part_vals,
                    const int* __restrict__ part_steps,
                    typename P::T* __restrict__ vals, int* __restrict__ idxs,
                    int B, int nbins, int groups) {
  using T = typename P::T;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long n = (long long)B * nbins;
  if (i >= n) return;
  T best = P::empty();
  int step = -1;
  for (int g = 0; g < groups; ++g) {  // ascending: earlier rows first
    const long long o = (long long)g * n + i;
    const T v = part_vals[o];
    if (v > best) {
      best = v;
      step = part_steps[o];
    }
  }
  vals[i] = best;
  idxs[i] = step >= 0 ? step * nbins + (int)(i % nbins) : -1;
}

template <typename P>
int launch_binmax_int8(const void* q, const void* db, const void* scales,
                       void* part_vals, void* part_steps, void* vals,
                       void* idxs, int B, int D, long long ntotal, int nbins,
                       int groups, void* stream) {
  using T = typename P::T;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int total_steps = (int)((ntotal + nbins - 1) / nbins);
  const int steps_per_group = (total_steps + groups - 1) / groups;
  const dim3 grid((nbins + kBinTile - 1) / kBinTile, (B + kQTile - 1) / kQTile,
                  groups);
  binmax_partial_kernel<P><<<grid, kThreads, 0, st>>>(
      static_cast<const int*>(q), static_cast<const int*>(db),
      static_cast<const float*>(scales), static_cast<T*>(part_vals),
      static_cast<int*>(part_steps), B, D / 4, ntotal, nbins, steps_per_group,
      total_steps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * nbins;
  binmax_merge_kernel<P><<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
                           kMergeThreads, 0, st>>>(
      static_cast<const T*>(part_vals), static_cast<const int*>(part_steps),
      static_cast<T*>(vals), static_cast<int*>(idxs), B, nbins, groups);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ragtorch_int8
