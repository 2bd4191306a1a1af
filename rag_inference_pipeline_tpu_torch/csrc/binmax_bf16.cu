// bf16 (or f32) bin-max partial top-k for Hopper (sm_90a), kernel K2.
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/topk.py::
// _binmax_kernel (launched by binmax_partial_topk). For every query b and
// bin j < nbins it returns the largest f32-accumulated score over the rows
// r < nvalid with r % nbins == j, and the earliest such row (strict `>`
// while walking rows in ascending order); a bin with no row keeps NEG_INF
// (-3.0e38) and row -1. nvalid = min(ntotal, N): no row at or past it is
// read.
//
// Bound on the H100: at the serving batch (B=8) the rows read once, 1.54 GB
// for 1M x 768 bf16, 0.46 ms at 3.35 TB/s; the 1.2e10 bf16 operations are
// 12 us at 989 TFLOP/s, and at B=128 (2.0e14) 0.20 ms, still below the
// bytes.
//
// bf16 rows: the tensor-core body of binmax_mma.cuh, shared with K1 and K3:
// m16n8k16 mma.sync with f32 accumulation (the reference also scores on
// its matrix unit, topk.py `_binmax_kernel`), rows fed by a 4-stage 16-byte
// cp.async ring, 128 bins by up to 64 queries a block, (max, step) in
// registers, the step range split over gridDim.z and merged in order.
// Products of bf16 values are exact in f32 and the tensor cores sum them
// in f32, so integer-valued inputs (|x| <= 8, D <= 768) give exact sums;
// real inputs sum in another order than the plain version's matmul.
//
// f32 rows stay on the CUDA cores (scan_tile.cuh: fmaf in ascending D
// order): TF32 tensor cores would round the inputs. That kernel owns 64
// bins x 8 queries a block and takes the same group split as the bf16 one.

#include "binmax_mma.cuh"
#include "scan_tile.cuh"

namespace {

constexpr int kF32BinTile = 64;
constexpr int kF32QTile = 8;
constexpr int kF32QPerThread = 2;
constexpr int kF32QGroups = kF32QTile / kF32QPerThread;
constexpr int kF32Threads = kF32BinTile * kF32QGroups;

// each thread owns one bin and kF32QPerThread queries and keeps their
// running (max, step) in registers
__global__ void __launch_bounds__(kF32Threads)
binmax_f32_kernel(const uint32_t* __restrict__ q,   // [B, D]
                  const uint32_t* __restrict__ db,  // [N, D]
                  float* __restrict__ part_vals,    // [G, B, nbins]
                  int* __restrict__ part_steps,     // [G, B, nbins]
                  int B, int D, long long nvalid, int nbins,
                  int steps_per_group, int total_steps) {
  using ragtorch::kNegInf;
  __shared__ uint32_t rows[kF32BinTile * ragtorch::kStride];
  __shared__ uint32_t qs[kF32QTile * ragtorch::kStride];

  const int tid = threadIdx.x;
  const int bin = tid / kF32QGroups;
  const int qg = tid % kF32QGroups;
  const int bin0 = blockIdx.x * kF32BinTile;
  const int q0 = blockIdx.y * kF32QTile;
  const int g = blockIdx.z;
  const int s_begin = g * steps_per_group;
  const int s_end = min(total_steps, s_begin + steps_per_group);
  const bool bin_ok = bin0 + bin < nbins;

  float best[kF32QPerThread];
  int best_step[kF32QPerThread];
#pragma unroll
  for (int k = 0; k < kF32QPerThread; ++k) {
    best[k] = kNegInf;
    best_step[k] = -1;
  }
  auto q_ptr = [&](int qi) -> const uint32_t* {
    return q0 + qi < B ? q + (size_t)(q0 + qi) * D : nullptr;
  };

  for (int s = s_begin; s < s_end; ++s) {
    const long long row0 = (long long)s * nbins + bin0;
    auto row_ptr = [&](int rb) -> const uint32_t* {
      return (bin0 + rb < nbins && row0 + rb < nvalid)
                 ? db + (size_t)(row0 + rb) * D
                 : nullptr;
    };
    float acc[kF32QPerThread];
#pragma unroll
    for (int k = 0; k < kF32QPerThread; ++k) acc[k] = 0.0f;
    ragtorch::tile_dot<kF32BinTile, kF32QTile, kF32QPerThread, kF32Threads, 1>(
        row_ptr, q_ptr, D, rows, qs, bin, qg, acc);
    if (bin_ok && row0 + bin < nvalid) {
#pragma unroll
      for (int k = 0; k < kF32QPerThread; ++k) {
        if (acc[k] > best[k]) {  // strict: the earliest row keeps a tie
          best[k] = acc[k];
          best_step[k] = s;
        }
      }
    }
  }

  if (!bin_ok) return;
#pragma unroll
  for (int k = 0; k < kF32QPerThread; ++k) {
    const int qi = q0 + qg * kF32QPerThread + k;
    if (qi < B) {
      const size_t o = ((size_t)g * B + qi) * nbins + bin0 + bin;
      part_vals[o] = best[k];
      part_steps[o] = best_step[k];
    }
  }
}

}  // namespace

// elem_bytes: 2 = bf16, 4 = f32 (queries and db in the same type).
extern "C" int ragtorch_binmax_bf16(const void* q, const void* db,
                                    void* part_vals, void* part_steps,
                                    void* vals, void* idxs, int B, int D,
                                    long long nvalid, int nbins, int groups,
                                    int elem_bytes, void* stream) {
  using namespace ragtorch_binmax;
  const ScanArgs a{q, db, nullptr, part_vals, static_cast<int*>(part_steps),
                   vals, static_cast<int*>(idxs), B, D * elem_bytes, nvalid,
                   nbins, groups};
  if (elem_bytes == 2) return launch_binmax<Bf16>(a, stream);
  if (elem_bytes != 4 || groups < 1 || nbins < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int total = 0;
  const int spg = steps_per_group(nvalid, nbins, groups, &total);
  const dim3 grid((nbins + kF32BinTile - 1) / kF32BinTile,
                  (B + kF32QTile - 1) / kF32QTile, groups);
  binmax_f32_kernel<<<grid, kF32Threads, 0, st>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(db),
      static_cast<float*>(part_vals), static_cast<int*>(part_steps), B, D,
      nvalid, nbins, spg, total);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_merge<Bf16>(a, st);
}
