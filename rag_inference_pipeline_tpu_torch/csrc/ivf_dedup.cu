// Slot-gathered batched GEMM of the batch-deduplicated IVF search, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/ivf.py::
// _dedup_bucket_kernel (launched by ivf_search_dedup):
//   scores[s, b, c] = <q[b], buckets[slots[s], c]>   (f32 accumulation)
// for every unique probed bucket slot s, every query b and every bucket
// position c. Positions at or past sizes[slots[s]] hold no vector (the
// layout zero-fills them and the caller masks them by id): the kernel does
// not read them and writes 0 there, which is what the zero rows would give.
// The member mask, the padding mask and the top-k stay outside, as in the
// reference.
//
// Bound on the H100: the unique buckets are read once per tile of kQTile
// queries; at B=8 over a 1M x 768 bf16 listing (nlist 4096, cap 640) the
// batch probes ~512 buckets, of which ~40% of the rows are filled: ~0.2 GB
// of real rows, 0.06 ms at 3.35 TB/s. Products are fmaf in a fixed D order
// (scan_tile.cuh); tensor cores and TMA come later.
//
// Design: one block per (slot, cap tile of kRowTile positions, query tile
// of kQTile queries); each thread owns one position and kQPerThread
// queries. Blocks are independent, there are no atomics, and the result is
// deterministic.

#include "scan_tile.cuh"

namespace {

using ragtorch::kStride;

constexpr int kRowTile = 64;
constexpr int kQTile = 8;
constexpr int kQPerThread = 2;
constexpr int kQGroups = kQTile / kQPerThread;
constexpr int kThreads = kRowTile * kQGroups;

template <int kPerWord>
__global__ void __launch_bounds__(kThreads)
ivf_dedup_kernel(const uint32_t* __restrict__ q,        // [B, Dw]
                 const uint32_t* __restrict__ buckets,  // [nlist, cap, Dw]
                 const int* __restrict__ slots,         // [n_slots]
                 const int* __restrict__ sizes,         // [nlist]
                 float* __restrict__ out,               // [n_slots, B, cap]
                 int B, int Dw, int cap) {
  __shared__ uint32_t rows[kRowTile * kStride];
  __shared__ uint32_t qs[kQTile * kStride];

  const int tid = threadIdx.x;
  const int r = tid / kQGroups;
  const int qg = tid % kQGroups;
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * kRowTile;
  const int q0 = blockIdx.z * kQTile;
  const int cluster = slots[s];
  const int size = min(sizes[cluster], cap);
  const uint32_t* bucket = buckets + (size_t)cluster * cap * Dw;

  float acc[kQPerThread];
#pragma unroll
  for (int k = 0; k < kQPerThread; ++k) acc[k] = 0.0f;
  if (c0 < size) {  // block-uniform: a tile wholly past the list is zeros
    auto row_ptr = [&](int rb) -> const uint32_t* {
      return c0 + rb < size ? bucket + (size_t)(c0 + rb) * Dw : nullptr;
    };
    auto q_ptr = [&](int qi) -> const uint32_t* {
      return q0 + qi < B ? q + (size_t)(q0 + qi) * Dw : nullptr;
    };
    ragtorch::tile_dot<kRowTile, kQTile, kQPerThread, kThreads, kPerWord>(
        row_ptr, q_ptr, Dw, rows, qs, r, qg, acc);
  }
  const int c = c0 + r;
  if (c >= cap) return;
#pragma unroll
  for (int k = 0; k < kQPerThread; ++k) {
    const int b = q0 + qg * kQPerThread + k;
    if (b < B) out[((size_t)s * B + b) * cap + c] = acc[k];
  }
}

}  // namespace

// elem_bytes: 2 = bf16, 4 = f32 (queries and buckets in the same type).
extern "C" int ragtorch_ivf_dedup(const void* q, const void* buckets,
                                  const void* slots, const void* sizes,
                                  void* out, int B, int D, int n_slots,
                                  int cap, int elem_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const int Dw = D * elem_bytes / 4;
  const dim3 grid(n_slots, (cap + kRowTile - 1) / kRowTile,
                  (B + kQTile - 1) / kQTile);
  const uint32_t* qw = static_cast<const uint32_t*>(q);
  const uint32_t* bw = static_cast<const uint32_t*>(buckets);
  const int* sl = static_cast<const int*>(slots);
  const int* sz = static_cast<const int*>(sizes);
  float* o = static_cast<float*>(out);
  if (elem_bytes == 2) {
    ivf_dedup_kernel<2><<<grid, kThreads, 0, st>>>(qw, bw, sl, sz, o, B, Dw,
                                                   cap);
  } else {
    ivf_dedup_kernel<1><<<grid, kThreads, 0, st>>>(qw, bw, sl, sz, o, B, Dw,
                                                   cap);
  }
  return (int)cudaGetLastError();
}
