// Per-query streaming IVF bucket scan into a positional max, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/ivf.py::
// _make_ivf_scan_kernel (launched by ivf_search_pallas). For query b and
// bucket position c < cap:
//   vals[b, c] = max over p < nprobe of <q[b], buckets[probe[b, p], c]>
//   win[b, c]  = the earliest p reaching that max (strict `>`), -1 if none
// where a position at or past sizes[probe[b, p]] holds no vector and counts
// as NEG_INF (-3.0e38, never a winner). Ids are resolved and the top-k taken
// outside, as in the reference.
//
// Bound on the H100: the kernel reads each query's probed buckets once, only
// the filled rows: at B=64, nprobe=64 over a 1M x 768 bf16 listing (nlist
// 4096, cap 640, ~40% filled) about 1.6 GB of the 4.03 GB the TPU kernel
// streams (it scores every row and masks), 0.5 ms at 3.35 TB/s. Products are
// fmaf in a fixed D order (scan_tile.cuh), one thread per bucket position;
// tensor cores, TMA and more threads per position come later.
//
// Design: one block per (cap tile of kRowTile positions, query b). The block
// loops over b's probe slots in order, skips a list whose filled length ends
// before its tile (block-uniform), and folds each score into a running
// (max, slot) pair in registers. Blocks are independent, there are no
// atomics, and the result is deterministic.

#include "scan_tile.cuh"

namespace {

using ragtorch::kNegInf;
using ragtorch::kStride;

constexpr int kRowTile = 64;
constexpr int kThreads = kRowTile;

template <int kPerWord>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const uint32_t* __restrict__ q,        // [B, Dw]
                const uint32_t* __restrict__ buckets,  // [nlist, cap, Dw]
                const int* __restrict__ probe,         // [B, nprobe]
                const int* __restrict__ sizes,         // [nlist]
                float* __restrict__ vals,              // [B, cap]
                int* __restrict__ win,                 // [B, cap]
                int Dw, int cap, int nprobe) {
  __shared__ uint32_t rows[kRowTile * kStride];
  __shared__ uint32_t qs[kStride];

  const int r = threadIdx.x;
  const int c0 = blockIdx.x * kRowTile;
  const int b = blockIdx.y;
  const int c = c0 + r;
  const uint32_t* qb = q + (size_t)b * Dw;
  auto q_ptr = [&](int) -> const uint32_t* { return qb; };

  float best = kNegInf;
  int best_p = -1;
  for (int p = 0; p < nprobe; ++p) {
    const int cluster = probe[(size_t)b * nprobe + p];
    const int size = min(sizes[cluster], cap);
    if (c0 >= size) continue;  // block-uniform: the tile holds no vector
    const uint32_t* bucket = buckets + (size_t)cluster * cap * Dw;
    auto row_ptr = [&](int rb) -> const uint32_t* {
      return c0 + rb < size ? bucket + (size_t)(c0 + rb) * Dw : nullptr;
    };
    float acc[1] = {0.0f};
    ragtorch::tile_dot<kRowTile, 1, 1, kThreads, kPerWord>(
        row_ptr, q_ptr, Dw, rows, qs, r, 0, acc);
    if (c < size && acc[0] > best) {  // strict: the earliest slot keeps a tie
      best = acc[0];
      best_p = p;
    }
  }
  if (c < cap) {
    vals[(size_t)b * cap + c] = best;
    win[(size_t)b * cap + c] = best_p;
  }
}

}  // namespace

// elem_bytes: 2 = bf16, 4 = f32 (queries and buckets in the same type).
extern "C" int ragtorch_ivf_scan(const void* q, const void* buckets,
                                 const void* probe, const void* sizes,
                                 void* vals, void* win, int B, int D,
                                 int nprobe, int cap, int elem_bytes,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (elem_bytes != 2 && elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const int Dw = D * elem_bytes / 4;
  const dim3 grid((cap + kRowTile - 1) / kRowTile, B);
  const uint32_t* qw = static_cast<const uint32_t*>(q);
  const uint32_t* bw = static_cast<const uint32_t*>(buckets);
  const int* pr = static_cast<const int*>(probe);
  const int* sz = static_cast<const int*>(sizes);
  float* v = static_cast<float*>(vals);
  int* w = static_cast<int*>(win);
  if (elem_bytes == 2) {
    ivf_scan_kernel<2><<<grid, kThreads, 0, st>>>(qw, bw, pr, sz, v, w, Dw,
                                                  cap, nprobe);
  } else {
    ivf_scan_kernel<1><<<grid, kThreads, 0, st>>>(qw, bw, pr, sz, v, w, Dw,
                                                  cap, nprobe);
  }
  return (int)cudaGetLastError();
}
