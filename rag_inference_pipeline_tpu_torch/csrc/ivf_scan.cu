// Per-query streaming IVF bucket scan into a positional max, for Hopper
// (sm_90a), kernel K4.
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
// Bytes on the H100 (3.35 TB/s), at B=64, nprobe 64 over the 1M x 768 bf16
// listing (nlist 4096, cap 640, ~244 filled rows a list):
// - what this kernel reads: every (query, probed list) pair's filled rows,
//   ~1.6 GB (of the 4.03 GB the TPU kernel streams: it scores every row and
//   masks), ~0.48 ms at the data sheet's rate;
// - the function's bound (chip_smoke.py): each list the batch probes read
//   once, ~0.88 GB, ~0.26 ms. Reaching it needs one read of a list shared
//   by several queries, which this design does not attempt.
// The products, 2 * D flops a pair row (~2.4e9), are nothing to the CUDA
// cores: the scan is bound by bytes in flight.
//
// Design: one block per (query b, tile of kWarps positions), one warp per
// position. The block first lists, in probe order, the probes whose list
// holds a vector at the tile (an ordered compaction by ballots: the
// block-uniform skip of lists whose filled length ends before the tile).
// Then a ring of kStages stages runs across that list: while probe i's rows
// are scored, the rows of the next kStages - 1 probes are in flight as
// 16-byte cp.async.cg copies. Each lane copies, and later reads, only its own
// pieces of its warp's row (pieces lane, lane + 32, ...), so the ring needs
// no barrier: cp.async.wait_group makes a thread's own copies visible to it.
// A lane sums its pieces with fmaf in ascending D order; the warp sums the
// lanes by an xor butterfly, which leaves the same value in every lane
// (IEEE adds commute), and folds it into a running (max, slot) pair with a
// strict `>`. bf16 products are exact in f32, so integer-valued rows
// (|x| <= 8, D <= 768) give exact sums; real rows sum in another order
// than the plain version's matmul. f32 buckets take the same path on the
// CUDA cores (no TF32). Rows whose byte length is not a multiple of 16 (or
// an unaligned base) take 4-byte copies. Blocks are independent, there are
// no atomics, and the result is deterministic.

#include "scan_tile.cuh"

namespace {

using ragtorch::dot_word;
using ragtorch::kNegInf;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// One block: positions c0 .. c0 + kWarps - 1 of query blockIdx.y, c0 =
// blockIdx.x * kWarps. Rows are npieces pieces of kBytes; a lane owns
// pieces lane + 32 * i, i < ppt. Shared memory: the query (npieces pieces),
// the ring [kStages][ppt][kThreads] pieces, the filled-probe list.
template <int kBytes, int kPerWord>
__global__ void __launch_bounds__(kThreads)
ivf_scan_ring_kernel(const uint8_t* __restrict__ q,        // [B, D]
                     const uint8_t* __restrict__ buckets,  // [nlist, cap, D]
                     const int* __restrict__ probe,        // [B, nprobe]
                     const int* __restrict__ sizes,        // [nlist]
                     float* __restrict__ vals,             // [B, cap]
                     int* __restrict__ win,                // [B, cap]
                     int row_bytes, int cap, int nprobe, int npieces, int ppt) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int warp_counts[kWarps];
  uint8_t* sh_q = smem;
  uint8_t* ring = smem + (size_t)npieces * kBytes;
  const size_t stage_bytes = (size_t)ppt * kThreads * kBytes;
  int* list_p = reinterpret_cast<int*>(ring + kStages * stage_bytes);
  int* list_cl = list_p + nprobe;
  int* list_sz = list_cl + nprobe;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kWarps;
  const int c = c0 + warp;  // this warp's position

  // the query, staged once (4-byte words: any 4-byte aligned row)
  const uint32_t* qw = reinterpret_cast<const uint32_t*>(q + (size_t)b * row_bytes);
  for (int i = tid; i < row_bytes / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(sh_q)[i] = qw[i];

  // the probes whose list holds a vector at the tile, in probe order
  int n_f = 0;
  for (int base = 0; base < nprobe; base += kThreads) {
    const int p = base + tid;
    int cl = 0, sz = 0;
    if (p < nprobe) {
      cl = probe[(size_t)b * nprobe + p];
      sz = min(sizes[cl], cap);
    }
    const bool filled = p < nprobe && sz > c0;
    const unsigned ballot = __ballot_sync(0xffffffffu, filled);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int off = n_f, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      off += w < warp ? warp_counts[w] : 0;
      total += warp_counts[w];
    }
    if (filled) {
      const int k = off + __popc(ballot & ((1u << lane) - 1u));
      list_p[k] = p;
      list_cl[k] = cl;
      list_sz[k] = sz;
    }
    n_f += total;
    __syncthreads();  // the list entries are visible; warp_counts reusable
  }

  // this lane's pieces of filled-probe i's row at c, into ring stage i % kStages
  auto load = [&](int i) {
    if (c >= list_sz[i]) return;  // warp-uniform: no vector at c
    const uint8_t* row = buckets + ((size_t)list_cl[i] * cap + c) * row_bytes;
    uint8_t* st = ring + (i % kStages) * stage_bytes;
    for (int k = 0; k < ppt; ++k) {
      const int piece = lane + 32 * k;
      if (piece < npieces)
        cp_async<kBytes>(smem_addr(st + ((size_t)k * kThreads + tid) * kBytes),
                         row + (size_t)piece * kBytes);
    }
  };

#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_f) load(j);
    cp_async_commit();
  }

  float best = kNegInf;
  int best_p = -1;
  for (int i = 0; i < n_f; ++i) {
    cp_async_wait<kStages - 2>();  // this thread's copies of probe i landed
    const int next = i + kStages - 1;
    if (next < n_f) load(next);  // into the stage probe i - 1 used
    cp_async_commit();
    if (c >= list_sz[i]) continue;  // warp-uniform
    const uint8_t* st = ring + (i % kStages) * stage_bytes;
    float acc = 0.0f;
    for (int k = 0; k < ppt; ++k) {
      const int piece = lane + 32 * k;
      if (piece >= npieces) break;
      const uint32_t* rw =
          reinterpret_cast<const uint32_t*>(st + ((size_t)k * kThreads + tid) * kBytes);
      const uint32_t* qv = reinterpret_cast<const uint32_t*>(sh_q + (size_t)piece * kBytes);
      if constexpr (kBytes == 16) {
        const uint4 r4 = *reinterpret_cast<const uint4*>(rw);
        const uint4 q4 = *reinterpret_cast<const uint4*>(qv);
        acc = dot_word<kPerWord>(r4.x, q4.x, acc);
        acc = dot_word<kPerWord>(r4.y, q4.y, acc);
        acc = dot_word<kPerWord>(r4.z, q4.z, acc);
        acc = dot_word<kPerWord>(r4.w, q4.w, acc);
      } else {
        acc = dot_word<kPerWord>(rw[0], qv[0], acc);
      }
    }
#pragma unroll
    for (int mask = 16; mask > 0; mask >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, mask);
    if (acc > best) {  // strict: the earliest slot keeps a tie
      best = acc;
      best_p = list_p[i];
    }
  }
  cp_async_wait<0>();  // no copy outlives the block
  if (lane == 0 && c < cap) {
    vals[(size_t)b * cap + c] = best;
    win[(size_t)b * cap + c] = best_p;
  }
}

template <int kBytes, int kPerWord>
int launch(const void* q, const void* buckets, const int* probe,
           const int* sizes, float* vals, int* win, int B, int row_bytes,
           int nprobe, int cap, cudaStream_t st) {
  auto kernel = ivf_scan_ring_kernel<kBytes, kPerWord>;
  const int npieces = row_bytes / kBytes;
  const int ppt = (npieces + 31) / 32;
  const size_t smem = (size_t)row_bytes +
                      (size_t)kStages * ppt * kThreads * kBytes +
                      (size_t)nprobe * 3 * sizeof(int);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((cap + kWarps - 1) / kWarps, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(buckets),
      probe, sizes, vals, win, row_bytes, cap, nprobe, npieces, ppt);
  return (int)cudaGetLastError();
}

}  // namespace

// elem_bytes: 2 = bf16, 4 = f32 (queries and buckets in the same type);
// rows of D elements, 4-byte aligned.
extern "C" int ragtorch_ivf_scan(const void* q, const void* buckets,
                                 const void* probe, const void* sizes,
                                 void* vals, void* win, int B, int D,
                                 int nprobe, int cap, int elem_bytes,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((elem_bytes != 2 && elem_bytes != 4) || nprobe < 1 ||
      (D * elem_bytes) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int row_bytes = D * elem_bytes;
  const bool vec16 = row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(buckets) % 16 == 0;
  const int* pr = static_cast<const int*>(probe);
  const int* sz = static_cast<const int*>(sizes);
  float* v = static_cast<float*>(vals);
  int* w = static_cast<int*>(win);
  if (elem_bytes == 2) {
    return vec16 ? launch<16, 2>(q, buckets, pr, sz, v, w, B, row_bytes, nprobe, cap, st)
                 : launch<4, 2>(q, buckets, pr, sz, v, w, B, row_bytes, nprobe, cap, st);
  }
  return vec16 ? launch<16, 1>(q, buckets, pr, sz, v, w, B, row_bytes, nprobe, cap, st)
               : launch<4, 1>(q, buckets, pr, sz, v, w, B, row_bytes, nprobe, cap, st);
}
