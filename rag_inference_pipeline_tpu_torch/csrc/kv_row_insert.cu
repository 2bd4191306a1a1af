// In-place KV-cache row write for Hopper (sm_90a), kernel K7.
//
// Replaces the TPU kernel scripts/bench_decode_anatomy.py::_row_insert_kernel
// (launched by _pallas_row_insert, the decode-anatomy probe's `pallas`
// variant): cache[b, pos[b]] = new[b] for every lane b, the output aliasing
// the cache. A position is placed as the Pallas kernel's block index is in
// interpret mode (lax.dynamic_update_slice): one below 0 counts from the end
// once (-1 is row S-1), and the result is clamped to [0, S-1], so a position
// past the end writes row S-1 as the port's decode insert (models/qwen.py)
// does.
//
// One launch writes a layer's K and V caches together (the reference
// launches its kernel once per cache): blockIdx.y picks the cache, and a
// launch with no second cache is the single insert.
//
// Bound on the H100: B rows of Hkv*Dh elements read and written once per
// cache (8 KiB for the pair at B=8 with Qwen2.5-0.5B's 2 x 64 bf16 heads),
// nanoseconds at 3.35 TB/s; in practice the launch (a few microseconds of
// host time) bounds it, so the pair halves the launches and the wrapper
// (ops/kv.py, through ops/_kernels.py::launch) keeps its host path short.
// Design: one block per (lane, cache), each thread copying 16-byte words;
// the position is read on the device, so the host never waits for it.
// Nothing here allocates or synchronises; the entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__global__ void __launch_bounds__(256)
kv_row_insert_kernel(uint4* __restrict__ cache_k,       // [B, S, row_words]
                     uint4* __restrict__ cache_v,       // the same, or null
                     const uint4* __restrict__ rows_k,  // [B, row_words]
                     const uint4* __restrict__ rows_v,
                     const int* __restrict__ pos,       // [B]
                     int S, int row_words) {
  const int b = blockIdx.x;
  uint4* cache = blockIdx.y == 0 ? cache_k : cache_v;
  const uint4* rows = blockIdx.y == 0 ? rows_k : rows_v;
  const int p0 = pos[b];
  const int p = min(max(p0 < 0 ? p0 + S : p0, 0), S - 1);
  uint4* dst = cache + ((long long)b * S + p) * row_words;
  const uint4* src = rows + (long long)b * row_words;
  for (int i = threadIdx.x; i < row_words; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

// cache_v and rows_v null: the single insert into cache_k.
extern "C" int ragtorch_kv_row_insert(void* cache_k, void* cache_v,
                                      const void* rows_k, const void* rows_v,
                                      const void* pos, int B, int S,
                                      int row_bytes, void* stream) {
  const int row_words = row_bytes / 16;
  const int threads = std::min(256, (row_words + 31) / 32 * 32);
  const dim3 grid(B, cache_v != nullptr ? 2 : 1);
  kv_row_insert_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache_k), static_cast<uint4*>(cache_v),
      static_cast<const uint4*>(rows_k), static_cast<const uint4*>(rows_v),
      static_cast<const int*>(pos), S, row_words);
  return (int)cudaGetLastError();
}
