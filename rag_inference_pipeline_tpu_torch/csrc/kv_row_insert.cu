// In-place KV-cache row write for Hopper (sm_90a), kernel K7.
//
// Replaces the TPU kernel scripts/bench_decode_anatomy.py::_row_insert_kernel
// (launched by _pallas_row_insert, the decode-anatomy probe's `pallas`
// variant): cache[b, pos[b]] = new[b] for every lane b, the output aliasing
// the cache. A position outside [0, S) writes the nearest row (S-1 past the
// end), as the Pallas kernel's clamped block index does in interpret mode and
// as the port's decode insert (models/qwen.py) clamps.
//
// Bound on the H100: B rows of Hkv*Dh elements read and written once (4 KiB
// at B=8 for Qwen2.5-0.5B's 2 x 64 bf16 heads), nanoseconds at 3.35 TB/s;
// in practice one launch (a few microseconds) bounds it. Design: one block
// per lane, each thread copying 16-byte words; the position is read on the
// device, so the host never waits for it. Nothing here allocates or
// synchronises; the entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__global__ void __launch_bounds__(256)
kv_row_insert_kernel(uint4* __restrict__ cache,      // [B, S, row_words]
                     const uint4* __restrict__ rows,  // [B, row_words]
                     const int* __restrict__ pos,     // [B]
                     int S, int row_words) {
  const int b = blockIdx.x;
  const int p = min(max(pos[b], 0), S - 1);
  uint4* dst = cache + ((long long)b * S + p) * row_words;
  const uint4* src = rows + (long long)b * row_words;
  for (int i = threadIdx.x; i < row_words; i += blockDim.x) dst[i] = src[i];
}

}  // namespace

extern "C" int ragtorch_kv_row_insert(void* cache, const void* rows,
                                      const void* pos, int B, int S,
                                      int row_bytes, void* stream) {
  const int row_words = row_bytes / 16;
  const int threads = std::min(256, (row_words + 31) / 32 * 32);
  kv_row_insert_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint4*>(cache), static_cast<const uint4*>(rows),
      static_cast<const int*>(pos), S, row_words);
  return (int)cudaGetLastError();
}
