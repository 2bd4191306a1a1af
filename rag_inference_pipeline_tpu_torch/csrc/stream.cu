// Device-memory stream ceiling for Hopper (sm_90a), kernel K8.
//
// Replaces the TPU kernel scripts/bench_kernel.py::stream_kernel (the kernel
// lab's `stream` mode): out = q + sum over chunks i < rows/chunk of
// db[i*chunk : i*chunk+8, 0:128] as int32. On the TPU every [chunk, D] block
// was DMA'd into VMEM whatever the kernel read of it; a GPU kernel that read
// only the corners would move 1/96 of the bytes at D=768. So this kernel
// reads EVERY byte of the first `rows` rows, and returns besides `out` a
// checksum: the int64 sum of every byte read, which the plain version in
// ops/stream.py also computes, so no load can be dropped unnoticed.
//
// Bound on the H100: rows*D bytes once, 0.23 ms for 1M x 768 at the data
// sheet's 3.35 TB/s; the byte sums (dp4a against 0x01010101) are far below
// any compute peak. Design: one wave of blocks (the wrapper passes
// `blocks`), each streaming a contiguous run of rows with 16-byte coalesced
// read-only loads, kUnroll in flight per thread; a corner word (row within
// the first 8 of its chunk, column < 128) is also added to `out` with
// integer atomics; each block adds its share of the checksum with one 64-bit
// atomic. Integer sums are exact in any order. The wrapper zeroes the
// checksum and sets out = q; nothing here allocates or synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kCornerRows = 8;
constexpr int kCornerWords = 128 / 16;  // the 128 corner columns

__device__ __forceinline__ int byte_sum(const int4 v) {
  int s = __dp4a(v.x, 0x01010101, 0);
  s = __dp4a(v.y, 0x01010101, s);
  s = __dp4a(v.z, 0x01010101, s);
  return __dp4a(v.w, 0x01010101, s);
}

// o[k] += the k-th byte of `word` as a signed int8, k = 0..3 (little-endian)
__device__ __forceinline__ void add_bytes(int* o, int word) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    atomicAdd(o + k, (int)((unsigned)word << (24 - 8 * k)) >> 24);
  }
}

__global__ void __launch_bounds__(kThreads)
stream_sum_kernel(const int4* __restrict__ db,  // [rows, row_words]
                  int* __restrict__ out,        // [8, 128], holds q
                  unsigned long long* __restrict__ checksum,
                  long long rows, int row_words, int chunk,
                  int rows_per_block) {
  __shared__ long long warp_sums[kThreads / 32];
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  long long acc = 0;
  if (r0 < rows) {
    const int nrows = (int)min((long long)rows_per_block, rows - r0);
    const int n = nrows * row_words;  // < 2^31: the wrapper sizes blocks
    const int4* base = db + r0 * row_words;
    const int r0_in_chunk = (int)(r0 % chunk);
    for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kUnroll) {
      int4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        v[u] = i < n ? __ldg(base + i) : make_int4(0, 0, 0, 0);
      }
      int part = 0;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kThreads;
        part += byte_sum(v[u]);  // zeros past n add nothing
        if (i < n) {
          const int r = i / row_words;
          const int w = i - r * row_words;
          if (w < kCornerWords) {
            const int rc = (r0_in_chunk + r) % chunk;
            if (rc < kCornerRows) {
              int* o = out + rc * 128 + w * 16;
              add_bytes(o, v[u].x);
              add_bytes(o + 4, v[u].y);
              add_bytes(o + 8, v[u].z);
              add_bytes(o + 12, v[u].w);
            }
          }
        }
      }
      acc += part;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  }
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];
    // two's complement: a negative share adds correctly modulo 2^64
    atomicAdd(checksum, (unsigned long long)total);
  }
}

}  // namespace

extern "C" int ragtorch_stream_sum(const void* db, void* out, void* checksum,
                                   long long rows, int D, int chunk,
                                   int blocks, void* stream) {
  const int row_words = D / 16;
  const int rows_per_block = (int)((rows + blocks - 1) / blocks);
  stream_sum_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(db), static_cast<int*>(out),
      static_cast<unsigned long long*>(checksum), rows, row_words, chunk,
      rows_per_block);
  return (int)cudaGetLastError();
}
