// PQ4 asymmetric-distance (ADC) scores over the batch's unique probed IVF
// buckets, for Hopper (sm_90a), kernel K6.
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/pq.py::_adc4_kernel
// (launched by ivfpq4_search_dedup):
//   scores[s, b, r] = sum over g < m/8 of
//                     sum over j < 8 of lut[b, (8g+j)*16 + codes[slots[s], r, 8g+j]]
// for every unique probed bucket slot s, every query b < b_pad and every
// bucket position r < cap, from per-query bf16 lookup tables (16 entries per
// subspace) and 4-bit codes stored one per byte (only the first m of the
// m_store code columns are read). Positions at or past sizes[slots[s]] hold no
// vector: the kernel does not read them and writes 0 there. (The TPU kernel
// scores the zero codes of those rows; the caller masks both by id.) The
// coarse term, the member mask and the top-k stay outside, as in the
// reference.
//
// Bound on the H100: the function needs the filled code rows of the unique
// buckets once (m bytes each) and writes the [n_slots, b_pad, cap] f32
// scores. At B=8 over the 1M PQ4 listing (m=192, nlist 4096, cap 640, ~512
// slots of ~244 filled rows) that is ~24 MB of codes and 10.5 MB of scores,
// ~0.01 ms at 3.35 TB/s; at B=64 (4096 slots) the 671 MB of scores set it,
// ~0.2 ms, and its 1.2e10 f32 adds at half the f32 rate ~0.37 ms.
//
// Design: the reference's own form, a one-hot matmul, on the tensor cores.
// With k16 = one subspace, mma.sync m16n8k16 (bf16 in, f32 accumulate) takes
// A = 16 positions x 16 one-hot columns (1.0 where the column is the
// position's code) and B = the 16 table entries of that subspace for 8
// queries, so D[r, q] += lut[q, 16j + code[r, j]]. The one-hot A never
// exists in memory: each thread builds its 4 A registers from the code
// nibbles of its two rows with two clamped shifts a row (shl.b32 of bf16 1.0
// by 16 * (code - column), 0 once the shift leaves the word). B comes from
// shared memory by ldmatrix. The one-hot form is 2 * 16 * b_pad * m flops a
// filled row: 3.9e11 at B=64, 0.40 ms at the dense bf16 peak.
// - A block takes 128 positions of one slot (8 warps of one m16 tile)
//   against up to kMaxQ = 64 queries (8 n-tiles; more queries take z-tiles
//   split evenly), so every A fragment built feeds up to 8 mma and each
//   staged table byte serves 128 rows; two blocks fit an SM (kWarps says
//   why this shape).
// - The tables do not fit a block at B=64 (384 KiB at m=192), so they
//   stream through shared memory in chunks of kSub = 16 subspaces, with the
//   chunk's 16 code bytes of every filled row, in a 2-stage cp.async ring:
//   chunk c+1 loads while chunk c is multiplied. A chunk is 33 KiB of tables
//   at 64 queries, rows padded to 528 bytes so ldmatrix is free of bank
//   conflicts; the tables are restaged for every block, ~3.9 GB from L2 at
//   B=64. (Staging a whole table once, where it fits, reads the same
//   bytes per block and would only cost occupancy.)
// - Group-of-8 accumulation: each group of 8 subspaces sums in a fresh mma
//   accumulator, and the group's sum is added to a running f32 sum on the
//   CUDA cores, as the reference adds one group's dot a step; the tensor
//   cores' accumulate rounding touches only a sum of 8 entries. Products
//   with 0 and 1 are exact, so integer-valued tables give exact sums,
//   bit-identical to the plain version.
// - Rows at or past the list's size are never read; a warp whose rows
//   are all past it skips the products, and a tile wholly past it writes
//   zeros and exits without a load.
// - Stores: the block's [queries, 128 positions] scores are staged in shared
//   memory and written along cap, 512 bytes a query row.
// Blocks are independent, there are no atomics, and the result is
// deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The block: kWarps warps of one m16 tile, 128 positions, two blocks an SM
// (<= 128 registers). Of the shapes timed at B=64 on an H100 (also 8 warps
// of two m16 tiles at one block an SM, 4 warps of two, z-tiles of 32
// queries) it was the fastest: more warps an SM and one block's stores
// overlapping another's products outweigh restaging the tables for every
// 128 rows.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kWarps * 16;       // positions a block
constexpr int kOutStride = kRows + 4;    // floats per staged output row
constexpr int kSub = 16;                 // subspaces per ring stage
constexpr int kLutRow = kSub * 32 + 16;  // 528 bytes: a query's stage row, padded
constexpr int kStages = 2;
constexpr int kMaxQ = 64;                // queries per z-tile (8 n-tiles)

template <int kNT>
__host__ __device__ constexpr int stage_bytes() {
  return kNT * 8 * kLutRow + kRows * kSub;
}

template <int kNT>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<kNT>() > kNT * 8 * kOutStride * 4
             ? kStages * stage_bytes<kNT>()
             : kNT * 8 * kOutStride * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 1.0 shifted left by `s` bits; PTX clamps a shift past 32 to 32, so
// the result is 0 there (and for a "negative" s, which is a huge unsigned)
__device__ __forceinline__ uint32_t one_at(uint32_t s) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;\n" : "=r"(r) : "r"(0x3F80u), "r"(s));
  return r;
}

// 16 * (code nibble of byte `kByte` of w): the code, pre-shifted by 4
template <int kByte>
__device__ __forceinline__ uint32_t code16(uint32_t w) {
  return (kByte == 0 ? w << 4 : w >> (8 * kByte - 4)) & 0xF0u;
}

// One block: kRows positions of slot blockIdx.x / n_ctiles (tile
// blockIdx.x % n_ctiles) against kNT * 8 queries of z-tile blockIdx.y.
template <int kNT>
__global__ void __launch_bounds__(kThreads, 2)
ivfpq4_adc_mma_kernel(const uint8_t* __restrict__ lut,    // [b_pad, m*16] bf16
                      const uint8_t* __restrict__ codes,  // [nlist, cap, m_store]
                      const int* __restrict__ slots,      // [n_slots]
                      const int* __restrict__ sizes,      // [nlist]
                      float* __restrict__ out,            // [n_slots, b_pad, cap]
                      int b_pad, int m, int cap, int m_store, int n_ctiles,
                      int q_tile) {
  constexpr int kQ = kNT * 8;
  constexpr int kStage = stage_bytes<kNT>();
  extern __shared__ __align__(16) uint8_t smem[];

  const int tid = threadIdx.x;
  const int s = blockIdx.x / n_ctiles;
  const int c0 = (blockIdx.x % n_ctiles) * kRows;
  const int q0 = blockIdx.y * q_tile;
  const int nq = min(q_tile, b_pad - q0);
  const int cluster = slots[s];
  const int size = min(sizes[cluster], cap);
  float* out_s = out + ((size_t)s * b_pad + q0) * cap + c0;
  const int ncols = min(kRows, cap - c0);  // positions of the tile below cap

  if (c0 >= size) {  // block-uniform: a tile wholly past the list is zeros
    for (int i = tid; i < nq * kRows; i += kThreads) {
      const int q = i / kRows, r = i % kRows;
      if (r < ncols) out_s[(size_t)q * cap + r] = 0.0f;
    }
    return;
  }

  const int nrows = min(kRows, size - c0);
  const uint8_t* rows = codes + ((size_t)cluster * cap + c0) * m_store;
  const size_t lut_stride = (size_t)m * 32;  // bytes of one query's table
  const uint8_t* lq = lut + (size_t)q0 * lut_stride;
  const int nchunks = (m + kSub - 1) / kSub;

  // chunk ch: 32 bytes a subspace of every tile query's table, and the
  // chunk's 16 code bytes of every filled row (the 8-subspace tail chunk
  // reads 16 code bytes too: m_store >= m rounded up to 16)
  auto load = [&](int ch) {
    uint8_t* st = smem + (ch % kStages) * kStage;
    const int j0 = ch * kSub;
    const int pieces = min(kSub, m - j0) * 2;
    for (int i = tid; i < nq * pieces; i += kThreads) {
      const int q = i / pieces;
      const int p = i - q * pieces;
      cp_async16(smem_addr(st + q * kLutRow + p * 16),
                 lq + q * lut_stride + j0 * 32 + p * 16);
    }
    for (int r = tid; r < nrows; r += kThreads)
      cp_async16(smem_addr(st + kQ * kLutRow + r * kSub),
                 rows + (size_t)r * m_store + j0);
  };

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const uint32_t t32 = 32u * (lane % 4);  // 16 * (first column 2t)
  const int row0 = warp * 16;             // this warp's first row
  const bool active = row0 < nrows;       // warp-uniform

  float run[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) run[n][i] = 0.0f;

  // ldmatrix row addresses for B: query n*8 + lane%8 (+8 for the second
  // n-tile of an x4), 16-byte piece (lane/8)%2 of a subspace's 32 bytes
  const int b_off = ((lane % 8) + (lane / 16) * 8) * kLutRow + ((lane / 8) % 2) * 16;

  load(0);
  cp_async_commit();
  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait_all();
    __syncthreads();  // chunk ch landed; the other stage is free
    if (ch + 1 < nchunks) load(ch + 1);
    cp_async_commit();
    if (!active) continue;

    const uint8_t* st = smem + (ch % kStages) * kStage;
    const int nsub = min(kSub, m - ch * kSub);  // 16, or 8 in a tail chunk
    // the chunk's 16 code bytes of this thread's rows row0 + g (h = 0) and
    // row0 + g + 8 (h = 1)
    uint4 cw[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      cw[h] = *reinterpret_cast<const uint4*>(st + kQ * kLutRow + (row0 + h * 8 + g) * kSub);
    const uint32_t b_base = smem_addr(st + b_off);

#pragma unroll
    for (int grp = 0; grp < kSub / 8; ++grp) {
      if (grp * 8 >= nsub) break;
      float acc[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = grp * 8 + jj;  // subspace within the chunk
        uint32_t a[4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 v = cw[h];
          const uint32_t w = (j / 4 == 0) ? v.x : (j / 4 == 1) ? v.y
                           : (j / 4 == 2) ? v.z : v.w;
          uint32_t c;
          switch (j % 4) {
            case 0: c = code16<0>(w); break;
            case 1: c = code16<1>(w); break;
            case 2: c = code16<2>(w); break;
            default: c = code16<3>(w); break;
          }
          const uint32_t sh = c - t32;  // 16 * (code - 2t)
          a[h] = one_at(sh);             // columns 2t, 2t+1
          a[2 + h] = one_at(sh - 128u);  // columns 2t+8, 2t+9
        }
#pragma unroll
        for (int n = 0; n < kNT; n += 2) {
          if (n + 1 < kNT) {
            uint32_t b[4];
            ldmatrix_x4(b, b_base + n * 8 * kLutRow + j * 32);
            mma_bf16(acc[n], a, b[0], b[1]);
            mma_bf16(acc[n + 1], a, b[2], b[3]);
          } else {
            uint32_t b[2];
            ldmatrix_x2(b, b_base + n * 8 * kLutRow + j * 32);
            mma_bf16(acc[n], a, b[0], b[1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) run[n][i] += acc[n][i];
    }
  }
  cp_async_wait_all();
  __syncthreads();  // every warp is done with the ring: reuse it for the stores

  // C fragment: run[n][i] is row row0 + g (+8 for i >= 2), query n*8 + 2t
  // (+1 for odd i)
  float* so = reinterpret_cast<float*>(smem);
  if (active) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = row0 + g + (i >= 2 ? 8 : 0);
        const int q = n * 8 + (lane % 4) * 2 + (i & 1);
        so[q * kOutStride + r] = run[n][i];
      }
  }
  __syncthreads();
  for (int i = tid; i < nq * kRows; i += kThreads) {
    const int q = i / kRows, r = i % kRows;
    if (r < ncols)
      out_s[(size_t)q * cap + r] = r < nrows ? so[q * kOutStride + r] : 0.0f;
  }
}

template <int kNT>
int launch(const void* lut, const void* codes, const int* slots,
           const int* sizes, float* out, int b_pad, int m, int n_slots,
           int cap, int m_store, int z_tiles, int q_tile, cudaStream_t st) {
  auto kernel = ivfpq4_adc_mma_kernel<kNT>;
  const int smem = smem_bytes<kNT>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ctiles = (cap + kRows - 1) / kRows;
  const dim3 grid(n_slots * n_ctiles, z_tiles);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(lut), static_cast<const uint8_t*>(codes),
      slots, sizes, out, b_pad, m, cap, m_store, n_ctiles, q_tile);
  return (int)cudaGetLastError();
}

}  // namespace

// lut: bf16 [b_pad, m*16]; codes: uint8 [nlist, cap, m_store]; both 16-byte
// aligned. Needs b_pad % 8 == 0, m % 8 == 0, m_store % 16 == 0 and
// m_store >= m rounded up to 16. Batches above kMaxQ queries run as z-tiles
// of at most kMaxQ, split as evenly as multiples of 8 allow.
extern "C" int ragtorch_ivfpq4_adc(const void* lut, const void* codes,
                                   const void* slots, const void* sizes,
                                   void* out, int b_pad, int m, int n_slots,
                                   int cap, int m_store, void* stream) {
  if (b_pad <= 0 || b_pad % 8 != 0 || m % 8 != 0 || m <= 0 ||
      m_store % 16 != 0 || m_store < (m + 15) / 16 * 16 ||
      reinterpret_cast<uintptr_t>(lut) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int z_tiles = (b_pad + kMaxQ - 1) / kMaxQ;
  const int q_tile = ((b_pad + z_tiles - 1) / z_tiles + 7) / 8 * 8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const int* sz = static_cast<const int*>(sizes);
  float* o = static_cast<float*>(out);
  switch (q_tile / 8) {
#define RAGTORCH_K6_CASE(nt)                                                \
  case nt:                                                                  \
    return launch<nt>(lut, codes, sl, sz, o, b_pad, m, n_slots, cap,        \
                      m_store, z_tiles, q_tile, st);
    RAGTORCH_K6_CASE(1)
    RAGTORCH_K6_CASE(2)
    RAGTORCH_K6_CASE(3)
    RAGTORCH_K6_CASE(4)
    RAGTORCH_K6_CASE(5)
    RAGTORCH_K6_CASE(6)
    RAGTORCH_K6_CASE(7)
    RAGTORCH_K6_CASE(8)
#undef RAGTORCH_K6_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
