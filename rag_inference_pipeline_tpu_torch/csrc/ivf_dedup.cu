// Slot-gathered batched GEMM of the batch-deduplicated IVF search, for
// Hopper (sm_90a), kernel K5.
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/ivf.py::
// _dedup_bucket_kernel (launched by ivf_search_dedup), one MXU dot_general
// with f32 accumulation per bucket:
//   scores[s, b, c] = <q[b], buckets[slots[s], c]>   (f32 accumulation)
// for every unique probed bucket slot s, every query b and every bucket
// position c. Positions at or past sizes[slots[s]] hold no vector (the
// layout zero-fills them and the caller masks them by id): the kernel does
// not read them and writes 0 there, which is what the zero rows would give.
// The member mask, the padding mask and the top-k stay outside, as in the
// reference.
//
// Bound on the H100 (3.35 TB/s): the slots' filled rows read once, the
// [n_slots, B, cap] f32 scores written once. Over the 1M x 768 bf16
// listing (nlist 4096, cap 640, ~244 filled rows a list): at B=8 the batch
// probes 512 slots, ~0.19 GB of rows + 10.5 MB of scores, 0.055 ms; at
// B=32 2,048 slots, ~0.72 GB + 168 MB, 0.27 ms. At B <= 40 that is at most
// ~40 flop per byte against the card's ~295, so bytes in flight and
// shared-memory traffic decide the time, not the tensor-core rate.
//
// bf16 design (what the earlier CUDA-core kernel lost time on, and the
// answer here):
// - Reads of each bucket: the old grid took 8 queries a block, so B=32
//   read every bucket 4 times. Here a block takes up to kMaxQ = 40 queries
//   (1-5 n-tiles of 8; larger batches take z-tiles split evenly), so a
//   bucket row is read once per batch up to B=40.
// - Loads: the old loop staged one 64-word slice with 4-byte loads between
//   two __syncthreads, so nothing was in flight while the block computed.
//   Here a kStages-deep ring of cp.async.cg 16-byte copies (commit and wait
//   groups) keeps the next chunks' loads in flight during this chunk's
//   products. Rows at or past the list's size are never read, and a tile
//   wholly past it writes zeros and exits without a load.
// - Shared-memory traffic: the old loop read a row word and a query word
//   per two FMAs. Here mma.sync m16n8k16 (bf16 in, f32 accumulate) takes
//   fragments from ldmatrix: each staged byte is read from shared memory
//   once per warp that uses it. Rows are padded to 144 bytes, so the
//   eight 16-byte rows of an ldmatrix fall in distinct banks.
// - Grid: one block per (slot, 128-position tile, query z-tile); a tile
//   past the list's size costs a block that writes zeros.
// mma.sync, not wgmma: at N = 8..40 queries a warpgroup's m64nNk16 gains
// nothing on a memory-bound product, and per-warp fragments keep the
// ragged row and query edges simple.
//
// Rows whose byte length is not a multiple of 16 (or an unaligned base)
// take 4-byte cp.async copies into the same layout. Elements past D in the
// last 64-element chunk are zero-filled (src-size 0) in both operands, so
// the k-tail adds nothing. Products of bf16 values are exact in f32 and the
// tensor cores sum them in f32, so integer-valued inputs (|x| <= 8,
// D <= 768) give exact sums; real inputs sum in another order than a
// fmaf chain or cuBLAS.
//
// f32 buckets keep the CUDA-core path of scan_tile.cuh (fmaf in D order):
// TF32 tensor cores would round the inputs and move the probe sets.
//
// Blocks are independent, there are no atomics, and the result is
// deterministic.

#include "scan_tile.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kRows = 128;        // bucket positions per block
constexpr int kWarps = 4;         // each warp owns 32 rows: two m16 tiles
constexpr int kMmaThreads = kWarps * 32;
constexpr int kChunk = 64;        // D elements per ring stage
constexpr int kRowBytes = kChunk * 2 + 16;  // 144: padded smem row
constexpr int kStages = 3;
constexpr int kMaxQ = 40;         // queries per z-tile (5 n-tiles)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 or 4 bytes global -> shared, bypassing L1; src_bytes 0 writes zeros
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
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

// Copies chunk `ch` (elements [ch*64, ch*64+64) of every row) of the
// filled bucket rows and of the tile's queries into one ring stage. Rows
// at or past `nrows` / `nq` are left alone (their outputs are discarded);
// elements past D are zero-filled.
template <int kBytes, int kQ>
__device__ __forceinline__ void load_chunk(uint8_t* stage,
                                           const uint8_t* rows, int nrows,
                                           const uint8_t* q, int nq,
                                           size_t row_stride, int D, int ch) {
  constexpr int kPieces = kChunk * 2 / kBytes;  // copies per row and chunk
  const int elems = kBytes / 2;
  const int k0 = ch * kChunk;
  for (int i = threadIdx.x; i < (kRows + kQ) * kPieces; i += kMmaThreads) {
    const int r = i / kPieces;
    const int p = i % kPieces;
    const bool is_q = r >= kRows;
    if (is_q ? r - kRows >= nq : r >= nrows) continue;
    const uint8_t* src = (is_q ? q + (size_t)(r - kRows) * row_stride
                               : rows + (size_t)r * row_stride);
    const int e = k0 + p * elems;
    const bool in_d = e < D;
    cp_async<kBytes>(smem_addr(stage + r * kRowBytes + p * kBytes),
                     in_d ? src + (size_t)e * 2 : src, in_d ? kBytes : 0);
  }
}

// One block: kRows positions of slot blockIdx.x / n_ctiles (tile
// blockIdx.x % n_ctiles) against kNT * 8 queries of z-tile blockIdx.y.
template <int kBytes, int kNT>
__global__ void __launch_bounds__(kMmaThreads, 3)
ivf_dedup_mma_kernel(const uint8_t* __restrict__ q,        // [B, D] bf16
                     const uint8_t* __restrict__ buckets,  // [nlist, cap, D]
                     const int* __restrict__ slots,        // [n_slots]
                     const int* __restrict__ sizes,        // [nlist]
                     float* __restrict__ out,              // [n_slots, B, cap]
                     int B, int D, int cap, int n_ctiles, int q_tile) {
  constexpr int kQ = kNT * 8;
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int kStageBytes = (kRows + kQ) * kRowBytes;

  const int s = blockIdx.x / n_ctiles;
  const int c0 = (blockIdx.x % n_ctiles) * kRows;
  const int q0 = blockIdx.y * q_tile;
  const int nq = min(q_tile, B - q0);
  const int cluster = slots[s];
  const int size = min(sizes[cluster], cap);
  float* out_s = out + (size_t)s * B * cap;

  if (c0 >= size) {  // block-uniform: a tile wholly past the list is zeros
    const int c = c0 + threadIdx.x;
    if (c < cap)
      for (int b = 0; b < nq; ++b) out_s[(size_t)(q0 + b) * cap + c] = 0.0f;
    return;
  }

  const size_t row_stride = (size_t)D * 2;
  const uint8_t* rows = buckets + ((size_t)cluster * cap + c0) * row_stride;
  const uint8_t* qs = q + (size_t)q0 * row_stride;
  const int nrows = min(kRows, size - c0);
  const int nchunks = (D + kChunk - 1) / kChunk;

  // the ring: chunk j lives in stage j % kStages; one commit group per
  // chunk (empty past the last) keeps the group count uniform
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < nchunks)
      load_chunk<kBytes, kQ>(smem + j * kStageBytes, rows, nrows, qs, nq,
                             row_stride, D, j);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc[2][kNT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][n][i] = 0.0f;

  // ldmatrix row addresses: A rows warp*32 + m*16 + lane%16, 16-byte piece
  // lane/16 of the k-step; B (query) rows n*8 + lane%8, piece (lane/8)%2
  const int a_row = warp * 32 + (lane % 16);
  const int a_piece = lane / 16;
  const int b_row = lane % 8;
  const int b_piece = (lane / 8) % 2;
  const int b_ntile = lane / 16;  // the second n-tile of an x4 load

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_async_wait<kStages - 2>();  // this thread's copies of chunk ch
    __syncthreads();  // everyone's copies landed; stage (ch-1) % kStages free
    const int next = ch + kStages - 1;
    if (next < nchunks)
      load_chunk<kBytes, kQ>(smem + (next % kStages) * kStageBytes, rows,
                             nrows, qs, nq, row_stride, D, next);
    cp_async_commit();

    const uint8_t* stage = smem + (ch % kStages) * kStageBytes;
    const uint32_t a_base = smem_addr(stage + a_row * kRowBytes + a_piece * 16);
    const uint32_t b_base = smem_addr(stage + (kRows + b_row) * kRowBytes +
                                      b_piece * 16);
    const int ksteps = min(kChunk, D - ch * kChunk + 15) / 16;
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ldmatrix_x4(a[m], a_base + m * 16 * kRowBytes + ks * 32);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        if (n + 1 < kNT) {
          uint32_t b[4];
          ldmatrix_x4(b, b_base + (n + b_ntile) * 8 * kRowBytes + ks * 32);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            mma_bf16(acc[m][n], a[m], b[0], b[1]);
            mma_bf16(acc[m][n + 1], a[m], b[2], b[3]);
          }
        } else {
          uint32_t b[2];
          ldmatrix_x2(b, b_base + n * 8 * kRowBytes + ks * 32);
#pragma unroll
          for (int m = 0; m < 2; ++m) mma_bf16(acc[m][n], a[m], b[0], b[1]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy outlives the block

  // C fragment: acc[m][n][i] is row warp*32 + m*16 + lane/4 (+8 for i >= 2),
  // query n*8 + (lane%4)*2 (+1 for odd i)
#pragma unroll
  for (int m = 0; m < 2; ++m) {
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = warp * 32 + m * 16 + lane / 4 + (i >= 2 ? 8 : 0);
        const int b = n * 8 + (lane % 4) * 2 + (i & 1);
        const int c = c0 + r;
        if (b < nq && c < cap)
          out_s[(size_t)(q0 + b) * cap + c] = c < size ? acc[m][n][i] : 0.0f;
      }
    }
  }
}

template <int kBytes, int kNT>
int launch_mma(const void* q, const void* buckets, const int* slots,
               const int* sizes, float* out, int B, int D, int n_slots,
               int cap, int z_tiles, int q_tile, cudaStream_t st) {
  auto kernel = ivf_dedup_mma_kernel<kBytes, kNT>;
  const int smem = kStages * (kRows + kNT * 8) * kRowBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_ctiles = (cap + kRows - 1) / kRows;
  const dim3 grid(n_slots * n_ctiles, z_tiles);
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const uint8_t*>(q), static_cast<const uint8_t*>(buckets),
      slots, sizes, out, B, D, cap, n_ctiles, q_tile);
  return (int)cudaGetLastError();
}

template <int kBytes>
int launch_mma_nt(const void* q, const void* buckets, const int* slots,
                  const int* sizes, float* out, int B, int D, int n_slots,
                  int cap, int z_tiles, int q_tile, cudaStream_t st) {
  switch ((q_tile + 7) / 8) {
    case 1:
      return launch_mma<kBytes, 1>(q, buckets, slots, sizes, out, B, D,
                                   n_slots, cap, z_tiles, q_tile, st);
    case 2:
      return launch_mma<kBytes, 2>(q, buckets, slots, sizes, out, B, D,
                                   n_slots, cap, z_tiles, q_tile, st);
    case 3:
      return launch_mma<kBytes, 3>(q, buckets, slots, sizes, out, B, D,
                                   n_slots, cap, z_tiles, q_tile, st);
    case 4:
      return launch_mma<kBytes, 4>(q, buckets, slots, sizes, out, B, D,
                                   n_slots, cap, z_tiles, q_tile, st);
    case 5:
      return launch_mma<kBytes, 5>(q, buckets, slots, sizes, out, B, D,
                                   n_slots, cap, z_tiles, q_tile, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores, fmaf in D order (scan_tile.cuh)
// ---------------------------------------------------------------------------

using ragtorch::kStride;

constexpr int kRowTile = 64;
constexpr int kQTile = 8;
constexpr int kQPerThread = 2;
constexpr int kQGroups = kQTile / kQPerThread;
constexpr int kThreads = kRowTile * kQGroups;

// one block per (slot, cap tile of kRowTile positions, query tile of
// kQTile queries); each thread owns one position and kQPerThread queries
__global__ void __launch_bounds__(kThreads)
ivf_dedup_f32_kernel(const uint32_t* __restrict__ q,        // [B, D]
                     const uint32_t* __restrict__ buckets,  // [nlist, cap, D]
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
    ragtorch::tile_dot<kRowTile, kQTile, kQPerThread, kThreads, 1>(
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
// bf16 runs z_tiles z-tiles of q_tile (<= 40) queries each.
extern "C" int ragtorch_ivf_dedup(const void* q, const void* buckets,
                                  const void* slots, const void* sizes,
                                  void* out, int B, int D, int n_slots,
                                  int cap, int elem_bytes, int z_tiles,
                                  int q_tile, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slots);
  const int* sz = static_cast<const int*>(sizes);
  float* o = static_cast<float*>(out);
  if (elem_bytes == 2) {
    if (q_tile < 1 || q_tile > kMaxQ || (long long)z_tiles * q_tile < B ||
        D % 2 != 0)
      return (int)cudaErrorInvalidValue;
    const bool vec16 = D % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(buckets) % 16 == 0;
    return vec16 ? launch_mma_nt<16>(q, buckets, sl, sz, o, B, D, n_slots,
                                     cap, z_tiles, q_tile, st)
                 : launch_mma_nt<4>(q, buckets, sl, sz, o, B, D, n_slots,
                                    cap, z_tiles, q_tile, st);
  }
  if (elem_bytes != 4) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_slots, (cap + kRowTile - 1) / kRowTile,
                  (B + kQTile - 1) / kQTile);
  ivf_dedup_f32_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(buckets),
      sl, sz, o, B, D, cap);
  return (int)cudaGetLastError();
}
