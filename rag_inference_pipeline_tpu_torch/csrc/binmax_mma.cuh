// Shared body of the bin-max partial top-k kernels on the tensor cores:
// K1 (binmax_int8gs.cu: s8 rows, one global scale, int32 compares), K3
// (binmax_int8.cu: s8 rows, a f32 scale per row, f32 compares) and K2
// (binmax_bf16.cu: bf16 rows, f32 accumulation). A policy gives the mma,
// the accumulator's and the running best's types, the value of an empty
// bin and the score of one row from its dot.
//
// For every query b and bin j < nbins the kernels return the largest score
// over the rows r < ntotal with r % nbins == j, and the earliest such row
// (strict `>` while walking rows in ascending order, starting from the
// empty value); a bin with no row keeps the empty value and row -1.
//
// What bounds it on the H100 (3.35 TB/s; 1,979 TOP/s int8, 989 TFLOP/s
// bf16, dense): at B=8 the rows, read once: 1M x 768 is 0.768 GB of int8
// (0.23 ms) or 1.54 GB of bf16 (0.46 ms), against 2*B*N*D = 1.2e10
// operations (6 us of int8). At B=128 the bytes are the same and the
// operations 16x as many: 2.0e14 int8 operations are 0.10 ms, still below
// the bytes. So the design is about bytes in flight and about what each
// loaded byte costs on the way to the tensor cores.
//
// Design (what the first, staged-load kernel lost time on, and the answer):
// - Loads: the old loop staged a 64-word slice with 4-byte loads between
//   two __syncthreads, so nothing was in flight while the block computed.
//   Here a kStages-deep ring of 16-byte cp.async.cg copies (commit and
//   wait groups) keeps the next chunks in flight during this chunk's
//   products, across step boundaries: the block walks one flat sequence of
//   (step, 128-byte chunk of D) pairs. Two blocks an SM keep ~110 KB in
//   flight. Rows at or past ntotal and bins past nbins are never read (the
//   copy is skipped; the fold masks them). Rows whose byte length is not a
//   multiple of 16, or an unaligned base, take 4-byte copies into the same
//   layout. Bytes past D in the last chunk are zero-filled (src-size 0) in
//   both operands, so the k-tail adds nothing.
// - Products: the old loop read a row word and a query word from shared
//   memory per dp4a (or two fmaf), ~72M shared-memory wavefronts at B=8,
//   more time than the HBM bound. Here mma.sync takes its fragments from
//   ldmatrix: the stored rows are A (16 consecutive bins of one step a
//   tile, row-major), the queries B (8 a tile, D contiguous: col-major).
//   s8 rows use m16n8k32 with an exact s32 sum (|dot| <= D * 128^2 < 2^31
//   for D < 131,072); bf16 rows m16n8k16 with f32 accumulation. Shared
//   rows are padded to 144 bytes a 128-byte chunk, so the eight 16-byte
//   rows of an ldmatrix fall in distinct banks.
// - Query reuse: a block takes kBinTile = 128 bins (4 warps, each two m16
//   tiles) by up to kMaxQ = 64 queries (1-8 n-tiles; 240-248 registers at
//   8, no spills); wider batches take more query tiles on gridDim.y, split
//   evenly. So the corpus is read once per tile of up to 64 queries: once
//   at B=8 and B=64, twice at B=128 (the old kernel's 8-query tiles read
//   it 16 times there).
// - Running best: each thread keeps the (best, step) of its C-fragment
//   entries (2 rows x 2 queries an n-tile and m16 tile) in registers and
//   folds a step in with a strict `>` once the step's whole D is summed,
//   steps ascending. The step range is split over gridDim.z groups writing
//   to scratch; a second small kernel merges the groups in ascending order
//   with strict `>`. The earliest-row tie rule stays bit-exact.
// - The launcher splits the batch into query tiles; the wrapper
//   (ops/topk.py `_scan_groups`) picks the groups from the tile shape
//   below, which it reads through `ragtorch_binmax_tile`, and allocates
//   outputs and scratch. Nothing here allocates or synchronises. The
//   launcher returns cudaGetLastError().

#pragma once

#include "ptx.cuh"

// Internal linkage: each including source gets its own instantiations.
namespace ragtorch_binmax {
namespace {

namespace ptx = ragtorch::ptx;

constexpr int kBinTile = 128;  // bins a block
constexpr int kWarps = 4;      // each warp: two m16 tiles, 32 bins
constexpr int kThreads = kWarps * 32;
constexpr int kMaxQ = 64;      // queries a y-tile at most
constexpr int kChunkBytes = 128;              // bytes of D a ring stage
constexpr int kRowBytes = kChunkBytes + 16;   // 144: padded shared row
constexpr int kStages = 4;
constexpr int kMergeThreads = 256;
constexpr float kNegInf = -3.0e38f;  // ops/topk.py NEG_INF, not -inf

// K1: the int32 dot itself; an empty bin holds -(2^31)+1, as on the TPU.
struct GlobalScale {
  using Acc = int;
  using T = int;
  static constexpr bool kRowScale = false;
  __device__ static T empty() { return -2147483647; }
  __device__ static T score(int dot, float) { return dot; }
  __device__ static void mma(int (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    ptx::mma_s8(d, a, b0, b1);
  }
};

// K3: the dot converted to f32 (exact below 2^24; round to nearest even
// above, as the reference's convert), times the row's f32 scale in one
// rounded multiply (nothing contracts into an FMA); an empty bin holds
// NEG_INF. A NaN score never passes the strict `>`.
struct RowScale {
  using Acc = int;
  using T = float;
  static constexpr bool kRowScale = true;
  __device__ static T empty() { return kNegInf; }
  __device__ static T score(int dot, float scale) {
    return __fmul_rn(__int2float_rn(dot), scale);
  }
  __device__ static void mma(int (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    ptx::mma_s8(d, a, b0, b1);
  }
};

// K2 on bf16 rows: the f32 sum of exact bf16 products; an empty bin holds
// NEG_INF.
struct Bf16 {
  using Acc = float;
  using T = float;
  static constexpr bool kRowScale = false;
  __device__ static T empty() { return kNegInf; }
  __device__ static T score(float dot, float) { return dot; }
  __device__ static void mma(float (&d)[4], const uint32_t (&a)[4],
                             uint32_t b0, uint32_t b1) {
    ptx::mma_bf16(d, a, b0, b1);
  }
};

// Copies chunk `ch` (bytes [ch*128, ch*128 + 128) of every row) of the
// step's first `nrows` rows and of the tile's `nq` queries into one ring
// stage: rows at [0, kBinTile), queries after them. Rows and queries past
// those counts are not copied (their outputs are masked or never stored);
// bytes past the row's end are zero-filled.
template <int kBytes, int kQ>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const uint8_t* rows,
                                           int nrows, const uint8_t* q, int nq,
                                           int row_bytes, int ch) {
  constexpr int kPieces = kChunkBytes / kBytes;  // copies a row and chunk
  const int b0 = ch * kChunkBytes;
  for (int i = threadIdx.x; i < (kBinTile + kQ) * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int p = i % kPieces;
    const bool is_q = r >= kBinTile;
    if (is_q ? r - kBinTile >= nq : r >= nrows) continue;
    const uint8_t* src = is_q ? q + (size_t)(r - kBinTile) * row_bytes
                              : rows + (size_t)r * row_bytes;
    const int e = b0 + p * kBytes;
    const bool in_d = e < row_bytes;
    ptx::cp_async<kBytes>(ptx::smem_addr(stage + r * kRowBytes + p * kBytes),
                          in_d ? src + e : src, in_d ? kBytes : 0);
  }
}

// One block: bins [bin0, bin0 + kBinTile) of steps [s_begin, s_end) of
// group blockIdx.z, against the q_tile queries of y-tile blockIdx.y (at
// most kNT * 8). Writes the group's (best, step) for every bin and query
// of the tile to part_vals / part_steps [groups, B, nbins].
template <class P, int kBytes, int kNT>
__global__ void __launch_bounds__(kThreads, 2)
binmax_mma_kernel(const uint8_t* __restrict__ q,       // [B, row_bytes]
                  const uint8_t* __restrict__ db,      // [N, row_bytes]
                  const float* __restrict__ scales,    // [N] or nullptr
                  typename P::T* __restrict__ part_vals,
                  int* __restrict__ part_steps, int B, int row_bytes,
                  long long ntotal, int nbins, int steps_per_group,
                  int total_steps, int q_tile) {
  using Acc = typename P::Acc;
  using T = typename P::T;
  constexpr int kQ = kNT * 8;
  constexpr int kStageBytes = (kBinTile + kQ) * kRowBytes;
  extern __shared__ __align__(16) uint8_t smem[];

  const int bin0 = blockIdx.x * kBinTile;
  const int nbin = min(kBinTile, nbins - bin0);  // bins of this tile
  const int q0 = blockIdx.y * q_tile;
  const int nq = min(q_tile, B - q0);
  if (nq <= 0) return;  // block-uniform: no query of this tile exists
  const int g = blockIdx.z;
  const int s_begin = g * steps_per_group;
  const int s_end = min(total_steps, s_begin + steps_per_group);
  const int nchunks = (row_bytes + kChunkBytes - 1) / kChunkBytes;
  const int n_iter = max(0, s_end - s_begin) * nchunks;
  const uint8_t* qs = q + (size_t)q0 * row_bytes;

  // the ring: flat chunk j (step s_begin + j / nchunks, chunk j % nchunks)
  // lives in stage j % kStages; one commit group a chunk (empty past the
  // last) keeps the group count uniform
  int ld_step = s_begin, ld_ch = 0;  // the next chunk to copy
  auto load_next = [&](int j) {
    const long long row0 = (long long)ld_step * nbins + bin0;
    const int nrows = (int)min((long long)nbin, ntotal - row0);
    load_chunk<kBytes, kQ>(smem + (j % kStages) * kStageBytes,
                           db + row0 * row_bytes, nrows, qs, nq, row_bytes,
                           ld_ch);
    if (++ld_ch == nchunks) {
      ld_ch = 0;
      ++ld_step;
    }
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_iter) load_next(j);
    ptx::cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  Acc acc[2][kNT][4];
  T best[2][kNT][4];
  int best_step[2][kNT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[m][n][i] = Acc(0);
        best[m][n][i] = P::empty();
        best_step[m][n][i] = -1;
      }
  float scale[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};  // K3: rows' scales

  // ldmatrix row addresses: A rows warp*32 + m*16 + lane%16, 16-byte piece
  // lane/16 of the 32-byte k-step; B (query) rows n*8 + lane%8, piece
  // (lane/8)%2, the second n-tile of an x4 load for lanes 16-31.
  // C fragment: acc[m][n][i] is bin warp*32 + m*16 + lane/4 (+8 for i >= 2),
  // query n*8 + (lane%4)*2 (+1 for odd i).
  const int a_row = warp * 32 + (lane % 16);
  const int a_piece = lane / 16;
  const int b_row = lane % 8;
  const int b_piece = (lane / 8) % 2;
  const int b_ntile = lane / 16;
  const int c_row = warp * 32 + lane / 4;

  int s = s_begin, ch = 0;  // the chunk being summed
  for (int it = 0; it < n_iter; ++it) {
    ptx::cp_async_wait<kStages - 2>();  // this thread's copies of chunk it
    __syncthreads();  // everyone's landed; stage (it-1) % kStages is free
    if (it + kStages - 1 < n_iter) load_next(it + kStages - 1);
    ptx::cp_async_commit();

    const long long row0 = (long long)s * nbins + bin0;
    if constexpr (P::kRowScale) {
      if (ch == 0) {  // used at the step's fold, chunks later
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = c_row + m * 16 + h * 8;
            scale[m][h] = r < nbin && row0 + r < ntotal
                              ? __ldg(scales + row0 + r)
                              : 0.0f;
          }
      }
    }

    const uint8_t* stage = smem + (it % kStages) * kStageBytes;
    const uint32_t a_base =
        ptx::smem_addr(stage + a_row * kRowBytes + a_piece * 16);
    const uint32_t b_base = ptx::smem_addr(
        stage + (kBinTile + b_row) * kRowBytes + b_piece * 16);
    const int ksteps = min(kChunkBytes, row_bytes - ch * kChunkBytes + 31) / 32;
#pragma unroll
    for (int ks = 0; ks < kChunkBytes / 32; ++ks) {
      if (ks >= ksteps) break;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        ptx::ldmatrix_x4(a[m], a_base + m * 16 * kRowBytes + ks * 32);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        if (n + 1 < kNT) {
          uint32_t b[4];
          ptx::ldmatrix_x4(b, b_base + (n + b_ntile) * 8 * kRowBytes + ks * 32);
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            P::mma(acc[m][n], a[m], b[0], b[1]);
            P::mma(acc[m][n + 1], a[m], b[2], b[3]);
          }
        } else {
          uint32_t b[2];
          ptx::ldmatrix_x2(b, b_base + n * 8 * kRowBytes + ks * 32);
#pragma unroll
          for (int m = 0; m < 2; ++m) P::mma(acc[m][n], a[m], b[0], b[1]);
        }
      }
    }

    if (++ch == nchunks) {  // step s is summed: fold it in, ascending
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = c_row + m * 16 + h * 8;
          const bool ok = r < nbin && row0 + r < ntotal;
#pragma unroll
          for (int n = 0; n < kNT; ++n)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              const int i = h * 2 + c;
              const T sc = P::score(acc[m][n][i], scale[m][h]);
              if (ok && sc > best[m][n][i]) {  // strict: earliest row wins
                best[m][n][i] = sc;
                best_step[m][n][i] = s;
              }
              acc[m][n][i] = Acc(0);
            }
        }
      ch = 0;
      ++s;
    }
  }
  ptx::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = c_row + m * 16 + h * 8;
      if (r >= nbin) continue;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int b = n * 8 + (lane % 4) * 2 + c;
          if (b < nq) {
            const size_t o = ((size_t)g * B + q0 + b) * nbins + bin0 + r;
            part_vals[o] = best[m][n][h * 2 + c];
            part_steps[o] = best_step[m][n][h * 2 + c];
          }
        }
    }
}

template <class P>
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

// What a launch takes; pointers are device pointers.
struct ScanArgs {
  const void* q;        // [B, row_bytes]
  const void* db;       // [N, row_bytes], rows below ntotal read
  const float* scales;  // [N] (RowScale) or nullptr
  void* part_vals;      // [groups, B, nbins] of P::T
  int* part_steps;      // [groups, B, nbins]
  void* vals;           // [B, nbins] of P::T
  int* idxs;            // [B, nbins]
  int B, row_bytes;
  long long ntotal;
  int nbins, groups;
};

template <class P>
int launch_merge(const ScanArgs& a, cudaStream_t st) {
  using T = typename P::T;
  const long long n = (long long)a.B * a.nbins;
  binmax_merge_kernel<P><<<(unsigned)((n + kMergeThreads - 1) / kMergeThreads),
                           kMergeThreads, 0, st>>>(
      static_cast<const T*>(a.part_vals), a.part_steps, static_cast<T*>(a.vals),
      a.idxs, a.B, a.nbins, a.groups);
  return (int)cudaGetLastError();
}

template <class P, int kBytes, int kNT>
int launch_tile(const ScanArgs& a, int q_tiles, int q_tile,
                int steps_per_group, int total_steps, cudaStream_t st) {
  auto kernel = binmax_mma_kernel<P, kBytes, kNT>;
  const int smem = kStages * (kBinTile + kNT * 8) * kRowBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.nbins + kBinTile - 1) / kBinTile, q_tiles, a.groups);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const uint8_t*>(a.q), static_cast<const uint8_t*>(a.db),
      a.scales, static_cast<typename P::T*>(a.part_vals), a.part_steps, a.B,
      a.row_bytes, a.ntotal, a.nbins, steps_per_group, total_steps, q_tile);
  return (int)cudaGetLastError();
}

// One instance per n-tile count: padding 5 n-tiles to 8 cost K1 16% at
// B=33 (0.42 ms against 0.37 on an H100), so every count keeps its own.
template <class P, int kBytes>
int launch_nt(const ScanArgs& a, int q_tiles, int q_tile, int spg, int total,
              cudaStream_t st) {
  switch ((q_tile + 7) / 8) {
    case 1:
      return launch_tile<P, kBytes, 1>(a, q_tiles, q_tile, spg, total, st);
    case 2:
      return launch_tile<P, kBytes, 2>(a, q_tiles, q_tile, spg, total, st);
    case 3:
      return launch_tile<P, kBytes, 3>(a, q_tiles, q_tile, spg, total, st);
    case 4:
      return launch_tile<P, kBytes, 4>(a, q_tiles, q_tile, spg, total, st);
    case 5:
      return launch_tile<P, kBytes, 5>(a, q_tiles, q_tile, spg, total, st);
    case 6:
      return launch_tile<P, kBytes, 6>(a, q_tiles, q_tile, spg, total, st);
    case 7:
      return launch_tile<P, kBytes, 7>(a, q_tiles, q_tile, spg, total, st);
    case 8:
      return launch_tile<P, kBytes, 8>(a, q_tiles, q_tile, spg, total, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The group split of the step range: ceil(steps / groups) steps a group.
inline int steps_per_group(long long ntotal, int nbins, int groups,
                           int* total_steps) {
  *total_steps = (int)((ntotal + nbins - 1) / nbins);
  return (*total_steps + groups - 1) / groups;
}

// The scan on the tensor cores, then the ordered merge of the groups. The
// batch takes ceil(B / kMaxQ) query tiles on gridDim.y, split evenly.
template <class P>
int launch_binmax(const ScanArgs& a, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.B < 1 || a.groups < 1 || a.nbins < 1 || a.row_bytes % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int q_tiles = (a.B + kMaxQ - 1) / kMaxQ;
  const int q_tile = (a.B + q_tiles - 1) / q_tiles;
  int total = 0;
  const int spg = steps_per_group(a.ntotal, a.nbins, a.groups, &total);
  const bool vec16 = a.row_bytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.q) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(a.db) % 16 == 0;
  const int err =
      vec16 ? launch_nt<P, 16>(a, q_tiles, q_tile, spg, total, st)
            : launch_nt<P, 4>(a, q_tiles, q_tile, spg, total, st);
  if (err != 0) return err;
  return launch_merge<P>(a, st);
}

}  // namespace
}  // namespace ragtorch_binmax
