// W8A8 product for small row counts on Hopper (sm_90a): the activation
// quantize and the s8 GEMM with its dequant epilogue in one launch, for a
// group of up to three weight matrices that share the activations.
//
// Replaces no Pallas kernel: the reference computes this in XLA,
// rag_inference_pipeline_tpu/models/layers.py::quantize_act_rows (:80-89)
// followed by _qdense (:92-100) for each weight (and the int8 heads of
// models/qwen.py::_logits, :309-327):
//   s   = max(max_k |x|, 1e-8) / 127; xq = clip(rint(x / s), -127, 127)
//   acc = xq . q  (s8 x s8 -> s32, exact)
//   y   = (f32(acc) * s[m]) * ws[n]    (w8a8_epilogue.cuh)
// ops/w8a8.py routes a product here when it has few rows (a decode step's
// B tokens) and its rows are longer than 1,024 or its weights pass 16 MB
// (`_qgemm_short`; w8a8_short_k.cu's kernel takes the others: Qwen2.5-
// 0.5B's q/k/v, o and gate/up, the classifiers); the decode step runs one
// launch each for q/k/v, o, gate/up, down and the head.
//
// Bound on the H100 (3.35 TB/s): bytes, each weight read once (Llama-3.1-
// 8B at B = 8: q/k/v 25 MB, o 17 MB, gate/up 117 MB, down 59 MB, the head
// 525 MB; Qwen2.5-0.5B's down 4.4 MB and its tied head 136 MB). So every
// SM has to stream an even share of the weights at the card's rate from
// the first microsecond to the last.
//
// Design:
// - One block of 16 warps an SM: the grid is at most the SMs (the launch
//   asks for more than half an SM's shared memory), in clusters of 1, 2 or
//   8 blocks that split K between them; ops/w8a8.py::_qgemm_plan keeps the
//   clusters within one wave (cudaOccupancyMaxActiveClusters, reported by
//   ragtorch_w8a8_qgemm_clusters: 66 pairs, 15 clusters of 8).
// - Tiles: 16 weight rows of one group member. Cluster c of P takes the contiguous tiles [c T / P,
//   (c + 1) T / P) of the T tiles of every member, so no SM streams more
//   than one tile past the mean; its block of rank r takes the r-th slice
//   of K (in 64-byte blocks) of every one of them. The block's (tile,
//   chunk of `kc` bytes of its slice) units are split evenly over its 16
//   warps, whatever the count of tiles.
// - Weights: each warp streams its units through a private ring of
//   `depth` stages in shared memory, one 1-D bulk copy (TMA) a weight row
//   a unit, completion counted in bytes on the stage's mbarrier (2-D
//   tensor-map boxes of 16 rows streamed slower on an H100: ~1.5 against
//   ~2.5 TB/s at the 8B's o). A warp's first `depth` units are issued
//   right after the block's reads of x and before the quantize, which
//   hides behind their DRAM latency. Rows past N read row N - 1 (their
//   sums are never stored). Where K % 16 != 0 or a weight is off 16 bytes
//   (no model's product) the lanes copy 4-byte words instead.
// - Products: m16n8k32 s8 mma.sync with the 16 weight rows as A and 8
//   token rows as B (kNT token tiles of 8: every row of the tensor core is
//   a weight row at B <= 8). K goes in 64-byte blocks whose bytes are
//   permuted: lane (g, t)'s 16 bytes at t * 16 feed two k32 products, read
//   from the weight rows g and g + 8 and from token g's quantized row with
//   the same permutation, so the sum is the same exact integer (integer
//   adds are exact in any order). Bytes past K in a stage are stale; the
//   quantized x is zero there.
// - Reduction: when a warp leaves a tile it adds its exact partial sums
//   into the int32 sums of the tile's owner (block r of the cluster owns
//   and stores its r-th share of the cluster's tiles) with reductions into
//   distributed shared memory; after one cluster barrier each block runs
//   the epilogue over the tiles it owns, its columns' scales and biases
//   read early into shared memory, with stores coalesced along N. No
//   scratch in device memory, no second kernel.
// - Prologue (the quantize folded in): each block quantizes its K slice
//   of the m tile ([mt, K]: up to 64 token rows) into its own shared
//   memory, with w8a8_quant.cu's arithmetic (an abs-max over the row, the
//   scale an IEEE division, x / s rounded as the IEEE quotient is,
//   w8a8_round.cuh, clip to +-127). A row goes to a group of threads
//   (512 / its rows rounded up to a power of two), each holding its units
//   of 16 elements in registers from the max to the quantize; a group's
//   maximum meets in a warp reduction, and the cluster's partial maxima
//   through distributed shared memory. Nothing is shared between clusters
//   and no state outlives the launch, so two streams may run the kernel
//   at once.
// - The s32 kind (in_kind 2, out_kind 2): x is already int8 (a
//   row-parallel shard's columns of a row quantized whole, ops/w8a8.py::
//   w8a8_row_dense), copied into shared memory as it is, and each output is
//   the exact sum itself, with no scale and no bias.
// Nothing here allocates or synchronises: the wrapper (ops/w8a8.py)
// allocates the outputs and chooses the plan. The entry point returns
// cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>
#include <type_traits>

#include "ptx.cuh"
#include "w8a8_epilogue.cuh"
#include "w8a8_round.cuh"

namespace {

namespace cg = cooperative_groups;
namespace ptx = ragtorch::ptx;
using ragtorch::w8a8::OutSide;
using ragtorch::w8a8::quantize16_exact;
using ragtorch::w8a8::row_scale;
using ragtorch::w8a8::bias_at;
using ragtorch::w8a8::epi_bf16;
using ragtorch::w8a8::epi_f32;
using ragtorch::w8a8::kOutF32;
using ragtorch::w8a8::kOutS32;

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;       // bytes of K an mma pair (the permutation)
constexpr int kTileRows = 16;     // weight rows a tile (the mma's A side)
constexpr int kRowPad = 64;       // a stage row's stride past its chunk
constexpr int kMaxDepth = 8;      // ring stages a warp
constexpr int kMaxCluster = 8;    // blocks of a cluster (they split K)
constexpr int kMaxMembers = 3;
constexpr int kMaxRows = 64;      // token rows an m tile at most
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100
// asked of every launch, whatever the plan needs: more than half an SM's
// shared memory, so the card never places two blocks on one SM
constexpr int kOneAnSm = 233472 / 2 + 1024;

struct Member {
  const uint8_t* wq;  // [N, K] int8
  OutSide o;
  int tiles;          // tiles of this member
};

struct Args {
  const void* x;  // [M, K] bf16, f32 or (the s32 kind) int8
  Member mem[kMaxMembers];
  int nmem, M, K, out_kind;
  int mt;      // token rows an m tile: 8, or a multiple of 16 up to 64
  int kc;      // bytes of K a unit: 128, 256 or 512
  int depth;   // ring stages a warp
  int kmax;    // bytes of K a block's slice at most
  int stride;  // bytes a quantized row of the slice takes in shared memory
  int tiles;   // tiles over every member
  int slots;   // tiles a block owns at most (its accumulators)
};

// Bytes a quantized row of K takes in shared memory: K rounded up to the
// 64-byte K block, then to 64 past a multiple of 128, so that the eight
// rows one quarter-warp reads with 16-byte loads fall in distinct banks.
__host__ __device__ inline int row_stride(int K) {
  const int kp = (K + kBlockK - 1) / kBlockK * kBlockK;
  return kp % 128 == 64 ? kp : kp + 64;
}

// Bytes of K in a block's slice at most, over a cluster of `cluster`: the
// 64-byte K blocks split as evenly as they go.
__host__ __device__ inline int slice_max(int K, int cluster) {
  return ((K + kBlockK - 1) / kBlockK + cluster - 1) / cluster * kBlockK;
}

// The shared memory of a block, in order: the quantized m tile of its K
// slice (at most kslice bytes a row), the accumulators (slots x mt x 16
// int32), its columns' scales, biases and places (3 x slots x 16 words), the row
// scales and maxima, the warps' mbarriers, then (on 128 bytes) the warps'
// rings of `depth` stages of 16 rows of kc + kRowPad bytes (a multiple
// of 128 plus 64: the rows one quarter-warp reads fall in distinct banks).
struct Layout {
  int acc, cols, scale, bars, ring, bytes;
  __host__ __device__ Layout(int mt, int kslice, int slots, int kc, int depth) {
    acc = mt * row_stride(kslice);
    cols = acc + slots * mt * kTileRows * 4;
    scale = cols + 3 * slots * kTileRows * 4;
    bars = scale + 2 * mt * 4;
    ring = (bars + kWarps * depth * 8 + 127) / 128 * 128;
    bytes = ring + kWarps * depth * kTileRows * (kc + kRowPad);
  }
};

// 16 elements of a row as loaded: 4 groups of 4 (bf16: 8 bytes each, f32:
// 16), so a row of any K % 4 == 0 is read on its own alignment
template <typename T>
struct Raw16;
template <>
struct Raw16<__nv_bfloat16> {
  uint2 v[4];
};
template <>
struct Raw16<float> {
  float4 v[4];
};
// registers a thread keeps of its x units, read at once and kept from the
// max to the quantize: 2 bf16 units (the plans ops/w8a8.py picks give a
// thread at most 2), 1 f32 one; the loops over them are unrolled, so this
// also bounds the prologue's code, which every launch fetches anew
constexpr int kKeepBytes = 64;
// stored columns' scales and biases a thread reads early, in registers
constexpr int kColRegs = 4;

// the 16 elements from element e: groups at or past K read as zeros (K % 4
// == 0, so a group lies wholly on one side of K); every load issued before
// any is used
__device__ __forceinline__ void load_raw(const float* row, int e, int K, Raw16<float>& r) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r.v[i] = e + 4 * i < K ? __ldg(reinterpret_cast<const float4*>(row + e + 4 * i))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

__device__ __forceinline__ void load_raw(const __nv_bfloat16* row, int e, int K,
                                         Raw16<__nv_bfloat16>& r) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    r.v[i] = e + 4 * i < K ? __ldg(reinterpret_cast<const uint2*>(row + e + 4 * i))
                           : make_uint2(0u, 0u);
}

__device__ __forceinline__ void unpack(const Raw16<float>& r, float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[4 * i] = r.v[i].x, f[4 * i + 1] = r.v[i].y, f[4 * i + 2] = r.v[i].z,
          f[4 * i + 3] = r.v[i].w;
}

__device__ __forceinline__ void unpack(const Raw16<__nv_bfloat16>& r, float (&f)[16]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r.v[i]);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[4 * i] = a.x, f[4 * i + 1] = a.y, f[4 * i + 2] = b.x, f[4 * i + 3] = b.y;
  }
}

template <typename T>
__device__ __forceinline__ float abs_max(const Raw16<T>& r) {
  float f[16];
  unpack(r, f);
  float m = 0.0f;
#pragma unroll
  for (int q = 0; q < 16; ++q) m = fmaxf(m, fabsf(f[q]));
  return m;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// The member of tile t and the first weight row of the tile.
__device__ __forceinline__ int tile_member(const Args& a, int t, int& n0) {
  int i = 0;
  while (i + 1 < a.nmem && t >= a.mem[i].tiles) t -= a.mem[i++].tiles;
  n0 = t * kTileRows;
  return i;
}

// Block (x: a cluster's share of the tiles and K, y: an m tile of the
// token rows).
template <typename T, int kNT, bool kBulk>
__global__ void __launch_bounds__(kThreads, 1)
w8a8_qgemm_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int mt = a.mt, K = a.K;
  const Layout lay(mt, a.kmax, a.slots, a.kc, a.depth);
  uint8_t* xq = smem;                                       // [mt][stride]
  int* acc_s = reinterpret_cast<int*>(smem + lay.acc);      // [slots][mt][16]
  float* col_ws = reinterpret_cast<float*>(smem + lay.cols);  // [slots * 16]
  float* col_b = col_ws + a.slots * kTileRows;                // [slots * 16]
  int* col_n = reinterpret_cast<int*>(col_b + a.slots * kTileRows);  // [slots * 16]
  float* scale = reinterpret_cast<float*>(smem + lay.scale);
  unsigned* rowmax = reinterpret_cast<unsigned*>(scale + mt);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  // this cluster's tiles [t0, t1); this block's 64-byte K blocks [kb0, kb1)
  // of them, bytes [kbeg, kend); this warp's units [u0, u1) of (tile, kc
  // bytes of the slice)
  const int nclusters = (int)gridDim.x / cn, c_id = (int)blockIdx.x / cn;
  const int t0 = c_id * a.tiles / nclusters;  // no overflow: the entry checks
  const int t1 = (c_id + 1) * a.tiles / nclusters;
  const int nkb64 = (K + kBlockK - 1) / kBlockK;
  const int kb0 = rank * nkb64 / cn, kb1 = (rank + 1) * nkb64 / cn;
  const int kbeg = kb0 * kBlockK, kend = min(K, kb1 * kBlockK);
  const int chunks = kend > kbeg ? (kend - kbeg + a.kc - 1) / a.kc : 0;
  const int units = (t1 - t0) * chunks;
  const int u0 = warp * units / kWarps, u1 = (warp + 1) * units / kWarps;
  const int rs = a.kc + kRowPad, stage = kTileRows * rs;
  const uint32_t ring = ptx::smem_addr(smem + lay.ring) + warp * a.depth * stage;
  uint64_t* my_bars = bars + warp * a.depth;
  const int m0 = blockIdx.y * mt;
  const int mrows = min(mt, a.M - m0);

  // unit u of this block into stage (u - u0) % depth: tile u / chunks, the
  // kc bytes of the slice at chunk u % chunks, a row each
  auto issue = [&](int u, bool refill) {
    const int s = (u - u0) % a.depth;
    const int tl = u / chunks, k0 = kbeg + (u - tl * chunks) * a.kc;
    const int bytes = min(a.kc, kend - k0);
    int n0;
    const Member& w = a.mem[tile_member(a, t0 + tl, n0)];
    const uint32_t dst = ring + s * stage;
    if constexpr (kBulk) {
      if (lane == 0) ptx::mbar_arrive_expect_tx(&my_bars[s], kTileRows * bytes);
      __syncwarp();
      if (lane < kTileRows) {
        // rows past N read row N - 1: their sums are never stored
        const int row = min(n0 + lane, w.o.N - 1);
        if (refill) ptx::fence_proxy_async();  // the stage's reads before the copy
        ptx::bulk_load_to(dst + lane * rs, w.wq + (size_t)row * K + k0, bytes,
                          ptx::smem_addr(&my_bars[s]));
      }
    } else {
      const int words = bytes / 4;  // K % 4 == 0
      for (int i = lane; i < kTileRows * words; i += 32) {
        const int r = i / words, q = i - r * words;
        const int row = min(n0 + r, w.o.N - 1);
        const uint32_t v = __ldg(reinterpret_cast<const unsigned*>(
            w.wq + (size_t)row * K + k0 + 4 * q));
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(dst + r * rs + 4 * q), "r"(v)
                     : "memory");
      }
    }
  };

  // The weights' first units are issued right after the reads of this
  // block's slice of x (which then sit ahead of the ring's ~150 KB an SM)
  // and before the quantize, which hides behind the copies' DRAM latency.
  // The mbarriers are set up first: their fence is a release, which would
  // wait for the reads of x.
  if constexpr (kBulk) {
    if (lane == 0) {
      for (int s = 0; s < a.depth; ++s) ptx::mbar_init(&my_bars[s], 1);
      ptx::fence_barrier_init();
    }
    __syncwarp();
  }
  // the cluster's tiles this block stores, [f0, f1)
  const int f0 = t0 + rank * (t1 - t0) / cn, f1 = t0 + (rank + 1) * (t1 - t0) / cn;
  // the stored columns: column j's scale and bias into col_ws[j] and
  // col_b[j], its member (bits 24 up) and n into col_n[j] (-1 past N); a
  // thread's first kColRegs scales and biases are read into registers
  // before the ring starts and stored once the quantize is done
  const int ncols = (f1 - f0) * kTileRows;
  auto col_at = [&](int j, float& ws, float& bias) {
    int n0;
    const int mem = tile_member(a, f0 + j / kTileRows, n0);
    const OutSide& o = a.mem[mem].o;
    const int n = n0 + j % kTileRows;
    const bool in = n < o.N && a.out_kind != kOutS32;
    ws = in ? o.ws[n] : 0.0f;
    bias = in ? bias_at(o, a.out_kind, n) : 0.0f;
    return n < o.N ? mem << 24 | n : -1;
  };
  float cw[kColRegs], cb[kColRegs];
  int cn_[kColRegs];
  auto start_ring = [&]() {
#pragma unroll
    for (int q = 0; q < kColRegs; ++q)
      if (tid + q * kThreads < ncols) cn_[q] = col_at(tid + q * kThreads, cw[q], cb[q]);
    if constexpr (kBulk) {
      for (int u = u0; u < u1 && u < u0 + a.depth; ++u) issue(u, false);
    }
  };
  auto store_cols = [&]() {
#pragma unroll
    for (int q = 0; q < kColRegs; ++q) {
      const int j = tid + q * kThreads;
      if (j < ncols) col_ws[j] = cw[q], col_b[j] = cb[q], col_n[j] = cn_[q];
    }
    for (int j = tid + kColRegs * kThreads; j < ncols; j += kThreads)
      col_n[j] = col_at(j, col_ws[j], col_b[j]);
  };
  for (int i = tid; i < a.slots * mt * kTileRows; i += kThreads) acc_s[i] = 0;

  // --- prologue: this block's K slice of x's m tile, quantized ---
  // Units of 16 elements (16 quantized bytes): row r of the m tile goes to
  // a group of L = kThreads / G consecutive threads (G = M's rows rounded
  // up to a power of two: at most 64 rows, so at least 8 threads a row),
  // each taking the row's units li, li + L, ... (QU of them); its first
  // kKeepT (all of them, on the plans ops/w8a8.py picks) are read at once
  // and stay in registers from the max to the quantize, later ones are
  // read twice. A group's maximum meets in a shuffle reduction and one
  // atomic a warp; the partial maxima of the cluster's slices meet through
  // distributed shared memory (a cluster of one takes all of K). Rows past
  // M are zeros.
  const int upr = (kb1 - kb0) * (kBlockK / 16);  // units a row in the slice
  int G = 1;
  while (G < mrows) G *= 2;
  const int L = kThreads / G, gi = tid / L, li = tid - gi * L;
  const int QU = (upr + L - 1) / L;
  const bool my_row = gi < mrows;
  const T* xr = static_cast<const T*>(a.x) + (size_t)(m0 + gi) * K + kbeg;
  uint8_t* qr = xq + gi * a.stride;
  for (int i = mrows * a.stride / 16 + tid; i < mt * a.stride / 16; i += kThreads)
    reinterpret_cast<uint4*>(xq)[i] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (std::is_same<T, int8_t>::value) {
    // int8 rows: copied as they are (zeros past K), no scale
    if (my_row)
      for (int c = li; c < upr; c += L) {
        uint4 word = make_uint4(0u, 0u, 0u, 0u);
        if (kbeg + c * 16 < K) word = __ldg(reinterpret_cast<const uint4*>(xr + c * 16));
        *reinterpret_cast<uint4*>(qr + c * 16) = word;
      }
    start_ring();
    cluster.sync();  // the peers have started and zeroed their sums
  } else {
    constexpr int kKeepT = kKeepBytes / sizeof(Raw16<T>);
    const int xk = K - kbeg;  // the row's elements from the slice on
    Raw16<T> keep[kKeepT];
#pragma unroll
    for (int q = 0; q < kKeepT; ++q) {
      const int c = li + q * L;
      if (my_row && q < QU && c < upr) load_raw(xr, c * 16, xk, keep[q]);
    }
    start_ring();
    for (int i = tid; i < mt; i += kThreads) rowmax[i] = 0u;
    float m = 0.0f;
#pragma unroll
    for (int q = 0; q < kKeepT; ++q) {
      const int c = li + q * L;
      if (my_row && q < QU && c < upr) m = fmaxf(m, abs_max(keep[q]));
    }
    for (int q = kKeepT; q < QU; ++q) {  // later units, read here and below
      const int c = li + q * L;
      if (my_row && c < upr) {
        Raw16<T> v;
        load_raw(xr, c * 16, xk, v);
        m = fmaxf(m, abs_max(v));
      }
    }
    // the group's maximum: non-negative floats order as their bits do
    unsigned mb = __float_as_uint(m);
    if (L >= 32) {
      mb = __reduce_max_sync(0xffffffffu, mb);
    } else {
      for (int o = L / 2; o > 0; o /= 2) mb = max(mb, __shfl_xor_sync(0xffffffffu, mb, o));
    }
    __syncthreads();  // rowmax is zeroed
    if (my_row && li % 32 == 0) atomicMax(&rowmax[gi], mb);
    cluster.sync();  // every block's partial maxima are in place
    for (int r = tid; r < mrows; r += kThreads) {
      float pm[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        pm[q] = q < cn ? __uint_as_float(cluster.map_shared_rank(rowmax, q)[r]) : 0.0f;
      float mx = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) mx = fmaxf(mx, pm[q]);
      scale[r] = row_scale(mx);
    }
    __syncthreads();
    if (my_row) {
      const float sc = scale[gi], rc = __frcp_rn(sc);
      auto put = [&](int c, const Raw16<T>& v) {
        float f[16];
        unpack(v, f);
        *reinterpret_cast<uint4*>(qr + c * 16) = quantize16_exact(f, sc, rc);
      };
#pragma unroll
      for (int q = 0; q < kKeepT; ++q) {
        const int c = li + q * L;
        if (q < QU && c < upr) put(c, keep[q]);
      }
      for (int q = kKeepT; q < QU; ++q) {
        const int c = li + q * L;
        if (c < upr) {
          Raw16<T> v;
          load_raw(xr, c * 16, xk, v);
          put(c, v);
        }
      }
    }
  }
  store_cols();
  __syncthreads();  // the slice and the columns are in place, the sums are 0

  // --- products: this warp's units, stage by stage ---
  const uint32_t xb = ptx::smem_addr(xq) + g * a.stride + tig * 16;
  int acc[kNT][4];
#pragma unroll
  for (int t = 0; t < kNT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0;
  for (int u = u0; u < u1; ++u) {
    const int j = u - u0, s = j % a.depth;
    const int tl = u / chunks, c = u - tl * chunks;
    const int k0 = c * a.kc;  // from kbeg
    if constexpr (kBulk) {
      ptx::mbar_wait(&my_bars[s], (j / a.depth) & 1);  // the stage has landed
    } else {
      issue(u, true);  // 4-byte words, copied now
      __syncwarp();
    }
    const uint32_t st = ring + s * stage + g * rs + tig * 16;
    const int nkb = (min(a.kc, kend - kbeg - k0) + kBlockK - 1) / kBlockK;
    for (int kb = 0; kb < nkb; ++kb) {
      const uint4 lo = lds128(st + kb * kBlockK);
      const uint4 hi = lds128(st + 8 * rs + kb * kBlockK);
      const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
      const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const uint4 bv = lds128(xb + t * 8 * a.stride + k0 + kb * kBlockK);
        ptx::mma_s8(acc[t], a0, bv.x, bv.y);
        ptx::mma_s8(acc[t], a1, bv.z, bv.w);
      }
    }
    __syncwarp();  // every lane has read the stage
    if constexpr (kBulk) {
      if (u + a.depth < u1) issue(u + a.depth, true);
    }
    if (c == chunks - 1 || u + 1 == u1) {
      // the warp leaves tile tl: its partial sums into the tile's owner's
      // (the block of the cluster that stores it: block r owns the tiles
      // [r nt / cn, (r + 1) nt / cn) of the cluster's nt), as reductions
      // into distributed shared memory. C fragment: acc[t][i] is weight
      // row g (+8 for i >= 2), token row 8t + 2 tig (+1 for odd i)
      const int owner = ((tl + 1) * cn - 1) / (t1 - t0);
      const int slot = tl - owner * (t1 - t0) / cn;
      int* sum = acc_s + slot * mt * kTileRows;
      const uint32_t remote = ptx::mapa(ptx::smem_addr(sum), owner);
      auto add = [&](int at, int v) {
        if (owner == rank)
          atomicAdd(sum + at, v);
        else
          ptx::red_cluster_add(remote + 4 * at, v);
      };
#pragma unroll
      for (int t = 0; t < kNT; ++t) {
        const int tok = 8 * t + 2 * tig;
        add(tok * kTileRows + g, acc[t][0]);
        add((tok + 1) * kTileRows + g, acc[t][1]);
        add(tok * kTileRows + g + 8, acc[t][2]);
        add((tok + 1) * kTileRows + g + 8, acc[t][3]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[t][i] = 0;
      }
    }
  }
  cluster.sync();  // every block's sums are in their owners' memory

  // --- epilogue: block `rank` stores the cluster's tiles it owns, [f0,
  // f1): output (m, column j) at e = m * ncols + j, so stores run along N;
  // one loop an output kind (the code a launch runs stays small) ---
  void* const out0 = a.mem[0].o.out;
  void* const out1 = a.mem[a.nmem > 1 ? 1 : 0].o.out;
  void* const out2 = a.mem[a.nmem > 2 ? 2 : 0].o.out;
  const int n_0 = a.mem[0].o.N, n_1 = a.mem[a.nmem > 1 ? 1 : 0].o.N;
  const int n_2 = a.mem[a.nmem > 2 ? 2 : 0].o.N;
  const int biased = (a.mem[0].o.bias != nullptr) | (a.nmem > 1 && a.mem[1].o.bias != nullptr) << 1 |
                     (a.nmem > 2 && a.mem[2].o.bias != nullptr) << 2;
  const int total = mrows * ncols;
  auto each = [&](auto store) {
    for (int e = tid; e < total; e += kThreads) {
      const int m = e / ncols, j = e - m * ncols;
      const int place = col_n[j];
      if (place < 0) continue;
      const int mem = place >> 24, n = place & 0xffffff;
      const int v = acc_s[((j / kTileRows) * mt + m) * kTileRows + j % kTileRows];
      const size_t row = (size_t)(m0 + m) * (mem == 0 ? n_0 : mem == 1 ? n_1 : n_2);
      store(mem == 0 ? out0 : mem == 1 ? out1 : out2, row + n, v, m, j, (biased >> mem) & 1);
    }
  };
  if (a.out_kind == kOutS32) {
    each([&](void* out, size_t o, int v, int, int, bool) { static_cast<int*>(out)[o] = v; });
  } else if (a.out_kind == kOutF32) {
    each([&](void* out, size_t o, int v, int m, int j, bool b) {
      static_cast<float*>(out)[o] = epi_f32(v, scale[m], col_ws[j], b, col_b[j]);
    });
  } else {
    each([&](void* out, size_t o, int v, int m, int j, bool b) {
      static_cast<__nv_bfloat16*>(out)[o] = epi_bf16(v, scale[m], col_ws[j], b, col_b[j]);
    });
  }
}

// Lets `kernel` take up to kMaxSmem of dynamic shared memory: once a
// process (a launch captured in a CUDA graph makes no such call after its
// warm-up). Returns the attribute call's error.
template <typename T, int kNT, bool kBulk>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      w8a8_qgemm_kernel<T, kNT, kBulk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
}

// The launch configuration of a grid of `grid_x` x `grid_y` blocks in
// clusters of `cluster`.
struct Config {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  Config(int grid_x, int grid_y, int cluster, int smem, cudaStream_t st) {
    cfg.gridDim = dim3(grid_x, grid_y);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    // a cluster of one launches as a plain grid (its cluster barrier is
    // the block's)
    cfg.attrs = &attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
  }
};

template <typename T, int kNT, bool kBulk>
int launch_kernel(const Args& a, int grid_x, int cluster, int smem,
                  cudaStream_t st) {
  const cudaError_t err = allow_smem<T, kNT, kBulk>();
  if (err != cudaSuccess) return (int)err;
  Config c(grid_x, (a.M + a.mt - 1) / a.mt, cluster, smem, st);
  return (int)cudaLaunchKernelEx(&c.cfg, w8a8_qgemm_kernel<T, kNT, kBulk>, a);
}

template <typename T, int kNT>
int launch_rows(const Args& a, bool bulk, int grid_x, int cluster, int smem,
                cudaStream_t st) {
  if constexpr (std::is_same<T, int8_t>::value) {
    // the s32 kind needs K % 16 == 0 and 16-byte-aligned weights
    if (!bulk) return (int)cudaErrorInvalidValue;
    return launch_kernel<T, kNT, true>(a, grid_x, cluster, smem, st);
  } else {
    return bulk ? launch_kernel<T, kNT, true>(a, grid_x, cluster, smem, st)
                : launch_kernel<T, kNT, false>(a, grid_x, cluster, smem, st);
  }
}

template <typename T>
int launch_t(const Args& a, bool bulk, int grid_x, int cluster, int smem,
             cudaStream_t st) {
  switch (a.mt / 8) {
    case 1:
      return launch_rows<T, 1>(a, bulk, grid_x, cluster, smem, st);
    case 2:
      return launch_rows<T, 2>(a, bulk, grid_x, cluster, smem, st);
    case 4:
      return launch_rows<T, 4>(a, bulk, grid_x, cluster, smem, st);
    case 6:
      return launch_rows<T, 6>(a, bulk, grid_x, cluster, smem, st);
    default:
      return launch_rows<T, 8>(a, bulk, grid_x, cluster, smem, st);
  }
}

template <int kNT>
int clusters(int smem, int cluster, int* out) {
  const cudaError_t err = allow_smem<__nv_bfloat16, kNT, true>();
  if (err != cudaSuccess) return (int)err;
  Config c(cluster, 1, cluster, smem, nullptr);
  c.cfg.numAttrs = 1;  // the cluster dimension, even for a cluster of one
  return (int)cudaOccupancyMaxActiveClusters(
      out, w8a8_qgemm_kernel<__nv_bfloat16, kNT, true>, &c.cfg);
}

}  // namespace

// The clusters of `cluster` blocks of the bf16 instance for an m tile of
// `mt` rows, launched with `smem` bytes of shared memory a block (raised
// to one block an SM's, as every launch is), that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *out: a host query for the plan's
// tests and the tools.
extern "C" int ragtorch_w8a8_qgemm_clusters(int mt, int smem, int cluster, int* out) {
  *out = 0;
  if (cluster < 1 || cluster > kMaxCluster || smem < 0 || smem > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  smem = std::max(smem, kOneAnSm);
  switch (mt <= 8 ? 1 : mt <= 16 ? 2 : mt <= 32 ? 4 : mt <= 48 ? 6 : 8) {
    case 1: return clusters<1>(smem, cluster, out);
    case 2: return clusters<2>(smem, cluster, out);
    case 4: return clusters<4>(smem, cluster, out);
    case 6: return clusters<6>(smem, cluster, out);
    default: return clusters<8>(smem, cluster, out);
  }
}

// Shared memory a block of the quantize-and-GEMM takes for an m tile of
// `mt` rows at K split over a cluster of `cluster`, `slots` tiles of 16
// weight rows, and rings of `depth` stages of `kc` bytes of K (the
// wrapper's plan keeps it within the card's limit).
extern "C" int ragtorch_w8a8_qgemm_smem(int mt, int K, int cluster, int slots, int kc,
                                        int depth) {
  return Layout(mt, slice_max(K, cluster), slots, kc, depth).bytes;
}

// outs[i] [M, N[i]] (f32: out_kind 0, bf16: 1) = epilogue(quantize(x) .
// wq[i]^T) for i < nmem (1 to 3 members sharing x); x [M, K] bf16 (in_kind
// 1) or f32 (0), its base aligned to 4 elements; wq[i] [N[i], K] int8,
// 4-byte aligned (1-D bulk copies where every one is 16-byte aligned and K
// % 16 == 0, else 4-byte words); biases[i] null or [N[i]] of the output
// type. The s32 kind: in_kind 2 and out_kind 2 together, x [M, K] int8 (K
// a multiple of 16, x and every wq[i] 16-byte aligned), outs[i] [M, N[i]]
// int32 = x . wq[i]^T, ws and biases unread (may be null). K a multiple of
// 4. The plan (ops/w8a8.py::_qgemm_plan): mt 8 (M <= 8) or a multiple of
// 16 up to 64; kc 128, 256 or 512 bytes of K a
// unit; depth 1 to 8 stages a warp; grid_x blocks (at most the SMs: one
// an SM) sharing the tiles, in clusters of `cluster` (1, 2 or 8) that
// split K.
extern "C" int ragtorch_w8a8_qgemm(const void* x, const void* const* wq,
                                   const void* const* ws, const void* const* bias,
                                   void* const* out, const int* N, int nmem,
                                   int M, int K, int in_kind, int out_kind,
                                   int mt, int kc, int depth, int grid_x,
                                   int cluster, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t xalign = in_kind == 1 ? 8 : 16;
  if (nmem < 1 || nmem > kMaxMembers || M < 1 || K < 4 || K % 4 != 0 ||
      (in_kind != 0 && in_kind != 1 && in_kind != 2) ||
      (out_kind != kOutF32 && out_kind != ragtorch::w8a8::kOutBf16 && out_kind != kOutS32) ||
      (in_kind == 2) != (out_kind == kOutS32) || (in_kind == 2 && K % 16 != 0) ||
      !(mt == 8 ? M <= 8 : mt % 16 == 0 && mt >= 16 && mt <= kMaxRows) ||
      (kc != 128 && kc != 256 && kc != 512) ||
      depth < 1 ||
      depth > kMaxDepth || grid_x < 1 ||
      (cluster != 1 && cluster != 2 && cluster != kMaxCluster) ||
      grid_x % cluster != 0 || reinterpret_cast<uintptr_t>(x) % xalign != 0)
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.nmem = nmem;
  a.M = M, a.K = K, a.out_kind = out_kind, a.mt = mt;
  a.kc = kc, a.depth = depth;
  a.kmax = slice_max(K, cluster);
  a.stride = row_stride(a.kmax);
  bool bulk = K % 16 == 0;
  for (int i = 0; i < nmem; ++i) {
    if (N[i] < 1 || reinterpret_cast<uintptr_t>(wq[i]) % 4 != 0)
      return (int)cudaErrorInvalidValue;
    bulk = bulk && reinterpret_cast<uintptr_t>(wq[i]) % 16 == 0;
    const int tiles = (N[i] + kTileRows - 1) / kTileRows;
    a.mem[i] = Member{static_cast<const uint8_t*>(wq[i]),
                      OutSide{static_cast<const float*>(ws[i]), bias[i], out[i], N[i]},
                      tiles};
    a.tiles += tiles;
  }
  if ((long long)grid_x * a.tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int nclusters = grid_x / cluster;
  a.slots = ((a.tiles + nclusters - 1) / nclusters + cluster - 1) / cluster;
  const int smem = Layout(mt, a.kmax, a.slots, kc, depth).bytes;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const int launch_smem = std::max(smem, kOneAnSm);
  if (in_kind == 2)
    return launch_t<int8_t>(a, bulk, grid_x, cluster, launch_smem, st);
  return in_kind == 1
             ? launch_t<__nv_bfloat16>(a, bulk, grid_x, cluster, launch_smem, st)
             : launch_t<float>(a, bulk, grid_x, cluster, launch_smem, st);
}
