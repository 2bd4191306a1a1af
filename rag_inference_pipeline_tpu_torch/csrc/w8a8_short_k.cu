// W8A8 product for small row counts over short rows (K <= 1,024) on Hopper
// (sm_90a), the short-K kernel: the activation quantize and the s8 GEMM
// with its dequant epilogue in one launch, for a group of up to three
// weight matrices that share the activations.
//
// Replaces no Pallas kernel: the reference computes this in XLA,
// rag_inference_pipeline_tpu/models/layers.py::quantize_act_rows (:80-89)
// followed by _qdense (:92-100) for each weight:
//   s   = max(max_k |x|, 1e-8) / 127; xq = clip(rint(x / s), -127, 127)
//   acc = xq . q  (s8 x s8 -> s32, exact)
//   y   = (f32(acc) * s[m]) * ws[n]    (w8a8_epilogue.cuh)
// ops/w8a8.py routes a small-row product here when K is at most 1,024 and
// its weights are a few MB (`_qgemm_short`: Qwen2.5-0.5B's q/k/v, o and
// gate/up at a decode step, the classifiers, their tp shards);
// w8a8_gemm.cu's kernel, which streams its weights at the card's rate,
// takes the other small-row products (long rows, the heads). At these
// shapes a product moves 0.8-9 MB, so the latency of a launch and of DRAM
// sets its time more than the bytes do (w8a8_gemm.cu's kernel measured
// 5-62% slower here on an H100: PERF.md).
//
// Design:
// - Prologue (the quantize folded in): the blocks of a cluster quantize
//   their m tile of x ([mt, K]: every K of up to 64 token rows) into each
//   one's shared memory, with w8a8_quant.cu's arithmetic (an abs-max over
//   the row, the scale an IEEE division, x / s by w8a8_round.cuh, rintf,
//   clip to +-127). Nothing is shared between clusters and no state
//   outlives the launch, so two streams may run the kernel at once. The
//   weights' first loads are issued before it, so the prologue hides their
//   DRAM latency.
// - Tiles: a block tile is nt8 x 8 weight rows of one group member; block b
//   takes tiles b, b + grid, ... over every member, so the grid fits the
//   card (at most two blocks an SM) however large N is (the head has
//   151,936 rows) and each block quantizes once.
// - Products: m16n8k32 s8 mma.sync, tokens as A (16 rows a tile) and 8
//   weight rows as B. The 8 warps of a block split the tile: nt8 n8 tiles
//   by 8 / nt8 K splits; each warp streams its weight pieces straight from
//   device memory into a private kDepth-deep ring of cp.async slots (16
//   bytes a lane and a 64-byte K block, 4-byte copies where K % 16 or a
//   base is not 16-aligned; zeros past K and rows past N), with no block
//   barrier in the loop. K is taken in 64-byte blocks whose bytes are
//   permuted: lane l's 16 bytes at l % 4 * 16 feed two k32 products. The
//   quantized x is read with the same permutation, so the sum is the same
//   exact integer (integer adds are exact in any order).
// - Reduction: with 8 n8 tiles a block tile each warp owns its tile over
//   all of K and runs the epilogue on its own fragments (no block barrier
//   after the prologue); with fewer, the K splits' exact partial sums meet
//   in shared memory at the end of each tile, and the block's threads add
//   them and run the epilogue with coalesced stores. Either way one
//   launch, no scratch, no second kernel; each tile's column scales and
//   biases are loaded as the tile starts.
// - The s32 kind (in_kind 2, out_kind 2): x is already int8 (a
//   row-parallel shard's columns of a row quantized whole, ops/w8a8.py::
//   w8a8_row_dense), copied into shared memory as it is, and each output is
//   the exact sum itself, with no scale and no bias.
// Nothing here allocates or synchronises: the wrapper (ops/w8a8.py)
// allocates the outputs and chooses mt, nt8 and the grid. The entry point
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <type_traits>

#include "ptx.cuh"
#include "w8a8_epilogue.cuh"
#include "w8a8_round.cuh"

namespace {

namespace cg = cooperative_groups;
namespace ptx = ragtorch::ptx;
using ragtorch::w8a8::OutSide;
using ragtorch::w8a8::quantize_exact;
using ragtorch::w8a8::row_scale;
using ragtorch::w8a8::bias_at;
using ragtorch::w8a8::epi_bf16;
using ragtorch::w8a8::epi_f32;
using ragtorch::w8a8::kOutF32;
using ragtorch::w8a8::kOutS32;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockK = 64;       // bytes of K an mma pair (the permutation)
constexpr int kItemK = 128;       // bytes of K a ring item: two 64-byte blocks
constexpr int kDepth = 8;         // ring slots a warp (32 bytes a lane each)
constexpr int kMaxCluster = 8;    // blocks that share the quantize of x
constexpr int kKeep = 2;          // x units a thread keeps in registers
constexpr int kMaxMembers = 3;
constexpr int kMaxRows = 64;      // token rows an m tile at most
constexpr int kMaxSmem = 232448;  // a block's shared memory on the H100

struct Member {
  const uint8_t* wq;  // [N, K] int8
  OutSide o;
  int tiles;          // block tiles of this member
};

struct Args {
  const void* x;  // [M, K] bf16, f32 or (the s32 kind) int8
  Member mem[kMaxMembers];
  int nmem, M, K, out_kind;
  int mt;      // token rows an m tile: 8, or a multiple of 16 up to 64
  int nt8;     // n8 tiles a block tile: 1, 2, 4 or 8
  int stride;  // bytes a quantized row takes in shared memory
  int tiles;   // block tiles over every member
};

// Bytes a quantized row of K takes in shared memory: K rounded up to the
// 64-byte K block, then to 64 past a multiple of 128, so that the eight
// rows one quarter-warp reads with 16-byte loads fall in distinct banks.
inline int row_stride(int K) {
  const int kp = (K + kBlockK - 1) / kBlockK * kBlockK;
  return kp % 128 == 64 ? kp : kp + 64;
}

// Shared memory of a block: the quantized m tile, the K splits' partial
// sums (8 warps x 8 columns x mt rows), the row scales and maxima, a tile's
// column scales and biases, and the warps' rings.
inline int smem_bytes(int mt, int K) {
  return mt * row_stride(K) + kWarps * 8 * mt * 4 + 2 * mt * 4 + 2 * 64 * 4 +
         kWarps * kDepth * 32 * 32;
}

// 16 elements of a row from element e: 4-element groups at or past K read
// as zeros (K % 4 == 0, so a group lies wholly on one side of K). Every
// load is issued before any is used.
__device__ __forceinline__ void load16(const float* row, int e, int K,
                                       float (&f)[16]) {
  float4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = e + 4 * i < K ? __ldg(reinterpret_cast<const float4*>(row + e + 4 * i))
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[4 * i] = v[i].x, f[4 * i + 1] = v[i].y, f[4 * i + 2] = v[i].z, f[4 * i + 3] = v[i].w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* row, int e, int K,
                                       float (&f)[16]) {
  uint2 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = e + 4 * i < K ? __ldg(reinterpret_cast<const uint2*>(row + e + 4 * i))
                         : make_uint2(0u, 0u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v[i]);
    const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
    f[4 * i] = a.x, f[4 * i + 1] = a.y, f[4 * i + 2] = b.x, f[4 * i + 3] = b.y;
  }
}

__device__ __forceinline__ uint32_t quantize4(const float* f, float scale, float rcp) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) w |= (uint32_t)(uint8_t)quantize_exact(f[i], scale, rcp) << (8 * i);
  return w;
}

// The member of block tile t and the first weight row of the tile.
__device__ __forceinline__ int tile_member(const Args& a, int t, int& n0) {
  int i = 0;
  while (i + 1 < a.nmem && t >= a.mem[i].tiles) t -= a.mem[i++].tiles;
  n0 = t * a.nt8 * 8;
  return i;
}

// Block (x: a share of the block tiles, y: an m tile of the token rows).
template <typename T, int kMT16, bool kVec16>
__global__ void __launch_bounds__(kThreads, 2)
w8a8_qshort_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int mt = a.mt;
  const bool half = mt == 8;  // rows 8-15 of the single m16 tile absent
  uint8_t* xq = smem;                                        // [mt][stride]
  int* red = reinterpret_cast<int*>(smem + mt * a.stride);   // [ks][mt][R]
  float* scale = reinterpret_cast<float*>(red + kWarps * 8 * mt);
  unsigned* rowmax = reinterpret_cast<unsigned*>(scale + mt);
  float* col_ws = reinterpret_cast<float*>(rowmax + mt);  // [64] a tile's
  float* col_b = col_ws + 64;                             // [64]
  const uint32_t ring = ptx::smem_addr(col_b + 64);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tig = lane % 4;
  const int K = a.K;
  const int nt8 = a.nt8, ks_n = kWarps / nt8, R = nt8 * 8;
  const int n8 = warp % nt8, ks = warp / nt8;
  const int nkb = (K + kItemK - 1) / kItemK;  // 128-byte K blocks: items a row
  const int per = ks < nkb ? (nkb - 1 - ks) / ks_n + 1 : 0;  // items a tile
  const int my_tiles =
      (int)blockIdx.x < a.tiles ? (a.tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int total = per * my_tiles;
  const int m0 = blockIdx.y * mt;
  const int mrows = min(mt, a.M - m0);

  // item c of this warp: its tile's weight row g, 128-byte K block
  // ks + i * ks_n (two 64-byte blocks: 16 bytes a lane of each)
  auto issue = [&](int c) {
    const int j = c / per;
    const int kb = ks + (c - j * per) * ks_n;
    int n0;
    const Member& w = a.mem[tile_member(a, (int)blockIdx.x + j * (int)gridDim.x, n0)];
    const int row = n0 + n8 * 8 + g;
    const bool in_n = row < w.o.N;
    const uint8_t* src = w.wq + (size_t)min(row, w.o.N - 1) * K;
    const uint32_t dst = ring + ((warp * kDepth + c % kDepth) * 32 + lane) * 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int off = kb * kItemK + h * kBlockK + tig * 16;
      if constexpr (kVec16) {
        const bool ok = in_n && off < K;
        ptx::cp_async<16>(dst + 16 * h, src + (ok ? off : 0), ok ? 16 : 0);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const bool ok = in_n && off + 4 * q < K;
          ptx::cp_async<4>(dst + 16 * h + 4 * q, src + (ok ? off + 4 * q : 0), ok ? 4 : 0);
        }
      }
    }
  };

  // the weights' first pieces fly while the cluster quantizes x
  for (int c = 0; c < kDepth - 1; ++c) {
    if (c < total) issue(c);
    ptx::cp_async_commit();
  }
  // tile j's column scale and bias, for thread r < R: loaded when the tile
  // starts, kept in shared memory for its epilogue
  float pre_ws = 0.0f, pre_b = 0.0f;
  auto fetch_cols = [&](int j) {
    int n0;
    const Member& w = a.mem[tile_member(a, (int)blockIdx.x + j * (int)gridDim.x, n0)];
    if (tid < R && n0 + tid < w.o.N && a.out_kind != kOutS32) {
      pre_ws = w.o.ws[n0 + tid];
      pre_b = bias_at(w.o, a.out_kind, n0 + tid);
    }
  };
  // nt8 == 8: each warp owns whole n8 tiles over all of K and stores its
  // outputs itself (no block barrier in the tile loop); else the warps
  // split K and meet in shared memory at the end of each tile
  const bool solo = ks_n == 1;
  if (my_tiles > 0 && !solo) fetch_cols(0);

  // --- prologue: x's m tile quantized into every block of the cluster ---
  // Block `rank` of a cluster of `cn` takes the 64-byte K blocks [kb0, kb1)
  // of every row: their partial abs-maxima meet through distributed shared
  // memory, then it quantizes its slice and stores it into each block's
  // copy (a cluster of one quantizes all of K itself). Units of 16
  // elements (16 quantized bytes); a thread's first kKeep units stay in
  // registers from the max to the quantize.
  cg::cluster_group cluster = cg::this_cluster();
  const int cn = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nkb64 = (K + kBlockK - 1) / kBlockK;
  const int kb0 = rank * nkb64 / cn, kb1 = (rank + 1) * nkb64 / cn;
  const int upr = (kb1 - kb0) * (kBlockK / 16);  // units a row in the slice
  const int units = mrows * upr;
  const T* x = static_cast<const T*>(a.x) + (size_t)m0 * K;
  auto unit_at = [&](int u, int& r) {
    r = u / upr;
    return kb0 * kBlockK + (u - r * upr) * 16;
  };
  if constexpr (std::is_same<T, int8_t>::value) {
    // int8 rows: copied as they are (zeros past K and past M), no scale
    cluster.sync();  // every block of the cluster has started
    for (int u = tid; u < mt * upr; u += kThreads) {
      int r;
      const int e = unit_at(u, r);
      uint4 word = make_uint4(0u, 0u, 0u, 0u);
      if (u < units && e < K)
        word = __ldg(reinterpret_cast<const uint4*>(x + (size_t)r * K + e));
      uint4* dst = reinterpret_cast<uint4*>(xq + r * a.stride + e);
      for (int q = 0; q < cn; ++q) *cluster.map_shared_rank(dst, q) = word;
    }
  } else {
    for (int i = tid; i < mt; i += kThreads) rowmax[i] = 0u;
    __syncthreads();
    float keep[kKeep][16];
#pragma unroll
    for (int i = 0; i < kKeep; ++i) {
      const int u = tid + i * kThreads;
      if (u < units) {
        int r;
        const int e = unit_at(u, r);
        load16(x + (size_t)r * K, e, K, keep[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kKeep; ++i) {
      const int u = tid + i * kThreads;
      if (u < units) {
        float m = 0.0f;
#pragma unroll
        for (int q = 0; q < 16; ++q) m = fmaxf(m, fabsf(keep[i][q]));
        // non-negative floats order as their bits do
        atomicMax(&rowmax[u / upr], __float_as_uint(m));
      }
    }
    for (int u = tid + kKeep * kThreads; u < units; u += kThreads) {
      int r;
      const int e = unit_at(u, r);
      float f[16];
      load16(x + (size_t)r * K, e, K, f);
      float m = 0.0f;
#pragma unroll
      for (int q = 0; q < 16; ++q) m = fmaxf(m, fabsf(f[q]));
      atomicMax(&rowmax[r], __float_as_uint(m));
    }
    cluster.sync();  // every block's partial maxima are in place
    for (int r = tid; r < mrows; r += kThreads) {
      float pm[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        pm[q] = q < cn ? __uint_as_float(cluster.map_shared_rank(rowmax, q)[r]) : 0.0f;
      float m = 0.0f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) m = fmaxf(m, pm[q]);
      scale[r] = row_scale(m);
    }
    __syncthreads();
    // unit u quantized from its 16 elements (valid), or zeros (past M)
    auto put = [&](int u, bool valid, const float (&f)[16]) {
      int r;
      const int e = unit_at(u, r);
      uint4 word = make_uint4(0u, 0u, 0u, 0u);
      if (valid) {
        const float sc = scale[r], rc = __frcp_rn(sc);
        word = make_uint4(quantize4(f, sc, rc), quantize4(f + 4, sc, rc),
                          quantize4(f + 8, sc, rc), quantize4(f + 12, sc, rc));
      }
      uint4* dst = reinterpret_cast<uint4*>(xq + r * a.stride + e);
      for (int q = 0; q < cn; ++q) *cluster.map_shared_rank(dst, q) = word;
    };
#pragma unroll
    for (int i = 0; i < kKeep; ++i) {
      const int u = tid + i * kThreads;
      if (u < mt * upr) put(u, u < units, keep[i]);
    }
    for (int u = tid + kKeep * kThreads; u < mt * upr; u += kThreads) {
      float f[16];
      if (u < units) {
        int r;
        const int e = unit_at(u, r);
        load16(x + (size_t)r * K, e, K, f);
      }
      put(u, u < units, f);
    }
  }
  cluster.sync();  // every slice has landed in every block

  // --- products: this warp's items, tile by tile ---
  const uint8_t* xb = xq + g * a.stride + tig * 16;
  for (int j = 0; j < my_tiles; ++j) {
    int n0;
    const Member& w = a.mem[tile_member(a, (int)blockIdx.x + j * (int)gridDim.x, n0)];
    // solo: this lane's two columns' scales and biases, loaded as the tile
    // starts
    const int n1 = n0 + n8 * 8 + 2 * tig;
    float sws[2] = {0.0f, 0.0f}, sb[2] = {0.0f, 0.0f};
    if (solo) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (n1 + i < w.o.N && a.out_kind != kOutS32)
          sws[i] = w.o.ws[n1 + i], sb[i] = bias_at(w.o, a.out_kind, n1 + i);
    } else if (j > 0) {
      fetch_cols(j);
    }
    int acc[kMT16][4];
#pragma unroll
    for (int t = 0; t < kMT16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] = 0;
    for (int i = 0; i < per; ++i) {
      const int c = j * per + i;
      if (c + kDepth - 1 < total) issue(c + kDepth - 1);
      ptx::cp_async_commit();
      ptx::cp_async_wait<kDepth - 1>();  // this lane's item c has landed
      const uint32_t slot = ring + ((warp * kDepth + c % kDepth) * 32 + lane) * 32;
      const int kb = ks + i * ks_n;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (2 * kb + h >= nkb64) break;  // past K: nothing of x or w there
        uint4 wv;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(wv.x), "=r"(wv.y), "=r"(wv.z), "=r"(wv.w)
                     : "r"(slot + 16 * h)
                     : "memory");
#pragma unroll
        for (int t = 0; t < kMT16; ++t) {
          const uint8_t* p = xb + t * 16 * a.stride + kb * kItemK + h * kBlockK;
          const uint4 lo = *reinterpret_cast<const uint4*>(p);
          const uint4 hi = half ? make_uint4(0, 0, 0, 0)
                                : *reinterpret_cast<const uint4*>(p + 8 * a.stride);
          const uint32_t a0[4] = {lo.x, hi.x, lo.y, hi.y};
          const uint32_t a1[4] = {lo.z, hi.z, lo.w, hi.w};
          ptx::mma_s8(acc[t], a0, wv.x, wv.y);
          ptx::mma_s8(acc[t], a1, wv.z, wv.w);
        }
      }
    }
    // C fragment: acc[t][i] is token row 16t + g (+8 for i >= 2), weight
    // column n8 * 8 + 2 tig (+1 for odd i)
    const bool has_bias = w.o.bias != nullptr;
    if (solo) {
#pragma unroll
      for (int t = 0; t < kMT16; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = 16 * t + g + (i >= 2 ? 8 : 0), n = n1 + (i & 1);
          if (m >= mrows || n >= w.o.N) continue;
          const size_t o = (size_t)(m0 + m) * w.o.N + n;
          if (a.out_kind == kOutS32)
            static_cast<int*>(w.o.out)[o] = acc[t][i];
          else if (a.out_kind == kOutF32)
            static_cast<float*>(w.o.out)[o] =
                epi_f32(acc[t][i], scale[m], sws[i & 1], has_bias, sb[i & 1]);
          else
            static_cast<__nv_bfloat16*>(w.o.out)[o] =
                epi_bf16(acc[t][i], scale[m], sws[i & 1], has_bias, sb[i & 1]);
        }
      continue;
    }
#pragma unroll
    for (int t = 0; t < kMT16; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = 16 * t + g + (i >= 2 ? 8 : 0);
        if (m < mt) red[(ks * mt + m) * R + n8 * 8 + 2 * tig + (i & 1)] = acc[t][i];
      }
    if (tid < R) col_ws[tid] = pre_ws, col_b[tid] = pre_b;
    __syncthreads();
    for (int e = tid; e < mrows * R; e += kThreads) {
      const int m = e / R, r = e - m * R;
      if (n0 + r >= w.o.N) continue;
      int sum = 0;
      for (int k = 0; k < ks_n; ++k) sum += red[(k * mt + m) * R + r];
      const size_t o = (size_t)(m0 + m) * w.o.N + n0 + r;
      if (a.out_kind == kOutS32)
        static_cast<int*>(w.o.out)[o] = sum;
      else if (a.out_kind == kOutF32)
        static_cast<float*>(w.o.out)[o] = epi_f32(sum, scale[m], col_ws[r], has_bias, col_b[r]);
      else
        static_cast<__nv_bfloat16*>(w.o.out)[o] =
            epi_bf16(sum, scale[m], col_ws[r], has_bias, col_b[r]);
    }
    __syncthreads();
  }
  ptx::cp_async_wait<0>();  // no copy outlives the block
}

// Lets `kernel` take up to kMaxSmem of dynamic shared memory: once a
// process (a launch captured in a CUDA graph makes no such call after its
// warm-up). Returns the attribute call's error.
template <typename T, int kMT16, bool kVec16>
cudaError_t allow_smem() {
  static const cudaError_t err = cudaFuncSetAttribute(
      w8a8_qshort_kernel<T, kMT16, kVec16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
}

template <typename T, int kMT16, bool kVec16>
int launch_kernel(const Args& a, int grid_x, int cluster, int smem, cudaStream_t st) {
  const cudaError_t err = allow_smem<T, kMT16, kVec16>();
  if (err != cudaSuccess) return (int)err;
  if (cluster == 1) {
    w8a8_qshort_kernel<T, kMT16, kVec16>
        <<<dim3(grid_x, (a.M + a.mt - 1) / a.mt), kThreads, smem, st>>>(a);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, (a.M + a.mt - 1) / a.mt);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, w8a8_qshort_kernel<T, kMT16, kVec16>, a);
}

template <typename T, int kMT16>
int launch_rows(const Args& a, bool vec16, int grid_x, int cluster, int smem,
                cudaStream_t st) {
  return vec16 ? launch_kernel<T, kMT16, true>(a, grid_x, cluster, smem, st)
               : launch_kernel<T, kMT16, false>(a, grid_x, cluster, smem, st);
}

template <typename T>
int launch_t(const Args& a, bool vec16, int grid_x, int cluster, int smem,
             cudaStream_t st) {
  switch ((a.mt + 15) / 16) {
    case 1:
      return launch_rows<T, 1>(a, vec16, grid_x, cluster, smem, st);
    case 2:
      return launch_rows<T, 2>(a, vec16, grid_x, cluster, smem, st);
    case 3:
      return launch_rows<T, 3>(a, vec16, grid_x, cluster, smem, st);
    default:
      return launch_rows<T, 4>(a, vec16, grid_x, cluster, smem, st);
  }
}

}  // namespace

// Shared memory a block of the quantize-and-GEMM takes for an m tile of
// `mt` rows at K (the wrapper's plan keeps it within the card's limit).
extern "C" int ragtorch_w8a8_qshort_smem(int mt, int K) { return smem_bytes(mt, K); }

// outs[i] [M, N[i]] (f32: out_kind 0, bf16: 1) = epilogue(quantize(x) .
// wq[i]^T) for i < nmem (1 to 3 members sharing x); x [M, K] bf16 (in_kind
// 1) or f32 (0), its base aligned to 4 elements; wq[i] [N[i], K] int8,
// 4-byte aligned; biases[i] null or [N[i]] of the output type. The s32
// kind: in_kind 2 and out_kind 2 together, x [M, K] int8 (K a multiple of
// 16, x 16-byte aligned), outs[i] [M, N[i]] int32 = x . wq[i]^T, ws and
// biases unread (may be null). K a multiple of 4; mt 8 (M <= 8) or a multiple of 16 up to 64; nt8 1, 2, 4 or 8;
// grid_x blocks a share of the tiles, in clusters of `cluster` (1 or 8)
// that share the quantize of x.
extern "C" int ragtorch_w8a8_qshort(const void* x, const void* const* wq,
                                   const void* const* ws, const void* const* bias,
                                   void* const* out, const int* N, int nmem,
                                   int M, int K, int in_kind, int out_kind,
                                   int mt, int nt8, int grid_x, int cluster,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t xalign = in_kind == 1 ? 8 : 16;
  if (nmem < 1 || nmem > kMaxMembers || M < 1 || K < 4 || K % 4 != 0 ||
      (in_kind != 0 && in_kind != 1 && in_kind != 2) ||
      (out_kind != kOutF32 && out_kind != ragtorch::w8a8::kOutBf16 && out_kind != kOutS32) ||
      (in_kind == 2) != (out_kind == kOutS32) || (in_kind == 2 && K % 16 != 0) ||
      !(mt == 8 ? M <= 8 : mt % 16 == 0 && mt >= 16 && mt <= kMaxRows) ||
      (nt8 != 1 && nt8 != 2 && nt8 != 4 && nt8 != 8) || grid_x < 1 ||
      (cluster != 1 && cluster != kMaxCluster) || grid_x % cluster != 0 ||
      reinterpret_cast<uintptr_t>(x) % xalign != 0)
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(mt, K);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  Args a{};
  a.x = x;
  a.nmem = nmem;
  a.M = M, a.K = K, a.out_kind = out_kind, a.mt = mt, a.nt8 = nt8;
  a.stride = row_stride(K);
  bool vec16 = K % 16 == 0;
  for (int i = 0; i < nmem; ++i) {
    if (N[i] < 1 || reinterpret_cast<uintptr_t>(wq[i]) % 4 != 0)
      return (int)cudaErrorInvalidValue;
    vec16 = vec16 && reinterpret_cast<uintptr_t>(wq[i]) % 16 == 0;
    const int tiles = (N[i] + nt8 * 8 - 1) / (nt8 * 8);
    a.mem[i] = Member{static_cast<const uint8_t*>(wq[i]),
                      OutSide{static_cast<const float*>(ws[i]), bias[i], out[i], N[i]},
                      tiles};
    a.tiles += tiles;
  }
  if (in_kind == 2) return launch_t<int8_t>(a, vec16, grid_x, cluster, smem, st);
  return in_kind == 1 ? launch_t<__nv_bfloat16>(a, vec16, grid_x, cluster, smem, st)
                      : launch_t<float>(a, vec16, grid_x, cluster, smem, st);
}
