// W8A8 GEMM for large row counts on Hopper (sm_90a): wgmma on s8 fed by TMA,
// one launch for a group of up to three weights that share the rows, on a
// launch plan that fills the card whether the rows make many tiles or few.
//
// Replaces no Pallas kernel: the reference computes this product in XLA,
// rag_inference_pipeline_tpu/models/layers.py::_qdense (:92-100, and the
// int8 heads of models/qwen.py::_logits, :309-327):
//   acc = xq . q  (s8 x s8 -> s32, exact)
//   y   = (f32(acc) * xs[m]) * s[n]    (w8a8_epilogue.cuh)
// ops/w8a8.py routes a product here when it has more rows than the small
// route's threshold (prefill, the encoders at 8 x 512 tokens, the verify
// round's B x (gamma + 1) rows, the engine's speculative segments); xq and
// xs come from quantize_rows (w8a8_quant.cu).
//
// Bound on the H100 (1,979 TOP/s int8, dense; 3.35 TB/s): a prefill gate/up
// (4,096 x 896 -> 4,864) is 35.7 G operations, 18 us; at 72 rows a product
// streams its weights once and is bound by bytes (the verify round's down,
// 72 x 4,864 -> 896: 4.4 MB, 1.3 us), so there the time goes to how many
// SMs stream at once and to the latency of the first loads.
//
// Design:
// - Operands: the int8 form of wgmma takes only K-major operands, and the
//   port's layouts are K-major: xq [M, K] and the weights [N, K]
//   (QuantizedLinear.q). A block computes a kBM x kBN output tile: one or
//   two consumer warpgroups (kBM 64 or 128 rows), each m64nNk32 on its 64
//   rows, plus one producer warp.
// - Group: the grid's x runs over the column tiles of every weight of the
//   group (q/k/v, gate/up; up to three, each with its own tensor map,
//   scales, bias and output), its y over the row tiles.
// - Plan (ops/w8a8.py::_gemm_plan, host arithmetic): where 128-column
//   tiles give at least half as many blocks as SMs (prefill, the tied head),
//   a block takes its tile over all of K. Where they give fewer (the verify
//   round's 72 rows, a B = 1 prefill, the engine's 288 speculative rows),
//   tiles narrow to 64 x 64 (one consumer warpgroup); there K may split
//   across the `split` blocks of a thread block cluster (2 to 8) where a
//   block would stream a long K, so that the weights stream through as many
//   SMs as there are.
// - Loads: the producer's lane 0 issues 2-D TMA tile loads (kBM or kBN rows
//   x 128 bytes of K, 128-byte swizzle) of both operands into a ring of
//   stages, each guarded by a "full" mbarrier (the loads' bytes) and an
//   "empty" one (one arrival per consumer warp once its wgmmas on the stage
//   have completed). TMA fills rows past M or N and bytes past K with
//   zeros, so ragged edges add nothing to the sums. The stages take ~96 KB
//   so that two blocks share an SM, one's epilogue overlapping the other's
//   products. (Six stages, one block an SM, and a persistent block an SM
//   with a ring that runs across tiles, both measured slower on an H100 at
//   prefill: PERF.md.)
// - Products: a stage's four k32 wgmmas stay in flight while the next
//   stage's are issued (wait_group 1), so the tensor cores do not idle
//   between stages.
// - Split K: a block takes a contiguous range of K's 128-byte chunks. Its
//   exact s32 partial sums go through distributed shared memory to the
//   block of the cluster that owns their rows (the tile's live rows split
//   evenly across the cluster's blocks); after one cluster barrier each
//   block adds the partials of its rows and runs the epilogue once for
//   them. Integer adds are exact in any order, so the result is the
//   unsplit sum bit for bit. No workspace in device memory, no atomics, no
//   counter: nothing outlives the launch, so a CUDA graph replays it as it
//   is and two streams may run it at once. A block arrives at the cluster
//   barrier (relaxed) as it starts and waits on it before its first store
//   into another block's shared memory, so every block has started by
//   then; the ring needs no change for the split, its partials have their
//   own shared memory.
// - Epilogue without a split: the tile's row scales, column scales and
//   biases are copied to shared memory while the products run. Each
//   consumer thread turns its exact sums into outputs with the epilogue of
//   w8a8_epilogue.cuh, staged in the stages' shared memory once every
//   product is done, so that they leave in row order, 16 bytes a store
//   where the output rows are 16-byte multiples; masked to M and N. With a
//   split: four columns a thread, the sums of every block's partial, then
//   the same epilogue, 4-wide stores where N % 4 == 0.
// - Programmatic dependent launch (where the wrapper asks for it: K under
//   4,096 bytes, ops/w8a8.py::_pdl): the blocks may start while
//   the previous kernel in the stream (quantize_rows, which lets its
//   dependents start at once) still runs; they set up their barriers and
//   prefetch the tensor maps, then wait for it (griddepcontrol.wait)
//   before any read of device memory. A block lets the next kernel start
//   once its main loop is done.
// - Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
//   found through tma.cuh's lookup: no -lcuda) and passed by value inside
//   a __grid_constant__ parameter, so a launch captured in a CUDA graph
//   carries its own maps.
// - Exact s32 sums: |acc| <= K * 127^2 < 2^31 for K < 133,000.
// - The s32 kind (out_kind 2, a row-parallel shard's partial) stores the
//   sums themselves (staged as 4-byte words like f32; summed over the split
//   as every kind is); no scale is read.
// Nothing here allocates or synchronises: the wrapper allocates the
// outputs and chooses the plan. The entry point returns the encode's or
// the launch's error.

#include <cuda.h>
#include <cuda_runtime.h>

#include "ptx.cuh"
#include "tma.cuh"
#include "w8a8_epilogue.cuh"

namespace {

namespace ptx = ragtorch::ptx;
using ragtorch::w8a8::OutSide;
using ragtorch::w8a8::bias_at;
using ragtorch::w8a8::epi_bf16;
using ragtorch::w8a8::epi_f32;
using ragtorch::w8a8::kOutBf16;
using ragtorch::w8a8::kOutF32;
using ragtorch::w8a8::kOutS32;

constexpr int kBK = 128;          // bytes of K a stage (the swizzle span)
constexpr int kMaxMembers = 3;    // weights a launch
constexpr int kMaxSplit = 8;      // blocks of a cluster (the portable limit)
constexpr int kRingBytes = 98304; // the stages of an unsplit block

// A block's shape: kConsumers warpgroups of 64 rows, kBN columns, and
// whether K splits across a cluster.
template <int kConsumers, int kBN, bool kSplit>
struct Tile {
  static constexpr int kBM = 64 * kConsumers;
  static constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
  static constexpr int kTileA = kBM * kBK;
  static constexpr int kStage = kTileA + kBN * kBK;
  // with a split, fewer stages leave room for the tile's partials (two
  // blocks an SM still)
  static constexpr int kStages = kSplit ? 5 : kRingBytes / kStage;
  // the partials a block receives: [split][rows it owns][kBN] s32, rows
  // padded by 16 bytes (a warp's 8-byte stores fall on two wavefronts)
  static constexpr int kRecvPitch = kBN * 4 + 16;
  static constexpr int kRecv = kSplit ? (kBM + kMaxSplit - 1) * kRecvPitch : 0;
  // the stages (an unsplit block stages its outputs there once every
  // product is done), the partials, the tile's row scales, column scales
  // and biases, the barriers, and 1 KB to align the stages
  static constexpr int kSmem =
      1024 + kStages * kStage + kRecv + (kBM + 2 * kBN) * 4 + 2 * kStages * 8;
  static_assert(kConsumers * 64 * (kBN * 4 + 16) <= kStages * kStage,
                "the staged outputs fit the stages");
  static_assert(2 * (kSmem + 1024) <= 233472, "two blocks an SM");
  static_assert(!kSplit || kConsumers == 1, "K splits over 64-row tiles");
};

struct Params {
  CUtensorMap tx;                // xq [M, K]
  CUtensorMap tw[kMaxMembers];   // each weight [N_i, K]
  const float* xs;               // [M] token scales (null for the s32 kind)
  OutSide o[kMaxMembers];
  int tiles[kMaxMembers];        // column tiles of each weight
  int M, nchunks, out_kind, split;
};

template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&acc)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (kN == 128)
    ptx::wgmma_m64n128k32_s8(acc, da, db);
  else
    ptx::wgmma_m64n64k32_s8(acc, da, db);
}

template <int kConsumers, int kBN, bool kSplit>
__global__ void __launch_bounds__(Tile<kConsumers, kBN, kSplit>::kThreads, 2)
w8a8_wgmma_kernel(const __grid_constant__ Params p) {
  using T = Tile<kConsumers, kBN, kSplit>;
  constexpr int kBM = T::kBM, kStages = T::kStages, kStage = T::kStage;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that
  uint8_t* smem = smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* recv = smem + kStages * kStage;
  float* row_s = reinterpret_cast<float*>(recv + T::kRecv);  // [kBM]
  float* col_s = row_s + kBM;                                 // [kBN]
  float* col_b = col_s + kBN;                                 // [kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(col_b + kBN);
  uint64_t* empty = full + kStages;

  // this block's weight, column tile, row tile and K chunks [c0, c0 + nc)
  const int split = kSplit ? p.split : 1;
  const int rank = kSplit ? (int)ptx::cluster_ctarank() : 0;
  if constexpr (kSplit) ptx::cluster_arrive_relaxed();  // this block has started
  int mem = 0, t = (int)blockIdx.x / split;
  while (t >= p.tiles[mem]) t -= p.tiles[mem++];
  const OutSide o = p.o[mem];  // in registers: read once
  const int n0 = t * kBN;
  const int m0 = blockIdx.y * kBM;
  const int c0 = rank * p.nchunks / split;
  const int nc = (rank + 1) * p.nchunks / split - c0;

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const CUtensorMap* tw = &p.tw[mem];
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], kConsumers * 4);
    }
    ptx::fence_barrier_init();
  }
  if (wg == kConsumers && lane == 0) {
    ptx::prefetch_tensormap(&p.tx);
    ptx::prefetch_tensormap(tw);
  }
  // launched under programmatic dependent launch, the block may start
  // while the previous kernel in the stream (quantize_rows) runs: nothing
  // above reads device memory, everything below comes after its end
  ptx::grid_dependency_wait();
  __syncthreads();

  const bool s32 = p.out_kind == kOutS32;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  if (wg == kConsumers) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      for (int c = 0; c < nc; ++c) {
        const int s = c % kStages;
        if (c >= kStages) ptx::mbar_wait(&empty[s], (c / kStages - 1) & 1);
        ptx::mbar_arrive_expect_tx(&full[s], kStage);
        ptx::tma_load_2d(smem + s * kStage, &p.tx, (c0 + c) * kBK, m0, &full[s]);
        ptx::tma_load_2d(smem + s * kStage + T::kTileA, tw, (c0 + c) * kBK, n0, &full[s]);
      }
    }
    ptx::launch_dependents();
    if constexpr (!kSplit) return;
  } else {
    // the epilogue's scales and biases, loaded while the products run
    // (read back from shared memory after the products' barrier)
    if (!s32) {
      const int i = threadIdx.x;
      if (i < kBM) row_s[i] = m0 + i < p.M ? p.xs[m0 + i] : 0.0f;
      const int j = i - (kConsumers * 128 - kBN);
      if (j >= 0 && n0 + j < o.N) {
        col_s[j] = o.ws[n0 + j];
        col_b[j] = bias_at(o, p.out_kind, n0 + j);
      }
    }
    for (int c = 0; c < nc; ++c) {
      const int s = c % kStages;
      ptx::mbar_wait(&full[s], (c / kStages) & 1);
      const uint64_t da = ptx::wgmma_desc_sw128(smem + s * kStage + wg * 64 * kBK);
      const uint64_t db = ptx::wgmma_desc_sw128(smem + s * kStage + T::kTileA);
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes of K a step: +2 in 16 B
        wgmma_s8<kBN>(acc, da + 2 * kk, db + 2 * kk);
      ptx::wgmma_commit();
      // chunk c's products stay in flight; chunk c - 1's have completed, so
      // its stage goes back to the producer
      ptx::wgmma_wait<1>();
      if (c > 0 && lane == 0) ptx::mbar_arrive(&empty[(c - 1) % kStages]);
    }
    ptx::wgmma_wait<0>();
    // the next kernel in the stream may start its prologue during this
    // block's epilogue (its blocks then wait for this grid's end)
    ptx::launch_dependents();
  }

  // accumulator layout (each warp 16 rows): acc[4j + 2h + i] is row
  // 16 * warp + lane / 4 + 8h of the warpgroup's 64, column 8j + 2 * (lane
  // % 4) + i
  const int col0 = 2 * (lane % 4);
  const bool has_bias = o.bias != nullptr;
  const bool f32 = p.out_kind == kOutF32;
  if constexpr (!kSplit) {
    // Every load has landed and every warpgroup's products are done with
    // every stage (named barrier 1), so the stages take each warpgroup's
    // 64 x kBN outputs, which then leave in row order (16-byte stores where
    // the rows allow).
    ptx::bar_sync(1, kConsumers * 128);
    const int esz = f32 || s32 ? 4 : 2;
    const int pitch = kBN * esz + 16;  // bytes a staged row, 16-aligned
    uint8_t* tile = smem + wg * 64 * pitch;
    const int r0 = (threadIdx.x % 128) / 32 * 16 + lane / 4;
    const int mw = m0 + wg * 64;  // this warpgroup's first row
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float xs = row_s[wg * 64 + r];
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const int col = col0 + 8 * j;
        // columns past N hold garbage sums of zeros; they are never stored
        const float s0 = col_s[col], s1 = col_s[col + 1];
        const float b0 = col_b[col], b1 = col_b[col + 1];
        const int a0 = acc[4 * j + 2 * h], a1 = acc[4 * j + 2 * h + 1];
        uint8_t* q = tile + r * pitch + col * esz;
        if (s32) {
          *reinterpret_cast<int2*>(q) = make_int2(a0, a1);
        } else if (f32) {
          *reinterpret_cast<float2*>(q) = make_float2(epi_f32(a0, xs, s0, has_bias, b0),
                                                      epi_f32(a1, xs, s1, has_bias, b1));
        } else {
          __nv_bfloat162 v;
          v.x = epi_bf16(a0, xs, s0, has_bias, b0);
          v.y = epi_bf16(a1, xs, s1, has_bias, b1);
          *reinterpret_cast<__nv_bfloat162*>(q) = v;
        }
      }
    }
    ptx::bar_sync(2 + wg, 128);
    const int tid = threadIdx.x % 128;
    uint8_t* out = static_cast<uint8_t*>(o.out);
    if ((o.N * esz) % 16 == 0) {  // whole rows of 16-byte chunks
      const int epc = 16 / esz, cpr = kBN / epc;
      for (int ci = tid; ci < 64 * cpr; ci += 128) {
        const int r = ci / cpr, n = n0 + (ci % cpr) * epc;
        if (mw + r < p.M && n < o.N)
          *reinterpret_cast<uint4*>(out + ((size_t)(mw + r) * o.N + n) * esz) =
              *reinterpret_cast<const uint4*>(tile + r * pitch + (ci % cpr) * 16);
      }
    } else {
      for (int ei = tid; ei < 64 * kBN; ei += 128) {
        const int r = ei / kBN, col = ei % kBN;
        if (mw + r >= p.M || n0 + col >= o.N) continue;
        const size_t off = ((size_t)(mw + r) * o.N + n0 + col) * esz;
        if (esz == 4)
          *reinterpret_cast<uint32_t*>(out + off) =
              *reinterpret_cast<const uint32_t*>(tile + r * pitch + col * 4);
        else
          *reinterpret_cast<__nv_bfloat16*>(out + off) =
              *reinterpret_cast<const __nv_bfloat16*>(tile + r * pitch + col * 2);
      }
    }
  } else {
    // The tile's live rows split evenly across the cluster: block q owns
    // rows [q * sl, (q + 1) * sl). Each consumer thread stores its partial
    // sums of row r into the owner's partials, in the slot of this block.
    const int live = min(kBM, p.M - m0);
    const int sl = (live + split - 1) / split;
    ptx::cluster_wait();  // every block of the cluster has started
    if (wg < kConsumers) {
      const int r0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
      const uint32_t base = ptx::smem_addr(recv);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r0 + 8 * h;
        if (r >= live) continue;
        const int q = r / sl;
        const uint32_t dst = ptx::mapa(
            base + (rank * sl + r - q * sl) * T::kRecvPitch + col0 * 4, q);
#pragma unroll
        for (int j = 0; j < kBN / 8; ++j)
          ptx::st_cluster_v2(dst + 32 * j, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
    ptx::cluster_arrive();  // this block's partials are stored
    ptx::cluster_wait();    // every partial of this block's rows has landed
    const int rb = rank * sl;
    const int rows = max(0, min(live, rb + sl) - rb);
    constexpr int kQuads = kBN / 4;
    const bool vec = o.N % 4 == 0;
    for (int e = threadIdx.x; e < rows * kQuads; e += T::kThreads) {
      const int lr = e / kQuads, c = (e - lr * kQuads) * 4;
      if (n0 + c >= o.N) continue;
      int sum[4] = {0, 0, 0, 0};
      for (int s = 0; s < split; ++s) {
        const int4 v =
            *reinterpret_cast<const int4*>(recv + (s * sl + lr) * T::kRecvPitch + c * 4);
        sum[0] += v.x, sum[1] += v.y, sum[2] += v.z, sum[3] += v.w;
      }
      const size_t off = (size_t)(m0 + rb + lr) * o.N + n0 + c;
      const int ncols = min(4, o.N - n0 - c);
      if (s32) {
        int* out = static_cast<int*>(o.out) + off;
        if (vec)
          *reinterpret_cast<int4*>(out) = make_int4(sum[0], sum[1], sum[2], sum[3]);
        else
          for (int i = 0; i < ncols; ++i) out[i] = sum[i];
        continue;
      }
      const float xs = row_s[rb + lr];
      if (f32) {
        float y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          y[i] = epi_f32(sum[i], xs, col_s[c + i], has_bias, col_b[c + i]);
        float* out = static_cast<float*>(o.out) + off;
        if (vec)
          *reinterpret_cast<float4*>(out) = make_float4(y[0], y[1], y[2], y[3]);
        else
          for (int i = 0; i < ncols; ++i) out[i] = y[i];
      } else {
        __nv_bfloat16 y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          y[i] = epi_bf16(sum[i], xs, col_s[c + i], has_bias, col_b[c + i]);
        __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o.out) + off;
        if (vec) {
          __nv_bfloat162 lo, hi;
          lo.x = y[0], lo.y = y[1], hi.x = y[2], hi.y = y[3];
          uint2 w;
          w.x = *reinterpret_cast<const uint32_t*>(&lo);
          w.y = *reinterpret_cast<const uint32_t*>(&hi);
          *reinterpret_cast<uint2*>(out) = w;
        } else {
          for (int i = 0; i < ncols; ++i) out[i] = y[i];
        }
      }
    }
  }
}

// a [rows, K] int8 matrix (K contiguous) in tiles of box_rows x kBK bytes,
// 128-byte swizzle, zeros past the edges
bool encode(CUtensorMap* map, const void* base, int rows, int K, int box_rows) {
  const ragtorch::EncodeTiled fn = ragtorch::encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kConsumers, int kBN, bool kSplit>
int launch(const Params& p, dim3 grid, bool pdl, cudaStream_t st) {
  using T = Tile<kConsumers, kBN, kSplit>;
  // once a process for each instance: a launch captured in a CUDA graph
  // makes no such call after its warm-up
  static const cudaError_t err =
      cudaFuncSetAttribute(w8a8_wgmma_kernel<kConsumers, kBN, kSplit>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  if (kSplit) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = p.split;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  if (pdl) {  // the blocks may start while the previous kernel finishes
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, w8a8_wgmma_kernel<kConsumers, kBN, kSplit>, p);
}

}  // namespace

// outs[i] [M, N[i]] (f32: out_kind 0, bf16: 1) = epilogue(xq [M, K] .
// wq[i]^T) for i < nmem (1 to 3 weights sharing xq); biases[i] null or
// [N[i]] of the output type; out_kind 2 (s32): outs[i] [M, N[i]] int32 =
// the exact sums, xs, ws and biases unread (may be null). K must be a
// multiple of 16 and xq, wq[i] 16-byte aligned (TMA's rules for a row
// stride and a base). The plan: bm 64 or 128 rows a tile (one or two
// consumer warpgroups), bn 128 or 64 columns (64 only on 64-row tiles),
// K split over `split` blocks of a cluster (1 to 8, at most K's 128-byte
// chunks; above 1 only on 64 x 64 tiles); pdl 1 launches under
// programmatic dependent launch.
extern "C" int ragtorch_w8a8_gemm_wgmma(const void* xq, const void* xs,
                                        const void* const* wq, const void* const* ws,
                                        const void* const* bias, void* const* out,
                                        const int* N, int nmem, int M, int K,
                                        int out_kind, int bm, int bn, int split,
                                        int pdl, void* stream) {
  const bool s32 = out_kind == kOutS32;
  const int nchunks = (K + kBK - 1) / kBK;
  if (nmem < 1 || nmem > kMaxMembers || M < 1 || K < 16 || K % 16 != 0 ||
      (out_kind != kOutF32 && out_kind != kOutBf16 && !s32) || (!s32 && xs == nullptr) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 || (bm != 64 && bm != 128) ||
      (bn != 64 && bn != 128) || split < 1 || split > kMaxSplit || split > nchunks ||
      (bn == 64 && bm != 64) || (split > 1 && bn != 64))
    return (int)cudaErrorInvalidValue;
  Params p{};
  if (!encode(&p.tx, xq, M, K, bm)) return (int)cudaErrorInvalidValue;
  p.xs = static_cast<const float*>(xs);
  p.M = M, p.nchunks = nchunks, p.out_kind = out_kind, p.split = split;
  int tiles = 0;
  for (int i = 0; i < nmem; ++i) {
    if (N[i] < 1 || reinterpret_cast<uintptr_t>(wq[i]) % 16 != 0 ||
        (!s32 && ws[i] == nullptr) || !encode(&p.tw[i], wq[i], N[i], K, bn))
      return (int)cudaErrorInvalidValue;
    p.o[i] = OutSide{static_cast<const float*>(ws[i]), bias[i], out[i], N[i]};
    p.tiles[i] = (N[i] + bn - 1) / bn;
    tiles += p.tiles[i];
  }
  const dim3 grid(tiles * split, (M + bm - 1) / bm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split > 1) return launch<1, 64, true>(p, grid, pdl, st);
  if (bn == 128)
    return bm == 128 ? launch<2, 128, false>(p, grid, pdl, st)
                     : launch<1, 128, false>(p, grid, pdl, st);
  return launch<1, 64, false>(p, grid, pdl, st);
}
