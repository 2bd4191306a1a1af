// W8A8 GEMM for large row counts on Hopper (sm_90a): wgmma on s8 fed by TMA.
//
// Replaces no Pallas kernel: the reference computes this product in XLA,
// rag_inference_pipeline_tpu/models/layers.py::_qdense (:92-100, and the
// int8 heads of models/qwen.py::_logits, :309-327):
//   acc = xq . q  (s8 x s8 -> s32, exact)
//   y   = (f32(acc) * xs[m]) * s[n]    (w8a8_epilogue.cuh)
// ops/w8a8.py routes a product here when it has more rows than the small
// route's threshold (prefill, the encoders at 8 x 512 tokens, the verify
// round's B x (gamma + 1) rows); xq and xs come from quantize_rows
// (w8a8_quant.cu).
//
// Bound on the H100 (1,979 TOP/s int8, dense; 3.35 TB/s): a prefill gate/up
// (4,096 x 896 -> 4,864) is 35.7 G operations, 18 us; at 72 rows a product
// streams its weight once and is bound by bytes.
//
// Design:
// - Operands: the int8 form of wgmma takes only K-major operands, and the
//   port's layouts are K-major: xq [M, K] and the weight [N, K]
//   (QuantizedLinear.q). A block computes a 128 x 128 output tile: two
//   consumer warpgroups, each m64n128k32 on its 64 rows, plus one producer
//   warp.
// - Loads: the producer's lane 0 issues 2-D TMA tile loads (128 rows x 128
//   bytes of K, 128-byte swizzle) of both operands into a ring of stages,
//   each guarded by a "full" mbarrier (the loads' bytes) and an "empty" one
//   (one arrival per consumer warp once its wgmmas on the stage have
//   completed). TMA fills rows past M or N and bytes past K with zeros, so
//   ragged edges add nothing to the sums. Three stages (97 KB) let two
//   blocks share an SM, one's epilogue overlapping the other's products.
//   (Six stages, one block an SM, and a persistent block an SM with a ring
//   that runs across tiles, both measured slower on an H100: PERF.md.)
// - Products: a stage's four k32 wgmmas stay in flight while the next
//   stage's are issued (wait_group 1), so the tensor cores do not idle
//   between stages.
// - Epilogue: the tile's row scales, column scales and biases are copied
//   to shared memory while the products run (read from device memory
//   between the staging stores, each would wait out its latency alone).
//   Each consumer thread turns its 64 exact sums into outputs with
//   the epilogue of w8a8_epilogue.cuh, staged in the stages'
//   shared memory once every product is done, so that they leave in row
//   order, 16 bytes a store where the output rows are 16-byte multiples;
//   masked to M and N.
// - Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
//   found through tma.cuh's lookup: no -lcuda) and passed by value as
//   __grid_constant__ parameters, so a launch captured in a CUDA graph
//   carries its own maps.
// - Exact s32 sums: |acc| <= K * 127^2 < 2^31 for K < 133,000.
// - The s32 kind (out_kind 2, a row-parallel shard's partial) stores the
//   sums themselves, staged as 4-byte words like f32; no scale is read.
// Nothing here allocates or synchronises: the wrapper allocates the
// output. The entry point returns the encode's or the launch's error.

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

constexpr int kBM = 128;             // output rows (tokens) a block
constexpr int kBN = 128;             // output columns (weight rows) a block
constexpr int kBK = 128;             // bytes of K a stage (the swizzle span)
constexpr int kConsumers = 2;        // warpgroups, 64 rows each
constexpr int kConsumerWarps = kConsumers * 4;
constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
constexpr int kTileA = kBM * kBK;
constexpr int kTileB = kBN * kBK;
constexpr int kStage = kTileA + kTileB;
constexpr int kStages = 3;
// the stages (the staged outputs reuse them once every product is done: 3
// stages hold an f32 tile), the tile's row scales, column scales and
// biases, the barriers, and 1 KB to align the stages
constexpr int kSmem = 1024 + kStages * kStage + 3 * 128 * 4 + 2 * kStages * 8;

struct Epi {
  const float* xs;  // [M] token scales (null for the s32 kind)
  OutSide o;
  int M, out_kind;
};

__global__ void __launch_bounds__(kThreads, 2)
w8a8_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                  const __grid_constant__ CUtensorMap tw, const __grid_constant__ Epi e,
                  int nchunks) {
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that
  uint8_t* smem = smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  float* row_s = reinterpret_cast<float*>(smem + kStages * kStage);  // [128]
  float* col_s = row_s + kBM;                                         // [128]
  float* col_b = col_s + kBN;                                         // [128]
  uint64_t* full = reinterpret_cast<uint64_t*>(col_b + kBN);
  uint64_t* empty = full + kStages;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], kConsumerWarps);
    }
    ptx::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warp: one lane issues every load
    if (threadIdx.x % 32 == 0) {
      for (int c = 0; c < nchunks; ++c) {
        const int s = c % kStages;
        if (c >= kStages) ptx::mbar_wait(&empty[s], (c / kStages - 1) & 1);
        ptx::mbar_arrive_expect_tx(&full[s], kStage);
        ptx::tma_load_2d(smem + s * kStage, &tx, c * kBK, m0, &full[s]);
        ptx::tma_load_2d(smem + s * kStage + kTileA, &tw, c * kBK, n0, &full[s]);
      }
    }
    return;
  }

  // the epilogue's scales and biases, loaded while the products run (read
  // back from shared memory after barrier 1)
  const bool f32 = e.out_kind == ragtorch::w8a8::kOutF32;
  const bool s32 = e.out_kind == ragtorch::w8a8::kOutS32;
  if (!s32) {
    const int i = threadIdx.x % 128;
    if (threadIdx.x < 128) {
      row_s[i] = m0 + i < e.M ? e.xs[m0 + i] : 0.0f;
    } else if (n0 + i < e.o.N) {
      col_s[i] = e.o.ws[n0 + i];
      col_b[i] = bias_at(e.o, e.out_kind, n0 + i);
    }
  }
  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  const int lane = threadIdx.x % 32;
  for (int c = 0; c < nchunks; ++c) {
    const int s = c % kStages;
    ptx::mbar_wait(&full[s], (c / kStages) & 1);
    const uint64_t da = ptx::wgmma_desc_sw128(smem + s * kStage + wg * 64 * kBK);
    const uint64_t db = ptx::wgmma_desc_sw128(smem + s * kStage + kTileA);
    ptx::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes of K a step: +2 in 16 B
      ptx::wgmma_m64n128k32_s8(acc, da + 2 * kk, db + 2 * kk);
    ptx::wgmma_commit();
    // chunk c's products stay in flight; chunk c - 1's have completed, so
    // its stage goes back to the producer
    ptx::wgmma_wait<1>();
    if (c > 0 && lane == 0) ptx::mbar_arrive(&empty[(c - 1) % kStages]);
  }
  ptx::wgmma_wait<0>();

  // Epilogue through shared memory: every load has landed and both
  // warpgroups' products are done with every stage (named barrier 1), so
  // the stages take each warpgroup's 64 x 128 outputs, which then leave in
  // row order (16-byte stores where the rows allow).
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 128) : "memory");
  const bool has_bias = e.o.bias != nullptr;
  const int esz = f32 || s32 ? 4 : 2;
  const int pitch = kBN * esz + 16;  // bytes a staged row, 16-aligned
  uint8_t* tile = smem + wg * 64 * pitch;
  // accumulator layout (each warp 16 rows): acc[4j + 2h + i] is row
  // 16 * warp + lane / 4 + 8h, column 8j + 2 * (lane % 4) + i
  const int r0 = (threadIdx.x % 128) / 32 * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
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
      uint8_t* p = tile + r * pitch + col * esz;
      if (s32) {
        *reinterpret_cast<int2*>(p) = make_int2(a0, a1);
      } else if (f32) {
        *reinterpret_cast<float2*>(p) = make_float2(epi_f32(a0, xs, s0, has_bias, b0),
                                                    epi_f32(a1, xs, s1, has_bias, b1));
      } else {
        __nv_bfloat162 v;
        v.x = epi_bf16(a0, xs, s0, has_bias, b0);
        v.y = epi_bf16(a1, xs, s1, has_bias, b1);
        *reinterpret_cast<__nv_bfloat162*>(p) = v;
      }
    }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
  const int t = threadIdx.x % 128;
  uint8_t* out = static_cast<uint8_t*>(e.o.out);
  if ((e.o.N * esz) % 16 == 0) {  // whole rows of 16-byte chunks
    const int epc = 16 / esz, cpr = kBN / epc;
    for (int ci = t; ci < 64 * cpr; ci += 128) {
      const int r = ci / cpr, n = n0 + (ci % cpr) * epc;
      if (mw + r < e.M && n < e.o.N)
        *reinterpret_cast<uint4*>(out + ((size_t)(mw + r) * e.o.N + n) * esz) =
            *reinterpret_cast<const uint4*>(tile + r * pitch + (ci % cpr) * 16);
    }
  } else {
    for (int ei = t; ei < 64 * kBN; ei += 128) {
      const int r = ei / kBN, col = ei % kBN;
      if (mw + r >= e.M || n0 + col >= e.o.N) continue;
      const size_t o = ((size_t)(mw + r) * e.o.N + n0 + col) * esz;
      if (esz == 4)
        *reinterpret_cast<uint32_t*>(out + o) =
            *reinterpret_cast<const uint32_t*>(tile + r * pitch + col * 4);
      else
        *reinterpret_cast<__nv_bfloat16*>(out + o) =
            *reinterpret_cast<const __nv_bfloat16*>(tile + r * pitch + col * 2);
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

}  // namespace

// out [M, N] (f32: out_kind 0, bf16: 1) = epilogue(xq [M, K] . wq [N, K]^T);
// bias null or [N] of the output type; out_kind 2 (s32): out [M, N] int32 =
// the exact sums, xs, ws and bias unread (may be null). K must be a
// multiple of 16 and xq, wq 16-byte aligned (TMA's rules for a row stride
// and a base).
extern "C" int ragtorch_w8a8_gemm_wgmma(const void* xq, const void* xs,
                                        const void* wq, const void* ws,
                                        const void* bias, void* out, int M,
                                        int N, int K, int out_kind,
                                        void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 != 0 ||
      (out_kind != ragtorch::w8a8::kOutF32 && out_kind != ragtorch::w8a8::kOutBf16 &&
       out_kind != ragtorch::w8a8::kOutS32) ||
      (out_kind != ragtorch::w8a8::kOutS32 && (xs == nullptr || ws == nullptr)) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  if (!encode(&tx, xq, M, K, kBM) || !encode(&tw, wq, N, K, kBN))
    return (int)cudaErrorInvalidValue;
  // once a process: a launch captured in a CUDA graph makes no such call
  // after its warm-up
  static const cudaError_t err = cudaFuncSetAttribute(
      w8a8_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const Epi e{static_cast<const float*>(xs),
              OutSide{static_cast<const float*>(ws), bias, out, N}, M, out_kind};
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  w8a8_wgmma_kernel<<<grid, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tx, tw, e, (K + kBK - 1) / kBK);
  return (int)cudaGetLastError();
}
