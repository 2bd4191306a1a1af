// Dynamic per-row int8 quantization of activations for Hopper (sm_90a): the
// activation side of the large-row W8A8 product (w8a8_wgmma.cu), and the
// whole row of a row-parallel product. Small row counts quantize inside
// their GEMM (w8a8_gemm.cu) and never come here.
//
// Replaces no Pallas kernel: the reference computes it in XLA,
// rag_inference_pipeline_tpu/models/layers.py::quantize_act_rows (:80-89).
// For every row of x ([M, K], bf16 or f32, read as f32):
//   s = max(max_k |x|, 1e-8) / 127          (an IEEE f32 division)
//   q = clip(rint(x / s), -127, 127)        (rint: half to even)
// and it writes q [M, K] int8 and s [M] f32.
//
// Bound on the H100: bytes, the row read once and written once as int8
// (4,096 x 896 bf16: 11 MB, 3.3 us at 3.35 TB/s; Llama-3.1-8B's down,
// 4,096 x 14,336: 176 MB, 52.6 us). Every kernel reads 16-byte pieces, and
// the two vector kernels keep a row in registers between the abs-max and
// the quantize, so it is read once. The launch plan (the kernel, warps a
// row or a block, blocks a row) is host arithmetic,
// ops/w8a8.py::_quant_plan, passed to the entry point, which refuses a
// plan its kernel cannot run:
//
// - path 1, quantize_rows_vec: a row of at most 8 warps x 32 lanes x 4
//   pieces (8,192 bf16, 4,096 f32) over 1, 2, 4 or 8 warps of an 8-warp
//   block; the row's warps meet in shared memory.
// - path 2, quantize_rows_long<resident>: a longer row over a thread block
//   cluster of `cluster` blocks (1 to 8), each of `warps` warps (1 to 32)
//   holding its slice of the row in registers, at most 4 pieces a lane: a
//   cluster holds 8 x 1,024 x 4 pieces (262,144 bf16, 131,072 f32). The
//   block's warps meet in shared memory, the cluster's blocks in
//   distributed shared memory: each block stores its maximum into every
//   block of the cluster, then one cluster barrier. A model's row takes
//   one block (Llama-3.1-8B's down, K 14,336: 14 warps), or two where that
//   evens the SMs' load (288 rows on 132 SMs); more blocks a row gained
//   nothing on few rows on an H100 (PERF.md).
// - path 3, quantize_rows_long<streamed>: a row past what a cluster holds:
//   the same blocks stream their slice in chunks of 4 pieces a lane for
//   the abs-max, then read it a second time (from L2) to quantize.
// - path 0, quantize_rows_scalar: any K and alignment, one warp a row, the
//   row read twice with 2- or 4-byte loads. Only a K that is not a whole
//   number of 16-byte pieces, or an x off a 16-byte boundary, takes it; no
//   model's product does (every hidden and intermediate width is a
//   multiple of 8, and the wrappers hand over fresh contiguous rows).
//
// Max is exact in any order, so the blocks and warps may meet in any order.
// The scale is an IEEE division and x / s rounds as an IEEE division would
// (w8a8_round.cuh); the file is built without -use_fast_math. Launched
// under programmatic dependent launch, as the GEMM after it
// (w8a8_wgmma.cu): the blocks wait for the previous kernel in the stream
// before they read x, then let the GEMM's blocks start their prologue (the
// GEMM waits for this grid's end before it reads q), so neither launch's
// latency adds to the other's. Nothing here allocates or synchronises; the
// entry point returns the launch's error.

#include <cuda_bf16.h>
#include <stdint.h>

#include "ptx.cuh"
#include "w8a8_round.cuh"

namespace {

using ragtorch::w8a8::quantize_exact;
using ragtorch::w8a8::row_scale;
namespace ptx = ragtorch::ptx;

constexpr int kWarps = 8;  // warps a block of the short-row and scalar kernels
constexpr int kThreads = kWarps * 32;
constexpr int kVecs = 4;  // 16-byte pieces a lane holds at most
constexpr int kMaxWarps = 32;  // warps a block of the long-row kernel
constexpr int kMaxCluster = 8;  // blocks a row (the portable cluster size)

enum Path { kScalar = 0, kShort = 1, kLong = 2, kStreamed = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the elements of one 16-byte piece as f32
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[16 / sizeof(T)]) {
  const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) f[i] = to_f32(e[i]);
}

// the larger of `m` and the piece's abs-max
template <typename T>
__device__ __forceinline__ float piece_max(const uint4& v, float m) {
  float f[16 / sizeof(T)];
  unpack<T>(v, f);
#pragma unroll
  for (int i = 0; i < 16 / (int)sizeof(T); ++i) m = fmaxf(m, fabsf(f[i]));
  return m;
}

// piece p of a row quantized into the row's int8 output qr
template <typename T>
__device__ __forceinline__ void store_piece(int8_t* qr, int p, const uint4& v, float scale,
                                            float rcp) {
  constexpr int kE = 16 / sizeof(T);
  float f[kE];
  unpack<T>(v, f);
  uint32_t wd[kE / 4];
#pragma unroll
  for (int i = 0; i < kE / 4; ++i)
    wd[i] = (uint32_t)(uint8_t)quantize_exact(f[4 * i], scale, rcp) |
            (uint32_t)(uint8_t)quantize_exact(f[4 * i + 1], scale, rcp) << 8 |
            (uint32_t)(uint8_t)quantize_exact(f[4 * i + 2], scale, rcp) << 16 |
            (uint32_t)(uint8_t)quantize_exact(f[4 * i + 3], scale, rcp) << 24;
  if constexpr (kE == 8)
    reinterpret_cast<uint2*>(qr)[p] = make_uint2(wd[0], wd[1]);
  else
    reinterpret_cast<uint32_t*>(qr)[p] = wd[0];
}

// kG warps a row (kWarps / kG rows a block), the row in registers: lane l
// of the row's warp w holds pieces (32 w + l) + 32 kG j, j < kVecs.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
quantize_rows_vec(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, int M, int K) {
  ptx::grid_dependency_wait();  // x is the previous kernel's output
  ptx::launch_dependents();     // the GEMM that reads q may start
  constexpr int kE = 16 / sizeof(T);  // elements a piece
  __shared__ float part[kWarps];
  const int w = threadIdx.x / 32 % kG;  // this warp's place in its row
  const int row = blockIdx.x * (kWarps / kG) + threadIdx.x / 32 / kG;
  const int lane = threadIdx.x % 32;
  const bool live = row < M;
  const int pieces = K / kE;
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)(live ? row : 0) * K);
  uint4 v[kVecs];
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int p = 32 * w + lane + 32 * kG * j;
    if (live && p < pieces) {
      v[j] = __ldg(xr + p);
      amax = piece_max<T>(v[j], amax);
    }
  }
  amax = warp_max(amax);
  if constexpr (kG > 1) {  // the row's warps meet in shared memory
    if (lane == 0) part[threadIdx.x / 32] = amax;
    __syncthreads();
    const int first = threadIdx.x / 32 - w;
#pragma unroll
    for (int i = 0; i < kG; ++i) amax = fmaxf(amax, part[first + i]);
  }
  if (!live) return;
  const float scale = row_scale(amax), rcp = __frcp_rn(scale);
  if (w == 0 && lane == 0) s[row] = scale;
  int8_t* qr = q + (size_t)row * K;
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const int p = 32 * w + lane + 32 * kG * j;
    if (p < pieces) store_piece<T>(qr, p, v[j], scale, rcp);
  }
}

// One row over a cluster of `cluster` blocks (blockIdx.x / cluster is the
// row; a launch without a cluster attribute when it is 1). Block r of the
// cluster takes pieces [r per, min((r + 1) per, pieces)) of the row, per
// = ceil(pieces / cluster); thread t of its T holds pieces p0 + t + T j,
// j < kVecs (kResident: the plan gives T kVecs >= per), or streams them
// kVecs at a time over the slice and reads them again to quantize.
template <typename T, bool kResident>
__global__ void __launch_bounds__(kMaxWarps * 32)
quantize_rows_long(const T* __restrict__ x, int8_t* __restrict__ q,
                   float* __restrict__ s, int K, int cluster) {
  ptx::grid_dependency_wait();  // x is the previous kernel's output
  ptx::launch_dependents();     // the GEMM that reads q may start
  constexpr int kE = 16 / sizeof(T);
  __shared__ float part[kMaxWarps];   // the block's warps' maxima
  __shared__ float peer[kMaxCluster];  // the cluster's blocks' maxima
  const int rank = cluster > 1 ? (int)ptx::cluster_ctarank() : 0;
  if (cluster > 1) ptx::cluster_arrive_relaxed();  // this block has started
  const int nt = blockDim.x, t = threadIdx.x, lane = t % 32;
  const int row = blockIdx.x / cluster;
  const int pieces = K / kE, per = (pieces + cluster - 1) / cluster;
  const int p0 = rank * per, p1 = min(pieces, p0 + per);
  const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * K);
  int8_t* qr = q + (size_t)row * K;
  uint4 v[kVecs];
  float amax = 0.0f;
  for (int base = p0 + t; base < p1; base += nt * kVecs) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j)  // the chunk's loads in flight together
      if (base + nt * j < p1) v[j] = __ldg(xr + base + nt * j);
#pragma unroll
    for (int j = 0; j < kVecs; ++j)
      if (base + nt * j < p1) amax = piece_max<T>(v[j], amax);
    if constexpr (kResident) break;  // one chunk holds the slice
  }
  amax = warp_max(amax);
  if (lane == 0) part[t / 32] = amax;
  __syncthreads();
  amax = warp_max(lane < nt / 32 ? part[lane] : 0.0f);
  if (cluster > 1) {  // the row's blocks meet in distributed shared memory
    ptx::cluster_wait();  // every block of the cluster has started
    if (t < cluster) ptx::st_cluster_f32(ptx::mapa(ptx::smem_addr(&peer[rank]), t), amax);
    ptx::cluster_arrive();  // this block's maximum is stored
    ptx::cluster_wait();    // every block's maximum has landed here
    for (int i = 0; i < cluster; ++i) amax = fmaxf(amax, peer[i]);
  }
  const float scale = row_scale(amax), rcp = __frcp_rn(scale);
  if (rank == 0 && t == 0) s[row] = scale;
  if constexpr (kResident) {
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int p = p0 + t + nt * j;
      if (p < p1) store_piece<T>(qr, p, v[j], scale, rcp);
    }
  } else {
    for (int base = p0 + t; base < p1; base += nt * kVecs) {
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        if (base + nt * j < p1) v[j] = __ldg(xr + base + nt * j);
#pragma unroll
      for (int j = 0; j < kVecs; ++j)
        if (base + nt * j < p1) store_piece<T>(qr, base + nt * j, v[j], scale, rcp);
    }
  }
}

// Any K and alignment: one warp a row, the row read twice (max, quantize).
template <typename T>
__global__ void __launch_bounds__(kThreads)
quantize_rows_scalar(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ s, int M, int K) {
  ptx::grid_dependency_wait();  // x is the previous kernel's output
  ptx::launch_dependents();     // the GEMM that reads q may start
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.0f;
  for (int i = lane; i < K; i += 32) amax = fmaxf(amax, fabsf(to_f32(xr[i])));
  amax = warp_max(amax);
  const float scale = row_scale(amax), rcp = __frcp_rn(scale);
  if (lane == 0) s[row] = scale;
  int8_t* qr = q + (size_t)row * K;
  for (int i = lane; i < K; i += 32) qr[i] = quantize_exact(to_f32(xr[i]), scale, rcp);
}

// a launch under programmatic dependent launch (its blocks may start while
// the previous kernel in the stream finishes; they wait for it before any
// read), in clusters of `cluster` blocks when that is over 1
template <typename... KArgs, typename... Args>
int launch_pdl(void (*kernel)(KArgs...), unsigned grid, unsigned block, int cluster,
               cudaStream_t st, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(block);
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  int n = 1;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = (unsigned)cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n].val.clusterDim.z = 1;
    ++n;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T>
int launch(const void* x, void* q, void* s, int M, int K, int path, int warps,
           int cluster, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  int8_t* qt = static_cast<int8_t*>(q);
  float* sf = static_cast<float*>(s);
  constexpr int kE = 16 / sizeof(T);
  const bool vec = K % kE == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const long pieces = K / kE;
  if (path == kScalar)
    return launch_pdl(quantize_rows_scalar<T>, (unsigned)((M + kWarps - 1) / kWarps),
                      kThreads, 1, st, xt, qt, sf, M, K);
  if (path == kShort) {
    if (!vec || (warps != 1 && warps != 2 && warps != 4 && warps != kWarps) ||
        pieces > 32L * kVecs * warps)
      return (int)cudaErrorInvalidValue;
    const unsigned grid = (unsigned)((M + kWarps / warps - 1) / (kWarps / warps));
    switch (warps) {
      case 1:
        return launch_pdl(quantize_rows_vec<T, 1>, grid, kThreads, 1, st, xt, qt, sf, M, K);
      case 2:
        return launch_pdl(quantize_rows_vec<T, 2>, grid, kThreads, 1, st, xt, qt, sf, M, K);
      case 4:
        return launch_pdl(quantize_rows_vec<T, 4>, grid, kThreads, 1, st, xt, qt, sf, M, K);
      default:
        return launch_pdl(quantize_rows_vec<T, kWarps>, grid, kThreads, 1, st, xt, qt, sf,
                          M, K);
    }
  }
  const long per = (pieces + cluster - 1) / cluster;
  if ((path != kLong && path != kStreamed) || !vec || warps < 1 || warps > kMaxWarps ||
      cluster < 1 || cluster > kMaxCluster || (long)M * cluster > 0x7fffffffL ||
      (path == kLong && per > 32L * kVecs * warps))
    return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)(M * cluster), block = (unsigned)(32 * warps);
  return path == kLong
             ? launch_pdl(quantize_rows_long<T, true>, grid, block, cluster, st, xt, qt, sf,
                          K, cluster)
             : launch_pdl(quantize_rows_long<T, false>, grid, block, cluster, st, xt, qt, sf,
                          K, cluster);
}

}  // namespace

// x [M, K] contiguous, bf16 (in_kind 1) or f32 (in_kind 0); q [M, K] int8;
// s [M] f32; the plan of ops/w8a8.py::_quant_plan: path 0 (scalar: warps
// and cluster unread), 1 (`warps` of 1, 2, 4, 8 a row), 2 or 3 (`warps`
// of 1 to 32 a block, `cluster` of 1 to 8 blocks a row; 2 only where
// they hold the row at 4 pieces a lane). Anything else is refused with
// cudaErrorInvalidValue before a launch.
extern "C" int ragtorch_w8a8_quantize_rows(const void* x, void* q, void* s, int M, int K,
                                           int in_kind, int path, int warps, int cluster,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || K < 1 || (in_kind != 0 && in_kind != 1)) return (int)cudaErrorInvalidValue;
  return in_kind == 1 ? launch<__nv_bfloat16>(x, q, s, M, K, path, warps, cluster, st)
                      : launch<float>(x, q, s, M, K, path, warps, cluster, st);
}
