// W8A8 GEMM with the dequant epilogue fused, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the reference computes this product in XLA,
// rag_inference_pipeline_tpu/models/layers.py::_qdense (:92-100, and the
// int8 heads of models/qwen.py::_logits, :309-327):
//   acc = xq . q  (s8 x s8 -> s32, exact)
//   y   = (f32(acc) * xs[m]) * s[n]    two f32 multiplies, in that order
// rounded to the output type (bf16 for a bf16 `dense`, f32 for an f32
// `dense` and for the head), then plus the bias in the output type. The
// port stores every weight with its K axis contiguous ([N, K]: the
// reference's [in, out] QuantizedLinear transposed once at load, and the
// tied [V, H] embedding as it is), because mma.sync's s8 B operand wants K
// contiguous and ldmatrix .trans does not transpose 8-bit elements.
//
// Bound on the H100 (3.35 TB/s; 1,979 TOP/s int8, dense): a decode step
// (M = B <= 8) streams each weight once, N x K bytes (0.80 MB for q/o of
// Qwen2.5-0.5B, 4.36 MB for gate, up and down, 136 MB for the tied head:
// 0.24, 1.30 and ~42 us); prefill and the encoders (M = 4,096) are bound by
// operations (35.7 G for a prefill gate/up: 18 us).
//
// Design (a simple correct kernel first):
// - Operands: the weight rows are mma's A (16 output columns an m16 tile),
//   the tokens its B (8 tokens an n8 tile, K contiguous: col-major), so a
//   decode batch of 8 fills one n-tile and no tensor-core row is wasted.
//   m16n8k32 s8 mma.sync with an exact s32 sum (|acc| <= K * 127^2 < 2^31
//   for K < 133,000). A block takes kRows = 64 weight rows (4 warps, one
//   m16 tile each) by up to 64 tokens (1, 2, 4 or 8 n-tiles).
// - Loads: both operands go through a kStages-deep ring of 16-byte
//   cp.async.cg copies, 128 bytes of K a stage (4-byte copies where K is
//   not a multiple of 16 or a base is unaligned), padded to 144-byte shared
//   rows so ldmatrix's eight rows fall in distinct banks. Bytes past K are
//   zero-filled in both operands; rows past N and tokens past M are not
//   copied, and their sums are never stored.
// - Split K: a decode GEMM has few output tiles (14 blocks for q at
//   N = 896), too few to keep the memory system busy. The launcher splits
//   K into chunk ranges until the grid holds about two blocks an SM; each
//   split writes its exact s32 partial sums to scratch, and a second small
//   kernel adds them (int adds: any order is exact) and runs the epilogue.
//   With one split the GEMM kernel runs the epilogue itself. (Reducing the
//   splits of a tile in a thread block cluster through distributed shared
//   memory, one launch and no scratch, made the decode step graph slower
//   on an H100: PERF.md §6.)
// - Epilogue: __int2float_rn, then __fmul_rn twice in the reference's
//   order (no contraction into an FMA), __float2bfloat16_rn for bf16, the
//   bias added as f32 (__fadd_rn) and rounded again, as PyTorch adds two
//   bf16 tensors. Never built with -use_fast_math.
// Nothing here allocates or synchronises: the wrapper (ops/w8a8.py)
// allocates the output and the split scratch. The entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>

#include "ptx.cuh"

namespace {

namespace ptx = ragtorch::ptx;

constexpr int kRows = 64;                  // weight rows (output columns) a block
constexpr int kWarps = kRows / 16;         // one m16 tile a warp
constexpr int kThreads = kWarps * 32;
constexpr int kMaxNT = 8;                  // n8 token tiles a block at most
constexpr int kChunk = 128;                // bytes of K a ring stage
constexpr int kRowBytes = kChunk + 16;     // 144: padded shared row
constexpr int kStages = 4;
constexpr int kEpiThreads = 256;

enum OutKind { kOutF32 = 0, kOutBf16 = 1 };

struct GemmArgs {
  const uint8_t* xq;   // [M, K] int8 tokens
  const float* xs;     // [M] token scales
  const uint8_t* wq;   // [N, K] int8 weights
  const float* ws;     // [N] column scales
  const void* bias;    // [N] of the output type, or null
  void* out;           // [M, N] f32 or bf16
  int* part;           // [splits, M, N] s32 partial sums (splits > 1)
  int M, N, K, splits, chunks_per_split, out_kind;
};

// One output element from its exact sum.
__device__ __forceinline__ void store_out(const GemmArgs& a, int m, int n,
                                          int acc) {
  const float y =
      __fmul_rn(__fmul_rn(__int2float_rn(acc), a.xs[m]), a.ws[n]);
  const size_t o = (size_t)m * a.N + n;
  if (a.out_kind == kOutF32) {
    float v = y;
    if (a.bias != nullptr)
      v = __fadd_rn(v, static_cast<const float*>(a.bias)[n]);
    static_cast<float*>(a.out)[o] = v;
  } else {
    __nv_bfloat16 v = __float2bfloat16_rn(y);
    if (a.bias != nullptr)
      v = __float2bfloat16_rn(__fadd_rn(
          __bfloat162float(v),
          __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[n])));
    static_cast<__nv_bfloat16*>(a.out)[o] = v;
  }
}

// Copies bytes [ch * 128, ch * 128 + 128) of the block's `nrows` weight
// rows and `ntok` token rows into one ring stage: weights at rows
// [0, kRows), tokens after them.
template <int kBytes, int kT>
__device__ __forceinline__ void load_chunk(uint8_t* stage, const uint8_t* w,
                                           int nrows, const uint8_t* x,
                                           int ntok, int K, int ch) {
  constexpr int kPieces = kChunk / kBytes;
  const int b0 = ch * kChunk;
  for (int i = threadIdx.x; i < (kRows + kT) * kPieces; i += kThreads) {
    const int r = i / kPieces;
    const int p = i % kPieces;
    const bool is_x = r >= kRows;
    if (is_x ? r - kRows >= ntok : r >= nrows) continue;
    const uint8_t* src =
        is_x ? x + (size_t)(r - kRows) * K : w + (size_t)r * K;
    const int e = b0 + p * kBytes;
    const bool in_k = e < K;
    ptx::cp_async<kBytes>(ptx::smem_addr(stage + r * kRowBytes + p * kBytes),
                          in_k ? src + e : src, in_k ? kBytes : 0);
  }
}

// Block (x: 64 weight rows, y: kNT * 8 tokens, z: a split of K's chunks).
template <int kBytes, int kNT>
__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(const GemmArgs a) {
  constexpr int kT = kNT * 8;
  constexpr int kStageBytes = (kRows + kT) * kRowBytes;
  extern __shared__ __align__(16) uint8_t smem[];

  const int n0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.N - n0);
  const int m0 = blockIdx.y * kT;
  const int ntok = min(kT, a.M - m0);
  const int nchunks = (a.K + kChunk - 1) / kChunk;
  const int c_begin = blockIdx.z * a.chunks_per_split;
  const int n_iter = max(0, min(nchunks, c_begin + a.chunks_per_split) - c_begin);
  const uint8_t* w = a.wq + (size_t)n0 * a.K;
  const uint8_t* x = a.xq + (size_t)m0 * a.K;

  // one commit group a chunk (empty past the last) keeps the count uniform
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < n_iter)
      load_chunk<kBytes, kT>(smem + j * kStageBytes, w, nrows, x, ntok, a.K,
                             c_begin + j);
    ptx::cp_async_commit();
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0;

  // ldmatrix row addresses (as in binmax_mma.cuh): A rows warp*16 +
  // lane%16, 16-byte piece lane/16 of the 32-byte k-step; B (token) rows
  // n*8 + lane%8, piece (lane/8)%2, the second n-tile of an x4 load for
  // lanes 16-31.
  const int a_row = warp * 16 + (lane % 16);
  const int a_piece = lane / 16;
  const int b_row = lane % 8;
  const int b_piece = (lane / 8) % 2;
  const int b_ntile = lane / 16;

  for (int it = 0; it < n_iter; ++it) {
    ptx::cp_async_wait<kStages - 2>();  // this thread's copies of chunk it
    __syncthreads();  // everyone's landed; stage (it-1) % kStages is free
    if (it + kStages - 1 < n_iter)
      load_chunk<kBytes, kT>(smem + ((it + kStages - 1) % kStages) * kStageBytes,
                             w, nrows, x, ntok, a.K, c_begin + it + kStages - 1);
    ptx::cp_async_commit();

    const uint8_t* stage = smem + (it % kStages) * kStageBytes;
    const uint32_t a_base =
        ptx::smem_addr(stage + a_row * kRowBytes + a_piece * 16);
    const uint32_t b_base =
        ptx::smem_addr(stage + (kRows + b_row) * kRowBytes + b_piece * 16);
    const int ksteps =
        min(kChunk, a.K - (c_begin + it) * kChunk + 31) / 32;
#pragma unroll
    for (int ks = 0; ks < kChunk / 32; ++ks) {
      if (ks >= ksteps) break;
      uint32_t af[4];
      ptx::ldmatrix_x4(af, a_base + ks * 32);
#pragma unroll
      for (int n = 0; n < kNT; n += 2) {
        if (n + 1 < kNT) {
          uint32_t b[4];
          ptx::ldmatrix_x4(b, b_base + (n + b_ntile) * 8 * kRowBytes + ks * 32);
          ptx::mma_s8(acc[n], af, b[0], b[1]);
          ptx::mma_s8(acc[n + 1], af, b[2], b[3]);
        } else {
          uint32_t b[2];
          ptx::ldmatrix_x2(b, b_base + n * 8 * kRowBytes + ks * 32);
          ptx::mma_s8(acc[n], af, b[0], b[1]);
        }
      }
    }
  }
  ptx::cp_async_wait<0>();  // no copy outlives the block

  // C fragment: acc[n][i] is weight row warp*16 + lane/4 (+8 for i >= 2),
  // token n*8 + (lane%4)*2 (+1 for odd i)
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = n0 + warp * 16 + lane / 4 + (i >= 2 ? 8 : 0);
      const int m = m0 + n * 8 + (lane % 4) * 2 + (i & 1);
      if (col >= a.N || m >= a.M) continue;
      if (a.splits == 1)
        store_out(a, m, col, acc[n][i]);
      else
        a.part[((size_t)blockIdx.z * a.M + m) * a.N + col] = acc[n][i];
    }
}

// The splits' partial sums added (exact in any order), then the epilogue.
__global__ void __launch_bounds__(kEpiThreads)
w8a8_splitk_epilogue_kernel(const GemmArgs a) {
  const long long i = (long long)blockIdx.x * kEpiThreads + threadIdx.x;
  const long long mn = (long long)a.M * a.N;
  if (i >= mn) return;
  int acc = 0;
  for (int s = 0; s < a.splits; ++s) acc += a.part[s * mn + i];
  store_out(a, (int)(i / a.N), (int)(i % a.N), acc);
}

// n-tiles a block: the fewest of 1, 2, 4, 8 that cover M (8 for M > 32)
inline int n_tiles(int M) {
  const int need = (M + 7) / 8;
  return need <= 1 ? 1 : need <= 2 ? 2 : need <= 4 ? 4 : kMaxNT;
}

template <int kBytes, int kNT>
int launch_tile(const GemmArgs& a, cudaStream_t st) {
  auto kernel = w8a8_gemm_kernel<kBytes, kNT>;
  constexpr int smem = kStages * (kRows + kNT * 8) * kRowBytes;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.N + kRows - 1) / kRows, (a.M + kNT * 8 - 1) / (kNT * 8),
                  a.splits);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <int kBytes>
int launch_nt(const GemmArgs& a, cudaStream_t st) {
  switch (n_tiles(a.M)) {
    case 1:
      return launch_tile<kBytes, 1>(a, st);
    case 2:
      return launch_tile<kBytes, 2>(a, st);
    case 4:
      return launch_tile<kBytes, 4>(a, st);
    default:
      return launch_tile<kBytes, kMaxNT>(a, st);
  }
}

}  // namespace

// The number of K splits for an [M, N, K] product on a card of `sms` SMs:
// 1 when the output tiles alone give two blocks an SM, else enough splits
// (each at least one 128-byte chunk of K, none empty) to get there. The
// wrapper sizes the split scratch from it.
extern "C" int ragtorch_w8a8_splits(int M, int N, int K, int sms) {
  if (M < 1 || N < 1 || K < 1) return 1;
  const long long tiles = (long long)((N + kRows - 1) / kRows) *
                          ((M + n_tiles(M) * 8 - 1) / (n_tiles(M) * 8));
  const int nchunks = (K + kChunk - 1) / kChunk;
  const long long want = 2LL * sms;
  if (tiles >= want) return 1;
  const int splits = (int)min((long long)nchunks, (want + tiles - 1) / tiles);
  const int cps = (nchunks + splits - 1) / splits;
  return (nchunks + cps - 1) / cps;
}

// out [M, N] (f32: out_kind 0, bf16: 1) = epilogue(xq [M, K] . wq [N, K]^T);
// bias null or [N] of the output type; part [splits, M, N] s32 scratch when
// splits > 1 (else null). K must be a multiple of 4 and both int8 bases
// 4-byte aligned.
extern "C" int ragtorch_w8a8_gemm(const void* xq, const void* xs,
                                  const void* wq, const void* ws,
                                  const void* bias, void* out, void* part,
                                  int M, int N, int K, int splits,
                                  int out_kind, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 4 || K % 4 != 0 || splits < 1 ||
      (splits > 1 && part == nullptr) ||
      (out_kind != kOutF32 && out_kind != kOutBf16) ||
      reinterpret_cast<uintptr_t>(xq) % 4 != 0 ||
      reinterpret_cast<uintptr_t>(wq) % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const int nchunks = (K + kChunk - 1) / kChunk;
  const GemmArgs a{static_cast<const uint8_t*>(xq), static_cast<const float*>(xs),
                   static_cast<const uint8_t*>(wq), static_cast<const float*>(ws),
                   bias, out, static_cast<int*>(part), M, N, K, splits,
                   (nchunks + splits - 1) / splits, out_kind};
  const bool vec16 = K % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(wq) % 16 == 0;
  const int err = vec16 ? launch_nt<16>(a, st) : launch_nt<4>(a, st);
  if (err != 0 || splits == 1) return err;
  const long long mn = (long long)M * N;
  w8a8_splitk_epilogue_kernel<<<(unsigned)((mn + kEpiThreads - 1) / kEpiThreads),
                                kEpiThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}
