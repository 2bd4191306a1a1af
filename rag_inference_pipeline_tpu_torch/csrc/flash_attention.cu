// Encoder flash attention with segment ids, for Hopper (sm_90a).
//
// Replaces the TPU kernel that rag_inference_pipeline_tpu/models/layers.py::
// encoder_attention calls at T >= 1024 (layers.py:205-215): the library
// Pallas flash-attention forward (jax/experimental/pallas/ops/tpu/
// flash_attention.py, _flash_attention_kernel_single_batch), non-causal,
// no bias, segment ids for both q and kv. For every batch row b, head h and
// query i, over 128-key blocks in order:
//   s     = (q_i . k_j accumulated in f32) * sm_scale    (scale after the product)
//   s    += seg_q[b, i] == seg_kv[b, j] ? 0 : -0.7 * FLT_MAX  (additive)
//   m'    = max(m, rowmax s),  m from -inf
//   p     = exp(s - m'),  alpha = exp(m - m'),  l' = rowsum p + alpha l
//   inv   = l' == 0 ? 1 : 1 / l'
//   acc   = acc * (alpha l * inv) + (p cast to v's dtype . v, f32) * inv
// and out = acc cast to q's dtype: the accumulator is normalised as it
// goes, with no division at the end. Every product and sum of that update
// is rounded as in the plain version (ops/flash_attention.py: __fmul_rn,
// __fadd_rn, the IEEE 1 / l', the accurate expf), and p . v goes into a
// fresh accumulator each block before the update, so only the sums of the
// two matrix products and the row sums of p run in another order.
//
// q, k, v are [B, T, H, Dh] read through their strides (the head row
// contiguous, 16-byte aligned), seg_q and seg_kv [B, T] int32 (seg_kv on
// 16 bytes), out [B, T, H, Dh] contiguous. Dh is 64, 128 or 256 and T a
// multiple of 128.
//
// Floors on the H100 (tools/bench_flash.py prints both a case):
// - tensor: the two products, 4 B H T^2 Dh operations at 989 TFLOP/s; bge-
//   base heads (H 12, Dh 64), B 4: 0.0130 ms at T 1024, 0.208 at T 4096
//   (the bytes of q, k, v, out and the ids once take 0.0075 ms at T 1024);
// - CUDA cores: the FP32-pipe instructions a score of the main loop (the
//   scale, the mask where a block needs it, the max, the subtraction, the
//   accurate expf's six, the sum, half a pack, and the update's three an
//   output element a block) over 132 SMs x 128 lanes, and its MUFU.EX2 (one
//   a score) over 132 x 16, at the SM clock: bench_flash.py counts them in
//   this kernel's SASS. At Dh 64 this floor is the larger; at Dh 128 and
//   256 the tensor floor is.
//
// Design of the bf16 and f16 kernel, against what held the mma.sync kernel
// it replaces back:
// - wgmma, not mma.sync: S = Q K^T is m64n128k16 with Q and K both K-major
//   in shared memory (SS); P V is m64nNk16 with P from registers (RS: the
//   f32 accumulator layout of S, cast to v's dtype, is the A fragment of
//   the k16 steps, no shuffle) and V as an MN-major B in shared memory (the
//   transpose bit). A warpgroup reads each K and V tile once for its 64
//   rows, where each mma.sync warp re-read the whole tile through ldmatrix
//   for its 16.
// - TMA, not cp.async: one producer thread loads Q once and then K_0, V_0,
//   K_1, V_1, ... (with each K tile the block's 128 key ids, a bulk copy)
//   into a ring of kSlots tiles, each guarded by a full mbarrier (the
//   bytes) and an empty one (one arrival a consumer warp once its products
//   and id reads are done). The maps are 4-D over (Dh, and H, T, B in
//   rising stride), built on the host from the wrapper's strides, with
//   64-element boxes along Dh and the 128-byte swizzle: any view the
//   wrapper takes (16-byte strides, the head row contiguous) loads as a
//   contiguous one would. The ring holds 4 key blocks ahead at Dh 64, 2.5
//   at Dh 128 and 1 at Dh 256 (two 64 KB tiles), where the mma.sync kernel
//   held one K and one V buffer behind four __syncthreads a block.
// - Warp specialisation and ping-pong: a block takes 128 query rows, two
//   consumer warpgroups of 64 and one producer warpgroup (setmaxnreg: 24
//   registers for the producer, 240 for the consumers).
//   Named barriers 1 and 2 let the consumers issue their products in
//   turns, so that one's softmax runs on the CUDA cores while the other's
//   products run on the tensor cores, rather than both waiting on the
//   same products.
// - At Dh 64 a turn issues S_{j+1} and P_j V_j together: softmax_{j+1}
//   runs while P_j V_j is in flight, and P_j V_j is folded in after it
//   (registers: s 64, o 32, acc 32, p 32 a thread). p is packed only after
//   the wait, and 1 / l' is reciprocal()'s, with no call: ptxas serializes
//   every wgmma of a kernel where a wgmma's A registers are written, or a
//   call (__fdiv_rn's slow path) is made, while it runs.
// - Dh 256: Q takes 64 KB and a K or V tile 64 KB, so the ring has two
//   tiles (192 KB in all); acc is 128 registers a thread, s and o are
//   never live together. On an H100 (tools/bench_flash.py) this tile took
//   0.043-0.050 ms at B 4, H 3, T 1024 against 0.055-0.059 for one
//   consumer warpgroup of 64 rows with a ring of three.
// - P V runs in output-column chunks (n64 at Dh 64 and 256, n128 at Dh
//   128), each into a fresh accumulator that the update then folds in, so
//   that it never holds more than 64 registers a thread.
// - Exact shortcuts only: a key block whose 128 ids equal every id of a
//   warp's rows skips the mask add (adding +0.0 changes no exp, no max
//   that matters and no output bit); a block whose ids are all one value
//   adds one constant a row; only mixed blocks read their ids key by key.
//   The row max is a tree (a max is exact in any order); the row sum is
//   four partial sums a row, 8 deep, not one chain of 32.
// - f32: CUDA-core FMAs (no TF32, which would round the inputs). A block
//   of 128 threads owns 64 query rows (32 at Dh 256); K and V stream in
//   32-key chunks, the 128-key scores and p sit in shared memory, and each
//   output sums its 128 products in key order before the update.
// Blocks are independent, there are no atomics, and the result is
// deterministic.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "ptx.cuh"
#include "tma.cuh"

namespace ragtorch {
namespace {

constexpr int kBlockK = 128;  // the library's key block
// the library's DEFAULT_MASK_VALUE, rounded once from double as JAX does
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

// 1 / l', the IEEE quotient: __fdiv_rn(1, l)'s fast path without its
// check and slow-path call (a call while a wgmma is in flight makes ptxas
// serialize every wgmma of the kernel). The check passes for every l' a
// block gives: l' >= 1, since the row's max contributes exp(0) = 1, and l'
// <= T. 1 where l' is 0, as the plain version writes it.
__device__ __forceinline__ float reciprocal(float l) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(l));
  r = __fmaf_rn(r, __fmaf_rn(-l, r, 1.0f), r);
  r = __fmaf_rn(r, __fmaf_rn(-l, r, 1.0f), r);
  return l == 0.0f ? 1.0f : r;
}

// the online-softmax update of one accumulator element, rounded as the
// plain version rounds it: acc * (l_corr * inv) + o * inv
__device__ __forceinline__ float update(float acc, float corr, float o, float inv) {
  return __fadd_rn(__fmul_rn(acc, corr), __fmul_rn(o, inv));
}

// masked, scaled score: the scale after the product, then the additive mask
__device__ __forceinline__ float score(float dot, float sm_scale, bool same) {
  return __fadd_rn(__fmul_rn(dot, sm_scale), same ? 0.0f : kMaskValue);
}

// `rows` rows of `kDh` elements from global rows `rs` elements apart into
// shared rows `kLd` elements apart, 16 bytes a cp.async
template <typename T, int kDh, int kLd, int kRowsN, int kThreads>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs, int tid) {
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kChunks = kDh / kPer;
#pragma unroll
  for (int i = tid; i < kRowsN * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    ptx::cp_async<16>(ptx::smem_addr(dst + r * kLd + c), src + r * rs + c, 16);
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16: wgmma, TMA, warp specialisation
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int kDh>
struct WgShape {
  static constexpr int kConsumers = 2;                    // warpgroups of 64 rows
  static constexpr int kRows = 64 * kConsumers;           // query rows a block
  static constexpr int kThreads = 128 * (kConsumers + 1); // + the producer's
  static constexpr int kPanels = kDh / 64;                // 128-byte column panels
  static constexpr int kPanel = kBlockK * 128;            // a K or V tile's panel
  static constexpr int kTile = kPanels * kPanel;          // one K or V tile
  static constexpr int kQPanel = kRows * 128;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kSlots = kDh == 64 ? 8 : kDh == 128 ? 5 : 2;
  static constexpr int kChunk = kDh == 128 ? 128 : 64;    // P V output columns
  // S_{j+1} and P_j V_j in flight together (registers: s 64, p twice 32,
  // o 32, acc 32 a thread)
  static constexpr bool kOverlap = kDh == 64;
  // 1 KB to align the tiles on the swizzle's 1,024 bytes, Q, the ring, its
  // key ids, the full and empty barriers and Q's
  static constexpr int kSmem =
      1024 + kQBytes + kSlots * kTile + kSlots * kBlockK * 4 + (2 * kSlots + 1) * 8;
  static_assert(kSmem <= 232448, "over the 227 KB a block can have");
};

// the box at Dh column `col` of head h, row t, batch row b: the map's
// dimensions 1-3 are H, T and B in rising stride, and `perm` holds the
// dimension of each (2 bits: H, then T, then B)
__device__ __forceinline__ void load_box(void* dst, const CUtensorMap* map, int perm,
                                         int col, int h, int t, int b, uint64_t* bar) {
  const int ph = perm & 3, pt = (perm >> 2) & 3;
  const int c1 = ph == 1 ? h : pt == 1 ? t : b;
  const int c2 = ph == 2 ? h : pt == 2 ? t : b;
  const int c3 = ph == 3 ? h : pt == 3 ? t : b;
  ptx::tma_load_4d(dst, map, col, c1, c2, c3, bar);
}

// S = Q K^T for a warpgroup's 64 rows and a 128-key tile: kDh / 16 k16
// steps of 32 bytes through the 128-byte panels
template <bool kBf16, int kDh, int kQPanel, int kPanel>
__device__ __forceinline__ void issue_s(float (&s)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int off = (kk % 4) * 2;
    ptx::wgmma_m64n128k16_ss<kBf16>(s, ptx::wgmma_desc_sw128(q_addr + (kk / 4) * kQPanel) + off,
                                    ptx::wgmma_desc_sw128(k_addr + (kk / 4) * kPanel) + off,
                                    kk > 0);
  }
}

// o (a fresh accumulator) = P . V for output columns [c0, c0 + kN) of a
// 128-key V tile: 8 k16 steps of 16 key rows (2,048 bytes)
template <bool kBf16, int kN, int kPanel>
__device__ __forceinline__ void issue_pv(float (&o)[kN / 2], const uint32_t (&pa)[8][4],
                                         uint32_t v_addr, int c0) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    ptx::wgmma_m64k16_rs<kBf16, kN>(
        o, pa[kk], ptx::wgmma_desc_sw128_mn(v_addr + (c0 / 64) * kPanel + kk * 2048, kPanel),
        kk > 0);
}

// The online-softmax step of one key block on the scores s of a thread's
// rows (s[4n + 2r + e]: row + 8r, key 8n + 2tq + e): scale and mask (block-
// uniform ids take the short forms), then release the K tile and its ids
// (`release`), the row statistics (m and l of each row), p = exp(s - m')
// in s, and the update's factors of each row: sc = alpha l * inv and
// inv = 1 / l'.
__device__ __forceinline__ void softmax_block(float (&s)[64], const int* kid, uint64_t* release,
                                              int seg0, int seg1, float sm_scale, float (&m)[2],
                                              float (&l)[2], float (&sc)[2], float (&inv)[2]) {
  float corr[2];
  const int lane = threadIdx.x % 32, tq = lane % 4;
  const int4 four = *reinterpret_cast<const int4*>(kid + 4 * lane);
  const int first = kid[0];
  const bool uniform = __all_sync(0xffffffffu, four.x == first && four.y == first &&
                                                   four.z == first && four.w == first);
  if (uniform && __all_sync(0xffffffffu, seg0 == first && seg1 == first)) {
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], sm_scale);
  } else if (uniform) {
    const float c0 = seg0 == first ? 0.0f : kMaskValue;
    const float c1 = seg1 == first ? 0.0f : kMaskValue;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * n + e] = __fadd_rn(__fmul_rn(s[4 * n + e], sm_scale), c0);
        s[4 * n + 2 + e] = __fadd_rn(__fmul_rn(s[4 * n + 2 + e], sm_scale), c1);
      }
  } else {
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int2 id = *reinterpret_cast<const int2*>(kid + 8 * n + 2 * tq);
      s[4 * n] = score(s[4 * n], sm_scale, id.x == seg0);
      s[4 * n + 1] = score(s[4 * n + 1], sm_scale, id.y == seg0);
      s[4 * n + 2] = score(s[4 * n + 2], sm_scale, id.x == seg1);
      s[4 * n + 3] = score(s[4 * n + 3], sm_scale, id.y == seg1);
    }
  }
  __syncwarp();
  if (lane == 0) ptx::mbar_arrive(release);

  // the row max as a tree (a max is exact in any order), then over the quad
  // that holds the row
  float mx[2][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      mx[r][i] = fmaxf(fmaxf(s[8 * i + 2 * r], s[8 * i + 2 * r + 1]),
                       fmaxf(s[8 * i + 4 + 2 * r], s[8 * i + 5 + 2 * r]));
#pragma unroll
  for (int w = 4; w > 0; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) mx[r][i] = fmaxf(mx[r][i], mx[r][i + w]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off *= 2)
      mx[r][0] = fmaxf(mx[r][0], __shfl_xor_sync(0xffffffffu, mx[r][0], off));
    mx[r][0] = fmaxf(m[r], mx[r][0]);
  }
  // the row sums in four partial sums a row (the plain version's sum has
  // its own order too), each 8 deep rather than one chain of 32
  float sum[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * n + 2 * r + e];
        x = expf(x - mx[r][0]);
        sum[r][(n % 2) * 2 + e] += x;
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = (sum[r][0] + sum[r][1]) + (sum[r][2] + sum[r][3]);
#pragma unroll
    for (int off = 1; off < 4; off *= 2) total += __shfl_xor_sync(0xffffffffu, total, off);
    corr[r] = __fmul_rn(expf(m[r] - mx[r][0]), l[r]);
    l[r] = __fadd_rn(total, corr[r]);
    m[r] = mx[r][0];
    inv[r] = reciprocal(l[r]);
    sc[r] = __fmul_rn(corr[r], inv[r]);
  }
}

// p in v's dtype: the A fragments of the 8 k16 steps of P . V (the f32
// accumulator layout of two n8 tiles is the A layout of one k16 step)
template <typename T>
__device__ __forceinline__ void pack_p(const float (&s)[64], uint32_t (&pa)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    pa[kk][0] = pack2<T>(s[8 * kk], s[8 * kk + 1]);
    pa[kk][1] = pack2<T>(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack2<T>(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack2<T>(s[8 * kk + 6], s[8 * kk + 7]);
    ptx::fence_regs(pa[kk]);
  }
}

// acc[i] (output columns of o's chunk) folded with o: acc * sc + o * inv
template <int kN>
__device__ __forceinline__ void update_chunk(float* acc, const float (&o)[kN], const float (&sc)[2],
                                             const float (&inv)[2]) {
#pragma unroll
  for (int i = 0; i < kN; i += 4) {
    acc[i] = update(acc[i], sc[0], o[i], inv[0]);
    acc[i + 1] = update(acc[i + 1], sc[0], o[i + 1], inv[0]);
    acc[i + 2] = update(acc[i + 2], sc[1], o[i + 2], inv[1]);
    acc[i + 3] = update(acc[i + 3], sc[1], o[i + 3], inv[1]);
  }
}

template <typename T, int kDh>
__global__ void __launch_bounds__(WgShape<kDh>::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, const int* __restrict__ seg_q,
                       const int* __restrict__ seg_kv, T* __restrict__ out, int t_len,
                       int heads, int perms, float sm_scale) {
  using S = WgShape<kDh>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* tiles = sq + S::kQBytes;
  int* ids = reinterpret_cast<int*>(tiles + S::kSlots * S::kTile);
  uint64_t* full = reinterpret_cast<uint64_t*>(ids + S::kSlots * kBlockK);
  uint64_t* empty = full + S::kSlots;
  uint64_t* qbar = empty + S::kSlots;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * S::kRows;
  const int nb = t_len / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kSlots; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], 4 * S::kConsumers);
    }
    ptx::mbar_init(qbar, 1);
    ptx::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == S::kConsumers) {  // the producer warpgroup: one thread loads
    ptx::setmaxnreg_dec<24>();
    if (threadIdx.x == S::kConsumers * 128) {
      ptx::mbar_arrive_expect_tx(qbar, S::kQBytes);
#pragma unroll
      for (int p = 0; p < S::kPanels; ++p)
        load_box(sq + p * S::kQPanel, &map_q, perms & 63, 64 * p, h, row0, b, qbar);
      const int* kid = seg_kv + (long long)b * t_len;
      for (int i = 0; i < 2 * nb; ++i) {  // K_0, V_0, K_1, V_1, ...
        const int s = i % S::kSlots, j = i / 2;
        if (i >= S::kSlots) ptx::mbar_wait(&empty[s], (i / S::kSlots - 1) & 1);
        uint8_t* dst = tiles + s * S::kTile;
        if (i % 2 == 0) {
          ptx::mbar_arrive_expect_tx(&full[s], S::kTile + kBlockK * 4);
#pragma unroll
          for (int p = 0; p < S::kPanels; ++p)
            load_box(dst + p * S::kPanel, &map_k, (perms >> 6) & 63, 64 * p, h, j * kBlockK, b,
                     &full[s]);
          ptx::bulk_load(ids + s * kBlockK, kid + j * kBlockK, kBlockK * 4, &full[s]);
        } else {
          ptx::mbar_arrive_expect_tx(&full[s], S::kTile);
#pragma unroll
          for (int p = 0; p < S::kPanels; ++p)
            load_box(dst + p * S::kPanel, &map_v, (perms >> 12) & 63, 64 * p, h, j * kBlockK, b,
                     &full[s]);
        }
      }
    }
    return;
  }
  ptx::setmaxnreg_inc<240>();

  // thread (warp, g, tq) of the warpgroup holds rows 16 warp + g and + 8 of
  // its 64: s[4n + 2r + e] is row + 8r, key 8n + 2tq + e; acc[4n + 2r + e]
  // the same rows at output column 8n + 2tq + e
  const int t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
  const int row = row0 + wg * 64 + (t / 32) * 16 + lane / 4;
  const int* sqg = seg_q + (long long)b * t_len + row;
  const int seg0 = __ldg(sqg), seg1 = __ldg(sqg + 8);
  float acc[kDh / 2];
#pragma unroll
  for (int i = 0; i < kDh / 2; ++i) acc[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, sc[2], inv[2];
  uint32_t pa[8][4];
  float s[64];
  const uint32_t q_addr = ptx::smem_addr(sq) + wg * 64 * 128;
  const uint32_t tiles_addr = ptx::smem_addr(tiles);
  // tile i (K_j at i = 2j, V_j at 2j + 1) sits in slot i % kSlots, in its
  // (i / kSlots)-th use
  auto wait_full = [&](int i) { ptx::mbar_wait(&full[i % S::kSlots], (i / S::kSlots) & 1); };
  auto tile = [&](int i) { return tiles_addr + (i % S::kSlots) * S::kTile; };
  auto slot_ids = [&](int i) { return ids + (i % S::kSlots) * kBlockK; };
  // ping-pong: consumer w issues its products after barrier 1 + w, then
  // lets the other go; consumer 0 goes first
  if (wg == 0) ptx::bar_arrive(1, 256);
  ptx::mbar_wait(qbar, 0);

  if constexpr (S::kOverlap) {
    // S_0 and its softmax; then each turn issues S_{j+1} and P_j V_j
    // together, runs softmax_{j+1} while P_j V_j is in flight, and folds
    // P_j V_j into acc with block j's factors
    wait_full(0);
    ptx::bar_sync(1 + wg, 256);
    ptx::wgmma_fence();
    issue_s<kBf16, kDh, S::kQPanel, S::kPanel>(s, q_addr, tile(0));
    ptx::wgmma_commit();
    ptx::bar_arrive(2 - wg, 256);
    ptx::wgmma_wait<0>();
    ptx::fence_regs(s);
    softmax_block(s, slot_ids(0), &empty[0], seg0, seg1, sm_scale, m, l, sc, inv);
    pack_p<T>(s, pa);
    for (int j = 0; j + 1 < nb; ++j) {
      wait_full(2 * j + 1);
      wait_full(2 * j + 2);
      float o[kDh / 2];
      ptx::bar_sync(1 + wg, 256);
      ptx::wgmma_fence();
      issue_s<kBf16, kDh, S::kQPanel, S::kPanel>(s, q_addr, tile(2 * j + 2));
      ptx::wgmma_commit();
      issue_pv<kBf16, kDh, S::kPanel>(o, pa, tile(2 * j + 1), 0);
      ptx::wgmma_commit();
      ptx::bar_arrive(2 - wg, 256);
      const float sc_j[2] = {sc[0], sc[1]}, inv_j[2] = {inv[0], inv[1]};
      ptx::wgmma_wait<1>();  // S_{j+1}; P_j V_j may still run
      ptx::fence_regs(s);
      softmax_block(s, slot_ids(2 * j + 2), &empty[(2 * j + 2) % S::kSlots], seg0, seg1,
                    sm_scale, m, l, sc, inv);
      ptx::wgmma_wait<0>();
      ptx::fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) ptx::fence_regs(pa[kk]);  // read until here
      update_chunk<kDh / 2>(acc, o, sc_j, inv_j);
      __syncwarp();
      if (lane == 0) ptx::mbar_arrive(&empty[(2 * j + 1) % S::kSlots]);  // V_j is read
      pack_p<T>(s, pa);  // only now: a wgmma's A registers change outside its stage
    }
    {  // the last block: P V alone
      const int j = nb - 1;
      wait_full(2 * j + 1);
      float o[kDh / 2];
      ptx::bar_sync(1 + wg, 256);
      ptx::wgmma_fence();
      issue_pv<kBf16, kDh, S::kPanel>(o, pa, tile(2 * j + 1), 0);
      ptx::wgmma_commit();
      ptx::bar_arrive(2 - wg, 256);
      ptx::wgmma_wait<0>();
      ptx::fence_regs(o);
      update_chunk<kDh / 2>(acc, o, sc, inv);
    }
  } else {
    for (int j = 0; j < nb; ++j) {
      wait_full(2 * j);
      ptx::bar_sync(1 + wg, 256);
      ptx::wgmma_fence();
      issue_s<kBf16, kDh, S::kQPanel, S::kPanel>(s, q_addr, tile(2 * j));
      ptx::wgmma_commit();
      ptx::bar_arrive(2 - wg, 256);
      ptx::wgmma_wait<0>();
      ptx::fence_regs(s);
      softmax_block(s, slot_ids(2 * j), &empty[(2 * j) % S::kSlots], seg0, seg1, sm_scale, m,
                    l, sc, inv);
      pack_p<T>(s, pa);
      wait_full(2 * j + 1);
#pragma unroll
      for (int c = 0; c < kDh / S::kChunk; ++c) {
        float o[S::kChunk / 2];
        ptx::wgmma_fence();
        issue_pv<kBf16, S::kChunk, S::kPanel>(o, pa, tile(2 * j + 1), c * S::kChunk);
        ptx::wgmma_commit();
        ptx::wgmma_wait<0>();
        ptx::fence_regs(o);
        update_chunk<S::kChunk / 2>(acc + c * S::kChunk / 2, o, sc, inv);
      }
      __syncwarp();
      if (lane == 0) ptx::mbar_arrive(&empty[(2 * j + 1) % S::kSlots]);  // V_j is read
    }
  }
  // the other consumer's last turn, so that no arrival outlives the block
  if (wg == 0) ptx::bar_sync(1, 256);

  // out rows `row` and row + 8, two adjacent columns a store
  const long long orow = (long long)heads * kDh;
  T* og = out + ((long long)b * t_len + row) * orow + (long long)h * kDh + 2 * tq;
#pragma unroll
  for (int n = 0; n < kDh / 8; ++n) {
    *reinterpret_cast<uint32_t*>(og + n * 8) = pack2<T>(acc[4 * n], acc[4 * n + 1]);
    *reinterpret_cast<uint32_t*>(og + 8 * orow + n * 8) =
        pack2<T>(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMAs
// ---------------------------------------------------------------------------

template <int kDh>
struct F32Shape {
  static constexpr int kThreads = 128;
  // query rows a block: the output tile is 32 (Dh 64) or 64 registers a
  // thread, and as many again for a block's products
  static constexpr int kRows = kDh == 256 ? 32 : 64;
  static constexpr int kChunk = 32;         // keys a staged K or V chunk
  static constexpr int kLd = kDh + 4;       // shared row of q, k, v, floats
  static constexpr int kLdS = kBlockK + 4;  // shared row of scores
  // the products: kRows x kChunk scores, thread (qg = tid / 8, kg = tid % 8)
  // owns rows qg + 16 i and keys kg + 8 j
  static constexpr int kSRows = kRows / 16;
  // the output: thread (rg, cg) owns rows rg + kRowGroups i, i < 4, and
  // the float4 columns 4 cg + 4 kColGroups c
  static constexpr int kRowGroups = kRows / 4;
  static constexpr int kColGroups = kThreads / kRowGroups;
  static constexpr int kCol4 = kDh / (4 * kColGroups);
  static constexpr int smem() {
    return (kRows * kLd + kRows * kLdS + kChunk * kLd) * 4 + kBlockK * 4 + 4 * kRows * 4;
  }
};

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int kDh>
__global__ void __launch_bounds__(F32Shape<kDh>::kThreads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, float* __restrict__ out, int t_len,
                     int heads, Strides st, float sm_scale) {
  using S = F32Shape<kDh>;
  constexpr int kLd = S::kLd, kLdS = S::kLdS, kThreads = S::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* ss = sq + S::kRows * kLd;  // scores, then p
  float* skv = ss + S::kRows * kLdS;
  int* sseg = reinterpret_cast<int*>(skv + S::kChunk * kLd);
  float* sm = reinterpret_cast<float*>(sseg + kBlockK);  // m, l, corr, inv a row
  float* sl = sm + S::kRows;
  float* scorr = sl + S::kRows;
  float* sinv = scorr + S::kRows;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * S::kRows;
  const float* kg = k + b * st.kb + h * st.kh;
  const float* vg = v + b * st.vb + h * st.vh;
  const int* sqg = seg_q + (long long)b * t_len + row0;
  const int* skg = seg_kv + (long long)b * t_len;

  load_rows<float, kDh, kLd, S::kRows, kThreads>(
      sq, q + b * st.qb + h * st.qh + row0 * st.qt, st.qt, tid);
  ptx::cp_async_commit();
  for (int r = tid; r < S::kRows; r += kThreads) {
    sm[r] = -INFINITY;
    sl[r] = 0.0f;
  }

  const int qg = tid / 8, kgrp = tid % 8;
  const int rg = tid / S::kColGroups, cg = tid % S::kColGroups;
  float acc[4][S::kCol4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < S::kCol4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][c][e] = 0.0f;

  for (int j0 = 0; j0 < t_len; j0 += kBlockK) {
    // the raw products q . k of the block, a 32-key chunk at a time
    if (tid < kBlockK) sseg[tid] = __ldg(skg + j0 + tid);
    for (int c0 = 0; c0 < kBlockK; c0 += S::kChunk) {
      __syncthreads();  // the chunk buffer is free
      load_rows<float, kDh, kLd, S::kChunk, kThreads>(skv, kg + (j0 + c0) * st.kt, st.kt,
                                                      tid);
      ptx::cp_async_commit();
      ptx::cp_async_wait<0>();
      __syncthreads();
      float d[S::kSRows][4];
#pragma unroll
      for (int i = 0; i < S::kSRows; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) d[i][jj] = 0.0f;
#pragma unroll 4
      for (int x = 0; x < kDh; x += 4) {
        float4 qa[S::kSRows], kb[4];
#pragma unroll
        for (int i = 0; i < S::kSRows; ++i)
          qa[i] = *reinterpret_cast<const float4*>(sq + (qg + 16 * i) * kLd + x);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kb[jj] = *reinterpret_cast<const float4*>(skv + (kgrp + 8 * jj) * kLd + x);
#pragma unroll
        for (int i = 0; i < S::kSRows; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) d[i][jj] = dot4(qa[i], kb[jj], d[i][jj]);
      }
#pragma unroll
      for (int i = 0; i < S::kSRows; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) ss[(qg + 16 * i) * kLdS + c0 + kgrp + 8 * jj] = d[i][jj];
    }
    __syncthreads();
    // the softmax update: a warp a row at a time, 4 keys a lane
    for (int r = warp; r < S::kRows; r += kThreads / 32) {
      const int segq = __ldg(sqg + r);
      float x[4], mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = lane + 32 * i;
        x[i] = score(ss[r * kLdS + key], sm_scale, sseg[key] == segq);
        mx = fmaxf(mx, x[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm[r], mn = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        x[i] = expf(x[i] - mn);
        sum += x[i];
        ss[r * kLdS + lane + 32 * i] = x[i];
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = __fmul_rn(expf(m_prev - mn), sl[r]);
      const float l = __fadd_rn(sum, corr);
      const float inv = l == 0.0f ? 1.0f : __fdiv_rn(1.0f, l);
      __syncwarp();
      if (lane == 0) {
        sm[r] = mn;
        sl[r] = l;
        scorr[r] = __fmul_rn(corr, inv);
        sinv[r] = inv;
      }
    }
    // p . v over the block, a 32-key chunk at a time, each output's sum in
    // key order
    float o[4][S::kCol4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < S::kCol4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][c][e] = 0.0f;
    for (int c0 = 0; c0 < kBlockK; c0 += S::kChunk) {
      __syncthreads();  // p is written and the chunk buffer is free
      load_rows<float, kDh, kLd, S::kChunk, kThreads>(skv, vg + (j0 + c0) * st.vt, st.vt,
                                                      tid);
      ptx::cp_async_commit();
      ptx::cp_async_wait<0>();
      __syncthreads();
#pragma unroll 2
      for (int x = 0; x < S::kChunk; x += 4) {
        float4 p4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p4[i] = *reinterpret_cast<const float4*>(ss + (rg + S::kRowGroups * i) * kLdS + c0 + x);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int c = 0; c < S::kCol4; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(
                skv + (x + kk) * kLd + 4 * cg + 4 * S::kColGroups * c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = kk == 0 ? p4[i].x : kk == 1 ? p4[i].y : kk == 2 ? p4[i].z : p4[i].w;
              o[i][c][0] = fmaf(p, vv.x, o[i][c][0]);
              o[i][c][1] = fmaf(p, vv.y, o[i][c][1]);
              o[i][c][2] = fmaf(p, vv.z, o[i][c][2]);
              o[i][c][3] = fmaf(p, vv.w, o[i][c][3]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + S::kRowGroups * i;
      const float corr = scorr[r], inv = sinv[r];
#pragma unroll
      for (int c = 0; c < S::kCol4; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][c][e] = update(acc[i][c][e], corr, o[i][c][e], inv);
    }
    __syncthreads();  // every thread has read this block's p and row factors
  }

  const long long orow = (long long)heads * kDh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* og = out + ((long long)b * t_len + row0 + rg + S::kRowGroups * i) * orow +
                (long long)h * kDh + 4 * cg;
#pragma unroll
    for (int c = 0; c < S::kCol4; ++c)
      *reinterpret_cast<float4*>(og + 4 * S::kColGroups * c) =
          make_float4(acc[i][c][0], acc[i][c][1], acc[i][c][2], acc[i][c][3]);
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// A [B, T, H, Dh] view of 16-bit elements with element strides (sb, st, sh)
// as a 4-D tensor map: Dh innermost, then H, T and B in rising stride (a
// dimension of size 1 never steps: it goes last), in boxes of 64 x 1 x
// `rows` (along T) x 1 with the 128-byte swizzle. `perm` gets the map
// dimension of H, T and B, 2 bits each.
bool encode_heads(CUtensorMap* map, const void* base, bool bf16, int batch, int t_len,
                  int heads, int dh, long long sb, long long st, long long sh, int rows,
                  int* perm) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  struct Dim {
    long long size, stride;
    int which;  // 0 H, 1 T, 2 B
  } d[3] = {{heads, sh, 0}, {t_len, st, 1}, {batch, sb, 2}};
  long long span = 1;
  for (const Dim& x : d) span = x.stride * x.size > span ? x.stride * x.size : span;
  for (Dim& x : d)
    if (x.size == 1) x.stride = span;
  for (int i = 1; i < 3; ++i)  // insertion sort by stride, stable
    for (int k = i; k > 0 && d[k].stride < d[k - 1].stride; --k) {
      const Dim tmp = d[k];
      d[k] = d[k - 1];
      d[k - 1] = tmp;
    }
  cuuint64_t dims[4] = {(cuuint64_t)dh, 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {64, 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)(d[i].stride * 2);
    if (d[i].which == 1) box[i + 1] = (cuuint32_t)rows;
    pos[d[i].which] = i + 1;
  }
  *perm = pos[0] | pos[1] << 2 | pos[2] << 4;
  return fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            4, const_cast<void*>(base), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int kDh>
int launch_wgmma(const void* q, const void* k, const void* v, const int* seg_q,
                 const int* seg_kv, void* out, int batch, int t_len, int heads,
                 const Strides& st, float sm_scale, cudaStream_t stream) {
  using S = WgShape<kDh>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap mq, mk, mv;
  int pq, pk, pv;
  if (reinterpret_cast<uintptr_t>(seg_kv) % 16 != 0 ||
      !encode_heads(&mq, q, kBf16, batch, t_len, heads, kDh, st.qb, st.qt, st.qh, S::kRows,
                    &pq) ||
      !encode_heads(&mk, k, kBf16, batch, t_len, heads, kDh, st.kb, st.kt, st.kh, kBlockK,
                    &pk) ||
      !encode_heads(&mv, v, kBf16, batch, t_len, heads, kDh, st.vb, st.vt, st.vh, kBlockK,
                    &pv))
    return (int)cudaErrorInvalidValue;
  // once a process: a launch captured in a CUDA graph makes no such call
  // after its warm-up
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_wgmma_kernel<T, kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(t_len / S::kRows, heads, batch);
  flash_wgmma_kernel<T, kDh><<<grid, S::kThreads, S::kSmem, stream>>>(
      mq, mk, mv, seg_q, seg_kv, static_cast<T*>(out), t_len, heads,
      pq | pk << 6 | pv << 12, sm_scale);
  return (int)cudaGetLastError();
}

template <int kDh>
int launch_f32(const void* q, const void* k, const void* v, const int* seg_q,
               const int* seg_kv, void* out, int batch, int t_len, int heads,
               const Strides& st, float sm_scale, cudaStream_t stream) {
  using S = F32Shape<kDh>;
  const int smem = S::smem();
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<kDh>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(t_len / S::kRows, heads, batch);
  flash_f32_kernel<kDh><<<grid, S::kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), seg_q, seg_kv, static_cast<float*>(out), t_len, heads,
      st, sm_scale);
  return (int)cudaGetLastError();
}

template <int kDh>
int dispatch(int kind, const void* q, const void* k, const void* v, const int* seg_q,
             const int* seg_kv, void* out, int batch, int t_len, int heads,
             const Strides& st, float sm_scale, cudaStream_t stream) {
  switch (kind) {
    case 0:
      return launch_f32<kDh>(q, k, v, seg_q, seg_kv, out, batch, t_len, heads, st,
                             sm_scale, stream);
    case 1:
      return launch_wgmma<__nv_bfloat16, kDh>(q, k, v, seg_q, seg_kv, out, batch, t_len,
                                              heads, st, sm_scale, stream);
    case 2:
      return launch_wgmma<__half, kDh>(q, k, v, seg_q, seg_kv, out, batch, t_len, heads,
                                       st, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ragtorch

// q, k, v: [B, T, H, dh] of `kind` (0 f32, 1 bf16, 2 f16) with element
// strides (b, t, h) each, the head row contiguous; seg_q, seg_kv: [B, T]
// int32 (seg_kv on 16 bytes for bf16 and f16); out: [B, T, H, dh]
// contiguous. Needs T % 128 == 0, dh in {64, 128, 256}, 16-byte aligned
// bases and strides that keep every head row on 16 bytes.
extern "C" int ragtorch_flash_attention(const void* q, const void* k, const void* v,
                                        const void* seg_q, const void* seg_kv, void* out,
                                        int batch, int t_len, int heads, int dh,
                                        long long qsb, long long qst, long long qsh,
                                        long long ksb, long long kst, long long ksh,
                                        long long vsb, long long vst, long long vsh,
                                        int kind, void* stream) {
  using namespace ragtorch;
  const int elem = kind == 0 ? 4 : 2;
  const long long strides[9] = {qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  bool aligned = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (long long stride : strides) aligned = aligned && (stride * elem) % 16 == 0;
  if (batch <= 0 || heads <= 0 || t_len <= 0 || t_len % kBlockK != 0 || !aligned ||
      kind < 0 || kind > 2) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh};
  // 1/sqrt(dh) rounded once from double, as the reference's Python float is
  const float sm_scale = static_cast<float>(1.0 / sqrt(static_cast<double>(dh)));
  const int* sq = static_cast<const int*>(seg_q);
  const int* skv = static_cast<const int*>(seg_kv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dh) {
    case 64:
      return dispatch<64>(kind, q, k, v, sq, skv, out, batch, t_len, heads, st, sm_scale, s);
    case 128:
      return dispatch<128>(kind, q, k, v, sq, skv, out, batch, t_len, heads, st, sm_scale, s);
    case 256:
      return dispatch<256>(kind, q, k, v, sq, skv, out, batch, t_len, heads, st, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
