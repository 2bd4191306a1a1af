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
// goes, with no division at the end. In bf16 and f16 every product and
// sum of that update is rounded as in the plain version
// (ops/flash_attention.py: __fmul_rn, __fadd_rn, the IEEE 1 / l', the
// accurate expf), and p . v goes into a fresh accumulator each block before
// the update, so only the sums of the two matrix products and the row sums
// of p run in another order; f32 folds 1 / l' into p (below).
//
// q, k, v are [B, T, H, Dh] read through their strides (the head row
// contiguous, 16-byte aligned), seg_q and seg_kv [B, T] int32 (seg_kv on
// 16 bytes in bf16 and f16), out [B, T, H, Dh] contiguous. Dh is 64, 128 or 256 and T a
// multiple of 128.
//
// Floors on the H100 (tools/bench_flash.py prints both a case):
// - tensor: the two products, 4 B H T^2 Dh operations at 989 TFLOP/s; bge-
//   base heads (H 12, Dh 64), B 4: 0.0130 ms at T 1024, 0.208 at T 4096
//   (the bytes of q, k, v, out and the ids once take 0.0075 ms at T 1024);
//   f32 does six bf16 products of that work: 0.0782 ms at T 1024;
// - CUDA cores: the FP32-pipe instructions a score of the main loop (the
//   scale, the mask where a block needs it, the max, the subtraction, the
//   accurate expf's six, the sum, half a pack (f32: the split of p and the
//   fold of 1 / l'), and the update's three an output element a block)
//   over 132 SMs x 128 lanes, and its MUFU.EX2 (one a score) over 132 x
//   16, at the SM clock: bench_flash.py counts them in this kernel's SASS.
//   In bf16 and f16 at Dh 64 this floor is the larger; at Dh 128 and 256
//   the tensor floor is.
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
//
// Design of the f32 kernel: the same products on the tensor cores, exact
// to f32's 24 bits by a three-way bf16 split (x = x1 + x2 + x3, x1 =
// bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2), every difference
// exact), where the CUDA-core FMA kernel it replaces reached 0.38 of the
// FMA floor and lost to SDPA (TF32 would round the inputs; three TF32
// products cost what six bf16 ones do, and TF32 wgmma takes no MN-major
// V):
// - each product a b is the sum of six, smallest first: a3 b1, a2 b2, a1
//   b3, a2 b1, a1 b2, a1 b1, all into one f32 accumulator by wgmma (S: SS,
//   m64n128k16; P V: RS, m64n64k16, V MN-major as in bf16). The dropped
//   terms are ~2^-24 of a b.
// - the producer warpgroup splits: one thread keeps two f32 boxes (32
//   columns, 128 keys or Q's rows) in flight by TMA, unswizzled; its 128
//   threads write each box's three parts in the 128-byte swizzle TMA
//   gives the 16-bit kernel, then fence them for the async proxy. Q's parts
//   stay for the block; each 64-column panel of K or V takes a ring slot
//   of its three parts (48 KB; 3 slots at Dh 64, 2 above), and two key
//   blocks' ids a buffer of their own. Shared memory (224 KB of 227) sets
//   the shape: 128 query rows (two consumer warpgroups in turns, as bf16)
//   at Dh 64 and 128, 64 rows (one) at Dh 256. Where K's panels all fit
//   the ring (Dh 64, 128) S takes the six products smallest first over the
//   whole head row; at Dh 256 its four panels stream through two slots,
//   smallest first a panel (later panels' small terms then meet a larger
//   sum: more error than one order over the row).
// - P's parts are split in registers (pa[3][8][4], the layout pack_p
//   uses); p is not rounded to v's dtype, which is f32. To free P V's
//   fresh accumulator (acc 128 + pa 96 registers a thread at Dh 256),
//   1 / l' is folded into p before the split and acc is scaled by alpha l
//   / l' before P V adds to it: the update's roundings move, not its value.
// - the softmax is the 16-bit kernel's (softmax_block), in f32.
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
// (`release`, unless null), the row statistics (m and l of each row), p = exp(s - m')
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
  if (release != nullptr && lane == 0) ptx::mbar_arrive(release);

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
// f32: the three-way bf16 split on wgmma
// ---------------------------------------------------------------------------

template <int kDh>
struct SplitShape {
  // two consumer warpgroups of 64 rows; one at Dh 256, where Q's three
  // parts of 128 rows would take 192 KB
  static constexpr int kConsumers = kDh == 256 ? 1 : 2;
  static constexpr int kRows = 64 * kConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);  // + the producer's
  static constexpr int kPanels = kDh / 64;                 // 64-column panels
  static constexpr int kPart = kBlockK * 128;              // a part of a K or V panel
  static constexpr int kSlot = 3 * kPart;                  // a ring slot: a panel's parts
  static constexpr int kQPanel = kRows * 128;
  static constexpr int kQPart = kPanels * kQPanel;
  static constexpr int kQBytes = 3 * kQPart;
  static constexpr int kSlots = kDh == 64 ? 3 : 2;
  // f32 boxes of 32 columns (one 128-byte row a key) staged for the split
  static constexpr int kUnits = kDh / 32;  // boxes a head row
  static constexpr int kStages = 2;
  static constexpr int kStage = kBlockK * 128;
  // 1 KB to align the tiles on the swizzle's 1,024 bytes, Q's parts, the
  // ring, the staging boxes, two key blocks' ids, the full and empty
  // barriers of the ring, the staging barriers and Q's
  static constexpr int kSmem = 1024 + kQBytes + kSlots * kSlot + kStages * kStage +
                               2 * kBlockK * 4 + (2 * kSlots + kStages + 1) * 8;
  static_assert(kSmem <= 232448, "over the 227 KB a block can have");
};

// the six products of the split, smallest first: a_i b_k with parts
// (i, k) = (3, 1), (2, 2), (1, 3), (2, 1), (1, 2), (1, 1), 0-based here
__device__ __forceinline__ constexpr int term_a(int t) { return t == 0 ? 2 : t == 1 || t == 3 ? 1 : 0; }
__device__ __forceinline__ constexpr int term_b(int t) { return t == 2 ? 2 : t == 1 || t == 4 ? 1 : 0; }

// x = x1 + x2 + x3 exactly (24 mantissa bits as three of 8) for a pair,
// each part a packed bf16x2: x1 = bf16(x), x2 = bf16(x - x1), x3 =
// bf16(x - x1 - x2); both differences are exact
__device__ __forceinline__ void split2(float a, float b, uint32_t& w1, uint32_t& w2,
                                       uint32_t& w3) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  w1 = *reinterpret_cast<uint32_t*>(&h);
  float2 f = __bfloat1622float2(h);
  a = __fsub_rn(a, f.x);
  b = __fsub_rn(b, f.y);
  h = __floats2bfloat162_rn(a, b);
  w2 = *reinterpret_cast<uint32_t*>(&h);
  f = __bfloat1622float2(h);
  h = __floats2bfloat162_rn(__fsub_rn(a, f.x), __fsub_rn(b, f.y));
  w3 = *reinterpret_cast<uint32_t*>(&h);
}

// S (+)= Q K^T for a warpgroup's 64 rows and a 128-key block over kN
// 64-column panels from panel p0 (K's at k_addr[0 .. kN)): the six
// products, smallest first over all kN panels, 4 k16 steps a panel, into
// one f32 accumulator (fresh at p0 = 0)
template <int kN, int kQPanel, int kQPart, int kPart>
__device__ __forceinline__ void issue_s_split(float (&s)[64], uint32_t q_addr,
                                              const uint32_t (&k_addr)[kN], int p0) {
#pragma unroll
  for (int t = 0; t < 6; ++t)
#pragma unroll
    for (int p = 0; p < kN; ++p)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ptx::wgmma_m64n128k16_ss<true>(
            s, ptx::wgmma_desc_sw128(q_addr + term_a(t) * kQPart + (p0 + p) * kQPanel) + 2 * kk,
            ptx::wgmma_desc_sw128(k_addr[p] + term_b(t) * kPart) + 2 * kk, p0 + t + p + kk > 0);
}

// acc (64 output columns) += P . V over a 128-key V panel: the six products,
// 8 k16 steps each, P's parts from registers
template <int kPart>
__device__ __forceinline__ void issue_pv_split(float (&acc)[32], const uint32_t (&pa)[3][8][4],
                                               uint32_t v_addr) {
#pragma unroll
  for (int t = 0; t < 6; ++t)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      ptx::wgmma_m64k16_rs<true, 64>(
          acc, pa[term_a(t)][kk],
          ptx::wgmma_desc_sw128_mn(v_addr + term_b(t) * kPart + kk * 2048, kPart), 1);
}

// p's three parts: the A fragments of the 8 k16 steps of P . V, as pack_p
__device__ __forceinline__ void split_p(const float (&s)[64], uint32_t (&pa)[3][8][4]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
    for (int w = 0; w < 4; ++w)
      split2(s[8 * kk + 2 * w], s[8 * kk + 2 * w + 1], pa[0][kk][w], pa[1][kk][w], pa[2][kk][w]);
#pragma unroll
    for (int i = 0; i < 3; ++i) ptx::fence_regs(pa[i][kk]);
  }
}

template <int kDh>
__global__ void __launch_bounds__(SplitShape<kDh>::kThreads, 1)
    flash_f32_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, float* __restrict__ out, int t_len,
                     int heads, int perms, float sm_scale) {
  using S = SplitShape<kDh>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* sq = smem;
  uint8_t* tiles = sq + S::kQBytes;
  uint8_t* stage = tiles + S::kSlots * S::kSlot;
  int* ids = reinterpret_cast<int*>(stage + S::kStages * S::kStage);
  uint64_t* full = reinterpret_cast<uint64_t*>(ids + 2 * kBlockK);
  uint64_t* empty = full + S::kSlots;
  uint64_t* staged = empty + S::kSlots;
  uint64_t* qbar = staged + S::kStages;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * S::kRows;
  const int nb = t_len / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S::kSlots; ++s) {
      ptx::mbar_init(&full[s], 128);
      ptx::mbar_init(&empty[s], 4 * S::kConsumers);
    }
    for (int s = 0; s < S::kStages; ++s) ptx::mbar_init(&staged[s], 1);
    ptx::mbar_init(qbar, 128);
    ptx::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == S::kConsumers) {
    // The producer warpgroup. Units of work, in order: Q's kUnits boxes,
    // then for each key block K's and V's. Thread 0 keeps kStages boxes of
    // f32 in flight by TMA; every thread splits its share of a staged box
    // into the three bf16 parts, written in the 128-byte swizzle TMA would
    // give them (16-byte chunk c of row r at chunk c ^ (r % 8)): Q's parts
    // once, each K or V panel (two boxes) into a ring slot with, for K's
    // first panel, the block's key ids (two blocks' apart).
    if constexpr (S::kConsumers == 2) ptx::setmaxnreg_dec<56>();
    const int pt = threadIdx.x - S::kConsumers * 128;
    const int units = S::kUnits * (1 + 2 * nb);
    const CUtensorMap *mq = &map_q, *mk = &map_k, *mv = &map_v;
    auto issue = [&](int u) {
      uint64_t* bar = &staged[u % S::kStages];
      uint8_t* dst = stage + (u % S::kStages) * S::kStage;
      if (u < S::kUnits) {
        ptx::mbar_arrive_expect_tx(bar, S::kRows * 128);
        load_box(dst, mq, perms & 63, 32 * u, h, row0, b, bar);
      } else {
        const int r = (u - S::kUnits) % (2 * S::kUnits), j = (u - S::kUnits) / (2 * S::kUnits);
        const bool is_v = r >= S::kUnits;
        ptx::mbar_arrive_expect_tx(bar, kBlockK * 128);
        load_box(dst, is_v ? mv : mk, (perms >> (is_v ? 12 : 6)) & 63, 32 * (r % S::kUnits), h,
                 j * kBlockK, b, bar);
      }
    };
    if (pt == 0)
      for (int u = 0; u < S::kStages && u < units; ++u) issue(u);
    // thread pt takes float4 column c4 of the box, 16 rows a pass, two rows
    // 4 apart in each half-warp so that its 8-byte stores meet no conflict
    const int c4 = pt % 8, q16 = pt / 8;
    const int rr = ((q16 & 1) << 2) | ((q16 >> 1) & 3) | (q16 & 8);
    for (int u = 0; u < units; ++u) {
      uint8_t* dst;
      int rows, half, slot = -1;
      if (u < S::kUnits) {
        dst = sq + (u / 2) * S::kQPanel;
        rows = S::kRows;
        half = u % 2;
      } else {
        const int r = (u - S::kUnits) % (2 * S::kUnits), j = (u - S::kUnits) / (2 * S::kUnits);
        const int panel = 2 * S::kPanels * j + r / 2;  // K_j's panels, then V_j's
        slot = panel % S::kSlots;
        half = r % 2;
        rows = kBlockK;
        dst = tiles + slot * S::kSlot;
        if (half == 0) {
          if (panel >= S::kSlots) ptx::mbar_wait(&empty[slot], (panel / S::kSlots - 1) & 1);
          // block j's ids: block j - 2's were read before that slot's
          // last panel was released
          if (r == 0)
            ids[(j % 2) * kBlockK + pt] = __ldg(seg_kv + (long long)b * t_len + j * kBlockK + pt);
        }
      }
      const int part = u < S::kUnits ? S::kQPart : S::kPart;
      const uint8_t* src = stage + (u % S::kStages) * S::kStage;
      ptx::mbar_wait(&staged[u % S::kStages], (u / S::kStages) & 1);
      for (int i = 0; i < rows / 16; ++i) {
        const int row = 16 * i + rr;
        const float4 x = *reinterpret_cast<const float4*>(src + row * 128 + c4 * 16);
        uint2 w[3];
        split2(x.x, x.y, w[0].x, w[1].x, w[2].x);
        split2(x.z, x.w, w[0].y, w[1].y, w[2].y);
        const int chunk = half * 4 + c4 / 2;
        const int off = row * 128 + ((chunk ^ (row & 7)) << 4) + (c4 & 1) * 8;
#pragma unroll
        for (int p = 0; p < 3; ++p) *reinterpret_cast<uint2*>(dst + p * part + off) = w[p];
      }
      ptx::bar_sync(3, 128);  // the staged box is read: refill it
      if (pt == 0 && u + S::kStages < units) issue(u + S::kStages);
      if (u == S::kUnits - 1 || (u >= S::kUnits && half == 1)) {
        ptx::fence_proxy_async();  // the parts, for the consumers' wgmma
        ptx::mbar_arrive(slot < 0 ? qbar : &full[slot]);
      }
    }
    return;
  }
  if constexpr (S::kConsumers == 2) ptx::setmaxnreg_inc<224>();

  // thread (warp, g, tq) of the warpgroup holds rows 16 warp + g and + 8 of
  // its 64: s[4n + 2r + e] is row + 8r, key 8n + 2tq + e; acc[c][4n + 2r + e]
  // the same rows at output column 64c + 8n + 2tq + e
  const int t = threadIdx.x % 128, lane = t % 32, tq = lane % 4;
  const int row = row0 + wg * 64 + (t / 32) * 16 + lane / 4;
  const int* sqg = seg_q + (long long)b * t_len + row;
  const int seg0 = __ldg(sqg), seg1 = __ldg(sqg + 8);
  float acc[S::kPanels][32];
#pragma unroll
  for (int c = 0; c < S::kPanels; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, sc[2], inv[2];
  uint32_t pa[3][8][4];
  float s[64];
  const uint32_t q_addr = ptx::smem_addr(sq) + wg * 64 * 128;
  const uint32_t tiles_addr = ptx::smem_addr(tiles);
  // panel i (K_j's at 2 kPanels j + p, V_j's kPanels later) sits in slot
  // i % kSlots, in its (i / kSlots)-th use
  auto wait_full = [&](int i) { ptx::mbar_wait(&full[i % S::kSlots], (i / S::kSlots) & 1); };
  auto slot_addr = [&](int i) { return tiles_addr + (i % S::kSlots) * S::kSlot; };
  auto release = [&](int i) {
    __syncwarp();
    if (lane == 0) ptx::mbar_arrive(&empty[i % S::kSlots]);
  };
  // ping-pong, as the 16-bit kernel: consumer w issues S after barrier
  // 1 + w, then lets the other go; consumer 0 goes first
  if (S::kConsumers == 2 && wg == 0) ptx::bar_arrive(1, 256);
  ptx::mbar_wait(qbar, 0);

  for (int j = 0; j < nb; ++j) {
    const int pk = 2 * S::kPanels * j, pv = pk + S::kPanels;
    if constexpr (S::kPanels <= S::kSlots) {
      // K's panels all in the ring: the six products smallest first over
      // the whole head row
      uint32_t k_addr[S::kPanels];
#pragma unroll
      for (int p = 0; p < S::kPanels; ++p) {
        wait_full(pk + p);
        k_addr[p] = slot_addr(pk + p);
      }
      if constexpr (S::kConsumers == 2) ptx::bar_sync(1 + wg, 256);
      ptx::wgmma_fence();
      issue_s_split<S::kPanels, S::kQPanel, S::kQPart, S::kPart>(s, q_addr, k_addr, 0);
      ptx::wgmma_commit();
      if constexpr (S::kConsumers == 2) ptx::bar_arrive(2 - wg, 256);
      ptx::wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < S::kPanels; ++p) release(pk + p);
    } else {
      // Dh 256: the panels stream through the ring, each released once its
      // products are done while the next one's run (wait_group 1)
#pragma unroll
      for (int p = 0; p < S::kPanels; ++p) {
        wait_full(pk + p);
        const uint32_t k_addr[1] = {slot_addr(pk + p)};
        ptx::wgmma_fence();
        issue_s_split<1, S::kQPanel, S::kQPart, S::kPart>(s, q_addr, k_addr, p);
        ptx::wgmma_commit();
        if (p > 0) {
          ptx::wgmma_wait<1>();
          release(pk + p - 1);
        }
      }
      ptx::wgmma_wait<0>();
      release(pk + S::kPanels - 1);
    }
    ptx::fence_regs(s);
    softmax_block(s, ids + (j % 2) * kBlockK, nullptr, seg0, seg1, sm_scale, m, l, sc, inv);
    // the update acc * (alpha l / l') + (p . v) / l', with 1 / l' folded
    // into p before the split and acc scaled before P . V adds to it
#pragma unroll
    for (int i = 0; i < 64; ++i) s[i] = __fmul_rn(s[i], inv[(i / 2) % 2]);
#pragma unroll
    for (int c = 0; c < S::kPanels; ++c)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[c][i] = __fmul_rn(acc[c][i], sc[(i / 2) % 2]);
    split_p(s, pa);
#pragma unroll
    for (int p = 0; p < S::kPanels; ++p) {
      wait_full(pv + p);
      ptx::wgmma_fence();
      issue_pv_split<S::kPart>(acc[p], pa, slot_addr(pv + p));
      ptx::wgmma_commit();
      if (p > 0) {
        ptx::wgmma_wait<1>();
        release(pv + p - 1);
      }
    }
    ptx::wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < S::kPanels; ++p) ptx::fence_regs(acc[p]);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) ptx::fence_regs(pa[i][kk]);  // read until here
    release(pv + S::kPanels - 1);
  }
  // the other consumer's last turn, so that no arrival outlives the block
  if (S::kConsumers == 2 && wg == 0) ptx::bar_sync(1, 256);

  // out rows `row` and row + 8, two adjacent columns a store
  const long long orow = (long long)heads * kDh;
  float* og = out + ((long long)b * t_len + row) * orow + (long long)h * kDh + 2 * tq;
#pragma unroll
  for (int c = 0; c < S::kPanels; ++c)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      *reinterpret_cast<float2*>(og + 64 * c + 8 * n) = make_float2(acc[c][4 * n], acc[c][4 * n + 1]);
      *reinterpret_cast<float2*>(og + 8 * orow + 64 * c + 8 * n) =
          make_float2(acc[c][4 * n + 2], acc[c][4 * n + 3]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

// A [B, T, H, Dh] view with element strides (sb, st, sh) as a 4-D tensor
// map of `type` (`elem` bytes): Dh innermost, then H, T and B in rising
// stride (a dimension of size 1 never steps: it goes last), in boxes of
// `cols` x 1 x `rows` (along T) x 1 with `swizzle`. `perm` gets the map
// dimension of H, T and B, 2 bits each.
bool encode_heads(CUtensorMap* map, const void* base, CUtensorMapDataType type, int elem,
                  int batch, int t_len, int heads, int dh, long long sb, long long st,
                  long long sh, int cols, int rows, CUtensorMapSwizzle swizzle, int* perm) {
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
  cuuint32_t box[4] = {(cuuint32_t)cols, 1, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[i + 1] = (cuuint64_t)d[i].size;
    strides[i] = (cuuint64_t)(d[i].stride * elem);
    if (d[i].which == 1) box[i + 1] = (cuuint32_t)rows;
    pos[d[i].which] = i + 1;
  }
  *perm = pos[0] | pos[1] << 2 | pos[2] << 4;
  return fn(map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the 16-bit kernel's maps: 64-element boxes with the 128-byte swizzle
bool encode_16bit(CUtensorMap* map, const void* base, bool bf16, int batch, int t_len,
                  int heads, int dh, long long sb, long long st, long long sh, int rows,
                  int* perm) {
  return encode_heads(map, base,
                      bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
                      2, batch, t_len, heads, dh, sb, st, sh, 64, rows,
                      CU_TENSOR_MAP_SWIZZLE_128B, perm);
}

// the f32 kernel's maps: boxes of 32 floats (one 128-byte row), unswizzled,
// for the producer to split
bool encode_f32(CUtensorMap* map, const void* base, int batch, int t_len, int heads, int dh,
                long long sb, long long st, long long sh, int rows, int* perm) {
  return encode_heads(map, base, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, batch, t_len, heads, dh,
                      sb, st, sh, 32, rows, CU_TENSOR_MAP_SWIZZLE_NONE, perm);
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
      !encode_16bit(&mq, q, kBf16, batch, t_len, heads, kDh, st.qb, st.qt, st.qh, S::kRows,
                    &pq) ||
      !encode_16bit(&mk, k, kBf16, batch, t_len, heads, kDh, st.kb, st.kt, st.kh, kBlockK,
                    &pk) ||
      !encode_16bit(&mv, v, kBf16, batch, t_len, heads, kDh, st.vb, st.vt, st.vh, kBlockK,
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
  using S = SplitShape<kDh>;
  CUtensorMap mq, mk, mv;
  int pq, pk, pv;
  if (!encode_f32(&mq, q, batch, t_len, heads, kDh, st.qb, st.qt, st.qh, S::kRows, &pq) ||
      !encode_f32(&mk, k, batch, t_len, heads, kDh, st.kb, st.kt, st.kh, kBlockK, &pk) ||
      !encode_f32(&mv, v, batch, t_len, heads, kDh, st.vb, st.vt, st.vh, kBlockK, &pv))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<kDh>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid(t_len / S::kRows, heads, batch);
  flash_f32_kernel<kDh><<<grid, S::kThreads, S::kSmem, stream>>>(
      mq, mk, mv, seg_q, seg_kv, static_cast<float*>(out), t_len, heads,
      pq | pk << 6 | pv << 12, sm_scale);
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
