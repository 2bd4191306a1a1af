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
// is rounded as in the plain version (ops/flash_attention.py), so only the
// sums of the two products run in another order.
//
// q, k, v are [B, T, H, Dh] read through their strides (the head row
// contiguous, 16-byte aligned), seg_q and seg_kv [B, T] int32, out
// [B, T, H, Dh] contiguous. Dh is 64, 128 or 256 and T a multiple of 128.
//
// Bound on the H100: 4 B H T^2 Dh operations (the two products) against the
// bytes of q, k, v, out and the ids once. At bge-base width (H 12, Dh 64),
// B 4, T 1024 that is 12.9 GFLOP, 13 us at 989 TFLOP/s, against 25 MB,
// 7.5 us at 3.35 TB/s: the tensor cores set it, and more so at longer T.
//
// Design (a first kernel that is right; wgmma, TMA and warp specialisation
// are later work):
// - One block per (b, h, tile of query rows), all tiles independent: the
//   TPU's sequential kv grid axis becomes a loop inside the block, which
//   carries m, l and the accumulator in registers.
// - bf16 and f16: mma.sync m16n8k16 with f32 accumulation for both
//   products. A warp owns 16 query rows: the Q tile stays in shared memory
//   and feeds ldmatrix; the 16 x 128 scores sit in 64 f32 registers a thread,
//   are scaled, masked and exponentiated there, and become the A fragments
//   of P . V after the cast to the value dtype (the C layout of two n-tiles
//   is the A layout of one k-step). At Dh 256 two warps share 16 rows, each
//   computing the scores and owning half of the output columns, so the
//   accumulator stays at 64 registers.
// - K and V blocks stream through one shared buffer each with cp.async: K
//   of the next block loads while this block's softmax and P . V run, V of
//   the next block while its Q . K^T runs. Shared rows are padded by 16
//   bytes so ldmatrix reads are free of bank conflicts.
// - f32: CUDA-core FMAs (no TF32, which would round the inputs). A block
//   of 128 threads owns 64 query rows (32 at Dh 256); K and V stream in
//   32-key chunks, the 128-key scores and p sit in shared memory, and each
//   output sums its 128 products in key order before the update.
// Blocks are independent, there are no atomics, and the result is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ptx.cuh"

namespace ragtorch {
namespace {

constexpr int kBlockK = 128;  // the library's key block
// the library's DEFAULT_MASK_VALUE, rounded once from double as JAX does
constexpr float kMaskValue = static_cast<float>(-0.7 * 3.4028234663852886e38);

struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

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
// bf16 and f16: mma.sync
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;

template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    ptx::mma_bf16(d, a, b0, b1);
  }
};

template <>
struct Mma<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    ptx::mma_f16(d, a, b0, b1);
  }
};

// kWarps warps; kSplit warps share 16 query rows, each owning kDh / kSplit
// output columns
template <int kDh>
struct MmaShape {
  static constexpr int kWarps = kDh == 256 ? 8 : 4;
  static constexpr int kSplit = kDh == 256 ? 2 : 1;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = 16 * kWarps / kSplit;  // query rows a block
  static constexpr int kLd = kDh + 8;                 // shared row, elements
  static constexpr int kCols = kDh / kSplit;          // output columns a warp
  static constexpr int kNtO = kCols / 8;              // their n-tiles
  template <typename T>
  static constexpr int smem() {
    return (kRows + 2 * kBlockK) * kLd * (int)sizeof(T) + kBlockK * (int)sizeof(int);
  }
};

template <typename T, int kDh>
__global__ void __launch_bounds__(MmaShape<kDh>::kThreads)
    flash_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv, T* __restrict__ out, int t_len,
                     int heads, Strides st, float sm_scale) {
  using S = MmaShape<kDh>;
  constexpr int kLd = S::kLd, kThreads = S::kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = sq + S::kRows * kLd;
  T* sv = sk + kBlockK * kLd;
  int* sseg = reinterpret_cast<int*>(sv + kBlockK * kLd);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * S::kRows;
  const T* qg = q + b * st.qb + h * st.qh + row0 * st.qt;
  const T* kg = k + b * st.kb + h * st.kh;
  const T* vg = v + b * st.vb + h * st.vh;
  const int* skv = seg_kv + (long long)b * t_len;

  // group: Q, K0 and its ids; group: V0
  load_rows<T, kDh, kLd, S::kRows, kThreads>(sq, qg, st.qt, tid);
  load_rows<T, kDh, kLd, kBlockK, kThreads>(sk, kg, st.kt, tid);
  if (tid < kBlockK) ptx::cp_async<4>(ptx::smem_addr(sseg + tid), skv + tid, 4);
  ptx::cp_async_commit();
  load_rows<T, kDh, kLd, kBlockK, kThreads>(sv, vg, st.vt, tid);
  ptx::cp_async_commit();

  const int rw = (warp / S::kSplit) * 16;  // the warp's rows in the tile
  const int c0 = (warp % S::kSplit) * S::kCols;
  const int* sqg = seg_q + (long long)b * t_len + row0 + rw + g;
  const int seg0 = __ldg(sqg), seg1 = __ldg(sqg + 8);  // rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;
  float acc[S::kNtO][4];
#pragma unroll
  for (int n = 0; n < S::kNtO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  const uint32_t q_addr = ptx::smem_addr(sq + (rw + lane % 16) * kLd + (lane / 16) * 8);
  const uint32_t k_addr =
      ptx::smem_addr(sk + ((lane % 8) + (lane / 16) * 8) * kLd + ((lane / 8) % 2) * 8);
  const uint32_t v_addr =
      ptx::smem_addr(sv + ((lane % 8) + ((lane / 8) % 2) * 8) * kLd + c0 + (lane / 16) * 8);
  const int nblocks = t_len / kBlockK;
  for (int j = 0; j < nblocks; ++j) {
    ptx::cp_async_wait<1>();  // Q, K_j and its ids have landed
    __syncthreads();
    // s: C fragments of 16 n-tiles; s[n][e] is row g (+8 for e >= 2), key
    // 8n + 2tq (+1 for odd e)
    float s[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk) {
      uint32_t a[4];
      ptx::ldmatrix_x4(a, q_addr + kk * 32);
#pragma unroll
      for (int n = 0; n < 16; n += 2) {
        uint32_t bf[4];
        ptx::ldmatrix_x4(bf, k_addr + (n * 8 * kLd + kk * 16) * (int)sizeof(T));
        Mma<T>::mma(s[n], a, bf[0], bf[1]);
        Mma<T>::mma(s[n + 1], a, bf[2], bf[3]);
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int seg = sseg[n * 8 + 2 * tq + e];
        s[n][e] = score(s[n][e], sm_scale, seg == seg0);
        s[n][e + 2] = score(s[n][e + 2], sm_scale, seg == seg1);
        mx0 = fmaxf(mx0, s[n][e]);
        mx1 = fmaxf(mx1, s[n][e + 2]);
      }
    __syncthreads();  // every warp is done with K_j and its ids
    if (j + 1 < nblocks) {
      load_rows<T, kDh, kLd, kBlockK, kThreads>(sk, kg + (j + 1) * kBlockK * st.kt,
                                                st.kt, tid);
      if (tid < kBlockK)
        ptx::cp_async<4>(ptx::smem_addr(sseg + tid), skv + (j + 1) * kBlockK + tid, 4);
    }
    ptx::cp_async_commit();

    // the row statistics over the quad that holds a row
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = expf(s[n][e] - mn0);
        s[n][e + 2] = expf(s[n][e + 2] - mn1);
        sum0 += s[n][e];
        sum1 += s[n][e + 2];
      }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float corr0 = __fmul_rn(expf(m0 - mn0), l0);
    const float corr1 = __fmul_rn(expf(m1 - mn1), l1);
    l0 = __fadd_rn(sum0, corr0);
    l1 = __fadd_rn(sum1, corr1);
    m0 = mn0;
    m1 = mn1;
    const float inv0 = l0 == 0.0f ? 1.0f : __fdiv_rn(1.0f, l0);
    const float inv1 = l1 == 0.0f ? 1.0f : __fdiv_rn(1.0f, l1);
    const float sc0 = __fmul_rn(corr0, inv0), sc1 = __fmul_rn(corr1, inv1);

    // p in the value dtype: the A fragments of 8 k-steps of 16 keys
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = Mma<T>::pack(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = Mma<T>::pack(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = Mma<T>::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = Mma<T>::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }

    ptx::cp_async_wait<1>();  // V_j has landed (K_{j+1} may be in flight)
    __syncthreads();
#pragma unroll
    for (int n = 0; n < S::kNtO; n += 2) {
      float o[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t bf[4];
        ptx::ldmatrix_x4_trans(bf, v_addr + (kk * 16 * kLd + n * 8) * (int)sizeof(T));
        Mma<T>::mma(o[0], pa[kk], bf[0], bf[1]);
        Mma<T>::mma(o[1], pa[kk], bf[2], bf[3]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        acc[n + i][0] = update(acc[n + i][0], sc0, o[i][0], inv0);
        acc[n + i][1] = update(acc[n + i][1], sc0, o[i][1], inv0);
        acc[n + i][2] = update(acc[n + i][2], sc1, o[i][2], inv1);
        acc[n + i][3] = update(acc[n + i][3], sc1, o[i][3], inv1);
      }
    }
    __syncthreads();  // every warp is done with V_j
    if (j + 1 < nblocks)
      load_rows<T, kDh, kLd, kBlockK, kThreads>(sv, vg + (j + 1) * kBlockK * st.vt,
                                                st.vt, tid);
    ptx::cp_async_commit();
  }
  ptx::cp_async_wait<0>();

  // out rows row0 + rw + g (+8), two adjacent columns a store
  const long long orow = (long long)heads * kDh;
  T* og = out + ((long long)b * t_len + row0 + rw + g) * orow + (long long)h * kDh + c0 +
          2 * tq;
#pragma unroll
  for (int n = 0; n < S::kNtO; ++n) {
    *reinterpret_cast<uint32_t*>(og + n * 8) = Mma<T>::pack(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(og + 8 * orow + n * 8) = Mma<T>::pack(acc[n][2], acc[n][3]);
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

template <typename T, typename Kernel>
int launch(Kernel kernel, int threads, int rows, int smem, const void* q, const void* k,
           const void* v, const int* seg_q, const int* seg_kv, void* out, int batch,
           int t_len, int heads, const Strides& st, float sm_scale, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(t_len / rows, heads, batch);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), seg_q,
      seg_kv, static_cast<T*>(out), t_len, heads, st, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T, int kDh>
int launch_mma(const void* q, const void* k, const void* v, const int* seg_q,
               const int* seg_kv, void* out, int batch, int t_len, int heads,
               const Strides& st, float sm_scale, cudaStream_t stream) {
  using S = MmaShape<kDh>;
  return launch<T>(flash_mma_kernel<T, kDh>, S::kThreads, S::kRows,
                   S::template smem<T>(), q, k, v, seg_q, seg_kv, out, batch, t_len,
                   heads, st, sm_scale, stream);
}

template <int kDh>
int launch_f32(const void* q, const void* k, const void* v, const int* seg_q,
               const int* seg_kv, void* out, int batch, int t_len, int heads,
               const Strides& st, float sm_scale, cudaStream_t stream) {
  using S = F32Shape<kDh>;
  return launch<float>(flash_f32_kernel<kDh>, S::kThreads, S::kRows, S::smem(), q, k, v,
                       seg_q, seg_kv, out, batch, t_len, heads, st, sm_scale, stream);
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
      return launch_mma<__nv_bfloat16, kDh>(q, k, v, seg_q, seg_kv, out, batch, t_len,
                                            heads, st, sm_scale, stream);
    case 2:
      return launch_mma<__half, kDh>(q, k, v, seg_q, seg_kv, out, batch, t_len, heads,
                                     st, sm_scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ragtorch

// q, k, v: [B, T, H, dh] of `kind` (0 f32, 1 bf16, 2 f16) with element
// strides (b, t, h) each, the head row contiguous; seg_q, seg_kv: [B, T]
// int32; out: [B, T, H, dh] contiguous. Needs T % 128 == 0, dh in {64, 128,
// 256}, 16-byte aligned bases and strides that keep every head row on 16
// bytes.
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
