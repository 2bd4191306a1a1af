// PQ4 asymmetric-distance (ADC) scores over the batch's unique probed IVF
// buckets, for Hopper (sm_90a).
//
// Replaces the TPU kernel rag_inference_pipeline_tpu/ops/pq.py::_adc4_kernel
// (launched by ivfpq4_search_dedup):
//   scores[s, b, r] = sum over g < m/8 of
//                     sum over j < 8 of lut[b, (8g+j)*16 + codes[slots[s], r, 8g+j]]
// for every unique probed bucket slot s, every query b < b_pad and every
// bucket position r < cap, from per-query bf16 lookup tables (16 entries per
// subspace) and 4-bit codes stored one per byte (only the first m of the
// m_store code columns are read). Positions at or past sizes[slots[s]] hold no
// vector: the kernel does not read them and writes 0 there. (The TPU kernel
// scores the zero codes of those rows; the caller masks both by id.) The
// coarse term, the member mask and the top-k stay outside, as in the
// reference.
//
// Bound on the H100: the function needs the filled code rows of the unique
// buckets once (m bytes each) and writes the [n_slots, b_pad, cap] f32
// scores. At B=8 over the 1M PQ4 listing (m=192, nlist 4096, cap 640, ~512
// slots of ~244 filled rows) that is ~24 MB of codes and 10.5 MB of scores,
// ~0.01 ms at 3.35 TB/s; at B=64 (4096 slots) the 671 MB of scores set it,
// ~0.2 ms. The work is one table lookup and one f32 add per (query, row,
// subspace): 1.9e8 at B=8, 1.2e10 at B=64. A lookup is a data-dependent read
// of shared memory, one 4-byte bank access per lane per clock, so in practice
// the lookups bound it (~26 us at B=8, ~1.7 ms at B=64 on 132 SMs); the
// TPU's one-hot matmul form would move them onto the tensor cores (a later
// redesign).
//
// Design: one block per (slot, tile of kRowTile positions, tile of kQTile
// queries); the block reads its slot id itself. It stages its queries' tables
// (kQTile x m*16 bf16: 48 KiB at m=192, above the static limit, so dynamic
// shared memory) and the tile's filled code rows (the first m bytes, rounded
// up to 16) with 16-byte loads. A staged code row is an odd number of 16-byte
// chunks, so the 16-byte reads of 8 neighbouring rows (one phase of a warp's
// load) touch distinct banks; a warp's table reads for one (query, subspace)
// fall in one 32-byte window, so they are broadcasts or distinct banks. Each
// thread owns one position and the kQTile queries: per group of 8 subspaces
// it sums the 8 table entries in ascending subspace order and adds the group's
// sum to its running sum, as the TPU kernel adds one group's product per
// step. bf16 entries widen to f32 by a 16-bit shift. Blocks are independent,
// there are no atomics, and the result is deterministic; integer-valued
// tables give exact sums.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowTile = 64;
constexpr int kQTile = 8;
constexpr int kThreads = kRowTile;

// Bytes of one staged code row: an odd number of 16-byte chunks holding the
// first m bytes of the row.
__host__ __device__ inline int staged_row_bytes(int m) {
  return 16 * (((m + 15) / 16) | 1);
}

__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// acc[k] += the sum, in ascending subspace order, of query k's table entries
// for the 8 codes packed in (lo, hi) (one code per byte, subspace 8g first).
// `t` points at the group's 128 table entries of query 0; queries are lut_w
// entries apart.
__device__ __forceinline__ void add_group(uint32_t lo, uint32_t hi,
                                          const uint16_t* t, int lut_w,
                                          float (&acc)[kQTile]) {
  int idx[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    idx[j] = j * 16 + ((lo >> (8 * j)) & 15u);
    idx[4 + j] = (4 + j) * 16 + ((hi >> (8 * j)) & 15u);
  }
#pragma unroll
  for (int k = 0; k < kQTile; ++k) {
    const uint16_t* tk = t + k * lut_w;
    float gs = widen(tk[idx[0]]);
#pragma unroll
    for (int j = 1; j < 8; ++j) gs += widen(tk[idx[j]]);
    acc[k] += gs;
  }
}

__global__ void __launch_bounds__(kThreads)
ivfpq4_adc_kernel(const uint16_t* __restrict__ lut,    // [b_pad, m*16] bf16
                  const uint8_t* __restrict__ codes,   // [nlist, cap, m_store]
                  const int* __restrict__ slots,       // [n_slots]
                  const int* __restrict__ sizes,       // [nlist]
                  float* __restrict__ out,             // [n_slots, b_pad, cap]
                  int b_pad, int m, int cap, int m_store) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lut_w = m * 16;
  uint16_t* sh_lut = reinterpret_cast<uint16_t*>(smem);  // [kQTile, lut_w]
  unsigned char* sh_codes = smem + (size_t)kQTile * lut_w * 2;
  const int row_bytes = staged_row_bytes(m);  // sh_codes: [kRowTile, row_bytes]

  const int r = threadIdx.x;
  const int s = blockIdx.x;
  const int c0 = blockIdx.y * kRowTile;
  const int q0 = blockIdx.z * kQTile;
  const int c = c0 + r;
  const int cluster = slots[s];
  const int size = min(sizes[cluster], cap);
  float* o = out + ((size_t)s * b_pad + q0) * cap + c;
  if (c0 >= size) {  // block-uniform: the tile holds no vector
    if (c < cap) {
#pragma unroll
      for (int k = 0; k < kQTile; ++k) o[(size_t)k * cap] = 0.0f;
    }
    return;
  }

  // the kQTile tables are one contiguous run of 32*m bytes per query
  const uint4* lsrc = reinterpret_cast<const uint4*>(lut + (size_t)q0 * lut_w);
  uint4* ldst = reinterpret_cast<uint4*>(sh_lut);
  for (int i = r; i < kQTile * lut_w / 8; i += kThreads) ldst[i] = lsrc[i];
  const int rows = min(kRowTile, size - c0);
  const int chunks = (m + 15) / 16;
  const uint8_t* bucket = codes + ((size_t)cluster * cap + c0) * m_store;
  for (int i = r; i < rows * chunks; i += kThreads) {
    const int row = i / chunks;
    const int ch = i - row * chunks;
    *reinterpret_cast<uint4*>(sh_codes + row * row_bytes + ch * 16) =
        *reinterpret_cast<const uint4*>(bucket + (size_t)row * m_store + ch * 16);
  }
  __syncthreads();
  if (c >= cap) return;

  float acc[kQTile];
#pragma unroll
  for (int k = 0; k < kQTile; ++k) acc[k] = 0.0f;
  if (c < size) {
    const unsigned char* mine = sh_codes + r * row_bytes;
    const int groups = m / 8;
    for (int g = 0; g < groups; g += 2) {
      const uint4 w = *reinterpret_cast<const uint4*>(mine + g * 8);
      add_group(w.x, w.y, sh_lut + g * 128, lut_w, acc);
      if (g + 1 < groups) add_group(w.z, w.w, sh_lut + (g + 1) * 128, lut_w, acc);
    }
  }
#pragma unroll
  for (int k = 0; k < kQTile; ++k) o[(size_t)k * cap] = acc[k];
}

}  // namespace

// lut: bf16 [b_pad, m*16]; codes: uint8 [nlist, cap, m_store], 16-byte
// aligned rows. Needs b_pad % 8 == 0, m % 8 == 0, m_store % 16 == 0 and
// m_store >= m rounded up to 16.
extern "C" int ragtorch_ivfpq4_adc(const void* lut, const void* codes,
                                   const void* slots, const void* sizes,
                                   void* out, int b_pad, int m, int n_slots,
                                   int cap, int m_store, void* stream) {
  if (b_pad % kQTile != 0 || m % 8 != 0 || m <= 0 || m_store % 16 != 0 ||
      m_store < (m + 15) / 16 * 16) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)kQTile * m * 16 * 2 +
                      (size_t)kRowTile * staged_row_bytes(m);
  cudaError_t err = cudaFuncSetAttribute(
      ivfpq4_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_slots, (cap + kRowTile - 1) / kRowTile, b_pad / kQTile);
  ivfpq4_adc_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(lut), static_cast<const uint8_t*>(codes),
      static_cast<const int*>(slots), static_cast<const int*>(sizes),
      static_cast<float*>(out), b_pad, m, cap, m_store);
  return (int)cudaGetLastError();
}
