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
// (4,096 x 896 -> 4,864) is 35.7 G operations, 18 us; Llama-3.1-8B's
// (4,096 x 4,096 -> 2 x 14,336) 962 G, 486 us. At 72 rows a product streams
// its weights once and is bound by bytes (Qwen2.5-0.5B's verify down, 72 x
// 4,864 -> 896: 4.4 MB, 1.3 us; the 8B's, 72 x 14,336 -> 4,096: 58.7 MB, 18
// us). Where the weights are small the time goes to how many SMs stream at
// once and to the latency of the first loads; where they are large (the
// 8B's), to how often each weight byte crosses from HBM to L2 and from L2
// to an SM, which the plan and the tile order keep near once.
//
// Design:
// - Operands: the int8 form of wgmma takes only K-major operands, and the
//   port's layouts are K-major: xq [M, K] and the weights [N, K]
//   (QuantizedLinear.q). A block computes a kBM x kBN output tile: one or
//   two consumer warpgroups (kBM 64 or 128 rows), each m64nNk32 on its 64
//   rows, plus one producer warp.
// - Group: the column tiles of every weight of the group (q/k/v, gate/up;
//   up to three, each with its own tensor map, scales, bias and output)
//   make one sequence of tiles.
// - Grid and tile order (by the linear block index; ops/w8a8.py::
//   _gemm_tiles is its twin): a cluster of `split` x `share` consecutive
//   blocks (one of the two is 1) takes one column tile. The clusters walk bands of `band` column
//   tiles: within a band, every column of the band for a group of `share`
//   row tiles, then the next group. A band of about a wave's blocks keeps a
//   wave's weights in L2 while every row tile reads them (the 8B's prefill
//   gate/up: 8 of 224 column tiles by 32 row tiles); `band` = every column
//   tile is the order by rows (a wave over all weights of a few row tiles),
//   launched as a 2-D grid (x the clusters of a group, y the group).
// - Plan (ops/w8a8.py::_gemm_plan, host arithmetic): where 128-column
//   tiles give at least half as many blocks as SMs (prefill, the heads,
//   gate/up from 72 rows), a block takes its tile over all of K; with 2 to
//   4 row tiles (the engine's verify round, 288 rows), the row tiles' blocks
//   of a column tile form a cluster and share each weight tile (`share`),
//   and so do pairs of row tiles at prefill where the weights are large.
//   Where 128-column tiles give fewer blocks and one tile of 32 to 128
//   token rows holds M (the 8B's verify round's 72 rows, its engine step's
//   32), the product is swapped (below) and K splits over a cluster of 2 to
//   8 blocks (`split`), so that each weight byte leaves L2 once and xq's
//   re-reads stay M / 128 of the weights. Else (Qwen2.5-0.5B's narrow
//   weights) tiles narrow to 64 x 64 (one consumer warpgroup), K split or
//   not.
// - Swapped product (kSwapK): wgmma's M side is 64 rows, its N side a
//   multiple of 16. With 72 token rows on the M side, 56 of a 128-row
//   tile's rows are zeros the tensor cores still multiply; so the weight
//   tile takes the M side (64 rows a consumer warpgroup) and the token
//   rows the N side (n80 for 72 rows, n32 for 32), and the sums of a
//   thread's registers are the transpose of the unswapped ones' (the split
//   epilogue stores them a word at a time into the owner's partials).
// - Loads: the producer's lane 0 issues 2-D TMA tile loads (kBM or kBN rows
//   x 128 bytes of K, 128-byte swizzle) of both operands into a ring of
//   stages, each guarded by a "full" mbarrier (the loads' bytes) and an
//   "empty" one (one arrival per consumer warp once its wgmmas on the stage
//   have completed). TMA fills rows past M or N and bytes past K with
//   zeros, so ragged edges add nothing to the sums. The instances of the
//   narrow and the wide plans take ~96 KB of stages so that two blocks
//   share an SM, one's epilogue overlapping the other's products; the
//   swapped split instances and the `deep` shared ones take one block an
//   SM and as many stages as its shared memory holds (6 to 8), to keep an
//   SM's loads in flight where the grid is about one block an SM.
// - Shared weight tiles: block 0 of the cluster loads the weight tile once
//   into every block's stage (TMA multicast, one L2 read for the cluster);
//   each block loads its own rows of xq. Block 0 refills a stage only once
//   every block's consumers have released it: they arrive on block 0's
//   "empty" barrier as on their own. Every block's barriers are set up
//   before the cluster's first load (a cluster barrier), and no block exits
//   while another may still arrive on its barriers (a second one).
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
//   then; its partials have shared memory of their own. Where that would
//   leave fewer than 5 stages (the swapped tile of 128 token rows), the
//   partials land in the stages instead: every block arrives at the barrier
//   once its main loop is done, and stores only after every block of the
//   cluster has.
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

constexpr int kBK = 128;           // bytes of K a stage (the swizzle span)
constexpr int kMaxMembers = 3;     // weights a launch
constexpr int kMaxCluster = 8;     // blocks of a cluster (the portable limit)
constexpr int kSmSmem = 233472;    // shared memory an SM holds
constexpr int kBlockSmem = 232448; // shared memory a block may take
constexpr int kReserved = 1024;    // of an SM's, a block's share the system keeps
constexpr int kMaxStages = 8;

// How a cluster's blocks share a column tile: not at all, K split across
// them (each sums a range of K's chunks), the weight tile shared by the
// row tiles' blocks (each sums its own rows over all of K), or K split with
// the operands swapped: the weight tile is the product's 64-row side, one
// a consumer warpgroup, and the tile's kTok token rows its n side, so that
// a tile of 72 rows computes 80 columns of products, not 128 rows.
enum Mode { kPlain = 0, kSplitK = 1, kShareW = 2, kSwapK = 3 };

// A block's shape: kConsumers warpgroups of 64 rows (of tokens; with
// kSwapK, of weights: kBN = 64 x kConsumers and kTok token rows), kBN
// columns, the cluster's mode, and the blocks an SM holds (2: ~96 KB of
// stages each; 1: as many stages as a block's shared memory holds).
template <int kConsumers, int kBN, int kMode, int kPerSM, int kTok>
struct Tile {
  static constexpr bool kSwap = kMode == kSwapK;
  static constexpr bool kSplit = kMode == kSplitK || kSwap;
  static constexpr int kBM = kSwap ? kTok : 64 * kConsumers;
  static constexpr int kAcc = (kSwap ? kTok : kBN) / 2;  // s32 sums a consumer thread
  static constexpr int kThreads = kConsumers * 128 + 32;  // + one producer warp
  static constexpr int kTileA = kBM * kBK;
  static constexpr int kTileB = kBN * kBK;
  static constexpr int kStage = kTileA + kTileB;
  // the partials a block receives with a split: [split][rows it owns][kBN]
  // s32, rows padded by 16 bytes (a warp's 8-byte stores fall on two
  // wavefronts)
  static constexpr int kRecvPitch = kBN * 4 + 16;
  static constexpr int kRecvBytes = (kBM + kMaxCluster - 1) * kRecvPitch;
  // a block's share of the SM's shared memory; besides the stages: 1 KB to
  // align them, the partials, the tile's row scales, column scales and
  // biases, and two barriers a stage
  static constexpr int kBudget = kPerSM == 1 ? kBlockSmem : kSmSmem / 2 - kReserved;
  static constexpr int kScales = (kBM + 2 * kBN) * 4;
  // where the partials' own shared memory would leave fewer than 5 stages,
  // they land in the stages once every block of the cluster is done with
  // them (kAlias)
  static constexpr bool kAlias =
      kSplit && (kBudget - 1024 - kRecvBytes - kScales) / (kStage + 16) < 5;
  static constexpr int kRecv = kSplit && !kAlias ? kRecvBytes : 0;
  static constexpr int kFixed = 1024 + kRecv + kScales;
  static constexpr int kFit = (kBudget - kFixed) / (kStage + 16);
  static constexpr int kStages = kFit < kMaxStages ? kFit : kMaxStages;
  static constexpr int kSmem = kFixed + kStages * (kStage + 16);
  static_assert(kPerSM == 1 || kPerSM == 2, "one or two blocks an SM");
  static_assert(kStages >= 2 && kSmem <= kBudget, "the ring fits the block's share");
  static_assert(!kSwap || (kBN == 64 * kConsumers && kTok % 16 == 0 && kTok <= 128),
                "a swapped tile: a consumer's 64 weight rows by the token rows");
  // an unsplit block stages its outputs in the stages once every product is done
  static_assert(kSplit || kConsumers * 64 * (kBN * 4 + 16) <= kStages * kStage,
                "the staged outputs fit the stages");
  static_assert(!kAlias || kRecvBytes <= kStages * kStage, "the partials fit the stages");
};

struct Params {
  CUtensorMap tx;                // xq [M, K]
  CUtensorMap tw[kMaxMembers];   // each weight [N_i, K]
  const float* xs;               // [M] token scales (null for the s32 kind)
  OutSide o[kMaxMembers];
  int tiles[kMaxMembers];        // column tiles of each weight
  int M, nchunks, out_kind;
  int split;   // blocks of a cluster that split K (1: none)
  int share;   // blocks of a cluster that share the weight tile (1: none)
  int ntiles;  // column tiles of the group
  int groups;  // groups of `share` row tiles (the last may run past M)
  int band;    // column tiles a band
};

template <int kN>
__device__ __forceinline__ void wgmma_s8(int (&acc)[kN / 2], uint64_t da, uint64_t db) {
  if constexpr (kN == 128)
    ptx::wgmma_m64n128k32_s8(acc, da, db);
  else if constexpr (kN == 80)
    ptx::wgmma_m64n80k32_s8(acc, da, db);
  else if constexpr (kN == 64)
    ptx::wgmma_m64n64k32_s8(acc, da, db);
  else
    ptx::wgmma_m64n32k32_s8(acc, da, db);
}

template <int kConsumers, int kBN, int kMode, int kPerSM, int kTok>
__global__ void __launch_bounds__(Tile<kConsumers, kBN, kMode, kPerSM, kTok>::kThreads, kPerSM)
w8a8_wgmma_kernel(const __grid_constant__ Params p) {
  using T = Tile<kConsumers, kBN, kMode, kPerSM, kTok>;
  constexpr int kBM = T::kBM, kStages = T::kStages, kStage = T::kStage;
  constexpr bool kSplit = T::kSplit, kShare = kMode == kShareW, kSwap = T::kSwap;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1,024 bytes: tiles start on that
  uint8_t* smem = smem_raw + ((1024 - (ptx::smem_addr(smem_raw) & 1023)) & 1023);
  uint8_t* recv = T::kAlias ? smem : smem + kStages * kStage;
  float* row_s = reinterpret_cast<float*>(smem + kStages * kStage + T::kRecv);  // [kBM]
  float* col_s = row_s + kBM;                                 // [kBN]
  float* col_b = col_s + kBN;                                 // [kBN]
  uint64_t* full = reinterpret_cast<uint64_t*>(col_b + kBN);
  uint64_t* empty = full + kStages;

  // this block's place (ops/w8a8.py::_gemm_tiles): its rank in the
  // cluster, column tile t of the group, row tile, K chunks [c0, c0 + nc)
  const int rank = kSplit || kShare ? (int)ptx::cluster_ctarank() : 0;
  if constexpr (kSplit && !T::kAlias) ptx::cluster_arrive_relaxed();  // this block has started
  const int split = kSplit ? p.split : 1, share = kShare ? p.share : 1;
  // in the order by rows the grid is 2-D, x the clusters of a group of row
  // tiles and y the group, and the block needs no division by a band
  int t = (int)blockIdx.x / (split * share), group = blockIdx.y;
  if (p.band < p.ntiles) {
    const int per_band = p.band * p.groups;
    const int band = t / per_band, j = t - band * per_band;
    const int bw = min(p.band, p.ntiles - band * p.band);
    t = band * p.band + j % bw;
    group = j / bw;
  }
  int mem = 0;
  while (t >= p.tiles[mem]) t -= p.tiles[mem++];
  const OutSide o = p.o[mem];  // in registers: read once
  const int n0 = t * kBN;
  const int m0 = (group * share + (kShare ? rank : 0)) * kBM;
  const int c0 = kSplit ? rank * p.nchunks / split : 0;
  const int nc = kSplit ? (rank + 1) * p.nchunks / split - c0 : p.nchunks;
  // a block of a shared weight tile past M loads no rows (the last group's)
  const bool rows_live = m0 < p.M;

  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const CUtensorMap* tw = &p.tw[mem];
  if (threadIdx.x == 0) {
    // block 0 of a shared weight tile refills a stage once every block's
    // consumers have released it
    const int releases = kConsumers * 4 * (kShare && rank == 0 ? share : 1);
    for (int s = 0; s < kStages; ++s) {
      ptx::mbar_init(&full[s], 1);
      ptx::mbar_init(&empty[s], releases);
    }
    ptx::fence_barrier_init();
  }
  if constexpr (kShare) ptx::cluster_arrive_relaxed();  // after thread 0's fence
  if (wg == kConsumers && lane == 0) {
    ptx::prefetch_tensormap(&p.tx);
    ptx::prefetch_tensormap(tw);
  }
  // launched under programmatic dependent launch, the block may start
  // while the previous kernel in the stream (quantize_rows) runs: nothing
  // above reads device memory, everything below comes after its end
  ptx::grid_dependency_wait();
  __syncthreads();
  // every block's barriers are set up before block 0's first load into it
  // and before any other block's first arrival on block 0's
  if constexpr (kShare) ptx::cluster_wait();

  const bool s32 = p.out_kind == kOutS32;
  int acc[T::kAcc];
#pragma unroll
  for (int i = 0; i < T::kAcc; ++i) acc[i] = 0;
  if (wg == kConsumers) {  // the producer warp: one lane issues every load
    if (lane == 0) {
      // only a shared weight tile's block past M loads no rows: elsewhere
      // the test compiles away (a branch here made the loop recompute its
      // shared addresses, ~50 ns a chunk on an H100)
      const bool load_rows = !kShare || rows_live;
      const uint32_t bytes = load_rows ? kStage : T::kTileB;
      for (int c = 0; c < nc; ++c) {
        const int s = c % kStages;
        if (c >= kStages) ptx::mbar_wait(&empty[s], (c / kStages - 1) & 1);
        ptx::mbar_arrive_expect_tx(&full[s], bytes);
        if (load_rows)
          ptx::tma_load_2d(smem + s * kStage, &p.tx, (c0 + c) * kBK, m0, &full[s]);
        if constexpr (kShare) {
          if (rank == 0)
            ptx::tma_load_2d_multicast(smem + s * kStage + T::kTileA, tw, (c0 + c) * kBK,
                                       n0, &full[s], (uint16_t)((1u << share) - 1));
        } else {
          ptx::tma_load_2d(smem + s * kStage + T::kTileA, tw, (c0 + c) * kBK, n0, &full[s]);
        }
      }
    }
    ptx::launch_dependents();
    if constexpr (kMode == kPlain) return;
    if constexpr (kShare) {  // no arrival of this warp's on another block
      ptx::cluster_arrive();
      ptx::cluster_wait();
      return;
    }
  } else {
    // the epilogue's scales and biases, loaded while the products run
    // (read back from shared memory after the products' barrier)
    if (!s32) {
      const int i = threadIdx.x;
      if (i < kBM) row_s[i] = m0 + i < p.M ? p.xs[m0 + i] : 0.0f;
      const int jc = i - (kConsumers * 128 - kBN);
      if (jc >= 0 && n0 + jc < o.N) {
        col_s[jc] = o.ws[n0 + jc];
        col_b[jc] = bias_at(o, p.out_kind, n0 + jc);
      }
    }
    for (int c = 0; c < nc; ++c) {
      const int s = c % kStages;
      ptx::mbar_wait(&full[s], (c / kStages) & 1);
      // a consumer's 64 rows of xq by the weight tile; swapped, its 64 rows
      // of the weight tile by the token rows
      uint8_t* st = smem + s * kStage;
      const uint64_t da = ptx::wgmma_desc_sw128(st + (kSwap ? T::kTileA : 0) + wg * 64 * kBK);
      const uint64_t db = ptx::wgmma_desc_sw128(st + (kSwap ? 0 : T::kTileA));
      ptx::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)  // 32 bytes of K a step: +2 in 16 B
        wgmma_s8<kSwap ? kTok : kBN>(acc, da + 2 * kk, db + 2 * kk);
      ptx::wgmma_commit();
      // chunk c's products stay in flight; chunk c - 1's have completed, so
      // its stage goes back to the producer (and to block 0's, which
      // fills it in every block of a shared weight tile)
      ptx::wgmma_wait<1>();
      if (c > 0 && lane == 0) {
        const int sp = (c - 1) % kStages;
        ptx::mbar_arrive(&empty[sp]);
        if (kShare && rank != 0) ptx::mbar_arrive_cluster(&empty[sp], 0);
      }
    }
    ptx::wgmma_wait<0>();
    // the next kernel in the stream may start its prologue during this
    // block's epilogue (its blocks then wait for this grid's end)
    ptx::launch_dependents();
    // this block's last arrival on block 0 is made: block 0 may exit once
    // every block has arrived here (the wait comes after the epilogue)
    if constexpr (kShare) ptx::cluster_arrive();
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
      for (int jj = 0; jj < kBN / 8; ++jj) {
        const int col = col0 + 8 * jj;
        // columns past N hold garbage sums of zeros; they are never stored
        const float s0 = col_s[col], s1 = col_s[col + 1];
        const float b0 = col_b[col], b1 = col_b[col + 1];
        const int a0 = acc[4 * jj + 2 * h], a1 = acc[4 * jj + 2 * h + 1];
        uint8_t* qd = tile + r * pitch + col * esz;
        if (s32) {
          *reinterpret_cast<int2*>(qd) = make_int2(a0, a1);
        } else if (f32) {
          *reinterpret_cast<float2*>(qd) = make_float2(epi_f32(a0, xs, s0, has_bias, b0),
                                                       epi_f32(a1, xs, s1, has_bias, b1));
        } else {
          __nv_bfloat162 v;
          v.x = epi_bf16(a0, xs, s0, has_bias, b0);
          v.y = epi_bf16(a1, xs, s1, has_bias, b1);
          *reinterpret_cast<__nv_bfloat162*>(qd) = v;
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
    // no block exits while another may still arrive on its barriers
    if constexpr (kShare) ptx::cluster_wait();
  } else {
    // The tile's live rows split evenly across the cluster: block q owns
    // rows [q * sl, (q + 1) * sl). Each consumer thread stores its partial
    // sums of row r into the owner's partials, in the slot of this block.
    const int live = min(kBM, p.M - m0);
    const int sl = (live + split - 1) / split;
    // every block of the cluster has started (and, where the partials land
    // in the stages, is done with its stages)
    if constexpr (T::kAlias) ptx::cluster_arrive();
    ptx::cluster_wait();
    const uint32_t base = ptx::smem_addr(recv);
    if constexpr (!kSwap) {
      if (wg < kConsumers) {
        const int r0 = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h;
          if (r >= live) continue;
          const int qo = r / sl;
          const uint32_t dst = ptx::mapa(
              base + (rank * sl + r - qo * sl) * T::kRecvPitch + col0 * 4, qo);
#pragma unroll
          for (int jj = 0; jj < kBN / 8; ++jj)
            ptx::st_cluster_v2(dst + 32 * jj, acc[4 * jj + 2 * h], acc[4 * jj + 2 * h + 1]);
        }
      }
    } else if (wg < kConsumers) {
      // swapped: the sum of column n (a weight row) for token row r is
      // acc[4j + 2h + i], n = 64 wg + 16 warp + lane / 4 + 8h, r = 8j + 2 (lane
      // % 4) + i; each goes to the owner of row r, one word a store
      const int n = wg * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;
#pragma unroll
      for (int jj = 0; jj < kTok / 8; ++jj) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = 8 * jj + col0 + i;
          if (r >= live) continue;
          const int qo = r / sl;
          const uint32_t dst = ptx::mapa(
              base + (rank * sl + r - qo * sl) * T::kRecvPitch + n * 4, qo);
          ptx::st_cluster_s32(dst, acc[4 * jj + i]);
          ptx::st_cluster_s32(dst + 32, acc[4 * jj + 2 + i]);
        }
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

// the instance's kernel, its shared memory allowed once a process: a
// launch captured in a CUDA graph makes no such call after its warm-up
template <int kConsumers, int kBN, int kMode, int kPerSM, int kTok = 0>
cudaError_t prepare() {
  static const cudaError_t err = cudaFuncSetAttribute(
      w8a8_wgmma_kernel<kConsumers, kBN, kMode, kPerSM, kTok>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tile<kConsumers, kBN, kMode, kPerSM, kTok>::kSmem);
  return err;
}

// the clusters of `cluster` blocks of the instance the card holds at once
template <int kConsumers, int kBN, int kMode, int kPerSM, int kTok = 0>
int clusters(int cluster, int* out) {
  using T = Tile<kConsumers, kBN, kMode, kPerSM, kTok>;
  const cudaError_t err = prepare<kConsumers, kBN, kMode, kPerSM, kTok>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(
      out, w8a8_wgmma_kernel<kConsumers, kBN, kMode, kPerSM, kTok>, &cfg);
}

template <int kConsumers, int kBN, int kMode, int kPerSM, int kTok = 0>
int launch(const Params& p, dim3 grid, bool pdl, cudaStream_t st) {
  using T = Tile<kConsumers, kBN, kMode, kPerSM, kTok>;
  const cudaError_t err = prepare<kConsumers, kBN, kMode, kPerSM, kTok>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::kThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  int n = 0;
  const int cluster = p.split * p.share;
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
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
  return (int)cudaLaunchKernelEx(&cfg, w8a8_wgmma_kernel<kConsumers, kBN, kMode, kPerSM, kTok>,
                                p);
}

// The instance a plan takes, as op.run<kConsumers, kBN, kMode, kPerSM,
// kTok>(): K split over 64 x 64 tiles (the 0.5B's plans) or with swapped
// operands on 128 weight rows by bm token rows (32, 64, 80 or 128); a
// shared weight tile, two blocks an SM or one (deep); else plain, 64 x 64,
// 64 x 128 or 128 x 128.
template <class Op>
int dispatch(int bm, int bn, int split, int share, int deep, Op& op) {
  if (split > 1) {
    if (bn == 64) return op.template run<1, 64, kSplitK, 2, 0>();
    switch (bm) {
      case 32: return op.template run<2, 128, kSwapK, 1, 32>();
      case 64: return op.template run<2, 128, kSwapK, 1, 64>();
      case 80: return op.template run<2, 128, kSwapK, 1, 80>();
      default: return op.template run<2, 128, kSwapK, 1, 128>();
    }
  }
  if (share > 1)
    return deep ? op.template run<2, 128, kShareW, 1, 0>()
                : op.template run<2, 128, kShareW, 2, 0>();
  if (bn == 64) return op.template run<1, 64, kPlain, 2, 0>();
  if (bm == 64) return op.template run<1, 128, kPlain, 2, 0>();
  return op.template run<2, 128, kPlain, 2, 0>();
}

struct Launch {
  const Params& p;
  dim3 grid;
  bool pdl;
  cudaStream_t st;
  template <int kC, int kN, int kM, int kS, int kT>
  int run() { return launch<kC, kN, kM, kS, kT>(p, grid, pdl, st); }
};

struct Clusters {
  int cluster;
  int* out;
  template <int kC, int kN, int kM, int kS, int kT>
  int run() { return clusters<kC, kN, kM, kS, kT>(cluster, out); }
};

// Whether the kernel takes a plan (bm, bn, split, share, band, deep): see
// ragtorch_w8a8_gemm_wgmma.
bool valid_plan(int bm, int bn, int split, int share, int band, int deep, int nchunks) {
  const bool wide = bm == 128 && bn == 128;
  const bool swap = split > 1 && bn == 128;
  if (swap ? bm != 32 && bm != 64 && bm != 80 && bm != 128 : bm != 64 && bm != 128)
    return false;
  return (bn == 64 || bn == 128) && (bn == 128 || bm == 64) && split >= 1 &&
         split <= kMaxCluster && split <= nchunks && share >= 1 && share <= kMaxCluster &&
         !(split > 1 && share > 1) && !(share > 1 && !wide) && band >= 1 &&
         (deep == 0 || deep == 1) && !(split > 1 && deep != (bn == 128)) &&
         !(split == 1 && share == 1 && deep);
}

}  // namespace

// outs[i] [M, N[i]] (f32: out_kind 0, bf16: 1) = epilogue(xq [M, K] .
// wq[i]^T) for i < nmem (1 to 3 weights sharing xq); biases[i] null or
// [N[i]] of the output type; out_kind 2 (s32): outs[i] [M, N[i]] int32 =
// the exact sums, xs, ws and biases unread (may be null). K must be a
// multiple of 16 and xq, wq[i] 16-byte aligned (TMA's rules for a row
// stride and a base). The plan (ops/w8a8.py::_gemm_plan): bm rows a tile
// (64 or 128: one or two consumer warpgroups; with K split on 128 columns,
// 32, 64, 80 or 128 token rows of the swapped product), bn 128 or 64
// columns (64 only on 64-row tiles); K split over `split` blocks of a
// cluster (1 to 8, at most K's 128-byte chunks; 64 x 64 tiles two blocks
// an SM, 128 columns one); the weight tile shared by `share` blocks of a
// cluster, one a row tile (1 to 8; 128 x 128 tiles, no split); `band`
// column tiles a band of the tile order (>= 1); `deep` 1 for one block an
// SM with the deepest ring (a shared weight tile may take either; a split
// must say what its tile takes: 1 on 128 columns, 0 on 64; 0 otherwise);
// pdl 1 launches under programmatic dependent launch.
extern "C" int ragtorch_w8a8_gemm_wgmma(const void* xq, const void* xs,
                                        const void* const* wq, const void* const* ws,
                                        const void* const* bias, void* const* out,
                                        const int* N, int nmem, int M, int K,
                                        int out_kind, int bm, int bn, int split,
                                        int share, int band, int deep, int pdl,
                                        void* stream) {
  const bool s32 = out_kind == kOutS32;
  const int nchunks = (K + kBK - 1) / kBK;
  if (nmem < 1 || nmem > kMaxMembers || M < 1 || K < 16 || K % 16 != 0 ||
      (out_kind != kOutF32 && out_kind != kOutBf16 && !s32) || (!s32 && xs == nullptr) ||
      reinterpret_cast<uintptr_t>(xq) % 16 != 0 ||
      !valid_plan(bm, bn, split, share, band, deep, nchunks))
    return (int)cudaErrorInvalidValue;
  Params p{};
  if (!encode(&p.tx, xq, M, K, bm)) return (int)cudaErrorInvalidValue;
  p.xs = static_cast<const float*>(xs);
  p.M = M, p.nchunks = nchunks, p.out_kind = out_kind, p.split = split, p.share = share;
  int tiles = 0;
  for (int i = 0; i < nmem; ++i) {
    if (N[i] < 1 || reinterpret_cast<uintptr_t>(wq[i]) % 16 != 0 ||
        (!s32 && ws[i] == nullptr) || !encode(&p.tw[i], wq[i], N[i], K, bn))
      return (int)cudaErrorInvalidValue;
    p.o[i] = OutSide{static_cast<const float*>(ws[i]), bias[i], out[i], N[i]};
    p.tiles[i] = (N[i] + bn - 1) / bn;
    tiles += p.tiles[i];
  }
  p.ntiles = tiles;
  p.groups = ((M + bm - 1) / bm + share - 1) / share;
  p.band = band < tiles ? band : tiles;
  const int cluster = share * split;
  const dim3 grid = p.band == tiles ? dim3(tiles * cluster, p.groups)
                                    : dim3(tiles * p.groups * cluster);
  Launch op{p, grid, pdl != 0, static_cast<cudaStream_t>(stream)};
  return dispatch(bm, bn, split, share, deep, op);
}

// The clusters the card holds at once (cudaOccupancyMaxActiveClusters) of
// the instance a plan with this bm, bn, split, share and deep launches,
// into *out: how many clusters of split x share blocks run in one wave (a
// host query for the tools; cudaErrorInvalidValue for a plan without a
// cluster or one the kernel does not take).
extern "C" int ragtorch_w8a8_gemm_clusters(int bm, int bn, int split, int share, int deep,
                                           int* out) {
  *out = 0;
  if (split * share < 2 || !valid_plan(bm, bn, split, share, 1, deep, kMaxCluster))
    return (int)cudaErrorInvalidValue;
  Clusters op{split * share, out};
  return dispatch(bm, bn, split, share, deep, op);
}
