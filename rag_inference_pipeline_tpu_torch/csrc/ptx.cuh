// PTX helpers of the tensor-core kernels (sm_90a): asynchronous
// global-to-shared copies with their commit and wait groups, ldmatrix,
// mma.sync on bf16 and s8; and, for the wgmma kernels (the W8A8 GEMM and
// the encoder flash attention), mbarriers, 2-D and 4-D TMA tile loads and
// bulk copies, named barriers, setmaxnreg, the async-proxy fence,
// shared-memory matrix
// descriptors (K-major and MN-major) and the warpgroup products (s8, and
// bf16/f16 with A from shared memory or registers) with their fence,
// commit and wait; and, for the W8A8 GEMM's split K and the long-row
// quantize, the cluster barrier, mapa and stores into another block's
// shared memory; for its weight tiles shared across a cluster, the
// multicast TMA load and the arrival on another block's mbarrier; and
// programmatic dependent launch's wait and trigger.
//
// Every helper is `asm volatile` with a "memory" clobber where it touches
// memory, so the compiler keeps a copy, its wait and the reads of what it
// wrote in program order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ragtorch {
namespace ptx {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kBytes (16 or 4) from global `src` to shared `dst`; the first `src_bytes`
// come from `src` and the rest of the kBytes are zeros (src_bytes 0: no
// read at all). 16 bytes go through L2 only (.cg), 4 bytes through L1 (.ca,
// the only form of that size).
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  static_assert(kBytes == 16 || kBytes == 4, "cp.async copies 16 or 4 bytes");
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most kPending of this thread's commit groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// four 8x8 b16 matrices: lanes 8i .. 8i+7 give the row addresses of
// matrix i, which lands in r[i]
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col): bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x32, row) * b (32x8, col): s8 in, exact s32 accumulate (no
// .satfinite: the callers' sums stay below 2^31)
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// --- mbarriers (shared::cta) ---------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// one arrival on the mbarrier at `bar`'s offset in block `rank` of the
// cluster
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// one arrival that also expects `bytes` from asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// spins until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// --- TMA -----------------------------------------------------------------

// the tile of `map` at (inner coordinate c0, outer c1) into shared `dst`;
// completion (its bytes) is reported to `bar`. `map` is a kernel parameter
// (__grid_constant__), passed by its generic address.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0,
                                            int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// the tile of `map` at (c0, c1) into shared `dst` of every block of the
// cluster whose rank is set in `mask`, at the same offset in each; each
// block's mbarrier at `bar`'s offset gets the bytes it received
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const void* map, int c0,
                                                      int c1, uint64_t* bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// the 4-D tile of `map` at (c0, c1, c2, c3), innermost first, into shared
// `dst`; completion reported to `bar` as for tma_load_2d
__device__ __forceinline__ void tma_load_4d(void* dst, const void* map, int c0,
                                            int c1, int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) contiguous bytes from global `src` to shared
// `dst`, both on 16 bytes; completion reported to `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// the same, to the shared address `dst` with the mbarrier at shared address
// `bar`
__device__ __forceinline__ void bulk_load_to(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// --- named barriers and register reallocation ------------------------------

// waits until `threads` threads (a multiple of 32) have arrived at barrier
// `id` (1-15: 0 is __syncthreads'), counting this warp
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// arrives at barrier `id` without waiting
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the warpgroup's registers a thread, raised or lowered to kRegs (a
// multiple of 8 in [24, 256]); every warp of the warpgroup executes it
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// --- wgmma ---------------------------------------------------------------

// A shared-memory matrix descriptor for a K-major tile written by TMA with
// the 128-byte swizzle: rows of 128 bytes, 8-row groups 1,024 bytes apart
// (stride byte offset), the leading byte offset unused, layout 1 (128B).
// The tile starts on a 1,024-byte boundary; a k step inside the 128-byte
// row adds its byte offset / 16 to the start address.
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr) {
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ uint64_t wgmma_desc_sw128(const void* tile) {
  return wgmma_desc_sw128(smem_addr(tile));
}

// The descriptor of an MN-major tile (the N index contiguous; 16-bit types
// only, read with the transpose bit) written by TMA with the 128-byte
// swizzle: each K row holds 64 N elements in 128 bytes, 8 K rows make a
// 1,024-byte atom. The stride byte offset steps 8 K rows (1,024 bytes);
// the leading byte offset `lbo` steps 64 N elements, to the next panel of
// the tile. A k16 step adds 2,048 bytes / 16 to the start address.
__device__ __forceinline__ uint64_t wgmma_desc_sw128_mn(uint32_t addr, uint32_t lbo) {
  return ((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

// makes this thread's ordinary stores to shared memory visible to the async
// proxy (a later wgmma or TMA store reading them), once an mbarrier or
// named barrier passes them on
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// d (64 x 128 s32 of the warpgroup: 64 registers a thread) += a (64 x 32
// s8, K-major, shared) . b (32 x 128 s8, K-major, shared); exact s32 sums
// (no .satfinite: the callers' sums stay below 2^31)
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t da,
                                                    uint64_t db) {
  // scale-d is a predicate: true accumulates into d
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 64 s32: 32 registers a thread) += a (64 x 32 s8, K-major, shared)
// . b (32 x 64 s8, K-major, shared); exact s32 sums, as the n128 form
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 80 s32: 40 registers a thread) += a (64 x 32 s8, K-major, shared)
// . b (32 x 80 s8, K-major, shared); exact s32 sums, as the n128 form
__device__ __forceinline__ void wgmma_m64n80k32_s8(int (&d)[40], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %42, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n80k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, %40, %41, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32 s32: 16 registers a thread) += a (64 x 32 s8, K-major, shared)
// . b (32 x 32 s8, K-major, shared); exact s32 sums, as the n128 form
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %18, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// --- thread block clusters -------------------------------------------------

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the cluster barrier's arrive (release: this thread's writes, shared
// memory of other blocks included, are seen by the threads that wait) and
// wait (acquire); every thread of every block of the cluster arrives once a
// phase. Not .aligned: a warp may reach them diverged. The relaxed arrive
// orders nothing: it marks the block as started, before any block stores
// into its shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the shared::cluster address of shared address `addr` in block `rank` of
// the cluster
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// two s32 values to a shared::cluster address (8-byte aligned)
__device__ __forceinline__ void st_cluster_v2(uint32_t addr, int a, int b) {
  asm volatile("st.shared::cluster.v2.s32 [%0], {%1, %2};\n" ::"r"(addr), "r"(a), "r"(b)
               : "memory");
}

// one s32 value to a shared::cluster address
__device__ __forceinline__ void st_cluster_s32(uint32_t addr, int v) {
  asm volatile("st.shared::cluster.s32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// one f32 value to a shared::cluster address
__device__ __forceinline__ void st_cluster_f32(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
}

// adds v to the s32 at a shared::cluster address (no value returned)
__device__ __forceinline__ void red_cluster_add(uint32_t addr, int v) {
  asm volatile("red.shared::cluster.add.s32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// a TMA descriptor (a __grid_constant__ parameter, by generic address)
// brought into the descriptor cache ahead of its first load
__device__ __forceinline__ void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map))
               : "memory");
}

// --- programmatic dependent launch ----------------------------------------

// waits until the grids this one depends on (the previous kernel in the
// stream, where this one was launched with programmatic stream
// serialization) have completed and their memory is visible; returns at
// once otherwise. Nothing before it may read what they write.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// lets the next kernel in the stream, where it was launched with
// programmatic stream serialization, start once every block of this grid
// has signalled or exited; a no-op otherwise
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// keeps the compiler from moving reads or writes of `r` across this point:
// around an asynchronous wgmma, whose registers the compiler believes
// written when the instruction issues
template <int kN>
__device__ __forceinline__ void fence_regs(float (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define RAGTORCH_F4(d, i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define RAGTORCH_F16(d, i) \
  RAGTORCH_F4(d, i), RAGTORCH_F4(d, i + 4), RAGTORCH_F4(d, i + 8), RAGTORCH_F4(d, i + 12)
#define RAGTORCH_F32(d, i) RAGTORCH_F16(d, i), RAGTORCH_F16(d, i + 16)
#define RAGTORCH_F64(d) RAGTORCH_F32(d, 0), RAGTORCH_F32(d, 32)
#define RAGTORCH_D32 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define RAGTORCH_D64 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128 f32 of the warpgroup: 64 registers a thread) = (scale_d ? d :
// 0) + a (64 x 16, K-major, shared) . b (16 x 128, K-major, shared); bf16
// (kBf16) or f16 inputs
template <bool kBf16>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  if constexpr (kBf16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RAGTORCH_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : RAGTORCH_F64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " RAGTORCH_D64
        ", %64, %65, p, 1, 1, 0, 0;\n}\n"
        : RAGTORCH_F64(d)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x kN f32: kN / 2 registers a thread) = (scale_d ? d : 0) + a (64 x
// 16 in registers, the mma.sync A fragment of each warp's 16 rows) . b (16 x
// kN, MN-major in shared memory: the transpose bit); kN 64 or 128
template <bool kBf16, int kN>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[kN / 2], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  static_assert(kN == 64 || kN == 128, "wgmma_m64k16_rs takes n64 or n128");
  if constexpr (kN == 64 && kBf16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RAGTORCH_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : RAGTORCH_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (kN == 64) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 " RAGTORCH_D32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : RAGTORCH_F32(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (kBf16) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RAGTORCH_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : RAGTORCH_F64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 " RAGTORCH_D64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : RAGTORCH_F64(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

#undef RAGTORCH_F4
#undef RAGTORCH_F16
#undef RAGTORCH_F32
#undef RAGTORCH_F64
#undef RAGTORCH_D32
#undef RAGTORCH_D64

}  // namespace ptx
}  // namespace ragtorch
