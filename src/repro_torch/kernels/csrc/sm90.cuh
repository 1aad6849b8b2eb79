// Hopper (sm_90a) building blocks of the wgmma bodies (flash_fwd.cu,
// flash_bwd.cu, ssd.cu, la_fwd.cu, la_bwd.cu), of the recurrent decode
// steps' state stream (la_decode_fused.cu) and of the paged decode's
// cluster-split page stream (paged_decode.cu): mbarriers, TMA tile loads,
// 1-D bulk copies, thread-block clusters and warpgroup matrix products, as
// raw PTX.
//
//   * mbarrier: init, arrive, arrive with an expected transaction count,
//     and a try_wait loop on a phase parity (a barrier's phase p has
//     completed once `wait(bar, p & 1)` returns);
//   * TMA: `cp.async.bulk.tensor` loads of a tile described by a
//     CUtensorMap that the kernel takes as a `__grid_constant__`
//     parameter; completion is counted in bytes on an mbarrier.  The host
//     side encodes the maps with `cuTensorMapEncodeTiled`, reached through
//     `cudaGetDriverEntryPoint`, so no library links against libcuda.
//     Rows of f32 statistics, whose starts need not be 16-byte aligned as
//     a TMA box's must, go by 4-byte `cp.async` whose completion arrives
//     on the same mbarrier;
//   * 1-D bulk copies (`cp.async.bulk`) of contiguous bytes: loads counted
//     on an mbarrier, stores in the thread's bulk group;
//   * clusters: the block's rank in its cluster, the cluster-wide barrier
//     (arrive with release, wait with acquire semantics), and reads of a
//     peer block's shared memory (distributed shared memory: `mapa` and
//     `ld.shared::cluster`);
//   * wgmma: shared-memory descriptors of 128-byte-swizzled bf16 tiles,
//     `wgmma.fence`, `commit_group`, `wait_group`, the proxy fence that
//     makes tiles written by threads visible to them, and the m64nNk16
//     products the bodies run (bf16 in, f32 accumulate);
//   * operands from f32 values: one bf16 rounding (pack_bf16, to_a,
//     store_tile) or a hi + lo pair of bf16 values (pack_bf16_split,
//     to_a_split, store_tile_split, and split_tile_f32 of an f32 tile
//     loaded by TMA through map_rows_f32) whose two products into one
//     accumulator keep ~16 bits; A fragments read transposed from a tile
//     (ldmatrix_x4_trans).
//
// Tile layout.  A bf16 tile of R rows and 128 columns sits in shared
// memory as two boxes of R x 64 (one 128-byte row each, as the 128-byte
// swizzle needs), box c at byte c * R * 128; each box is what one TMA load
// of a (64, R, 1) box of a 3-D map (D, N, heads) writes, with 16-byte
// chunks of row r XOR-swizzled by r % 8 (a tile of 64 columns is one
// box).  Every tile starts 1024-byte aligned, so the swizzle (a function
// of the address bits) matches the descriptors'.  Such a tile is
//   * a K-major operand (rows = M or N, columns = K): 8-row groups 1024
//     bytes apart (SBO); the k-th 16-column step starts at box k / 4, byte
//     32 (k % 4) of its rows;
//   * an MN-major operand (rows = K, columns = N): 8-row K groups 1024
//     bytes apart (SBO), the two 64-column boxes R * 128 bytes apart
//     (LBO); the k-th 16-row step starts 2048 k bytes in.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool bar_try(uint32_t addr, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %globaltimer;\n" : "=l"(t));
  return t;
}

// a wait longer than this is a fault (a barrier that can never complete):
// the kernel traps and the launch fails instead of holding the card
constexpr uint64_t kWaitLimitNs = 2000000000ull;

// returns once the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  if (bar_try(addr, parity)) return;
  const uint64_t t0 = global_ns();
  while (!bar_try(addr, parity))
    if (global_ns() - t0 > kWaitLimitNs) __trap();
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// box (c0, c1, c2) of a 3-D map into shared memory; elements outside the
// map's extent arrive as zeros and count as bytes all the same
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// box (c0, c1, c2) of a 3-D map from shared memory to global memory, in
// the thread's bulk group; elements outside the map's extent are not
// written
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// returns once at most N of the thread's bulk groups still read shared
// memory (kRead) or are still in flight at all
template <int N, bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` contiguous bytes from global to shared memory by one 1-D bulk
// copy, counted on `bar` (bar_expect); both addresses 16-byte aligned,
// `bytes` a multiple of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes from shared to global memory by one 1-D bulk
// copy, in the thread's bulk group (bulk_commit, bulk_wait); the writers
// of the bytes each fence_async_smem first, then a barrier
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], "
               "%2;\n" ::"l"(reinterpret_cast<uint64_t>(dst)),
               "r"(smem_u32(src)), "r"(bytes)
               : "memory");
}

// 4 bytes from global to shared memory by `cp.async` (zero-filled where
// !in; src must still be a valid address), for values too few or too
// unaligned for a TMA box
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// one arrival on the barrier once every cp.async the thread started has
// landed (the barrier's count includes it: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// ---------------------------------------------------------------------------
// thread-block clusters
// ---------------------------------------------------------------------------

// the block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster arrives, then waits: writes
// to shared memory before it are visible to the cluster's reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the f32 at `p` (this block's shared memory) in the shared memory of the
// cluster's block `rank`
__device__ __forceinline__ float ld_peer(const float* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr)
               : "r"(smem_u32(p)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// descriptor of a 128-byte-swizzled bf16 operand starting at p (see the
// tile layout above); byte offsets are encoded in 16-byte units
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// the k-th 16-column step of a K-major tile of kRows rows, from `tile`,
// which may point at a row of box 0 that is a multiple of 8 (a
// warpgroup's 64 rows of a 128-row tile)
template <int kRows>
__device__ __forceinline__ uint64_t desc_k(const __nv_bfloat16* tile, int k) {
  return desc(reinterpret_cast<const char*>(tile) + (k / 4) * kRows * 128 +
                  (k % 4) * 32,
              16, 1024);
}

// the k-th 16-row step of an MN-major tile of kRows rows
template <int kRows>
__device__ __forceinline__ uint64_t desc_mn(const __nv_bfloat16* tile,
                                            int k) {
  return desc(reinterpret_cast<const char*>(tile) + k * 2048, kRows * 128,
              1024);
}

// orders this thread's shared-memory writes before later reads of the
// same bytes by wgmma or TMA (the async proxy); a barrier must still
// follow before another thread's product reads them
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void mma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// pins register values in place around the asynchronous products: the
// compiler may not move their reads or writes across this point
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B bf16 in shared
// memory, both K-major (descriptors a, b); d is overwritten where
// accumulate is 0.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 128, f32) (+)= A (64 x 16) B (16 x 128), A and B bf16 in shared
// memory (descriptors a, b), K-major unless kTransA / kTransB is 1 (then
// MN-major, read transposed); d is overwritten where accumulate is 0.
template <int kTransA = 0, int kTransB = 0>
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(kTransA), "n"(kTransB));
}

// d (64 x 128, f32) += A (64 x 16) B (16 x 128): A bf16 in registers (the
// four 32-bit fragment registers a), B bf16 in shared memory, MN-major
// (descriptor b, transposed).
__device__ __forceinline__ void mma_rs_n128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}


// d (64 x 64, f32) += A (64 x 16) B (16 x 64): A bf16 in registers (the
// four 32-bit fragment registers a), B bf16 in shared memory, MN-major
// (descriptor b, transposed).
__device__ __forceinline__ void mma_rs_n64(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate));
}

// two f32 values as one bf16x2 register (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from registers into shared memory: register j
// holds this thread's pair of matrix j (row lane / 4, columns
// 2 (lane % 4) and + 1, as in an accumulator), and lane l gives the
// address of row l % 8 of matrix l / 8 (16 bytes).
__device__ __forceinline__ void stmatrix_x4(void* row, uint32_t r0,
                                            uint32_t r1, uint32_t r2,
                                            uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::
          "r"(smem_u32(row)),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// A warpgroup's m64nN f32 accumulator d (N = 8 kBlocks: 4 values of each
// 8-column block a thread) as bf16 into a 128-byte-swizzled K-major tile
// of 64 rows and N columns (see the tile layout above): eight columns of
// a warp's 16 rows are two 8 x 8 matrices, four go by one stmatrix.
template <int kBlocks>
__device__ __forceinline__ void store_tile(unsigned char* tile,
                                           const float (&d)[4 * kBlocks]) {
  static_assert(kBlocks % 2 == 0, "column blocks in pairs");
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // this lane's row of its matrix: matrices 0 and 2 the warp's top 8
  // rows, 1 and 3 its bottom 8; 0 and 1 column block a, 2 and 3 a + 1
  const int m = lane / 8;
  const int row = 16 * warp + 8 * (m & 1) + lane % 8;
#pragma unroll
  for (int a = 0; a < kBlocks; a += 2) {
    const int blk = a + (m >> 1);  // the lane's 16-byte column block
    unsigned char* addr = tile + (blk / 8) * 64 * 128 + row * 128 +
                          (((blk % 8) ^ (row % 8)) * 16);
    stmatrix_x4(addr, pack_bf16(d[4 * a], d[4 * a + 1]),
                pack_bf16(d[4 * a + 2], d[4 * a + 3]),
                pack_bf16(d[4 * a + 4], d[4 * a + 5]),
                pack_bf16(d[4 * a + 6], d[4 * a + 7]));
  }
}

// two f32 values as a hi + lo pair of bf16x2 registers: hi = bf16(x), lo =
// bf16(x - hi) (x - hi is exact in f32), so hi + lo keeps ~16 of x's bits
// (relative error <= 2^-17) where hi alone keeps 8 (2^-9)
__device__ __forceinline__ void pack_bf16_split(float x0, float x1,
                                                uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

// store_tile of d's hi part into `hi` and of its lo part into `lo`
// (pack_bf16_split), both 128-byte-swizzled K-major tiles of 64 rows
template <int kBlocks>
__device__ __forceinline__ void store_tile_split(unsigned char* hi,
                                                 unsigned char* lo,
                                                 const float (&d)[4 * kBlocks]) {
  static_assert(kBlocks % 2 == 0, "column blocks in pairs");
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int m = lane / 8;
  const int row = 16 * warp + 8 * (m & 1) + lane % 8;
#pragma unroll
  for (int a = 0; a < kBlocks; a += 2) {
    const int blk = a + (m >> 1);
    const int off = (blk / 8) * 64 * 128 + row * 128 +
                    (((blk % 8) ^ (row % 8)) * 16);
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pack_bf16_split(d[4 * a + 2 * j], d[4 * a + 2 * j + 1], h[j], l[j]);
    stmatrix_x4(hi + off, h[0], h[1], h[2], h[3]);
    stmatrix_x4(lo + off, l[0], l[1], l[2], l[3]);
  }
}

// Columns [c0, c0 + kCols) of a 64-row f32 tile (TMA boxes of 32 columns,
// 8 KB apart, 128-byte swizzled: map_rows_f32) as a hi + lo pair of bf16
// tiles of kCols columns (pack_bf16_split; boxes of 64 columns, 8 KB
// apart, swizzled as a TMA load writes them), so that the pair serves as a
// K-major or an MN-major operand (see the tile layout above).  c0 is a
// multiple of 8; the block's kThreads threads share the work.
template <int kCols, int kThreads>
__device__ __forceinline__ void split_tile_f32(const unsigned char* f32,
                                               int c0, unsigned char* hi,
                                               unsigned char* lo) {
  constexpr int kPerRow = kCols / 8;  // 16-byte bf16 chunks of a row
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 64 * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, y = idx % kPerRow;
    const int col = c0 + 8 * y;    // the chunk's first f32 column
    const int x = (col % 32) / 4;  // its first 16-byte f32 chunk (even)
    const unsigned char* row = f32 + (col / 32) * 8192 + r * 128;
    const float4 u = *reinterpret_cast<const float4*>(
        row + ((x ^ (r % 8)) * 16));
    const float4 w = *reinterpret_cast<const float4*>(
        row + (((x + 1) ^ (r % 8)) * 16));
    uint32_t h[4], l[4];
    pack_bf16_split(u.x, u.y, h[0], l[0]);
    pack_bf16_split(u.z, u.w, h[1], l[1]);
    pack_bf16_split(w.x, w.y, h[2], l[2]);
    pack_bf16_split(w.z, w.w, h[3], l[3]);
    const int off = (y / 8) * 8192 + r * 128 + (((y % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lane l gives
// the address of row l % 8 of matrix l / 8 (16 bytes), and register j
// receives this thread's pair of matrix j's transpose (row lane / 4,
// columns 2 (lane % 4) and + 1): the A fragment of a product whose A is
// the transpose of the tile read.
__device__ __forceinline__ void ldmatrix_x4_trans(const void* row,
                                                  uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(row))
      : "memory");
}

// 2^x by one `ex2.approx.ftz` (results below 2^-126 flush to 0; -inf
// gives 0)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The accumulator of an m64nN product as the A operand of the next one:
// element i of d (row 16 w + l / 4 + 8 ((i / 2) % 2), column
// 8 (i / 4) + 2 (l % 4) + i % 2 for lane l of warp w) lands where the A
// fragment of k-step i / 8 wants it.
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&a)[K][4],
                                     const float (&d)[K * 8]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a[k][j] = pack_bf16(d[8 * k + 2 * j], d[8 * k + 2 * j + 1]);
}

// to_a as a hi + lo pair (pack_bf16_split): two A operands whose products
// with the same B, summed in one accumulator, keep ~16 bits of d
template <int K>
__device__ __forceinline__ void to_a_split(uint32_t (&hi)[K][4],
                                           uint32_t (&lo)[K][4],
                                           const float (&d)[K * 8]) {
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pack_bf16_split(d[8 * k + 2 * j], d[8 * k + 2 * j + 1], hi[k][j],
                      lo[k][j]);
}

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A 3-D map of a contiguous (slices, n, cols) tensor of `elem` bytes per
// value as (cols, n, slices), boxes of (box_cols, rows, 1) with the
// 128-byte swizzle (box_cols * elem = 128): a box past one slice's n rows
// is zero-filled, never the next slice's rows.
inline cudaError_t map_rows_of(CUtensorMap* map, CUtensorMapDataType type,
                               int elem, const void* base, int n, int slices,
                               int rows, int cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(slices)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * elem,
                                 static_cast<cuuint64_t>(n) * cols * elem};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = encode(
      map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A 3-D map of a contiguous bf16 (slices, n, cols) tensor as (cols, n,
// slices), cols 128 or 64, boxes of (64, rows, 1) with the 128-byte
// swizzle: a box past one slice's n rows is zero-filled, never the next
// slice's rows.
inline cudaError_t map_rows(CUtensorMap* map, const void* base, int n,
                            int slices, int rows, int cols = 128) {
  return map_rows_of(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, base, n,
                     slices, rows, cols);
}

// The same of a contiguous f32 (slices, n, cols) tensor: boxes of (32,
// rows, 1), so a 64-row tile of 128 columns is four boxes of 32 columns
// (one 128-byte row each, swizzled as the bf16 boxes are).
inline cudaError_t map_rows_f32(CUtensorMap* map, const void* base, int n,
                                int slices, int rows, int cols = 128) {
  return map_rows_of(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, base, n,
                     slices, rows, cols);
}

// The dynamic shared memory of a wgmma body rounded up to the 1024-byte
// alignment its tiles need.
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  return raw + pad;
}

}  // namespace sm90
