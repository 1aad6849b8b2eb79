// Shared pieces of the flash kernels (flash_fwd.cu, flash_bwd.cu).
//
// Each flash source holds two bodies of every product kernel:
//
//   * the wgmma body (bf16 at D = 128, the main path's instance): two
//     consumer warpgroups of 64 rows each issue Hopper's `wgmma` from
//     shared-memory tiles that TMA loads into a ring of stages
//     (sm90.cuh); scores, probabilities and dS stay in registers and feed
//     the next product as its register A operand.  Its constants and its
//     epilogue store are in `flash::wg` below;
//   * the mma.sync body (f32 at every head dim, bf16 at D = 32 and 64):
//     4 warps of 16 rows, described next.
//
// Every product of the mma.sync body is a warp-level tile product whose
// operands sit in shared memory and whose result stays in registers, laid
// out as the f32 accumulator of the tensor cores' m16n8k16 `mma.sync`:
// lane l holds rows g = l / 4 and g + 8 and columns 2 t, 2 t + 1 with
// t = l % 4 of each 16 x 8 tile (c[0], c[1] on row g, c[2], c[3] on row
// g + 8).  For bf16 operands `warp_gemm` loads the fragments with
// `ldmatrix` and issues `mma.sync` (bf16 in, f32 accumulate); for f32
// operands it computes the same accumulator with f32 FMAs on the CUDA
// cores, so one kernel body serves both types and the f32 instance is
// exact to float32 rounding (the exponentials use the fast `__expf`:
// ex2.approx of a scaled argument, within a few float32 ulps here).
// The wgmma accumulator has the same layout within each warp's 16 rows.
//
// Shared-memory tiles of the mma.sync body are read as `Tile`s: element
// (r, c) of a row-major tile is p[r * ld + c], of a column-major one
// p[c * ld + r].  Rows are padded by 16 bytes (`kPad`), so the 8 row
// groups of a fragment load fall on distinct banks.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace flash {

constexpr int kBlockQ = 64;    // query rows of a block tile (4 warps x 16)
constexpr int kBlockK = 64;    // key rows of a block tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpRows = 16;  // M of m16n8k16
constexpr float kNegInf = -1e30f;

template <typename T>
constexpr int kPad = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, bool kRowMajor>
struct Tile {
  const T* p;
  int ld;
  __device__ __forceinline__ T at(int r, int c) const {
    return kRowMajor ? p[r * ld + c] : p[c * ld + r];
  }
};

__device__ __forceinline__ uint32_t smem_address(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices from shared memory: lane l gives the address of
// row l % 8 of matrix l / 8 and receives, of each matrix i, row l / 4 and
// columns 2 (l % 4), 2 (l % 4) + 1 in r[i] (with .trans, rows 2 (l % 4),
// 2 (l % 4) + 1 of column l / 4): exactly the register pairs of the
// m16n8k16 fragments.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_address(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A (16 x K) * B (K x 8 NT), columns 8 nt .. 8 nt + 7 of B in
// acc[nt].  K is a multiple of 16 and NT even; A is row-major; every row
// of a tile starts 16-byte aligned (ldmatrix reads 16-byte rows).  One
// ldmatrix.x4 brings the A fragment of a k-step, one more the B fragments
// of two n-tiles (transposed for a row-major B).
template <int NT, int K, bool kRowA, bool kRowB>
__device__ __forceinline__ void warp_gemm(
    float (&acc)[NT][4], const Tile<__nv_bfloat16, kRowA>& a,
    const Tile<__nv_bfloat16, kRowB>& b) {
  static_assert(kRowA, "the bf16 products take a row-major A");
  static_assert(NT % 2 == 0, "B fragments come two n-tiles at a time");
  const int lane = threadIdx.x & 31;
  const int r8 = lane & 7, lo = (lane >> 3) & 1, hi = lane >> 4;
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    uint32_t af[4];
    // matrices: (rows 0-7 | 8-15) x (k 0-7 | 8-15), rows first
    ldmatrix_x4(af, a.p + (r8 + 8 * lo) * a.ld + k0 + 8 * hi);
#pragma unroll
    for (int nt = 0; nt < NT; nt += 2) {
      uint32_t bf[4];
      // matrices: (k 0-7 | 8-15) x (n-tile nt | nt + 1), k first
      if constexpr (kRowB) {
        ldmatrix_x4_trans(bf, b.p + (k0 + r8 + 8 * lo) * b.ld + nt * 8 +
                                  8 * hi);
      } else {
        ldmatrix_x4(bf, b.p + (nt * 8 + r8 + 8 * hi) * b.ld + k0 + 8 * lo);
      }
      mma_bf16(acc[nt], af, bf[0], bf[1]);
      mma_bf16(acc[nt + 1], af, bf[2], bf[3]);
    }
  }
}

// The f32 instance: the same accumulator layout from f32 FMAs.
template <int NT, int K, bool kRowA, bool kRowB>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4],
                                          const Tile<float, kRowA>& a,
                                          const Tile<float, kRowB>& b) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    const float a0 = a.at(g, k), a1 = a.at(g + 8, k);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float b0 = b.at(k, nt * 8 + 2 * t);
      const float b1 = b.at(k, nt * 8 + 2 * t + 1);
      acc[nt][0] = fmaf(a0, b0, acc[nt][0]);
      acc[nt][1] = fmaf(a0, b1, acc[nt][1]);
      acc[nt][2] = fmaf(a1, b0, acc[nt][2]);
      acc[nt][3] = fmaf(a1, b1, acc[nt][3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
}

// Start copying rows [r0, r0 + rows) of a row-major (n, D) matrix into
// shared memory with leading dimension ld, by 16-byte `cp.async` copies
// spread over the block, every copy of the call in flight at once; rows
// at or past n are zero-filled (the ragged edge is masked here, nothing
// is padded in device memory).  `stage_wait` then waits for every copy
// the thread started; a __syncthreads after it publishes the tile.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, int ld, const T* src,
                                           int r0, int n, int rows) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  constexpr int kVecPerRow = D / kVec;
  for (int i = threadIdx.x; i < rows * kVecPerRow; i += blockDim.x) {
    const int r = i / kVecPerRow, c = (i % kVecPerRow) * kVec;
    const bool in = r0 + r < n;
    // a masked row reads nothing (source size 0) from a valid address
    const T* from = src + static_cast<size_t>(in ? r0 + r : 0) * D + c;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :
                 : "r"(smem_address(dst + r * ld + c)), "l"(from),
                   "r"(in ? 16 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void stage_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Store the accumulator of a warp's 16 rows (rows row0 + g, row0 + g + 8)
// into a row-major (n, D) matrix, times `mul`, skipping rows >= n.
template <typename T, int NT>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[NT][4],
                                           int row0, int n, float mul0,
                                           float mul1) {
  constexpr int D = NT * 8;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= n) continue;
    const float mul = half ? mul1 : mul0;
    T* row = dst + static_cast<size_t>(r) * D;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      row[nt * 8 + 2 * t] = from_f32<T>(acc[nt][2 * half] * mul);
      row[nt * 8 + 2 * t + 1] = from_f32<T>(acc[nt][2 * half + 1] * mul);
    }
  }
}

// max / sum over the 4 lanes that share a row of the accumulator
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// the wgmma bodies
// ---------------------------------------------------------------------------

namespace wg {

constexpr int kD = 128;         // the head dim the wgmma bodies cover
constexpr int kThreads = 256;   // two consumer warpgroups
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// dynamic shared memory beside the tiles: the barriers, and up to 1024
// bytes of padding to the tiles' 1024-byte alignment
constexpr size_t kExtra = 2048;

// bytes of a bf16 tile of `rows` rows of D
constexpr size_t tile_bytes(int rows) {
  return static_cast<size_t>(rows) * kD * 2;
}

using sm90::exp2_ftz;

// whether the instantiation (T, D) runs the wgmma body
template <typename T, int D>
constexpr bool covers() {
  return std::is_same<T, __nv_bfloat16>::value && D == kD;
}

// A block's work in launch order.  Blocks start roughly in the order of
// their linear index (x fastest), so the longest walks go first when the
// rank of a walk's length varies slowest: the block of linear index L
// takes rank L / (Y Z) and (head, slot) = (L % Y, L % (Y Z) / Y) of a
// (X, Y, Z) grid.
struct Order {
  int rank, head, slot;
};
__device__ __forceinline__ Order launch_order() {
  const int per_rank = gridDim.y * gridDim.z;
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  const int rem = lin % per_rank;
  return {lin / per_rank, rem % static_cast<int>(gridDim.y),
          rem / static_cast<int>(gridDim.y)};
}

// Store a warpgroup's 64 x 128 f32 accumulator, row halves times mul0 and
// mul1, as bf16 rows row0 .. row0 + 63 of a row-major (n, 128) matrix,
// skipping rows >= n.
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst,
                                           const float (&d)[64], int row0,
                                           int n, float mul0, float mul1) {
  const int t = threadIdx.x % 128, w = t / 32, l = t % 32;
  const int g = l / 4, tq = l % 4;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + 16 * w + g + 8 * half;
    if (r >= n) continue;
    const float mul = half ? mul1 : mul0;
    __nv_bfloat16* row = dst + static_cast<size_t>(r) * kD;
#pragma unroll
    for (int nt = 0; nt < kD / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + nt * 8 + 2 * tq) =
          sm90::pack_bf16(d[4 * nt + 2 * half] * mul,
                          d[4 * nt + 2 * half + 1] * mul);
  }
}

}  // namespace wg

}  // namespace flash
