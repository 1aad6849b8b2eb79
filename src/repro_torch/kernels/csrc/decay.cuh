// The decay bookkeeping of the chunked wgmma bodies that carry a
// per-token decay γ_t = exp(ld_t) (ssd.cu: sc, sk, sq; la_fwd.cu: lc's
// gated instance; la_bwd.cu: bkv's gated instance), on sm90.cuh's
// fragments and tiles.
//
// A chunk of 64 tokens keeps the inclusive cumsum cl of its log decays in
// base 2; every decay factor is 2^x of a masked difference x <= 0 of that
// cumsum (or of the chunk's total), so nothing overflows:
//   * Cumsum / scan: the warp-scan cumsum, held whole by every warp, with
//     its gathers by token and by an m64n64 fragment's columns;
//   * decay_mask: a score fragment times 2^(cl_row - cl_col) under a
//     causal mask (lower or upper), the mask applied first;
//   * weighted_v: the (w o v) tile of a forward state update, w_n =
//     2^(total - cl_n), as one bf16 rounding or a hi + lo pair;
//   * weighted_a_trans: the A fragments of (2^cl o x)^T read from a bf16
//     tile by ldmatrix.trans, scaled per token, as a hi + lo pair (a
//     reverse state update);
//   * split_rows_f32: split_tile_f32 with each row scaled by 2^cl_row;
//   * row_dot: two rows of a bf16 tile dotted with an f32 vector in
//     shared memory, split over a quad (an f32 dot on the CUDA cores
//     beside the products, for normalizers held tighter than a bf16
//     operand allows).

#pragma once

#include <cuda_bf16.h>

#include "sm90.cuh"

namespace cd {

// A chunk's inclusive cumsum cl of its 64 log decays (base 2), held whole
// by every warp: lane l holds tokens 2l (even) and 2l + 1 (odd); total is
// cl of the chunk's last token.
struct Cumsum {
  float even, odd, total;

  // cl of token t of the chunk (t may differ between lanes)
  __device__ __forceinline__ float at(int t) const {
    const float e = __shfl_sync(0xffffffffu, even, t / 2);
    const float od = __shfl_sync(0xffffffffu, odd, t / 2);
    return (t & 1) ? od : e;
  }

  // cl of this thread's columns 8 a + 2 tq (+ 1) of an m64n64 fragment
  __device__ __forceinline__ void cols(int tq, float (&cl)[16]) const {
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      cl[2 * a] = __shfl_sync(0xffffffffu, even, 4 * a + tq);
      cl[2 * a + 1] = __shfl_sync(0xffffffffu, odd, 4 * a + tq);
    }
  }
};

// the warp scan of this lane's two log decays (tokens 2 lane, 2 lane + 1)
__device__ __forceinline__ Cumsum scan(const float (&ld)[2], int lane) {
  float incl = ld[0] + ld[1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  return {incl - ld[1], incl, __shfl_sync(0xffffffffu, incl, 31)};
}

// x o M in place, x an m64n64 f32 fragment (this thread's rows row0 and
// row0 + 8 of the chunk, its columns 8 a + 2 tq (+ 1)).  kLower: M =
// 2^(cl_row - cl_col) on columns <= the row, column blocks past the
// warp's last row masked whole; else M = 2^(cl_col - cl_row) on columns
// >= the row, column blocks before the warp's first row masked whole.
// The exponent is masked first, so it is <= 0.
template <bool kLower>
__device__ __forceinline__ void decay_mask(float (&x)[32],
                                           const float (&cl_row)[2],
                                           const float (&cl_col)[16],
                                           int warp, int tq, int row0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    const int col = 8 * (i / 4) + 2 * tq + (i & 1);
    const float cc = cl_col[2 * (i / 4) + (i & 1)];
    if (kLower ? 8 * (i / 4) > 16 * warp + 15 : 8 * (i / 4) + 7 < 16 * warp) {
      x[i] = 0.f;
      continue;
    }
    if (kLower)
      x[i] = col <= row0 + 8 * r ? x[i] * sm90::exp2_ftz(cl_row[r] - cc)
                                 : 0.f;
    else
      x[i] = col >= row0 + 8 * r ? x[i] * sm90::exp2_ftz(cc - cl_row[r])
                                 : 0.f;
  }
}

// The (w o v) tile of the forward state update, w_n = 2^(total - cl_n)
// <= 1: v's 64 x 64 bf16 TMA tile scaled row by row, 16 bytes at a time
// (the swizzle permutes the 16-byte chunks within a row only, so v's
// layout carries over), rounded to bf16 once into hi, or (kSplit) as a
// hi + lo pair (sm90::pack_bf16_split) into hi and lo.
template <bool kSplit, int kThreads>
__device__ __forceinline__ void weighted_v(const Cumsum& cl,
                                           const unsigned char* v,
                                           unsigned char* hi,
                                           unsigned char* lo, int tid) {
#pragma unroll
  for (int r = 0; r < 64 * 8 / kThreads; ++r) {
    const int ch = tid + kThreads * r;  // 8 chunks of 16 bytes a row
    const float w = sm90::exp2_ftz(cl.total - cl.at(ch / 8));
    const uint4 raw = reinterpret_cast<const uint4*>(v)[ch];
    const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&raw);
    uint32_t h[4];
    [[maybe_unused]] uint32_t l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(pv[e]);
      if constexpr (kSplit)
        sm90::pack_bf16_split(w * f.x, w * f.y, h[e], l[e]);
      else
        h[e] = sm90::pack_bf16(w * f.x, w * f.y);
    }
    reinterpret_cast<uint4*>(hi)[ch] = make_uint4(h[0], h[1], h[2], h[3]);
    if constexpr (kSplit)
      reinterpret_cast<uint4*>(lo)[ch] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// (2^cl o x)^T as the A operand of a reverse state update: x is a 64 x 64
// bf16 tile (tokens x columns, one TMA box, 128-byte swizzled), read
// transposed by ldmatrix (lane l: row 16 kk + 8 (m / 2) + l % 8 of the
// tile, columns 8 (2 warp + m % 2).. of matrix m = l / 8), so that the
// warp's 16 rows of A are columns 16 warp.. of x and its k steps the
// tokens; each token scaled by 2^cl (cl_col: cl of this thread's fragment
// columns, Cumsum::cols), then split into hi + lo pairs.
__device__ __forceinline__ void weighted_a_trans(const unsigned char* x,
                                                 const float (&cl_col)[16],
                                                 int warp, int lane,
                                                 uint32_t (&hi)[4][4],
                                                 uint32_t (&lo)[4][4]) {
  const int m = lane / 8;
  const int ch = 2 * warp + (m & 1);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int i = 16 * kk + 8 * (m >> 1) + lane % 8;
    uint32_t raw[4];
    sm90::ldmatrix_x4_trans(x + i * 128 + ((ch ^ (i % 8)) * 16), raw);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int cc = 4 * kk + 2 * (jj >> 1);  // cl_col of tokens +0, +1
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&raw[jj]));
      sm90::pack_bf16_split(f.x * sm90::exp2_ftz(cl_col[cc]),
                            f.y * sm90::exp2_ftz(cl_col[cc + 1]),
                            hi[kk][jj], lo[kk][jj]);
    }
  }
}

// sm90::split_tile_f32 with row r of the f32 tile scaled by 2^cl_r first:
// columns [c0, c0 + kCols) of a 64-row f32 tile (map_rows_f32's boxes of
// 32 columns) as a hi + lo pair of bf16 tiles of kCols columns.  Every
// thread of the block takes part (the gathers of cl are warp shuffles).
template <int kCols, int kThreads>
__device__ __forceinline__ void split_rows_f32(const Cumsum& cl,
                                               const unsigned char* f32,
                                               int c0, unsigned char* hi,
                                               unsigned char* lo) {
  constexpr int kPerRow = kCols / 8;  // 16-byte bf16 chunks of a row
  static_assert(64 * kPerRow % kThreads == 0, "whole rounds of the block");
#pragma unroll 4
  for (int idx = threadIdx.x; idx < 64 * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow, y = idx % kPerRow;
    const float w = sm90::exp2_ftz(cl.at(r));
    const int col = c0 + 8 * y;    // the chunk's first f32 column
    const int x = (col % 32) / 4;  // its first 16-byte f32 chunk (even)
    const unsigned char* row = f32 + (col / 32) * 8192 + r * 128;
    const float4 u = *reinterpret_cast<const float4*>(
        row + ((x ^ (r % 8)) * 16));
    const float4 v = *reinterpret_cast<const float4*>(
        row + (((x + 1) ^ (r % 8)) * 16));
    uint32_t h[4], l[4];
    sm90::pack_bf16_split(w * u.x, w * u.y, h[0], l[0]);
    sm90::pack_bf16_split(w * u.z, w * u.w, h[1], l[1]);
    sm90::pack_bf16_split(w * v.x, w * v.y, h[2], l[2]);
    sm90::pack_bf16_split(w * v.z, w * v.w, h[3], l[3]);
    const int off = (y / 8) * 8192 + r * 128 + (((y % 8) ^ (r % 8)) * 16);
    *reinterpret_cast<uint4*>(hi + off) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + off) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Σ_col tile[row, col] vec[col] for rows row0 and row0 + 8 of a 64-row
// bf16 tile of kCols columns (64 or 128: 128-byte-swizzled boxes of 64
// columns, kBox bytes apart), vec kCols f32 values in shared memory: the
// quad of a row splits its kCols / 8 chunks of 16 bytes, then sums its
// partial dots with two shuffles.  Every lane of the warp takes part.
template <size_t kBox, int kCols = 128>
__device__ __forceinline__ void row_dot(const unsigned char* tile,
                                        const float* vec, int row0, int tq,
                                        float (&out)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    float part = 0.f;
#pragma unroll
    for (int jj = 0; jj < kCols / 32; ++jj) {
      const int x = tq + 4 * jj;  // 16-byte chunk: columns 8 x ..
      const uint4 raw = *reinterpret_cast<const uint4*>(
          tile + (x / 8) * kBox + row * 128 + (((x % 8) ^ (row % 8)) * 16));
      const __nv_bfloat162* pq = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(pq[e]);
        part = fmaf(f.x, vec[8 * x + 2 * e], part);
        part = fmaf(f.y, vec[8 * x + 2 * e + 1], part);
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    out[r] = part;
  }
}

}  // namespace cd
