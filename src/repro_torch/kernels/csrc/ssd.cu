// SSD (Mamba-2) forward and analytic backward for Hopper (sm_90a): three
// kernels.
//
// Replaces the TPU kernels `ssd_fwd_pallas` (src/repro/kernels/ssd.py:65;
// body `_ssd_kernel`, ssd.py:34) and `ssd_bwd_pallas` (ssd.py:192; bodies
// `_ssd_bwd_q_kernel` :118 and `_ssd_bwd_kv_kernel` :151).  For every
// (batch, head) and token, with the decay γ_t = exp(ld_t), in f32:
//
//   ssd_fwd     S_t = γ_t S_{t-1} + k_t^T v_t          (Dk, Dv)
//               o_t = q_t S_t
//   ssd_bwd_q   the same forward walk;  dq_t = S_t Ω_t   (Dk,)
//   ssd_bwd_kv  a reverse walk: U_n = γ_{n+1} U_{n+1} + q_n^T Ω_n
//               dk_n = U_n v_n (Dk,),  dv_n = U_n^T k_n (Dv,)
//
// The forward decays the state carried into t by t's own γ_t and never
// token t's own term; the reverse walk carries U_{n+1} into n with
// γ_{n+1}, the decay of the token walked just before (the weight of query
// i on key n is Π_{m=n+1..i} γ_m).  The sums include the token itself, as
// the reference's causal masks do.  Every factor is exp(ld) <= 1, so
// nothing overflows and the chunked form's log-space cumsums have no
// counterpart.  No normalizer, no a/b: unlike la_fwd.cu this is the
// reference's plain SSD recurrence.
//
// Grouping (the reference's `hi // group` index maps): q and k are
// (B, G, N, Dk), shared by the H/G heads of a group (Mamba-2's C and B,
// G = 1 at full width); v, Ω, o and dv are (B, H, N, Dv), ld is (B, H, N).
// dq and dk are written as PER-HEAD partials (B, H, N, Dk) in f32, as the
// Pallas kernels write them (ssd.py:236, :268); the caller sums them over
// the group with one reduction, in a fixed order, so the result is
// deterministic (no float atomics).  dv comes back in f32 for the
// caller's dld epilogue (dcl = Ω.o - v.dv, then a reverse cumsum).
//
// Shapes (all contiguous): q, k in the compute type T (float or bf16);
// v and Ω in T; ld f32; o in T; dq, dk partials and dv in f32.
// (Dk, Dv) are template parameters, instantiated for (128, 64)
// (mamba2-2.7b: state 128, head dim 64) and (16, 32) (its smoke config);
// any other pair is refused.
//
// What bounds them (estimates from the shapes, not measurements; B=2,
// G=1, H=80, N=8192, Dk=128, Dv=64): ssd_fwd does 5 Dk Dv flops per token
// and head (the decayed update and the readout), 53.7 GFLOP, 0.80 ms at
// 67 TFLOP/s f32, against 0.10 ms for its ~0.35 GB; ssd_bwd_q the same
// flops, but it writes 671 MB of f32 partials (0.26 ms); ssd_bwd_kv
// updates U once and reads it twice, 7 Dk Dv flops, 75.2 GFLOP, 1.12 ms.
// All are bound by f32 operations on the CUDA cores.
//
// Design (simple first; a chunk-parallel form on the tensor cores is
// later work):
//   * one block per (batch, head), walking the whole sequence: a (B, H)
//     grid, 160 blocks at B=2, H=80 on 132 SMs, small enough that two
//     fit on one SM, so the grid runs in one wave;
//   * the state lives in registers, tiled over the threads two ways.
//     Column tiles (ssd_fwd; ssd_bwd_kv's dv role): a thread owns 4
//     adjacent columns and R = Dk / kColGroups rows; the row groups of a
//     column group are adjacent lanes, so o = q S and dv = U^T k end in
//     log2(kColGroups) shuffles per column.  Row tiles (ssd_bwd_q;
//     ssd_bwd_kv's dk role): a thread owns 4 adjacent rows and
//     C = Dv / kRowGroups columns, so dq = S Ω and dk = U v end in
//     log2(kRowGroups) shuffles per row.  At (128, 64) a tile is 64
//     floats, 128 threads per role;
//   * ssd_bwd_kv reads U by rows (dk) and by columns (dv), so the block
//     keeps it twice: 128 threads in row tiles, 128 in column tiles, each
//     taking the same rank-1 update.  That doubles the update's flops but
//     needs no reduction across warps per token;
//   * per iteration the block stages `stage` tokens of the inputs in
//     shared memory as f32 (bf16 values are exact in f32) by 16-byte
//     loads, with 4 floats of padding after each tile-wide slice of a row
//     so that the lanes of a warp read disjoint banks, and each token's
//     decay exp(ld) (one expf per token, not per thread); the outputs of
//     the staged tokens land in shared memory and are written out
//     together.  The reverse walk stages from the end of the sequence
//     backwards.  The tail iteration is bounded by N; nothing is padded
//     in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr size_t kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory

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

// 16 bytes of device memory (8 bf16 or 4 f32 values) as f32.
__device__ __forceinline__ void load16(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// A staged token row of W floats with 4 floats of padding after every G.
template <int W, int G>
struct Padded {
  static_assert(W % G == 0 && G % 4 == 0, "slices of whole float4s");
  static constexpr int kWidth = W + 4 * (W / G);
  __device__ static int at(int e) { return e + 4 * (e / G); }
};

// The two register tilings of a (Dk, Dv) state (see the header).
template <int DK, int DV>
struct Tiles;
template <>
struct Tiles<128, 64> {
  static constexpr int kColGroups = 8;
  static constexpr int kRowGroups = 4;
};
template <>
struct Tiles<16, 32> {
  static constexpr int kColGroups = 4;
  static constexpr int kRowGroups = 8;
};

template <int DK, int DV>
struct Layout {
  static constexpr int kColGroups = Tiles<DK, DV>::kColGroups;
  static constexpr int kRowGroups = Tiles<DK, DV>::kRowGroups;
  static constexpr int R = DK / kColGroups;  // rows of a column tile
  static constexpr int C = DV / kRowGroups;  // columns of a row tile
  static constexpr int kColThreads = (DV / 4) * kColGroups;
  static constexpr int kRowThreads = (DK / 4) * kRowGroups;
  using PadK = Padded<DK, R>;  // staged q and k rows
  using PadV = Padded<DV, C>;  // staged v and Ω rows
  static_assert(R % 4 == 0 && C % 4 == 0, "tiles of whole float4s");
  static_assert(kColThreads % 32 == 0 && kRowThreads % 32 == 0,
                "each role fills whole warps");
};

// Stage `len` contiguous rows of W values from device memory into padded
// shared-memory rows as f32, 16 bytes per load; unrolled so that each
// thread keeps several loads in flight.  Rows are 16-byte aligned.
template <typename Pad, int W, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int len,
                                           int tid, int nthr) {
  constexpr int V = 16 / sizeof(T);
  static_assert(W % V == 0, "whole 16-byte loads per row");
#pragma unroll 4
  for (int idx = tid; idx < len * (W / V); idx += nthr) {
    const int e = idx * V;
    const int t = e / W;
    const int col = e - t * W;
    float vals[V];
    load16(src + e, vals);
    float* row = dst + t * Pad::kWidth;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(row + Pad::at(col + i)) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Sum over N adjacent lanes (N a power of two dividing 32).
template <int N>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = 1; off < N; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Column tile s[c][i] = S[row0 + i, col0 + c]: S <- gam S + a^T b over the
// tile (a: its R rows, b: its 4 columns), then acc[c] = the tile's share
// of x . S[:, col0 + c].
template <int R>
__device__ __forceinline__ void col_step(float (&s)[4][R], float gam,
                                         const float* a, float4 b4,
                                         const float* x, float (&acc)[4]) {
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int i4 = 0; i4 < R / 4; ++i4) {
    const float4 a4 = ld4(a + 4 * i4);
    const float4 x4 = ld4(x + 4 * i4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float& e = s[c][4 * i4 + r];
        e = fmaf(av[r], b[c], gam * e);
        acc[c] = fmaf(xv[r], e, acc[c]);
      }
    }
  }
}

// Row tile s[r][j] = S[row0 + r, col0 + j]: S <- gam S + a^T b over the
// tile (a: its 4 rows, b: its C columns), then acc[r] = the tile's share
// of S[row0 + r, :] . y.
template <int C>
__device__ __forceinline__ void row_step(float (&s)[4][C], float gam,
                                         float4 a4, const float* b,
                                         const float* y, float (&acc)[4]) {
  const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int j4 = 0; j4 < C / 4; ++j4) {
    const float4 b4 = ld4(b + 4 * j4);
    const float4 y4 = ld4(y + 4 * j4);
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
    const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& e = s[r][4 * j4 + j];
        e = fmaf(av[r], bv[j], gam * e);
        acc[r] = fmaf(e, yv[j], acc[r]);
      }
    }
  }
}

// Write `count` f32 values from shared memory to device memory as T.
template <typename T>
__device__ __forceinline__ void write_out(T* dst, const float* src,
                                          int count, int tid, int nthr) {
  for (int idx = tid; idx < count; idx += nthr) dst[idx] = from_f32<T>(src[idx]);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(Layout<DK, DV>::kColThreads, 2)
    ssd_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ld,
                   T* __restrict__ o, int heads, int per_group, int n,
                   int stage) {
  using L = Layout<DK, DV>;
  using PK = typename L::PadK;
  using PV = typename L::PadV;
  constexpr int R = L::R;
  extern __shared__ __align__(16) float smem[];  // read as float4
  float* q_sh = smem;                      // (stage, PK::kWidth)
  float* k_sh = q_sh + stage * PK::kWidth;  // (stage, PK::kWidth)
  float* v_sh = k_sh + stage * PK::kWidth;  // (stage, PV::kWidth)
  float* o_sh = v_sh + stage * PV::kWidth;  // (stage, DV)
  float* gam_sh = o_sh + stage * DV;        // (stage,)

  const int bh = blockIdx.x;  // batch * heads + head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int groups = heads / per_group;
  const size_t qk_base =
      (static_cast<size_t>(bi) * groups + hi / per_group) * n * DK;
  const size_t v_base = static_cast<size_t>(bh) * n * DV;
  const size_t ld_base = static_cast<size_t>(bh) * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rg = tid % L::kColGroups;
  const int cg = tid / L::kColGroups;

  float s[4][R];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < R; ++i) s[c][i] = 0.0f;

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t qk_row = qk_base + static_cast<size_t>(t0) * DK;
    const size_t v_row = v_base + static_cast<size_t>(t0) * DV;
    stage_rows<PK, DK>(q_sh, q + qk_row, len, tid, nthr);
    stage_rows<PK, DK>(k_sh, k + qk_row, len, tid, nthr);
    stage_rows<PV, DV>(v_sh, v + v_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr)
      gam_sh[t] = expf(ld[ld_base + t0 + t]);
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      float acc[4];
      col_step<R>(s, gam_sh[t], k_sh + t * PK::kWidth + PK::at(rg * R),
                  ld4(v_sh + t * PV::kWidth + PV::at(4 * cg)),
                  q_sh + t * PK::kWidth + PK::at(rg * R), acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = lane_sum<L::kColGroups>(acc[c]);
      if (rg == 0)
        *reinterpret_cast<float4*>(o_sh + t * DV + 4 * cg) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    write_out(o + v_row, o_sh, len * DV, tid, nthr);
    __syncthreads();  // the next iteration overwrites the staging
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(Layout<DK, DV>::kRowThreads, 2)
    ssd_bwd_q_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ ld, const T* __restrict__ om,
                     float* __restrict__ dq, int heads, int per_group, int n,
                     int stage) {
  using L = Layout<DK, DV>;
  using PK = typename L::PadK;
  using PV = typename L::PadV;
  constexpr int C = L::C;
  extern __shared__ __align__(16) float smem[];
  float* k_sh = smem;                        // (stage, PK::kWidth)
  float* v_sh = k_sh + stage * PK::kWidth;   // (stage, PV::kWidth)
  float* om_sh = v_sh + stage * PV::kWidth;  // (stage, PV::kWidth)
  float* dq_sh = om_sh + stage * PV::kWidth;  // (stage, DK)
  float* gam_sh = dq_sh + stage * DK;         // (stage,)

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int groups = heads / per_group;
  const size_t k_base =
      (static_cast<size_t>(bi) * groups + hi / per_group) * n * DK;
  const size_t v_base = static_cast<size_t>(bh) * n * DV;
  const size_t dq_base = static_cast<size_t>(bh) * n * DK;
  const size_t ld_base = static_cast<size_t>(bh) * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int cg = tid % L::kRowGroups;
  const int dg = tid / L::kRowGroups;

  float s[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) s[r][j] = 0.0f;

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t v_row = v_base + static_cast<size_t>(t0) * DV;
    stage_rows<PK, DK>(k_sh, k + k_base + static_cast<size_t>(t0) * DK, len,
                       tid, nthr);
    stage_rows<PV, DV>(v_sh, v + v_row, len, tid, nthr);
    stage_rows<PV, DV>(om_sh, om + v_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr)
      gam_sh[t] = expf(ld[ld_base + t0 + t]);
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      float acc[4];
      row_step<C>(s, gam_sh[t], ld4(k_sh + t * PK::kWidth + PK::at(4 * dg)),
                  v_sh + t * PV::kWidth + PV::at(cg * C),
                  om_sh + t * PV::kWidth + PV::at(cg * C), acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = lane_sum<L::kRowGroups>(acc[r]);
      if (cg == 0)
        *reinterpret_cast<float4*>(dq_sh + t * DK + 4 * dg) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    write_out(dq + dq_base + static_cast<size_t>(t0) * DK, dq_sh, len * DK,
              tid, nthr);
    __syncthreads();
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(Layout<DK, DV>::kRowThreads +
                                      Layout<DK, DV>::kColThreads,
                                  2)
    ssd_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ ld,
                      const T* __restrict__ om, float* __restrict__ dk,
                      float* __restrict__ dv, int heads, int per_group,
                      int n, int stage) {
  using L = Layout<DK, DV>;
  using PK = typename L::PadK;
  using PV = typename L::PadV;
  constexpr int R = L::R;
  // both roles keep U in one register array of the same shape
  static_assert(L::R == L::C, "row and column tiles of equal size");
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                         // (stage, PK::kWidth)
  float* k_sh = q_sh + stage * PK::kWidth;    // (stage, PK::kWidth)
  float* v_sh = k_sh + stage * PK::kWidth;    // (stage, PV::kWidth)
  float* om_sh = v_sh + stage * PV::kWidth;   // (stage, PV::kWidth)
  float* dk_sh = om_sh + stage * PV::kWidth;  // (stage, DK)
  float* dv_sh = dk_sh + stage * DK;          // (stage, DV)
  float* gam_sh = dv_sh + stage * DV;         // (stage,)

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int groups = heads / per_group;
  const size_t qk_base =
      (static_cast<size_t>(bi) * groups + hi / per_group) * n * DK;
  const size_t v_base = static_cast<size_t>(bh) * n * DV;
  const size_t dk_base = static_cast<size_t>(bh) * n * DK;
  const size_t ld_base = static_cast<size_t>(bh) * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const bool row_role = tid < L::kRowThreads;  // warp-uniform
  const int ct = tid - L::kRowThreads;         // column role's thread
  // row role: rows 4dg..4dg+3, columns cgr*C..; column role: columns
  // 4cgc..4cgc+3, rows rg*R..
  const int cgr = tid % L::kRowGroups;
  const int dg = tid / L::kRowGroups;
  const int rg = ct % L::kColGroups;
  const int cgc = ct / L::kColGroups;

  float u[4][R];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < R; ++i) u[a][i] = 0.0f;
  float gam_next = 1.0f;  // γ of the token walked last (U starts at 0)

  for (int end = n; end > 0; end -= stage) {
    const int t0 = max(0, end - stage);
    const int len = end - t0;
    const size_t qk_row = qk_base + static_cast<size_t>(t0) * DK;
    const size_t v_row = v_base + static_cast<size_t>(t0) * DV;
    stage_rows<PK, DK>(q_sh, q + qk_row, len, tid, nthr);
    stage_rows<PK, DK>(k_sh, k + qk_row, len, tid, nthr);
    stage_rows<PV, DV>(v_sh, v + v_row, len, tid, nthr);
    stage_rows<PV, DV>(om_sh, om + v_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr)
      gam_sh[t] = expf(ld[ld_base + t0 + t]);
    __syncthreads();

    if (row_role) {
      for (int t = len - 1; t >= 0; --t) {
        float acc[4];
        row_step<R>(u, gam_next, ld4(q_sh + t * PK::kWidth + PK::at(4 * dg)),
                    om_sh + t * PV::kWidth + PV::at(cgr * R),
                    v_sh + t * PV::kWidth + PV::at(cgr * R), acc);
        gam_next = gam_sh[t];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = lane_sum<L::kRowGroups>(acc[r]);
        if (cgr == 0)
          *reinterpret_cast<float4*>(dk_sh + t * DK + 4 * dg) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    } else {
      for (int t = len - 1; t >= 0; --t) {
        float acc[4];
        col_step<R>(u, gam_next, q_sh + t * PK::kWidth + PK::at(rg * R),
                    ld4(om_sh + t * PV::kWidth + PV::at(4 * cgc)),
                    k_sh + t * PK::kWidth + PK::at(rg * R), acc);
        gam_next = gam_sh[t];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = lane_sum<L::kColGroups>(acc[c]);
        if (rg == 0)
          *reinterpret_cast<float4*>(dv_sh + t * DV + 4 * cgc) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    __syncthreads();
    write_out(dk + dk_base + static_cast<size_t>(t0) * DK, dk_sh, len * DK,
              tid, nthr);
    write_out(dv + v_row, dv_sh, len * DV, tid, nthr);
    __syncthreads();
  }
}

enum class Kind { kFwd, kBwdQ, kBwdKV };

template <Kind K, int DK, int DV>
struct Plan {
  using L = Layout<DK, DV>;
  static constexpr int kThreads =
      K == Kind::kFwd    ? L::kColThreads
      : K == Kind::kBwdQ ? L::kRowThreads
                         : L::kRowThreads + L::kColThreads;
  // staged floats per token: inputs, outputs and the decay
  static constexpr size_t kPerToken =
      K == Kind::kFwd
          ? 2 * L::PadK::kWidth + L::PadV::kWidth + DV + 1
      : K == Kind::kBwdQ
          ? L::PadK::kWidth + 2 * L::PadV::kWidth + DK + 1
          : 2 * L::PadK::kWidth + 2 * L::PadV::kWidth + DK + DV + 1;
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ld;
  const void* om;
  void* out0;
  void* out1;
  int batch, heads, groups, n, stage;
  cudaStream_t stream;
};

template <Kind K, typename T, int DK, int DV>
cudaError_t launch(const Args& a) {
  using P = Plan<K, DK, DV>;
  const size_t per_token = P::kPerToken * sizeof(float);
  const int stage = static_cast<int>(
      std::min(static_cast<size_t>(a.stage), kMaxSmem / per_token));
  if (stage < 1) return cudaErrorInvalidValue;
  const size_t smem = stage * per_token;
  const int blocks = a.batch * a.heads;
  const int per_group = a.heads / a.groups;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const float* ld = static_cast<const float*>(a.ld);
  const T* om = static_cast<const T*>(a.om);
  cudaError_t err;
  if constexpr (K == Kind::kFwd) {
    auto kernel = ssd_fwd_kernel<T, DK, DV>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, P::kThreads, smem, a.stream>>>(
        q, k, v, ld, static_cast<T*>(a.out0), a.heads, per_group, a.n,
        stage);
  } else if constexpr (K == Kind::kBwdQ) {
    auto kernel = ssd_bwd_q_kernel<T, DK, DV>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, P::kThreads, smem, a.stream>>>(
        k, v, ld, om, static_cast<float*>(a.out0), a.heads, per_group, a.n,
        stage);
  } else {
    auto kernel = ssd_bwd_kv_kernel<T, DK, DV>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    kernel<<<blocks, P::kThreads, smem, a.stream>>>(
        q, k, v, ld, om, static_cast<float*>(a.out0),
        static_cast<float*>(a.out1), a.heads, per_group, a.n, stage);
  }
  return cudaGetLastError();
}

template <Kind K, typename T>
cudaError_t dispatch_dims(int dk, int dv, const Args& a) {
  if (dk == 128 && dv == 64) return launch<K, T, 128, 64>(a);
  if (dk == 16 && dv == 32) return launch<K, T, 16, 32>(a);
  return cudaErrorInvalidValue;
}

template <Kind K>
int run(const Args& a, int dk, int dv, int dtype) {
  if (a.batch <= 0 || a.groups <= 0 || a.heads <= 0 || a.n < 0 ||
      a.stage <= 0 || a.heads % a.groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dims<K, float>(dk, dv, a);
  else if (dtype == 1)
    err = dispatch_dims<K, __nv_bfloat16>(dk, dv, a);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (of q, k, v, Ω and o).  Each returns the cudaError_t of its launch
// (0 = success); the launch is asynchronous on `stream`.
extern "C" int ssd_fwd(const void* q, const void* k, const void* v,
                       const void* ld, void* o, int batch, int heads,
                       int groups, int n, int dk, int dv, int stage,
                       int dtype, void* stream) {
  const Args a{q,     k,      v, ld,    nullptr, o, nullptr, batch,
               heads, groups, n, stage, static_cast<cudaStream_t>(stream)};
  return run<Kind::kFwd>(a, dk, dv, dtype);
}

// dq: per-head partials (B, H, N, Dk) f32.
extern "C" int ssd_bwd_q(const void* k, const void* v, const void* ld,
                         const void* om, void* dq, int batch, int heads,
                         int groups, int n, int dk, int dv, int stage,
                         int dtype, void* stream) {
  const Args a{nullptr, k,      v, ld,    om, dq, nullptr, batch,
               heads,   groups, n, stage, static_cast<cudaStream_t>(stream)};
  return run<Kind::kBwdQ>(a, dk, dv, dtype);
}

// dk: per-head partials (B, H, N, Dk) f32; dv (B, H, N, Dv) f32.
extern "C" int ssd_bwd_kv(const void* q, const void* k, const void* v,
                          const void* ld, const void* om, void* dk,
                          void* dv_out, int batch, int heads, int groups,
                          int n, int dk_dim, int dv_dim, int stage,
                          int dtype, void* stream) {
  const Args a{q,     k,      v, ld,    om, dk, dv_out, batch,
               heads, groups, n, stage, static_cast<cudaStream_t>(stream)};
  return run<Kind::kBwdKV>(a, dk_dim, dv_dim, dtype);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
