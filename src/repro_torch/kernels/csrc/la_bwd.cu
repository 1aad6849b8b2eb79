// Analytic linear-attention backward, plain and decay-gated, for Hopper
// (sm_90a): two kernels, each with a `kGated` instantiation.
//
// Replaces the TPU kernels `la_bwd_pallas`
// (src/repro/kernels/linear_attention.py:208), whose two pallas_calls are
// `_bwd_q_kernel` (:142, grid (B, H, T)) and `_bwd_kv_kernel` (:170,
// grid (B, Hkv, T), run in reverse), and, behind the entries `gla_bwd_q`
// and `gla_bwd_kv`, `gla_bwd_pallas` (src/repro/kernels/gla.py:249;
// `_gla_bwd_q_kernel` :167 and `_gla_bwd_kv_kernel` :202).  With
// Ω̂ = safe_div(ω, g) and h = Σ o·Ω̂ prepared by the caller in f32 (as the
// reference does at linear_attention.py:219-223 and gla.py:262-263),
// paper Eqs. 19-21 give, token by token, with the decay γ_t = exp(ld_t)
// (γ_t = 1 for the linear entries):
//
//   la_bwd_q / gla_bwd_q   (forward scan, one block per (batch, query head))
//     A_t  = γ_t A_{t-1} + k_t^T [v_t, 1]              (Dk, Dv+1)
//     dq_t = b A_t [Ω̂_t, -h_t]                          (Dk,)
//
//   la_bwd_kv / gla_bwd_kv (reverse scan, one block per (batch, KV head))
//     U_p  = γ_{p+1} U_{p+1} + Σ_g [q_gp, 1]^T [Ω̂_gp, h_gp]  (Dk+1, Dv+1)
//     dk_p = b U_p[:Dk] [v_p, -1]                       (Dk,)
//     dv_p = a U_p[Dk, :Dv] + b k_p U_p[:Dk, :Dv]        (Dv,)
//
// The forward scan decays the state carried into t by t's own γ_t; the
// reverse scan carries U_{p+1} into p with γ_{p+1}, the decay of the
// token after p (the weight of query i on key p is Π_{m=p+1..i} γ_m).  g
// runs over the G query heads of the KV head, so dk and dv land on the
// unexpanded (B, Hkv, N, D) tensors with no atomics: the result is
// deterministic.  The sums include the token itself, as the reference's
// causal masks do.
//
// The gated dk/dV' kernel also writes the augmented column of
// dV' = [dv, dv_1]: dv_1,p = -(b k_p · U_p[:Dk, Dv] + a U_p[Dk, Dv]) with
// U's last column built from +h, i.e. dV' = b U^T k + a U[Dk] for the
// reference's [Ω̂, -h].  It returns dV' (B, Hkv, N, Dv+1) in f32 for a
// PyTorch epilogue, as the reference does (gla.py:324-331):
// dcl = -[v, 1]·dV' and dld = the reverse cumsum of dcl.  The epilogue
// needs a dot over Dv per token, which this kernel spreads over D
// threads; keeping it in PyTorch costs one pass over dV' and keeps the
// kernel free of a block reduction per token.
//
// Shapes (all contiguous): q (B, H, N, D), k and v (B, Hkv, N, D) in the
// compute type T (float or bf16); om (B, H, N, D) and h (B, H, N) f32;
// ld (B, Hkv, N) f32 (gated only); dq (B, H, N, D) and dk (B, Hkv, N, D)
// in T; dv (B, Hkv, N, D) in T, or gated dV' (B, Hkv, N, D+1) in f32.
// Dk = Dv = D, a template parameter (32, 64 or 128) so that a state row or
// column lives in registers.
//
// What bounds them (estimates from the shapes, not measurements; B=2,
// H=Hkv=16, N=8192, D=128): la_bwd_q does 4 D (D+1) flops per token and
// head, 17.3 GFLOP, 0.26 ms at 67 TFLOP/s f32, against 0.10 ms for its
// 336.6 MB; la_bwd_kv needs ~6 D^2 per token and head, ~26 GFLOP,
// 0.39 ms, against 0.14 ms for its 470.8 MB.  The gated kernels add one
// multiply per state element and token.  All are bound by f32 operations
// on the CUDA cores.
//
// Design (simple first; as in la_fwd.cu):
//   * every state is tiled over threads in 4 x D/4 register tiles, so each
//     float a thread reads from shared memory feeds 4 FMAs, and the 4
//     partial dots of a tile row are summed across 4 adjacent lanes with
//     two shuffles;
//   * la_bwd_q: thread (dg, cg) owns rows 4dg..4dg+3 of A and columns
//     cg*D/4..(cg+1)*D/4-1; dq_t[d] is the dot of A's row d with the
//     broadcast [Ω̂_t, -h_t]; A's ones column (the running sum of k[d])
//     is kept by every lane of the row;
//   * la_bwd_kv: dk reads U by rows and dv reads it by columns, so the
//     block keeps U twice: D threads tile its rows (4 rows x D/4 columns,
//     plus U[d, Dv] = Σ q[d] h) and compute dk_p; D threads tile its
//     columns (D/4 rows x 4 columns, plus U[Dk, e] = Σ Ω̂[e]) and compute
//     dv_p.  Both copies take the same rank-G update, which doubles the
//     update's flops but needs no cross-tile reduction per token;
//   * inputs are staged `stage` tokens at a time in shared memory as f32
//     by 16-byte loads, each row padded by 4 floats per row group so that
//     the row groups of a warp read disjoint banks; la_bwd_kv stages from the end of the
//     sequence backwards, the tail bounded by N, nothing padded in device
//     memory;
//   * gated: the staging also holds the tokens' decays exp(ld), and every
//     state element takes one multiply more per token (a decay of 1 leaves
//     it exactly as ungated).  For dV''s last entry the row role already
//     holds U's last column U[:Dk, Dv] (its u_last); each row warp sums
//     its share of k.U[:Dk, Dv] with one warp reduction per token into
//     shared memory, and after the stage's tokens the block adds the
//     shares and U[Dk, Dv] (kept by every row thread).  A warp of its own
//     for that column would make 9 warps of ~216 registers at D = 128,
//     more than the register file of one SM's four schedulers holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <string.h>

#include <type_traits>

#include "plan.cuh"

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

// Shared-memory row of one token: D floats in 4 groups of D/4, each
// followed by 4 floats of padding.
template <int D>
struct Rows {
  static constexpr int kGroup = D / 4;
  static constexpr int kPadded = D + 16;
  __device__ static int at(int r) { return r + 4 * (r / kGroup); }
};

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

// Stage `len` contiguous rows of D values from device memory into the
// padded shared-memory rows `dst` as f32, 16 bytes per load; unrolled so
// that each thread keeps several loads in flight (the loads' latency,
// not their bytes, bounds the staging).  The caller guarantees 16-byte
// aligned rows.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int len,
                                           int tid, int nthr) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll 4
  for (int idx = tid; idx < len * (D / V); idx += nthr) {
    const int e = idx * V;
    const int t = e / D;
    float vals[V];
    load16(src + e, vals);
    float* out = dst + t * Rows<D>::kPadded + Rows<D>::at(e - t * D);
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// Sum over the 4 adjacent lanes (lane ^ 1, lane ^ 2) that hold the
// partial dots of one tile row.
__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// dQ: forward scan
// ---------------------------------------------------------------------------

template <typename T, int D, bool kGated>
__global__ void la_bwd_q_kernel(const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ ld,
                                const float* __restrict__ om,
                                const float* __restrict__ hv,
                                T* __restrict__ dq, int heads, int kv_heads,
                                int n, int stage, float b) {
  using L = Rows<D>;
  constexpr int R = L::kGroup;  // columns of a thread's tile
  constexpr int DP = L::kPadded;
  extern __shared__ __align__(16) float smem[];  // read as float4
  float* k_sh = smem;                 // (stage, DP)
  float* v_sh = k_sh + stage * DP;    // (stage, DP)
  float* om_sh = v_sh + stage * DP;   // (stage, DP)
  float* h_sh = om_sh + stage * DP;   // (stage,)
  float* gam_sh = h_sh + stage;       // (stage,) decays (gated only)

  const int bh = blockIdx.x;  // batch * heads + query head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int group = heads / kv_heads;
  const size_t q_base = static_cast<size_t>(bh) * n * D;
  const size_t ld_base = (static_cast<size_t>(bi) * kv_heads + hi / group) * n;
  const size_t kv_base = ld_base * D;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int cg = tid & 3;   // column group of the tile
  const int dg = tid >> 2;  // rows 4dg..4dg+3 of A

  float at_[4][R];  // A[4dg + r, cg*R + e]
  float a1[4];      // A[4dg + r, Dv] = running sum of k[4dg + r]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a1[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < R; ++e) at_[r][e] = 0.0f;
  }

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t q_row = q_base + static_cast<size_t>(t0) * D;
    const size_t kv_row = kv_base + static_cast<size_t>(t0) * D;
    stage_rows<D>(k_sh, k + kv_row, len, tid, nthr);
    stage_rows<D>(v_sh, v + kv_row, len, tid, nthr);
    stage_rows<D>(om_sh, om + q_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr) {
      h_sh[t] = hv[static_cast<size_t>(bh) * n + t0 + t];
      if constexpr (kGated) gam_sh[t] = expf(ld[ld_base + t0 + t]);
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      [[maybe_unused]] const float gam = kGated ? gam_sh[t] : 1.0f;
      const float4 kk4 =
          *reinterpret_cast<const float4*>(k_sh + t * DP + L::at(4 * dg));
      const float kk[4] = {kk4.x, kk4.y, kk4.z, kk4.w};
      const float4* vt =
          reinterpret_cast<const float4*>(v_sh + t * DP + cg * (R + 4));
      const float4* omt =
          reinterpret_cast<const float4*>(om_sh + t * DP + cg * (R + 4));
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e4 = 0; e4 < R / 4; ++e4) {
        const float4 vv4 = vt[e4];
        const float4 oo4 = omt[e4];
        const float vv[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
        const float oo[4] = {oo4.x, oo4.y, oo4.z, oo4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (kGated)
              at_[r][4 * e4 + c] = fmaf(kk[r], vv[c], gam * at_[r][4 * e4 + c]);
            else
              at_[r][4 * e4 + c] += kk[r] * vv[c];
            acc[r] += at_[r][4 * e4 + c] * oo[c];
          }
        }
      }
      const float ht = h_sh[t];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] = sum4(acc[r]);
        if constexpr (kGated)
          a1[r] = fmaf(gam, a1[r], kk[r]);
        else
          a1[r] += kk[r];
      }
      if (cg == 0) {
        T* out = dq + q_row + static_cast<size_t>(t) * D + 4 * dg;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          out[r] = from_f32<T>(b * (acc[r] - a1[r] * ht));
      }
    }
    __syncthreads();  // the next iteration overwrites the staging
  }
}

// ---------------------------------------------------------------------------
// dK / dV: reverse scan, the query group folded into the block
// ---------------------------------------------------------------------------

// dv's element type and row stride: T and D, or gated dV' in f32 with its
// augmented column
template <typename T, int D, bool kGated>
struct DvOut {
  using type = T;
  static constexpr int kStride = D;
};
template <typename T, int D>
struct DvOut<T, D, true> {
  using type = float;
  static constexpr int kStride = D + 1;
};

template <typename T, int D, bool kGated>
__global__ void la_bwd_kv_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const float* __restrict__ ld,
                                 const float* __restrict__ om,
                                 const float* __restrict__ hv,
                                 T* __restrict__ dk,
                                 typename DvOut<T, D, kGated>::type* __restrict__ dv,
                                 int heads, int kv_heads, int n, int stage,
                                 float a, float b) {
  using L = Rows<D>;
  using TV = typename DvOut<T, D, kGated>::type;
  constexpr int VS = DvOut<T, D, kGated>::kStride;
  constexpr int R = L::kGroup;
  constexpr int DP = L::kPadded;
  constexpr int kRowWarps = D / 32;
  extern __shared__ __align__(16) float smem[];  // read as float4
  const int group = heads / kv_heads;
  float* q_sh = smem;                         // (G, stage, DP)
  float* om_sh = q_sh + group * stage * DP;   // (G, stage, DP)
  float* k_sh = om_sh + group * stage * DP;   // (stage, DP)
  float* v_sh = k_sh + stage * DP;            // (stage, DP)
  float* h_sh = v_sh + stage * DP;            // (G, stage), after the rows:
                                              // they stay 16-byte aligned
  // gated only: the decays, each row warp's share of k.U[:Dk, Dv], and
  // U[Dk, Dv], per staged token
  float* gam_sh = h_sh + group * stage;       // (stage,)
  float* kpart_sh = gam_sh + stage;           // (stage, kRowWarps)
  float* hh_sh = kpart_sh + stage * kRowWarps;  // (stage,)

  const int bk = blockIdx.x;  // batch * kv_heads + KV head
  const int bi = bk / kv_heads;
  const int hk = bk - bi * kv_heads;
  const size_t kv_base = static_cast<size_t>(bk) * n * D;
  // query head hk * G + gi reads this KV head
  const size_t q_head0 = static_cast<size_t>(bi) * heads + hk * group;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // row role (tid < D): rows 4*(tid/4).. of U, columns (tid%4)*R..;
  // column role: rows ((tid-D)%4)*R.., columns 4*((tid-D)/4)..
  const bool row_role = tid < D;
  const int x = row_role ? tid : tid - D;
  const int grp4 = x >> 2;  // which 4 rows (row role) or 4 columns
  const int sub = x & 3;    // which D/4 columns (row role) or rows

  float u[4][R];  // row role: U[4grp4 + r, sub*R + e];
                  // column role: U[sub*R + i, 4grp4 + c], stored [c][i]
  float u_last[4];  // row role: U[4grp4 + r, Dv]; column: U[Dk, 4grp4 + c]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u_last[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < R; ++e) u[r][e] = 0.0f;
  }
  // gated, row role: U[Dk, Dv] = the decayed sum of h
  [[maybe_unused]] float u_hh = 0.0f;
  // gated: the decay of the token after the current one (U starts at
  // zero, so its first value is never used)
  [[maybe_unused]] float g_next = 1.0f;

  for (int t_end = n; t_end > 0; t_end -= stage) {
    const int t0 = max(0, t_end - stage);
    const int len = t_end - t0;
    for (int gi = 0; gi < group; ++gi) {
      const size_t src = ((q_head0 + gi) * n + t0) * D;
      stage_rows<D>(q_sh + gi * stage * DP, q + src, len, tid, nthr);
      stage_rows<D>(om_sh + gi * stage * DP, om + src, len, tid, nthr);
    }
    for (int idx = tid; idx < group * len; idx += nthr) {
      const int gi = idx / len;
      const int t = idx - gi * len;
      h_sh[gi * stage + t] = hv[(q_head0 + gi) * n + t0 + t];
    }
    if constexpr (kGated) {
      for (int t = tid; t < len; t += nthr)
        gam_sh[t] = expf(ld[static_cast<size_t>(bk) * n + t0 + t]);
    }
    const size_t kv_row = kv_base + static_cast<size_t>(t0) * D;
    stage_rows<D>(k_sh, k + kv_row, len, tid, nthr);
    stage_rows<D>(v_sh, v + kv_row, len, tid, nthr);
    __syncthreads();

    for (int t = len - 1; t >= 0; --t) {
      // the token's row of dv (or dV')
      TV* dv_row = dv + (static_cast<size_t>(bk) * n + t0 + t) * VS;
      if constexpr (kGated) {
        // carry U_{p+1} into p: decay by γ_{p+1}
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          u_last[r] *= g_next;
#pragma unroll
          for (int e = 0; e < R; ++e) u[r][e] *= g_next;
        }
        u_hh *= g_next;
        g_next = gam_sh[t];
      }
      if (row_role) {
        for (int gi = 0; gi < group; ++gi) {
          const float* base = (gi * stage + t) * DP + q_sh;
          const float4 qq4 =
              *reinterpret_cast<const float4*>(base + L::at(4 * grp4));
          const float qq[4] = {qq4.x, qq4.y, qq4.z, qq4.w};
          const float4* omt = reinterpret_cast<const float4*>(
              om_sh + (gi * stage + t) * DP + sub * (R + 4));
#pragma unroll
          for (int e4 = 0; e4 < R / 4; ++e4) {
            const float4 oo4 = omt[e4];
            const float oo[4] = {oo4.x, oo4.y, oo4.z, oo4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
#pragma unroll
              for (int r = 0; r < 4; ++r) u[r][4 * e4 + c] += qq[r] * oo[c];
            }
          }
          const float hg = h_sh[gi * stage + t];
#pragma unroll
          for (int r = 0; r < 4; ++r) u_last[r] += qq[r] * hg;
          if constexpr (kGated) u_hh += hg;
        }
        const float4* vt =
            reinterpret_cast<const float4*>(v_sh + t * DP + sub * (R + 4));
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int e4 = 0; e4 < R / 4; ++e4) {
          const float4 vv4 = vt[e4];
          const float vv[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r] += u[r][4 * e4 + c] * vv[c];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = sum4(acc[r]);
        if (sub == 0) {
          T* out = dk + kv_row + static_cast<size_t>(t) * D + 4 * grp4;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            out[r] = from_f32<T>(b * (acc[r] - u_last[r]));
        }
        if constexpr (kGated) {
          // this warp's share of k.U[:Dk, Dv] (rows 4grp4.. of its sub-0
          // lanes), and U[Dk, Dv]
          float part = 0.0f;
          if (sub == 0) {
            const float4 kk4 = *reinterpret_cast<const float4*>(
                k_sh + t * DP + L::at(4 * grp4));
            part = kk4.x * u_last[0] + kk4.y * u_last[1] +
                   kk4.z * u_last[2] + kk4.w * u_last[3];
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if ((tid & 31) == 0) kpart_sh[t * kRowWarps + (tid >> 5)] = part;
          if (tid == 0) hh_sh[t] = u_hh;
        }
      } else {
        for (int gi = 0; gi < group; ++gi) {
          const float* obase = om_sh + (gi * stage + t) * DP;
          const float4 oo4 =
              *reinterpret_cast<const float4*>(obase + L::at(4 * grp4));
          const float oo[4] = {oo4.x, oo4.y, oo4.z, oo4.w};
          const float4* qt = reinterpret_cast<const float4*>(
              q_sh + (gi * stage + t) * DP + sub * (R + 4));
#pragma unroll
          for (int i4 = 0; i4 < R / 4; ++i4) {
            const float4 qq4 = qt[i4];
            const float qq[4] = {qq4.x, qq4.y, qq4.z, qq4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int c = 0; c < 4; ++c) u[c][4 * i4 + r] += qq[r] * oo[c];
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) u_last[c] += oo[c];
        }
        const float4* kt =
            reinterpret_cast<const float4*>(k_sh + t * DP + sub * (R + 4));
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i4 = 0; i4 < R / 4; ++i4) {
          const float4 kk4 = kt[i4];
          const float kk[4] = {kk4.x, kk4.y, kk4.z, kk4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] += kk[r] * u[c][4 * i4 + r];
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = sum4(acc[c]);
        if (sub == 0) {
          TV* out = dv_row + 4 * grp4;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            out[c] = from_f32<TV>(a * u_last[c] + b * acc[c]);
        }
      }
    }
    __syncthreads();  // the next iteration overwrites the staging
    if constexpr (kGated) {
      // dV'[Dv] = -(b k.U[:Dk, Dv] + a U[Dk, Dv]) of the stage's tokens;
      // the next stage writes these shares only after its staging barrier
      for (int t = tid; t < len; t += nthr) {
        float dot = 0.0f;
#pragma unroll
        for (int w = 0; w < kRowWarps; ++w) dot += kpart_sh[t * kRowWarps + w];
        dv[(static_cast<size_t>(bk) * n + t0 + t) * VS + D] =
            -(b * dot + a * hh_sh[t]);
      }
    }
  }
}

// The launches of the two kernels, shared by the launchers and
// `la_bwd_plan`: f(Type<T>{}, kernel, geometry) for the instantiation a call
// with these arguments runs, with `stage` shrunk to fit kMaxSmem.
// dq: one block per (batch, query head), D threads; the staging holds k, v
// and Ω̂ padded, h and the decay per token.
template <bool kGated, typename F>
cudaError_t with_launch_q(int dtype, int d, int batch, int heads, int stage,
                          F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      using T = typename decltype(t)::type;
      constexpr int D = decltype(dc)::value;
      const size_t per_token =
          static_cast<size_t>(3 * Rows<D>::kPadded + 1 + (kGated ? 1 : 0)) *
          sizeof(float);
      auto kernel = la_bwd_q_kernel<T, D, kGated>;
      return f(t, kernel,
               plan::fit({dim3(batch * heads), D, 0, 0}, stage, per_token,
                         kMaxSmem));
    });
  });
}

// dk, dv: one block per (batch, KV head), the row and column roles of D
// threads each; the staging holds q and Ω̂ of the G query heads and k and v,
// padded, h of the G heads and, gated, the decay, the row warps' shares of
// k.U[:Dk, Dv] and U[Dk, Dv] per token, so large groups stage fewer tokens.
template <bool kGated, typename F>
cudaError_t with_launch_kv(int dtype, int d, int batch, int heads,
                           int kv_heads, int stage, F&& f) {
  const int group = heads / kv_heads;
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      using T = typename decltype(t)::type;
      constexpr int D = decltype(dc)::value;
      const size_t per_token =
          static_cast<size_t>((2 * group + 2) * Rows<D>::kPadded + group +
                              (kGated ? D / 32 + 2 : 0)) *
          sizeof(float);
      auto kernel = la_bwd_kv_kernel<T, D, kGated>;
      return f(t, kernel,
               plan::fit({dim3(batch * kv_heads), 2 * D, 0, 0}, stage,
                         per_token, kMaxSmem));
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int n, int stage) {
  return batch <= 0 || kv_heads <= 0 || n < 0 || stage <= 0 ||
         heads % kv_heads != 0;
}

template <bool kGated>
int run_q(const void* k, const void* v, const void* ld, const void* om,
          const void* hv, void* dq, int batch, int heads, int kv_heads,
          int n, int d, int stage, float b, int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return static_cast<int>(with_launch_q<kGated>(
      dtype, d, batch, heads, stage,
      [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        if (geo.stage < 1) return cudaErrorInvalidValue;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const T*>(k),
                            static_cast<const T*>(v),
                            static_cast<const float*>(ld),
                            static_cast<const float*>(om),
                            static_cast<const float*>(hv),
                            static_cast<T*>(dq), heads, kv_heads, n,
                            geo.stage, b);
      }));
}

template <bool kGated>
int run_kv(const void* q, const void* k, const void* v, const void* ld,
           const void* om, const void* hv, void* dk, void* dv, int batch,
           int heads, int kv_heads, int n, int d, int stage, float a, float b,
           int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return static_cast<int>(with_launch_kv<kGated>(
      dtype, d, batch, heads, kv_heads, stage,
      [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        // dv's element type (DvOut): T, or f32 for the gated dV'
        using TV = std::conditional_t<kGated, float, T>;
        if (geo.stage < 1) return cudaErrorInvalidValue;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const T*>(q),
                            static_cast<const T*>(k),
                            static_cast<const T*>(v),
                            static_cast<const float*>(ld),
                            static_cast<const float*>(om),
                            static_cast<const float*>(hv),
                            static_cast<T*>(dk), static_cast<TV*>(dv), heads,
                            kv_heads, n, geo.stage, a, b);
      }));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v, dq, dk and the linear dv; om, h, ld and the gated dV' are
// always float32).  Each returns the cudaError_t of its launch
// (0 = success); launches are asynchronous on `stream`.
extern "C" int la_bwd_q(const void* k, const void* v, const void* om,
                        const void* hv, void* dq, int batch, int heads,
                        int kv_heads, int n, int d, int stage, float b,
                        int dtype, void* stream) {
  return run_q<false>(k, v, nullptr, om, hv, dq, batch, heads, kv_heads, n,
                      d, stage, b, dtype, stream);
}

extern "C" int la_bwd_kv(const void* q, const void* k, const void* v,
                         const void* om, const void* hv, void* dk, void* dv,
                         int batch, int heads, int kv_heads, int n, int d,
                         int stage, float a, float b, int dtype,
                         void* stream) {
  return run_kv<false>(q, k, v, nullptr, om, hv, dk, dv, batch, heads,
                       kv_heads, n, d, stage, a, b, dtype, stream);
}

// The gated dq: ld (B, Hkv, N) f32 is the per-token log decay.
extern "C" int gla_bwd_q(const void* k, const void* v, const void* ld,
                         const void* om, const void* hv, void* dq, int batch,
                         int heads, int kv_heads, int n, int d, int stage,
                         float b, int dtype, void* stream) {
  return run_q<true>(k, v, ld, om, hv, dq, batch, heads, kv_heads, n, d,
                     stage, b, dtype, stream);
}

// The gated dk and dV': dva (B, Hkv, N, D+1) f32.
extern "C" int gla_bwd_kv(const void* q, const void* k, const void* v,
                          const void* ld, const void* om, const void* hv,
                          void* dk, void* dva, int batch, int heads,
                          int kv_heads, int n, int d, int stage, float a,
                          float b, int dtype, void* stream) {
  return run_kv<true>(q, k, v, ld, om, hv, dk, dva, batch, heads, kv_heads,
                      n, d, stage, a, b, dtype, stream);
}

// The geometry a call of `entry` ("la_bwd_q", "la_bwd_kv", "gla_bwd_q" or
// "gla_bwd_kv") with these arguments launches, into out[7] (plan.cuh);
// nothing is launched.
extern "C" int la_bwd_plan(const char* entry, int batch, int heads,
                           int kv_heads, int n, int d, int stage, int dtype,
                           int64_t* out) {
  if (bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  auto report = [&](auto, auto kernel, const plan::Geometry& geo) {
    return plan::report(kernel, geo, out);
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (strcmp(entry, "la_bwd_q") == 0)
    err = with_launch_q<false>(dtype, d, batch, heads, stage, report);
  else if (strcmp(entry, "gla_bwd_q") == 0)
    err = with_launch_q<true>(dtype, d, batch, heads, stage, report);
  else if (strcmp(entry, "la_bwd_kv") == 0)
    err = with_launch_kv<false>(dtype, d, batch, heads, kv_heads, stage,
                                report);
  else if (strcmp(entry, "gla_bwd_kv") == 0)
    err = with_launch_kv<true>(dtype, d, batch, heads, kv_heads, stage,
                               report);
  return static_cast<int>(err);
}

extern "C" const char* la_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
