// Causal normalized linear-attention forward, plain and decay-gated, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `la_fwd_pallas`
// (src/repro/kernels/linear_attention.py:96; its body is `_fwd_kernel`,
// linear_attention.py:67) and, as the `kGated` instantiation behind the
// entry `gla_fwd`, `gla_fwd_pallas` (src/repro/kernels/gla.py:118; body
// `_gla_fwd_kernel`, gla.py:77).  For every (batch, query head) and token t:
//
//   S_t = γ_t S_{t-1} + k_t^T [v_t, 1]  (Dk, Dv+1), f32
//   P_t = γ_t P_{t-1} + [v_t, 1]        (Dv+1,),    f32
//   f_t = a P_t + b q_t S_t             (the causal sum includes t)
//   o_t = f_t[:Dv] / f_t[Dv]            safe_div semantics: |den| < 1e-30 -> 0
//   g_t = f_t[Dv]                       the normalizer, the backward's residual
//
// with the decay γ_t = exp(ld_t) of token t applied to the state carried
// from t-1, never to token t's own term; γ_t = 1 for `la_fwd`.  This is the
// chunked form's intra-chunk (a + b q k^T)[v, 1] (decay-masked) plus its
// inter-chunk a P + b q S, summed token by token.  Every factor is
// exp(ld) <= 1, so nothing overflows and the reference's clamp of the
// decay exponent (`_decay_tri`, gla.py:58) has no counterpart.  The ones
// column of [v, 1] is implicit.  Both entries divide with the `xla`
// impls' safe_div (src/repro/core/chunked.py:140, src/repro/core/gla.py:153);
// the Pallas kernels divide plainly (linear_attention.py:89) or guard
// only g == 0 (gla.py:107).  They differ only where |g| < 1e-30.
//
// Shapes (all contiguous): q (B, H, N, D), k and v (B, Hkv, N, D) in the
// compute type T (float or bf16), o (B, H, N, D) in T, g (B, H, N) f32,
// ld (B, Hkv, N) f32 (gated only: one decay per KV head, shared by its
// query group).  H = G * Hkv, and query head h reads KV head h / G.
// Dk = Dv = D, a template parameter (32, 64 or 128) so that a state column
// lives in registers.
//
// What bounds it: the recurrent form does 4 D (D+1) flops per token and
// head (the state update and the q.S readout; gated, 5 D (D+1) with the
// decay), in f32 on the CUDA cores; at B=2, H=16, N=8192, D=128 that is
// 17.3 GFLOP (gated 21.6), 0.26 ms (0.32) at 67 TFLOP/s, against 0.08 ms
// for its 269.5 MB at 3.35 TB/s (estimates from the shapes, not
// measurements).
//
// Design (simple first; a chunk-parallel two-pass form on wgmma is later
// work):
//   * one block per (batch, query head), walking the whole sequence: a
//     (B, H) grid, 32 blocks at B=2, H=16, on 132 SMs;
//   * the D value columns of S are tiled over D threads: thread (cg, rg)
//     owns columns 4cg..4cg+3 and rows rg*D/4..(rg+1)*D/4-1, a 4 x D/4
//     tile in registers, so each float it reads from shared memory feeds
//     4 FMAs.  The 4 row groups of a column group are adjacent lanes and
//     sum their partial q.S dots with two shuffles;
//   * one more warp keeps the normalizer column (the running sum of k)
//     and its q dot, reduced across the warp; P's normalizer entry is
//     the token count;
//   * per iteration the block stages `stage` tokens of q, k and v in
//     shared memory as f32 (bf16 products are exact in f32) by 16-byte
//     loads, each row padded by 4 floats per row group so that the row
//     groups of a warp read disjoint banks; the tail iteration is bounded
//     by N, nothing is padded in device memory;
//   * the un-normalized f of the staged tokens lands in shared memory,
//     so every thread sees the normalizer for the divide;
//   * gated: the staging also holds the tokens' decays exp(ld) (one expf
//     per token, not per thread), and every state element, P and the
//     normalizer warp's column and count take one multiply more.  At
//     ld = 0 each update is the ungated one exactly (1 * x is x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr float kSafeEps = 1e-30f;  // core.numerics.safe_div threshold
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

// Shared-memory row of one token: D floats in 4 row groups of D/4, each
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

template <typename T, int D, bool kGated>
__global__ void la_fwd_kernel(const T* __restrict__ q,
                              const T* __restrict__ k,
                              const T* __restrict__ v,
                              const float* __restrict__ ld,
                              T* __restrict__ o, float* __restrict__ g,
                              int heads, int kv_heads, int n, int stage,
                              float a, float b) {
  using L = Rows<D>;
  constexpr int R = L::kGroup;    // rows of a thread's tile
  constexpr int DP = L::kPadded;
  constexpr int R2 = D / 32;      // rows per lane of the normalizer warp
  extern __shared__ __align__(16) float smem[];  // read as float4
  float* q_sh = smem;               // (stage, DP)
  float* k_sh = q_sh + stage * DP;  // (stage, DP)
  float* v_sh = k_sh + stage * DP;  // (stage, DP)
  float* f_sh = v_sh + stage * DP;  // (stage, D+1) un-normalized output
  float* gam_sh = f_sh + stage * (D + 1);  // (stage,) decays (gated only)

  const int bh = blockIdx.x;  // batch * heads + query head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int group = heads / kv_heads;
  const size_t q_base = static_cast<size_t>(bh) * n * D;
  const size_t ld_base = (static_cast<size_t>(bi) * kv_heads + hi / group) * n;
  const size_t kv_base = ld_base * D;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rg = tid & 3;   // value threads: row group
  const int cg = tid >> 2;  // value threads: column group
  const int lane = tid - D; // normalizer warp

  float s[4][R];  // value threads: S[rg*R + i, 4cg + c]
  float p[4];     // value threads: P[4cg + c]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p[c] = 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) s[c][i] = 0.0f;
  }
  float ks[R2];   // normalizer warp: S[lane*R2 + r, D] = running sum of k
#pragma unroll
  for (int r = 0; r < R2; ++r) ks[r] = 0.0f;
  float count = 0.0f;  // normalizer warp, gated: P[D], the decayed count

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t q_row = q_base + static_cast<size_t>(t0) * D;
    const size_t kv_row = kv_base + static_cast<size_t>(t0) * D;
    stage_rows<D>(q_sh, q + q_row, len, tid, nthr);
    stage_rows<D>(k_sh, k + kv_row, len, tid, nthr);
    stage_rows<D>(v_sh, v + kv_row, len, tid, nthr);
    if constexpr (kGated) {
      for (int t = tid; t < len; t += nthr)
        gam_sh[t] = expf(ld[ld_base + t0 + t]);
    }
    __syncthreads();

    if (tid < D) {
      for (int t = 0; t < len; ++t) {
        [[maybe_unused]] const float gam = kGated ? gam_sh[t] : 1.0f;
        const float4 vv =
            *reinterpret_cast<const float4*>(v_sh + t * DP + L::at(4 * cg));
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
        const float4* qt =
            reinterpret_cast<const float4*>(q_sh + t * DP + rg * (R + 4));
        const float4* kt =
            reinterpret_cast<const float4*>(k_sh + t * DP + rg * (R + 4));
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i4 = 0; i4 < R / 4; ++i4) {
          const float4 kk4 = kt[i4];
          const float4 qq4 = qt[i4];
          const float kk[4] = {kk4.x, kk4.y, kk4.z, kk4.w};
          const float qq[4] = {qq4.x, qq4.y, qq4.z, qq4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if constexpr (kGated)
                s[c][4 * i4 + r] = fmaf(kk[r], vc[c], gam * s[c][4 * i4 + r]);
              else
                s[c][4 * i4 + r] += kk[r] * vc[c];
              acc[c] += qq[r] * s[c][4 * i4 + r];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 1);
          acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], 2);
          if constexpr (kGated)
            p[c] = fmaf(gam, p[c], vc[c]);
          else
            p[c] += vc[c];
        }
        if (rg == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            f_sh[t * (D + 1) + 4 * cg + c] = a * p[c] + b * acc[c];
        }
      }
    } else if (lane < 32) {
      for (int t = 0; t < len; ++t) {
        [[maybe_unused]] const float gam = kGated ? gam_sh[t] : 1.0f;
        float part = 0.0f;
#pragma unroll
        for (int r = 0; r < R2; ++r) {
          const int at = t * DP + L::at(lane * R2 + r);
          if constexpr (kGated)
            ks[r] = fmaf(gam, ks[r], k_sh[at]);
          else
            ks[r] += k_sh[at];
          part += q_sh[at] * ks[r];
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if constexpr (kGated)
          count = fmaf(gam, count, 1.0f);
        else
          count = static_cast<float>(t0 + t + 1);
        if (lane == 0) f_sh[t * (D + 1) + D] = a * count + b * part;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < len * D; idx += nthr) {
      const int t = idx / D;
      const int jj = idx - t * D;
      const float den = f_sh[t * (D + 1) + D];
      const float val =
          fabsf(den) < kSafeEps ? 0.0f : f_sh[t * (D + 1) + jj] / den;
      o[q_row + idx] = from_f32<T>(val);
    }
    for (int t = tid; t < len; t += nthr)
      g[static_cast<size_t>(bh) * n + t0 + t] = f_sh[t * (D + 1) + D];
    __syncthreads();  // the next iteration overwrites the staging
  }
}

template <typename T, int D, bool kGated>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ld, void* o, void* g, int blocks, int heads,
                   int kv_heads, int n, int stage, float a, float b,
                   cudaStream_t stream) {
  // the staging's floats per token: q, k and v padded, f, and the decay
  const size_t per_token =
      static_cast<size_t>(3 * Rows<D>::kPadded + D + 1 + (kGated ? 1 : 0)) *
      sizeof(float);
  stage = static_cast<int>(
      std::min(static_cast<size_t>(stage), kMaxSmem / per_token));
  if (stage < 1) return cudaErrorInvalidValue;
  const size_t smem = stage * per_token;
  auto kernel = la_fwd_kernel<T, D, kGated>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  // D value threads and the normalizer warp
  kernel<<<blocks, D + 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ld),
      static_cast<T*>(o), static_cast<float*>(g), heads, kv_heads, n, stage,
      a, b);
  return cudaGetLastError();
}

template <typename T, bool kGated>
cudaError_t dispatch_dim(int d, const void* q, const void* k, const void* v,
                         const void* ld, void* o, void* g, int blocks,
                         int heads, int kv_heads, int n, int stage, float a,
                         float b, cudaStream_t st) {
  switch (d) {
    case 32:
      return launch<T, 32, kGated>(q, k, v, ld, o, g, blocks, heads,
                                   kv_heads, n, stage, a, b, st);
    case 64:
      return launch<T, 64, kGated>(q, k, v, ld, o, g, blocks, heads,
                                   kv_heads, n, stage, a, b, st);
    case 128:
      return launch<T, 128, kGated>(q, k, v, ld, o, g, blocks, heads,
                                    kv_heads, n, stage, a, b, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <bool kGated>
int run(const void* q, const void* k, const void* v, const void* ld, void* o,
        void* g, int batch, int heads, int kv_heads, int n, int d, int stage,
        float a, float b, int dtype, void* stream) {
  if (batch <= 0 || kv_heads <= 0 || n < 0 || stage <= 0 ||
      heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int blocks = batch * heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<float, kGated>(d, q, k, v, ld, o, g, blocks, heads,
                                      kv_heads, n, stage, a, b, st);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16, kGated>(d, q, k, v, ld, o, g, blocks,
                                              heads, kv_heads, n, stage, a, b,
                                              st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 = success); the launch is
// asynchronous on `stream`.
extern "C" int la_fwd(const void* q, const void* k, const void* v, void* o,
                      void* g, int batch, int heads, int kv_heads, int n,
                      int d, int stage, float a, float b, int dtype,
                      void* stream) {
  return run<false>(q, k, v, nullptr, o, g, batch, heads, kv_heads, n, d,
                    stage, a, b, dtype, stream);
}

// The decay-gated forward: ld (B, Hkv, N) f32 is the per-token log decay.
extern "C" int gla_fwd(const void* q, const void* k, const void* v,
                       const void* ld, void* o, void* g, int batch,
                       int heads, int kv_heads, int n, int d, int stage,
                       float a, float b, int dtype, void* stream) {
  return run<true>(q, k, v, ld, o, g, batch, heads, kv_heads, n, d, stage, a,
                   b, dtype, stream);
}

extern "C" const char* la_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
