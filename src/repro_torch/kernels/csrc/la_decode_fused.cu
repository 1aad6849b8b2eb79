// Fused linear-attention and GLA decode steps for Hopper (sm_90a).
//
// Replaces the TPU kernels `la_decode_fused_pallas` and
// `gla_decode_fused_pallas` (src/repro/kernels/decode_fused.py:157 and
// :169; their shared body is `_recurrent_step_kernel`, decode_fused.py:79,
// with `gated` False or True).  One call advances every slot's recurrent
// state by one token and writes the normalized output:
//
//   S <- γ S + k^T [v, 1]  P <- γ P + [v, 1]      (state, f32, in place)
//   f  = a P + b q S       over the G query heads of the KV head
//   o  = f[:Dv] / f[Dv]    with safe_div semantics (|den| < 1e-30 -> 0)
//
// where γ = 1 for the linear entry `la_decode_fused` and γ = exp(ld[b, hk])
// for the gated entry `gla_decode_fused` (the decay gate, applied to the
// carried state before the rank-1 update).  Both are one kernel body with
// a compile-time `kGated` flag; the linear instantiation is the ungated
// code unchanged.
//
// Shapes (all contiguous): s (B, Hkv, Dk, Dv+1) f32, p (B, Hkv, Dv+1) f32,
// q (B, H, Dk), k (B, Hkv, Dk), v (B, Hkv, Dv) and o (B, H, Dv) in the
// compute type T (float or bf16), ld (B, Hkv) f32 (gated only), H = G * Hkv
// with query head hk*G + g reading KV head hk.
//
// What bounds it: pure streaming of the f32 state.  Every state element
// is read once and written once, and the arithmetic is 2 + 2G flops per
// element (one more multiply per element when gated).  At B=8, Hkv=16,
// Dk=Dv=128 one launch moves 2 * 8*16*128*129 * 4 B ~= 16.9 MB, ~5 us at
// 3.35 TB/s (an estimate from the shapes, not a measurement); the gate adds
// 512 B of ld.
//
// Design (simple first; vector loads and several KV heads per block are
// later work):
//   * one block per (slot, KV head), so the state slab of a block is one
//     contiguous (Dk, Dv+1) row-major matrix;
//   * threads stride over the Dv+1 columns, so each row of S is read and
//     written coalesced; each thread walks down its column over Dk,
//     updating S[i, j] in place and accumulating the G dot products
//     q_g . S_new[:, j] in registers;
//   * k, [v, 1] and the group's G query rows are staged in shared memory
//     (read as broadcasts in the inner loop);
//   * the un-normalized f lands in shared memory, so the normalizer
//     column's G values are visible to every thread for the divide.
// The state is updated in place: the counterpart of the TPU kernel's
// input_output_aliases={0: 0, 1: 1}.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <string.h>

#include "plan.cuh"

namespace {

constexpr float kSafeEps = 1e-30f;  // core.numerics.safe_div threshold
constexpr int kMaxThreads = 1024;
constexpr size_t kMaxSmem = 48 * 1024;

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

template <typename T, int G, bool kGated>
__global__ void la_decode_fused_kernel(float* __restrict__ s,
                                       float* __restrict__ p,
                                       const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v,
                                       const float* __restrict__ ld,
                                       T* __restrict__ o, int dk, int dv,
                                       float a, float b) {
  extern __shared__ float smem[];
  const int dv1 = dv + 1;
  float* k_sh = smem;            // (Dk,)
  float* va_sh = k_sh + dk;      // (Dv+1,)  [v, 1]
  float* q_sh = va_sh + dv1;     // (G, Dk)
  float* f_sh = q_sh + G * dk;   // (G, Dv+1) un-normalized output

  const size_t bh = blockIdx.x;  // slot * Hkv + kv head
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;

  const T* k_row = k + bh * dk;
  const T* v_row = v + bh * dv;
  const T* q_rows = q + bh * G * dk;  // the G query heads of this KV head
  for (int i = tid; i < dk; i += nthr) k_sh[i] = to_f32(k_row[i]);
  for (int j = tid; j < dv1; j += nthr)
    va_sh[j] = j < dv ? to_f32(v_row[j]) : 1.0f;
  for (int i = tid; i < G * dk; i += nthr) q_sh[i] = to_f32(q_rows[i]);
  __syncthreads();

  float* s_slab = s + bh * dk * dv1;
  float* p_row = p + bh * dv1;
  float gam = 1.0f;  // the decay gate of this (slot, KV head)
  if constexpr (kGated) gam = expf(ld[bh]);
  for (int j = tid; j < dv1; j += nthr) {
    const float vj = va_sh[j];
    float acc[G];
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = 0.0f;
#pragma unroll 4
    for (int i = 0; i < dk; ++i) {
      float* cell = s_slab + static_cast<size_t>(i) * dv1 + j;
      float s_new;
      if constexpr (kGated)
        s_new = fmaf(k_sh[i], vj, gam * *cell);  // gam == 1: the ungated sum
      else
        s_new = *cell + k_sh[i] * vj;
      *cell = s_new;
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] += q_sh[g * dk + i] * s_new;
    }
    float p_new;
    if constexpr (kGated)
      p_new = fmaf(gam, p_row[j], vj);
    else
      p_new = p_row[j] + vj;
    p_row[j] = p_new;
#pragma unroll
    for (int g = 0; g < G; ++g) f_sh[g * dv1 + j] = a * p_new + b * acc[g];
  }
  __syncthreads();

  T* o_rows = o + bh * G * dv;
  for (int idx = tid; idx < G * dv; idx += nthr) {
    const int g = idx / dv;
    const int j = idx - g * dv;
    const float den = f_sh[g * dv1 + dv];
    const float val = fabsf(den) < kSafeEps ? 0.0f : f_sh[g * dv1 + j] / den;
    o_rows[idx] = from_f32<T>(val);
  }
}

// The launch of la_decode_fused / gla_decode_fused, shared by the launcher
// and `la_decode_fused_plan`: f(Type<T>{}, kernel, geometry) for the
// instantiation a call with these arguments runs.  One block per (slot, KV
// head); threads stride over the Dv+1 columns; k, [v, 1], the group's G
// query rows and its G un-normalized rows f in shared memory, at most
// kMaxSmem (the launcher refuses more).
template <bool kGated, typename F>
cudaError_t with_launch(int dtype, int group, int batch, int kv_heads,
                        int dk, int dv, F&& f) {
  const int dv1 = dv + 1;
  const int threads = std::min((dv1 + 31) / 32 * 32, kMaxThreads);
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_group(group, [&](auto gc) {
      using T = typename decltype(t)::type;
      constexpr int G = decltype(gc)::value;
      const size_t smem =
          static_cast<size_t>(dk + dv1 + G * dk + G * dv1) * sizeof(float);
      auto kernel = la_decode_fused_kernel<T, G, kGated>;
      return f(t, kernel,
               plan::Geometry{dim3(batch * kv_heads), threads, smem, 1});
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int dk, int dv) {
  return batch <= 0 || kv_heads <= 0 || dk <= 0 || dv <= 0 ||
         heads % kv_heads != 0;
}

template <bool kGated>
int run(void* s, void* p, const void* q, const void* k, const void* v,
        const void* ld, void* o, int batch, int heads, int kv_heads, int dk,
        int dv, float a, float b, int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, dk, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch<kGated>(
      dtype, heads / kv_heads, batch, kv_heads, dk, dv,
      [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        if (geo.smem > kMaxSmem) return cudaErrorInvalidValue;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<float*>(s), static_cast<float*>(p),
                            static_cast<const T*>(q),
                            static_cast<const T*>(k),
                            static_cast<const T*>(v),
                            static_cast<const float*>(ld),
                            static_cast<T*>(o), dk, dv, a, b);
      }));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 = success); the launch is
// asynchronous on `stream`.
extern "C" int la_decode_fused(void* s, void* p, const void* q, const void* k,
                               const void* v, void* o, int batch, int heads,
                               int kv_heads, int dk, int dv, float a, float b,
                               int dtype, void* stream) {
  return run<false>(s, p, q, k, v, nullptr, o, batch, heads, kv_heads, dk,
                    dv, a, b, dtype, stream);
}

// The gated step: ld (B, Hkv) f32 is the per-step log decay.
extern "C" int gla_decode_fused(void* s, void* p, const void* q,
                                const void* k, const void* v, const void* ld,
                                void* o, int batch, int heads, int kv_heads,
                                int dk, int dv, float a, float b, int dtype,
                                void* stream) {
  return run<true>(s, p, q, k, v, ld, o, batch, heads, kv_heads, dk, dv, a,
                   b, dtype, stream);
}

// The geometry a call of `entry` ("la_decode_fused" or "gla_decode_fused")
// with these arguments launches, into out[7] (plan.cuh); nothing is
// launched.
extern "C" int la_decode_fused_plan(const char* entry, int batch, int heads,
                                    int kv_heads, int dk, int dv, int dtype,
                                    int64_t* out) {
  const bool gated = strcmp(entry, "gla_decode_fused") == 0;
  if ((!gated && strcmp(entry, "la_decode_fused") != 0) ||
      bad_shape(batch, heads, kv_heads, dk, dv))
    return static_cast<int>(cudaErrorInvalidValue);
  auto report = [&](auto, auto kernel, const plan::Geometry& geo) {
    return plan::report(kernel, geo, out);
  };
  const int group = heads / kv_heads;
  return static_cast<int>(
      gated ? with_launch<true>(dtype, group, batch, kv_heads, dk, dv, report)
            : with_launch<false>(dtype, group, batch, kv_heads, dk, dv,
                                 report));
}

extern "C" const char* la_decode_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
