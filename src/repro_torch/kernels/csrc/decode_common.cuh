// Shared walk of the softmax decode kernels (softmax_decode_fused.cu over a
// contiguous cache, paged_decode.cu over a paged arena).
//
// `decode::attend` is one block's work: R query rows of one slot, all
// reading the same KV head, attend to the first `len` keys,
//
//   s_j = scale * q . k_j         for j < len
//   o   = sum_j softmax(s)_j v_j  (online softmax in f32, divided here)
//
// and a walk of length 0 writes zeros (the guarded divide).  Where key j's
// row lies is the caller's `KeyRow` (element offset of the row in k and
// v), so one body serves every cache layout.  Each of the block's warps
// walks every W-th key; a lane owns D/32 columns, loads its slice of
// kUnroll keys' K and V rows before it uses any (several loads in flight),
// reduces each q.k over the warp with shuffles and keeps its own running
// max, sum and output slice per row.  The warps' partial softmaxes merge
// in shared memory (`merge_floats` floats).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace decode {

constexpr float kNegInf = -1e30f;
constexpr int kUnroll = 4;  // keys whose rows a warp loads before using
constexpr int kMaxWarps = 16;

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

// E consecutive elements from `src` into f32 registers, by one vector load
// where E * sizeof(T) is 4, 8 or 16 bytes
template <typename T, int E>
__device__ __forceinline__ void load_slice(float (&dst)[E],
                                           const T* __restrict__ src) {
  constexpr int kBytes = E * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    using Vec = typename std::conditional<
        kBytes == 16, int4,
        typename std::conditional<kBytes == 8, int2, int>::type>::type;
    Vec raw = *reinterpret_cast<const Vec*>(src);
    const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = to_f32(vals[e]);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) dst[e] = to_f32(src[e]);
  }
}

// shared-memory floats `attend` needs for its merge
__host__ __device__ inline size_t merge_floats(int warps, int rows, int d) {
  return static_cast<size_t>(warps) * rows * (d + 2);
}

// q and o point at the block's R query rows (consecutive, D apart);
// key_row(j) is the element offset of key j's row in k and v.  Every
// thread of the block calls it (it synchronizes the block).
template <typename T, int D, int R, typename KeyRow>
__device__ __forceinline__ void attend(const T* __restrict__ q,
                                       const T* __restrict__ k,
                                       const T* __restrict__ v, int len,
                                       const KeyRow& key_row,
                                       T* __restrict__ o, float scale,
                                       float* smem) {
  constexpr int E = D / 32;  // columns a lane owns
  const int warps = blockDim.x >> 5;
  float* m_sh = smem;                  // (W, R)
  float* l_sh = m_sh + warps * R;      // (W, R)
  float* acc_sh = l_sh + warps * R;    // (W, R, D)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* kl = k + lane * E;
  const T* vl = v + lane * E;

  float qr[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    load_slice<T, E>(qr[r], q + r * D + lane * E);
#pragma unroll
    for (int e = 0; e < E; ++e) qr[r][e] *= scale;
  }
  float m_run[R], l_run[R], acc[R][E];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  for (int j0 = warp; j0 < len; j0 += kUnroll * warps) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * warps;
      if (j < len) {
        const size_t row = key_row(j);
        load_slice<T, E>(kr[u], kl + row);
        load_slice<T, E>(vr[u], vl + row);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * warps >= len) break;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[r][e], kr[u][e], s);
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, sh);
        const float m_new = fmaxf(m_run[r], s);
        const float corr = expf(m_run[r] - m_new);
        const float p = expf(s - m_new);
        l_run[r] = corr * l_run[r] + p;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[r][e] = fmaf(p, vr[u][e], corr * acc[r][e]);
        m_run[r] = m_new;
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      m_sh[warp * R + r] = m_run[r];
      l_sh[warp * R + r] = l_run[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc_sh[(warp * R + r) * D + lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < R * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    float m_all = kNegInf;
    for (int w = 0; w < warps; ++w) m_all = fmaxf(m_all, m_sh[w * R + r]);
    float l_all = 0.f, a_all = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float f = expf(m_sh[w * R + r] - m_all);
      l_all = fmaf(f, l_sh[w * R + r], l_all);
      a_all = fmaf(f, acc_sh[(w * R + r) * D + d], a_all);
    }
    // length 0: l_all == 0 and a_all == 0, so the guarded divide gives 0
    const float l_safe = l_all <= 0.f ? 1.f : l_all;
    o[r * D + d] = from_f32<T>(a_all / l_safe);
  }
}

}  // namespace decode
