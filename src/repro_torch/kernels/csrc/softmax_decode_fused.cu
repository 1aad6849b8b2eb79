// Fused contiguous-cache softmax decode for Hopper (sm_90a).
//
// Replaces the TPU kernel `softmax_decode_fused_pallas`
// (src/repro/kernels/decode_fused.py:226; its body is
// `_softmax_fused_kernel`, :184).  One call attends every slot's new query
// token to the first lengths[b] keys of its contiguous KV cache:
//
//   s_j = q . k_j / sqrt(D) for j < min(lengths[b], S)
//   o   = sum_j softmax(s)_j v_j      (online softmax, f32, divide here)
//   a slot of length 0 yields zeros, as the Pallas kernel does
//
// Shapes (contiguous): q (B, H, 1, D), k and v (B, Hkv, S, D), lengths
// (B,) int32, o (B, H, 1, D), with H = G * Hkv and query head hk * G + g
// reading KV head hk.  T is float or bf16.
//
// What bounds it: reading the live prefix of the cache.  At B=8, Hkv=16,
// D=128 and 544 live keys a call reads 2 * 8*16*544*128 * 2 B ~= 35.7 MB,
// ~10.6 us at 3.35 TB/s, for 2 flops per byte (an estimate from the
// shapes, not a measurement).
//
// Design (simple first):
//   * one block per (slot, KV head) holds the G query rows of the group in
//     registers, so each K/V row is read once per KV head, not once per
//     query head (the Pallas kernel's head-fold);
//   * each of the block's warps walks every W-th key of the live prefix; a
//     lane owns D/32 columns, loads its slice of 4 keys' K and V rows before
//     it uses any (so several loads are in flight), reduces each q.k over
//     the warp with shuffles and keeps its own online softmax (running
//     max, sum and output slice per query row);
//   * the warps' partial (max, sum, output) merge in shared memory and the
//     divide runs in the kernel; an empty walk leaves sum 0, guarded to 1,
//     so a length-0 slot writes zeros;
//   * the walk is bounded at min(lengths[b], S): a retired slot whose
//     position ran past the cache reads no row beyond it.
// At B=8, Hkv=16 this is 128 blocks; splitting the walk of one (slot, KV
// head) across blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

namespace {

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

template <typename T, int D, int G>
__global__ void softmax_decode_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ o, int kv_heads, int s_len, float scale) {
  constexpr int E = D / 32;  // columns a lane owns
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  float* m_sh = smem;                  // (W, G)
  float* l_sh = m_sh + warps * G;      // (W, G)
  float* acc_sh = l_sh + warps * G;    // (W, G, D)

  const int bh = blockIdx.x;           // slot * Hkv + KV head
  const int b = bh / kv_heads, hk = bh % kv_heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = max(0, min(lengths[b], s_len));
  const size_t heads = static_cast<size_t>(kv_heads) * G;
  const T* kg = k + static_cast<size_t>(bh) * s_len * D + lane * E;
  const T* vg = v + static_cast<size_t>(bh) * s_len * D + lane * E;

  float qr[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    load_slice<T, E>(qr[gi],
                     q + (b * heads + hk * G + gi) * D + lane * E);
#pragma unroll
    for (int e = 0; e < E; ++e) qr[gi][e] *= scale;
  }
  float m_run[G], l_run[G], acc[G][E];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m_run[gi] = kNegInf;
    l_run[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[gi][e] = 0.f;
  }

  for (int j0 = warp; j0 < len; j0 += kUnroll * warps) {
    float kr[kUnroll][E], vr[kUnroll][E];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u * warps;
      if (j < len) {
        load_slice<T, E>(kr[u], kg + static_cast<size_t>(j) * D);
        load_slice<T, E>(vr[u], vg + static_cast<size_t>(j) * D);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u * warps >= len) break;
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) s = fmaf(qr[gi][e], kr[u][e], s);
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, sh);
        const float m_new = fmaxf(m_run[gi], s);
        const float corr = expf(m_run[gi] - m_new);
        const float p = expf(s - m_new);
        l_run[gi] = corr * l_run[gi] + p;
#pragma unroll
        for (int e = 0; e < E; ++e)
          acc[gi][e] = fmaf(p, vr[u][e], corr * acc[gi][e]);
        m_run[gi] = m_new;
      }
    }
  }

  // merge the warps' partial softmaxes
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    if (lane == 0) {
      m_sh[warp * G + gi] = m_run[gi];
      l_sh[warp * G + gi] = l_run[gi];
    }
#pragma unroll
    for (int e = 0; e < E; ++e)
      acc_sh[(warp * G + gi) * D + lane * E + e] = acc[gi][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int gi = idx / D, d = idx % D;
    float m_all = kNegInf;
    for (int w = 0; w < warps; ++w) m_all = fmaxf(m_all, m_sh[w * G + gi]);
    float l_all = 0.f, a_all = 0.f;
    for (int w = 0; w < warps; ++w) {
      const float f = expf(m_sh[w * G + gi] - m_all);
      l_all = fmaf(f, l_sh[w * G + gi], l_all);
      a_all = fmaf(f, acc_sh[(w * G + gi) * D + d], a_all);
    }
    // length 0: l_all == 0 and a_all == 0, so the guarded divide gives 0
    const float l_safe = l_all <= 0.f ? 1.f : l_all;
    o[(b * heads + hk * G + gi) * D + d] = from_f32<T>(a_all / l_safe);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* lengths, void* o, int batch, int kv_heads,
                   int s_len, int warps, float scale, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(warps) * G * (D + 2) * sizeof(float);
  auto kernel = softmax_decode_fused_kernel<T, D, G>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<batch * kv_heads, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<T*>(o), kv_heads, s_len, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_group(int group, const void* q, const void* k,
                           const void* v, const void* lengths, void* o,
                           int batch, int kv_heads, int s_len, int warps,
                           float scale, cudaStream_t st) {
  switch (group) {
    case 1:
      return launch<T, D, 1>(q, k, v, lengths, o, batch, kv_heads, s_len,
                             warps, scale, st);
    case 2:
      return launch<T, D, 2>(q, k, v, lengths, o, batch, kv_heads, s_len,
                             warps, scale, st);
    case 4:
      return launch<T, D, 4>(q, k, v, lengths, o, batch, kv_heads, s_len,
                             warps, scale, st);
    case 8:
      return launch<T, D, 8>(q, k, v, lengths, o, batch, kv_heads, s_len,
                             warps, scale, st);
    case 16:
      return launch<T, D, 16>(q, k, v, lengths, o, batch, kv_heads, s_len,
                              warps, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int d, int group, const void* q, const void* k,
                         const void* v, const void* lengths, void* o,
                         int batch, int kv_heads, int s_len, int warps,
                         float scale, cudaStream_t st) {
  switch (d) {
    case 32:
      return dispatch_group<T, 32>(group, q, k, v, lengths, o, batch,
                                   kv_heads, s_len, warps, scale, st);
    case 64:
      return dispatch_group<T, 64>(group, q, k, v, lengths, o, batch,
                                   kv_heads, s_len, warps, scale, st);
    case 128:
      return dispatch_group<T, 128>(group, q, k, v, lengths, o, batch,
                                    kv_heads, s_len, warps, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16;
// warps: warps per block (1..16).  Returns the cudaError_t of the launch
// (0 = success); the launch is asynchronous on `stream`.
extern "C" int softmax_decode_fused(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int batch, int heads,
                                    int kv_heads, int s_len, int d,
                                    int warps, float scale, int dtype,
                                    void* stream) {
  if (batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_len < 0 ||
      warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group = heads / kv_heads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch_dim<float>(d, group, q, k, v, lengths, o, batch,
                              kv_heads, s_len, warps, scale, st);
  else if (dtype == 1)
    err = dispatch_dim<__nv_bfloat16>(d, group, q, k, v, lengths, o, batch,
                                      kv_heads, s_len, warps, scale, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

extern "C" const char* softmax_decode_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
