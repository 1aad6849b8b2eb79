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
//   * the walk is decode_common.cuh's `attend`: each of the block's warps
//     walks every W-th key of the live prefix with several rows' loads in
//     flight and its own online softmax; the warps' partial (max, sum,
//     output) merge in shared memory and the divide runs in the kernel; an
//     empty walk leaves sum 0, guarded to 1, so a length-0 slot writes
//     zeros;
//   * the walk is bounded at min(lengths[b], S): a retired slot whose
//     position ran past the cache reads no row beyond it.
// At B=8, Hkv=16 this is 128 blocks; splitting the walk of one (slot, KV
// head) across blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "plan.cuh"

namespace {

using decode::kMaxWarps;

// key j of a slot's contiguous cache: row j of its (S, D) block
template <int D>
struct ContiguousRows {
  size_t base;
  __device__ size_t operator()(int j) const {
    return base + static_cast<size_t>(j) * D;
  }
};

template <typename T, int D, int G>
__global__ void softmax_decode_fused_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const int* __restrict__ lengths,
    T* __restrict__ o, int kv_heads, int s_len, float scale) {
  extern __shared__ float smem[];
  const int bh = blockIdx.x;           // slot * Hkv + KV head
  const int b = bh / kv_heads;
  const int len = max(0, min(lengths[b], s_len));
  // the G query rows of KV head hk: heads hk * G .. hk * G + G - 1 of slot
  // b, i.e. rows bh * G .. bh * G + G - 1 of (B * H, D)
  const size_t rows = static_cast<size_t>(bh) * G * D;
  const ContiguousRows<D> key_row{static_cast<size_t>(bh) * s_len * D};
  decode::attend<T, D, G>(q + rows, k, v, len, key_row, o + rows, scale,
                          smem);
}

// The launch of softmax_decode_fused, shared by the launcher and
// `softmax_decode_fused_plan`: f(Type<T>{}, kernel, geometry) for the
// instantiation (T, D, G) a call with these arguments runs.  One block of
// `warps` warps per (slot, KV head); the warps' partial softmaxes merge in
// shared memory.
template <typename F>
cudaError_t with_launch(int dtype, int d, int group, int batch, int kv_heads,
                        int warps, F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      return plan::with_group(group, [&](auto gc) {
        using T = typename decltype(t)::type;
        constexpr int D = decltype(dc)::value;
        constexpr int G = decltype(gc)::value;
        const size_t smem = decode::merge_floats(warps, G, D) * sizeof(float);
        auto kernel = softmax_decode_fused_kernel<T, D, G>;
        return f(t, kernel,
                 plan::Geometry{dim3(batch * kv_heads), warps * 32, smem, 1});
      });
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int s_len, int warps) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_len < 0 ||
         warps < 1 || warps > kMaxWarps;
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
  if (bad_shape(batch, heads, kv_heads, s_len, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      dtype, d, heads / kv_heads, batch, kv_heads, warps,
      [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const T*>(q),
                            static_cast<const T*>(k),
                            static_cast<const T*>(v),
                            static_cast<const int*>(lengths),
                            static_cast<T*>(o), kv_heads, s_len, scale);
      }));
}

// The geometry a call of `entry` ("softmax_decode_fused") with these
// arguments launches, into out[7] (plan.cuh); nothing is launched.
extern "C" int softmax_decode_fused_plan(const char* entry, int batch,
                                         int heads, int kv_heads, int s_len,
                                         int d, int warps, int dtype,
                                         int64_t* out) {
  if (strcmp(entry, "softmax_decode_fused") != 0 ||
      bad_shape(batch, heads, kv_heads, s_len, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      dtype, d, heads / kv_heads, batch, kv_heads, warps,
      [&](auto, auto kernel, const plan::Geometry& geo) {
        return plan::report(kernel, geo, out);
      }));
}

extern "C" const char* softmax_decode_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
