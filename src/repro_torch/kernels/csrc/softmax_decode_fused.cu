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
// Design: the tile stream of decode_common.cuh (`pc::stream_kernel`), the
// body of the paged kernels.  A contiguous cache is a paged arena with one
// page of S rows per slot and the identity table, so a cell per (slot, KV
// head) holds its G query rows (the Pallas kernel's head-fold: each K/V
// row is read once per KV head), its live prefix [0, min(lengths[b], S))
// is a run of tiles of tile_rows rows, and a cluster of 4 blocks splits
// them, each streaming its span by 1-D bulk copies, merged in rank order
// through distributed shared memory.  No table is read; a retired slot
// whose position ran past the cache reads no row beyond it.

#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "plan.cuh"

namespace {

bool bad_shape(int batch, int heads, int kv_heads, int s_len) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_len <= 0;
}

// The stream's launch: f(Type<T>{}, kernel, geometry) for the (T, D, G) a
// call with these arguments runs; one page of S rows per slot
template <typename F>
cudaError_t with_launch(int dtype, int d, int batch, int heads, int kv_heads,
                        int s_len, int tile_rows, F&& f) {
  return pc::with_stream<false>(dtype, d, heads / kv_heads, batch, heads,
                                s_len, 1, tile_rows, f);
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16;
// tile_rows: rows of one tile (1..64).  Returns the cudaError_t of the
// launch (0 = success); the launch is asynchronous on `stream`.
extern "C" int softmax_decode_fused(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int batch, int heads,
                                    int kv_heads, int s_len, int d,
                                    int tile_rows, float scale, int dtype,
                                    void* stream) {
  if (bad_shape(batch, heads, kv_heads, s_len))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      dtype, d, batch, heads, kv_heads, s_len, tile_rows,
      [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        return pc::launch<T>(kernel, geo, static_cast<cudaStream_t>(stream),
                             q, k, v, nullptr, lengths, o, heads, kv_heads,
                             batch, s_len, 1, tile_rows, scale);
      }));
}

// The geometry a call of `entry` ("softmax_decode_fused") with these
// arguments launches, into out[7] (plan.cuh); nothing is launched.
extern "C" int softmax_decode_fused_plan(const char* entry, int batch,
                                         int heads, int kv_heads, int s_len,
                                         int d, int tile_rows, int dtype,
                                         int64_t* out) {
  if (strcmp(entry, "softmax_decode_fused") != 0 ||
      bad_shape(batch, heads, kv_heads, s_len))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      dtype, d, batch, heads, kv_heads, s_len, tile_rows,
      [&](auto, auto kernel, const plan::Geometry& geo) {
        return plan::report(kernel, geo, out);
      }));
}

// The clusters of the same call, into out[2]: blocks per cluster and the
// most clusters of that kernel the card holds at once; nothing is
// launched.
extern "C" int softmax_decode_fused_cluster_plan(const char* entry,
                                                 int batch, int heads,
                                                 int kv_heads, int s_len,
                                                 int d, int tile_rows,
                                                 int dtype, int64_t* out) {
  if (strcmp(entry, "softmax_decode_fused") != 0 ||
      bad_shape(batch, heads, kv_heads, s_len))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      dtype, d, batch, heads, kv_heads, s_len, tile_rows,
      [&](auto, auto kernel, const plan::Geometry& geo) {
        return pc::clusters(kernel, geo, out);
      }));
}

extern "C" const char* softmax_decode_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
