// Paged-KV softmax decode for Hopper (sm_90a): two entry points.
//
// Replaces the TPU kernels `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py:149; body `_decode_kernel`, :97)
// and `paged_decode_fused_pallas` (src/repro/kernels/decode_fused.py:333;
// body `_paged_fused_kernel`, :289).  One call attends every slot's new
// query token to its first lengths[b] keys, which live in a shared arena of
// fixed-size pages:
//
//   key j of slot b: row j % ps of page page_table[b, j / ps], KV head hk
//   s_j = scale * q . k_j for j < min(lengths[b], Pmax * ps)
//   o   = sum_j softmax(s)_j v_j      (online softmax, f32, divide here)
//   a slot of length 0 yields zeros, as both Pallas kernels do
//
// Shapes (contiguous): q (B, H, 1, D), k_pages and v_pages
// (P, Hkv, ps, D), page_table (B, Pmax) int32, lengths (B,) int32,
// o (B, H, 1, D), with H = G * Hkv and query head h reading KV head h / G.
// T is float or bf16; any ps >= 1.
//
// Both run the tile stream of decode_common.cuh (`pc::stream_kernel`, a
// cluster of 4 blocks per cell, each a span of the cell's live tiles
// through a ring of 1-D bulk copies, merged in rank order through
// distributed shared memory); a page of ps <= tile_rows rows is one tile,
// a larger one ceil(ps / tile_rows) tiles:
//
//   paged_attention     a cell per (slot, query head), R = 1 row, as
//                       `paged_attention_pallas`'s grid; at G = 1 the same
//                       work as paged_decode_fused
//   paged_decode_fused  a cell per (slot, KV head), its R = G query rows,
//                       so each page is read once per KV head (the Pallas
//                       kernel's head-fold)
//
// What bounds it: reading the live keys' pages.  At B=8, Hkv=16, D=128,
// ps=16 and 544 live keys a call reads 2 * 8*16*544*128 * 2 B ~= 35.7 MB,
// ~10.7 us at 3.35 TB/s, for 2 flops per byte (an estimate from the
// shapes, not a measurement); the table adds 4 B per page.  The TPU
// kernels' pages_per_block tiling amortises sequential grid steps, which
// CUDA does not have: a cluster's blocks split the pages between them.

#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "plan.cuh"

namespace {

bool bad_entry(const char* entry, bool* fold_heads) {
  *fold_heads = strcmp(entry, "paged_decode_fused") == 0;
  return !*fold_heads && strcmp(entry, "paged_attention") != 0;
}

bool bad_shape(int batch, int heads, int kv_heads, int num_pages,
               int page_size, int pmax) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
         num_pages <= 0 || page_size <= 0 || pmax <= 0 ||
         static_cast<int64_t>(pmax) * page_size > INT32_MAX;
}

// The stream's launch for `entry`: f(Type<T>{}, kernel, geometry), R = 1
// (paged_attention) or the group G (paged_decode_fused)
template <typename F>
cudaError_t with_launch(bool fold_heads, int dtype, int d, int batch,
                        int heads, int kv_heads, int page_size, int pmax,
                        int tile_rows, F&& f) {
  return pc::with_stream<true>(dtype, d, fold_heads ? heads / kv_heads : 1,
                               batch, heads, page_size, pmax, tile_rows, f);
}

int run(bool fold_heads, const void* q, const void* k_pages,
        const void* v_pages, const void* page_table, const void* lengths,
        void* o, int batch, int heads, int kv_heads, int num_pages,
        int page_size, int pmax, int d, int tile_rows, float scale,
        int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, page_size, pmax,
      tile_rows, [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        return pc::launch<T>(kernel, geo, static_cast<cudaStream_t>(stream),
                             q, k_pages, v_pages, page_table, lengths, o,
                             heads, kv_heads, num_pages, page_size, pmax,
                             tile_rows, scale);
      }));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16;
// tile_rows: the most rows of one tile (1..64).  Each returns the
// cudaError_t of its launch (0 = success); the launch is asynchronous on
// `stream`.

// a cell per (slot, query head)
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_table,
                               const void* lengths, void* o, int batch,
                               int heads, int kv_heads, int num_pages,
                               int page_size, int pmax, int d, int tile_rows,
                               float scale, int dtype, void* stream) {
  return run(false, q, k_pages, v_pages, page_table, lengths, o, batch,
             heads, kv_heads, num_pages, page_size, pmax, d, tile_rows,
             scale, dtype, stream);
}

// a cell per (slot, KV head); G = heads / kv_heads in {1, 2, 4, 8, 16}
extern "C" int paged_decode_fused(const void* q, const void* k_pages,
                                  const void* v_pages,
                                  const void* page_table,
                                  const void* lengths, void* o, int batch,
                                  int heads, int kv_heads, int num_pages,
                                  int page_size, int pmax, int d,
                                  int tile_rows, float scale, int dtype,
                                  void* stream) {
  return run(true, q, k_pages, v_pages, page_table, lengths, o, batch,
             heads, kv_heads, num_pages, page_size, pmax, d, tile_rows,
             scale, dtype, stream);
}

// The geometry a call of `entry` ("paged_attention" or
// "paged_decode_fused") with these arguments launches, into out[7]
// (plan.cuh); nothing is launched.
extern "C" int paged_decode_plan(const char* entry, int batch, int heads,
                                 int kv_heads, int num_pages, int page_size,
                                 int pmax, int d, int tile_rows, int dtype,
                                 int64_t* out) {
  bool fold_heads;
  if (bad_entry(entry, &fold_heads) ||
      bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, page_size, pmax,
      tile_rows, [&](auto, auto kernel, const plan::Geometry& geo) {
        return plan::report(kernel, geo, out);
      }));
}

// The clusters of the same call, into out[2]: blocks per cluster and the
// most clusters of that kernel the card holds at once; nothing is
// launched.
extern "C" int paged_decode_cluster_plan(const char* entry, int batch,
                                         int heads, int kv_heads,
                                         int num_pages, int page_size,
                                         int pmax, int d, int tile_rows,
                                         int dtype, int64_t* out) {
  bool fold_heads;
  if (bad_entry(entry, &fold_heads) ||
      bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, page_size, pmax,
      tile_rows, [&](auto, auto kernel, const plan::Geometry& geo) {
        return pc::clusters(kernel, geo, out);
      }));
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
