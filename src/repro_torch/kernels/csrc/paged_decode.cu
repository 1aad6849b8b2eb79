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
//   paged_attention     one block per (slot, query head): R = 1 row
//   paged_decode_fused  one block per (slot, KV head): its R = G query
//                       rows, so each page is read once per KV head (the
//                       Pallas kernel's head-fold)
//
// What bounds it: reading the live keys' pages.  At B=8, Hkv=16, D=128,
// ps=16 and 544 live keys a call reads 2 * 8*16*544*128 * 2 B ~= 35.7 MB,
// ~10.7 us at 3.35 TB/s, for 2 flops per byte (an estimate from the
// shapes, not a measurement); the table adds 4 B per page.
//
// Design (simple first):
//   * the block stages its slot's live table entries (ceil(len / ps) of
//     them) in shared memory once, checking each names an arena page (an
//     entry outside the arena traps: no read outside it);
//   * the walk is decode_common.cuh's `attend`, the contiguous kernel's:
//     warps on interleaved keys, a lane per D/32 columns with several
//     rows' loads in flight, an online softmax per warp merged in shared
//     memory, the guarded divide; only where key j's row lies differs.  A
//     key's row is D contiguous elements whatever the page size, so a
//     warp's loads stay coalesced for any ps;
//   * the walk stops at min(lengths[b], Pmax * ps): a retired slot whose
//     position ran past its table reads no entry beyond the table's last.
// The TPU kernels' pages_per_block tiling amortises sequential grid steps,
// which CUDA does not have: a block walks all its pages itself.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "plan.cuh"

namespace {

using decode::kMaxWarps;

// key j of a slot: row j % ps of KV head hk of page table[j / ps]
template <int D>
struct PagedRows {
  const int* table;  // the slot's live entries, in shared memory
  int kv_heads, hk, page_size;
  __device__ size_t operator()(int j) const {
    const int page = table[j / page_size];
    return ((static_cast<size_t>(page) * kv_heads + hk) * page_size +
            j % page_size) *
           D;
  }
};

// R query rows per block: heads h0 .. h0 + R - 1 of slot b, all reading KV
// head h0 / G (R is 1 or G)
template <typename T, int D, int R>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ o, int heads,
    int kv_heads, int num_pages, int page_size, int pmax, float scale) {
  extern __shared__ float smem[];
  const int row_groups = heads / R;
  const int b = blockIdx.x / row_groups;
  const int h0 = (blockIdx.x % row_groups) * R;
  const int hk = h0 / (heads / kv_heads);
  const int len = max(0, min(lengths[b], pmax * page_size));
  const int live_pages = (len + page_size - 1) / page_size;
  int* table = reinterpret_cast<int*>(
      smem + decode::merge_floats(blockDim.x >> 5, R, D));
  const int* row = page_table + static_cast<size_t>(b) * pmax;
  for (int i = threadIdx.x; i < live_pages; i += blockDim.x) {
    const int page = row[i];
    if (page < 0 || page >= num_pages) __trap();
    table[i] = page;
  }
  __syncthreads();
  const size_t rows = (static_cast<size_t>(b) * heads + h0) * D;
  const PagedRows<D> key_row{table, kv_heads, hk, page_size};
  decode::attend<T, D, R>(q + rows, k_pages, v_pages, len, key_row,
                          o + rows, scale, smem);
}

// The launch of paged_attention / paged_decode_fused, shared by the
// launcher and `paged_decode_plan`: f(Type<T>{}, kernel, geometry) for the
// instantiation (T, D, R) a call with these arguments runs.  One block of
// `warps` warps per (slot, R query rows): R = 1 (paged_attention) or the
// group G (paged_decode_fused); shared memory holds the warps' merge and
// the slot's live table entries (at most Pmax).
template <typename F>
cudaError_t with_launch(bool fold_heads, int dtype, int d, int batch,
                        int heads, int kv_heads, int pmax, int warps, F&& f) {
  const int rows = fold_heads ? heads / kv_heads : 1;
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      return plan::with_group(rows, [&](auto rc) {
        using T = typename decltype(t)::type;
        constexpr int D = decltype(dc)::value;
        constexpr int R = decltype(rc)::value;
        const size_t smem = decode::merge_floats(warps, R, D) * sizeof(float) +
                            static_cast<size_t>(pmax) * sizeof(int);
        auto kernel = paged_decode_kernel<T, D, R>;
        return f(t, kernel,
                 plan::Geometry{dim3(batch * (heads / R)), warps * 32, smem,
                                1});
      });
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int num_pages,
               int page_size, int pmax, int warps) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
         num_pages <= 0 || page_size <= 0 || pmax <= 0 || warps < 1 ||
         warps > kMaxWarps ||
         static_cast<int64_t>(pmax) * page_size > INT32_MAX;
}

int run(bool fold_heads, const void* q, const void* k_pages,
        const void* v_pages, const void* page_table, const void* lengths,
        void* o, int batch, int heads, int kv_heads, int num_pages,
        int page_size, int pmax, int d, int warps, float scale, int dtype,
        void* stream) {
  if (bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, pmax, warps,
      [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const T*>(q),
                            static_cast<const T*>(k_pages),
                            static_cast<const T*>(v_pages),
                            static_cast<const int*>(page_table),
                            static_cast<const int*>(lengths),
                            static_cast<T*>(o), heads, kv_heads, num_pages,
                            page_size, pmax, scale);
      }));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16;
// warps: warps per block (1..16).  Each returns the cudaError_t of its
// launch (0 = success); the launch is asynchronous on `stream`.

// one block per (slot, query head)
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_table,
                               const void* lengths, void* o, int batch,
                               int heads, int kv_heads, int num_pages,
                               int page_size, int pmax, int d, int warps,
                               float scale, int dtype, void* stream) {
  return run(false, q, k_pages, v_pages, page_table, lengths, o, batch,
             heads, kv_heads, num_pages, page_size, pmax, d, warps, scale,
             dtype, stream);
}

// one block per (slot, KV head); G = heads / kv_heads in {1, 2, 4, 8, 16}
extern "C" int paged_decode_fused(const void* q, const void* k_pages,
                                  const void* v_pages,
                                  const void* page_table,
                                  const void* lengths, void* o, int batch,
                                  int heads, int kv_heads, int num_pages,
                                  int page_size, int pmax, int d, int warps,
                                  float scale, int dtype, void* stream) {
  return run(true, q, k_pages, v_pages, page_table, lengths, o, batch,
             heads, kv_heads, num_pages, page_size, pmax, d, warps, scale,
             dtype, stream);
}

// The geometry a call of `entry` ("paged_attention" or
// "paged_decode_fused") with these arguments launches, into out[7]
// (plan.cuh); nothing is launched.
extern "C" int paged_decode_plan(const char* entry, int batch, int heads,
                                 int kv_heads, int num_pages, int page_size,
                                 int pmax, int d, int warps, int dtype,
                                 int64_t* out) {
  const bool fold_heads = strcmp(entry, "paged_decode_fused") == 0;
  if ((!fold_heads && strcmp(entry, "paged_attention") != 0) ||
      bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, pmax, warps,
      [&](auto, auto kernel, const plan::Geometry& geo) {
        return plan::report(kernel, geo, out);
      }));
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
