// Launch geometry shared by every kernel source's launcher and its `_plan`
// export.
//
// Each source works out the grid, the threads, the dynamic shared memory
// and, where it stages tokens, the stage of a launch in ONE host function
// per kernel.  Its launcher launches exactly that, and its C export
// `<source>_plan(entry, dims..., out)` reports it without launching, so the
// plan cannot drift from the launch.  `repro_torch.check.bounds` holds each
// Python plan (kernels/*.py) equal to the export on the card.  `out` holds
// kPlanFields int64 values:
//
//   out[0..2]  grid x, y, z
//   out[3]     threads per block
//   out[4]     dynamic shared memory in bytes; above the source's limit
//              the launcher refuses the launch (cudaErrorInvalidValue), and
//              the export reports what one token or block would need
//   out[5]     registers per thread    (cudaFuncGetAttributes of the very
//   out[6]     static shared memory     instantiation the launch runs)
//
// The dispatch on the element type and the compile-time sizes goes through
// the same `with_*` helpers for the launch and for the plan, each calling
// back with tag types (Type<T>, Int<N>), so both name one instantiation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

namespace plan {

constexpr int kPlanFields = 7;

struct Geometry {
  dim3 grid;
  int threads;
  size_t smem;  // dynamic shared memory, bytes
  int stage;    // tokens staged per iteration; 0 where one does not fit
};

template <typename T>
struct Type {
  using type = T;
};
template <int N>
struct Int {
  static constexpr int value = N;
};

// g with `stage` tokens of `per_token` bytes, shrunk to fit `limit`; stage 0
// where one token does not fit (smem then holds one token's bytes).
inline Geometry fit(Geometry g, int stage, size_t per_token, size_t limit) {
  g.stage = static_cast<int>(
      std::min(static_cast<size_t>(stage), limit / per_token));
  g.smem = static_cast<size_t>(std::max(g.stage, 1)) * per_token;
  return g;
}

// f(Type<T>{}) for dtype code 0 (float) or 1 (bf16).
template <typename F>
cudaError_t with_dtype(int dtype, F&& f) {
  if (dtype == 0) return f(Type<float>{});
  if (dtype == 1) return f(Type<__nv_bfloat16>{});
  return cudaErrorInvalidValue;
}

// f(Int<d>{}) for a head dim the kernels are instantiated for.
template <typename F>
cudaError_t with_head_dim(int d, F&& f) {
  switch (d) {
    case 32:
      return f(Int<32>{});
    case 64:
      return f(Int<64>{});
    case 128:
      return f(Int<128>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// f(Int<d>{}) for a head dim the linear-attention token walks are
// instantiated for: with_head_dim's and, for the ungated walks, 112
// (zamba2-7b's shared attention, 3584 / 32), whose 28 row groups of 4 leave
// the last warp of a role half full.  The gated (GLA) walks take
// with_head_dim's only.
template <bool kGated, typename F>
cudaError_t with_walk_head_dim(int d, F&& f) {
  if constexpr (!kGated) {
    if (d == 112) return f(Int<112>{});
  }
  return with_head_dim(d, f);
}

// f(Int<dk>{}, Int<dv>{}) for the (Dk, Dv) pairs of the token walks:
// with_walk_head_dim's D as (D, D) and, for the ungated walks,
// (192, 128) (deepseek-v2-236b's MLA: q and k carry nope 128 + rope 64
// per head, v 128).  Every other pair is refused.
template <bool kGated, typename F>
cudaError_t with_walk_dims(int dk, int dv, F&& f) {
  if (dk == dv)
    return with_walk_head_dim<kGated>(dk, [&](auto dc) { return f(dc, dc); });
  if constexpr (!kGated) {
    if (dk == 192 && dv == 128) return f(Int<192>{}, Int<128>{});
  }
  return cudaErrorInvalidValue;
}

// Whether the chunked wgmma bodies of the linear-attention kernels
// (la_fwd.cu's lc, la_bwd.cu's bq and bkv) take (Dk, Dv) in bf16: Dk = Dv =
// 128, and for the ungated bodies 64 too (stablelm-1.6b, whisper-large-v3's
// decoder); every other pair walks.
template <bool kGated>
constexpr bool chunked_dims(int dk, int dv) {
  return dk == dv && (dk == 128 || (!kGated && dk == 64));
}

// f(Int<d>{}) for a head dim that chunked_dims<kGated> takes (no gated
// instance at 64 is compiled).
template <bool kGated, typename F>
cudaError_t with_chunked_dim(int d, F&& f) {
  if constexpr (!kGated) {
    if (d == 64) return f(Int<64>{});
  }
  return f(Int<128>{});
}

// f(Int<g>{}) for a query group (or rows per block) of 1, 2, 4, 8 or 16.
template <typename F>
cudaError_t with_group(int g, F&& f) {
  switch (g) {
    case 1:
      return f(Int<1>{});
    case 2:
      return f(Int<2>{});
    case 4:
      return f(Int<4>{});
    case 8:
      return f(Int<8>{});
    case 16:
      return f(Int<16>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// f(Int<g>{}) for a query group of the recurrent decode steps: with_group's,
// 7 (qwen2-vl-7b: 28 heads on 4 KV heads) and 48 (granite-20b's multi-query
// attention, 48 heads on one KV head).
template <typename F>
cudaError_t with_decode_group(int g, F&& f) {
  if (g == 7) return f(Int<7>{});
  if (g == 48) return f(Int<48>{});
  return with_group(g, f);
}

// Fill out[kPlanFields] with g and `kernel`'s registers and static shared
// memory.
template <typename Kernel>
cudaError_t report(Kernel kernel, const Geometry& g, int64_t* out) {
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  out[0] = g.grid.x;
  out[1] = g.grid.y;
  out[2] = g.grid.z;
  out[3] = g.threads;
  out[4] = static_cast<int64_t>(g.smem);
  out[5] = attr.numRegs;
  out[6] = static_cast<int64_t>(attr.sharedSizeBytes);
  return cudaSuccess;
}

// Launch `kernel` with geometry g on `stream`, its dynamic shared memory
// allowed first; returns the launch's error.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, const Geometry& g, cudaStream_t stream,
                   Args... args) {
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(g.smem));
  if (err != cudaSuccess) return err;
  kernel<<<g.grid, g.threads, g.smem, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace plan
