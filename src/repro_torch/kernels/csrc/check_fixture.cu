// The launch-bounds fixture of the static checks, for Hopper (sm_90a): a
// blocked copy that reads one block too far, wrong on purpose.
//
// Replaces the TPU kernel `oob_blocked_sum` (src/repro/check/fixtures.py:35;
// its pallas_call at :40, body `_copy_kernel` :31), whose input index map
// reads block i + 1, so that its last grid step indexes one block past the
// array.  Here the grid has t = n / block blocks of `block` threads, and
//
//   o[i * block + t] = x[(i + 1) * block + t]
//
// so block t - 1 reads x[n .. n + block), past the end of x.  It exists so
// that the port's bounds check (src/repro_torch/check/bounds.py) can be
// shown to catch such a launch: statically, from the plan beside its
// wrapper (check/fixtures.py), as REPRO-B001; and on the card, launched
// inside a guard-banded allocation whose NaN guard the last block copies
// into o.  It is not a kernel of the model and nothing registers it.
//
// Shapes: x and o (n,) f32, contiguous; block <= 1024.
//
// What bounds it: the copy, n * 4 bytes read and n * 4 written, no
// arithmetic: at n = 2^24 that is 134 MB, ~40 us at 3.35 TB/s (an estimate
// from the shapes, not a measurement).
//
// Design: the simplest copy, one element a thread, coalesced.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "plan.cuh"

namespace {

__global__ void oob_blocked_sum_kernel(const float* __restrict__ x,
                                       float* __restrict__ o, int block) {
  const size_t i = blockIdx.x;
  const int t = threadIdx.x;
  o[i * block + t] = x[(i + 1) * block + t];
}

// The launch, shared by the launcher and `check_fixture_plan`: one block
// of `block` threads per grid step, t = n / block steps.
template <typename F>
cudaError_t with_launch(int n, int block, F&& f) {
  auto kernel = oob_blocked_sum_kernel;
  return f(kernel, plan::Geometry{dim3(n / block), block, 0, 1});
}

bool bad_shape(int n, int block) { return n <= 0 || block <= 0; }

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the cudaError_t of the
// launch (0 = success); the launch is asynchronous on `stream`.
extern "C" int oob_blocked_sum(const void* x, void* o, int n, int block,
                               void* stream) {
  if (bad_shape(n, block)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      with_launch(n, block, [&](auto kernel, const plan::Geometry& geo) {
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const float*>(x),
                            static_cast<float*>(o), block);
      }));
}

// The geometry a call of `entry` ("oob_blocked_sum") with these arguments
// launches, into out[7] (plan.cuh); nothing is launched.  dtype must be 0
// (float32).
extern "C" int check_fixture_plan(const char* entry, int n, int block,
                                  int dtype, int64_t* out) {
  if (strcmp(entry, "oob_blocked_sum") != 0 || bad_shape(n, block) ||
      dtype != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      with_launch(n, block, [&](auto kernel, const plan::Geometry& geo) {
        return plan::report(kernel, geo, out);
      }));
}

extern "C" const char* check_fixture_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
