// The launch-bounds fixture of the static checks, for Hopper (sm_90a): a
// blocked copy that reads one block too far, wrong on purpose.
//
// Replaces the TPU kernel `oob_blocked_sum` (src/repro/check/fixtures.py:35;
// its pallas_call at :40, body `_copy_kernel` :31), whose input index map
// reads block i + 1, so that its last grid step indexes one block past the
// array.  Here, over the reference's t = n / block grid steps i and the
// `block` elements e of a step,
//
//   o[i * block + e] = x[(i + 1) * block + e]
//
// so step t - 1 reads x[n .. n + block), past the end of x.  It exists so
// that the port's bounds check (src/repro_torch/check/bounds.py) can be
// shown to catch such a launch: statically, from the plan beside its
// wrapper (check/fixtures.py), as REPRO-B001; and on the card, launched
// inside a guard-banded allocation whose NaN guard the last block copies
// into o.  It is not a kernel of the model and nothing registers it.
//
// Shapes: x and o (n,) f32, contiguous and 16-byte aligned; block a
// multiple of 4 (the wrapper checks both; the launcher refuses others).
//
// What bounds it: the copy, n * 4 bytes read and n * 4 written, no
// arithmetic: at n = 2^24 that is 134 MB, 0.04006 ms at 3.35 TB/s.
//
// Design: a bandwidth-shaped copy.  256 threads a CUDA block, 16-byte
// loads and stores (float4), four loads in flight per thread before their
// stores; each CUDA block covers a contiguous run of kRunFloats / block
// of the reference's grid steps, so that it reads one box of x and writes
// one box of o.  The last grid step, the one whose read is the defect,
// runs as a CUDA block of its own, so that the read past x is a whole
// box of its own, as in the reference.

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include "plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLoads = 4;  // float4 loads in flight per thread
constexpr int kRunFloats = kThreads * kLoads * 4;

// `run` grid steps a CUDA block over the first steps - 1, then one CUDA
// block for the last step.
struct Runs {
  int run;     // grid steps of a run
  int blocks;  // CUDA blocks, the last step's included
};
inline Runs runs_of(int steps, int block) {
  const int run = block >= kRunFloats ? 1 : kRunFloats / block;
  return {run, steps < 1 ? 0 : (steps - 1 + run - 1) / run + 1};
}

// o[i * block + e] = x[(i + 1) * block + e] over the steps of this CUDA
// block, 16 bytes a load: float4 j of o from float4 j + shift4 of x, for j
// in [b run4, min((b + 1) run4, last4)), or [last4, total4) for the last
// step's block (n is an int, so 32-bit float4 indices do)
__global__ void __launch_bounds__(kThreads)
    oob_blocked_sum_kernel(const float4* __restrict__ x,
                           float4* __restrict__ o, int shift4, int run4,
                           int last4, int total4) {
  const bool tail = blockIdx.x == gridDim.x - 1;
  const int begin = tail ? last4 : blockIdx.x * run4;
  const int end = tail ? total4 : min(begin + run4, last4);
  for (int j0 = begin + threadIdx.x; j0 < end;
       j0 += kThreads * kLoads) {
    float4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * kThreads;
      if (j < end) v[u] = x[j + shift4];
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int j = j0 + u * kThreads;
      if (j < end) o[j] = v[u];
    }
  }
}

// The launch, shared by the launcher and `check_fixture_plan`:
// f(kernel, geometry) for t = n / block grid steps.
template <typename F>
cudaError_t with_launch(int n, int block, F&& f) {
  return f(oob_blocked_sum_kernel,
           plan::Geometry{dim3(runs_of(n / block, block).blocks),
                          kThreads, 0, 1});
}

bool bad_shape(int n, int block) {
  return n <= 0 || block <= 0 || block % 4 != 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  Returns the cudaError_t of the
// launch (0 = success); the launch is asynchronous on `stream`.  x and o
// must be 16-byte aligned (else cudaErrorInvalidValue, nothing launched).
extern "C" int oob_blocked_sum(const void* x, void* o, int n, int block,
                               void* stream) {
  if (bad_shape(n, block) ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(o)) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      with_launch(n, block, [&](auto kernel, const plan::Geometry& geo) {
        const int steps = n / block, shift4 = block / 4;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const float4*>(x),
                            static_cast<float4*>(o), shift4,
                            runs_of(steps, block).run * shift4,
                            (steps - 1) * shift4, steps * shift4);
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
