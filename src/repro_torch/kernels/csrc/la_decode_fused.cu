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
// carried state before the rank-1 update).  Both bodies below take a
// compile-time `kGated` flag: the linear instance neither reads ld nor
// multiplies by γ, and its update fmaf(k_i, v_j, S_ij) is the gated one's
// at γ = 1 bit for bit.
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
// Two bodies, chosen by the launcher from the dims alone, for both entries:
//   * the state stream (namespace ds) wherever Dk % 4 == 0 and
//     4 (Dv + 1) <= 1024, below;
//   * the column walk at other dims, the first design.
//
// Design of the column walk (simple first):
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
//
// Design of the state stream (ds; the column walk keeps about 5 warps x
// 4 x 128 B of loads in flight an SM, ~8 % of the card's bandwidth at the
// serving shape, while ~1 us of latency at 3.35 TB/s wants ~26 KB an SM):
//   * one block per (slot, KV head) streams its contiguous Dk x (Dv+1)
//     f32 slab through a ring of chunks of kRows rows in shared memory,
//     each chunk one 1-D bulk copy (`cp.async.bulk`, completion on an
//     mbarrier; a run of a multiple of 4 rows starts 16-byte aligned when
//     Dk % 4 == 0).  The ring holds as many chunks as fit kMaxSmem, up to
//     kMaxStages (5 x 8,256 B at Dv = 128), all in flight from the start;
//   * 4 (Dv+1) threads sweep a chunk linearly, thread t = ry (Dv+1) + j
//     on column j of rows ry, ry + 4, ... (row class ry), each S element
//     updated in shared memory exactly as the column walk does it,
//     fmaf(k_i, v_j, γ S_ij) (fmaf(k_i, v_j, S_ij) in the linear
//     instance), so the new state carries the same bits;
//   * each chunk goes back by one bulk store (each writer fences its
//     writes to the async proxy, then a barrier); its stage takes the
//     chunk `stages` later once that store has read it, a chunk behind,
//     so the wait overlaps the next chunk's update;
//   * each thread keeps the G partial dots q_g . S_new[:, j] of its row
//     class in registers; after the stream, row classes 1..3 leave theirs
//     in the ring and class 0 adds them in that fixed order, so o is
//     bit-deterministic.  P, the normalizer and the divide are the column
//     walk's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <string.h>

#include "plan.cuh"
#include "sm90.cuh"

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

}  // namespace

namespace ds {

constexpr int kRows = 16;     // state rows of a chunk
constexpr int kClasses = 4;   // row classes: a thread's rows in a chunk
constexpr int kMaxStages = 5;
constexpr int kMinStages = 2;

// Byte offsets of the stream's shared memory: the ring of `stages` chunks
// (after the stream, the partial dots of row classes 1..kClasses-1, G
// rows of Dv+1 f32 each), then k, [v, 1], the G query rows and the G
// un-normalized rows f (f32), then the ring's mbarriers.
struct Layout {
  size_t chunk, k, va, q, f, bars, total;
};

__host__ __device__ inline Layout layout(int dk, int dv, int group,
                                         int stages) {
  const size_t dv1 = static_cast<size_t>(dv) + 1;
  Layout l;
  l.chunk = kRows * dv1 * sizeof(float);
  const size_t ring = stages * l.chunk;
  const size_t parts = (kClasses - 1) * group * dv1 * sizeof(float);
  l.k = ((ring > parts ? ring : parts) + 15) / 16 * 16;
  l.va = l.k + dk * sizeof(float);
  l.q = l.va + dv1 * sizeof(float);
  l.f = l.q + static_cast<size_t>(group) * dk * sizeof(float);
  l.bars = (l.f + group * dv1 * sizeof(float) + 7) / 8 * 8;
  l.total = l.bars + stages * sizeof(uint64_t);
  return l;
}

// whether the stream takes these dims: 16-byte aligned chunks, and one
// thread per column and row class
inline bool takes(int dk, int dv) {
  return dk % 4 == 0 && kClasses * (dv + 1) <= kMaxThreads;
}

// the most stages, at most one a chunk and kMaxStages, down to kMinStages,
// whose layout fits kMaxSmem
inline int stages_for(int dk, int dv, int group) {
  int stages = std::min(kMaxStages, (dk + kRows - 1) / kRows);
  while (stages > kMinStages &&
         layout(dk, dv, group, stages).total > kMaxSmem)
    --stages;
  return stages;
}

// One block per (slot, KV head): S <- γ S + k^T [v, 1] streamed chunk by
// chunk, P <- γ P + [v, 1], f = a P + b q S over the G query heads, o =
// f[:Dv] / f[Dv]; γ = exp(ld[bh]) where kGated, else 1 (ld not read).  s
// must be 16-byte aligned (the launcher checks it).
template <typename T, int G, bool kGated>
__global__ void __launch_bounds__(kMaxThreads)
    decode_stream_kernel(float* __restrict__ s, float* __restrict__ p,
                             const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const float* __restrict__ ld,
                             T* __restrict__ o, int dk, int dv, int stages,
                             float a, float b) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int dv1 = dv + 1;
  const Layout l = layout(dk, dv, G, stages);
  float* k_sh = reinterpret_cast<float*>(smem + l.k);    // (Dk,)
  float* va_sh = reinterpret_cast<float*>(smem + l.va);  // (Dv+1,) [v, 1]
  float* q_sh = reinterpret_cast<float*>(smem + l.q);    // (G, Dk)
  float* f_sh = reinterpret_cast<float*>(smem + l.f);    // (G, Dv+1)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);

  const size_t bh = blockIdx.x;  // slot * Hkv + kv head
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int ry = tid / dv1;  // row class
  const int j = tid - ry * dv1;
  const bool live = ry < kClasses;
  const int chunks = (dk + kRows - 1) / kRows;
  unsigned char* slab =
      reinterpret_cast<unsigned char*>(s + bh * dk * dv1);
  auto bytes_of = [&](int c) {
    return static_cast<uint32_t>(min(kRows, dk - c * kRows) * dv1 *
                                 sizeof(float));
  };
  // chunk c of the slab into its stage
  auto load = [&](int c) {
    uint64_t* bar = &full[c % stages];
    sm90::bar_expect(bar, bytes_of(c));
    sm90::bulk_load(smem + (c % stages) * l.chunk, slab + c * l.chunk,
                    bytes_of(c), bar);
  };

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) sm90::bar_init(&full[i], 1);
    sm90::bar_init_fence();
    for (int c = 0; c < min(stages, chunks); ++c) load(c);
  }
  const T* k_row = k + bh * dk;
  const T* v_row = v + bh * dv;
  const T* q_rows = q + bh * G * dk;  // the G query heads of this KV head
  for (int i = tid; i < dk; i += nthr) k_sh[i] = to_f32(k_row[i]);
  for (int i = tid; i < dv1; i += nthr)
    va_sh[i] = i < dv ? to_f32(v_row[i]) : 1.0f;
  for (int i = tid; i < G * dk; i += nthr) q_sh[i] = to_f32(q_rows[i]);
  __syncthreads();

  // the decay gate of this (slot, KV head)
  const float gam = kGated ? expf(ld[bh]) : 1.0f;
  const float vj = live ? va_sh[j] : 0.f;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  for (int c = 0; c < chunks; ++c) {
    sm90::bar_wait(&full[c % stages], (c / stages) & 1);
    float* tile = reinterpret_cast<float*>(smem + (c % stages) * l.chunk);
    const int rows = min(kRows, dk - c * kRows);
    if (live) {
#pragma unroll
      for (int m = 0; m < kRows / kClasses; ++m) {
        const int r = ry + kClasses * m;
        if (r < rows) {
          const int i = c * kRows + r;
          float* cell = tile + r * dv1 + j;
          const float s_new =
              fmaf(k_sh[i], vj, kGated ? gam * *cell : *cell);
          *cell = s_new;
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] += q_sh[g * dk + i] * s_new;
        }
      }
    }
    // the chunk's new rows, visible to the bulk store
    sm90::fence_async_smem();
    __syncthreads();
    if (tid == 0) {
      sm90::bulk_store(slab + c * l.chunk, tile, bytes_of(c));
      sm90::bulk_commit();
      // the stage of chunk c - 1, once its store has read it, takes the
      // chunk `stages` after it
      if (c >= 1 && c - 1 + stages < chunks) {
        sm90::bulk_wait<1, true>();
        load(c - 1 + stages);
      }
    }
  }
  // every store has read its stage: the ring takes the partial dots
  if (tid == 0) sm90::bulk_wait<0, true>();
  __syncthreads();
  float* part = reinterpret_cast<float*>(smem);  // (kClasses - 1, G, Dv+1)
  if (live && ry > 0) {
#pragma unroll
    for (int g = 0; g < G; ++g)
      part[((ry - 1) * G + g) * dv1 + j] = acc[g];
  }
  __syncthreads();
  if (live && ry == 0) {
    float* p_row = p + bh * dv1;
    const float p_new = kGated ? fmaf(gam, p_row[j], vj) : p_row[j] + vj;
    p_row[j] = p_new;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float dot = acc[g];
#pragma unroll
      for (int y = 1; y < kClasses; ++y)
        dot += part[((y - 1) * G + g) * dv1 + j];
      f_sh[g * dv1 + j] = a * p_new + b * dot;
    }
  }
  __syncthreads();

  T* o_rows = o + bh * G * dv;
  for (int idx = tid; idx < G * dv; idx += nthr) {
    const int g = idx / dv;
    const int jj = idx - g * dv;
    const float den = f_sh[g * dv1 + dv];
    const float val = fabsf(den) < kSafeEps ? 0.0f : f_sh[g * dv1 + jj] / den;
    o_rows[idx] = from_f32<T>(val);
  }
  // the state's stores are complete before the block exits
  if (tid == 0) sm90::bulk_wait<0, false>();
}

}  // namespace ds

namespace {

// The launch of la_decode_fused / gla_decode_fused, shared by the launcher
// and `la_decode_fused_plan`: f(Type<T>{}, kernel, geometry, Int<stream>{})
// for the instantiation a call with these arguments runs, at most
// kMaxSmem of shared memory (the launcher refuses more).  Both entries
// stream the state wherever ds::takes the dims: one block per (slot, KV
// head) of 4 (Dv+1) threads rounded up to warps, the ring's stages in
// geometry.stage.  Otherwise the column walk: one block per (slot, KV
// head); threads stride over the Dv+1 columns; k, [v, 1], the group's G
// query rows and its G un-normalized rows f in shared memory.
template <bool kGated, typename F>
cudaError_t with_launch(int dtype, int group, int batch, int kv_heads,
                        int dk, int dv, F&& f) {
  const int dv1 = dv + 1;
  const int threads = std::min((dv1 + 31) / 32 * 32, kMaxThreads);
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_group(group, [&](auto gc) {
      using T = typename decltype(t)::type;
      constexpr int G = decltype(gc)::value;
      if (ds::takes(dk, dv)) {
        const int stages = ds::stages_for(dk, dv, G);
        return f(t, ds::decode_stream_kernel<T, G, kGated>,
                 plan::Geometry{dim3(batch * kv_heads),
                                (ds::kClasses * dv1 + 31) / 32 * 32,
                                ds::layout(dk, dv, G, stages).total, stages},
                 plan::Int<1>{});
      }
      const size_t smem =
          static_cast<size_t>(dk + dv1 + G * dk + G * dv1) * sizeof(float);
      auto kernel = la_decode_fused_kernel<T, G, kGated>;
      return f(t, kernel,
               plan::Geometry{dim3(batch * kv_heads), threads, smem, 1},
               plan::Int<0>{});
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
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        if (geo.smem > kMaxSmem) return cudaErrorInvalidValue;
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        if constexpr (decltype(body)::value == 1) {
          // the bulk copies need the slab 16-byte aligned
          if (reinterpret_cast<uintptr_t>(s) % 16 != 0)
            return cudaErrorInvalidValue;
          return plan::launch(kernel, geo, st, static_cast<float*>(s),
                              static_cast<float*>(p),
                              static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v),
                              static_cast<const float*>(ld),
                              static_cast<T*>(o), dk, dv, geo.stage, a, b);
        } else {
          return plan::launch(kernel, geo, st, static_cast<float*>(s),
                              static_cast<float*>(p),
                              static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v),
                              static_cast<const float*>(ld),
                              static_cast<T*>(o), dk, dv, a, b);
        }
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
  auto report = [&](auto, auto kernel, const plan::Geometry& geo, auto) {
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
