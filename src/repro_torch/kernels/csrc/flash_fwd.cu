// Causal flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py:126; its body is `_fwd_kernel`,
// :72).  Softmax attention of the paper's Regular-Attention baseline with
// an online softmax over KV tiles:
//
//   s = q k^T / sqrt(D), masked at global positions (query row i of slot b
//       sits at q_offset[b] + i, key j at j; live iff i_pos >= j)
//   m = running row max, l = running sum of exp(s - m), acc = sum p v
//   o = acc / l (l <= 0 -> 1), lse = m + log l (f32, when asked)
//
// Shapes (contiguous): q (B, H, Nq, D), k and v (B, Hkv, Nk, D) with
// H = G * Hkv, query head h reading KV head h / G (no KV copy); o like q;
// lse (B, H, Nq) f32 or null; q_offset (B,) int32 or null (then every
// slot's offset is Nk - Nq, the training convention).  T is float or bf16.
//
// What bounds it: the two products.  Causal at B=2, H=16, N=8192, D=128
// they are ~5.5e11 flop (~0.56 ms at 989 TFLOP/s on the bf16 tensor cores)
// against ~2.7e8 bytes moved (~0.08 ms at 3.35 TB/s): operations (an
// estimate from the shapes, not a measurement).
//
// Design (simple and right first; wgmma, TMA and warp specialisation are
// later work):
//   * one block of 4 warps per (query tile of 64 rows, head, slot); a warp
//     owns 16 query rows, the M edge of `mma.sync` m16n8k16 (bf16 in, f32
//     accumulate); the f32 instance runs the same tiles on the CUDA cores;
//   * the block stages its Q tile once and then walks the KV tiles of 64
//     keys in order, each staged in shared memory by 16-byte `cp.async`
//     copies that are all in flight at once, up to its own causal
//     frontier min(Nk, q_offset + last row + 1): a serving prefill over a
//     max_len cache costs what the live prefix costs;
//   * scores, running max and sum, and the (16, D) output accumulator stay
//     in registers; the probabilities go through a per-warp shared tile in
//     T (bf16 probabilities feed the P V product, as in FlashAttention-2);
//   * ragged Nq and Nk edges are masked here: rows and keys past the end
//     are zero-filled in shared memory and masked, nothing is padded;
//   * query tiles are issued deepest first, so the longest walks start
//     first.

#include <string.h>

#include "flash_common.cuh"
#include "plan.cuh"

namespace {

using flash::kBlockK;
using flash::kBlockQ;
using flash::kNegInf;
using flash::kThreads;
using flash::kWarpRows;
using flash::Tile;

template <typename T, int D>
constexpr size_t smem_bytes() {
  constexpr int ld = D + flash::kPad<T>;
  constexpr int ldp = kBlockK + flash::kPad<T>;
  return (static_cast<size_t>(kBlockQ + 2 * kBlockK) * ld +
          static_cast<size_t>(flash::kWarps) * kWarpRows * ldp) *
         sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse,
                     const int* __restrict__ q_offset, int heads,
                     int kv_heads, int nq, int nk, float scale) {
  constexpr int kLd = D + flash::kPad<T>;
  constexpr int kLdP = kBlockK + flash::kPad<T>;
  constexpr int kNtS = kBlockK / 8;  // score n-tiles
  constexpr int kNtO = D / 8;        // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_sh = reinterpret_cast<T*>(smem_raw);
  T* k_sh = q_sh + kBlockQ * kLd;
  T* v_sh = k_sh + kBlockK * kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* p_sh = v_sh + kBlockK * kLd + warp * kWarpRows * kLdP;

  const int q_tiles = (nq + kBlockQ - 1) / kBlockQ;
  const int qt = q_tiles - 1 - blockIdx.x;  // deepest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int off = q_offset ? q_offset[b] : nk - nq;
  const int q0 = qt * kBlockQ;
  const size_t qbase = (static_cast<size_t>(b) * heads + h) * nq;
  const size_t kbase = (static_cast<size_t>(b) * kv_heads + hk) * nk;

  flash::stage_rows<T, D>(q_sh, kLd, q + qbase * D, q0, nq, kBlockQ);
  // the block's causal frontier: its deepest live query row's position
  const int last_key = min(nk, off + min(q0 + kBlockQ, nq)) - 1;
  const int kv_tiles = last_key < 0 ? 0 : last_key / kBlockK + 1;

  const int row0 = q0 + warp * kWarpRows + g;  // this lane's two rows
  const int pos[2] = {off + row0, off + row0 + 8};
  float acc[kNtO][4];
  flash::zero(acc);
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const Tile<T, true> q_w{q_sh + warp * kWarpRows * kLd, kLd};

  for (int kt = 0; kt < kv_tiles; ++kt) {
    __syncthreads();  // every warp is done with the previous K/V tile
    flash::stage_rows<T, D>(k_sh, kLd, k + kbase * D, kt * kBlockK, nk,
                            kBlockK);
    flash::stage_rows<T, D>(v_sh, kLd, v + kbase * D, kt * kBlockK, nk,
                            kBlockK);
    flash::stage_wait();  // the Q tile's copies too, on the first tile
    __syncthreads();

    float s[kNtS][4];
    flash::zero(s);
    // S = Q K^T: B(d, j) = K[j][d], column-major in k_sh
    flash::warp_gemm<kNtS, D>(s, q_w, Tile<T, false>{k_sh, kLd});

    float m_new[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = kt * kBlockK + nt * 8 + 2 * t + (e & 1);
        const bool live = j < nk && j <= pos[e >> 1];
        s[nt][e] = live ? s[nt][e] * scale : -INFINITY;
        m_new[e >> 1] = fmaxf(m_new[e >> 1], s[nt][e]);
      }
    float corr[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = flash::quad_max(m_new[r]);
      corr[r] = __expf(m_run[r] - m_new[r]);
      m_run[r] = m_new[r];
    }
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // masked scores are -inf: exp gives exactly 0
        const float p = __expf(s[nt][e] - m_new[e >> 1]);
        rsum[e >> 1] += p;
        p_sh[(g + 8 * (e >> 1)) * kLdP + nt * 8 + 2 * t + (e & 1)] =
            flash::from_f32<T>(p);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      l_run[r] = corr[r] * l_run[r] + flash::quad_sum(rsum[r]);
#pragma unroll
    for (int nt = 0; nt < kNtO; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] *= corr[e >> 1];
    __syncwarp();
    // O += P V: B(j, d) = V[j][d], row-major in v_sh
    flash::warp_gemm<kNtO, kBlockK>(acc, Tile<T, true>{p_sh, kLdP},
                                    Tile<T, true>{v_sh, kLd});
    __syncwarp();
  }

  flash::stage_wait();  // no copy outlives the block (no KV tile: Nk = 0)
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = l_run[r] <= 0.f ? 1.f : l_run[r];
  flash::store_rows<T, kNtO>(o + qbase * D, acc,
                             q0 + warp * kWarpRows, nq, 1.f / l_safe[0],
                             1.f / l_safe[1]);
  if (lse != nullptr && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < nq) lse[qbase + row] = m_run[r] + logf(l_safe[r]);
    }
  }
}

// The launch of flash_fwd, shared by the launcher and `flash_fwd_plan`:
// f(Type<T>{}, kernel, geometry) for the instantiation a call with these
// arguments runs.  One block of 4 warps per (query tile, head, slot).
template <typename F>
cudaError_t with_launch(int dtype, int d, int batch, int heads, int nq,
                        F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      using T = typename decltype(t)::type;
      constexpr int D = decltype(dc)::value;
      auto kernel = flash_fwd_kernel<T, D>;
      return f(t, kernel,
               plan::Geometry{dim3((nq + kBlockQ - 1) / kBlockQ, heads, batch),
                              kThreads, smem_bytes<T, D>(), 1});
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int nq, int nk,
               int block_q, int block_k) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || nq < 0 ||
         nk < 0 || block_q != kBlockQ || block_k != kBlockK;
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// block_q / block_k must be the compiled tiles (64, 64).  lse and q_offset
// may be null.  Returns the cudaError_t of the launch (0 = success); the
// launch is asynchronous on `stream`.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* q_offset, int batch,
                         int heads, int kv_heads, int nq, int nk, int d,
                         int block_q, int block_k, float scale, int dtype,
                         void* stream) {
  if (bad_shape(batch, heads, kv_heads, nq, nk, block_q, block_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  return static_cast<int>(with_launch(
      dtype, d, batch, heads, nq,
      [&](auto t, auto kernel, const plan::Geometry& geo) {
        using T = typename decltype(t)::type;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const T*>(q),
                            static_cast<const T*>(k),
                            static_cast<const T*>(v), static_cast<T*>(o),
                            static_cast<float*>(lse),
                            static_cast<const int*>(q_offset), heads,
                            kv_heads, nq, nk, scale);
      }));
}

// The geometry a call of `entry` ("flash_fwd") with these arguments
// launches, into out[7] (plan.cuh); nothing is launched.
extern "C" int flash_fwd_plan(const char* entry, int batch, int heads,
                              int kv_heads, int nq, int nk, int d,
                              int block_q, int block_k, int dtype,
                              int64_t* out) {
  if (strcmp(entry, "flash_fwd") != 0 ||
      bad_shape(batch, heads, kv_heads, nq, nk, block_q, block_k))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      dtype, d, batch, heads, nq,
      [&](auto, auto kernel, const plan::Geometry& geo) {
        return plan::report(kernel, geo, out);
      }));
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
