// Causal flash-attention backward for Hopper (sm_90a): three kernels.
//
// Replaces the TPU kernel `flash_attention_bwd_pallas`
// (src/repro/kernels/flash_attention.py:294; its bodies are
// `_delta_kernel` :208, `_bwd_q_kernel` :218 and `_bwd_kv_kernel` :255).
// Recomputation backward from the residuals {q, k, v, o, lse} and the
// upstream grad dO, training convention only (Nq = Nk = N, query i sees
// keys j <= i):
//
//   flash_bwd_delta  delta_i = sum_d dO_id O_id                      (f32)
//   flash_bwd_q      P = exp(s - lse), dS = P * (dO V^T - delta),
//                    dq = scale * dS K over the KV tiles at or below the
//                    diagonal
//   flash_bwd_kv     dv = sum over the group's query heads of P^T dO,
//                    dk = scale * sum of dS^T Q, over the query tiles at
//                    or below the diagonal
//
// Shapes (contiguous): q, o, dO, dq (B, H, N, D); k, v, dk, dv
// (B, Hkv, N, D) with H = G * Hkv, query head h reading KV head h / G;
// lse and delta (B, H, N) f32.  T is float or bf16.
//
// What bounds it: the five products (Q K^T and dO V^T recomputed in both
// kernels, dS K, P^T dO, dS^T Q).  Causal at B=2, H=16, N=8192, D=128
// they are ~1.4e12 flop (~1.39 ms at 989 TFLOP/s on the bf16 tensor
// cores) against ~5.4e8 bytes moved (~0.16 ms at 3.35 TB/s): operations
// (an estimate from the shapes, not a measurement).
//
// Design (simple and right first; wgmma and TMA are later work):
//   * both product kernels run blocks of 4 warps whose warps own 16 rows
//     (the M edge of `mma.sync` m16n8k16, bf16 in, f32 accumulate; the
//     f32 instance runs the same tiles on the CUDA cores), stage their
//     tiles in shared memory by 16-byte `cp.async` copies, all in flight
//     at once, and zero-fill the ragged edge, masking it too;
//   * flash_bwd_q: one block per (query tile, head, slot) walks the KV
//     tiles up to its diagonal; P and dP stay in registers, dS goes
//     through a per-warp shared tile in T to feed dS K;
//   * flash_bwd_kv: one block per (KV tile, KV head, slot) walks every
//     query head of its group and every query tile from the diagonal on,
//     computing the transposed scores S^T = K Q^T directly (a warp owns
//     16 keys), so P^T and dS^T feed their products from a per-warp shared
//     tile; dk and dv accumulate in registers and land on the unexpanded
//     (B, Hkv, N, D) tensors with no atomics: the result is deterministic;
//   * the delta pass is its own kernel (one warp per row), so both product
//     kernels read delta as they read lse.

#include "flash_common.cuh"

namespace {

using flash::kBlockK;
using flash::kBlockQ;
using flash::kThreads;
using flash::kWarpRows;
using flash::Tile;

// query columns of a flash_bwd_kv sub-tile: keeps S^T and dP^T at 16
// registers a thread each beside the 2 x 64 of the dk/dv accumulators
constexpr int kSubQ = 32;

// ---------------------------------------------------------------------------
// delta
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o,
                                       const T* __restrict__ dout,
                                       float* __restrict__ delta,
                                       size_t rows) {
  const size_t row =
      (static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* orow = o + row * D;
  const T* drow = dout + row * D;
  float sum = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    sum = fmaf(flash::to_f32(orow[d]), flash::to_f32(drow[d]), sum);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, s);
  if (lane == 0) delta[row] = sum;
}

// ---------------------------------------------------------------------------
// dq
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t smem_q_bytes() {
  constexpr int ld = D + flash::kPad<T>;
  constexpr int ldp = kBlockK + flash::kPad<T>;
  return (static_cast<size_t>(2 * kBlockQ + 2 * kBlockK) * ld +
          static_cast<size_t>(flash::kWarps) * kWarpRows * ldp) *
         sizeof(T);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_q_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, T* __restrict__ dq,
                       int heads, int kv_heads, int n, float scale) {
  constexpr int kLd = D + flash::kPad<T>;
  constexpr int kLdP = kBlockK + flash::kPad<T>;
  constexpr int kNtS = kBlockK / 8;
  constexpr int kNtD = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_sh = reinterpret_cast<T*>(smem_raw);
  T* do_sh = q_sh + kBlockQ * kLd;
  T* k_sh = do_sh + kBlockQ * kLd;
  T* v_sh = k_sh + kBlockK * kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* ds_sh = v_sh + kBlockK * kLd + warp * kWarpRows * kLdP;

  const int q_tiles = (n + kBlockQ - 1) / kBlockQ;
  const int qt = q_tiles - 1 - blockIdx.x;  // deepest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kBlockQ;
  const size_t qbase = (static_cast<size_t>(b) * heads + h) * n;
  const size_t kbase = (static_cast<size_t>(b) * kv_heads + hk) * n;

  flash::stage_rows<T, D>(q_sh, kLd, q + qbase * D, q0, n, kBlockQ);
  flash::stage_rows<T, D>(do_sh, kLd, dout + qbase * D, q0, n, kBlockQ);
  const int row0 = q0 + warp * kWarpRows + g;
  const int rows[2] = {row0, row0 + 8};
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = rows[r] < n ? lse[qbase + rows[r]] : 0.f;
    delta_r[r] = rows[r] < n ? delta[qbase + rows[r]] : 0.f;
  }
  const int last_key = min(n, q0 + kBlockQ) - 1;
  const int kv_tiles = last_key / kBlockK + 1;
  float acc[kNtD][4];
  flash::zero(acc);
  const Tile<T, true> q_w{q_sh + warp * kWarpRows * kLd, kLd};
  const Tile<T, true> do_w{do_sh + warp * kWarpRows * kLd, kLd};

  for (int kt = 0; kt < kv_tiles; ++kt) {
    __syncthreads();
    flash::stage_rows<T, D>(k_sh, kLd, k + kbase * D, kt * kBlockK, n,
                            kBlockK);
    flash::stage_rows<T, D>(v_sh, kLd, v + kbase * D, kt * kBlockK, n,
                            kBlockK);
    flash::stage_wait();  // the Q and dO tiles' copies too, on the first
    __syncthreads();

    float s[kNtS][4], dp[kNtS][4];
    flash::zero(s);
    flash::zero(dp);
    flash::warp_gemm<kNtS, D>(s, q_w, Tile<T, false>{k_sh, kLd});
    flash::warp_gemm<kNtS, D>(dp, do_w, Tile<T, false>{v_sh, kLd});
#pragma unroll
    for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int j = kt * kBlockK + nt * 8 + 2 * t + (e & 1);
        const bool live = rows[r] < n && j <= rows[r];
        const float p = live ? __expf(s[nt][e] * scale - lse_r[r]) : 0.f;
        ds_sh[(g + 8 * r) * kLdP + nt * 8 + 2 * t + (e & 1)] =
            flash::from_f32<T>(p * (dp[nt][e] - delta_r[r]));
      }
    __syncwarp();
    // dQ += dS K: B(j, d) = K[j][d], row-major in k_sh
    flash::warp_gemm<kNtD, kBlockK>(acc, Tile<T, true>{ds_sh, kLdP},
                                    Tile<T, true>{k_sh, kLd});
    __syncwarp();
  }
  flash::store_rows<T, kNtD>(dq + qbase * D, acc, q0 + warp * kWarpRows, n,
                             scale, scale);
}

// ---------------------------------------------------------------------------
// dk, dv
// ---------------------------------------------------------------------------

template <typename T, int D>
constexpr size_t smem_kv_bytes() {
  constexpr int ld = D + flash::kPad<T>;
  constexpr int ldp = kSubQ + flash::kPad<T>;
  return (static_cast<size_t>(2 * kBlockK + 2 * kBlockQ) * ld +
          static_cast<size_t>(flash::kWarps) * kWarpRows * ldp) *
             sizeof(T) +
         static_cast<size_t>(2 * kBlockQ) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dk,
                        T* __restrict__ dv, int heads, int kv_heads, int n,
                        float scale) {
  constexpr int kLd = D + flash::kPad<T>;
  constexpr int kLdP = kSubQ + flash::kPad<T>;
  constexpr int kNtS = kSubQ / 8;
  constexpr int kNtD = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lse_sh = reinterpret_cast<float*>(smem_raw);
  float* delta_sh = lse_sh + kBlockQ;
  T* k_sh = reinterpret_cast<T*>(delta_sh + kBlockQ);
  T* v_sh = k_sh + kBlockK * kLd;
  T* q_sh = v_sh + kBlockK * kLd;
  T* do_sh = q_sh + kBlockQ * kLd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  T* pt_sh = do_sh + kBlockQ * kLd + warp * kWarpRows * kLdP;

  const int kt = blockIdx.x;  // shallowest KV tiles (most queries) first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = heads / kv_heads;
  const int k0 = kt * kBlockK;
  const size_t kbase = (static_cast<size_t>(b) * kv_heads + hk) * n;

  flash::stage_rows<T, D>(k_sh, kLd, k + kbase * D, k0, n, kBlockK);
  flash::stage_rows<T, D>(v_sh, kLd, v + kbase * D, k0, n, kBlockK);
  const int key0 = k0 + warp * kWarpRows + g;  // this lane's two keys
  const int keys[2] = {key0, key0 + 8};
  float dk_acc[kNtD][4], dv_acc[kNtD][4];
  flash::zero(dk_acc);
  flash::zero(dv_acc);
  const Tile<T, true> k_w{k_sh + warp * kWarpRows * kLd, kLd};
  const Tile<T, true> v_w{v_sh + warp * kWarpRows * kLd, kLd};
  const int q_tiles = (n + kBlockQ - 1) / kBlockQ;

  for (int gi = 0; gi < group; ++gi) {
    const size_t qbase =
        (static_cast<size_t>(b) * heads + hk * group + gi) * n;
    for (int qt = k0 / kBlockQ; qt < q_tiles; ++qt) {
      const int q0 = qt * kBlockQ;
      __syncthreads();
      flash::stage_rows<T, D>(q_sh, kLd, q + qbase * D, q0, n, kBlockQ);
      flash::stage_rows<T, D>(do_sh, kLd, dout + qbase * D, q0, n, kBlockQ);
      for (int i = threadIdx.x; i < kBlockQ; i += blockDim.x) {
        const bool in = q0 + i < n;
        lse_sh[i] = in ? lse[qbase + q0 + i] : 0.f;
        delta_sh[i] = in ? delta[qbase + q0 + i] : 0.f;
      }
      flash::stage_wait();  // the K and V tiles' copies too, on the first
      __syncthreads();

#pragma unroll 1
      for (int c0 = 0; c0 < kBlockQ; c0 += kSubQ) {
        float st[kNtS][4], dpt[kNtS][4];
        flash::zero(st);
        flash::zero(dpt);
        // S^T = K Q^T: B(d, i) = Q[i][d], column-major in q_sh
        flash::warp_gemm<kNtS, D>(
            st, k_w, Tile<T, false>{q_sh + c0 * kLd, kLd});
        // dP^T = V dO^T
        flash::warp_gemm<kNtS, D>(
            dpt, v_w, Tile<T, false>{do_sh + c0 * kLd, kLd});
        float pt[kNtS][4];
#pragma unroll
        for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int il = c0 + nt * 8 + 2 * t + (e & 1);
            const int i = q0 + il;
            const int j = keys[e >> 1];
            const bool live = i < n && j < n && j <= i;
            pt[nt][e] = live ? __expf(st[nt][e] * scale - lse_sh[il]) : 0.f;
            pt_sh[(g + 8 * (e >> 1)) * kLdP + nt * 8 + 2 * t + (e & 1)] =
                flash::from_f32<T>(pt[nt][e]);
            // dS^T, written over P^T once dV has read it
            dpt[nt][e] = pt[nt][e] * (dpt[nt][e] - delta_sh[il]);
          }
        __syncwarp();
        // dV += P^T dO: B(i, d) = dO[i][d], row-major in do_sh
        flash::warp_gemm<kNtD, kSubQ>(dv_acc, Tile<T, true>{pt_sh, kLdP},
                                      Tile<T, true>{do_sh + c0 * kLd, kLd});
        __syncwarp();
#pragma unroll
        for (int nt = 0; nt < kNtS; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            pt_sh[(g + 8 * (e >> 1)) * kLdP + nt * 8 + 2 * t + (e & 1)] =
                flash::from_f32<T>(dpt[nt][e]);
        __syncwarp();
        // dK += dS^T Q: B(i, d) = Q[i][d], row-major in q_sh
        flash::warp_gemm<kNtD, kSubQ>(dk_acc, Tile<T, true>{pt_sh, kLdP},
                                      Tile<T, true>{q_sh + c0 * kLd, kLd});
        __syncwarp();
      }
    }
  }
  flash::store_rows<T, kNtD>(dk + kbase * D, dk_acc, k0 + warp * kWarpRows,
                             n, scale, scale);
  flash::store_rows<T, kNtD>(dv + kbase * D, dv_acc, k0 + warp * kWarpRows,
                             n, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T, int D>
cudaError_t launch_delta(const void* o, const void* dout, void* delta,
                         size_t rows, cudaStream_t stream) {
  constexpr int kRowsPerBlock = 8;
  const size_t blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  flash_bwd_delta_kernel<T, D><<<static_cast<unsigned>(blocks),
                                 kRowsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_q(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dq, int batch, int heads, int kv_heads, int n,
                     float scale, cudaStream_t stream) {
  const size_t smem = smem_q_bytes<T, D>();
  auto kernel = flash_bwd_q_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockQ - 1) / kBlockQ, heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), heads, kv_heads, n, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_kv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dk, void* dv, int batch, int heads, int kv_heads,
                      int n, float scale, cudaStream_t stream) {
  const size_t smem = smem_kv_bytes<T, D>();
  auto kernel = flash_bwd_kv_kernel<T, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBlockK - 1) / kBlockK, kv_heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), heads, kv_heads, n, scale);
  return cudaGetLastError();
}

bool valid(int batch, int heads, int kv_heads, int n, int block_q,
           int block_k) {
  return batch > 0 && kv_heads > 0 && heads % kv_heads == 0 && n >= 0 &&
         block_q == kBlockQ && block_k == kBlockK;
}

}  // namespace

#define FLASH_DISPATCH(T_CODE, D, CALL)                               \
  do {                                                                \
    if ((T_CODE) == 0) {                                              \
      using T = float;                                                \
      if ((D) == 32) { constexpr int kD = 32; return (int)(CALL); }   \
      if ((D) == 64) { constexpr int kD = 64; return (int)(CALL); }   \
      if ((D) == 128) { constexpr int kD = 128; return (int)(CALL); } \
    } else if ((T_CODE) == 1) {                                       \
      using T = __nv_bfloat16;                                        \
      if ((D) == 32) { constexpr int kD = 32; return (int)(CALL); }   \
      if ((D) == 64) { constexpr int kD = 64; return (int)(CALL); }   \
      if ((D) == 128) { constexpr int kD = 128; return (int)(CALL); } \
    }                                                                 \
    return static_cast<int>(cudaErrorInvalidValue);                   \
  } while (0)

// Plain C interface, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  block_q / block_k must be the compiled tiles (64, 64).
// Each returns the cudaError_t of its launch (0 = success); launches are
// asynchronous on `stream`.

extern "C" int flash_bwd_delta(const void* o, const void* dout, void* delta,
                               int batch, int heads, int n, int d, int dtype,
                               void* stream) {
  if (batch <= 0 || heads <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(batch) * heads * n;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, d, (launch_delta<T, kD>(o, dout, delta, rows, st)));
}

extern "C" int flash_bwd_q(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int batch, int heads,
                           int kv_heads, int n, int d, int block_q,
                           int block_k, float scale, int dtype,
                           void* stream) {
  if (!valid(batch, heads, kv_heads, n, block_q, block_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, d,
                 (launch_q<T, kD>(q, k, v, dout, lse, delta, dq, batch,
                                  heads, kv_heads, n, scale, st)));
}

extern "C" int flash_bwd_kv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int batch,
                            int heads, int kv_heads, int n, int d,
                            int block_q, int block_k, float scale, int dtype,
                            void* stream) {
  if (!valid(batch, heads, kv_heads, n, block_q, block_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  FLASH_DISPATCH(dtype, d,
                 (launch_kv<T, kD>(q, k, v, dout, lse, delta, dk, dv, batch,
                                   heads, kv_heads, n, scale, st)));
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
