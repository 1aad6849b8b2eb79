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
// lse and delta (B, H, N) f32.
//
// What bounds it: the products.  The split recomputes Q K^T and dO V^T in
// both product kernels, so it runs 7 products where a fused backward runs
// 5; causal at B=2, H=16, N=8192, D=128 they are ~1.9e12 flop (~1.95 ms
// at 989 TFLOP/s on the bf16 tensor cores: 0.83 ms in flash_bwd_q, 1.11
// ms in flash_bwd_kv) against ~5.4e8 bytes moved (~0.16 ms at 3.35
// TB/s): operations.  The split keeps the backward deterministic (no
// atomics) and the reference's structure.
//
// Two bodies of each product kernel, chosen by the launcher from the
// dtype and D:
//
// The wgmma body: bf16 at D = 128 (the main path).  Two warpgroups of 64
// rows per block issue `wgmma` (sm90.cuh); one thread loads the block's
// resident tiles once and streams the others through a 2-stage TMA ring
// (3-D maps, zero-filled past a head's N; full and empty mbarriers), the
// next tile in flight while the current one's products run; blocks start
// longest walk first over every head and slot
// (`flash::wg::launch_order`); no producer warp and no setmaxnreg (every
// thread keeps up to 255 registers).
//   * flash_bwd_q: one block per (128 query rows, head, slot), Q and dO
//     resident, K and V tiles of 64 keys streamed up to the diagonal.
//     S = Q K^T and dP = dO V^T from shared memory (K-major); dS =
//     P (dP - delta) is formed in registers and feeds dQ += dS K as the
//     register A operand, K read MN-major;
//   * flash_bwd_kv: one block per (128 keys, KV head, slot), K and V
//     resident, Q, dO, lse and delta tiles of 64 query rows streamed over
//     every query head of the group and every query tile from the
//     diagonal on (lse and delta by 4-byte cp.async onto the same
//     barrier: a row's start need not be 16-byte aligned, as a TMA
//     box's must).  S^T = K Q^T and dP^T =
//     V dO^T from shared memory; P^T and dS^T feed dV += P^T dO and
//     dK += dS^T Q from registers, dO and Q read MN-major from the same
//     tiles the first products read K-major; dV runs while dS^T is
//     formed;
//   * only tiles that cross a warpgroup's diagonal or the N edge run the
//     mask arithmetic; tiles no row of a warpgroup can see are skipped.
// The mma.sync body: f32 at D = 32, 64, 128 and bf16 at D = 32, 64.
//   * both product kernels run blocks of 4 warps whose warps own 16 rows
//     (the M edge of `mma.sync` m16n8k16, bf16 in, f32 accumulate; the
//     f32 instance runs the same tiles on the CUDA cores), stage their
//     tiles in shared memory by 16-byte `cp.async` copies, all in flight
//     at once, and zero-fill the ragged edge, masking it too;
//   * flash_bwd_q: one block per (64 query rows, head, slot) walks the KV
//     tiles up to its diagonal; P and dP stay in registers, dS goes
//     through a per-warp shared tile in T to feed dS K;
//   * flash_bwd_kv: one block per (64 keys, KV head, slot) walks every
//     query head of its group and every query tile from the diagonal on,
//     computing the transposed scores S^T = K Q^T directly (a warp owns
//     16 keys), so P^T and dS^T feed their products from a per-warp shared
//     tile.
// In both, dk and dv accumulate in registers and land on the unexpanded
// (B, Hkv, N, D) tensors with no atomics: the result is deterministic.
// The delta pass is its own kernel (one warp per row), so both product
// kernels read delta as they read lse.

#include <string.h>

#include "flash_common.cuh"
#include "plan.cuh"
#include "sm90.cuh"

// ---------------------------------------------------------------------------
// the wgmma bodies (bf16, D = 128)
// ---------------------------------------------------------------------------

namespace bw {

using bf16 = __nv_bfloat16;
using flash::wg::kD;
using flash::wg::kLog2e;
using flash::wg::kThreads;
using flash::wg::tile_bytes;

constexpr int kBlock = 128;   // resident rows of a block: two warpgroups
constexpr int kStream = 64;   // rows of a streamed tile
// Each ring holds 2 streamed tiles: tile t + 1 loads while tile t's
// products run.  A tile's last product completes within the tile: left
// in flight across the next tile's products, it measured slower in
// flash_bwd_q, and in flash_bwd_kv its A operands would not fit in
// registers beside the next tile's S^T and dP^T.
constexpr int kStages = 2;
constexpr size_t kBlockBytes = tile_bytes(kBlock);
constexpr size_t kStreamBytes = tile_bytes(kStream);
constexpr size_t kStatBytes = kStream * sizeof(float);  // lse or delta
// two resident tiles, two streamed tiles per stage (flash_bwd_kv: and
// their lse and delta), the barriers and the alignment pad
constexpr size_t kSmemQ = 2 * kBlockBytes + 2 * kStages * kStreamBytes +
                          flash::wg::kExtra;
constexpr size_t kSmemKV = kSmemQ + 2 * kStages * kStatBytes;

// the thread's place in the wgmma accumulator: warpgroup, warp within
// it, row group g and column pair tq
struct Lane {
  int wg, warp, g, tq;
  __device__ Lane()
      : wg(threadIdx.x / 128),
        warp((threadIdx.x % 128) / 32),
        g((threadIdx.x % 32) / 4),
        tq(threadIdx.x % 4) {}
};

// S (+)= A B over D for a warpgroup: A its 64 rows of a resident K-major
// tile of 128 rows, B a streamed K-major tile of 64 rows
__device__ __forceinline__ void scores(float (&d)[32], const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    sm90::mma_ss_n64(d, sm90::desc_k<kBlock>(a, kk),
                     sm90::desc_k<kStream>(b, kk), kk);
}

// acc += A B over 64 rows: A in registers, B a tile of 64 rows read
// MN-major
__device__ __forceinline__ void accumulate(float (&acc)[64],
                                           const uint32_t (&a)[4][4],
                                           const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    sm90::mma_rs_n128(acc, a[kk], sm90::desc_mn<kStream>(b, kk), 1);
}

// dS = P (dP - delta) in place of S for one tile of flash_bwd_q, P =
// exp(s - lse) zeroed above the diagonal where kMasked
template <bool kMasked>
__device__ __forceinline__ void ds_rows(float (&sc)[32], const float (&dp)[32],
                                        const float (&lse2)[2],
                                        const float (&dlt)[2], float sl2,
                                        int k0, int tq,
                                        const int (&rows)[2]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int r = (i >> 1) & 1;
    float p = flash::wg::exp2_ftz(fmaf(sc[i], sl2, -lse2[r]));
    if (kMasked && k0 + 8 * (i / 4) + 2 * tq + (i & 1) > rows[r]) p = 0.f;
    sc[i] = p * (dp[i] - dlt[r]);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_q_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                             const __grid_constant__ CUtensorMap do_map,
                             const __grid_constant__ CUtensorMap k_map,
                             const __grid_constant__ CUtensorMap v_map,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int heads, int kv_heads,
                             int n, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  bf16* q_sh = reinterpret_cast<bf16*>(smem);
  bf16* do_sh = reinterpret_cast<bf16*>(smem + kBlockBytes);
  bf16* k_sh = reinterpret_cast<bf16*>(smem + 2 * kBlockBytes);
  bf16* v_sh = reinterpret_cast<bf16*>(smem + 2 * kBlockBytes +
                                       kStages * kStreamBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      smem + 2 * kBlockBytes + 2 * kStages * kStreamBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  // deepest query tiles (longest walks) first, across all heads and slots
  const flash::wg::Order ord = flash::wg::launch_order();
  const int q_tiles = (n + kBlock - 1) / kBlock;
  const int qt = q_tiles - 1 - ord.rank;
  const int h = ord.head, b = ord.slot;
  const int hk = h / (heads / kv_heads);
  const int q0 = qt * kBlock;
  const int kv_tiles = (min(n, q0 + kBlock) - 1) / kStream + 1;
  const int q_slice = b * heads + h, kv_slice = b * kv_heads + hk;
  const int tid = threadIdx.x;

  auto load_kv = [&](int tile) {
    const int s = tile % kStages;
    sm90::bar_expect(&full[s], 2 * kStreamBytes);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sm90::tma_load_3d(k_sh + (s * kStream + c * kStream / 2) * kD, &k_map,
                        &full[s], 64 * c, tile * kStream, kv_slice);
      sm90::tma_load_3d(v_sh + (s * kStream + c * kStream / 2) * kD, &v_map,
                        &full[s], 64 * c, tile * kStream, kv_slice);
    }
  };
  if (tid == 0) {
    sm90::bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(&full[s], 1);
      sm90::bar_init(&empty[s], kThreads);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    sm90::bar_expect(q_full, 2 * kBlockBytes);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sm90::tma_load_3d(q_sh + c * kBlock / 2 * kD, &q_map, q_full, 64 * c,
                        q0, q_slice);
      sm90::tma_load_3d(do_sh + c * kBlock / 2 * kD, &do_map, q_full, 64 * c,
                        q0, q_slice);
    }
    for (int t = 0; t < min(kStages, kv_tiles); ++t) load_kv(t);
  }

  const Lane ln;
  const int wrow0 = q0 + 64 * ln.wg;
  const int row = wrow0 + 16 * ln.warp + ln.g;  // rows row and row + 8
  const int rows[2] = {row, row + 8};
  const size_t qbase = static_cast<size_t>(q_slice) * n;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = rows[r] < n ? lse[qbase + rows[r]] * kLog2e : 0.f;
    dlt[r] = rows[r] < n ? delta[qbase + rows[r]] : 0.f;
  }
  const float sl2 = scale * kLog2e;
  const bf16* q_wg = q_sh + 64 * ln.wg * 64;
  const bf16* do_wg = do_sh + 64 * ln.wg * 64;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  sm90::bar_wait(q_full, 0);

  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int s = kt % kStages;
    if (tid == 0 && kt >= 1 && kt + kStages - 1 < kv_tiles) {
      sm90::bar_wait(&empty[(kt - 1) % kStages], ((kt - 1) / kStages) & 1);
      load_kv(kt + kStages - 1);
    }
    __syncwarp();
    sm90::bar_wait(&full[s], (kt / kStages) & 1);
    const int k0 = kt * kStream;
    if (k0 <= wrow0 + 63) {  // some row of the warpgroup sees the tile
      float sc[32], dp[32];
      sm90::mma_fence();
      scores(sc, q_wg, k_sh + s * kStream * kD);
      scores(dp, do_wg, v_sh + s * kStream * kD);
      sm90::mma_commit();
      sm90::mma_wait<0>();
      sm90::pin(sc);
      sm90::pin(dp);
      if (k0 + kStream - 1 > wrow0)
        ds_rows<true>(sc, dp, lse2, dlt, sl2, k0, ln.tq, rows);
      else
        ds_rows<false>(sc, dp, lse2, dlt, sl2, k0, ln.tq, rows);
      uint32_t ds[4][4];
      sm90::to_a<4>(ds, sc);
      sm90::pin(acc);
      sm90::pin(ds);
      sm90::mma_fence();
      accumulate(acc, ds, k_sh + s * kStream * kD);
      sm90::mma_commit();
      sm90::mma_wait<0>();
      sm90::pin(acc);
      sm90::pin(ds);
    }
    sm90::bar_arrive(&empty[s]);
  }
  flash::wg::store_rows(dq + qbase * kD, acc, wrow0, n, scale, scale);
}

// P^T = exp(s - lse) in place of S^T for one tile of flash_bwd_kv (query
// columns q0 + c, c = 8 (e / 4) + 2 tq + e % 2), zeroed where a query
// precedes the key or lies past n where kMasked
template <bool kMasked>
__device__ __forceinline__ void p_cols(float (&st)[32], const float* lse_t,
                                       float sl2, int q0, int n, int tq,
                                       const int (&keys)[2]) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int c = 8 * (e / 4) + 2 * tq + (e & 1);
    const float p = flash::wg::exp2_ftz(fmaf(st[e], sl2, -lse_t[c] * kLog2e));
    st[e] = kMasked && (q0 + c < keys[(e >> 1) & 1] || q0 + c >= n) ? 0.f
                                                                     : p;
  }
}

// dS^T = P^T (dP^T - delta) in place of dP^T
__device__ __forceinline__ void ds_cols(float (&dpt)[32],
                                        const float (&pt)[32],
                                        const float* dlt_t, int tq) {
#pragma unroll
  for (int e = 0; e < 32; ++e)
    dpt[e] = pt[e] * (dpt[e] - dlt_t[8 * (e / 4) + 2 * tq + (e & 1)]);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int heads, int kv_heads, int n, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  bf16* k_sh = reinterpret_cast<bf16*>(smem);
  bf16* v_sh = reinterpret_cast<bf16*>(smem + kBlockBytes);
  bf16* q_sh = reinterpret_cast<bf16*>(smem + 2 * kBlockBytes);
  bf16* do_sh = reinterpret_cast<bf16*>(smem + 2 * kBlockBytes +
                                        kStages * kStreamBytes);
  float* lse_sh = reinterpret_cast<float*>(smem + 2 * kBlockBytes +
                                           2 * kStages * kStreamBytes);
  float* dlt_sh = lse_sh + kStages * kStream;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dlt_sh + kStages * kStream);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  // shallowest KV tiles (most queries) first, across all heads and slots
  const flash::wg::Order ord = flash::wg::launch_order();
  const int kt = ord.rank;
  const int hk = ord.head, b = ord.slot;
  const int group = heads / kv_heads;
  const int k0 = kt * kBlock;
  const int q_tiles = (n + kStream - 1) / kStream;
  const int qt0 = k0 / kStream;  // the first query tile at the diagonal
  const int per_head = q_tiles - qt0;
  const int tiles = group * per_head;
  const int kv_slice = b * kv_heads + hk;
  const int tid = threadIdx.x;

  // Q, dO, lse and delta of streamed tile i: query head i / per_head of
  // the group, query tile qt0 + i % per_head.  Run by the 32 lanes of
  // warp 0: lane 0 issues the TMA loads, every lane copies 2 of the 64
  // lse and delta values by cp.async (zero past n) and arrives on the
  // stage's barrier when they land
  auto load_q = [&](int i) {
    const int s = i % kStages;
    const int slice = b * heads + hk * group + i / per_head;
    const int r0 = (qt0 + i % per_head) * kStream;
    if (tid == 0) {
      sm90::bar_expect(&full[s], 2 * kStreamBytes);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sm90::tma_load_3d(q_sh + (s * kStream + c * kStream / 2) * kD,
                          &q_map, &full[s], 64 * c, r0, slice);
        sm90::tma_load_3d(do_sh + (s * kStream + c * kStream / 2) * kD,
                          &do_map, &full[s], 64 * c, r0, slice);
      }
    }
    const size_t base = static_cast<size_t>(slice) * n;
#pragma unroll
    for (int c = tid; c < kStream; c += 32) {
      const bool in = r0 + c < n;
      const size_t at = base + (in ? r0 + c : 0);
      sm90::cp_async_4(lse_sh + s * kStream + c, lse + at, in);
      sm90::cp_async_4(dlt_sh + s * kStream + c, delta + at, in);
    }
    sm90::cp_async_arrive(&full[s]);
  };
  if (tid == 0) {
    sm90::bar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(&full[s], 1 + 32);  // the TMA issuer and warp 0
      sm90::bar_init(&empty[s], kThreads);
    }
    sm90::bar_init_fence();
  }
  __syncthreads();
  if (tid < 32) {
    if (tid == 0) {
      sm90::bar_expect(kv_full, 2 * kBlockBytes);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        sm90::tma_load_3d(k_sh + c * kBlock / 2 * kD, &k_map, kv_full,
                          64 * c, k0, kv_slice);
        sm90::tma_load_3d(v_sh + c * kBlock / 2 * kD, &v_map, kv_full,
                          64 * c, k0, kv_slice);
      }
    }
    for (int i = 0; i < min(kStages, tiles); ++i) load_q(i);
  }

  const Lane ln;
  const int kw0 = k0 + 64 * ln.wg;  // the warpgroup's first key
  const int key = kw0 + 16 * ln.warp + ln.g;  // keys key and key + 8
  const int keys[2] = {key, key + 8};
  const float sl2 = scale * kLog2e;
  const bf16* k_wg = k_sh + 64 * ln.wg * 64;
  const bf16* v_wg = v_sh + 64 * ln.wg * 64;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  sm90::bar_wait(kv_full, 0);

  for (int i = 0; i < tiles; ++i) {
    const int s = i % kStages;
    if (tid < 32 && i >= 1 && i + kStages - 1 < tiles) {
      if (tid == 0)
        sm90::bar_wait(&empty[(i - 1) % kStages], ((i - 1) / kStages) & 1);
      __syncwarp();
      load_q(i + kStages - 1);
    }
    __syncwarp();
    sm90::bar_wait(&full[s], (i / kStages) & 1);
    const int q0 = (qt0 + i % per_head) * kStream;
    if (q0 + kStream - 1 >= kw0) {  // some query of the tile sees a key
      const bf16* q_t = q_sh + s * kStream * kD;
      const bf16* do_t = do_sh + s * kStream * kD;
      float st[32], dpt[32];
      sm90::mma_fence();
      scores(st, k_wg, q_t);
      scores(dpt, v_wg, do_t);
      sm90::mma_commit();
      sm90::mma_wait<0>();
      sm90::pin(st);
      sm90::pin(dpt);
      const float* lse_t = lse_sh + s * kStream;
      if (q0 < kw0 + 63 || q0 + kStream > n)
        p_cols<true>(st, lse_t, sl2, q0, n, ln.tq, keys);
      else
        p_cols<false>(st, lse_t, sl2, q0, n, ln.tq, keys);
      // dV += P^T dO runs while dS^T is formed
      uint32_t pa[4][4], da[4][4];
      sm90::to_a<4>(pa, st);
      sm90::pin(dv_acc);
      sm90::pin(pa);
      sm90::mma_fence();
      accumulate(dv_acc, pa, do_t);
      sm90::mma_commit();
      ds_cols(dpt, st, dlt_sh + s * kStream, ln.tq);
      sm90::to_a<4>(da, dpt);
      sm90::pin(dk_acc);
      sm90::pin(da);
      sm90::mma_fence();
      accumulate(dk_acc, da, q_t);
      sm90::mma_commit();
      sm90::mma_wait<0>();
      sm90::pin(dv_acc);
      sm90::pin(dk_acc);
      sm90::pin(pa);
      sm90::pin(da);
    }
    sm90::bar_arrive(&empty[s]);
  }
  const size_t kbase = static_cast<size_t>(kv_slice) * n * kD;
  flash::wg::store_rows(dk + kbase, dk_acc, kw0, n, scale, scale);
  flash::wg::store_rows(dv + kbase, dv_acc, kw0, n, 1.f, 1.f);
}

}  // namespace bw

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

enum class Kind { kDelta, kQ, kKV };

constexpr int kDeltaRowsPerBlock = 8;  // one warp per row

// The launch of one of the three kernels, shared by the launchers and
// `flash_bwd_plan`: f(Type<T>{}, kernel, geometry, Int<wgmma>{}) for the
// instantiation a call with these arguments runs, after checking the
// tiles the caller names against that body's (the delta pass has none).
// delta: one warp per row of the flattened (B * H * N) rows, 8 rows a
// block, no shared memory.  wgmma body: dq one block of two warpgroups
// per (128 query rows, head, slot), dk/dv one per (128 keys, KV head,
// slot).  mma.sync body: one block of 4 warps per (64 query rows, head,
// slot) or (64 keys, KV head, slot).
template <Kind K, typename F>
cudaError_t with_launch(int dtype, int d, int batch, int heads, int kv_heads,
                        int n, int block_q, int block_k, F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      using T = typename decltype(t)::type;
      constexpr int D = decltype(dc)::value;
      if constexpr (K == Kind::kDelta) {
        const size_t rows = static_cast<size_t>(batch) * heads * n;
        return f(t, flash_bwd_delta_kernel<T, D>,
                 plan::Geometry{
                     dim3(static_cast<unsigned>(
                         (rows + kDeltaRowsPerBlock - 1) /
                         kDeltaRowsPerBlock)),
                     kDeltaRowsPerBlock * 32, 0, 1},
                 plan::Int<0>{});
      } else if constexpr (flash::wg::covers<T, D>()) {
        constexpr bool kQ = K == Kind::kQ;
        // (block_q, block_k): dq (128, 64), dk/dv (64, 128)
        if (block_q != (kQ ? bw::kBlock : bw::kStream) ||
            block_k != (kQ ? bw::kStream : bw::kBlock))
          return cudaErrorInvalidValue;
        const dim3 grid((n + bw::kBlock - 1) / bw::kBlock,
                        kQ ? heads : kv_heads, batch);
        if constexpr (kQ)
          return f(t, bw::flash_bwd_q_wgmma_kernel,
                   plan::Geometry{grid, bw::kThreads, bw::kSmemQ, 1},
                   plan::Int<1>{});
        else
          return f(t, bw::flash_bwd_kv_wgmma_kernel,
                   plan::Geometry{grid, bw::kThreads, bw::kSmemKV, 1},
                   plan::Int<1>{});
      } else {
        if (block_q != kBlockQ || block_k != kBlockK)
          return cudaErrorInvalidValue;
        if constexpr (K == Kind::kQ)
          return f(t, flash_bwd_q_kernel<T, D>,
                   plan::Geometry{
                       dim3((n + kBlockQ - 1) / kBlockQ, heads, batch),
                       kThreads, smem_q_bytes<T, D>(), 1},
                   plan::Int<0>{});
        else
          return f(t, flash_bwd_kv_kernel<T, D>,
                   plan::Geometry{
                       dim3((n + kBlockK - 1) / kBlockK, kv_heads, batch),
                       kThreads, smem_kv_bytes<T, D>(), 1},
                   plan::Int<0>{});
      }
    });
  });
}

bool valid(int batch, int heads, int kv_heads, int n) {
  return batch > 0 && kv_heads > 0 && heads % kv_heads == 0 && n >= 0;
}

// The TMA maps of the wgmma bodies: q and dO (B H, N, 128) in boxes of
// `q_rows` rows, k and v (B Hkv, N, 128) in boxes of `k_rows`.
cudaError_t map_operands(CUtensorMap (&maps)[4], const void* q,
                         const void* dout, const void* k, const void* v,
                         int batch, int heads, int kv_heads, int n,
                         int q_rows, int k_rows) {
  cudaError_t err = sm90::map_rows(&maps[0], q, n, batch * heads, q_rows);
  if (err == cudaSuccess)
    err = sm90::map_rows(&maps[1], dout, n, batch * heads, q_rows);
  if (err == cudaSuccess)
    err = sm90::map_rows(&maps[2], k, n, batch * kv_heads, k_rows);
  if (err == cudaSuccess)
    err = sm90::map_rows(&maps[3], v, n, batch * kv_heads, k_rows);
  return err;
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32,
// 1 = bfloat16.  block_q / block_k must be the tiles of the body the call
// runs (wgmma body: flash_bwd_q 128, 64 and flash_bwd_kv 64, 128;
// mma.sync body: 64, 64).  Each returns the cudaError_t of its launch
// (0 = success); launches are asynchronous on `stream`.  The wgmma
// bodies' TMA reads need every operand 16-byte aligned (the wrapper
// checks it; a map that cannot be encoded is refused with
// cudaErrorInvalidValue).

extern "C" int flash_bwd_delta(const void* o, const void* dout, void* delta,
                               int batch, int heads, int n, int d, int dtype,
                               void* stream) {
  if (batch <= 0 || heads <= 0 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t rows = static_cast<size_t>(batch) * heads * n;
  if (rows == 0) return 0;
  return static_cast<int>(with_launch<Kind::kDelta>(
      dtype, d, batch, heads, heads, n, 0, 0,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto) {
        using T = typename decltype(t)::type;
        return plan::launch(kernel, geo, static_cast<cudaStream_t>(stream),
                            static_cast<const T*>(o),
                            static_cast<const T*>(dout),
                            static_cast<float*>(delta), rows);
      }));
}

extern "C" int flash_bwd_q(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, void* dq, int batch, int heads,
                           int kv_heads, int n, int d, int block_q,
                           int block_k, float scale, int dtype,
                           void* stream) {
  if (!valid(batch, heads, kv_heads, n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return static_cast<int>(with_launch<Kind::kQ>(
      dtype, d, batch, heads, kv_heads, n, block_q, block_k,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        const auto st = static_cast<cudaStream_t>(stream);
        if constexpr (decltype(body)::value == 1) {
          CUtensorMap maps[4];
          const cudaError_t err =
              map_operands(maps, q, dout, k, v, batch, heads, kv_heads, n,
                           bw::kBlock, bw::kStream);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, st, maps[0], maps[1], maps[2],
                              maps[3], static_cast<const float*>(lse),
                              static_cast<const float*>(delta),
                              static_cast<__nv_bfloat16*>(dq), heads,
                              kv_heads, n, scale);
        } else {
          return plan::launch(kernel, geo, st, static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v),
                              static_cast<const T*>(dout),
                              static_cast<const float*>(lse),
                              static_cast<const float*>(delta),
                              static_cast<T*>(dq), heads, kv_heads, n,
                              scale);
        }
      }));
}

extern "C" int flash_bwd_kv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dk, void* dv, int batch,
                            int heads, int kv_heads, int n, int d,
                            int block_q, int block_k, float scale, int dtype,
                            void* stream) {
  if (!valid(batch, heads, kv_heads, n))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return static_cast<int>(with_launch<Kind::kKV>(
      dtype, d, batch, heads, kv_heads, n, block_q, block_k,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        const auto st = static_cast<cudaStream_t>(stream);
        if constexpr (decltype(body)::value == 1) {
          CUtensorMap maps[4];
          const cudaError_t err =
              map_operands(maps, q, dout, k, v, batch, heads, kv_heads, n,
                           bw::kStream, bw::kBlock);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, st, maps[0], maps[1], maps[2],
                              maps[3], static_cast<const float*>(lse),
                              static_cast<const float*>(delta),
                              static_cast<__nv_bfloat16*>(dk),
                              static_cast<__nv_bfloat16*>(dv), heads,
                              kv_heads, n, scale);
        } else {
          return plan::launch(kernel, geo, st, static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v),
                              static_cast<const T*>(dout),
                              static_cast<const float*>(lse),
                              static_cast<const float*>(delta),
                              static_cast<T*>(dk), static_cast<T*>(dv),
                              heads, kv_heads, n, scale);
        }
      }));
}

// The geometry a call of `entry` ("flash_bwd_delta", "flash_bwd_q" or
// "flash_bwd_kv") with these arguments launches, into out[7] (plan.cuh);
// nothing is launched.  flash_bwd_delta reads batch, heads, n, d and dtype.
extern "C" int flash_bwd_plan(const char* entry, int batch, int heads,
                              int kv_heads, int n, int d, int block_q,
                              int block_k, int dtype, int64_t* out) {
  auto report = [&](auto, auto kernel, const plan::Geometry& geo, auto) {
    return plan::report(kernel, geo, out);
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (strcmp(entry, "flash_bwd_delta") == 0) {
    if (batch > 0 && heads > 0 && n >= 0)
      err = with_launch<Kind::kDelta>(dtype, d, batch, heads, heads, n, 0, 0,
                                      report);
  } else if (valid(batch, heads, kv_heads, n)) {
    if (strcmp(entry, "flash_bwd_q") == 0)
      err = with_launch<Kind::kQ>(dtype, d, batch, heads, kv_heads, n,
                                  block_q, block_k, report);
    else if (strcmp(entry, "flash_bwd_kv") == 0)
      err = with_launch<Kind::kKV>(dtype, d, batch, heads, kv_heads, n,
                                   block_q, block_k, report);
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
