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
// slot's offset is Nk - Nq, the training convention).
//
// What bounds it: the two products.  Causal at B=2, H=16, N=8192, D=128
// they are ~5.5e11 flop (~0.56 ms at 989 TFLOP/s on the bf16 tensor cores)
// against ~2.7e8 bytes moved (~0.08 ms at 3.35 TB/s): operations.
//
// Two bodies, chosen by the launcher from the dtype and D:
//
// The wgmma body: bf16 at D = 128 (the main path).
//   * one block of two warpgroups per (128 query rows, head, slot); a
//     warpgroup owns 64 rows, the M of `wgmma` m64nNk16;
//   * one thread loads the Q tile once and the K/V tiles of 128 keys
//     through a 3-stage TMA ring (sm90.cuh: 3-D maps (D, N, B Hkv), so a
//     tile past one head's Nk arrives zero-filled; full and empty
//     mbarriers): tile t + 1 is in flight while tile t's products run;
//   * S = Q K^T by `wgmma` with both operands in shared memory
//     (K-major); the online softmax runs on the accumulator in registers
//     (base 2), P goes to bf16 in registers and feeds O += P V as the
//     register A operand, V read MN-major (no transpose copy).  The P V
//     product is left in flight and completes behind the next tile's
//     S = Q K^T, so a warpgroup waits once per tile; its V stays in the
//     ring's third stage until then;
//   * only a tile that crosses the warpgroup's causal frontier or the Nk
//     edge runs the mask arithmetic; a tile no row of the warpgroup can
//     see is skipped;
//   * blocks start longest walk first over every head and slot
//     (`flash::wg::launch_order`), so the last blocks are short;
//   * no producer warp and no setmaxnreg: the two warpgroups keep up to
//     255 registers a thread, and the TMA-issuing thread waits for the
//     slower warpgroup only to refill a stage both have finished.
//     Turn-taking of the two warpgroups (FlashAttention-3's ping-pong)
//     and issuing P V after the next S measured slower.
// The mma.sync body: f32 at D = 32, 64, 128 and bf16 at D = 32, 64.
//   * one block of 4 warps per (query tile of 64 rows, head, slot); a warp
//     owns 16 query rows, the M edge of `mma.sync` m16n8k16 (bf16 in, f32
//     accumulate); the f32 instance runs the same tiles on the CUDA cores;
//   * the block stages its Q tile once and then walks the KV tiles of 64
//     keys in order, each staged in shared memory by 16-byte `cp.async`
//     copies that are all in flight at once;
//   * scores, running max and sum, and the (16, D) output accumulator stay
//     in registers; the probabilities go through a per-warp shared tile in
//     T (bf16 probabilities feed the P V product, as in FlashAttention-2);
//   * ragged Nq and Nk edges are masked here: rows and keys past the end
//     are zero-filled in shared memory and masked, nothing is padded.
// Both walk each block's KV tiles up to its own causal frontier
// min(Nk, q_offset + last row + 1), so a serving prefill over a max_len
// cache costs what the live prefix costs, and issue query tiles deepest
// first (the mma.sync body within each head).

#include <string.h>

#include "flash_common.cuh"
#include "plan.cuh"
#include "sm90.cuh"

// ---------------------------------------------------------------------------
// the wgmma body (bf16, D = 128)
// ---------------------------------------------------------------------------

namespace fw {

using bf16 = __nv_bfloat16;
using flash::wg::kD;
using flash::wg::kThreads;
using flash::wg::tile_bytes;

constexpr int kBlockQ = 128;  // query rows of a block: two warpgroups
constexpr int kBlockK = 128;  // keys of a streamed K/V tile
// The ring holds 3 K/V tiles: tile t + 1 loads while tile t's products
// run, and tile t - 1 stays until its P V product, left in flight across
// the next tile's S = Q K^T, has completed.
constexpr int kStages = 3;
constexpr size_t kQBytes = tile_bytes(kBlockQ);
constexpr size_t kKVBytes = tile_bytes(kBlockK);
// Q, the K and V stages, the barriers and the alignment pad
constexpr size_t kSmem = kQBytes + 2 * kStages * kKVBytes +
                         flash::wg::kExtra;

// The online-softmax step of one tile on the raw score accumulator sc,
// in base 2 (sl2 = scale log2 e): mask where kMasked, update the running
// max m and this thread's share of the running sum l, rescale the output
// accumulator, and leave P in sc.
template <bool kMasked>
__device__ __forceinline__ void softmax_step(float (&sc)[64],
                                             float (&acc)[64], float (&m)[2],
                                             float (&l)[2], float sl2,
                                             int k0, int nk, int tq,
                                             const int (&pos)[2]) {
  // the row max of the raw scores (sl2 > 0: the max of the scaled ones
  // is sl2 times it); masked scores are -inf
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    if (kMasked) {
      const int j = k0 + 8 * (i / 4) + 2 * tq + (i & 1);
      if (j >= nk || j > pos[r]) sc[i] = -INFINITY;
    }
    mx[r] = fmaxf(mx[r], sc[i]);
  }
  float corr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], flash::quad_max(mx[r]) * sl2);
    corr[r] = flash::wg::exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    // a masked score gives exactly 0
    sc[i] = flash::wg::exp2_ftz(fmaf(sc[i], sl2, -m[r]));
    l[r] += sc[i];
    acc[i] *= corr[r];
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           bf16* __restrict__ o, float* __restrict__ lse,
                           const int* __restrict__ q_offset, int heads,
                           int kv_heads, int nq, int nk, float scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  bf16* q_sh = reinterpret_cast<bf16*>(smem);
  bf16* k_sh = reinterpret_cast<bf16*>(smem + kQBytes);
  bf16* v_sh = reinterpret_cast<bf16*>(smem + kQBytes + kStages * kKVBytes);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(
      smem + kQBytes + 2 * kStages * kKVBytes);
  uint64_t* full = q_full + 1;       // a stage's K/V tile has landed
  uint64_t* empty = full + kStages;  // every thread is done with a stage

  // deepest query tiles (longest walks) first, across all heads and slots
  const flash::wg::Order ord = flash::wg::launch_order();
  const int q_tiles = (nq + kBlockQ - 1) / kBlockQ;
  const int qt = q_tiles - 1 - ord.rank;
  const int h = ord.head, b = ord.slot;
  const int hk = h / (heads / kv_heads);
  const int off = q_offset ? q_offset[b] : nk - nq;
  const int q0 = qt * kBlockQ;
  // the block's causal frontier: its deepest live query row's position
  const int last_key = min(nk, off + min(q0 + kBlockQ, nq)) - 1;
  const int kv_tiles = last_key < 0 ? 0 : last_key / kBlockK + 1;
  const int kv_slice = b * kv_heads + hk;
  const int tid = threadIdx.x;

  // K and V of `tile` into its stage (box c: columns 64 c .. 64 c + 63)
  auto load_kv = [&](int tile) {
    const int s = tile % kStages;
    sm90::bar_expect(&full[s], 2 * kKVBytes);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sm90::tma_load_3d(k_sh + (s * kBlockK + c * kBlockK / 2) * kD, &k_map,
                        &full[s], 64 * c, tile * kBlockK, kv_slice);
      sm90::tma_load_3d(v_sh + (s * kBlockK + c * kBlockK / 2) * kD, &v_map,
                        &full[s], 64 * c, tile * kBlockK, kv_slice);
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
    sm90::bar_expect(q_full, kQBytes);
#pragma unroll
    for (int c = 0; c < 2; ++c)
      sm90::tma_load_3d(q_sh + c * kBlockQ / 2 * kD, &q_map, q_full, 64 * c,
                        q0, b * heads + h);
    for (int t = 0; t < min(kStages, kv_tiles); ++t) load_kv(t);
  }

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int wrow0 = q0 + 64 * wg;         // the warpgroup's first row
  const int row = wrow0 + 16 * warp + g;  // this thread's rows: row, row + 8
  const int pos[2] = {off + row, off + row + 8};
  const int first = off + wrow0, last = first + 63;  // their positions
  const float sl2 = scale * flash::wg::kLog2e;
  const bf16* q_wg = q_sh + 64 * wg * 64;  // row 64 wg of box 0
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  // P of the tile whose P V product is in flight: its A operand, kept
  // unchanged until that product completes
  uint32_t pa[kBlockK / 16][4];
  // running max (base 2) and this thread's share of the running sum
  float m[2] = {flash::kNegInf, flash::kNegInf}, l[2] = {0.f, 0.f};
  sm90::bar_wait(q_full, 0);

  for (int kt = 0; kt < kv_tiles; ++kt) {
    const int s = kt % kStages;
    if (tid == 0 && kt >= 2 && kt + 1 < kv_tiles) {
      // tile kt + 1 into the stage of tile kt - 2, released by both
      // warpgroups once its P V product completed (during tile kt - 1)
      sm90::bar_wait(&empty[(kt - 2) % kStages], ((kt - 2) / kStages) & 1);
      load_kv(kt + 1);
    }
    __syncwarp();
    sm90::bar_wait(&full[s], (kt / kStages) & 1);
    const int k0 = kt * kBlockK;
    const bool seen = k0 <= last;  // some row of the warpgroup sees a key
    float sc[64];
    if (seen) {
      sm90::mma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        sm90::mma_ss_n128(sc, sm90::desc_k<kBlockQ>(q_wg, kk),
                          sm90::desc_k<kBlockK>(k_sh + s * kBlockK * kD, kk),
                          kk);
      sm90::mma_commit();
    }
    // S of this tile, queued behind the previous tile's P V
    sm90::mma_wait<0>();
    sm90::pin(acc);
    sm90::pin(pa);
    if (kt >= 1) sm90::bar_arrive(&empty[(kt - 1) % kStages]);
    if (seen) {
      sm90::pin(sc);
      if (k0 + kBlockK - 1 > first || k0 + kBlockK > nk)
        softmax_step<true>(sc, acc, m, l, sl2, k0, nk, tq, pos);
      else
        softmax_step<false>(sc, acc, m, l, sl2, k0, nk, tq, pos);
      sm90::to_a<kBlockK / 16>(pa, sc);
      sm90::pin(acc);
      sm90::pin(pa);
      sm90::mma_fence();
      const bf16* v_t = v_sh + s * kBlockK * kD;
#pragma unroll
      for (int kk = 0; kk < kBlockK / 16; ++kk)
        sm90::mma_rs_n128(acc, pa[kk], sm90::desc_mn<kBlockK>(v_t, kk), 1);
      sm90::mma_commit();  // completes during the next tile
    }
  }
  sm90::mma_wait<0>();
  sm90::pin(acc);
  sm90::pin(pa);

  const size_t qbase = (static_cast<size_t>(b) * heads + h) * nq;
  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = flash::quad_sum(l[r]);
    l_safe[r] = lr <= 0.f ? 1.f : lr;
  }
  flash::wg::store_rows(o + qbase * kD, acc, wrow0, nq, 1.f / l_safe[0],
                        1.f / l_safe[1]);
  if (lse != nullptr && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = row + 8 * r;
      if (rr < nq)
        lse[qbase + rr] = m[r] == flash::kNegInf
                              ? flash::kNegInf
                              : m[r] * flash::wg::kLn2 + logf(l_safe[r]);
    }
  }
}

}  // namespace fw

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
// f(Type<T>{}, kernel, geometry, Int<wgmma>{}) for the instantiation a
// call with these arguments runs, after checking the tiles the caller
// names against that body's.  wgmma body: one block of two warpgroups per
// (128 query rows, head, slot); mma.sync body: one block of 4 warps per
// (64 query rows, head, slot).
template <typename F>
cudaError_t with_launch(int dtype, int d, int batch, int heads, int nq,
                        int block_q, int block_k, F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      using T = typename decltype(t)::type;
      constexpr int D = decltype(dc)::value;
      if constexpr (flash::wg::covers<T, D>()) {
        if (block_q != fw::kBlockQ || block_k != fw::kBlockK)
          return cudaErrorInvalidValue;
        return f(t, fw::flash_fwd_wgmma_kernel,
                 plan::Geometry{
                     dim3((nq + fw::kBlockQ - 1) / fw::kBlockQ, heads, batch),
                     fw::kThreads, fw::kSmem, 1},
                 plan::Int<1>{});
      } else {
        if (block_q != kBlockQ || block_k != kBlockK)
          return cudaErrorInvalidValue;
        return f(t, flash_fwd_kernel<T, D>,
                 plan::Geometry{
                     dim3((nq + kBlockQ - 1) / kBlockQ, heads, batch),
                     kThreads, smem_bytes<T, D>(), 1},
                 plan::Int<0>{});
      }
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int nq, int nk) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || nq < 0 ||
         nk < 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// block_q / block_k must be the tiles of the body the call runs (wgmma
// body: 128, 128; mma.sync body: 64, 64).  lse and q_offset may be null.
// Returns the cudaError_t of the launch (0 = success); the launch is
// asynchronous on `stream`.  The wgmma body's TMA reads need q, k and v
// 16-byte aligned (the wrapper checks it; a map that cannot be encoded
// is refused with cudaErrorInvalidValue).
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, const void* q_offset, int batch,
                         int heads, int kv_heads, int nq, int nk, int d,
                         int block_q, int block_k, float scale, int dtype,
                         void* stream) {
  if (bad_shape(batch, heads, kv_heads, nq, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nq == 0) return 0;
  return static_cast<int>(with_launch(
      dtype, d, batch, heads, nq, block_q, block_k,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        const auto st = static_cast<cudaStream_t>(stream);
        if constexpr (decltype(body)::value == 1) {
          CUtensorMap q_map, k_map, v_map;
          // with Nk = 0 no block reads K or V: their maps describe q
          const bool no_keys = nk == 0;
          cudaError_t err = sm90::map_rows(&q_map, q, nq, batch * heads,
                                           fw::kBlockQ);
          if (err == cudaSuccess)
            err = sm90::map_rows(&k_map, no_keys ? q : k, no_keys ? nq : nk,
                                 batch * (no_keys ? heads : kv_heads),
                                 fw::kBlockK);
          if (err == cudaSuccess)
            err = sm90::map_rows(&v_map, no_keys ? q : v, no_keys ? nq : nk,
                                 batch * (no_keys ? heads : kv_heads),
                                 fw::kBlockK);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, st, q_map, k_map, v_map,
                              static_cast<__nv_bfloat16*>(o),
                              static_cast<float*>(lse),
                              static_cast<const int*>(q_offset), heads,
                              kv_heads, nq, nk, scale);
        } else {
          return plan::launch(kernel, geo, st, static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v), static_cast<T*>(o),
                              static_cast<float*>(lse),
                              static_cast<const int*>(q_offset), heads,
                              kv_heads, nq, nk, scale);
        }
      }));
}

// The geometry a call of `entry` ("flash_fwd") with these arguments
// launches, into out[7] (plan.cuh); nothing is launched.
extern "C" int flash_fwd_plan(const char* entry, int batch, int heads,
                              int kv_heads, int nq, int nk, int d,
                              int block_q, int block_k, int dtype,
                              int64_t* out) {
  if (strcmp(entry, "flash_fwd") != 0 ||
      bad_shape(batch, heads, kv_heads, nq, nk))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      dtype, d, batch, heads, nq, block_q, block_k,
      [&](auto, auto kernel, const plan::Geometry& geo, auto) {
        return plan::report(kernel, geo, out);
      }));
}

extern "C" const char* flash_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
