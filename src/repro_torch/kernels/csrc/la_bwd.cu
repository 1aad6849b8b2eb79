// Analytic linear-attention backward, plain and decay-gated, for Hopper
// (sm_90a): two kernels, each with a `kGated` instantiation.
//
// Replaces the TPU kernels `la_bwd_pallas`
// (src/repro/kernels/linear_attention.py:208), whose two pallas_calls are
// `_bwd_q_kernel` (:142, grid (B, H, T)) and `_bwd_kv_kernel` (:170,
// grid (B, Hkv, T), run in reverse), and, behind the entries `gla_bwd_q`
// and `gla_bwd_kv`, `gla_bwd_pallas` (src/repro/kernels/gla.py:249;
// `_gla_bwd_q_kernel` :167 and `_gla_bwd_kv_kernel` :202).  With
// Ω̂ = safe_div(ω, g) and h = Σ o·Ω̂ prepared by the caller in f32 (as the
// reference does at linear_attention.py:219-223 and gla.py:262-263),
// paper Eqs. 19-21 give, token by token, with the decay γ_t = exp(ld_t)
// (γ_t = 1 for the linear entries):
//
//   la_bwd_q / gla_bwd_q   (forward scan, one block per (batch, query head))
//     A_t  = γ_t A_{t-1} + k_t^T [v_t, 1]              (Dk, Dv+1)
//     dq_t = b A_t [Ω̂_t, -h_t]                          (Dk,)
//
//   la_bwd_kv / gla_bwd_kv (reverse scan, one block per (batch, KV head))
//     U_p  = γ_{p+1} U_{p+1} + Σ_g [q_gp, 1]^T [Ω̂_gp, h_gp]  (Dk+1, Dv+1)
//     dk_p = b U_p[:Dk] [v_p, -1]                       (Dk,)
//     dv_p = a U_p[Dk, :Dv] + b k_p U_p[:Dk, :Dv]        (Dv,)
//
// The forward scan decays the state carried into t by t's own γ_t; the
// reverse scan carries U_{p+1} into p with γ_{p+1}, the decay of the
// token after p (the weight of query i on key p is Π_{m=p+1..i} γ_m).  g
// runs over the G query heads of the KV head, so dk and dv land on the
// unexpanded (B, Hkv, N, D) tensors with no atomics: the result is
// deterministic.  The sums include the token itself, as the reference's
// causal masks do.
//
// The gated dk/dV' kernel also writes the augmented column of
// dV' = [dv, dv_1]: dv_1,p = -(b k_p · U_p[:Dk, Dv] + a U_p[Dk, Dv]) with
// U's last column built from +h, i.e. dV' = b U^T k + a U[Dk] for the
// reference's [Ω̂, -h].  It returns dV' (B, Hkv, N, Dv+1) in f32 for a
// PyTorch epilogue, as the reference does (gla.py:324-331):
// dcl = -[v, 1]·dV' and dld = the reverse cumsum of dcl.  The epilogue
// needs a dot over Dv per token, which this kernel spreads over D
// threads; keeping it in PyTorch costs one pass over dV' and keeps the
// kernel free of a block reduction per token.
//
// Shapes (all contiguous): q (B, H, N, D), k and v (B, Hkv, N, D) in the
// compute type T (float or bf16); om (B, H, N, D) and h (B, H, N) f32;
// ld (B, Hkv, N) f32 (gated only); dq (B, H, N, D) and dk (B, Hkv, N, D)
// in T; dv (B, Hkv, N, D) in T, or gated dV' (B, Hkv, N, D+1) in f32.
// Dk = Dv = D, a template parameter (32, 64 or 128) so that a state row or
// column lives in registers.
//
// Two bodies of each entry, chosen by the launcher from the dtype and D:
// the chunked wgmma bodies (namespaces bq and bkv; gla_bwd_q and
// gla_bwd_kv run their kGated instances) for bf16 at D = 128, the
// training instance; the token walk (the gated entries its kGated
// instantiation) for f32 and for D < 128.
//
// What bounds them (estimates from the shapes, not measurements; B=2,
// H=Hkv=16, N=8192, D=128): the token walk of la_bwd_q does 4 D (D+1)
// flops per token and head, 17.3 GFLOP, 0.26 ms at 67 TFLOP/s f32,
// against 0.10 ms for its 336.6 MB; la_bwd_kv ~6 D^2 per token and head,
// ~26 GFLOP, 0.39 ms, against 0.14 ms for its 470.8 MB.  The gated
// kernels add one multiply per state element and token.  The walks are
// bound by f32 operations on the CUDA cores.  The chunked bodies do their
// products on the bf16 tensor cores, each product with a hi + lo operand
// two or three times: la_bwd_q 60.1 GFLOP (0.061 ms at 989 TFLOP/s;
// gated, with its two-product update, 68.7 GFLOP, 0.069 ms), la_bwd_kv
// 116.0 GFLOP (0.117 ms; gated, with its three-product update in the dk
// blocks, 124.6 GFLOP); all are bound by their bytes (gla_bwd_q 337.6 MB,
// 0.101 ms; gla_bwd_kv 540.0 MB, 0.161 ms, dV' in f32).
//
// Design of the chunked la_bwd_q body (namespace bq; the reference's
// chunk form, src/repro/kernels/linear_attention.py:142-167, with
// la_fwd.cu's lc as the model):
//   * two blocks per (batch, query head), one per half of dq's Dk = 128
//     columns, so each block's share of the state, A_v = Σ k^T v (its 64
//     rows of Dk x Dv), is one m64n128 f32 accumulator (64 registers a
//     thread); 64 blocks at B=2, H=16, one to an SM;
//   * thread 0 loads each chunk's k (the block's half), v and the f32 Ω̂
//     (TMA boxes of 32 f32 columns, map_rows_f32) into a 2-stage ring;
//     rows past N arrive as zeros; h goes by plain loads a chunk ahead;
//   * per chunk of 64 tokens: Ω̂ is split into hi + lo bf16 tiles; P =
//     Ω̂ v^T and R = Ω̂ A_v^T (SS); P - h on j <= i in f32, split in
//     registers; dq = b (R + P k - h z^T) (RS), z = Σ k an f32 sum on the
//     CUDA cores, double-buffered in shared memory as lc keeps its sums;
//     A_v += k^T v (SS, both MN-major); then A_v's hi + lo copies;
//   * dq is stored from registers; each element is written once;
//   * gated (gla_bwd_q): lc's gated instance carries the decay through the
//     same forward scan (decay.cuh): with cl the chunk's cumsum of the KV
//     head's log decays (base 2), P - h takes 2^(cl_i - cl_j) on j <= i in
//     f32 before its split, R and the carried h z^T take 2^cl_i in the
//     accumulator before P k adds in, A_v decays by 2^total in registers
//     and its update reads (w o v), w_j = 2^(total - cl_j) <= 1, split by
//     the threads into hi + lo tiles (two 64-column boxes each), and z
//     decays likewise (215,808 B).
//
// Design of the chunked la_bwd_kv body (namespace bkv; the reference's
// chunk form, linear_attention.py:170-205, with ssd.cu's sk as the model):
//   * four blocks per (batch, KV head): blocks y = 0, 1 write dk's column
//     half y, blocks y = 2, 3 dv's half y - 2.  Each keeps a 64 x 128
//     slice of U_qΩ = Σ q^T Ω̂ as one m64n128 f32 accumulator in the
//     orientation its readout needs (dk: rows of U_qΩ, dv: rows of
//     U_qΩ^T), as the walk's row and column roles do; 128 blocks at B=2,
//     Hkv=16, one wave on 132 SMs;
//   * the reverse walk goes over (chunk, query head of the group) steps
//     from the last chunk, loaded by TMA into a 2-stage ring: dk blocks
//     v, their half of q and the f32 Ω̂; dv blocks k, q and their half of
//     Ω̂.  U's readout runs at a chunk's first step, from the hi + lo
//     copies of the state before the chunk; each step adds its query
//     head's share; dk or dv is stored at the chunk's last step;
//   * dk = b (v U_qΩ^T - u_h + T q) with T = v Ω̂^T - 1 h^T on i >= p;
//     dv = b k U_qΩ + a u_Ω + A Ω̂ with A = a + b k q^T on i >= p.  u_h =
//     Σ q h and u_Ω = Σ Ω̂ are f32 sums on the CUDA cores;
//   * dk and dv are stored from registers; each element is written once:
//     the result is bit-deterministic;
//   * gated (gla_bwd_kv): ssd.cu's sk carries the decay through the same
//     reverse scan (decay.cuh): with cl the chunk's cumsum of log decays
//     (base 2), the carried state's readout and sums take 2^(total -
//     cl_p) on row p, T and A take 2^(cl_i - cl_p) on i >= p in f32 before
//     their split, and the state decays by 2^total while the chunk's rows
//     i enter weighted by 2^cl_i: the dk blocks weight q (read transposed
//     by ldmatrix into registers, an RS update of two pairs), the dv
//     blocks Ω̂ (split weighted into the free second boxes of Ω̂'s tiles),
//     so no tile is added.  dV' is f32 rows of D + 1, stored from
//     registers (4-byte stores: its 516-byte rows rule out TMA); block y =
//     2 also writes its column D from the row dots of the f32 A with h
//     and f32 sums of q h and h beside u_Ω, their token weights 2^cl and
//     2^cl h formed once a step in shared memory (200,976 B).
//
// Precision of the chunked bodies (held to one bf16 step, 2^-7 of the
// largest |value|).  Where l2-normalized q and k share a direction, the
// terms of [Ω̂, -h] A (dq) and of U [v, -1] (dk) grow with t and cancel,
// so an operand rounded once to bf16 (2^-9) errs several times the
// limit: tests/test_torch_la_bwd_sm90.py's emulation with the lo halves
// dropped misses it by 3-7x on dq.  So every operand that is not a bf16
// input goes as a hi + lo pair (sm90.cuh): Ω̂ (split from its f32 tile),
// the copies of A_v and of U, and the score tiles P, T and A (split in
// registers after the -h or the mask, in f32); products of a pair with a
// pair run three times (hi hi, lo hi, hi lo).  h, z, u_h and u_Ω never
// go through an operand.
//
// Design of the token walk (simple first; as in la_fwd.cu):
//   * every state is tiled over threads in 4 x D/4 register tiles, so each
//     float a thread reads from shared memory feeds 4 FMAs, and the 4
//     partial dots of a tile row are summed across 4 adjacent lanes with
//     two shuffles;
//   * la_bwd_q: thread (dg, cg) owns rows 4dg..4dg+3 of A and columns
//     cg*D/4..(cg+1)*D/4-1; dq_t[d] is the dot of A's row d with the
//     broadcast [Ω̂_t, -h_t]; A's ones column (the running sum of k[d])
//     is kept by every lane of the row;
//   * la_bwd_kv: dk reads U by rows and dv reads it by columns, so the
//     block keeps U twice: D threads tile its rows (4 rows x D/4 columns,
//     plus U[d, Dv] = Σ q[d] h) and compute dk_p; D threads tile its
//     columns (D/4 rows x 4 columns, plus U[Dk, e] = Σ Ω̂[e]) and compute
//     dv_p.  Both copies take the same rank-G update, which doubles the
//     update's flops but needs no cross-tile reduction per token;
//   * inputs are staged `stage` tokens at a time in shared memory as f32
//     by 16-byte loads, each row padded by 4 floats per row group so that
//     the row groups of a warp read disjoint banks; la_bwd_kv stages from the end of the
//     sequence backwards, the tail bounded by N, nothing padded in device
//     memory;
//   * gated: the staging also holds the tokens' decays exp(ld), and every
//     state element takes one multiply more per token (a decay of 1 leaves
//     it exactly as ungated).  For dV''s last entry the row role already
//     holds U's last column U[:Dk, Dv] (its u_last); each row warp sums
//     its share of k.U[:Dk, Dv] with one warp reduction per token into
//     shared memory, and after the stage's tokens the block adds the
//     shares and U[Dk, Dv] (kept by every row thread).  A warp of its own
//     for that column would make 9 warps of ~216 registers at D = 128,
//     more than the register file of one SM's four schedulers holds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <string.h>

#include <type_traits>

#include "decay.cuh"
#include "plan.cuh"
#include "sm90.cuh"

// ---------------------------------------------------------------------------
// the chunked wgmma bodies (bf16, D = 128)
// ---------------------------------------------------------------------------

namespace lbw {

using bf16 = __nv_bfloat16;

constexpr int kD = 128;
constexpr int kHalf = kD / 2;       // the columns a block writes
constexpr int kChunk = 64;          // tokens of a chunk: the M of wgmma
constexpr int kStages = 2;          // steps in the TMA ring
constexpr int kThreads = 128;       // one warpgroup
constexpr size_t kBox = static_cast<size_t>(kChunk) * 128;  // one TMA box
constexpr size_t kTile = 2 * kBox;  // a 64 x 128 bf16 tile
// beside the tiles and the sums: the barriers, and up to 1024 bytes of
// padding to the tiles' 1024-byte alignment
constexpr size_t kExtra = 2048;

// element (t, col) of a 64-row f32 tile loaded by map_rows_f32 (boxes of
// 32 columns, 128-byte swizzled)
__device__ __forceinline__ float f32_at(const unsigned char* tile, int t,
                                        int col) {
  return *reinterpret_cast<const float*>(
      tile + (col / 32) * kBox + t * 128 +
      ((((col % 32) / 4) ^ (t % 8)) * 16) + (col % 4) * 4);
}

// element (t, col) of a 64-row bf16 tile (boxes of 64 columns, 128-byte
// swizzled), as f32
__device__ __forceinline__ float bf16_at(const unsigned char* tile, int t,
                                         int col) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      tile + (col / 64) * kBox + t * 128 +
      ((((col % 64) / 8) ^ (t % 8)) * 16) + (col % 8) * 2));
}

// rows row0 and row0 + 8 of a warpgroup's m64n64 f32 accumulator d (the
// half of D a block writes) as bf16 into rows t0 + row0 (+ 8) < n of
// `out` (rows of kD values, starting at the half's first column), each
// value f(i, column) of accumulator element i
template <typename F>
__device__ __forceinline__ void store_rows(bf16* out, int t0, int row0,
                                           int n, F&& f) {
  const int tq = threadIdx.x % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = t0 + row0 + 8 * r;
    if (row >= n) continue;
    bf16* dst = out + static_cast<size_t>(row) * kD + 2 * tq;
#pragma unroll
    for (int a = 0; a < kHalf / 8; ++a) {
      const int i = 4 * a + 2 * r, col = 8 * a + 2 * tq;
      *reinterpret_cast<uint32_t*>(dst + 8 * a) =
          sm90::pack_bf16(f(i, col), f(i + 1, col + 1));
    }
  }
}

}  // namespace lbw

namespace bq {

using namespace lbw;

constexpr int kSplit = 2;  // blocks per head, by dq's columns
// a stage: k (the block's half, one box), v (two), the f32 Ω̂ (four)
constexpr size_t kK = 0;
constexpr size_t kV = kK + kBox;
constexpr size_t kOm = kV + 2 * kBox;
constexpr size_t kStageBytes = kOm + 4 * kBox;
constexpr float kLog2e = 1.4426950408889634f;
// after the ring: Ω̂'s hi and lo tiles, A_v's hi and lo copies, gated the
// hi and lo (w o v) tiles (64 x 128 each), z twice and h of the chunk
// (f32).  183,040 B; gated 215,808 B: one block an SM
template <bool kGated>
struct Layout {
  static constexpr size_t kOmHi = kStages * kStageBytes;
  static constexpr size_t kOmLo = kOmHi + kTile;
  static constexpr size_t kAHi = kOmLo + kTile;
  static constexpr size_t kALo = kAHi + kTile;
  static constexpr size_t kWvHi = kALo + kTile;
  static constexpr size_t kWvLo = kWvHi + kTile;
  static constexpr size_t kZ = kGated ? kWvLo + kTile : kWvHi;
  static constexpr size_t kH = kZ + 2 * kHalf * 4;
  static constexpr size_t kBars = kH + kChunk * 4;
  static constexpr size_t kSmem = kBars + kExtra;
};

// One block per (batch, query head, half of Dk) walks its head's chunks in
// order.  Per chunk of c = 64 tokens, with A_v (this half's 64 rows of
// Σ k^T v, held as the f32 accumulator av) and z (its Σ k) over the
// earlier chunks:
//   P  = Ω̂ v^T, R = Ω̂ A_v^T                  (wgmma, SS; Ω̂ and A_v hi + lo)
//   P  = P - h on j <= i, else 0              (f32, then hi + lo registers)
//   dq = b (R + P k - h z^T)                  (wgmma, RS; k MN-major)
//   A_v += k^T v                              (wgmma, SS; both MN-major)
//   z  += Σ k                                 (f32, CUDA cores)
// kGated (gla_bwd_q; the reference's _gla_bwd_q_kernel): with cl the
// inclusive cumsum of the chunk's log decays (base 2, the KV head's),
// `total` its last, and every exponent a masked difference <= 0
// (decay.cuh):
//   P  = (P - h) o 2^(cl_i - cl_j) on j <= i   (f32, the mask first)
//   dq = b (2^cl_i (R - h z^T) + P k)          (R scaled in the
//                                              accumulator before P k)
//   A_v = 2^total A_v + k^T (w o v), w_j = 2^(total - cl_j) <= 1
//                                              ((w o v) as hi + lo, SS)
//   z  = 2^total z + Σ_j w_j k_j               (f32, CUDA cores)
template <bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
    la_bwd_q_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                          const __grid_constant__ CUtensorMap v_map,
                          const __grid_constant__ CUtensorMap om_map,
                          const float* __restrict__ ld,
                          const float* __restrict__ hv, bf16* __restrict__ dq,
                          int heads, int kv_heads, int n, float b) {
  using L = Layout<kGated>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  float* z_sh = reinterpret_cast<float*>(smem + L::kZ);  // [2][kHalf]
  float* h_sh = reinterpret_cast<float*>(smem + L::kH);  // [kChunk]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;  // batch * heads + query head
  const int half = blockIdx.y;
  const int bi = bh / heads;
  const int kv_slice = bi * kv_heads + (bh - bi * heads) / (heads / kv_heads);
  const int chunks = (n + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tq = lane % 4;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: +0, +8
  const float* h_row = hv + static_cast<size_t>(bh) * n;

  auto stage_of = [&](int c) { return smem + (c % kStages) * kStageBytes; };
  // k's half, v and Ω̂ of chunk c into its stage; rows past n arrive as
  // zeros
  auto load_chunk = [&](int c) {
    unsigned char* st = stage_of(c);
    uint64_t* bar = &full[c % kStages];
    sm90::bar_expect(bar, kStageBytes);
    sm90::tma_load_3d(st + kK, &k_map, bar, kHalf * half, c * kChunk,
                      kv_slice);
#pragma unroll
    for (int bx = 0; bx < 2; ++bx)
      sm90::tma_load_3d(st + kV + bx * kBox, &v_map, bar, 64 * bx,
                        c * kChunk, kv_slice);
#pragma unroll
    for (int bx = 0; bx < 4; ++bx)
      sm90::tma_load_3d(st + kOm + bx * kBox, &om_map, bar, 32 * bx,
                        c * kChunk, bh);
  };
  // h of chunk c's token tid (0 past n and for tid >= kChunk)
  auto load_h = [&](int c) {
    const int t = c * kChunk + tid;
    return tid < kChunk && t < n ? h_row[t] : 0.f;
  };
  // gated: lane l's two log decays of chunk c in base 2 (tokens 2l,
  // 2l + 1; 0 past n, so the padded tokens of a ragged last chunk decay
  // nothing)
  [[maybe_unused]] auto load_ld = [&](int c, float (&x)[2]) {
    const float* ld_row = ld + static_cast<size_t>(kv_slice) * n;
    const int t = c * kChunk + 2 * lane;
    x[0] = t < n ? ld_row[t] * kLog2e : 0.f;
    x[1] = t + 1 < n ? ld_row[t + 1] * kLog2e : 0.f;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::bar_init(&full[s], 1);
    sm90::bar_init_fence();
  }
  // A_v = 0 before the first chunk (both copies), z = 0
  for (int i = tid; i < static_cast<int>(2 * kTile / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem + L::kAHi)[i] = make_uint4(0, 0, 0, 0);
  if (tid < kHalf) z_sh[tid] = 0.f;
  sm90::fence_async_smem();
  __syncthreads();
  if (tid == 0) load_chunk(0);

  float av[64];  // A_v: rows (Dk) row0 (+ 8), columns (Dv) 8 a + 2 tq (+ 1)
#pragma unroll
  for (int i = 0; i < 64; ++i) av[i] = 0.f;
  float h_next = load_h(0);
  bf16* dq_head = dq + static_cast<size_t>(bh) * n * kD + kHalf * half;
  // gated: the chunk's log decays (the next chunk's, loaded a chunk ahead)
  [[maybe_unused]] float ld_cur[2] = {0.f, 0.f}, ld_next[2] = {0.f, 0.f};
  if constexpr (kGated) load_ld(0, ld_cur);

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    // every thread is done with chunk c - 1: its stage, Ω̂'s tiles, h and
    // the (w o v) tiles are free, A_v's copies and z are whole
    __syncthreads();
    if (tid == 0 && c + 1 < chunks) load_chunk(c + 1);
    if (tid < kChunk) h_sh[tid] = h_next;
    h_next = c + 1 < chunks ? load_h(c + 1) : 0.f;
    if constexpr (kGated) {
      if (c + 1 < chunks) load_ld(c + 1, ld_next);
    }
    __syncwarp();
    sm90::bar_wait(&full[c % kStages], (c / kStages) & 1);
    const unsigned char* st = stage_of(c);
    sm90::split_tile_f32<kD, kThreads>(st + kOm, 0, smem + L::kOmHi,
                                       smem + L::kOmLo);
    sm90::fence_async_smem();
    __syncthreads();  // Ω̂'s tiles and h are whole
    const bf16* k_t = reinterpret_cast<const bf16*>(st + kK);
    const bf16* v_t = reinterpret_cast<const bf16*>(st + kV);
    const bf16* oh_t = reinterpret_cast<const bf16*>(smem + L::kOmHi);
    const bf16* ol_t = reinterpret_cast<const bf16*>(smem + L::kOmLo);
    const bf16* ah_t = reinterpret_cast<const bf16*>(smem + L::kAHi);
    const bf16* al_t = reinterpret_cast<const bf16*>(smem + L::kALo);

    float p[32], acc[32];
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::mma_ss_n64(p, sm90::desc_k<kChunk>(oh_t, kk),
                       sm90::desc_k<kChunk>(v_t, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::mma_ss_n64(p, sm90::desc_k<kChunk>(ol_t, kk),
                       sm90::desc_k<kChunk>(v_t, kk), 1);
    sm90::mma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(oh_t, kk),
                       sm90::desc_k<kHalf>(ah_t, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(ol_t, kk),
                       sm90::desc_k<kHalf>(ah_t, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(oh_t, kk),
                       sm90::desc_k<kHalf>(al_t, kk), 1);
    sm90::mma_commit();

    // behind the products, in f32 on the CUDA cores: gated, cl
    // (cd::scan) and the hi and lo (w o v) tiles; the next chunk's z (each
    // of the first kHalf threads one column of k's half; gated, each token
    // weighted by w and the carried z decayed by 2^total)
    [[maybe_unused]] cd::Cumsum cl;
    [[maybe_unused]] float w_tok[2] = {1.f, 1.f};  // w of tokens 2l, 2l + 1
    [[maybe_unused]] float e_total = 1.f;
    if constexpr (kGated) {
      cl = cd::scan(ld_cur, lane);
#pragma unroll
      for (int bx = 0; bx < 2; ++bx)
        cd::weighted_v<true, kThreads>(cl, st + kV + bx * kBox,
                                       smem + L::kWvHi + bx * kBox,
                                       smem + L::kWvLo + bx * kBox, tid);
      w_tok[0] = sm90::exp2_ftz(cl.total - cl.even);
      w_tok[1] = sm90::exp2_ftz(cl.total - cl.odd);
      e_total = sm90::exp2_ftz(cl.total);
    }
    const float* z_cur = z_sh + (c % 2) * kHalf;
    if (tid < kHalf) {
      float sum = 0.f;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
        if constexpr (kGated)
          sum = fmaf(__shfl_sync(0xffffffffu, w_tok[t & 1], t / 2),
                     bf16_at(st + kK, t, tid), sum);
        else
          sum += bf16_at(st + kK, t, tid);
      }
      z_sh[((c + 1) % 2) * kHalf + tid] =
          kGated ? fmaf(e_total, z_cur[tid], sum) : z_cur[tid] + sum;
    }
    [[maybe_unused]] float cl_col[16], cl_row[2];
    if constexpr (kGated) {
      cl.cols(tq, cl_col);
      cl_row[0] = cl.at(row0);
      cl_row[1] = cl.at(row0 + 8);
    }
    const float h_r[2] = {h_sh[row0], h_sh[row0 + 8]};
    __syncwarp();
    sm90::mma_wait<1>();  // P
    sm90::pin(p);
    if constexpr (!kGated) {
      // P - h on j <= i, else 0: h enters in f32, before any rounding
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int j = 8 * (i / 4) + 2 * tq + (i & 1);
        p[i] = j <= row0 + 8 * r ? p[i] - h_r[r] : 0.f;
      }
    } else {
      // (P - h) o 2^(cl_i - cl_j) on j <= i, in f32 before the split
#pragma unroll
      for (int i = 0; i < 32; ++i) p[i] -= h_r[(i >> 1) & 1];
      cd::decay_mask<true>(p, cl_row, cl_col, warp, tq, row0);
    }
    uint32_t ph[kChunk / 16][4], pl[kChunk / 16][4];
    sm90::to_a_split<kChunk / 16>(ph, pl, p);
    sm90::mma_wait<0>();  // R
    sm90::pin(acc);
    if constexpr (kGated) {
      // 2^cl_i (R - h z^T) in the accumulator, before P k adds in; the
      // state decays by 2^total before its update
      const float e_row[2] = {sm90::exp2_ftz(cl_row[0]),
                              sm90::exp2_ftz(cl_row[1])};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        acc[i] = e_row[r] *
                 (acc[i] - h_r[r] * z_cur[8 * (i / 4) + 2 * tq + (i & 1)]);
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) av[i] *= e_total;
      // the (w o v) tiles for the state update
      sm90::fence_async_smem();
    }
    // no product reads A_v's copies any more: they are rewritten below
    // (gated: the (w o v) tiles are whole)
    __syncthreads();
    sm90::pin(acc);
    sm90::pin(av);
    sm90::pin(ph);
    sm90::pin(pl);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n64(acc, ph[kk], sm90::desc_mn<kChunk>(k_t, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n64(acc, pl[kk], sm90::desc_mn<kChunk>(k_t, kk), 1);
    sm90::mma_commit();
    if constexpr (kGated) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk)
          sm90::mma_ss_n128<1, 1>(
              av, sm90::desc_mn<kChunk>(k_t, kk),
              sm90::desc_mn<kChunk>(reinterpret_cast<const bf16*>(
                                        smem + (x ? L::kWvLo : L::kWvHi)),
                                    kk),
              1);
    } else {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_ss_n128<1, 1>(av, sm90::desc_mn<kChunk>(k_t, kk),
                                sm90::desc_mn<kChunk>(v_t, kk), 1);
    }
    sm90::mma_commit();

    sm90::mma_wait<1>();  // dq, while the state update runs
    sm90::pin(acc);
    sm90::pin(ph);
    sm90::pin(pl);
    store_rows(dq_head, t0, row0, n, [&](int i, int col) {
      return kGated ? b * acc[i]
                    : b * (acc[i] - h_r[(i >> 1) & 1] * z_cur[col]);
    });
    __syncwarp();
    sm90::mma_wait<0>();
    sm90::pin(av);
    // the copies of the new A_v, the B of the next chunk's R
    sm90::store_tile_split<kD / 8>(smem + L::kAHi, smem + L::kALo, av);
    sm90::fence_async_smem();
    if constexpr (kGated) {
      ld_cur[0] = ld_next[0];
      ld_cur[1] = ld_next[1];
    }
  }
}

}  // namespace bq

namespace bkv {

using namespace lbw;

constexpr int kSplit = 4;  // blocks per KV head: dk's halves, dv's halves
// a stage: v (dk blocks) or k (dv blocks), two boxes; q's half (dk, one
// box) or q (dv, two); the f32 Ω̂ (dk: four boxes) or its half (dv: two)
constexpr size_t kKV = 0;
constexpr size_t kQ = kKV + 2 * kBox;
constexpr size_t kOm = kQ + 2 * kBox;
constexpr size_t kStageBytes = kOm + 4 * kBox;
// after the ring: Ω̂'s hi and lo tiles (the dv blocks use their first
// box; gated, their second holds the decay-weighted Ω̂), U's hi and lo
// copies, the f32 sums (u_h or u_Ω) twice and h
constexpr size_t kOmHi = kStages * kStageBytes;
constexpr size_t kOmLo = kOmHi + kTile;
constexpr size_t kUHi = kOmLo + kTile;
constexpr size_t kULo = kUHi + kTile;
constexpr size_t kSums = kULo + kTile;
constexpr size_t kH = kSums + 2 * kHalf * 4;
constexpr float kLog2e = 1.4426950408889634f;
// then, gated only, the sums of dV''s augmented column (u_h over all of
// Dk and Σ h, each twice), the step's token weights 2^cl and 2^cl h, and
// the barriers.  199,424 B; gated 200,976 B: one block an SM
template <bool kGated>
struct Layout {
  static constexpr size_t kUh = kH + kChunk * 4;
  static constexpr size_t kHs = kUh + 2 * kD * 4;
  static constexpr size_t kE = kHs + 16;
  static constexpr size_t kEh = kE + kChunk * 4;
  static constexpr size_t kBars = kGated ? kEh + kChunk * 4 : kUh;
  static constexpr size_t kSmem = kBars + kExtra;
};

// The reverse walk of one block: kDk, dk's column half `part` (its U
// slice U_qΩ[64 part.., :], out = dk); else dv's half (U_qΩ^T[64 part..,
// :], out = dv).  Steps s = j G + gi walk chunk chunks - 1 - j with the
// group's query head gi.  Per step, with U (the f32 accumulator ut), u_h
// or u_Ω over the later chunks:
//   dk: first step of a chunk  acc = v U_qΩ^T        (SS; U's copies)
//       T = v Ω̂^T - 1 h^T on i >= p, else 0           (SS, then f32)
//       acc += T q,  U_qΩ += q^T Ω̂,  u_h += q^T h     (RS; SS; f32)
//       last step: dk = b (acc - u_h)
//   dv: first step of a chunk  acc = b k U_qΩ         (SS; U's copies)
//       A = a + b k q^T on i >= p, else 0             (SS, then f32)
//       acc += A Ω̂,  U_qΩ^T += Ω̂^T q,  u_Ω += Σ Ω̂     (RS; SS; f32)
//       last step: dv = acc + a u_Ω
// kGated (gla_bwd_kv): with cl the inclusive cumsum of the chunk's log
// decays (base 2), `total` its last and e_p = 2^(total - cl_p) the decay
// from token p to the chunk's end (decay.cuh):
//   * the carried state's readout and sums take e_p on row p: dk: acc =
//     e_p (v U_qΩ^T - u_h); dv: acc = e_p (b k U_qΩ + a u_Ω);
//   * T and A take 2^(cl_i - cl_p) on i >= p, in f32 before the split;
//   * the state and its sums decay by 2^total at a chunk's first step,
//     and the chunk's query rows i enter weighted by 2^cl_i: dk blocks
//     weight q's rows, as the A of an RS update read by ldmatrix.trans
//     (U_qΩ += (2^cl o q)^T Ω̂, three products of the pairs); dv blocks
//     split the weighted Ω̂ half into the second boxes of Ω̂'s tiles
//     (U_qΩ^T += (2^cl o Ω̂)^T q);
//   * dv is dV' in f32 (rows of kD + 1), stored from registers; the dv
//     block of the first half also writes its column kD, -(b k_p . U_p[:Dk,
//     Dv] + a U_p[Dk, Dv]): the row dot of the f32 A with h plus e_p (b k_p
//     . u_h + a Σ h), u_h (over all of Dk) and Σ h f32 sums kept beside
//     u_Ω.
template <bool kDk, bool kGated, typename Out>
__device__ __forceinline__ void walk(unsigned char* smem,
                                     const CUtensorMap* q_map,
                                     const CUtensorMap* kv_map,
                                     const CUtensorMap* om_map,
                                     const float* __restrict__ ld,
                                     const float* __restrict__ hv,
                                     Out* __restrict__ out, int part,
                                     int heads, int kv_heads, int n, float a,
                                     float b) {
  using L = Layout<kGated>;
  // gated dv: rows of dV' are kD + 1 f32 values
  constexpr int kOutRow = kGated && !kDk ? kD + 1 : kD;
  float* sums = reinterpret_cast<float*>(smem + kSums);  // [2][kHalf]
  float* h_sh = reinterpret_cast<float*>(smem + kH);     // [kChunk]
  [[maybe_unused]] float* uh = reinterpret_cast<float*>(smem + L::kUh);
  [[maybe_unused]] float* hs = reinterpret_cast<float*>(smem + L::kHs);
  [[maybe_unused]] float* e_sh = reinterpret_cast<float*>(smem + L::kE);
  [[maybe_unused]] float* eh_sh = reinterpret_cast<float*>(smem + L::kEh);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bk = blockIdx.x;  // batch * kv_heads + KV head
  const int group = heads / kv_heads;
  const int bi = bk / kv_heads;
  // query head hk * G + gi reads this KV head
  const int q0 = bi * heads + (bk - bi * kv_heads) * group;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int steps = chunks * group;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int tq = lane % 4;
  const int row0 = 16 * warp + lane / 4;  // this thread's rows: +0, +8
  // gated: the dv block that writes dV''s augmented column
  [[maybe_unused]] const bool aug = kGated && !kDk && part == 0;

  auto stage_of = [&](int s) { return smem + (s % kStages) * kStageBytes; };
  // the tiles of step s into its stage; rows past n arrive as zeros
  auto load_step = [&](int s) {
    const int c = chunks - 1 - s / group, slice = q0 + s % group;
    unsigned char* st = stage_of(s);
    uint64_t* bar = &full[s % kStages];
    sm90::bar_expect(bar, (kDk ? 7 : 6) * kBox);
#pragma unroll
    for (int bx = 0; bx < 2; ++bx)
      sm90::tma_load_3d(st + kKV + bx * kBox, kv_map, bar, 64 * bx,
                        c * kChunk, bk);
    if (kDk) {
      sm90::tma_load_3d(st + kQ, q_map, bar, kHalf * part, c * kChunk,
                        slice);
#pragma unroll
      for (int bx = 0; bx < 4; ++bx)
        sm90::tma_load_3d(st + kOm + bx * kBox, om_map, bar, 32 * bx,
                          c * kChunk, slice);
    } else {
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        sm90::tma_load_3d(st + kQ + bx * kBox, q_map, bar, 64 * bx,
                          c * kChunk, slice);
        sm90::tma_load_3d(st + kOm + bx * kBox, om_map, bar,
                          kHalf * part + 32 * bx, c * kChunk, slice);
      }
    }
  };
  // dk (and gated dv): h of step s's token tid (0 past n and for tid >=
  // kChunk)
  auto load_h = [&](int s) {
    const int t = (chunks - 1 - s / group) * kChunk + tid;
    return (kDk || kGated) && tid < kChunk && t < n
               ? hv[static_cast<size_t>(q0 + s % group) * n + t]
               : 0.f;
  };
  // gated: lane l's two log decays of chunk c in base 2 (tokens 2l,
  // 2l + 1; 0 past n)
  [[maybe_unused]] auto load_ld = [&](int c, float (&x)[2]) {
    const float* ld_row = ld + static_cast<size_t>(bk) * n;
    const int t = c * kChunk + 2 * lane;
    x[0] = t < n ? ld_row[t] * kLog2e : 0.f;
    x[1] = t + 1 < n ? ld_row[t + 1] * kLog2e : 0.f;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::bar_init(&full[s], 1);
    sm90::bar_init_fence();
  }
  // U = 0 past the last chunk (both copies), and its sums
  for (int i = tid; i < static_cast<int>(2 * kTile / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem + kUHi)[i] = make_uint4(0, 0, 0, 0);
  if (tid < kHalf) sums[tid] = 0.f;
  if constexpr (kGated) {
    uh[tid] = 0.f;
    if (tid == 0) hs[0] = 0.f;
  }
  sm90::fence_async_smem();
  __syncthreads();
  if (tid == 0) load_step(0);

  float ut[64];  // dk: U_qΩ rows (Dk) row0 (+ 8), columns (Dv) 8 a + 2 tq
                 // (+ 1); dv: U_qΩ^T rows (Dv), columns (Dk)
#pragma unroll
  for (int i = 0; i < 64; ++i) ut[i] = 0.f;
  float acc[32];  // dk or dv of this half, summed over the group
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float h_next = load_h(0);
  out += static_cast<size_t>(bk) * n * kOutRow + kHalf * part;
  // gated: the chunk's log decays (the next chunk's, loaded a chunk
  // ahead), and the dv block's -dV'[kD] of its rows, summed over the group
  [[maybe_unused]] float ld_cur[2] = {0.f, 0.f}, ld_next[2] = {0.f, 0.f};
  [[maybe_unused]] float xd[2] = {0.f, 0.f};
  if constexpr (kGated) load_ld(chunks - 1, ld_cur);

  for (int s = 0; s < steps; ++s) {
    const int j = s / group;
    const bool first = s - j * group == 0, last = s - j * group == group - 1;
    const int t0 = (chunks - 1 - j) * kChunk;
    // every thread is done with step s - 1: its stage, Ω̂'s tiles and h
    // are free, U's copies and the sums are whole
    __syncthreads();
    if (tid == 0 && s + 1 < steps) load_step(s + 1);
    [[maybe_unused]] cd::Cumsum cl;
    [[maybe_unused]] float e_total = 1.f;
    if constexpr (kGated) {
      if (first && j + 1 < chunks) load_ld(chunks - 2 - j, ld_next);
      cl = cd::scan(ld_cur, lane);
      e_total = sm90::exp2_ftz(cl.total);
      // the weights of the step's sums: 2^cl of token tid, and 2^cl h
      const float e = sm90::exp2_ftz(cl.at(tid % kChunk));
      if (tid < kChunk) {
        e_sh[tid] = e;
        eh_sh[tid] = e * h_next;
      }
    }
    if (kDk || kGated) {
      if (tid < kChunk) h_sh[tid] = h_next;
      h_next = s + 1 < steps ? load_h(s + 1) : 0.f;
    }
    __syncwarp();
    sm90::bar_wait(&full[s % kStages], (s / kStages) & 1);
    const unsigned char* st = stage_of(s);
    sm90::split_tile_f32<kDk ? kD : kHalf, kThreads>(st + kOm, 0,
                                                      smem + kOmHi,
                                                      smem + kOmLo);
    if constexpr (kGated && !kDk)
      cd::split_rows_f32<kHalf, kThreads>(cl, st + kOm, 0,
                                          smem + kOmHi + kBox,
                                          smem + kOmLo + kBox);
    sm90::fence_async_smem();
    __syncthreads();  // Ω̂'s tiles and h are whole
    const bf16* kv_t = reinterpret_cast<const bf16*>(st + kKV);
    const bf16* q_t = reinterpret_cast<const bf16*>(st + kQ);
    const bf16* oh_t = reinterpret_cast<const bf16*>(smem + kOmHi);
    const bf16* ol_t = reinterpret_cast<const bf16*>(smem + kOmLo);
    const bf16* uh_t = reinterpret_cast<const bf16*>(smem + kUHi);
    const bf16* ul_t = reinterpret_cast<const bf16*>(smem + kULo);

    float sc[32];
    sm90::pin(acc);
    sm90::mma_fence();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(kv_t, kk),
                         sm90::desc_k<kHalf>(uh_t, kk), kk);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(kv_t, kk),
                         sm90::desc_k<kHalf>(ul_t, kk), 1);
    }
    if (kDk) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        sm90::mma_ss_n64(sc, sm90::desc_k<kChunk>(kv_t, kk),
                         sm90::desc_k<kChunk>(oh_t, kk), kk);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        sm90::mma_ss_n64(sc, sm90::desc_k<kChunk>(kv_t, kk),
                         sm90::desc_k<kChunk>(ol_t, kk), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        sm90::mma_ss_n64(sc, sm90::desc_k<kChunk>(kv_t, kk),
                         sm90::desc_k<kChunk>(q_t, kk), kk);
    }
    sm90::mma_commit();

    // behind the products, in f32 on the CUDA cores: this step's share of
    // the next chunk's sums (each of the first kHalf threads one column;
    // gated, each token weighted by 2^cl and the carried sums decayed by
    // 2^total)
    const float* s_cur = sums + (j % 2) * kHalf;
    float* s_next = sums + ((j + 1) % 2) * kHalf;
    if (tid < kHalf) {
      float sum = 0.f;
      if (kDk) {
#pragma unroll 8
        for (int t = 0; t < kChunk; ++t) {
          if constexpr (kGated)
            sum = fmaf(bf16_at(st + kQ, t, tid), eh_sh[t], sum);
          else
            sum += bf16_at(st + kQ, t, tid) * h_sh[t];
        }
      } else {
#pragma unroll 8
        for (int t = 0; t < kChunk; ++t) {
          if constexpr (kGated)
            sum = fmaf(f32_at(st + kOm, t, tid), e_sh[t], sum);
          else
            sum += f32_at(st + kOm, t, tid);
        }
      }
      if constexpr (kGated)
        s_next[tid] = (first ? e_total * s_cur[tid] : s_next[tid]) + sum;
      else
        s_next[tid] = (first ? s_cur[tid] : s_next[tid]) + sum;
    }
    [[maybe_unused]] float cl_col[16], cl_row[2], e_row[2];
    if constexpr (kGated) {
      cl.cols(tq, cl_col);
      cl_row[0] = cl.at(row0);
      cl_row[1] = cl.at(row0 + 8);
      e_row[0] = sm90::exp2_ftz(cl.total - cl_row[0]);
      e_row[1] = sm90::exp2_ftz(cl.total - cl_row[1]);
    }
    __syncwarp();
    sm90::mma_wait<0>();
    sm90::pin(sc);
    sm90::pin(acc);
    if constexpr (!kGated) {
      // T (the -h in f32, before any rounding) or A, on i >= p
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int col = 8 * (i / 4) + 2 * tq + (i & 1);
        const bool in = col >= row0 + 8 * r;
        if (kDk)
          sc[i] = in ? sc[i] - h_sh[col] : 0.f;
        else
          sc[i] = in ? fmaf(b, sc[i], a) : 0.f;
      }
      if (!kDk && first) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= b;
      }
    } else {
      // T or A in f32, decayed by 2^(cl_i - cl_p) on i >= p
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * tq + (i & 1);
        sc[i] = kDk ? sc[i] - h_sh[col] : fmaf(b, sc[i], a);
      }
      cd::decay_mask<false>(sc, cl_row, cl_col, warp, tq, row0);
      if (first) {
        // the carried state's readout and sums, decayed to row p
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float sv = s_cur[8 * (i / 4) + 2 * tq + (i & 1)];
          acc[i] = e_row[(i >> 1) & 1] *
                   (kDk ? acc[i] - sv : fmaf(b, acc[i], a * sv));
        }
      }
      if (aug) {
        // -dV'[kD] of rows p: the row dot of A with h (the carried part
        // is added behind the state update)
        float rd[2] = {0.f, 0.f};
#pragma unroll
        for (int i = 0; i < 32; ++i)
          rd[(i >> 1) & 1] =
              fmaf(sc[i], h_sh[8 * (i / 4) + 2 * tq + (i & 1)],
                   rd[(i >> 1) & 1]);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 1);
          rd[r] += __shfl_xor_sync(0xffffffffu, rd[r], 2);
          xd[r] = first ? rd[r] : xd[r] + rd[r];
        }
      }
    }
    uint32_t xh[kChunk / 16][4], xl[kChunk / 16][4];
    sm90::to_a_split<kChunk / 16>(xh, xl, sc);
    // gated dk: (2^cl o q)^T, the A of the state update
    [[maybe_unused]] uint32_t qh[kChunk / 16][4], ql[kChunk / 16][4];
    if constexpr (kGated && kDk)
      cd::weighted_a_trans(st + kQ, cl_col, warp, lane, qh, ql);
    if constexpr (kGated) {
      if (first) {
#pragma unroll
        for (int i = 0; i < 64; ++i) ut[i] *= e_total;
      }
    }
    sm90::pin(acc);
    sm90::pin(ut);
    sm90::pin(xh);
    sm90::pin(xl);
    if constexpr (kGated && kDk) {
      sm90::pin(qh);
      sm90::pin(ql);
    }
    sm90::mma_fence();
    if (kDk) {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n64(acc, xh[kk], sm90::desc_mn<kChunk>(q_t, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n64(acc, xl[kk], sm90::desc_mn<kChunk>(q_t, kk), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n64(acc, xh[kk], sm90::desc_mn<kChunk>(oh_t, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n64(acc, xl[kk], sm90::desc_mn<kChunk>(oh_t, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n64(acc, xh[kk], sm90::desc_mn<kChunk>(ol_t, kk), 1);
    }
    sm90::mma_commit();
    if constexpr (kGated && kDk) {
      // U_qΩ += (2^cl o q)^T Ω̂: the pairs' hi hi, lo hi, hi lo
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n128(ut, qh[kk], sm90::desc_mn<kChunk>(oh_t, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n128(ut, ql[kk], sm90::desc_mn<kChunk>(oh_t, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n128(ut, qh[kk], sm90::desc_mn<kChunk>(ol_t, kk), 1);
    } else {
      // the state update: U_qΩ += q^T Ω̂ (dk) or U_qΩ^T += Ω̂^T q (dv;
      // gated, the weighted Ω̂ from the tiles' second boxes)
      const bf16* ow_t[2] = {
          kGated ? reinterpret_cast<const bf16*>(smem + kOmHi + kBox) : oh_t,
          kGated ? reinterpret_cast<const bf16*>(smem + kOmLo + kBox)
                 : ol_t};
      const bf16* ua_t[2] = {kDk ? q_t : ow_t[0], kDk ? q_t : ow_t[1]};
      const bf16* ub_t[2] = {kDk ? oh_t : q_t, kDk ? ol_t : q_t};
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk)
          sm90::mma_ss_n128<1, 1>(ut, sm90::desc_mn<kChunk>(ua_t[x], kk),
                                  sm90::desc_mn<kChunk>(ub_t[x], kk), 1);
    }
    sm90::mma_commit();

    if constexpr (kGated) {
      if (aug) {
        // behind the products: the next chunk's u_h (each thread one
        // column of q) and Σ h (warp 0), both weighted by 2^cl and the
        // carried ones decayed by 2^total; at a chunk's first step the
        // carried part of -dV'[kD], e_p (b k_p . u_h + a Σ h)
        const float* uh_cur = uh + (j % 2) * kD;
        float* uh_next = uh + ((j + 1) % 2) * kD;
        float sum = 0.f;
#pragma unroll 8
        for (int t = 0; t < kChunk; ++t)
          sum = fmaf(bf16_at(st + kQ, t, tid), eh_sh[t], sum);
        uh_next[tid] = (first ? e_total * uh_cur[tid] : uh_next[tid]) + sum;
        if (warp == 0) {
          float part_h = eh_sh[2 * lane] + eh_sh[2 * lane + 1];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part_h += __shfl_xor_sync(0xffffffffu, part_h, off);
          if (lane == 0)
            hs[(j + 1) % 2] =
                (first ? e_total * hs[j % 2] : hs[(j + 1) % 2]) + part_h;
        }
        if (first) {
          float kdot[2];
          cd::row_dot<kBox>(st + kKV, uh_cur, row0, tq, kdot);
          const float hsum = hs[j % 2];
#pragma unroll
          for (int r = 0; r < 2; ++r)
            xd[r] = fmaf(e_row[r], fmaf(b, kdot[r], a * hsum), xd[r]);
        }
      }
    }
    sm90::mma_wait<1>();  // dk or dv, while the state update runs
    sm90::pin(acc);
    sm90::pin(xh);
    sm90::pin(xl);
    if (last) {
      if constexpr (kGated && !kDk) {
        // dV' rows from registers (rows of kD + 1 f32: 4-byte stores)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = t0 + row0 + 8 * r;
          if (row >= n) continue;
          float* dst = out + static_cast<size_t>(row) * kOutRow + 2 * tq;
#pragma unroll
          for (int x = 0; x < kHalf / 8; ++x) {
            dst[8 * x] = acc[4 * x + 2 * r];
            dst[8 * x + 1] = acc[4 * x + 2 * r + 1];
          }
          if (aug && tq == 0) dst[kD] = -xd[r];
        }
      } else if (kDk) {
        store_rows(out, t0, row0, n, [&](int i, int col) {
          return kGated ? b * acc[i] : b * (acc[i] - s_cur[col]);
        });
      } else {
        store_rows(out, t0, row0, n, [&](int i, int col) {
          return fmaf(a, s_cur[col], acc[i]);
        });
      }
    }
    __syncwarp();
    sm90::mma_wait<0>();
    sm90::pin(ut);
    if constexpr (kGated && kDk) {
      sm90::pin(qh);
      sm90::pin(ql);
    }
    if (last) {
      // every warp is done with this chunk's readout of U's copies
      __syncthreads();
      sm90::store_tile_split<kD / 8>(smem + kUHi, smem + kULo, ut);
    }
    // orders this step's reads of its stage and the copies' stores before
    // the async proxy's next use of those bytes
    sm90::fence_async_smem();
    if constexpr (kGated) {
      if (last) {
        ld_cur[0] = ld_next[0];
        ld_cur[1] = ld_next[1];
      }
    }
  }
}

template <bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
    la_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap om_map,
                           const float* __restrict__ ld,
                           const float* __restrict__ hv,
                           bf16* __restrict__ dk, void* __restrict__ dv,
                           int heads, int kv_heads, int n, float a, float b) {
  // dv: bf16, or the gated dV' in f32
  using Dv = std::conditional_t<kGated, float, bf16>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  if (blockIdx.y < 2)
    walk<true, kGated>(smem, &q_map, &v_map, &om_map, ld, hv, dk,
                       blockIdx.y, heads, kv_heads, n, a, b);
  else
    walk<false, kGated>(smem, &q_map, &k_map, &om_map, ld, hv,
                        static_cast<Dv*>(dv), blockIdx.y - 2, heads,
                        kv_heads, n, a, b);
}

}  // namespace bkv

namespace {

constexpr size_t kMaxSmem = 232448;  // H100: 227 KB of dynamic shared memory

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

// Shared-memory row of one token: D floats in 4 groups of D/4, each
// followed by 4 floats of padding.
template <int D>
struct Rows {
  static constexpr int kGroup = D / 4;
  static constexpr int kPadded = D + 16;
  __device__ static int at(int r) { return r + 4 * (r / kGroup); }
};

// 16 bytes of device memory (8 bf16 or 4 f32 values) as f32.
__device__ __forceinline__ void load16(const float* src, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src,
                                       float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* pairs = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(pairs[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Stage `len` contiguous rows of D values from device memory into the
// padded shared-memory rows `dst` as f32, 16 bytes per load; unrolled so
// that each thread keeps several loads in flight (the loads' latency,
// not their bytes, bounds the staging).  The caller guarantees 16-byte
// aligned rows.
template <int D, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int len,
                                           int tid, int nthr) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll 4
  for (int idx = tid; idx < len * (D / V); idx += nthr) {
    const int e = idx * V;
    const int t = e / D;
    float vals[V];
    load16(src + e, vals);
    float* out = dst + t * Rows<D>::kPadded + Rows<D>::at(e - t * D);
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(out + i) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

// Sum over the 4 adjacent lanes (lane ^ 1, lane ^ 2) that hold the
// partial dots of one tile row.
__device__ __forceinline__ float sum4(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// dQ: forward scan
// ---------------------------------------------------------------------------

template <typename T, int D, bool kGated>
__global__ void la_bwd_q_kernel(const T* __restrict__ k,
                                const T* __restrict__ v,
                                const float* __restrict__ ld,
                                const float* __restrict__ om,
                                const float* __restrict__ hv,
                                T* __restrict__ dq, int heads, int kv_heads,
                                int n, int stage, float b) {
  using L = Rows<D>;
  constexpr int R = L::kGroup;  // columns of a thread's tile
  constexpr int DP = L::kPadded;
  extern __shared__ __align__(16) float smem[];  // read as float4
  float* k_sh = smem;                 // (stage, DP)
  float* v_sh = k_sh + stage * DP;    // (stage, DP)
  float* om_sh = v_sh + stage * DP;   // (stage, DP)
  float* h_sh = om_sh + stage * DP;   // (stage,)
  float* gam_sh = h_sh + stage;       // (stage,) decays (gated only)

  const int bh = blockIdx.x;  // batch * heads + query head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int group = heads / kv_heads;
  const size_t q_base = static_cast<size_t>(bh) * n * D;
  const size_t ld_base = (static_cast<size_t>(bi) * kv_heads + hi / group) * n;
  const size_t kv_base = ld_base * D;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int cg = tid & 3;   // column group of the tile
  const int dg = tid >> 2;  // rows 4dg..4dg+3 of A

  float at_[4][R];  // A[4dg + r, cg*R + e]
  float a1[4];      // A[4dg + r, Dv] = running sum of k[4dg + r]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a1[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < R; ++e) at_[r][e] = 0.0f;
  }

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t q_row = q_base + static_cast<size_t>(t0) * D;
    const size_t kv_row = kv_base + static_cast<size_t>(t0) * D;
    stage_rows<D>(k_sh, k + kv_row, len, tid, nthr);
    stage_rows<D>(v_sh, v + kv_row, len, tid, nthr);
    stage_rows<D>(om_sh, om + q_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr) {
      h_sh[t] = hv[static_cast<size_t>(bh) * n + t0 + t];
      if constexpr (kGated) gam_sh[t] = expf(ld[ld_base + t0 + t]);
    }
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      [[maybe_unused]] const float gam = kGated ? gam_sh[t] : 1.0f;
      const float4 kk4 =
          *reinterpret_cast<const float4*>(k_sh + t * DP + L::at(4 * dg));
      const float kk[4] = {kk4.x, kk4.y, kk4.z, kk4.w};
      const float4* vt =
          reinterpret_cast<const float4*>(v_sh + t * DP + cg * (R + 4));
      const float4* omt =
          reinterpret_cast<const float4*>(om_sh + t * DP + cg * (R + 4));
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int e4 = 0; e4 < R / 4; ++e4) {
        const float4 vv4 = vt[e4];
        const float4 oo4 = omt[e4];
        const float vv[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
        const float oo[4] = {oo4.x, oo4.y, oo4.z, oo4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            if constexpr (kGated)
              at_[r][4 * e4 + c] = fmaf(kk[r], vv[c], gam * at_[r][4 * e4 + c]);
            else
              at_[r][4 * e4 + c] += kk[r] * vv[c];
            acc[r] += at_[r][4 * e4 + c] * oo[c];
          }
        }
      }
      const float ht = h_sh[t];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r] = sum4(acc[r]);
        if constexpr (kGated)
          a1[r] = fmaf(gam, a1[r], kk[r]);
        else
          a1[r] += kk[r];
      }
      if (cg == 0) {
        T* out = dq + q_row + static_cast<size_t>(t) * D + 4 * dg;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          out[r] = from_f32<T>(b * (acc[r] - a1[r] * ht));
      }
    }
    __syncthreads();  // the next iteration overwrites the staging
  }
}

// ---------------------------------------------------------------------------
// dK / dV: reverse scan, the query group folded into the block
// ---------------------------------------------------------------------------

// dv's element type and row stride: T and D, or gated dV' in f32 with its
// augmented column
template <typename T, int D, bool kGated>
struct DvOut {
  using type = T;
  static constexpr int kStride = D;
};
template <typename T, int D>
struct DvOut<T, D, true> {
  using type = float;
  static constexpr int kStride = D + 1;
};

template <typename T, int D, bool kGated>
__global__ void la_bwd_kv_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const float* __restrict__ ld,
                                 const float* __restrict__ om,
                                 const float* __restrict__ hv,
                                 T* __restrict__ dk,
                                 typename DvOut<T, D, kGated>::type* __restrict__ dv,
                                 int heads, int kv_heads, int n, int stage,
                                 float a, float b) {
  using L = Rows<D>;
  using TV = typename DvOut<T, D, kGated>::type;
  constexpr int VS = DvOut<T, D, kGated>::kStride;
  constexpr int R = L::kGroup;
  constexpr int DP = L::kPadded;
  constexpr int kRowWarps = D / 32;
  extern __shared__ __align__(16) float smem[];  // read as float4
  const int group = heads / kv_heads;
  float* q_sh = smem;                         // (G, stage, DP)
  float* om_sh = q_sh + group * stage * DP;   // (G, stage, DP)
  float* k_sh = om_sh + group * stage * DP;   // (stage, DP)
  float* v_sh = k_sh + stage * DP;            // (stage, DP)
  float* h_sh = v_sh + stage * DP;            // (G, stage), after the rows:
                                              // they stay 16-byte aligned
  // gated only: the decays, each row warp's share of k.U[:Dk, Dv], and
  // U[Dk, Dv], per staged token
  float* gam_sh = h_sh + group * stage;       // (stage,)
  float* kpart_sh = gam_sh + stage;           // (stage, kRowWarps)
  float* hh_sh = kpart_sh + stage * kRowWarps;  // (stage,)

  const int bk = blockIdx.x;  // batch * kv_heads + KV head
  const int bi = bk / kv_heads;
  const int hk = bk - bi * kv_heads;
  const size_t kv_base = static_cast<size_t>(bk) * n * D;
  // query head hk * G + gi reads this KV head
  const size_t q_head0 = static_cast<size_t>(bi) * heads + hk * group;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // row role (tid < D): rows 4*(tid/4).. of U, columns (tid%4)*R..;
  // column role: rows ((tid-D)%4)*R.., columns 4*((tid-D)/4)..
  const bool row_role = tid < D;
  const int x = row_role ? tid : tid - D;
  const int grp4 = x >> 2;  // which 4 rows (row role) or 4 columns
  const int sub = x & 3;    // which D/4 columns (row role) or rows

  float u[4][R];  // row role: U[4grp4 + r, sub*R + e];
                  // column role: U[sub*R + i, 4grp4 + c], stored [c][i]
  float u_last[4];  // row role: U[4grp4 + r, Dv]; column: U[Dk, 4grp4 + c]
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    u_last[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < R; ++e) u[r][e] = 0.0f;
  }
  // gated, row role: U[Dk, Dv] = the decayed sum of h
  [[maybe_unused]] float u_hh = 0.0f;
  // gated: the decay of the token after the current one (U starts at
  // zero, so its first value is never used)
  [[maybe_unused]] float g_next = 1.0f;

  for (int t_end = n; t_end > 0; t_end -= stage) {
    const int t0 = max(0, t_end - stage);
    const int len = t_end - t0;
    for (int gi = 0; gi < group; ++gi) {
      const size_t src = ((q_head0 + gi) * n + t0) * D;
      stage_rows<D>(q_sh + gi * stage * DP, q + src, len, tid, nthr);
      stage_rows<D>(om_sh + gi * stage * DP, om + src, len, tid, nthr);
    }
    for (int idx = tid; idx < group * len; idx += nthr) {
      const int gi = idx / len;
      const int t = idx - gi * len;
      h_sh[gi * stage + t] = hv[(q_head0 + gi) * n + t0 + t];
    }
    if constexpr (kGated) {
      for (int t = tid; t < len; t += nthr)
        gam_sh[t] = expf(ld[static_cast<size_t>(bk) * n + t0 + t]);
    }
    const size_t kv_row = kv_base + static_cast<size_t>(t0) * D;
    stage_rows<D>(k_sh, k + kv_row, len, tid, nthr);
    stage_rows<D>(v_sh, v + kv_row, len, tid, nthr);
    __syncthreads();

    for (int t = len - 1; t >= 0; --t) {
      // the token's row of dv (or dV')
      TV* dv_row = dv + (static_cast<size_t>(bk) * n + t0 + t) * VS;
      if constexpr (kGated) {
        // carry U_{p+1} into p: decay by γ_{p+1}
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          u_last[r] *= g_next;
#pragma unroll
          for (int e = 0; e < R; ++e) u[r][e] *= g_next;
        }
        u_hh *= g_next;
        g_next = gam_sh[t];
      }
      if (row_role) {
        for (int gi = 0; gi < group; ++gi) {
          const float* base = (gi * stage + t) * DP + q_sh;
          const float4 qq4 =
              *reinterpret_cast<const float4*>(base + L::at(4 * grp4));
          const float qq[4] = {qq4.x, qq4.y, qq4.z, qq4.w};
          const float4* omt = reinterpret_cast<const float4*>(
              om_sh + (gi * stage + t) * DP + sub * (R + 4));
#pragma unroll
          for (int e4 = 0; e4 < R / 4; ++e4) {
            const float4 oo4 = omt[e4];
            const float oo[4] = {oo4.x, oo4.y, oo4.z, oo4.w};
#pragma unroll
            for (int c = 0; c < 4; ++c) {
#pragma unroll
              for (int r = 0; r < 4; ++r) u[r][4 * e4 + c] += qq[r] * oo[c];
            }
          }
          const float hg = h_sh[gi * stage + t];
#pragma unroll
          for (int r = 0; r < 4; ++r) u_last[r] += qq[r] * hg;
          if constexpr (kGated) u_hh += hg;
        }
        const float4* vt =
            reinterpret_cast<const float4*>(v_sh + t * DP + sub * (R + 4));
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int e4 = 0; e4 < R / 4; ++e4) {
          const float4 vv4 = vt[e4];
          const float vv[4] = {vv4.x, vv4.y, vv4.z, vv4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) {
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[r] += u[r][4 * e4 + c] * vv[c];
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = sum4(acc[r]);
        if (sub == 0) {
          T* out = dk + kv_row + static_cast<size_t>(t) * D + 4 * grp4;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            out[r] = from_f32<T>(b * (acc[r] - u_last[r]));
        }
        if constexpr (kGated) {
          // this warp's share of k.U[:Dk, Dv] (rows 4grp4.. of its sub-0
          // lanes), and U[Dk, Dv]
          float part = 0.0f;
          if (sub == 0) {
            const float4 kk4 = *reinterpret_cast<const float4*>(
                k_sh + t * DP + L::at(4 * grp4));
            part = kk4.x * u_last[0] + kk4.y * u_last[1] +
                   kk4.z * u_last[2] + kk4.w * u_last[3];
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          if ((tid & 31) == 0) kpart_sh[t * kRowWarps + (tid >> 5)] = part;
          if (tid == 0) hh_sh[t] = u_hh;
        }
      } else {
        for (int gi = 0; gi < group; ++gi) {
          const float* obase = om_sh + (gi * stage + t) * DP;
          const float4 oo4 =
              *reinterpret_cast<const float4*>(obase + L::at(4 * grp4));
          const float oo[4] = {oo4.x, oo4.y, oo4.z, oo4.w};
          const float4* qt = reinterpret_cast<const float4*>(
              q_sh + (gi * stage + t) * DP + sub * (R + 4));
#pragma unroll
          for (int i4 = 0; i4 < R / 4; ++i4) {
            const float4 qq4 = qt[i4];
            const float qq[4] = {qq4.x, qq4.y, qq4.z, qq4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r) {
#pragma unroll
              for (int c = 0; c < 4; ++c) u[c][4 * i4 + r] += qq[r] * oo[c];
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) u_last[c] += oo[c];
        }
        const float4* kt =
            reinterpret_cast<const float4*>(k_sh + t * DP + sub * (R + 4));
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i4 = 0; i4 < R / 4; ++i4) {
          const float4 kk4 = kt[i4];
          const float kk[4] = {kk4.x, kk4.y, kk4.z, kk4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[c] += kk[r] * u[c][4 * i4 + r];
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = sum4(acc[c]);
        if (sub == 0) {
          TV* out = dv_row + 4 * grp4;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            out[c] = from_f32<TV>(a * u_last[c] + b * acc[c]);
        }
      }
    }
    __syncthreads();  // the next iteration overwrites the staging
    if constexpr (kGated) {
      // dV'[Dv] = -(b k.U[:Dk, Dv] + a U[Dk, Dv]) of the stage's tokens;
      // the next stage writes these shares only after its staging barrier
      for (int t = tid; t < len; t += nthr) {
        float dot = 0.0f;
#pragma unroll
        for (int w = 0; w < kRowWarps; ++w) dot += kpart_sh[t * kRowWarps + w];
        dv[(static_cast<size_t>(bk) * n + t0 + t) * VS + D] =
            -(b * dot + a * hh_sh[t]);
      }
    }
  }
}

// The launches of the two kernels, shared by the launchers and
// `la_bwd_plan`: f(Type<T>{}, kernel, geometry, Int<wgmma>{}) for the
// instantiation a call with these arguments runs.  Every entry in bf16 at
// D = 128 runs its chunked wgmma body (the gated entries its kGated
// instance), walking chunks of lbw::kChunk tokens, which `stage` must
// name: dq two blocks per (batch, query head), dk and dv four per (batch,
// KV head).  Otherwise the token walk, with `stage` shrunk to fit
// kMaxSmem.
// dq: one block per (batch, query head), D threads; the staging holds k, v
// and Ω̂ padded, h and the decay per token.
template <bool kGated, typename F>
cudaError_t with_launch_q(int dtype, int d, int batch, int heads, int stage,
                          F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (d == lbw::kD) {
        if (stage != lbw::kChunk) return cudaErrorInvalidValue;
        return f(t, bq::la_bwd_q_wgmma_kernel<kGated>,
                 plan::Geometry{dim3(batch * heads, bq::kSplit),
                                lbw::kThreads, bq::Layout<kGated>::kSmem,
                                lbw::kChunk},
                 plan::Int<1>{});
      }
    }
    return plan::with_head_dim(d, [&](auto dc) {
      constexpr int D = decltype(dc)::value;
      const size_t per_token =
          static_cast<size_t>(3 * Rows<D>::kPadded + 1 + (kGated ? 1 : 0)) *
          sizeof(float);
      auto kernel = la_bwd_q_kernel<T, D, kGated>;
      return f(t, kernel,
               plan::fit({dim3(batch * heads), D, 0, 0}, stage, per_token,
                         kMaxSmem),
               plan::Int<0>{});
    });
  });
}

// dk, dv: one block per (batch, KV head), the row and column roles of D
// threads each; the staging holds q and Ω̂ of the G query heads and k and v,
// padded, h of the G heads and, gated, the decay, the row warps' shares of
// k.U[:Dk, Dv] and U[Dk, Dv] per token, so large groups stage fewer tokens.
template <bool kGated, typename F>
cudaError_t with_launch_kv(int dtype, int d, int batch, int heads,
                           int kv_heads, int stage, F&& f) {
  const int group = heads / kv_heads;
  return plan::with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (d == lbw::kD) {
        if (stage != lbw::kChunk) return cudaErrorInvalidValue;
        return f(t, bkv::la_bwd_kv_wgmma_kernel<kGated>,
                 plan::Geometry{dim3(batch * kv_heads, bkv::kSplit),
                                lbw::kThreads, bkv::Layout<kGated>::kSmem,
                                lbw::kChunk},
                 plan::Int<1>{});
      }
    }
    return plan::with_head_dim(d, [&](auto dc) {
      constexpr int D = decltype(dc)::value;
      const size_t per_token =
          static_cast<size_t>((2 * group + 2) * Rows<D>::kPadded + group +
                              (kGated ? D / 32 + 2 : 0)) *
          sizeof(float);
      auto kernel = la_bwd_kv_kernel<T, D, kGated>;
      return f(t, kernel,
               plan::fit({dim3(batch * kv_heads), 2 * D, 0, 0}, stage,
                         per_token, kMaxSmem),
               plan::Int<0>{});
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int n, int stage) {
  return batch <= 0 || kv_heads <= 0 || n < 0 || stage <= 0 ||
         heads % kv_heads != 0;
}

template <bool kGated>
int run_q(const void* k, const void* v, const void* ld, const void* om,
          const void* hv, void* dq, int batch, int heads, int kv_heads,
          int n, int d, int stage, float b, int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_launch_q<kGated>(
      dtype, d, batch, heads, stage,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        if (geo.stage < 1) return cudaErrorInvalidValue;
        if constexpr (decltype(body)::value == 1) {
          CUtensorMap k_map, v_map, om_map;
          cudaError_t err = sm90::map_rows(&k_map, k, n, batch * kv_heads,
                                           lbw::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&v_map, v, n, batch * kv_heads, lbw::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows_f32(&om_map, om, n, batch * heads,
                                     lbw::kChunk);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, st, k_map, v_map, om_map,
                              static_cast<const float*>(ld),
                              static_cast<const float*>(hv),
                              static_cast<__nv_bfloat16*>(dq), heads,
                              kv_heads, n, b);
        } else {
          return plan::launch(kernel, geo, st, static_cast<const T*>(k),
                              static_cast<const T*>(v),
                              static_cast<const float*>(ld),
                              static_cast<const float*>(om),
                              static_cast<const float*>(hv),
                              static_cast<T*>(dq), heads, kv_heads, n,
                              geo.stage, b);
        }
      }));
}

template <bool kGated>
int run_kv(const void* q, const void* k, const void* v, const void* ld,
           const void* om, const void* hv, void* dk, void* dv, int batch,
           int heads, int kv_heads, int n, int d, int stage, float a, float b,
           int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_launch_kv<kGated>(
      dtype, d, batch, heads, kv_heads, stage,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        // dv's element type (DvOut): T, or f32 for the gated dV'
        using TV = std::conditional_t<kGated, float, T>;
        if (geo.stage < 1) return cudaErrorInvalidValue;
        if constexpr (decltype(body)::value == 1) {
          CUtensorMap q_map, k_map, v_map, om_map;
          cudaError_t err = sm90::map_rows(&q_map, q, n, batch * heads,
                                           lbw::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&k_map, k, n, batch * kv_heads, lbw::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&v_map, v, n, batch * kv_heads, lbw::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows_f32(&om_map, om, n, batch * heads,
                                     lbw::kChunk);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, st, q_map, k_map, v_map, om_map,
                              static_cast<const float*>(ld),
                              static_cast<const float*>(hv),
                              static_cast<__nv_bfloat16*>(dk), dv, heads,
                              kv_heads, n, a, b);
        } else {
          return plan::launch(kernel, geo, st, static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v),
                              static_cast<const float*>(ld),
                              static_cast<const float*>(om),
                              static_cast<const float*>(hv),
                              static_cast<T*>(dk), static_cast<TV*>(dv),
                              heads, kv_heads, n, geo.stage, a, b);
        }
      }));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (q, k, v, dq, dk and the linear dv; om, h, ld and the gated dV' are
// always float32).  Each returns the cudaError_t of its launch
// (0 = success); launches are asynchronous on `stream`.  Every entry in
// bf16 at D = 128 runs its wgmma body: `stage` must be the chunk (64), and
// the TMA reads need q, k, v and om 16-byte aligned (the wrappers check
// it; a map that cannot be encoded is refused with cudaErrorInvalidValue).
extern "C" int la_bwd_q(const void* k, const void* v, const void* om,
                        const void* hv, void* dq, int batch, int heads,
                        int kv_heads, int n, int d, int stage, float b,
                        int dtype, void* stream) {
  return run_q<false>(k, v, nullptr, om, hv, dq, batch, heads, kv_heads, n,
                      d, stage, b, dtype, stream);
}

extern "C" int la_bwd_kv(const void* q, const void* k, const void* v,
                         const void* om, const void* hv, void* dk, void* dv,
                         int batch, int heads, int kv_heads, int n, int d,
                         int stage, float a, float b, int dtype,
                         void* stream) {
  return run_kv<false>(q, k, v, nullptr, om, hv, dk, dv, batch, heads,
                       kv_heads, n, d, stage, a, b, dtype, stream);
}

// The gated dq: ld (B, Hkv, N) f32 is the per-token log decay.
extern "C" int gla_bwd_q(const void* k, const void* v, const void* ld,
                         const void* om, const void* hv, void* dq, int batch,
                         int heads, int kv_heads, int n, int d, int stage,
                         float b, int dtype, void* stream) {
  return run_q<true>(k, v, ld, om, hv, dq, batch, heads, kv_heads, n, d,
                     stage, b, dtype, stream);
}

// The gated dk and dV': dva (B, Hkv, N, D+1) f32.
extern "C" int gla_bwd_kv(const void* q, const void* k, const void* v,
                          const void* ld, const void* om, const void* hv,
                          void* dk, void* dva, int batch, int heads,
                          int kv_heads, int n, int d, int stage, float a,
                          float b, int dtype, void* stream) {
  return run_kv<true>(q, k, v, ld, om, hv, dk, dva, batch, heads, kv_heads,
                      n, d, stage, a, b, dtype, stream);
}

// The geometry a call of `entry` ("la_bwd_q", "la_bwd_kv", "gla_bwd_q" or
// "gla_bwd_kv") with these arguments launches, into out[7] (plan.cuh);
// nothing is launched.
extern "C" int la_bwd_plan(const char* entry, int batch, int heads,
                           int kv_heads, int n, int d, int stage, int dtype,
                           int64_t* out) {
  if (bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  auto report = [&](auto, auto kernel, const plan::Geometry& geo, auto) {
    return plan::report(kernel, geo, out);
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (strcmp(entry, "la_bwd_q") == 0)
    err = with_launch_q<false>(dtype, d, batch, heads, stage, report);
  else if (strcmp(entry, "gla_bwd_q") == 0)
    err = with_launch_q<true>(dtype, d, batch, heads, stage, report);
  else if (strcmp(entry, "la_bwd_kv") == 0)
    err = with_launch_kv<false>(dtype, d, batch, heads, kv_heads, stage,
                                report);
  else if (strcmp(entry, "gla_bwd_kv") == 0)
    err = with_launch_kv<true>(dtype, d, batch, heads, kv_heads, stage,
                               report);
  return static_cast<int>(err);
}

extern "C" const char* la_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
