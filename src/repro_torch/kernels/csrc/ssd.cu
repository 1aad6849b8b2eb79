// SSD (Mamba-2) forward and analytic backward for Hopper (sm_90a): three
// kernels with two bodies each.
//
// Replaces the TPU kernels `ssd_fwd_pallas` (src/repro/kernels/ssd.py:65;
// body `_ssd_kernel`, ssd.py:34) and `ssd_bwd_pallas` (ssd.py:192; bodies
// `_ssd_bwd_q_kernel` :118 and `_ssd_bwd_kv_kernel` :151).  For every
// (batch, head) and token, with the decay γ_t = exp(ld_t), in f32:
//
//   ssd_fwd     S_t = γ_t S_{t-1} + k_t^T v_t          (Dk, Dv)
//               o_t = q_t S_t
//   ssd_bwd_q   the same forward walk;  dq_t = S_t Ω_t   (Dk,)
//   ssd_bwd_kv  a reverse walk: U_n = γ_{n+1} U_{n+1} + q_n^T Ω_n
//               dk_n = U_n v_n (Dk,),  dv_n = U_n^T k_n (Dv,)
//
// The forward decays the state carried into t by t's own γ_t and never
// token t's own term; the reverse walk carries U_{n+1} into n with
// γ_{n+1}, the decay of the token walked just before (the weight of query
// i on key n is Π_{m=n+1..i} γ_m).  The sums include the token itself, as
// the reference's causal masks do.  Every factor is exp(ld) <= 1, so
// nothing overflows: the token walks multiply the decays token by token;
// the chunked body takes the reference's log-space cumsums within a chunk
// of 64 and exponentiates only differences <= 0.  No normalizer, no a/b: unlike la_fwd.cu this is the
// reference's plain SSD recurrence.
//
// Grouping (the reference's `hi // group` index maps): q and k are
// (B, G, N, Dk), shared by the H/G heads of a group (Mamba-2's C and B,
// G = 1 at full width); v, Ω, o and dv are (B, H, N, Dv), ld is (B, H, N).
// dq and dk are written as PER-HEAD partials (B, H, N, Dk) in f32, as the
// Pallas kernels write them (ssd.py:236, :268); the caller sums them over
// the group with one reduction, in a fixed order, so the result is
// deterministic (no float atomics).  dv comes back in f32 for the
// caller's dld epilogue (dcl = Ω.o - v.dv, then a reverse cumsum).
//
// Shapes (all contiguous): q, k in the compute type T (float or bf16);
// v and Ω in T; ld f32; o in T; dq, dk partials and dv in f32.
// (Dk, Dv) are template parameters, instantiated for (128, 64)
// (mamba2-2.7b: state 128, head dim 64), (64, 64) (zamba2-7b's Mamba-2
// layers: state 64, head dim 64) and (16, 32) (the smoke configs); any
// other pair is refused.
//
// Two bodies of each kernel, chosen by the launcher from the dtype and
// dims: the chunked wgmma bodies for bf16 at (128, 64) (mamba2-2.7b's
// training instance) and, for ssd_fwd, at (64, 64) too (zamba2-7b's
// Mamba-2 layers; its body templated on Dk); the token walk for f32 at
// every pair and bf16 at (16, 32), and for the backward's two kernels bf16
// at (64, 64).
//
// What bounds them (estimates from the shapes; B=2, G=1, H=80, N=8192,
// Dk=128, Dv=64): every kernel moves its bytes once, ssd_fwd ~0.35 GB
// (0.104 ms at 3.35 TB/s).  The token walk does 5 Dk Dv f32 flops per
// token and head in ssd_fwd (the decayed update and the readout), 53.7
// GFLOP, 0.80 ms at 67 TFLOP/s; ssd_bwd_q the same flops, but it writes
// 671 MB of f32 partials (0.26 ms); ssd_bwd_kv updates U once and reads
// it twice, 7 Dk Dv flops, 75.2 GFLOP, 1.12 ms: bound by f32 operations
// on the CUDA cores.  The chunked ssd_fwd body does four products per
// chunk of c = 64 tokens (q k^T, q S, A v and the state update: 2 c Dk
// (c + Dv) + 2 c Dv (c + Dk) flops), 75.2 GFLOP on the bf16 tensor cores,
// 0.076 ms at 989 TFLOP/s: bound by its bytes (0.104 ms).  The chunked
// ssd_bwd_q body does four products per chunk, three of them twice (a hi
// and a lo operand), 139.6 GFLOP (0.141 ms): bound by its bytes, 1.02 GB
// (0.303 ms), two thirds of them the f32 dq partials.  The chunked
// ssd_bwd_kv body does seven products per chunk, five of them twice (a hi
// and a lo operand), 225.5 GFLOP on the tensor cores (0.228 ms): bound by
// its bytes, 1.36 GB (0.405 ms), half of them the f32 dk partials.  At
// zamba2-7b's (64, 64) (B=2, G=1, H=112, N=8192) ssd_fwd moves 0.48 GB
// (0.144 ms); its body's seven products per chunk (q k^T once; q S, A v
// and the state update each with a hi + lo operand) are 105.2 GFLOP
// (0.106 ms): bound by its bytes.
//
// Design of the chunked body (namespace sc, the reference's chunked form,
// src/repro/kernels/ssd.py:34-62): one warpgroup per (batch, head), 160
// blocks of 108,544 B of shared memory, two to an SM, one wave on 132 SMs
// (at (64, 64): 224 blocks at zamba2-7b's B=2, H=112, 83,968 B, two an
// SM, one wave; S^T an m64n64 accumulator, q and k one box a row, and A,
// w v and S's copy as hi + lo pairs, below).
//   * thread 0 loads each chunk's q, k (64 x Dk) and v (64 x 64) by TMA
//     into a 2-stage ring (sm90.cuh: 128-byte-swizzled boxes; rows past N
//     arrive as zeros, so a ragged last chunk needs no padding in device
//     memory); at G = 1 every head of a batch reads the same q and k,
//     which stay in L2.  Chunk c + 1 is requested when chunk c starts;
//   * per chunk: q k^T and q S (S from the bf16 copy of S^T, a K-major B)
//     by `wgmma` from shared memory; behind them the log decays' inclusive
//     cumsum cl as a warp scan (every warp holds all 64), and the tile
//     (w v) with w_n = exp(cl_last - cl_n) <= 1; then the decay matrix
//     A = (q k^T) o exp(cl_i - cl_j) (j <= i, else 0; exponent <= 0, so
//     nothing overflows) in registers, rounded to bf16 as the register A
//     of A v; o = exp(cl_i) q S + A v (v read MN-major); S^T =
//     exp(cl_last) S^T + (w v)^T k (both MN-major, no transpose copy);
//   * the state stays an f32 accumulator in registers (S^T, 64 x Dk: 64
//     registers a thread at Dk = 128, 32 at 64) for the whole walk; only
//     operands are rounded to bf16 (A, w v and the readout's copy of S),
//     as the flash kernels round P; at (64, 64) each as a hi + lo pair,
//     two products into one accumulator (~2^-17 relative), so that o
//     keeps f32's bits to its final rounding: zamba2's step-0 train
//     comparison reads o through the decays' cancelling grads;
//   * o of a chunk is stored from registers while the state update runs;
//     each o is written once (no atomics): the result is bit-deterministic.
// Design of the chunked ssd_bwd_kv body (namespace sk, the reference's
// chunked form, src/repro/kernels/ssd.py:151-189): one warpgroup per
// (batch, head) walks its chunks from the last, 160 blocks of 108,544 B,
// two to an SM, one wave on 132 SMs.
//   * the state U is held as U^T (Dv x Dk), an m64n128 f32 accumulator
//     (64 registers a thread), as sc holds S^T; its readouts read a bf16
//     copy of U^T from shared memory, MN-major for e v U^T (dk) and
//     K-major for e k U (dv): one layout serves both;
//   * precision: chip_smoke.py holds the f32 dk partials and dv to 1e-4
//     of their largest |value|, which the f32 walk meets and one bf16
//     rounding of an operand (2^-9) would not.  So every operand that is
//     not a bf16 input -- p o M, s o M, exp(cl) o Ω and the copy of U^T --
//     goes as a pair hi = bf16(x), lo = bf16(x - hi) (sm90.cuh), two
//     products into one f32 accumulator: ~2^-17 relative.  p = v Ω^T and
//     s = k q^T are products of inputs, exact before the f32 sums;
//   * shared memory, for two blocks an SM: both copies of U^T (32 KB),
//     q and Ω in a ring of two chunks (their last reads end a chunk), k
//     and v once: their last reads (p, s and the readouts of U) end
//     half-way through a chunk, where the next chunk's k and v are
//     requested by TMA;
//   * per chunk: p and e v U^T (SS), then (p o M) q (RS, hi and lo), dk
//     stored from registers (a quad's 8-byte stores fill 32-byte
//     sectors); s and e k U (SS), then (s o M) Ω (RS) and behind it the
//     state update (exp(cl) o Ω)^T q, its A read from Ω's tile by
//     ldmatrix.trans and scaled per token in registers (RS); dv stored,
//     then the new hi and lo copies of U^T by stmatrix.  Exponents are
//     differences <= 0 of the chunk's cumsum, masked first, as in sc;
//   * each dk and dv element is written once (no atomics): the result is
//     bit-deterministic.
// Design of the chunked ssd_bwd_q body (namespace sq, the reference's
// `_ssd_bwd_q_kernel`, src/repro/kernels/ssd.py:118-147): sc's forward
// walk with the readout dq = S Ω in place of o = q S.  One warpgroup per
// (batch, head), 160 blocks of 100,352 B, two to an SM, one wave on 132
// SMs.
//   * the state and its update are sc's: S^T (Dv x Dk) as one m64n128 f32
//     accumulator, S^T = 2^total S^T + (w o v)^T k; k comes through the
//     group's map (at G = 1 every head reads one k, which stays in L2), v,
//     Ω and the log decays per head;
//   * per chunk: p = Ω v^T (both bf16 inputs: exact in f32) and Ω S (S
//     from S^T's copies read MN-major) by SS wgmma; behind them cl and the
//     (w o v) tiles; W = p o 2^(cl_i - cl_n) (n <= i) in registers; dq =
//     2^cl_i (Ω S) + W k (RS, k MN-major from its TMA tile); dq, 64 x 128
//     f32, stored from registers (a quad's 8-byte stores fill 32-byte
//     sectors) while the state update runs;
//   * precision: chip_smoke.py holds the f32 dq partials to 1e-4 of their
//     largest |value|, so W, the copy of S^T and w o v each go as a hi +
//     lo pair of bf16, two products into one accumulator, as in sk;
//   * shared memory: both copies of S^T (32 KB), k in a ring of two
//     chunks (its last reads end a chunk), v and Ω once (their last reads,
//     p, Ω S and the (w o v) tiles, end half-way through a chunk, where
//     the next chunk's v and Ω are requested by TMA), the hi and lo
//     (w o v) tiles (16 KB);
//   * each dq element is written once (no atomics): the result is
//     bit-deterministic.
// The three chunked bodies share their decay bookkeeping with la_fwd.cu's
// and la_bwd.cu's gated bodies (decay.cuh, namespace cd): the warp-scan
// cumsum of a chunk's log decays, its gathers by token and by fragment
// column, the masked decay of a score fragment, the (w o v) tile of the
// forward state update and the decayed A of the reverse one.
// Design of the token walk (simple first):
//   * one block per (batch, head), walking the whole sequence: a (B, H)
//     grid, 160 blocks at B=2, H=80 on 132 SMs, small enough that two
//     fit on one SM, so the grid runs in one wave;
//   * the state lives in registers, tiled over the threads two ways.
//     Column tiles (ssd_fwd; ssd_bwd_kv's dv role): a thread owns 4
//     adjacent columns and R = Dk / kColGroups rows; the row groups of a
//     column group are adjacent lanes, so o = q S and dv = U^T k end in
//     log2(kColGroups) shuffles per column.  Row tiles (ssd_bwd_q;
//     ssd_bwd_kv's dk role): a thread owns 4 adjacent rows and
//     C = Dv / kRowGroups columns, so dq = S Ω and dk = U v end in
//     log2(kRowGroups) shuffles per row.  At (128, 64) a tile is 64
//     floats, 128 threads per role; at (64, 64) 32 floats (8 column and
//     8 row groups), 128 threads per role;
//   * ssd_bwd_kv reads U by rows (dk) and by columns (dv), so the block
//     keeps it twice: 128 threads in row tiles, 128 in column tiles, each
//     taking the same rank-1 update.  That doubles the update's flops but
//     needs no reduction across warps per token;
//   * per iteration the block stages `stage` tokens of the inputs in
//     shared memory as f32 (bf16 values are exact in f32) by 16-byte
//     loads, with 4 floats of padding after each tile-wide slice of a row
//     so that the lanes of a warp read disjoint banks, and each token's
//     decay exp(ld) (one expf per token, not per thread); the outputs of
//     the staged tokens land in shared memory and are written out
//     together.  The reverse walk stages from the end of the sequence
//     backwards.  The tail iteration is bounded by N; nothing is padded
//     in device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <string.h>

#include <type_traits>

#include "decay.cuh"
#include "plan.cuh"
#include "sm90.cuh"

// ---------------------------------------------------------------------------
// the chunked wgmma body of ssd_fwd (bf16, Dk = 128 or 64, Dv = 64)
// ---------------------------------------------------------------------------

namespace sc {

using bf16 = __nv_bfloat16;

constexpr int kDv = 64;
constexpr int kChunk = 64;     // tokens of a chunk: the M of wgmma
constexpr int kStages = 2;     // chunks of q, k and v in the TMA ring
constexpr int kThreads = 128;  // one warpgroup
// dynamic shared memory beside the tiles: the barriers, and up to 1024
// bytes of padding to the tiles' 1024-byte alignment
constexpr size_t kExtra = 2048;

// Whether the body takes (Dk, Dv): mamba2-2.7b's (128, 64) and zamba2-7b's
// Mamba-2 layers' (64, 64).
constexpr bool takes(int dk, int dv) {
  return dv == kDv && (dk == 128 || dk == 64);
}

// At state width kDk (128 or 64): q and k are kDk / 64 boxes a row.  The
// ring, the (w v) tile and the bf16 copy of S^T (Dv x kDk), each twice
// (hi, lo) with kPairs, barriers and pad: 108,544 B at (128, single), so
// that two blocks share an SM; 83,968 B at (64, pairs), two.
template <int kDk, bool kPairs>
struct Layout {
  static constexpr size_t kQKBytes = static_cast<size_t>(kChunk) * kDk * 2;
  static constexpr size_t kVBytes = static_cast<size_t>(kChunk) * kDv * 2;
  static constexpr size_t kStageBytes = 2 * kQKBytes + kVBytes;  // q, k, v
  static constexpr size_t kSBytes = static_cast<size_t>(kDv) * kDk * 2;
  static constexpr size_t kCopies = kPairs ? 2 : 1;
  static constexpr size_t kWv = kStages * kStageBytes;
  static constexpr size_t kS = kWv + kCopies * kVBytes;
  static constexpr size_t kBars = kS + kCopies * kSBytes;
  static constexpr size_t kSmem = kBars + kExtra;
};

constexpr float kLog2e = 1.4426950408889634f;

// One block (one warpgroup) per (batch, head) walks its head's chunks in
// order.  Per chunk of c = 64 tokens, with cl the inclusive cumsum of the
// chunk's log decays (kept in base 2) and S the state carried in (S^T
// held as the f32 accumulator st, Dv x Dk):
//   sc  = q k^T                                   (wgmma, SS)
//   acc = q S = q (S^T)^T, from S^T's bf16 copy    (wgmma, SS)
//   A   = sc o exp(cl_i - cl_j) for j <= i, else 0; bf16 in registers
//   o   = exp(cl_i) acc + A v                      (wgmma, RS; v MN-major)
//   S^T = exp(cl_last) S^T + (w o v)^T k, w_n = exp(cl_last - cl_n) <= 1
//                                                  (wgmma, SS; both MN-major)
// The bf16 copy of the new S^T goes back to shared memory for the next
// chunk's readout; o goes as bf16 into the chunk's q tile (64 x Dv fits it
// at either kDk), which the next chunk stores by TMA.  At kDk = 64 S^T is
// an m64n64 accumulator (32 registers a thread) and every product's K over
// Dk takes 4 steps of 16 where it took 8; each expression of kDk folds to
// the kDk = 128 body's.  kPairs (zamba2-7b's (64, 64)): A, the readout's
// copy of S^T and the (w v) tile go as hi + lo pairs of bf16 (sm90.cuh),
// two products each where one rounding was, as la_fwd.cu's gated body
// sends its operands: o then keeps ~16 bits before its own rounding, which
// a step-0 train comparison reads through cancelling grads (the decays'
// a_log and dt_bias of a 3-block zamba2 moved 1.9x its limit with single
// roundings; mamba2-2.7b's 64 layers hold (128, 64)'s within 0.87).
template <int kDk, bool kPairs>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap o_map,
                         const float* __restrict__ ld, int heads,
                         int per_group, int n) {
  using L = Layout<kDk, kPairs>;
  constexpr size_t kQKBytes = L::kQKBytes, kVBytes = L::kVBytes;
  constexpr size_t kStageBytes = L::kStageBytes, kSBytes = L::kSBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* wv_sh = smem + L::kWv;  // (kPairs: then its lo tile)
  unsigned char* s_sh = smem + L::kS;    // (kPairs: then its lo copy)
  [[maybe_unused]] unsigned char* wv_lo = wv_sh + kVBytes;
  [[maybe_unused]] unsigned char* s_lo = s_sh + kSBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);

  const int bh = blockIdx.x;  // batch * heads + head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int qk_slice = bi * (heads / per_group) + hi / per_group;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  auto stage_of = [&](int c) { return smem + (c % kStages) * kStageBytes; };
  // q, k and v of chunk c into its stage (q, k: box b = columns
  // 64 b .. 64 b + 63); rows past n arrive as zeros
  auto load_chunk = [&](int c) {
    unsigned char* st = stage_of(c);
    uint64_t* bar = &full[c % kStages];
    sm90::bar_expect(bar, kStageBytes);
#pragma unroll
    for (int b = 0; b < kDk / 64; ++b) {
      sm90::tma_load_3d(st + b * kQKBytes / (kDk / 64), &q_map, bar, 64 * b,
                        c * kChunk, qk_slice);
      sm90::tma_load_3d(st + kQKBytes + b * kQKBytes / (kDk / 64), &k_map,
                        bar, 64 * b, c * kChunk, qk_slice);
    }
    sm90::tma_load_3d(st + 2 * kQKBytes, &v_map, bar, 0, c * kChunk, bh);
  };
  // o of chunk c, staged in its q tile, to device memory (rows past n
  // are not written)
  auto store_o = [&](int c) {
    sm90::tma_store_3d(&o_map, stage_of(c), 0, c * kChunk, bh);
    sm90::bulk_commit();
  };
  // lane l's two log decays of chunk c in base 2 (tokens 2l, 2l + 1; 0
  // past n)
  const float* ld_row = ld + static_cast<size_t>(bh) * n;
  auto load_ld = [&](int c, float (&x)[2]) {
    const int t = c * kChunk + 2 * lane;
    x[0] = t < n ? ld_row[t] * kLog2e : 0.f;
    x[1] = t + 1 < n ? ld_row[t + 1] * kLog2e : 0.f;
  };

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::bar_init(&full[s], 1);
    sm90::bar_init_fence();
  }
  // S_0 = 0: its bf16 copy (copies) too
  for (int i = tid; i < static_cast<int>(L::kCopies * kSBytes / 16);
       i += kThreads)
    reinterpret_cast<uint4*>(s_sh)[i] = make_uint4(0, 0, 0, 0);
  sm90::fence_async_smem();
  __syncthreads();
  if (tid == 0) load_chunk(0);

  float st[kDk / 2];  // S^T: rows (Dv) 16 warp + g (+ 8), columns (Dk)
                     // 8 a + 2 tq
#pragma unroll
  for (int i = 0; i < kDk / 2; ++i) st[i] = 0.f;
  float ld_cur[2];
  load_ld(0, ld_cur);
  const int row0 = 16 * warp + g;  // this thread's rows of a chunk: +0, +8

  for (int c = 0; c < chunks; ++c) {
    // every thread is done with chunk c - 1: its o is staged, the bf16
    // copy of S^T it wrote is complete, and its k, v and (w v) are free
    __syncthreads();
    if (tid == 0 && c > 0) store_o(c - 1);
    __syncwarp();
    float ld_next[2] = {0.f, 0.f};
    if (c + 1 < chunks) load_ld(c + 1, ld_next);
    sm90::bar_wait(&full[c % kStages], (c / kStages) & 1);
    __syncwarp();  // the products below are warp-aligned
    const unsigned char* stage = stage_of(c);
    const bf16* q_t = reinterpret_cast<const bf16*>(stage);
    const bf16* k_t = reinterpret_cast<const bf16*>(stage + kQKBytes);
    const bf16* v_t = reinterpret_cast<const bf16*>(stage + 2 * kQKBytes);
    const bf16* s_t = reinterpret_cast<const bf16*>(s_sh);

    float sc[32], acc[32];
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk)
      sm90::mma_ss_n64(sc, sm90::desc_k<kChunk>(q_t, kk),
                       sm90::desc_k<kChunk>(k_t, kk), kk);
    sm90::mma_commit();
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk)
      sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(q_t, kk),
                       sm90::desc_k<kDv>(s_t, kk), kk);
    if constexpr (kPairs) {
#pragma unroll
      for (int kk = 0; kk < kDk / 16; ++kk)
        sm90::mma_ss_n64(
            acc, sm90::desc_k<kChunk>(q_t, kk),
            sm90::desc_k<kDv>(reinterpret_cast<const bf16*>(s_lo), kk), 1);
    }
    sm90::mma_commit();

    // behind the products: cl, the inclusive cumsum of the chunk's log
    // decays (cd::scan), and the (w v) tile of the state update
    const cd::Cumsum cl = cd::scan(ld_cur, lane);
    cd::weighted_v<kPairs, kThreads>(cl, stage + 2 * kQKBytes, wv_sh,
                                     kPairs ? wv_lo : nullptr, tid);
    float cl_col[16];  // cl of this thread's key columns
    cl.cols(tq, cl_col);
    const float cl_row[2] = {cl.at(row0), cl.at(row0 + 8)};
    if (tid == 0 && c + 1 < chunks) {
      // chunk c + 1 into the stage of chunk c - 1, once the store of
      // that chunk's o has read it
      sm90::bulk_wait<0, true>();
      load_chunk(c + 1);
    }
    __syncwarp();
    sm90::mma_wait<0>();  // q k^T and q S
    sm90::pin(sc);
    sm90::pin(acc);
    sm90::fence_async_smem();
    // the (w v) tile is whole, and no product reads S^T's copy or q any
    // more
    __syncthreads();

    uint32_t pa[kChunk / 16][4];
    [[maybe_unused]] uint32_t pl[kChunk / 16][4];
    cd::decay_mask<true>(sc, cl_row, cl_col, warp, tq, row0);
    if constexpr (kPairs)
      sm90::to_a_split<kChunk / 16>(pa, pl, sc);
    else
      sm90::to_a<kChunk / 16>(pa, sc);
    const float e_row[2] = {sm90::exp2_ftz(cl_row[0]),
                            sm90::exp2_ftz(cl_row[1])};
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= e_row[(i >> 1) & 1];
    const float e_total = sm90::exp2_ftz(cl.total);
#pragma unroll
    for (int i = 0; i < kDk / 2; ++i) st[i] *= e_total;
    sm90::pin(acc);
    sm90::pin(st);
    sm90::pin(pa);
    if constexpr (kPairs) sm90::pin(pl);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n64(acc, pa[kk], sm90::desc_mn<kChunk>(v_t, kk), 1);
    if constexpr (kPairs) {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n64(acc, pl[kk], sm90::desc_mn<kChunk>(v_t, kk), 1);
    }
    sm90::mma_commit();
#pragma unroll
    for (int x = 0; x < static_cast<int>(L::kCopies); ++x)
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_ss<1, 1>(
            st,
            sm90::desc_mn<kChunk>(
                reinterpret_cast<const bf16*>(x ? wv_lo : wv_sh), kk),
            sm90::desc_mn<kChunk>(k_t, kk), 1);
    sm90::mma_commit();

    sm90::mma_wait<1>();  // o, while the state update runs
    sm90::pin(acc);
    sm90::pin(pa);
    if constexpr (kPairs) sm90::pin(pl);
    sm90::store_tile<kDv / 8>(smem + (c % kStages) * kStageBytes, acc);
    sm90::mma_wait<0>();
    sm90::pin(st);
    // the bf16 copy (copies) of S^T, the K-major B of the next readout
    if constexpr (kPairs)
      sm90::store_tile_split<kDk / 8>(s_sh, s_lo, st);
    else
      sm90::store_tile<kDk / 8>(s_sh, st);
    sm90::fence_async_smem();
    ld_cur[0] = ld_next[0];
    ld_cur[1] = ld_next[1];
  }
  __syncthreads();
  if (tid == 0) {
    store_o(chunks - 1);
    sm90::bulk_wait<0, false>();
  }
}

}  // namespace sc

// ---------------------------------------------------------------------------
// the chunked wgmma body of ssd_bwd_kv (bf16, Dk = 128, Dv = 64)
// ---------------------------------------------------------------------------

namespace sk {

using bf16 = __nv_bfloat16;

constexpr int kDk = 128;
constexpr int kDv = 64;
constexpr int kChunk = 64;     // tokens of a chunk: the M of wgmma
constexpr int kThreads = 128;  // one warpgroup
constexpr size_t kQKBytes = static_cast<size_t>(kChunk) * kDk * 2;
constexpr size_t kVBytes = static_cast<size_t>(kChunk) * kDv * 2;
constexpr size_t kUBytes = static_cast<size_t>(kDv) * kDk * 2;  // U^T, bf16
// tile offsets (each 1024-byte aligned): the hi and lo copies of U^T; q
// and Ω in rings of two chunks (their last reads end a chunk); k and v
// once (their last reads are half-way through a chunk, and the next
// chunk's load starts there)
constexpr size_t kUHi = 0;
constexpr size_t kULo = kUHi + kUBytes;
constexpr size_t kQ = kULo + kUBytes;
constexpr size_t kOm = kQ + 2 * kQKBytes;
constexpr size_t kK = kOm + 2 * kVBytes;
constexpr size_t kV = kK + kQKBytes;
constexpr size_t kBars = kV + kVBytes;
// beside the tiles: the barriers, and up to 1024 bytes of padding to the
// tiles' 1024-byte alignment
constexpr size_t kExtra = 2048;
// 108,544 B, so that two blocks share an SM
constexpr size_t kSmem = kBars + kExtra;

constexpr float kLog2e = 1.4426950408889634f;

// One block (one warpgroup) per (batch, head) walks its head's chunks from
// the last to the first.  Per chunk of c = 64 tokens, with cl the
// inclusive cumsum of its log decays (base 2), `total` its last, and U
// (U^T held as the f32 accumulator ut, Dv x Dk) carried in from the later
// chunks:
//   p   = v Ω^T, s = k q^T                        (wgmma, SS; exact products)
//   M   = exp(cl_i - cl_n) for i >= n, else 0;  e_n = exp(total - cl_n)
//   dk  = e_n (v U^T) + (p o M) q                 (SS from U^T's copies; RS)
//   dv  = e_n (k U) + (s o M) Ω                   (SS from U^T's copies; RS)
//   U^T = exp(total) U^T + (exp(cl) o Ω)^T q      (RS: A by ldmatrix.trans)
// Every operand that is not a bf16 input (p o M, s o M, exp(cl) o Ω and
// U^T's copy) goes as a hi + lo pair of bf16 (sm90::pack_bf16_split), two
// products into one f32 accumulator: ~2^-17 relative, where one bf16
// rounding (2^-9) would miss the f32 walk's 1e-4.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_kv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap om_map,
                            const float* __restrict__ ld,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int heads, int per_group, int n) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* u_hi = smem + kUHi;
  unsigned char* u_lo = smem + kULo;
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(smem + kBars);  // [2]
  uint64_t* kv_full = qo_full + 2;

  const int bh = blockIdx.x;  // batch * heads + head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int qk_slice = bi * (heads / per_group) + hi / per_group;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  // iteration j walks chunk chunks - 1 - j; rows past n arrive as zeros
  auto q_tile = [&](int j) { return smem + kQ + (j % 2) * kQKBytes; };
  auto om_tile = [&](int j) { return smem + kOm + (j % 2) * kVBytes; };
  auto load_qo = [&](int j) {
    const int c = chunks - 1 - j;
    uint64_t* bar = &qo_full[j % 2];
    sm90::bar_expect(bar, kQKBytes + kVBytes);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      sm90::tma_load_3d(q_tile(j) + b * kQKBytes / 2, &q_map, bar, 64 * b,
                        c * kChunk, qk_slice);
    sm90::tma_load_3d(om_tile(j), &om_map, bar, 0, c * kChunk, bh);
  };
  auto load_kv = [&](int j) {
    const int c = chunks - 1 - j;
    sm90::bar_expect(kv_full, kQKBytes + kVBytes);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      sm90::tma_load_3d(smem + kK + b * kQKBytes / 2, &k_map, kv_full,
                        64 * b, c * kChunk, qk_slice);
    sm90::tma_load_3d(smem + kV, &v_map, kv_full, 0, c * kChunk, bh);
  };
  // lane l's two log decays of chunk c in base 2 (tokens 2l, 2l + 1; 0
  // past n)
  const float* ld_row = ld + static_cast<size_t>(bh) * n;
  auto load_ld = [&](int c, float (&x)[2]) {
    const int t = c * kChunk + 2 * lane;
    x[0] = t < n ? ld_row[t] * kLog2e : 0.f;
    x[1] = t + 1 < n ? ld_row[t + 1] * kLog2e : 0.f;
  };
  float* dk_head = dk + static_cast<size_t>(bh) * n * kDk;
  float* dv_head = dv + static_cast<size_t>(bh) * n * kDv;

  if (tid == 0) {
    sm90::bar_init(&qo_full[0], 1);
    sm90::bar_init(&qo_full[1], 1);
    sm90::bar_init(kv_full, 1);
    sm90::bar_init_fence();
  }
  // U = 0 past the last chunk: both of its copies too
  for (int i = tid; i < static_cast<int>(2 * kUBytes / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem + kUHi)[i] = make_uint4(0, 0, 0, 0);
  sm90::fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    load_qo(0);
    load_kv(0);
  }

  float ut[64];  // U^T: rows (Dv) 16 warp + g (+ 8), columns (Dk) 8 a + 2 tq
#pragma unroll
  for (int i = 0; i < 64; ++i) ut[i] = 0.f;
  float ld_cur[2];
  load_ld(chunks - 1, ld_cur);
  const int row0 = 16 * warp + g;  // this thread's rows of a chunk: +0, +8

  for (int j = 0; j < chunks; ++j) {
    const int c = chunks - 1 - j;
    const int t0 = c * kChunk;
    // every thread is done with iteration j - 1: its q and Ω stage is
    // free and both copies of U^T are whole
    __syncthreads();
    if (tid == 0 && j + 1 < chunks) load_qo(j + 1);
    __syncwarp();
    float ld_next[2] = {0.f, 0.f};
    if (c > 0) load_ld(c - 1, ld_next);
    sm90::bar_wait(&qo_full[j % 2], (j / 2) & 1);
    sm90::bar_wait(kv_full, j & 1);
    __syncwarp();  // the products below are warp-aligned
    const bf16* q_t = reinterpret_cast<const bf16*>(q_tile(j));
    const unsigned char* om_raw = om_tile(j);
    const bf16* om_t = reinterpret_cast<const bf16*>(om_raw);
    const bf16* k_t = reinterpret_cast<const bf16*>(smem + kK);
    const bf16* v_t = reinterpret_cast<const bf16*>(smem + kV);
    const bf16* uh_t = reinterpret_cast<const bf16*>(u_hi);
    const bf16* ul_t = reinterpret_cast<const bf16*>(u_lo);

    // ---- dk: p = v Ω^T; e_n v U^T from both copies
    float p[32], dka[64];
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kDv / 16; ++kk)
      sm90::mma_ss_n64(p, sm90::desc_k<kChunk>(v_t, kk),
                       sm90::desc_k<kChunk>(om_t, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kDv / 16; ++kk)
      sm90::mma_ss_n128<0, 1>(dka, sm90::desc_k<kChunk>(v_t, kk),
                              sm90::desc_mn<kDv>(uh_t, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kDv / 16; ++kk)
      sm90::mma_ss_n128<0, 1>(dka, sm90::desc_k<kChunk>(v_t, kk),
                              sm90::desc_mn<kDv>(ul_t, kk), 1);
    sm90::mma_commit();

    // behind the products: cl (cd::scan)
    const cd::Cumsum cl = cd::scan(ld_cur, lane);
    float cl_col[16];  // cl of this thread's columns
    cl.cols(tq, cl_col);
    const float cl_row[2] = {cl.at(row0), cl.at(row0 + 8)};
    const float e_row[2] = {sm90::exp2_ftz(cl.total - cl_row[0]),
                            sm90::exp2_ftz(cl.total - cl_row[1])};

    sm90::mma_wait<0>();
    sm90::pin(p);
    sm90::pin(dka);
    uint32_t ah[kChunk / 16][4], al[kChunk / 16][4];
    cd::decay_mask<false>(p, cl_row, cl_col, warp, tq, row0);
    sm90::to_a_split<kChunk / 16>(ah, al, p);
#pragma unroll
    for (int i = 0; i < 64; ++i) dka[i] *= e_row[(i >> 1) & 1];
    sm90::pin(dka);
    sm90::pin(ah);
    sm90::pin(al);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n128(dka, ah[kk], sm90::desc_mn<kChunk>(q_t, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n128(dka, al[kk], sm90::desc_mn<kChunk>(q_t, kk), 1);
    sm90::mma_commit();
    sm90::mma_wait<0>();
    sm90::pin(dka);
    sm90::pin(ah);
    sm90::pin(al);
    // dk rows from registers: a quad's 8-byte stores fill 32-byte sectors
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + row0 + 8 * r;
      if (row < n) {
        float* out = dk_head + static_cast<size_t>(row) * kDk + 2 * tq;
#pragma unroll
        for (int a = 0; a < kDk / 8; ++a)
          *reinterpret_cast<float2*>(out + 8 * a) =
              make_float2(dka[4 * a + 2 * r], dka[4 * a + 2 * r + 1]);
      }
    }

    // ---- dv: s = k q^T; e_n k U from both copies
    float s[32], dva[32];
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk)
      sm90::mma_ss_n64(s, sm90::desc_k<kChunk>(k_t, kk),
                       sm90::desc_k<kChunk>(q_t, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk)
      sm90::mma_ss_n64(dva, sm90::desc_k<kChunk>(k_t, kk),
                       sm90::desc_k<kDv>(uh_t, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kDk / 16; ++kk)
      sm90::mma_ss_n64(dva, sm90::desc_k<kChunk>(k_t, kk),
                       sm90::desc_k<kDv>(ul_t, kk), 1);
    sm90::mma_commit();
    sm90::mma_wait<0>();
    sm90::pin(s);
    sm90::pin(dva);
    // every warp is done with k, v and both copies of U^T: the next
    // chunk's k and v load behind the rest of this one
    __syncthreads();
    if (tid == 0 && j + 1 < chunks) load_kv(j + 1);
    __syncwarp();
    cd::decay_mask<false>(s, cl_row, cl_col, warp, tq, row0);
    sm90::to_a_split<kChunk / 16>(ah, al, s);
#pragma unroll
    for (int i = 0; i < 32; ++i) dva[i] *= e_row[(i >> 1) & 1];
    // (exp(cl) o Ω)^T, the A of the state update: Ω's tile read transposed
    // (lane l: row 16 kk + 8 (m / 2) + l % 8 of the tile, columns
    // 8 (2 warp + m % 2).. of matrix m = l / 8), scaled per token
    uint32_t oh[kChunk / 16][4], ol[kChunk / 16][4];
    cd::weighted_a_trans(om_raw, cl_col, warp, lane, oh, ol);
    const float e_total = sm90::exp2_ftz(cl.total);
#pragma unroll
    for (int i = 0; i < 64; ++i) ut[i] *= e_total;
    sm90::pin(dva);
    sm90::pin(ut);
    sm90::pin(ah);
    sm90::pin(al);
    sm90::pin(oh);
    sm90::pin(ol);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n64(dva, ah[kk], sm90::desc_mn<kChunk>(om_t, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n64(dva, al[kk], sm90::desc_mn<kChunk>(om_t, kk), 1);
    sm90::mma_commit();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n128(ut, oh[kk], sm90::desc_mn<kChunk>(q_t, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n128(ut, ol[kk], sm90::desc_mn<kChunk>(q_t, kk), 1);
    sm90::mma_commit();
    sm90::mma_wait<1>();  // dv, while the state update runs
    sm90::pin(dva);
    sm90::pin(ah);
    sm90::pin(al);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + row0 + 8 * r;
      if (row < n) {
        float* out = dv_head + static_cast<size_t>(row) * kDv + 2 * tq;
#pragma unroll
        for (int a = 0; a < kDv / 8; ++a)
          *reinterpret_cast<float2*>(out + 8 * a) =
              make_float2(dva[4 * a + 2 * r], dva[4 * a + 2 * r + 1]);
      }
    }
    sm90::mma_wait<0>();
    sm90::pin(ut);
    sm90::pin(oh);
    sm90::pin(ol);
    // the copies of the new U^T, the B of the next chunk's readouts; the
    // fence also orders this chunk's ldmatrix reads of Ω before the TMA
    // load that reuses its stage
    sm90::store_tile_split<kDk / 8>(u_hi, u_lo, ut);
    sm90::fence_async_smem();
    ld_cur[0] = ld_next[0];
    ld_cur[1] = ld_next[1];
  }
}

}  // namespace sk

// ---------------------------------------------------------------------------
// the chunked wgmma body of ssd_bwd_q (bf16, Dk = 128, Dv = 64)
// ---------------------------------------------------------------------------

namespace sq {

using bf16 = __nv_bfloat16;

constexpr int kDk = 128;
constexpr int kDv = 64;
constexpr int kChunk = 64;     // tokens of a chunk: the M of wgmma
constexpr int kKStages = 2;    // chunks of k in the TMA ring
constexpr int kThreads = 128;  // one warpgroup
constexpr size_t kKBytes = static_cast<size_t>(kChunk) * kDk * 2;
constexpr size_t kVBytes = static_cast<size_t>(kChunk) * kDv * 2;  // v or Ω
constexpr size_t kSBytes = static_cast<size_t>(kDv) * kDk * 2;  // S^T, bf16
// tile offsets (each 1024-byte aligned): the hi and lo copies of S^T; k
// in a ring of two chunks (its last reads end a chunk); v and Ω once
// (their last reads are half-way through a chunk, and the next chunk's
// load starts there); the hi and lo (w v) tiles
constexpr size_t kSHi = 0;
constexpr size_t kSLo = kSHi + kSBytes;
constexpr size_t kK = kSLo + kSBytes;
constexpr size_t kV = kK + kKStages * kKBytes;
constexpr size_t kOm = kV + kVBytes;
constexpr size_t kWvHi = kOm + kVBytes;
constexpr size_t kWvLo = kWvHi + kVBytes;
constexpr size_t kBars = kWvLo + kVBytes;
// beside the tiles: the barriers, and up to 1024 bytes of padding to the
// tiles' 1024-byte alignment
constexpr size_t kExtra = 2048;
// 100,352 B, so that two blocks share an SM
constexpr size_t kSmem = kBars + kExtra;

constexpr float kLog2e = 1.4426950408889634f;

// One block (one warpgroup) per (batch, head) walks its head's chunks in
// order, carrying sc's state S (S^T held as the f32 accumulator st, Dv x
// Dk).  Per chunk of c = 64 tokens, with cl the inclusive cumsum of its
// log decays (base 2) and `total` its last:
//   p   = Ω v^T                                    (wgmma, SS; exact)
//   W   = p o 2^(cl_i - cl_n) for n <= i, else 0
//   dq  = 2^cl_i (Ω S) + W k                        (SS from S^T's copies,
//                                                    MN-major; RS, k MN-major)
//   S^T = 2^total S^T + (w o v)^T k, w_n = 2^(total - cl_n) <= 1
//                                                  (SS; both MN-major)
// Every operand that is not a bf16 input (W, the copy of S^T and w o v)
// goes as a hi + lo pair of bf16 (sm90::pack_bf16_split), two products
// into one f32 accumulator: ~2^-17 relative, where one bf16 rounding
// (2^-9) would miss the f32 walk's 1e-4.  dq, the per-head f32 partial,
// is stored from registers.
__global__ void __launch_bounds__(kThreads, 2)
    ssd_bwd_q_wgmma_kernel(const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap om_map,
                           const float* __restrict__ ld,
                           float* __restrict__ dq, int heads, int per_group,
                           int n) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* s_hi = smem + kSHi;
  unsigned char* s_lo = smem + kSLo;
  unsigned char* wv_hi = smem + kWvHi;
  unsigned char* wv_lo = smem + kWvLo;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(smem + kBars);  // [2]
  uint64_t* vo_full = k_full + kKStages;

  const int bh = blockIdx.x;  // batch * heads + head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int k_slice = bi * (heads / per_group) + hi / per_group;
  const int chunks = (n + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  // rows past n arrive as zeros
  auto k_tile = [&](int c) { return smem + kK + (c % kKStages) * kKBytes; };
  auto load_k = [&](int c) {
    uint64_t* bar = &k_full[c % kKStages];
    sm90::bar_expect(bar, kKBytes);
#pragma unroll
    for (int b = 0; b < 2; ++b)
      sm90::tma_load_3d(k_tile(c) + b * kKBytes / 2, &k_map, bar, 64 * b,
                        c * kChunk, k_slice);
  };
  auto load_vo = [&](int c) {
    sm90::bar_expect(vo_full, 2 * kVBytes);
    sm90::tma_load_3d(smem + kV, &v_map, vo_full, 0, c * kChunk, bh);
    sm90::tma_load_3d(smem + kOm, &om_map, vo_full, 0, c * kChunk, bh);
  };
  // lane l's two log decays of chunk c in base 2 (tokens 2l, 2l + 1; 0
  // past n)
  const float* ld_row = ld + static_cast<size_t>(bh) * n;
  auto load_ld = [&](int c, float (&x)[2]) {
    const int t = c * kChunk + 2 * lane;
    x[0] = t < n ? ld_row[t] * kLog2e : 0.f;
    x[1] = t + 1 < n ? ld_row[t + 1] * kLog2e : 0.f;
  };
  float* dq_head = dq + static_cast<size_t>(bh) * n * kDk;

  if (tid == 0) {
    for (int s = 0; s < kKStages; ++s) sm90::bar_init(&k_full[s], 1);
    sm90::bar_init(vo_full, 1);
    sm90::bar_init_fence();
  }
  // S_0 = 0: both of its copies too
  for (int i = tid; i < static_cast<int>(2 * kSBytes / 16); i += kThreads)
    reinterpret_cast<uint4*>(smem + kSHi)[i] = make_uint4(0, 0, 0, 0);
  sm90::fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    load_k(0);
    load_vo(0);
  }

  float st[kDk / 2];  // S^T: rows (Dv) 16 warp + g (+ 8), columns (Dk)
                     // 8 a + 2 tq
#pragma unroll
  for (int i = 0; i < kDk / 2; ++i) st[i] = 0.f;
  float ld_cur[2];
  load_ld(0, ld_cur);
  const int row0 = 16 * warp + g;  // this thread's rows of a chunk: +0, +8

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    // every thread is done with chunk c - 1: its k stage and the (w v)
    // tiles are free, both copies of S^T are whole
    __syncthreads();
    if (tid == 0 && c + 1 < chunks) load_k(c + 1);
    __syncwarp();
    float ld_next[2] = {0.f, 0.f};
    if (c + 1 < chunks) load_ld(c + 1, ld_next);
    sm90::bar_wait(&k_full[c % kKStages], (c / kKStages) & 1);
    sm90::bar_wait(vo_full, c & 1);
    __syncwarp();  // the products below are warp-aligned
    const bf16* k_t = reinterpret_cast<const bf16*>(k_tile(c));
    const bf16* v_t = reinterpret_cast<const bf16*>(smem + kV);
    const bf16* om_t = reinterpret_cast<const bf16*>(smem + kOm);

    // p = Ω v^T; Ω S from both copies of S^T
    float p[32], dqa[64];
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kDv / 16; ++kk)
      sm90::mma_ss_n64(p, sm90::desc_k<kChunk>(om_t, kk),
                       sm90::desc_k<kChunk>(v_t, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kDv / 16; ++kk)
      sm90::mma_ss_n128<0, 1>(
          dqa, sm90::desc_k<kChunk>(om_t, kk),
          sm90::desc_mn<kDv>(reinterpret_cast<const bf16*>(s_hi), kk), kk);
#pragma unroll
    for (int kk = 0; kk < kDv / 16; ++kk)
      sm90::mma_ss_n128<0, 1>(
          dqa, sm90::desc_k<kChunk>(om_t, kk),
          sm90::desc_mn<kDv>(reinterpret_cast<const bf16*>(s_lo), kk), 1);
    sm90::mma_commit();

    // behind the products: cl (cd::scan), and the hi and lo (w v) tiles
    const cd::Cumsum cl = cd::scan(ld_cur, lane);
    cd::weighted_v<true, kThreads>(cl, smem + kV, wv_hi, wv_lo, tid);
    float cl_col[16];  // cl of this thread's key columns
    cl.cols(tq, cl_col);
    const float cl_row[2] = {cl.at(row0), cl.at(row0 + 8)};
    __syncwarp();
    sm90::mma_wait<0>();  // p and Ω S
    sm90::pin(p);
    sm90::pin(dqa);
    // the (w v) tiles for the state update; the fence also orders this
    // thread's reads of v before the TMA load that reuses its tile
    sm90::fence_async_smem();
    // every warp is done with v, Ω and both copies of S^T, and the (w v)
    // tiles are whole: the next chunk's v and Ω load behind the rest of
    // this one
    __syncthreads();
    if (tid == 0 && c + 1 < chunks) load_vo(c + 1);
    __syncwarp();

    // W = p o M in place: rows i (this thread's), columns n <= i
    cd::decay_mask<true>(p, cl_row, cl_col, warp, tq, row0);
    uint32_t wh[kChunk / 16][4], wl[kChunk / 16][4];
    sm90::to_a_split<kChunk / 16>(wh, wl, p);
    const float e_row[2] = {sm90::exp2_ftz(cl_row[0]),
                            sm90::exp2_ftz(cl_row[1])};
#pragma unroll
    for (int i = 0; i < 64; ++i) dqa[i] *= e_row[(i >> 1) & 1];
    const float e_total = sm90::exp2_ftz(cl.total);
#pragma unroll
    for (int i = 0; i < kDk / 2; ++i) st[i] *= e_total;
    sm90::pin(dqa);
    sm90::pin(st);
    sm90::pin(wh);
    sm90::pin(wl);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n128(dqa, wh[kk], sm90::desc_mn<kChunk>(k_t, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n128(dqa, wl[kk], sm90::desc_mn<kChunk>(k_t, kk), 1);
    sm90::mma_commit();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_ss_n128<1, 1>(
          st, sm90::desc_mn<kChunk>(reinterpret_cast<const bf16*>(wv_hi), kk),
          sm90::desc_mn<kChunk>(k_t, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_ss_n128<1, 1>(
          st, sm90::desc_mn<kChunk>(reinterpret_cast<const bf16*>(wv_lo), kk),
          sm90::desc_mn<kChunk>(k_t, kk), 1);
    sm90::mma_commit();

    sm90::mma_wait<1>();  // dq, while the state update runs
    sm90::pin(dqa);
    sm90::pin(wh);
    sm90::pin(wl);
    // dq rows from registers: a quad's 8-byte stores fill 32-byte sectors
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = t0 + row0 + 8 * r;
      if (row < n) {
        float* out = dq_head + static_cast<size_t>(row) * kDk + 2 * tq;
#pragma unroll
        for (int a = 0; a < kDk / 8; ++a)
          *reinterpret_cast<float2*>(out + 8 * a) =
              make_float2(dqa[4 * a + 2 * r], dqa[4 * a + 2 * r + 1]);
      }
    }
    sm90::mma_wait<0>();
    sm90::pin(st);
    // the hi and lo copies of the new S^T, the B of the next readout
    sm90::store_tile_split<kDk / 8>(s_hi, s_lo, st);
    sm90::fence_async_smem();
    ld_cur[0] = ld_next[0];
    ld_cur[1] = ld_next[1];
  }
}

}  // namespace sq

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

// A staged token row of W floats with 4 floats of padding after every G.
template <int W, int G>
struct Padded {
  static_assert(W % G == 0 && G % 4 == 0, "slices of whole float4s");
  static constexpr int kWidth = W + 4 * (W / G);
  __device__ static int at(int e) { return e + 4 * (e / G); }
};

// The two register tilings of a (Dk, Dv) state (see the header).
template <int DK, int DV>
struct Tiles;
template <>
struct Tiles<128, 64> {
  static constexpr int kColGroups = 8;
  static constexpr int kRowGroups = 4;
};
template <>
struct Tiles<64, 64> {
  static constexpr int kColGroups = 8;
  static constexpr int kRowGroups = 8;
};
template <>
struct Tiles<16, 32> {
  static constexpr int kColGroups = 4;
  static constexpr int kRowGroups = 8;
};

template <int DK, int DV>
struct Layout {
  static constexpr int kColGroups = Tiles<DK, DV>::kColGroups;
  static constexpr int kRowGroups = Tiles<DK, DV>::kRowGroups;
  static constexpr int R = DK / kColGroups;  // rows of a column tile
  static constexpr int C = DV / kRowGroups;  // columns of a row tile
  static constexpr int kColThreads = (DV / 4) * kColGroups;
  static constexpr int kRowThreads = (DK / 4) * kRowGroups;
  using PadK = Padded<DK, R>;  // staged q and k rows
  using PadV = Padded<DV, C>;  // staged v and Ω rows
  static_assert(R % 4 == 0 && C % 4 == 0, "tiles of whole float4s");
  static_assert(kColThreads % 32 == 0 && kRowThreads % 32 == 0,
                "each role fills whole warps");
};

// Stage `len` contiguous rows of W values from device memory into padded
// shared-memory rows as f32, 16 bytes per load; unrolled so that each
// thread keeps several loads in flight.  Rows are 16-byte aligned.
template <typename Pad, int W, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int len,
                                           int tid, int nthr) {
  constexpr int V = 16 / sizeof(T);
  static_assert(W % V == 0, "whole 16-byte loads per row");
#pragma unroll 4
  for (int idx = tid; idx < len * (W / V); idx += nthr) {
    const int e = idx * V;
    const int t = e / W;
    const int col = e - t * W;
    float vals[V];
    load16(src + e, vals);
    float* row = dst + t * Pad::kWidth;
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(row + Pad::at(col + i)) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Sum over N adjacent lanes (N a power of two dividing 32).
template <int N>
__device__ __forceinline__ float lane_sum(float x) {
#pragma unroll
  for (int off = 1; off < N; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Column tile s[c][i] = S[row0 + i, col0 + c]: S <- gam S + a^T b over the
// tile (a: its R rows, b: its 4 columns), then acc[c] = the tile's share
// of x . S[:, col0 + c].
template <int R>
__device__ __forceinline__ void col_step(float (&s)[4][R], float gam,
                                         const float* a, float4 b4,
                                         const float* x, float (&acc)[4]) {
  const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = 0.0f;
#pragma unroll
  for (int i4 = 0; i4 < R / 4; ++i4) {
    const float4 a4 = ld4(a + 4 * i4);
    const float4 x4 = ld4(x + 4 * i4);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float& e = s[c][4 * i4 + r];
        e = fmaf(av[r], b[c], gam * e);
        acc[c] = fmaf(xv[r], e, acc[c]);
      }
    }
  }
}

// Row tile s[r][j] = S[row0 + r, col0 + j]: S <- gam S + a^T b over the
// tile (a: its 4 rows, b: its C columns), then acc[r] = the tile's share
// of S[row0 + r, :] . y.
template <int C>
__device__ __forceinline__ void row_step(float (&s)[4][C], float gam,
                                         float4 a4, const float* b,
                                         const float* y, float (&acc)[4]) {
  const float av[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = 0.0f;
#pragma unroll
  for (int j4 = 0; j4 < C / 4; ++j4) {
    const float4 b4 = ld4(b + 4 * j4);
    const float4 y4 = ld4(y + 4 * j4);
    const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
    const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float& e = s[r][4 * j4 + j];
        e = fmaf(av[r], bv[j], gam * e);
        acc[r] = fmaf(e, yv[j], acc[r]);
      }
    }
  }
}

// Write `count` f32 values from shared memory to device memory as T.
template <typename T>
__device__ __forceinline__ void write_out(T* dst, const float* src,
                                          int count, int tid, int nthr) {
  for (int idx = tid; idx < count; idx += nthr) dst[idx] = from_f32<T>(src[idx]);
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(Layout<DK, DV>::kColThreads, 2)
    ssd_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ ld,
                   T* __restrict__ o, int heads, int per_group, int n,
                   int stage) {
  using L = Layout<DK, DV>;
  using PK = typename L::PadK;
  using PV = typename L::PadV;
  constexpr int R = L::R;
  extern __shared__ __align__(16) float smem[];  // read as float4
  float* q_sh = smem;                      // (stage, PK::kWidth)
  float* k_sh = q_sh + stage * PK::kWidth;  // (stage, PK::kWidth)
  float* v_sh = k_sh + stage * PK::kWidth;  // (stage, PV::kWidth)
  float* o_sh = v_sh + stage * PV::kWidth;  // (stage, DV)
  float* gam_sh = o_sh + stage * DV;        // (stage,)

  const int bh = blockIdx.x;  // batch * heads + head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int groups = heads / per_group;
  const size_t qk_base =
      (static_cast<size_t>(bi) * groups + hi / per_group) * n * DK;
  const size_t v_base = static_cast<size_t>(bh) * n * DV;
  const size_t ld_base = static_cast<size_t>(bh) * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rg = tid % L::kColGroups;
  const int cg = tid / L::kColGroups;

  float s[4][R];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int i = 0; i < R; ++i) s[c][i] = 0.0f;

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t qk_row = qk_base + static_cast<size_t>(t0) * DK;
    const size_t v_row = v_base + static_cast<size_t>(t0) * DV;
    stage_rows<PK, DK>(q_sh, q + qk_row, len, tid, nthr);
    stage_rows<PK, DK>(k_sh, k + qk_row, len, tid, nthr);
    stage_rows<PV, DV>(v_sh, v + v_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr)
      gam_sh[t] = expf(ld[ld_base + t0 + t]);
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      float acc[4];
      col_step<R>(s, gam_sh[t], k_sh + t * PK::kWidth + PK::at(rg * R),
                  ld4(v_sh + t * PV::kWidth + PV::at(4 * cg)),
                  q_sh + t * PK::kWidth + PK::at(rg * R), acc);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = lane_sum<L::kColGroups>(acc[c]);
      if (rg == 0)
        *reinterpret_cast<float4*>(o_sh + t * DV + 4 * cg) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    write_out(o + v_row, o_sh, len * DV, tid, nthr);
    __syncthreads();  // the next iteration overwrites the staging
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(Layout<DK, DV>::kRowThreads, 2)
    ssd_bwd_q_kernel(const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ ld, const T* __restrict__ om,
                     float* __restrict__ dq, int heads, int per_group, int n,
                     int stage) {
  using L = Layout<DK, DV>;
  using PK = typename L::PadK;
  using PV = typename L::PadV;
  constexpr int C = L::C;
  extern __shared__ __align__(16) float smem[];
  float* k_sh = smem;                        // (stage, PK::kWidth)
  float* v_sh = k_sh + stage * PK::kWidth;   // (stage, PV::kWidth)
  float* om_sh = v_sh + stage * PV::kWidth;  // (stage, PV::kWidth)
  float* dq_sh = om_sh + stage * PV::kWidth;  // (stage, DK)
  float* gam_sh = dq_sh + stage * DK;         // (stage,)

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int groups = heads / per_group;
  const size_t k_base =
      (static_cast<size_t>(bi) * groups + hi / per_group) * n * DK;
  const size_t v_base = static_cast<size_t>(bh) * n * DV;
  const size_t dq_base = static_cast<size_t>(bh) * n * DK;
  const size_t ld_base = static_cast<size_t>(bh) * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int cg = tid % L::kRowGroups;
  const int dg = tid / L::kRowGroups;

  float s[4][C];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int j = 0; j < C; ++j) s[r][j] = 0.0f;

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t v_row = v_base + static_cast<size_t>(t0) * DV;
    stage_rows<PK, DK>(k_sh, k + k_base + static_cast<size_t>(t0) * DK, len,
                       tid, nthr);
    stage_rows<PV, DV>(v_sh, v + v_row, len, tid, nthr);
    stage_rows<PV, DV>(om_sh, om + v_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr)
      gam_sh[t] = expf(ld[ld_base + t0 + t]);
    __syncthreads();

    for (int t = 0; t < len; ++t) {
      float acc[4];
      row_step<C>(s, gam_sh[t], ld4(k_sh + t * PK::kWidth + PK::at(4 * dg)),
                  v_sh + t * PV::kWidth + PV::at(cg * C),
                  om_sh + t * PV::kWidth + PV::at(cg * C), acc);
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = lane_sum<L::kRowGroups>(acc[r]);
      if (cg == 0)
        *reinterpret_cast<float4*>(dq_sh + t * DK + 4 * dg) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();
    write_out(dq + dq_base + static_cast<size_t>(t0) * DK, dq_sh, len * DK,
              tid, nthr);
    __syncthreads();
  }
}

template <typename T, int DK, int DV>
__global__ void __launch_bounds__(Layout<DK, DV>::kRowThreads +
                                      Layout<DK, DV>::kColThreads,
                                  2)
    ssd_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const float* __restrict__ ld,
                      const T* __restrict__ om, float* __restrict__ dk,
                      float* __restrict__ dv, int heads, int per_group,
                      int n, int stage) {
  using L = Layout<DK, DV>;
  using PK = typename L::PadK;
  using PV = typename L::PadV;
  constexpr int R = L::R;
  // both roles keep U in one register array of the same shape
  static_assert(L::R == L::C, "row and column tiles of equal size");
  extern __shared__ __align__(16) float smem[];
  float* q_sh = smem;                         // (stage, PK::kWidth)
  float* k_sh = q_sh + stage * PK::kWidth;    // (stage, PK::kWidth)
  float* v_sh = k_sh + stage * PK::kWidth;    // (stage, PV::kWidth)
  float* om_sh = v_sh + stage * PV::kWidth;   // (stage, PV::kWidth)
  float* dk_sh = om_sh + stage * PV::kWidth;  // (stage, DK)
  float* dv_sh = dk_sh + stage * DK;          // (stage, DV)
  float* gam_sh = dv_sh + stage * DV;         // (stage,)

  const int bh = blockIdx.x;
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int groups = heads / per_group;
  const size_t qk_base =
      (static_cast<size_t>(bi) * groups + hi / per_group) * n * DK;
  const size_t v_base = static_cast<size_t>(bh) * n * DV;
  const size_t dk_base = static_cast<size_t>(bh) * n * DK;
  const size_t ld_base = static_cast<size_t>(bh) * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const bool row_role = tid < L::kRowThreads;  // warp-uniform
  const int ct = tid - L::kRowThreads;         // column role's thread
  // row role: rows 4dg..4dg+3, columns cgr*C..; column role: columns
  // 4cgc..4cgc+3, rows rg*R..
  const int cgr = tid % L::kRowGroups;
  const int dg = tid / L::kRowGroups;
  const int rg = ct % L::kColGroups;
  const int cgc = ct / L::kColGroups;

  float u[4][R];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int i = 0; i < R; ++i) u[a][i] = 0.0f;
  float gam_next = 1.0f;  // γ of the token walked last (U starts at 0)

  for (int end = n; end > 0; end -= stage) {
    const int t0 = max(0, end - stage);
    const int len = end - t0;
    const size_t qk_row = qk_base + static_cast<size_t>(t0) * DK;
    const size_t v_row = v_base + static_cast<size_t>(t0) * DV;
    stage_rows<PK, DK>(q_sh, q + qk_row, len, tid, nthr);
    stage_rows<PK, DK>(k_sh, k + qk_row, len, tid, nthr);
    stage_rows<PV, DV>(v_sh, v + v_row, len, tid, nthr);
    stage_rows<PV, DV>(om_sh, om + v_row, len, tid, nthr);
    for (int t = tid; t < len; t += nthr)
      gam_sh[t] = expf(ld[ld_base + t0 + t]);
    __syncthreads();

    if (row_role) {
      for (int t = len - 1; t >= 0; --t) {
        float acc[4];
        row_step<R>(u, gam_next, ld4(q_sh + t * PK::kWidth + PK::at(4 * dg)),
                    om_sh + t * PV::kWidth + PV::at(cgr * R),
                    v_sh + t * PV::kWidth + PV::at(cgr * R), acc);
        gam_next = gam_sh[t];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r] = lane_sum<L::kRowGroups>(acc[r]);
        if (cgr == 0)
          *reinterpret_cast<float4*>(dk_sh + t * DK + 4 * dg) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    } else {
      for (int t = len - 1; t >= 0; --t) {
        float acc[4];
        col_step<R>(u, gam_next, q_sh + t * PK::kWidth + PK::at(rg * R),
                    ld4(om_sh + t * PV::kWidth + PV::at(4 * cgc)),
                    k_sh + t * PK::kWidth + PK::at(rg * R), acc);
        gam_next = gam_sh[t];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = lane_sum<L::kColGroups>(acc[c]);
        if (rg == 0)
          *reinterpret_cast<float4*>(dv_sh + t * DV + 4 * cgc) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    __syncthreads();
    write_out(dk + dk_base + static_cast<size_t>(t0) * DK, dk_sh, len * DK,
              tid, nthr);
    write_out(dv + v_row, dv_sh, len * DV, tid, nthr);
    __syncthreads();
  }
}

enum class Kind { kFwd, kBwdQ, kBwdKV };

template <Kind K, int DK, int DV>
struct Block {
  using L = Layout<DK, DV>;
  static constexpr int kThreads =
      K == Kind::kFwd    ? L::kColThreads
      : K == Kind::kBwdQ ? L::kRowThreads
                         : L::kRowThreads + L::kColThreads;
  // staged floats per token: inputs, outputs and the decay
  static constexpr size_t kPerToken =
      K == Kind::kFwd
          ? 2 * L::PadK::kWidth + L::PadV::kWidth + DV + 1
      : K == Kind::kBwdQ
          ? L::PadK::kWidth + 2 * L::PadV::kWidth + DK + 1
          : 2 * L::PadK::kWidth + 2 * L::PadV::kWidth + DK + DV + 1;
};

// The kernel of kind K for (T, DK, DV).
template <Kind K, typename T, int DK, int DV>
auto kernel_of() {
  if constexpr (K == Kind::kFwd)
    return ssd_fwd_kernel<T, DK, DV>;
  else if constexpr (K == Kind::kBwdQ)
    return ssd_bwd_q_kernel<T, DK, DV>;
  else
    return ssd_bwd_kv_kernel<T, DK, DV>;
}

// The launch of one of the three kernels, shared by the launchers and
// `ssd_plan`: f(Type<T>{}, kernel, geometry, Int<wgmma>{}) for the
// instantiation a call with these arguments runs.  One block per (batch,
// head).  The wgmma bodies (all three kernels in bf16 at (128, 64),
// ssd_fwd also at (64, 64)) walk
// chunks of sc::kChunk = sq::kChunk = sk::kChunk tokens, which `stage`
// must name;
// the token walk stages `stage` tokens per iteration, shrunk to fit
// kMaxSmem.
template <Kind K, typename F>
cudaError_t with_launch(int dtype, int dk, int dv, int batch, int heads,
                        int stage, F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if constexpr (K == Kind::kFwd &&
                  std::is_same<T, __nv_bfloat16>::value) {
      if (sc::takes(dk, dv)) {
        if (stage != sc::kChunk) return cudaErrorInvalidValue;
        // (64, 64) with hi + lo operands, (128, 64) single roundings
        auto go = [&](auto dkc) {
          constexpr int DK = decltype(dkc)::value;
          constexpr bool kPairs = DK == 64;
          return f(t, sc::ssd_fwd_wgmma_kernel<DK, kPairs>,
                   plan::Geometry{dim3(batch * heads), sc::kThreads,
                                  sc::Layout<DK, kPairs>::kSmem, sc::kChunk},
                   plan::Int<1>{});
        };
        return dk == 64 ? go(plan::Int<64>{}) : go(plan::Int<128>{});
      }
    }
    if constexpr (K == Kind::kBwdQ &&
                  std::is_same<T, __nv_bfloat16>::value) {
      if (dk == sq::kDk && dv == sq::kDv) {
        if (stage != sq::kChunk) return cudaErrorInvalidValue;
        return f(t, sq::ssd_bwd_q_wgmma_kernel,
                 plan::Geometry{dim3(batch * heads), sq::kThreads, sq::kSmem,
                                sq::kChunk},
                 plan::Int<1>{});
      }
    }
    if constexpr (K == Kind::kBwdKV &&
                  std::is_same<T, __nv_bfloat16>::value) {
      if (dk == sk::kDk && dv == sk::kDv) {
        if (stage != sk::kChunk) return cudaErrorInvalidValue;
        return f(t, sk::ssd_bwd_kv_wgmma_kernel,
                 plan::Geometry{dim3(batch * heads), sk::kThreads, sk::kSmem,
                                sk::kChunk},
                 plan::Int<1>{});
      }
    }
    auto go = [&](auto dkc, auto dvc) {
      constexpr int DK = decltype(dkc)::value;
      constexpr int DV = decltype(dvc)::value;
      using B = Block<K, DK, DV>;
      auto kernel = kernel_of<K, T, DK, DV>();
      return f(t, kernel,
               plan::fit({dim3(batch * heads), B::kThreads, 0, 0}, stage,
                         B::kPerToken * sizeof(float), kMaxSmem),
               plan::Int<0>{});
    };
    if (dk == 128 && dv == 64) return go(plan::Int<128>{}, plan::Int<64>{});
    if (dk == 64 && dv == 64) return go(plan::Int<64>{}, plan::Int<64>{});
    if (dk == 16 && dv == 32) return go(plan::Int<16>{}, plan::Int<32>{});
    return cudaErrorInvalidValue;
  });
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* ld;
  const void* om;
  void* out0;
  void* out1;
  int batch, heads, groups, n, stage;
  cudaStream_t stream;
};

bool bad_shape(int batch, int heads, int groups, int n, int stage) {
  return batch <= 0 || groups <= 0 || heads <= 0 || n < 0 || stage <= 0 ||
         heads % groups != 0;
}

template <Kind K>
int run(const Args& a, int dk, int dv, int dtype) {
  if (bad_shape(a.batch, a.heads, a.groups, a.n, a.stage))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.n == 0) return 0;
  const int per_group = a.heads / a.groups;
  return static_cast<int>(with_launch<K>(
      dtype, dk, dv, a.batch, a.heads, a.stage,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        if (geo.stage < 1) return cudaErrorInvalidValue;
        const T* q = static_cast<const T*>(a.q);
        const T* k = static_cast<const T*>(a.k);
        const T* v = static_cast<const T*>(a.v);
        const float* ld = static_cast<const float*>(a.ld);
        [[maybe_unused]] const T* om = static_cast<const T*>(a.om);
        if constexpr (decltype(body)::value == 1 && K == Kind::kBwdKV) {
          CUtensorMap q_map, k_map, v_map, om_map;
          cudaError_t err = sm90::map_rows(&q_map, q, a.n,
                                           a.batch * a.groups, sk::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&k_map, k, a.n, a.batch * a.groups,
                                 sk::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&v_map, v, a.n, a.batch * a.heads,
                                 sk::kChunk, sk::kDv);
          if (err == cudaSuccess)
            err = sm90::map_rows(&om_map, om, a.n, a.batch * a.heads,
                                 sk::kChunk, sk::kDv);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, a.stream, q_map, k_map, v_map,
                              om_map, ld, static_cast<float*>(a.out0),
                              static_cast<float*>(a.out1), a.heads,
                              per_group, a.n);
        } else if constexpr (decltype(body)::value == 1 &&
                             K == Kind::kBwdQ) {
          CUtensorMap k_map, v_map, om_map;
          cudaError_t err = sm90::map_rows(&k_map, k, a.n,
                                           a.batch * a.groups, sq::kChunk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&v_map, v, a.n, a.batch * a.heads,
                                 sq::kChunk, sq::kDv);
          if (err == cudaSuccess)
            err = sm90::map_rows(&om_map, om, a.n, a.batch * a.heads,
                                 sq::kChunk, sq::kDv);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, a.stream, k_map, v_map, om_map,
                              ld, static_cast<float*>(a.out0), a.heads,
                              per_group, a.n);
        } else if constexpr (decltype(body)::value == 1) {
          CUtensorMap q_map, k_map, v_map, o_map;
          cudaError_t err = sm90::map_rows(&q_map, q, a.n,
                                           a.batch * a.groups, sc::kChunk,
                                           dk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&k_map, k, a.n, a.batch * a.groups,
                                 sc::kChunk, dk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&v_map, v, a.n, a.batch * a.heads,
                                 sc::kChunk, sc::kDv);
          if (err == cudaSuccess)
            err = sm90::map_rows(&o_map, a.out0, a.n, a.batch * a.heads,
                                 sc::kChunk, sc::kDv);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, a.stream, q_map, k_map, v_map,
                              o_map, ld, a.heads, per_group, a.n);
        } else if constexpr (K == Kind::kFwd)
          return plan::launch(kernel, geo, a.stream, q, k, v, ld,
                              static_cast<T*>(a.out0), a.heads, per_group,
                              a.n, geo.stage);
        else if constexpr (K == Kind::kBwdQ)
          return plan::launch(kernel, geo, a.stream, k, v, ld, om,
                              static_cast<float*>(a.out0), a.heads,
                              per_group, a.n, geo.stage);
        else
          return plan::launch(kernel, geo, a.stream, q, k, v, ld, om,
                              static_cast<float*>(a.out0),
                              static_cast<float*>(a.out1), a.heads,
                              per_group, a.n, geo.stage);
      }));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16
// (of q, k, v, Ω and o).  Each returns the cudaError_t of its launch
// (0 = success); the launch is asynchronous on `stream`.  All three in
// bf16 at (Dk, Dv) = (128, 64), and ssd_fwd at (64, 64), run their wgmma
// bodies: `stage` must be the
// chunk (64), and their TMA reads need q, k, v (and Ω) 16-byte aligned
// (the wrapper checks it; a map that cannot be encoded is refused with
// cudaErrorInvalidValue).
extern "C" int ssd_fwd(const void* q, const void* k, const void* v,
                       const void* ld, void* o, int batch, int heads,
                       int groups, int n, int dk, int dv, int stage,
                       int dtype, void* stream) {
  const Args a{q,     k,      v, ld,    nullptr, o, nullptr, batch,
               heads, groups, n, stage, static_cast<cudaStream_t>(stream)};
  return run<Kind::kFwd>(a, dk, dv, dtype);
}

// dq: per-head partials (B, H, N, Dk) f32.
extern "C" int ssd_bwd_q(const void* k, const void* v, const void* ld,
                         const void* om, void* dq, int batch, int heads,
                         int groups, int n, int dk, int dv, int stage,
                         int dtype, void* stream) {
  const Args a{nullptr, k,      v, ld,    om, dq, nullptr, batch,
               heads,   groups, n, stage, static_cast<cudaStream_t>(stream)};
  return run<Kind::kBwdQ>(a, dk, dv, dtype);
}

// dk: per-head partials (B, H, N, Dk) f32; dv (B, H, N, Dv) f32.
extern "C" int ssd_bwd_kv(const void* q, const void* k, const void* v,
                          const void* ld, const void* om, void* dk,
                          void* dv_out, int batch, int heads, int groups,
                          int n, int dk_dim, int dv_dim, int stage,
                          int dtype, void* stream) {
  const Args a{q,     k,      v, ld,    om, dk, dv_out, batch,
               heads, groups, n, stage, static_cast<cudaStream_t>(stream)};
  return run<Kind::kBwdKV>(a, dk_dim, dv_dim, dtype);
}

// The geometry a call of `entry` ("ssd_fwd", "ssd_bwd_q" or "ssd_bwd_kv")
// with these arguments launches, into out[7] (plan.cuh); nothing is
// launched.
extern "C" int ssd_plan(const char* entry, int batch, int heads, int groups,
                        int n, int dk, int dv, int stage, int dtype,
                        int64_t* out) {
  if (bad_shape(batch, heads, groups, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  auto report = [&](auto, auto kernel, const plan::Geometry& geo, auto) {
    return plan::report(kernel, geo, out);
  };
  cudaError_t err = cudaErrorInvalidValue;
  if (strcmp(entry, "ssd_fwd") == 0)
    err = with_launch<Kind::kFwd>(dtype, dk, dv, batch, heads, stage, report);
  else if (strcmp(entry, "ssd_bwd_q") == 0)
    err = with_launch<Kind::kBwdQ>(dtype, dk, dv, batch, heads, stage,
                                   report);
  else if (strcmp(entry, "ssd_bwd_kv") == 0)
    err = with_launch<Kind::kBwdKV>(dtype, dk, dv, batch, heads, stage,
                                    report);
  return static_cast<int>(err);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
