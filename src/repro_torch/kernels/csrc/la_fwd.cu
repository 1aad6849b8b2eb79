// Causal normalized linear-attention forward, plain and decay-gated, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels `la_fwd_pallas`
// (src/repro/kernels/linear_attention.py:96; its body is `_fwd_kernel`,
// linear_attention.py:67) and, as the `kGated` instantiation behind the
// entry `gla_fwd`, `gla_fwd_pallas` (src/repro/kernels/gla.py:118; body
// `_gla_fwd_kernel`, gla.py:77).  For every (batch, query head) and token t:
//
//   S_t = γ_t S_{t-1} + k_t^T [v_t, 1]  (Dk, Dv+1), f32
//   P_t = γ_t P_{t-1} + [v_t, 1]        (Dv+1,),    f32
//   f_t = a P_t + b q_t S_t             (the causal sum includes t)
//   o_t = f_t[:Dv] / f_t[Dv]            safe_div semantics: |den| < 1e-30 -> 0
//   g_t = f_t[Dv]                       the normalizer, the backward's residual
//
// with the decay γ_t = exp(ld_t) of token t applied to the state carried
// from t-1, never to token t's own term; γ_t = 1 for `la_fwd`.  This is the
// chunked form's intra-chunk (a + b q k^T)[v, 1] (decay-masked) plus its
// inter-chunk a P + b q S, summed token by token.  Every factor is
// exp(ld) <= 1, so nothing overflows and the reference's clamp of the
// decay exponent (`_decay_tri`, gla.py:58) has no counterpart.  The ones
// column of [v, 1] is implicit.  Both entries divide with the `xla`
// impls' safe_div (src/repro/core/chunked.py:140, src/repro/core/gla.py:153);
// the Pallas kernels divide plainly (linear_attention.py:89) or guard
// only g == 0 (gla.py:107).  They differ only where |g| < 1e-30.
//
// Shapes (all contiguous): q and k (B, H, N, Dk) and (B, Hkv, N, Dk), v
// (B, Hkv, N, Dv) in the compute type T (float or bf16), o (B, H, N, Dv)
// in T, g (B, H, N) f32, ld (B, Hkv, N) f32 (gated only: one decay per KV
// head, shared by its query group).  H = G * Hkv, and query head h reads
// KV head h / G.  Dk and Dv are template parameters so that a state
// column lives in registers: Dk = Dv = D at 32, 64 or 128 (`la_fwd`'s walk
// also 112), and for `la_fwd`'s walk (Dk, Dv) = (192, 128), deepseek-v2's
// MLA heads (plan::with_walk_dims).
//
// Two bodies of each entry, chosen by the launcher from the dtype and the
// dims (plan::chunked_dims): the chunked wgmma body (namespace lc,
// `template <int kD, bool kGated>`) for bf16 at Dk = Dv = 128 (gla_fwd its
// kGated instance) and, for `la_fwd` only, 64 (stablelm-1.6b,
// whisper-large-v3's decoder); the token walk (gla_fwd its kGated
// instantiation) for f32 and at every other pair.
//
// What bounds them: the recurrent form does 4 D (D+1) flops per token and
// head (the state update and the q.S readout; gated, 5 D (D+1) with the
// decay), in f32 on the CUDA cores; at B=2, H=16, N=8192, D=128 that is
// 17.3 GFLOP (gated 21.6), 0.26 ms (0.32) at 67 TFLOP/s, against 0.08 ms
// for its 269.5 MB at 3.35 TB/s (estimates from the shapes, not
// measurements).  The chunked body does four products per chunk of 64
// tokens and part of 64 value columns, 30.1 GFLOP on the bf16 tensor
// cores (0.030 ms at 989 TFLOP/s): bound by its bytes (0.080 ms); at
// stablelm-1.6b's B=2, H=32, N=8192, D=64, 17.2 GFLOP (0.017 ms) against
// 0.081 ms of bytes.  Its gated instance runs three of them twice (a hi
// + lo operand), 51.5 GFLOP (0.052 ms), and is bound by its bytes too
// (270.5 MB, 0.081 ms).
//
// Design of the chunked body (the reference's chunked form,
// src/repro/kernels/linear_attention.py:67-93; ssd.cu's sc without the
// decay, with the normalizer):
//   * D / 64 blocks per (batch, query head), one per part of 64 value
//     columns, so each block's state S^T (64 x D) is one m64nD f32
//     accumulator (D / 2 registers a thread) and its products are sc's
//     tile shapes: at D = 128 two blocks per head, 64 at B=2, H=16; at
//     D = 64 one, whose whole state S^T (64 x 64) is 32 registers a
//     thread, 64 blocks at B=2, H=32 (its update S^T += v^T k an m64n64
//     product).  The parts read all of q and k and compute the same
//     scores and g (bit-identical); the part with column 0 writes g;
//   * thread 0 loads each chunk's q, k (64 x D, boxes of 64 columns) and
//     the block's part of v (64 x 64) by TMA into a 2-stage ring (rows
//     past N arrive as zeros; 101,888 B of shared memory at D = 128,
//     60,416 B at 64); o is staged by stmatrix in the chunk's q tile and
//     stored by TMA from the next chunk;
//   * per chunk: q k^T and q S (S from the bf16 copy of S^T, K-major) by
//     wgmma; A = a + b q k^T on j <= i rounded to bf16 in registers, f =
//     b q S + a P + A v (v MN-major), o = f / g; S^T += v^T k (both
//     MN-major: no transpose copy, no rounding of the update);
//   * precision: g is the backward's residual and is held to 1e-4, so it
//     never goes through a bf16 operand: the row sums come from the f32
//     score accumulator, q . z is an f32 dot on the CUDA cores from the q
//     tile, and z (the sum of k) and P (the sum of v) are f32 sums in
//     shared memory, double-buffered so that the next chunk's sums are
//     formed while this chunk reads its own (at D = 64 z by the first
//     two warps and P by the other two).  o, held to one bf16 step,
//     rounds A and the readout's copy of S once per chunk;
//   * each o and g element is written once (no atomics): the result is
//     bit-deterministic;
//   * gated (gla_fwd): ssd.cu's sc carries the decay the same way
//     (decay.cuh): the chunk's cumsum cl of the KV head's log decays in
//     base 2 by a warp scan, A = (a + b q k^T) o 2^(cl_i - cl_j), the
//     readout scaled by 2^cl_i, the state by 2^total and its update fed
//     (w o v), w_j = 2^(total - cl_j) <= 1, built by the threads; the
//     exponents are masked differences <= 0, so nothing overflows.  z, P
//     and the decayed token count stay f32 on the CUDA cores, weighted
//     the same way, and g is the f32 row sums of the decayed A plus
//     2^cl_i (a n + b q . z).  A, the readout's copy of S^T and w o v go
//     as hi + lo pairs of bf16 (134,656 B of shared memory): o is held to
//     one bf16 step of the plain path, and a step-0 training comparison
//     reads it through deep-layer grads that cancel.
//
// Design of the token walk (simple first; f32, D = 32 and 112, (192,
// 128), and the gated entry at D = 64):
//   * one block per (batch, query head), walking the whole sequence: a
//     (B, H) grid, 32 blocks at B=2, H=16, on 132 SMs;
//   * the D value columns of S are tiled over D threads: thread (cg, rg)
//     owns columns 4cg..4cg+3 and rows rg*D/4..(rg+1)*D/4-1, a 4 x D/4
//     tile in registers, so each float it reads from shared memory feeds
//     4 FMAs.  The 4 row groups of a column group are adjacent lanes and
//     sum their partial q.S dots with two shuffles.  At (Dk, Dv) =
//     (192, 128) a column holds 192 rows: 8 row groups of 24 (`Walk`), 256
//     value threads of 4 x 24 floats, three shuffles, and q and k rows
//     padded per row group of 24;
//   * one more warp keeps the normalizer column (the running sum of k)
//     and its q dot, reduced across the warp; P's normalizer entry is
//     the token count.  It starts on a warp boundary: the D value threads
//     are rounded up to whole warps (at D = 112, 128 of which 112 work),
//     their shuffles name only the working lanes, and the normalizer
//     warp's lanes take ceil(D / 32) rows each (at 112, lanes 0..27);
//   * per iteration the block stages `stage` tokens of q, k and v in
//     shared memory as f32 (bf16 products are exact in f32) by 16-byte
//     loads, each row padded by 4 floats per row group so that the row
//     groups of a warp read disjoint banks; the tail iteration is bounded
//     by N, nothing is padded in device memory;
//   * the un-normalized f of the staged tokens lands in shared memory,
//     so every thread sees the normalizer for the divide;
//   * gated: the staging also holds the tokens' decays exp(ld) (one expf
//     per token, not per thread), and every state element, P and the
//     normalizer warp's column and count take one multiply more.  At
//     ld = 0 each update is the ungated one exactly (1 * x is x).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <string.h>

#include <type_traits>

#include "decay.cuh"
#include "plan.cuh"
#include "sm90.cuh"

namespace {
constexpr float kSafeEps = 1e-30f;  // core.numerics.safe_div threshold
}  // namespace

// ---------------------------------------------------------------------------
// the chunked wgmma body of la_fwd (bf16, D = 64 and 128)
// ---------------------------------------------------------------------------

namespace lc {

using bf16 = __nv_bfloat16;

constexpr int kPart = 64;             // value columns of a block: its N
constexpr int kChunk = 64;            // tokens of a chunk: the M of wgmma
constexpr int kStages = 2;            // chunks of q, k and v in the TMA ring
constexpr int kThreads = 128;         // one warpgroup
constexpr size_t kBox = static_cast<size_t>(kChunk) * 128;  // one TMA box
// beside the tiles and the sums: the barriers, and up to 1024 bytes of
// padding to the tiles' 1024-byte alignment
constexpr size_t kExtra = 2048;
constexpr float kLog2e = 1.4426950408889634f;

// The sizes at head dim kD (64 or 128; gated only 128), and the offsets
// after the ring (each tile 1024-byte aligned): the bf16 copy of S^T
// (gated: its hi + lo pair), the gated body's hi and lo (w o v) tiles,
// then z and P twice and the barriers.  D = 128: 101,888 B, gated
// 134,656 B; D = 64: 60,416 B.
template <int kD, bool kGated>
struct Layout {
  static constexpr int kSplit = kD / kPart;  // blocks per head
  static constexpr size_t kQKBytes = static_cast<size_t>(kChunk) * kD * 2;
  static constexpr size_t kVBytes = static_cast<size_t>(kChunk) * kPart * 2;
  // q, k and the block's part of v
  static constexpr size_t kStageBytes = 2 * kQKBytes + kVBytes;
  static constexpr size_t kSBytes = static_cast<size_t>(kPart) * kD * 2;
  static constexpr size_t kSumBytes = 2 * (kD + kPart) * 4;  // z, P twice
  static constexpr size_t kSHi = kStages * kStageBytes;
  static constexpr size_t kSLo = kSHi + kSBytes;
  static constexpr size_t kWvHi = kSLo + (kGated ? kSBytes : 0);
  static constexpr size_t kWvLo = kWvHi + kVBytes;
  static constexpr size_t kSums = kGated ? kWvLo + kVBytes : kSLo;
  static constexpr size_t kSmem = kSums + kSumBytes + kExtra;
};

// One block per (batch, query head, part of 64 value columns) walks its
// head's chunks in order: D / 64 blocks per head, so that the block's
// state S^T (64 x D) is one m64nD f32 accumulator (D / 2 registers a
// thread).  Per chunk of c = 64 tokens, with S (D x 64, held as the f32
// accumulator st = S^T) the sum of k^T v over the earlier chunks, P their
// sum of v and z their sum of k:
//   sc = q k^T                                     (wgmma, SS)
//   acc = q S, from S^T's bf16 copy                (wgmma, SS)
//   g  = a (t + 1) + b (rowsum of sc on j <= i + q . z), in f32: the row
//        sums from the f32 accumulator, q . z on the CUDA cores
//   A  = a + b sc on j <= i, else 0; bf16 in registers
//   f  = b acc + a P + A v                         (wgmma, RS; v MN-major)
//   o  = f / g (|g| < 1e-30 gives 0)
//   S^T += v^T k                                   (wgmma, SS; both MN-major)
//   z += sum of k, P += sum of v                   (f32, CUDA cores)
// kGated (gla_fwd, D = 128): with cl the inclusive cumsum of the chunk's
// log decays (base 2, a KV head's), `total` its last, and n the decayed
// count of the earlier tokens, every sum above is decayed (sc, sk's and
// sq's bookkeeping, decay.cuh):
//   A  = (a + b sc) o 2^(cl_i - cl_j) on j <= i, else 0, in f32
//   g  = rowsum of A + 2^cl_i (a n + b q . z)       (f32)
//   f  = 2^cl_i (b acc + a P) + A v                 (A as hi + lo, RS)
//   S^T = 2^total S^T + (w o v)^T k,  w_j = 2^(total - cl_j) <= 1
//                                                   ((w o v) as hi + lo, SS)
//   z = 2^total z + Σ w k,  P = 2^total P + Σ w v,  n = 2^total n + Σ w
// and the readout reads S^T's copy as a hi + lo pair.  o is held to one
// bf16 step of the plain path, and a step-0 train comparison reads it
// through cancelling deep-layer grads, so every non-input operand keeps
// ~16 bits.
// Every part computes g; the part with value column 0 writes it.  o of a
// chunk is staged as bf16 in the chunk's q tile and stored by TMA from the
// next chunk.
template <int kD, bool kGated>
__global__ void __launch_bounds__(kThreads, 1)
    la_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap o_map,
                        const float* __restrict__ ld,
                        float* __restrict__ g_out, int heads, int kv_heads,
                        int n, float a, float b) {
  using L = Layout<kD, kGated>;
  constexpr size_t kQKBytes = L::kQKBytes;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = sm90::aligned_smem(smem_raw);
  unsigned char* s_sh = smem + L::kSHi;
  [[maybe_unused]] unsigned char* s_lo = smem + L::kSLo;
  [[maybe_unused]] unsigned char* wv_hi = smem + L::kWvHi;
  [[maybe_unused]] unsigned char* wv_lo = smem + L::kWvLo;
  float* z_sh = reinterpret_cast<float*>(smem + L::kSums);  // [2][kD]
  float* p_sh = z_sh + 2 * kD;                              // [2][kPart]
  uint64_t* full = reinterpret_cast<uint64_t*>(p_sh + 2 * kPart);

  const int bh = blockIdx.x;  // batch * heads + query head
  const int part = blockIdx.y;  // the part of the value columns
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int kv_slice = bi * kv_heads + hi / (heads / kv_heads);
  const int chunks = (n + kChunk - 1) / kChunk;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  auto stage_of = [&](int c) {
    return smem + (c % kStages) * L::kStageBytes;
  };
  // q, k (box b = columns 64 b ..) and this part of v of chunk c into its
  // stage; rows past n arrive as zeros
  auto load_chunk = [&](int c) {
    unsigned char* st = stage_of(c);
    uint64_t* bar = &full[c % kStages];
    sm90::bar_expect(bar, L::kStageBytes);
#pragma unroll
    for (int bx = 0; bx < kD / 64; ++bx) {
      sm90::tma_load_3d(st + bx * kBox, &q_map, bar, 64 * bx, c * kChunk,
                        bh);
      sm90::tma_load_3d(st + L::kQKBytes + bx * kBox, &k_map, bar, 64 * bx,
                        c * kChunk, kv_slice);
    }
    sm90::tma_load_3d(st + 2 * L::kQKBytes, &v_map, bar, kPart * part,
                      c * kChunk, kv_slice);
  };
  // o of chunk c (this part's columns), staged in its q tile, to device
  // memory (rows past n are not written)
  auto store_o = [&](int c) {
    sm90::tma_store_3d(&o_map, stage_of(c), kPart * part, c * kChunk, bh);
    sm90::bulk_commit();
  };
  // gated: lane l's two log decays of chunk c in base 2 (tokens 2l,
  // 2l + 1; 0 past n, so the padded tokens of a ragged last chunk decay
  // nothing, and add nothing to a row of the chunk's real tokens)
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
  // S_0 = 0 (its bf16 copies too), z_0 = 0, P_0 = 0
  for (int i = tid;
       i < static_cast<int>((kGated ? 2 : 1) * L::kSBytes / 16);
       i += kThreads)
    reinterpret_cast<uint4*>(s_sh)[i] = make_uint4(0, 0, 0, 0);
  if (kD == kThreads || tid < kD) z_sh[tid] = 0.f;
  if (tid < kPart) p_sh[tid] = 0.f;
  sm90::fence_async_smem();
  __syncthreads();
  if (tid == 0) load_chunk(0);

  float st[kD / 2];  // S^T: rows (values) 16 warp + g (+ 8), columns 8 a +
                     // 2 tq
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) st[i] = 0.f;
  const int row0 = 16 * warp + g;  // this thread's rows of a chunk: +0, +8
  // gated: the decayed count of the earlier tokens (P's normalizer entry),
  // the same in every thread; the chunk's log decays
  [[maybe_unused]] float count = 0.f;
  [[maybe_unused]] float ld_cur[2] = {0.f, 0.f};
  if constexpr (kGated) load_ld(0, ld_cur);

  for (int c = 0; c < chunks; ++c) {
    const int t0 = c * kChunk;
    // every thread is done with chunk c - 1: its o is staged, the bf16
    // copy of S^T, z and P it wrote are complete, its k and v (and the
    // (w o v) tiles) are free
    __syncthreads();
    if (tid == 0 && c > 0) store_o(c - 1);
    __syncwarp();
    [[maybe_unused]] float ld_next[2] = {0.f, 0.f};
    if constexpr (kGated) {
      if (c + 1 < chunks) load_ld(c + 1, ld_next);
    }
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
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::mma_ss_n64(sc, sm90::desc_k<kChunk>(q_t, kk),
                       sm90::desc_k<kChunk>(k_t, kk), kk);
    sm90::mma_commit();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(q_t, kk),
                       sm90::desc_k<kPart>(s_t, kk), kk);
    if constexpr (kGated) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        sm90::mma_ss_n64(acc, sm90::desc_k<kChunk>(q_t, kk),
                         sm90::desc_k<kPart>(
                             reinterpret_cast<const bf16*>(s_lo), kk), 1);
    }
    sm90::mma_commit();

    // behind the products, in f32 on the CUDA cores: q . z of this
    // thread's rows (a quad splits the D / 8 chunks of 16 bytes of a row),
    // and the next chunk's z and P (a thread a column of k; of v the first
    // 64 threads at D = 128, the last 64 at D = 64); gated: cl (cd::scan),
    // the hi and lo (w o v) tiles, and each sum weighted by w and decayed
    // by 2^total
    const float* z_cur = z_sh + (c % 2) * kD;
    const float* p_cur = p_sh + (c % 2) * kPart;
    float qz[2];
    cd::row_dot<kBox, kD>(stage, z_cur, row0, tq, qz);
    [[maybe_unused]] cd::Cumsum cl;
    [[maybe_unused]] float w_tok[2] = {1.f, 1.f};  // w of tokens 2l, 2l + 1
    [[maybe_unused]] float e_total = 1.f;
    if constexpr (kGated) {
      cl = cd::scan(ld_cur, lane);
      cd::weighted_v<true, kThreads>(cl, stage + 2 * kQKBytes, wv_hi, wv_lo,
                                     tid);
      w_tok[0] = sm90::exp2_ftz(cl.total - cl.even);
      w_tok[1] = sm90::exp2_ftz(cl.total - cl.odd);
      e_total = sm90::exp2_ftz(cl.total);
    }
    // w of token t (the same t in every lane)
    [[maybe_unused]] auto w_at = [&](int t) {
      return __shfl_sync(0xffffffffu, w_tok[t & 1], t / 2);
    };
    if (kD == kThreads || tid < kD) {
      const int d = tid;
      const unsigned char* col = stage + kQKBytes + (d / 64) * kBox;
      float sum = 0.f;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
        const float x = __bfloat162float(*reinterpret_cast<const bf16*>(
            col + t * 128 + ((((d % 64) / 8) ^ (t % 8)) * 16) + (d % 8) * 2));
        if constexpr (kGated)
          sum = fmaf(w_at(t), x, sum);
        else
          sum += x;
      }
      z_sh[((c + 1) % 2) * kD + d] =
          kGated ? fmaf(e_total, z_cur[d], sum) : z_cur[d] + sum;
    }
    if (kD == kThreads ? tid < kPart : tid >= kD) {
      const int d = kD == kThreads ? tid : tid - kD;
      const unsigned char* vcol = stage + 2 * kQKBytes;
      float vsum = 0.f;
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) {
        const float x = __bfloat162float(*reinterpret_cast<const bf16*>(
            vcol + t * 128 + (((d / 8) ^ (t % 8)) * 16) + (d % 8) * 2));
        if constexpr (kGated)
          vsum = fmaf(w_at(t), x, vsum);
        else
          vsum += x;
      }
      p_sh[((c + 1) % 2) * kPart + d] =
          kGated ? fmaf(e_total, p_cur[d], vsum) : p_cur[d] + vsum;
    }
    [[maybe_unused]] float cl_col[16], cl_row[2];
    if constexpr (kGated) {
      cl.cols(tq, cl_col);
      cl_row[0] = cl.at(row0);
      cl_row[1] = cl.at(row0 + 8);
    }
    if (tid == 0 && c + 1 < chunks) {
      // chunk c + 1 into the stage of chunk c - 1, once the store of that
      // chunk's o has read it
      sm90::bulk_wait<0, true>();
      load_chunk(c + 1);
    }
    __syncwarp();
    sm90::mma_wait<0>();  // q k^T and q S
    sm90::pin(sc);
    sm90::pin(acc);

    float g_row[2];
    uint32_t pa[kChunk / 16][4];
    [[maybe_unused]] uint32_t pl[kChunk / 16][4];
    if constexpr (!kGated) {
      // g from the f32 scores, then A in place
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        const int j = 8 * (i / 4) + 2 * tq + (i & 1);
        const bool in = j <= row0 + 8 * r;
        rs[r] += in ? sc[i] : 0.f;
        sc[i] = in ? fmaf(b, sc[i], a) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        g_row[r] = a * static_cast<float>(t0 + row0 + 8 * r + 1) +
                   b * (rs[r] + qz[r]);
      }
      sm90::to_a<kChunk / 16>(pa, sc);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = fmaf(b, acc[i], a * p_cur[8 * (i / 4) + 2 * tq + (i & 1)]);
    } else {
      // A in f32, decayed and masked; g from its row sums
#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = fmaf(b, sc[i], a);
      cd::decay_mask<true>(sc, cl_row, cl_col, warp, tq, row0);
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 32; ++i) rs[(i >> 1) & 1] += sc[i];
      const float e_row[2] = {sm90::exp2_ftz(cl_row[0]),
                              sm90::exp2_ftz(cl_row[1])};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        g_row[r] = fmaf(e_row[r], fmaf(b, qz[r], a * count), rs[r]);
      }
      sm90::to_a_split<kChunk / 16>(pa, pl, sc);
#pragma unroll
      for (int i = 0; i < 32; ++i)
        acc[i] = e_row[(i >> 1) & 1] *
                 fmaf(b, acc[i], a * p_cur[8 * (i / 4) + 2 * tq + (i & 1)]);
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) st[i] *= e_total;
      // the next chunk's count: 2^total n + Σ w, summed over the warp
      float wsum = w_tok[0] + w_tok[1];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        wsum += __shfl_xor_sync(0xffffffffu, wsum, off);
      count = fmaf(e_total, count, wsum);
      // the (w o v) tiles for the state update
      sm90::fence_async_smem();
    }
    // no product or thread reads q or S^T's copy any more (gated: the
    // (w o v) tiles are whole)
    __syncthreads();
    sm90::pin(acc);
    sm90::pin(st);
    sm90::pin(pa);
    if constexpr (kGated) sm90::pin(pl);
    sm90::mma_fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      sm90::mma_rs_n64(acc, pa[kk], sm90::desc_mn<kChunk>(v_t, kk), 1);
    if constexpr (kGated) {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_rs_n64(acc, pl[kk], sm90::desc_mn<kChunk>(v_t, kk), 1);
    }
    sm90::mma_commit();
    if constexpr (kGated) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int kk = 0; kk < kChunk / 16; ++kk)
          sm90::mma_ss<1, 1>(
              st,
              sm90::desc_mn<kChunk>(
                  reinterpret_cast<const bf16*>(x ? wv_lo : wv_hi), kk),
              sm90::desc_mn<kChunk>(k_t, kk), 1);
    } else {
#pragma unroll
      for (int kk = 0; kk < kChunk / 16; ++kk)
        sm90::mma_ss<1, 1>(st, sm90::desc_mn<kChunk>(v_t, kk),
                           sm90::desc_mn<kChunk>(k_t, kk), 1);
    }
    sm90::mma_commit();

    sm90::mma_wait<1>();  // f, while the state update runs
    sm90::pin(acc);
    sm90::pin(pa);
    if constexpr (kGated) sm90::pin(pl);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float den = g_row[(i >> 1) & 1];
      acc[i] = fabsf(den) < kSafeEps ? 0.f : acc[i] / den;
    }
    sm90::store_tile<kPart / 8>(stage_of(c), acc);
    if (part == 0 && tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = t0 + row0 + 8 * r;
        if (row < n) g_out[static_cast<size_t>(bh) * n + row] = g_row[r];
      }
    }
    sm90::mma_wait<0>();
    sm90::pin(st);
    // the bf16 copy (gated: the hi + lo copies) of S^T, the K-major B of
    // the next readout
    if constexpr (kGated)
      sm90::store_tile_split<kD / 8>(s_sh, s_lo, st);
    else
      sm90::store_tile<kD / 8>(s_sh, st);
    sm90::fence_async_smem();
    if constexpr (kGated) {
      ld_cur[0] = ld_next[0];
      ld_cur[1] = ld_next[1];
    }
  }
  __syncthreads();
  if (tid == 0) {
    store_o(chunks - 1);
    sm90::bulk_wait<0, false>();
  }
}

}  // namespace lc

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

// Shared-memory row of one token: D floats in G row groups of D/G, each
// followed by 4 floats of padding.
template <int D, int G = 4>
struct Rows {
  static constexpr int kGroup = D / G;
  static constexpr int kPadded = D + 4 * G;
  __device__ static int at(int r) { return r + 4 * (r / kGroup); }
};

// The walk's thread layout at (Dk, Dv).  Value thread (cg, rg) owns value
// columns 4cg..4cg+3 and state rows rg*Dk/RG..(rg+1)*Dk/RG-1: RG = 4 row
// groups where Dk = Dv, 8 where Dk > Dv ((192, 128): 4 x 24 state floats a
// thread instead of 4 x 48, which would not fit the registers).  kWork =
// RG Dv / 4 value threads, rounded up to whole warps (kValue) so the
// normalizer warp after them starts on a warp boundary; threads kWork.. of
// the last value warp (at D = 112, its lanes 16..31) only stage and wait.
// kBound, the launch bound, rounds the block up to 4 warps: an SM gives
// each of its four schedulers a quarter of the register file, so 9 warps
// (at (192, 128)) have 3 on one scheduler and ptxas must keep a thread
// under 16,384 / (3 x 32) registers.
template <int DK, int DV>
struct Walk {
  static constexpr int kRowGroups = DK == DV ? 4 : 8;
  static constexpr int kWork = kRowGroups * DV / 4;
  static constexpr int kValue = (kWork + 31) / 32 * 32;
  static constexpr int kThreads = kValue + 32;
  static constexpr int kBound = (kThreads + 127) / 128 * 128;
};

// The lanes of thread tid's warp that are among the first kWorkers threads:
// the members of the value threads' shuffles.
template <int kWorkers>
__device__ __forceinline__ unsigned value_mask(int tid) {
  const int live = kWorkers - (tid & ~31);
  return live >= 32 ? 0xffffffffu : (1u << live) - 1u;
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

// Stage `len` contiguous rows of D values from device memory into the
// padded shared-memory rows `dst` (Rows<D, G>) as f32, 16 bytes per load;
// unrolled so that each thread keeps several loads in flight (the loads'
// latency, not their bytes, bounds the staging).  The caller guarantees
// 16-byte aligned rows.
template <int D, int G, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int len,
                                           int tid, int nthr) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll 4
  for (int idx = tid; idx < len * (D / V); idx += nthr) {
    const int e = idx * V;
    const int t = e / D;
    float vals[V];
    load16(src + e, vals);
    float* row = dst + t * Rows<D, G>::kPadded;
    // each 4 values to their own place: a load of 8 bf16 values may
    // straddle a row group where D / G is not a multiple of 8 (D = 112)
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(row + Rows<D, G>::at(e - t * D + i)) =
          make_float4(vals[i], vals[i + 1], vals[i + 2], vals[i + 3]);
  }
}

template <typename T, int DK, int DV, bool kGated>
__global__ void __launch_bounds__(Walk<DK, DV>::kBound)
    la_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const float* __restrict__ ld,
                  T* __restrict__ o, float* __restrict__ g, int heads,
                  int kv_heads, int n, int stage, float a, float b) {
  using W = Walk<DK, DV>;
  constexpr int RG = W::kRowGroups;
  using LK = Rows<DK, RG>;  // q and k rows
  using LV = Rows<DV>;      // v rows
  constexpr int R = LK::kGroup;    // rows of a thread's tile
  constexpr int DPK = LK::kPadded;
  constexpr int DPV = LV::kPadded;
  constexpr int VT = W::kValue;
  constexpr int R2 = (DK + 31) / 32;  // rows per lane of the normalizer warp
  extern __shared__ __align__(16) float smem[];  // read as float4
  float* q_sh = smem;                 // (stage, DPK)
  float* k_sh = q_sh + stage * DPK;   // (stage, DPK)
  float* v_sh = k_sh + stage * DPK;   // (stage, DPV)
  float* f_sh = v_sh + stage * DPV;   // (stage, DV+1) un-normalized output
  float* gam_sh = f_sh + stage * (DV + 1);  // (stage,) decays (gated only)

  const int bh = blockIdx.x;  // batch * heads + query head
  const int bi = bh / heads;
  const int hi = bh - bi * heads;
  const int group = heads / kv_heads;
  const size_t ld_base = (static_cast<size_t>(bi) * kv_heads + hi / group) * n;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int rg = tid % RG;  // value threads: row group
  const int cg = tid / RG;  // value threads: column group
  const int lane = tid - VT;  // normalizer warp

  float s[4][R];  // value threads: S[rg*R + i, 4cg + c]
  float p[4];     // value threads: P[4cg + c]
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p[c] = 0.0f;
#pragma unroll
    for (int i = 0; i < R; ++i) s[c][i] = 0.0f;
  }
  float ks[R2];   // normalizer warp: S[lane*R2 + r, Dv] = running sum of k
#pragma unroll
  for (int r = 0; r < R2; ++r) ks[r] = 0.0f;
  float count = 0.0f;  // normalizer warp, gated: P[Dv], the decayed count

  for (int t0 = 0; t0 < n; t0 += stage) {
    const int len = min(stage, n - t0);
    const size_t q_row = (static_cast<size_t>(bh) * n + t0) * DK;
    const size_t o_row = (static_cast<size_t>(bh) * n + t0) * DV;
    const size_t k_row = (ld_base + t0) * DK;
    const size_t v_row = (ld_base + t0) * DV;
    stage_rows<DK, RG>(q_sh, q + q_row, len, tid, nthr);
    stage_rows<DK, RG>(k_sh, k + k_row, len, tid, nthr);
    stage_rows<DV, 4>(v_sh, v + v_row, len, tid, nthr);
    if constexpr (kGated) {
      for (int t = tid; t < len; t += nthr)
        gam_sh[t] = expf(ld[ld_base + t0 + t]);
    }
    __syncthreads();

    if (tid < W::kWork) {
      const unsigned vmask = value_mask<W::kWork>(tid);
      for (int t = 0; t < len; ++t) {
        [[maybe_unused]] const float gam = kGated ? gam_sh[t] : 1.0f;
        const float4 vv = *reinterpret_cast<const float4*>(
            v_sh + t * DPV + LV::at(4 * cg));
        const float vc[4] = {vv.x, vv.y, vv.z, vv.w};
        const float4* qt =
            reinterpret_cast<const float4*>(q_sh + t * DPK + rg * (R + 4));
        const float4* kt =
            reinterpret_cast<const float4*>(k_sh + t * DPK + rg * (R + 4));
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int i4 = 0; i4 < R / 4; ++i4) {
          const float4 kk4 = kt[i4];
          const float4 qq4 = qt[i4];
          const float kk[4] = {kk4.x, kk4.y, kk4.z, kk4.w};
          const float qq[4] = {qq4.x, qq4.y, qq4.z, qq4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              if constexpr (kGated)
                s[c][4 * i4 + r] = fmaf(kk[r], vc[c], gam * s[c][4 * i4 + r]);
              else
                s[c][4 * i4 + r] += kk[r] * vc[c];
              acc[c] += qq[r] * s[c][4 * i4 + r];
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // the RG row groups of a column group are adjacent lanes
#pragma unroll
          for (int off = 1; off < RG; off <<= 1)
            acc[c] += __shfl_xor_sync(vmask, acc[c], off);
          if constexpr (kGated)
            p[c] = fmaf(gam, p[c], vc[c]);
          else
            p[c] += vc[c];
        }
        if (rg == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            f_sh[t * (DV + 1) + 4 * cg + c] = a * p[c] + b * acc[c];
        }
      }
    } else if (tid >= VT) {
      for (int t = 0; t < len; ++t) {
        [[maybe_unused]] const float gam = kGated ? gam_sh[t] : 1.0f;
        float part = 0.0f;
#pragma unroll
        for (int r = 0; r < R2; ++r) {
          if (DK % 32 == 0 || lane * R2 + r < DK) {
            const int at = t * DPK + LK::at(lane * R2 + r);
            if constexpr (kGated)
              ks[r] = fmaf(gam, ks[r], k_sh[at]);
            else
              ks[r] += k_sh[at];
            part += q_sh[at] * ks[r];
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if constexpr (kGated)
          count = fmaf(gam, count, 1.0f);
        else
          count = static_cast<float>(t0 + t + 1);
        if (lane == 0) f_sh[t * (DV + 1) + DV] = a * count + b * part;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < len * DV; idx += nthr) {
      const int t = idx / DV;
      const int jj = idx - t * DV;
      const float den = f_sh[t * (DV + 1) + DV];
      const float val =
          fabsf(den) < kSafeEps ? 0.0f : f_sh[t * (DV + 1) + jj] / den;
      o[o_row + idx] = from_f32<T>(val);
    }
    for (int t = tid; t < len; t += nthr)
      g[static_cast<size_t>(bh) * n + t0 + t] = f_sh[t * (DV + 1) + DV];
    __syncthreads();  // the next iteration overwrites the staging
  }
}

// The launch of la_fwd / gla_fwd, shared by the launcher and `la_fwd_plan`:
// f(Type<T>{}, kernel, geometry, Int<wgmma>{}) for the instantiation a
// call with these arguments runs.  Both entries in bf16 at Dk = Dv = 128,
// and la_fwd at 64, run the chunked wgmma body (gla_fwd its kGated
// instance): D / 64 blocks per (batch, query head), one per part of 64
// value columns, walking chunks of lc::kChunk tokens, which `stage` must
// name.  Otherwise the token walk
// at a pair of plan::with_walk_dims: one block per (batch, query head);
// Walk<Dk, Dv>'s value threads and the normalizer warp; `stage` tokens
// staged per iteration, shrunk to fit kMaxSmem.
template <bool kGated, typename F>
cudaError_t with_launch(int dtype, int dk, int dv, int batch, int heads,
                        int stage, F&& f) {
  return plan::with_dtype(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (plan::chunked_dims<kGated>(dk, dv)) {
        if (stage != lc::kChunk) return cudaErrorInvalidValue;
        return plan::with_chunked_dim<kGated>(dk, [&](auto dc) {
          constexpr int D = decltype(dc)::value;
          using L = lc::Layout<D, kGated>;
          return f(t, lc::la_fwd_wgmma_kernel<D, kGated>,
                   plan::Geometry{dim3(batch * heads, L::kSplit),
                                  lc::kThreads, L::kSmem, lc::kChunk},
                   plan::Int<1>{});
        });
      }
    }
    return plan::with_walk_dims<kGated>(dk, dv, [&](auto kc, auto vc) {
      constexpr int DK = decltype(kc)::value;
      constexpr int DV = decltype(vc)::value;
      using W = Walk<DK, DV>;
      // the staging's floats per token: q and k, v padded, f, and the decay
      const size_t per_token =
          static_cast<size_t>(2 * Rows<DK, W::kRowGroups>::kPadded +
                              Rows<DV>::kPadded + DV + 1 + (kGated ? 1 : 0)) *
          sizeof(float);
      auto kernel = la_fwd_kernel<T, DK, DV, kGated>;
      return f(t, kernel,
               plan::fit({dim3(batch * heads), W::kThreads, 0, 0}, stage,
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
int run(const void* q, const void* k, const void* v, const void* ld, void* o,
        void* g, int batch, int heads, int kv_heads, int n, int dk, int dv,
        int stage, float a, float b, int dtype, void* stream) {
  if (bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_launch<kGated>(
      dtype, dk, dv, batch, heads, stage,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        if (geo.stage < 1) return cudaErrorInvalidValue;
        if constexpr (decltype(body)::value == 1) {
          CUtensorMap q_map, k_map, v_map, o_map;
          cudaError_t err = sm90::map_rows(&q_map, q, n, batch * heads,
                                           lc::kChunk, dk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&k_map, k, n, batch * kv_heads, lc::kChunk,
                                 dk);
          if (err == cudaSuccess)
            err = sm90::map_rows(&v_map, v, n, batch * kv_heads, lc::kChunk,
                                 dv);
          if (err == cudaSuccess)
            err = sm90::map_rows(&o_map, o, n, batch * heads, lc::kChunk, dv);
          if (err != cudaSuccess) return err;
          return plan::launch(kernel, geo, st, q_map, k_map, v_map, o_map,
                              static_cast<const float*>(ld),
                              static_cast<float*>(g), heads, kv_heads, n, a,
                              b);
        } else {
          return plan::launch(kernel, geo, st, static_cast<const T*>(q),
                              static_cast<const T*>(k),
                              static_cast<const T*>(v),
                              static_cast<const float*>(ld),
                              static_cast<T*>(o), static_cast<float*>(g),
                              heads, kv_heads, n, geo.stage, a, b);
        }
      }));
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Each returns the cudaError_t of its launch (0 = success); the launch is
// asynchronous on `stream`.  Both entries in bf16 at Dk = Dv = 128, and
// la_fwd at 64, run the wgmma body: `stage` must be its chunk (64), and
// its TMA reads need q, k and v 16-byte aligned (the wrappers check it; a
// map that cannot be encoded is refused with cudaErrorInvalidValue).
// `la_fwd` takes q and k (.., dk) and v and o (.., dv).
extern "C" int la_fwd(const void* q, const void* k, const void* v, void* o,
                      void* g, int batch, int heads, int kv_heads, int n,
                      int dk, int stage, float a, float b, int dtype, int dv,
                      void* stream) {
  return run<false>(q, k, v, nullptr, o, g, batch, heads, kv_heads, n, dk,
                    dv, stage, a, b, dtype, stream);
}

// The decay-gated forward: ld (B, Hkv, N) f32 is the per-token log decay;
// Dk = Dv = d.
extern "C" int gla_fwd(const void* q, const void* k, const void* v,
                       const void* ld, void* o, void* g, int batch,
                       int heads, int kv_heads, int n, int d, int stage,
                       float a, float b, int dtype, void* stream) {
  return run<true>(q, k, v, ld, o, g, batch, heads, kv_heads, n, d, d, stage,
                   a, b, dtype, stream);
}

// The geometry a call of `entry` ("la_fwd" or "gla_fwd") with these
// arguments launches, into out[7] (plan.cuh); nothing is launched.  dv is
// Dv (gla_fwd: dk).
extern "C" int la_fwd_plan(const char* entry, int batch, int heads,
                           int kv_heads, int n, int dk, int stage, int dtype,
                           int dv, int64_t* out) {
  const bool gated = strcmp(entry, "gla_fwd") == 0;
  if ((!gated && strcmp(entry, "la_fwd") != 0) ||
      bad_shape(batch, heads, kv_heads, n, stage))
    return static_cast<int>(cudaErrorInvalidValue);
  auto report = [&](auto, auto kernel, const plan::Geometry& geo, auto) {
    return plan::report(kernel, geo, out);
  };
  return static_cast<int>(
      gated ? with_launch<true>(dtype, dk, dv, batch, heads, stage, report)
            : with_launch<false>(dtype, dk, dv, batch, heads, stage, report));
}

extern "C" const char* la_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
