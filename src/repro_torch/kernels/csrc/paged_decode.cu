// Paged-KV softmax decode for Hopper (sm_90a): two entry points.
//
// Replaces the TPU kernels `paged_attention_pallas`
// (src/repro/kernels/paged_attention.py:149; body `_decode_kernel`, :97)
// and `paged_decode_fused_pallas` (src/repro/kernels/decode_fused.py:333;
// body `_paged_fused_kernel`, :289).  One call attends every slot's new
// query token to its first lengths[b] keys, which live in a shared arena of
// fixed-size pages:
//
//   key j of slot b: row j % ps of page page_table[b, j / ps], KV head hk
//   s_j = scale * q . k_j for j < min(lengths[b], Pmax * ps)
//   o   = sum_j softmax(s)_j v_j      (online softmax, f32, divide here)
//   a slot of length 0 yields zeros, as both Pallas kernels do
//
// Shapes (contiguous): q (B, H, 1, D), k_pages and v_pages
// (P, Hkv, ps, D), page_table (B, Pmax) int32, lengths (B,) int32,
// o (B, H, 1, D), with H = G * Hkv and query head h reading KV head h / G.
// T is float or bf16; any ps >= 1.
//
//   paged_attention     the walk, one block per (slot, query head): R = 1
//   paged_decode_fused  the cluster-split page stream (namespace pc) where
//                       its ring of two pages fits (at D = 128 pages of up
//                       to 194-224 rows in bf16, 102-112 in f32, by G),
//                       else the walk with one block per (slot, KV
//                       head) for its R = G query rows; both read each
//                       page once per KV head (the Pallas kernel's
//                       head-fold)
//
// What bounds it: reading the live keys' pages.  At B=8, Hkv=16, D=128,
// ps=16 and 544 live keys a call reads 2 * 8*16*544*128 * 2 B ~= 35.7 MB,
// ~10.7 us at 3.35 TB/s, for 2 flops per byte (an estimate from the
// shapes, not a measurement); the table adds 4 B per page.
//
// Design of the walk (simple first):
//   * the block stages its slot's live table entries (ceil(len / ps) of
//     them) in shared memory once, checking each names an arena page (an
//     entry outside the arena traps: no read outside it);
//   * the walk is decode_common.cuh's `attend`, the contiguous kernel's:
//     warps on interleaved keys, a lane per D/32 columns with several
//     rows' loads in flight, an online softmax per warp merged in shared
//     memory, the guarded divide; only where key j's row lies differs.  A
//     key's row is D contiguous elements whatever the page size, so a
//     warp's loads stay coalesced for any ps;
//   * the walk stops at min(lengths[b], Pmax * ps): a retired slot whose
//     position ran past its table reads no entry beyond the table's last.
// The TPU kernels' pages_per_block tiling amortises sequential grid steps,
// which CUDA does not have: a block walks all its pages itself.
//
// Design of the cluster-split page stream (pc; the walk runs one block of
// 8 warps per (slot, KV head), 128 blocks, each with at most 16 KB of
// loads in flight and the next load issued only after the last key's
// softmax, a 5-step shuffle chain and two expf per key):
//   * a cluster of kCluster blocks per (slot, KV head), B Hkv kCluster
//     blocks (512 at the serving shape, several an SM); block r takes the
//     contiguous span [r n, min((r + 1) n, live)) of the slot's live
//     pages, n = ceil(live / kCluster), and stages that span's table
//     entries, each checked against the arena (an entry outside traps);
//   * (page, hk)'s ps rows are ps D contiguous elements: each page of K
//     and of V for the KV head is one 1-D bulk copy (`cp.async.bulk`) of
//     its live rows only, both counted on one mbarrier, into a ring of
//     up to kRing stages, all issued at once; a stage takes the page
//     `stages` later once every thread has read it, a page behind;
//   * per staged page: the G x rows scores from shared memory, kLanes
//     lanes a key (a 3-step shuffle over 16-byte chunks, every key of the
//     page at once; q's chunks in registers where they fit) and each
//     warp's max over its keys; one max and one rescale per page as the
//     Pallas body takes them: m_new = max(m, the warps' maxima), p =
//     exp(s - m_new) a (row, key) pair a thread, the running max kept by
//     page parity so no thread overwrites one another still reads; then
//     acc = corr acc + P V and l = corr l + sum p in f32 registers, a
//     thread per column and row class: no per-key chain, no divide by ps;
//   * two block barriers a page: after the scores and maxima, after p;
//   * each block leaves its (m, l, acc) in its shared memory; after a
//     cluster barrier rank 0 reads its peers' through distributed shared
//     memory, merges them in rank order, divides with the guard and
//     writes o; a second cluster barrier keeps every block resident until
//     then.  One launch, no workspace, no atomics, o bit-deterministic; a
//     block with an empty span leaves m = -1e30, l = 0, acc = 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "plan.cuh"
#include "sm90.cuh"

namespace {

using decode::kMaxWarps;

// key j of a slot: row j % ps of KV head hk of page table[j / ps]
template <int D>
struct PagedRows {
  const int* table;  // the slot's live entries, in shared memory
  int kv_heads, hk, page_size;
  __device__ size_t operator()(int j) const {
    const int page = table[j / page_size];
    return ((static_cast<size_t>(page) * kv_heads + hk) * page_size +
            j % page_size) *
           D;
  }
};

// R query rows per block: heads h0 .. h0 + R - 1 of slot b, all reading KV
// head h0 / G (R is 1 or G)
template <typename T, int D, int R>
__global__ void paged_decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pages,
    const T* __restrict__ v_pages, const int* __restrict__ page_table,
    const int* __restrict__ lengths, T* __restrict__ o, int heads,
    int kv_heads, int num_pages, int page_size, int pmax, float scale) {
  extern __shared__ float smem[];
  const int row_groups = heads / R;
  const int b = blockIdx.x / row_groups;
  const int h0 = (blockIdx.x % row_groups) * R;
  const int hk = h0 / (heads / kv_heads);
  const int len = max(0, min(lengths[b], pmax * page_size));
  const int live_pages = (len + page_size - 1) / page_size;
  int* table = reinterpret_cast<int*>(
      smem + decode::merge_floats(blockDim.x >> 5, R, D));
  const int* row = page_table + static_cast<size_t>(b) * pmax;
  for (int i = threadIdx.x; i < live_pages; i += blockDim.x) {
    const int page = row[i];
    if (page < 0 || page >= num_pages) __trap();
    table[i] = page;
  }
  __syncthreads();
  const size_t rows = (static_cast<size_t>(b) * heads + h0) * D;
  const PagedRows<D> key_row{table, kv_heads, hk, page_size};
  decode::attend<T, D, R>(q + rows, k_pages, v_pages, len, key_row,
                          o + rows, scale, smem);
}

}  // namespace

namespace pc {

constexpr int kCluster = 4;   // blocks per (slot, KV head)
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 4;      // pages in flight per block, at most
constexpr int kMinStages = 2;
constexpr size_t kMaxSmem = 232448;

// A key row of D elements of T as 16-byte chunks: lanes [0, kLanes) of a
// key each own chunks sub, sub + kLanes, ... (neighbouring lanes read
// neighbouring chunks); kSlots keys are scored at once.
template <typename T, int D>
struct Row {
  static_assert(D * sizeof(T) % 16 == 0, "rows of 16-byte chunks");
  static constexpr int kChunks = D * static_cast<int>(sizeof(T)) / 16;
  static constexpr int kLanes = kChunks < 8 ? kChunks : 8;
  static constexpr int kPerLane = kChunks / kLanes;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(T));
  static constexpr int kSlots = kThreads / kLanes;
  static_assert(kChunks % kLanes == 0 && 32 % kLanes == 0, "chunks");
  // position (in floats) of q's column `col` of row g in the staged copy:
  // for each (g, lane chunk i, 4-float part h) the kLanes lanes' float4
  // are consecutive, so a key's lanes read 16 kLanes contiguous bytes
  __device__ static int q_pos(int g, int col) {
    const int c = col / kElems, e = col % kElems;
    const int sub = c % kLanes, i = c / kLanes;
    return (((g * kPerLane + i) * (kElems / 4) + e / 4) * kLanes + sub) * 4 +
           e % 4;
  }
};

// Byte offsets of the body's shared memory: the ring of `stages` pages of
// K and V rows (after the stream, the block's acc, G x D f32), the scaled
// query rows (G x D f32), the scores and the probabilities (G x ps f32
// each), the warps' page maxima (kWarps x G f32), the running max by page
// parity (2 x G f32), l and the final max (G f32 each), the span's table
// entries, then an mbarrier per stage.
struct Layout {
  size_t page, stage, q, sc, pb, wm, m, l, mfin, table, bars, total;
};

__host__ __device__ inline size_t span_max(int pmax) {
  return (static_cast<size_t>(pmax) + kCluster - 1) / kCluster;
}

__host__ __device__ inline Layout layout(int size, int d, int ps, int pmax,
                                         int group, int stages) {
  Layout l;
  const size_t rows = static_cast<size_t>(group) * sizeof(float);
  l.page = static_cast<size_t>(ps) * d * size;
  l.stage = 2 * l.page;
  const size_t ring = stages * l.stage;
  const size_t acc = rows * d;
  l.q = ((ring > acc ? ring : acc) + 15) / 16 * 16;
  l.sc = l.q + acc;
  l.pb = l.sc + rows * ps;
  l.wm = l.pb + rows * ps;
  l.m = l.wm + rows * kWarps;
  l.l = l.m + 2 * rows;
  l.mfin = l.l + rows;
  l.table = l.mfin + rows;
  l.bars = (l.table + span_max(pmax) * sizeof(int) + 7) / 8 * 8;
  l.total = l.bars + stages * sizeof(uint64_t);
  return l;
}

// the most stages, at most kRing and one per page of the longest span, at
// least kMinStages, whose layout fits kMaxSmem
inline int stages_for(int size, int d, int ps, int pmax, int group) {
  int stages = static_cast<int>(
      std::max<size_t>(kMinStages, std::min<size_t>(kRing, span_max(pmax))));
  while (stages > kMinStages &&
         layout(size, d, ps, pmax, group, stages).total > kMaxSmem)
    --stages;
  return stages;
}

// whether the body takes these shapes: a ring of kMinStages pages fits
// (a page's rows for one KV head are 16-byte-aligned contiguous bytes at
// every head dim plan::with_head_dim admits; Row asserts it)
inline bool takes(int size, int d, int ps, int pmax, int group) {
  return layout(size, d, ps, pmax, group, kMinStages).total <= kMaxSmem;
}

template <typename T>
__device__ __forceinline__ void chunk_f32(float (&dst)[16 / sizeof(T)],
                                          const unsigned char* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* vals = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < static_cast<int>(16 / sizeof(T)); ++e)
    dst[e] = decode::to_f32(vals[e]);
}

// Cluster (b, hk), block `rank`: its span of the slot's live pages, then
// the rank-order merge by rank 0.  k_pages and v_pages 16-byte aligned
// (the launcher checks it).
template <typename T, int D, int G>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    paged_cluster_kernel(const T* __restrict__ q,
                         const T* __restrict__ k_pages,
                         const T* __restrict__ v_pages,
                         const int* __restrict__ page_table,
                         const int* __restrict__ lengths, T* __restrict__ o,
                         int kv_heads, int num_pages, int page_size,
                         int pmax, int stages, float scale) {
  using R = Row<T, D>;
  static_assert(kThreads % D == 0, "a column per thread and row class");
  constexpr int kRowClasses = kThreads / D;
  constexpr int kRows = (G + kRowClasses - 1) / kRowClasses;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(sizeof(T), D, page_size, pmax, G, stages);
  float* q_sh = reinterpret_cast<float*>(smem + l.q);
  float* sc = reinterpret_cast<float*>(smem + l.sc);
  float* pb = reinterpret_cast<float*>(smem + l.pb);
  float* wm = reinterpret_cast<float*>(smem + l.wm);   // (kWarps, G)
  float* m_sh = reinterpret_cast<float*>(smem + l.m);  // (2, G)
  float* l_sh = reinterpret_cast<float*>(smem + l.l);
  float* mfin = reinterpret_cast<float*>(smem + l.mfin);
  int* table = reinterpret_cast<int*>(smem + l.table);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cl = blockIdx.x / kCluster;
  const uint32_t rank = sm90::cluster_rank();
  const int b = cl / kv_heads, hk = cl % kv_heads;
  const int heads = kv_heads * G;
  const int ps = page_size;
  const int len = max(0, min(lengths[b], pmax * ps));
  const int live = (len + ps - 1) / ps;
  const int span = (live + kCluster - 1) / kCluster;
  const int first = min(static_cast<int>(rank) * span, live);
  const int n = min(first + span, live) - first;

  const int* row = page_table + static_cast<size_t>(b) * pmax + first;
  for (int i = tid; i < n; i += kThreads) {
    const int page = row[i];
    if (page < 0 || page >= num_pages) __trap();
    table[i] = page;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_sh[g] = decode::kNegInf;  // page 0's running max
    l_sh[g] = 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) sm90::bar_init(&full[i], 1);
    sm90::bar_init_fence();
  }
  __syncthreads();

  // the live rows of page c of the span, K then V, into its stage
  auto rows_of = [&](int c) { return min(ps, len - (first + c) * ps); };
  auto load = [&](int c) {
    const uint32_t bytes =
        static_cast<uint32_t>(rows_of(c) * D * sizeof(T));
    const size_t at = (static_cast<size_t>(table[c]) * kv_heads + hk) *
                      ps * D;
    unsigned char* dst = smem + (c % stages) * l.stage;
    uint64_t* bar = &full[c % stages];
    sm90::bar_expect(bar, 2 * bytes);
    sm90::bulk_load(dst, k_pages + at, bytes, bar);
    sm90::bulk_load(dst + l.page, v_pages + at, bytes, bar);
  };
  if (tid == 0)
    for (int c = 0; c < min(stages, n); ++c) load(c);

  const T* q_rows = q + (static_cast<size_t>(b) * heads + hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads)
    q_sh[R::q_pos(i / D, i % D)] = decode::to_f32(q_rows[i]) * scale;
  __syncthreads();

  const int sub = tid % R::kLanes, slot = tid / R::kLanes;
  const int col = tid % D, rc = tid / D;
  // q's float4 (g, lane chunk i, part h) of this lane: in registers where
  // the group's fit 64 floats, else read from shared memory
  constexpr int kParts = R::kPerLane * (R::kElems / 4);
  constexpr bool kQRegs = G * kParts * 4 <= 64;
  const float4* q4 = reinterpret_cast<const float4*>(q_sh);
  float4 q_reg[kQRegs ? G * kParts : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int x = 0; x < G * kParts; ++x) q_reg[x] = q4[x * R::kLanes + sub];
  }
  auto q_part = [&](int x) {
    if constexpr (kQRegs)
      return q_reg[x];
    else
      return q4[x * R::kLanes + sub];
  };
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;

  for (int c = 0; c < n; ++c) {
    sm90::bar_wait(&full[c % stages], (c / stages) & 1);
    const unsigned char* kst = smem + (c % stages) * l.stage;
    const T* vst = reinterpret_cast<const T*>(kst + l.page);
    const int rows = rows_of(c);
    const float* m_old = m_sh + (c & 1) * G;
    float* m_new = m_sh + ((c + 1) & 1) * G;

    // scores: the page's keys kSlots at a time, kLanes lanes a key; each
    // warp's max over its keys per query row
    float mx[G];
#pragma unroll
    for (int g = 0; g < G; ++g) mx[g] = decode::kNegInf;
    for (int j0 = 0; j0 < rows; j0 += R::kSlots) {
      const int j = j0 + slot;
      float kr[R::kPerLane][R::kElems];
#pragma unroll
      for (int i = 0; i < R::kPerLane; ++i) {
        if (j < rows) {
          chunk_f32<T>(kr[i], kst + static_cast<size_t>(j) * D * sizeof(T) +
                                  (sub + R::kLanes * i) * 16);
        } else {
#pragma unroll
          for (int e = 0; e < R::kElems; ++e) kr[i][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float part[2] = {0.f, 0.f};  // two chains of fmaf
#pragma unroll
        for (int i = 0; i < R::kPerLane; ++i) {
#pragma unroll
          for (int h = 0; h < R::kElems / 4; ++h) {
            const int x = i * (R::kElems / 4) + h;
            const float4 qv = q_part(g * kParts + x);
            float& s = part[x & 1];
            s = fmaf(qv.x, kr[i][4 * h], s);
            s = fmaf(qv.y, kr[i][4 * h + 1], s);
            s = fmaf(qv.z, kr[i][4 * h + 2], s);
            s = fmaf(qv.w, kr[i][4 * h + 3], s);
          }
        }
        float s = part[0] + part[1];
#pragma unroll
        for (int off = R::kLanes / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (j < rows) {
          if (sub == 0) sc[g * ps + j] = s;
          mx[g] = fmaxf(mx[g], s);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float v = mx[g];
#pragma unroll
      for (int off = R::kLanes; off < 32; off <<= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) wm[warp * G + g] = v;
    }
    __syncthreads();
    // every thread has read the previous page: its stage takes the page
    // `stages` after it
    if (tid == 0 && c >= 1 && c - 1 + stages < n) load(c - 1 + stages);

    // one max per page and query row, m_new = max(m_old, the page's max),
    // and p = exp(s - m_new), a (row, key) pair a thread
    for (int idx = tid; idx < G * rows; idx += kThreads) {
      const int g = idx / rows, j = idx - g * rows;
      float mp = m_old[g];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mp = fmaxf(mp, wm[w * G + g]);
      pb[g * ps + j] = expf(sc[g * ps + j] - mp);
      if (j == 0) m_new[g] = mp;
    }
    __syncthreads();

    // one rescale per page: acc = corr acc + p V and l = corr l + sum p,
    // column `col` of rows rc, rc + kRowClasses, ... (l by column 0)
    float corr[kRows], psum[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int g = rc + kRowClasses * k;
      corr[k] = g < G ? expf(m_old[g] - m_new[g]) : 0.f;
      acc[k] *= corr[k];
      psum[k] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const float vj = decode::to_f32(vst[j * D + col]);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int g = rc + kRowClasses * k;
        if (g < G) {
          const float pj = pb[g * ps + j];
          acc[k] = fmaf(pj, vj, acc[k]);
          psum[k] += pj;
        }
      }
    }
    if (col == 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int g = rc + kRowClasses * k;
        if (g < G) l_sh[g] = corr[k] * l_sh[g] + psum[k];
      }
    }
  }

  // the ring is read: it takes the block's acc, then the cluster merges
  __syncthreads();
  float* acc_sh = reinterpret_cast<float*>(smem);  // (G, D)
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int g = rc + kRowClasses * k;
    if (g < G) acc_sh[g * D + col] = acc[k];
  }
  for (int g = tid; g < G; g += kThreads) mfin[g] = m_sh[(n & 1) * G + g];
  sm90::cluster_sync();
  if (rank == 0) {
    T* o_rows = o + (static_cast<size_t>(b) * heads + hk * G) * D;
    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int g = idx / D;
      float mr[kCluster], m_all = decode::kNegInf;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        mr[r] = sm90::ld_peer(&mfin[g], r);
        m_all = fmaxf(m_all, mr[r]);
      }
      float l_all = 0.f, a_all = 0.f;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const float f = expf(mr[r] - m_all);
        l_all = fmaf(f, sm90::ld_peer(&l_sh[g], r), l_all);
        a_all = fmaf(f, sm90::ld_peer(&acc_sh[idx], r), a_all);
      }
      // length 0: l_all == 0 and a_all == 0, so the guarded divide gives 0
      const float l_safe = l_all <= 0.f ? 1.f : l_all;
      o_rows[idx] = decode::from_f32<T>(a_all / l_safe);
    }
  }
  // no block leaves while rank 0 may still read its shared memory
  sm90::cluster_sync();
}

}  // namespace pc

namespace {

// The launch of paged_attention / paged_decode_fused, shared by the
// launcher and `paged_decode_plan`: f(Type<T>{}, kernel, geometry,
// Int<body>{}) for the instantiation a call with these arguments runs.
// paged_decode_fused runs the cluster-split page stream (body 1) wherever
// pc::takes the dims: a cluster of pc::kCluster blocks of pc::kThreads
// threads per (slot, KV head), the ring's stages in geometry.stage.
// Otherwise the walk (body 0): one block of `warps` warps per (slot, R
// query rows), R = 1 (paged_attention) or the group G
// (paged_decode_fused); shared memory holds the warps' merge and the
// slot's live table entries (at most Pmax).
template <typename F>
cudaError_t with_launch(bool fold_heads, int dtype, int d, int batch,
                        int heads, int kv_heads, int page_size, int pmax,
                        int warps, F&& f) {
  const int rows = fold_heads ? heads / kv_heads : 1;
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      return plan::with_group(rows, [&](auto rc) {
        using T = typename decltype(t)::type;
        constexpr int D = decltype(dc)::value;
        constexpr int R = decltype(rc)::value;
        constexpr int size = static_cast<int>(sizeof(T));
        if (fold_heads && pc::takes(size, D, page_size, pmax, R)) {
          const int stages = pc::stages_for(size, D, page_size, pmax, R);
          return f(t, pc::paged_cluster_kernel<T, D, R>,
                   plan::Geometry{
                       dim3(batch * kv_heads * pc::kCluster), pc::kThreads,
                       pc::layout(size, D, page_size, pmax, R, stages).total,
                       stages},
                   plan::Int<1>{});
        }
        const size_t smem = decode::merge_floats(warps, R, D) * sizeof(float) +
                            static_cast<size_t>(pmax) * sizeof(int);
        auto kernel = paged_decode_kernel<T, D, R>;
        return f(t, kernel,
                 plan::Geometry{dim3(batch * (heads / R)), warps * 32, smem,
                                1},
                 plan::Int<0>{});
      });
    });
  });
}

bool bad_shape(int batch, int heads, int kv_heads, int num_pages,
               int page_size, int pmax, int warps) {
  return batch <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
         num_pages <= 0 || page_size <= 0 || pmax <= 0 || warps < 1 ||
         warps > kMaxWarps ||
         static_cast<int64_t>(pmax) * page_size > INT32_MAX;
}

int run(bool fold_heads, const void* q, const void* k_pages,
        const void* v_pages, const void* page_table, const void* lengths,
        void* o, int batch, int heads, int kv_heads, int num_pages,
        int page_size, int pmax, int d, int warps, float scale, int dtype,
        void* stream) {
  if (bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, page_size, pmax, warps,
      [&](auto t, auto kernel, const plan::Geometry& geo, auto body) {
        using T = typename decltype(t)::type;
        const cudaStream_t st = static_cast<cudaStream_t>(stream);
        if constexpr (decltype(body)::value == 1) {
          // the bulk copies need the arenas 16-byte aligned
          if (geo.smem > pc::kMaxSmem ||
              reinterpret_cast<uintptr_t>(k_pages) % 16 != 0 ||
              reinterpret_cast<uintptr_t>(v_pages) % 16 != 0)
            return cudaErrorInvalidValue;
          return plan::launch(kernel, geo, st, static_cast<const T*>(q),
                              static_cast<const T*>(k_pages),
                              static_cast<const T*>(v_pages),
                              static_cast<const int*>(page_table),
                              static_cast<const int*>(lengths),
                              static_cast<T*>(o), kv_heads, num_pages,
                              page_size, pmax, geo.stage, scale);
        } else {
          return plan::launch(kernel, geo, st, static_cast<const T*>(q),
                              static_cast<const T*>(k_pages),
                              static_cast<const T*>(v_pages),
                              static_cast<const int*>(page_table),
                              static_cast<const int*>(lengths),
                              static_cast<T*>(o), heads, kv_heads,
                              num_pages, page_size, pmax, scale);
        }
      }));
}

bool bad_entry(const char* entry, bool* fold_heads) {
  *fold_heads = strcmp(entry, "paged_decode_fused") == 0;
  return !*fold_heads && strcmp(entry, "paged_attention") != 0;
}

}  // namespace

// Plain C interface, loaded with ctypes.  dtype: 0 = float32, 1 = bfloat16;
// warps: warps per block of the walk (1..16).  Each returns the
// cudaError_t of its launch (0 = success); the launch is asynchronous on
// `stream`.

// the walk, one block per (slot, query head)
extern "C" int paged_attention(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_table,
                               const void* lengths, void* o, int batch,
                               int heads, int kv_heads, int num_pages,
                               int page_size, int pmax, int d, int warps,
                               float scale, int dtype, void* stream) {
  return run(false, q, k_pages, v_pages, page_table, lengths, o, batch,
             heads, kv_heads, num_pages, page_size, pmax, d, warps, scale,
             dtype, stream);
}

// per (slot, KV head): the cluster-split page stream where pc::takes the
// dims, else the walk; G = heads / kv_heads in {1, 2, 4, 8, 16}
extern "C" int paged_decode_fused(const void* q, const void* k_pages,
                                  const void* v_pages,
                                  const void* page_table,
                                  const void* lengths, void* o, int batch,
                                  int heads, int kv_heads, int num_pages,
                                  int page_size, int pmax, int d, int warps,
                                  float scale, int dtype, void* stream) {
  return run(true, q, k_pages, v_pages, page_table, lengths, o, batch,
             heads, kv_heads, num_pages, page_size, pmax, d, warps, scale,
             dtype, stream);
}

// The geometry a call of `entry` ("paged_attention" or
// "paged_decode_fused") with these arguments launches, into out[7]
// (plan.cuh); nothing is launched.
extern "C" int paged_decode_plan(const char* entry, int batch, int heads,
                                 int kv_heads, int num_pages, int page_size,
                                 int pmax, int d, int warps, int dtype,
                                 int64_t* out) {
  bool fold_heads;
  if (bad_entry(entry, &fold_heads) ||
      bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, page_size, pmax, warps,
      [&](auto, auto kernel, const plan::Geometry& geo, auto) {
        return plan::report(kernel, geo, out);
      }));
}

// The clusters of the same call, into out[2]: blocks per cluster (0 for
// the walk, which launches none) and the most clusters of that kernel the
// card holds at once (cudaOccupancyMaxActiveClusters; 0 for the walk);
// nothing is launched.
extern "C" int paged_decode_cluster_plan(const char* entry, int batch,
                                         int heads, int kv_heads,
                                         int num_pages, int page_size,
                                         int pmax, int d, int warps,
                                         int dtype, int64_t* out) {
  bool fold_heads;
  if (bad_entry(entry, &fold_heads) ||
      bad_shape(batch, heads, kv_heads, num_pages, page_size, pmax, warps))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_launch(
      fold_heads, dtype, d, batch, heads, kv_heads, page_size, pmax, warps,
      [&](auto, auto kernel, const plan::Geometry& geo, auto body) {
        out[0] = out[1] = 0;
        if constexpr (decltype(body)::value == 1) {
          cudaError_t err = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              static_cast<int>(geo.smem));
          if (err != cudaSuccess) return err;
          cudaLaunchAttribute attr;
          attr.id = cudaLaunchAttributeClusterDimension;
          attr.val.clusterDim.x = pc::kCluster;
          attr.val.clusterDim.y = 1;
          attr.val.clusterDim.z = 1;
          cudaLaunchConfig_t cfg = {};
          cfg.gridDim = geo.grid;
          cfg.blockDim = dim3(geo.threads);
          cfg.dynamicSmemBytes = geo.smem;
          cfg.attrs = &attr;
          cfg.numAttrs = 1;
          int clusters = 0;
          err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
          if (err != cudaSuccess) return err;
          out[0] = pc::kCluster;
          out[1] = clusters;
        }
        return cudaSuccess;
      }));
}

extern "C" const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
