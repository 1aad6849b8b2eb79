// The tile stream of the softmax decode kernels: `softmax_decode_fused`
// (softmax_decode_fused.cu, a contiguous KV cache) and `paged_attention`
// and `paged_decode_fused` (paged_decode.cu, a paged KV arena) all run
// `pc::stream_kernel`.
//
// A cell is one slot's R query rows, all reading one KV head hk:
//
//   s_j = scale * q . k_j         for j < len = min(lengths[b], Pmax ps)
//   o   = sum_j softmax(s)_j v_j  (online softmax in f32, divided here)
//
// and a slot of length 0 writes zeros (the guarded divide), as the Pallas
// kernels do.  The keys lie in pages: key j of slot b is row j % ps of KV
// head hk of page table[b, j / ps] in a (P, Hkv, ps, D) arena.  A
// contiguous (B, Hkv, S, D) cache is the same arena with one page of S rows
// per slot and the identity table (page b), which the kernel never reads.
//
// Tiles.  A cell's live keys [0, len) are a run of tiles, each at most
// `tile_rows` rows that lie contiguously in memory: a page of ps <=
// tile_rows rows is one tile; a larger page (the contiguous cache's
// included) is ceil(ps / tile_rows) tiles of tile_rows rows, its last one
// shorter; a tile is cut at len.  The C entries take tile_rows, in [1,
// kMaxTileRows] (the Python wrappers pass DECODE_TILE_ROWS): a ring of two
// tiles of kMaxTileRows rows fits at f32, D = 128 and R = 16, so every
// shape the launchers admit runs the stream.
//
// Design (what bounds the work: reading the live keys once per KV head):
//   * a cluster of kCluster blocks per cell; block r takes the contiguous
//     span [r n, min((r + 1) n, live)) of the cell's live tiles, n =
//     ceil(live / kCluster), and (paged) stages each of its tiles' table
//     entry, checked against the arena (an entry outside traps);
//   * each tile's live rows of K and of V are one 1-D bulk copy each
//     (`cp.async.bulk`), counted on one mbarrier, into a ring of up to
//     kRing stages, all issued at once; a stage takes the tile `stages`
//     later once every thread has read it, a tile behind;
//   * per staged tile: the R x rows scores from shared memory, kLanes
//     lanes a key (a shuffle over 16-byte chunks, kSlots keys at once; q's
//     chunks in registers where they fit) and each warp's max over its
//     keys; one max and one rescale per tile as the Pallas body takes them
//     per page: m_new = max(m, the warps' maxima), p = exp(s - m_new) a
//     (row, key) pair a thread, the running max kept by tile parity so no
//     thread overwrites one another still reads; then acc = corr acc + P V
//     and l = corr l + sum p in f32 registers, a thread per column and row
//     class: no per-key chain;
//   * two block barriers a tile: after the scores and maxima, after p;
//   * each block leaves its (m, l, acc) in its shared memory; after a
//     cluster barrier rank 0 reads its peers' through distributed shared
//     memory, merges them in rank order, divides with the guard and writes
//     o; a second cluster barrier keeps every block resident until then.
//     One launch, no workspace, no atomics, o bit-deterministic; a block
//     with an empty span leaves m = -1e30, l = 0, acc = 0.
// At ps <= tile_rows the tiles are the pages, so the paged kernel's
// arithmetic is the page stream's; a contiguous cache in tiles of ps rows
// gives the bits of the paged kernel over the same keys in pages of ps.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "plan.cuh"
#include "sm90.cuh"

namespace decode {

constexpr float kNegInf = -1e30f;

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

}  // namespace decode

namespace pc {

constexpr int kCluster = 4;   // blocks per cell
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRing = 4;      // tiles in flight per block, at most
constexpr int kMinStages = 2;
constexpr int kMaxTileRows = 64;
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

// A cell's keys as tiles: pages of ps rows, each cut into `sub` tiles of
// at most tr = min(ps, tile_rows) rows (one tile a page where ps <=
// tile_rows).  Tile t is rows [r0, r0 + tr) of the cell's page index t /
// sub, r0 = t % sub * tr, cut at the page's end and at len.
struct Tiling {
  int ps, tr, sub;
  __host__ __device__ Tiling(int page_size, int tile_rows)
      : ps(page_size),
        tr(page_size < tile_rows ? page_size : tile_rows),
        sub((page_size + tr - 1) / tr) {}
  // tiles of the first len keys: the full pages' tiles, then the last's
  __host__ __device__ int live(int len) const {
    const int full = len / ps;
    return full * sub + (len - full * ps + tr - 1) / tr;
  }
};

// Byte offsets of the body's shared memory: the ring of `stages` tiles of
// K and V rows (after the stream, the block's acc, R x D f32), the scaled
// query rows (R x D f32), the scores and the probabilities (R x tr f32
// each), the warps' tile maxima (kWarps x R f32), the running max by tile
// parity (2 x R f32), l and the final max (R f32 each), `table_len` staged
// table entries (0 for the contiguous cache), then an mbarrier per stage.
struct Layout {
  size_t tile, stage, q, sc, pb, wm, m, l, mfin, table, bars, total;
};

__host__ __device__ inline int span_max(int tiles) {
  return (tiles + kCluster - 1) / kCluster;
}

__host__ __device__ inline Layout layout(int size, int d, int tr,
                                         int table_len, int rows,
                                         int stages) {
  Layout l;
  const size_t row_f32 = static_cast<size_t>(rows) * sizeof(float);
  l.tile = static_cast<size_t>(tr) * d * size;
  l.stage = 2 * l.tile;
  const size_t ring = stages * l.stage;
  const size_t acc = row_f32 * d;
  l.q = ((ring > acc ? ring : acc) + 15) / 16 * 16;
  l.sc = l.q + acc;
  l.pb = l.sc + row_f32 * tr;
  l.wm = l.pb + row_f32 * tr;
  l.m = l.wm + row_f32 * kWarps;
  l.l = l.m + 2 * row_f32;
  l.mfin = l.l + row_f32;
  l.table = l.mfin + row_f32;
  l.bars = (l.table + static_cast<size_t>(table_len) * sizeof(int) + 7) /
           8 * 8;
  l.total = l.bars + stages * sizeof(uint64_t);
  return l;
}

// The ring's stages of a launch and its layout: the most stages, at most
// kRing and one per tile of the longest span, at least kMinStages, whose
// layout fits kMaxSmem (the launcher refuses a layout that does not fit
// with kMinStages)
struct Shape {
  int stages;
  Layout l;
};

inline Shape shape_of(int size, int d, int rows, int page_size, int pmax,
                      bool paged, int tile_rows) {
  const Tiling tl(page_size, tile_rows);
  const int span = span_max(pmax * tl.sub);
  const int table_len = paged ? span : 0;
  int stages = std::max(kMinStages, std::min(kRing, span));
  while (stages > kMinStages &&
         layout(size, d, tl.tr, table_len, rows, stages).total > kMaxSmem)
    --stages;
  return Shape{stages, layout(size, d, tl.tr, table_len, rows, stages)};
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

// Cluster `cell` = (slot b, rows h0 .. h0 + R - 1), block `rank`: its span
// of the cell's live tiles, then the rank-order merge by rank 0.  The KV
// head is h0 / (heads / kv_heads).  Three instantiations by the keys'
// layout, each a division-free step from one tile to the next:
//   !kPaged          the contiguous cache: page b of num_pages = B pages of
//                    page_size = S rows, pmax = 1, no table; tile t is
//                    rows [t tr, t tr + tr) of the slot's block
//   kPaged, !kSplit  pages of ps <= tile_rows rows: tile t is page t
//   kPaged, kSplit   pages of ps > tile_rows rows, `sub` tiles a page
// k and v 16-byte aligned (the launcher checks it).
template <typename T, int D, int R, bool kPaged, bool kSplit>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    stream_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const int* __restrict__ page_table,
                  const int* __restrict__ lengths, T* __restrict__ o,
                  int heads, int kv_heads, int num_pages, int page_size,
                  int pmax, int tile_rows, int stages, float scale) {
  static_assert(kPaged || !kSplit, "a contiguous cache is one page a slot");
  using Rw = Row<T, D>;
  static_assert(kThreads % D == 0, "a column per thread and row class");
  constexpr int kRowClasses = kThreads / D;
  constexpr int kRows = (R + kRowClasses - 1) / kRowClasses;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ps = page_size;
  // rows of a tile, tiles of a page (of the contiguous block: unused)
  const int tr = kPaged && !kSplit ? ps : min(ps, tile_rows);
  const int sub = kSplit ? (ps + tr - 1) / tr : 1;
  const Layout l =
      layout(sizeof(T), D, tr, kPaged ? span_max(pmax * sub) : 0, R, stages);
  float* q_sh = reinterpret_cast<float*>(smem + l.q);
  float* sc = reinterpret_cast<float*>(smem + l.sc);
  float* pb = reinterpret_cast<float*>(smem + l.pb);
  float* wm = reinterpret_cast<float*>(smem + l.wm);   // (kWarps, R)
  float* m_sh = reinterpret_cast<float*>(smem + l.m);  // (2, R)
  float* l_sh = reinterpret_cast<float*>(smem + l.l);
  float* mfin = reinterpret_cast<float*>(smem + l.mfin);
  int* table = reinterpret_cast<int*>(smem + l.table);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + l.bars);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cells = heads / R;
  const int cl = blockIdx.x / kCluster;
  const uint32_t rank = sm90::cluster_rank();
  const int b = cl / cells, h0 = cl % cells * R;
  const int hk = R == 1 ? h0 / (heads / kv_heads) : cl % cells;
  const int len = max(0, min(lengths[b], pmax * ps));
  int live;
  if constexpr (kSplit) {
    live = Tiling(ps, tile_rows).live(len);
  } else {
    live = (len + tr - 1) / tr;
  }
  const int span = (live + kCluster - 1) / kCluster;
  const int first = min(static_cast<int>(rank) * span, live);
  const int n = min(first + span, live) - first;

  if constexpr (kPaged) {
    const int* row = page_table + static_cast<size_t>(b) * pmax;
    for (int i = tid; i < n; i += kThreads) {
      const int page = row[kSplit ? (first + i) / sub : first + i];
      if (page < 0 || page >= num_pages) __trap();
      table[i] = page;
    }
  }
  for (int g = tid; g < R; g += kThreads) {
    m_sh[g] = decode::kNegInf;  // tile 0's running max
    l_sh[g] = 0.f;
  }
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) sm90::bar_init(&full[i], 1);
    sm90::bar_init_fence();
  }
  __syncthreads();

  // tile c of the span: its live rows and its first row in its page (the
  // slot's block for the contiguous cache)
  auto rows_of = [&](int c) {
    const int t = first + c;
    if constexpr (kSplit) {
      const int pi = t / sub, r0 = (t - pi * sub) * tr;
      return min(min(tr, ps - r0), len - pi * ps - r0);
    } else {
      return min(tr, len - t * tr);
    }
  };
  auto row0_of = [&](int c) {
    if constexpr (kSplit)
      return (first + c) % sub * tr;
    else if constexpr (kPaged)
      return 0;
    else
      return (first + c) * tr;
  };
  // its live rows, K then V, into its stage
  auto load = [&](int c) {
    const uint32_t bytes = static_cast<uint32_t>(rows_of(c) * D * sizeof(T));
    const int page = kPaged ? table[c] : b;
    const size_t at =
        ((static_cast<size_t>(page) * kv_heads + hk) * ps + row0_of(c)) * D;
    unsigned char* dst = smem + (c % stages) * l.stage;
    uint64_t* bar = &full[c % stages];
    sm90::bar_expect(bar, 2 * bytes);
    sm90::bulk_load(dst, k + at, bytes, bar);
    sm90::bulk_load(dst + l.tile, v + at, bytes, bar);
  };
  if (tid == 0)
    for (int c = 0; c < min(stages, n); ++c) load(c);

  const T* q_rows = q + (static_cast<size_t>(b) * heads + h0) * D;
  for (int i = tid; i < R * D; i += kThreads)
    q_sh[Rw::q_pos(i / D, i % D)] = decode::to_f32(q_rows[i]) * scale;
  __syncthreads();

  const int sub_lane = tid % Rw::kLanes, slot = tid / Rw::kLanes;
  const int col = tid % D, rc = tid / D;
  // q's float4 (g, lane chunk i, part h) of this lane: in registers where
  // the rows' fit 64 floats, else read from shared memory
  constexpr int kParts = Rw::kPerLane * (Rw::kElems / 4);
  constexpr bool kQRegs = R * kParts * 4 <= 64;
  const float4* q4 = reinterpret_cast<const float4*>(q_sh);
  float4 q_reg[kQRegs ? R * kParts : 1];
  if constexpr (kQRegs) {
#pragma unroll
    for (int x = 0; x < R * kParts; ++x)
      q_reg[x] = q4[x * Rw::kLanes + sub_lane];
  }
  auto q_part = [&](int x) {
    if constexpr (kQRegs)
      return q_reg[x];
    else
      return q4[x * Rw::kLanes + sub_lane];
  };
  float acc[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) acc[k] = 0.f;

  for (int c = 0; c < n; ++c) {
    sm90::bar_wait(&full[c % stages], (c / stages) & 1);
    const unsigned char* kst = smem + (c % stages) * l.stage;
    const T* vst = reinterpret_cast<const T*>(kst + l.tile);
    const int rows = rows_of(c);
    const float* m_old = m_sh + (c & 1) * R;
    float* m_new = m_sh + ((c + 1) & 1) * R;

    // scores: the tile's keys kSlots at a time, kLanes lanes a key; each
    // warp's max over its keys per query row
    float mx[R];
#pragma unroll
    for (int g = 0; g < R; ++g) mx[g] = decode::kNegInf;
    for (int j0 = 0; j0 < rows; j0 += Rw::kSlots) {
      const int j = j0 + slot;
      float kr[Rw::kPerLane][Rw::kElems];
#pragma unroll
      for (int i = 0; i < Rw::kPerLane; ++i) {
        if (j < rows) {
          chunk_f32<T>(kr[i], kst + static_cast<size_t>(j) * D * sizeof(T) +
                                  (sub_lane + Rw::kLanes * i) * 16);
        } else {
#pragma unroll
          for (int e = 0; e < Rw::kElems; ++e) kr[i][e] = 0.f;
        }
      }
#pragma unroll
      for (int g = 0; g < R; ++g) {
        float part[2] = {0.f, 0.f};  // two chains of fmaf
#pragma unroll
        for (int i = 0; i < Rw::kPerLane; ++i) {
#pragma unroll
          for (int h = 0; h < Rw::kElems / 4; ++h) {
            const int x = i * (Rw::kElems / 4) + h;
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
        for (int off = Rw::kLanes / 2; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (j < rows) {
          if (sub_lane == 0) sc[g * tr + j] = s;
          mx[g] = fmaxf(mx[g], s);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < R; ++g) {
      float v = mx[g];
#pragma unroll
      for (int off = Rw::kLanes; off < 32; off <<= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
      if (lane == 0) wm[warp * R + g] = v;
    }
    __syncthreads();
    // every thread has read the previous tile: its stage takes the tile
    // `stages` after it
    if (tid == 0 && c >= 1 && c - 1 + stages < n) load(c - 1 + stages);

    // one max per tile and query row, m_new = max(m_old, the tile's max),
    // and p = exp(s - m_new), a (row, key) pair a thread
    for (int idx = tid; idx < R * rows; idx += kThreads) {
      const int g = idx / rows, j = idx - g * rows;
      float mp = m_old[g];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mp = fmaxf(mp, wm[w * R + g]);
      pb[g * tr + j] = expf(sc[g * tr + j] - mp);
      if (j == 0) m_new[g] = mp;
    }
    __syncthreads();

    // one rescale per tile: acc = corr acc + p V and l = corr l + sum p,
    // column `col` of rows rc, rc + kRowClasses, ... (l by column 0)
    float corr[kRows], psum[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int g = rc + kRowClasses * k;
      corr[k] = g < R ? expf(m_old[g] - m_new[g]) : 0.f;
      acc[k] *= corr[k];
      psum[k] = 0.f;
    }
#pragma unroll 4
    for (int j = 0; j < rows; ++j) {
      const float vj = decode::to_f32(vst[j * D + col]);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int g = rc + kRowClasses * k;
        if (g < R) {
          const float pj = pb[g * tr + j];
          acc[k] = fmaf(pj, vj, acc[k]);
          psum[k] += pj;
        }
      }
    }
    if (col == 0) {
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int g = rc + kRowClasses * k;
        if (g < R) l_sh[g] = corr[k] * l_sh[g] + psum[k];
      }
    }
  }

  // the ring is read: it takes the block's acc, then the cluster merges
  __syncthreads();
  float* acc_sh = reinterpret_cast<float*>(smem);  // (R, D)
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const int g = rc + kRowClasses * k;
    if (g < R) acc_sh[g * D + col] = acc[k];
  }
  for (int g = tid; g < R; g += kThreads) mfin[g] = m_sh[(n & 1) * R + g];
  sm90::cluster_sync();
  if (rank == 0) {
    T* o_rows = o + (static_cast<size_t>(b) * heads + h0) * D;
    for (int idx = tid; idx < R * D; idx += kThreads) {
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

// The launch of the stream for a call, shared by each source's launcher
// and its `_plan` and `_cluster_plan` exports: f(Type<T>{}, kernel,
// geometry) for the instantiation (T, D, R, kPaged, kSplit) a call with
// these arguments runs (kSplit: pages of more than tile_rows rows);
// kCluster blocks of kThreads threads per cell (batch * heads / R cells),
// the ring's stages in geometry.stage.  cudaErrorInvalidValue where the
// tile rows are outside [1, kMaxTileRows] or the dims are not
// instantiated.
template <bool kPaged, typename F>
cudaError_t with_stream(int dtype, int d, int rows, int batch, int heads,
                        int page_size, int pmax, int tile_rows, F&& f) {
  if (tile_rows < 1 || tile_rows > kMaxTileRows)
    return cudaErrorInvalidValue;
  return plan::with_dtype(dtype, [&](auto t) {
    return plan::with_head_dim(d, [&](auto dc) {
      return plan::with_group(rows, [&](auto rc) {
        using T = typename decltype(t)::type;
        constexpr int D = decltype(dc)::value;
        constexpr int R = decltype(rc)::value;
        const Shape s = shape_of(static_cast<int>(sizeof(T)), D, R,
                                 page_size, pmax, kPaged, tile_rows);
        const plan::Geometry geo{
            dim3(static_cast<unsigned>(batch) * (heads / R) * kCluster),
            kThreads, s.l.total, s.stages};
        if constexpr (kPaged) {
          if (page_size > tile_rows)
            return f(t, stream_kernel<T, D, R, true, true>, geo);
          return f(t, stream_kernel<T, D, R, true, false>, geo);
        } else {
          return f(t, stream_kernel<T, D, R, false, false>, geo);
        }
      });
    });
  });
}

// Launch `kernel` (geometry geo from with_stream): refused
// (cudaErrorInvalidValue) where a ring of kMinStages tiles does not fit or
// q, k or v is not 16-byte aligned (the bulk copies need it).
template <typename T, typename Kernel>
cudaError_t launch(Kernel kernel, const plan::Geometry& geo,
                   cudaStream_t stream, const void* q, const void* k,
                   const void* v, const void* page_table,
                   const void* lengths, void* o, int heads, int kv_heads,
                   int num_pages, int page_size, int pmax, int tile_rows,
                   float scale) {
  if (geo.smem > kMaxSmem || reinterpret_cast<uintptr_t>(q) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(k) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(v) % 16 != 0)
    return cudaErrorInvalidValue;
  return plan::launch(
      kernel, geo, stream, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<T*>(o), heads, kv_heads,
      num_pages, page_size, pmax, tile_rows, geo.stage, scale);
}

// The clusters of a launch, into out[2]: blocks per cluster and the most
// clusters of `kernel` the card holds at once
// (cudaOccupancyMaxActiveClusters); nothing is launched.
template <typename Kernel>
cudaError_t clusters(Kernel kernel, const plan::Geometry& geo,
                     int64_t* out) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(geo.smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = geo.grid;
  cfg.blockDim = dim3(geo.threads);
  cfg.dynamicSmemBytes = geo.smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (err != cudaSuccess) return err;
  out[0] = kCluster;
  out[1] = n;
  return cudaSuccess;
}

}  // namespace pc
