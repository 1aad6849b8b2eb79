"""Default kernel sizes of the port — its own table, not the TPU's.

The reference's table (`repro/kernels/defaults.py`) holds sizes chosen
for a TPU's VMEM and (8, 128) tiling; none of them is a Hopper default.
The reference's `DEFAULT_TILES["linear"]["chunk"] = 512` is a VMEM
tiling of its Pallas kernels; the CUDA kernels below pick their own
staging size, and no result depends on it.

  * `DEFAULT_SCAN_CHUNK` — tokens per iteration of the plain chunked
    scans (core/chunked.py: serving prefill and the `torch` impl of
    training's forward and backward); `LACfg.chunk` mirrors it.
  * `LA_STAGE_TOKENS` — the most tokens of q/k/v (and Ω̂/h in the
    backward) that a block of the CUDA linear-attention kernels' token
    walk (`la_fwd`, `la_bwd_q` and `la_bwd_kv` in f32 and at D = 32, 112
    and (192, 128)) stages in shared memory per iteration.  The kernels
    walk the recurrence one token at a time, so the staging size changes
    no result; each launcher stages fewer where its block would exceed the
    H100's 227 KB of shared memory (large query groups in `la_bwd_kv`).

  * `LA_CHUNK_TOKENS`, `LA_CHUNK_RING`, `LA_WGMMA_PART` — the chunk,
    the ring depth and the value columns a block of `la_fwd`'s "wgmma"
    body writes (bf16 at D in `LA_WGMMA_HEAD_DIMS`: 128, the paper's
    training instance, and 64, stablelm-1.6b's and whisper-large-v3's
    decoder's; the dtype and D pick the body,
    `linear_attention.la_fwd_body`; f32 and the other D keep the token
    walk).  A chunk is 64 tokens, the M of Hopper's `wgmma`; a head's D
    value columns are split over D / 64 blocks of 64
    (`linear_attention.wgmma_parts`), so each block's state S^T (64 x D)
    is one m64nD f32 accumulator, D / 2 registers a thread: two blocks a
    head at D = 128, 64 at the timing shape (B = 2, H = 16); one at D =
    64, 64 at stablelm's (B = 2, H = 32).  Two chunks of q, k (64 x D)
    and the block's 64 columns of v in bf16 (40 KB each at D = 128) in
    the TMA ring, the bf16 copy of S^T and the f32 sums z (of k) and P
    (of v) come to 101,888 B at D = 128, 60,416 B at 64.  The chunk moves
    where o rounds:
    the intra-chunk matrix A = a + b q k^T and the readout's copy of S
    are rounded to bf16 once per chunk (one bf16 step of o at most); g,
    the normalizer and the backward's residual, stays f32 (the row sums
    of the f32 scores and q . z on the CUDA cores).  The kernel is
    compiled for exactly this chunk and refuses any other.
  * `LA_BWD_WGMMA_HEAD_DIMS`, `LA_BWD_RING` — the "wgmma" bodies of
    the analytic backward's `la_bwd_q` and `la_bwd_kv` (bf16 at D in
    `LA_BWD_WGMMA_HEAD_DIMS`, 128 and 64 as the forward's; the entry, the
    dtype and D pick the body, `linear_attention.la_bwd_body`; f32 and
    the other D keep the token walk).  Both walk chunks of
    `LA_CHUNK_TOKENS` with blocks of `LA_WGMMA_PART` columns.  `la_bwd_q`
    runs D / 64 blocks per (batch, query head), one per 64 of dq's
    columns, so a block's share of the state A = Σ k^T v (64 x D) is one
    m64nD f32 accumulator; `la_bwd_kv` runs 2 D / 64 blocks per (batch,
    KV head), dk's parts of 64 columns and dv's (four at D = 128, two at
    64), each holding a 64 x D slice of U = Σ q^T Ω̂ in the orientation
    its readout needs (128 blocks at either timing shape, one wave on 132
    SMs).  `LA_BWD_RING` steps of k, v, q and the f32 Ω̂ are in flight in
    the TMA ring: with Ω̂'s hi and lo bf16 tiles and the state's hi and lo
    copies that is 183,040 B (`la_bwd_q`) and 199,424 B (`la_bwd_kv`) at
    D = 128, one block an SM, and 101,120 B each at 64.  Every operand
    that is not a bf16 input (Ω̂, the copies of the states, the score
    tiles) goes as a hi + lo pair of bf16 values, so dq, dk and dv stay
    within one bf16 step where q and k share a direction; the kernels are
    compiled for exactly this chunk and refuse any other.
  * `LA_BWD_KV_SPLIT_GROUP`, `H100_SMS` — the split of `la_bwd_kv`'s (and
    `gla_bwd_kv`'s) chunked body over the query group.  A block walks its
    chunks once per query head of its group, so at G = 8, 16, 48 and 7
    (qwen2.5-3b, chatglm3-6b, granite-20b, qwen2-vl-7b) the unsplit grid
    had 16, 16, 8 and 32 blocks at B = 2, each doing G heads' steps.  From
    `LA_BWD_KV_SPLIT_GROUP` query heads a KV head (7, the smallest group of
    a registry model) the group is cut into S slices of consecutive heads,
    slice s the heads [s G / S, (s + 1) G / S), each walked by a block of
    its own (grid z): S is the smallest count that keeps the largest
    slice's share, ⌈G / min(G, fit)⌉ heads, where fit is the blocks per
    (batch, KV head, part) that leave the grid within one block on each of
    `H100_SMS` SMs (S = 8, 8, 16 and 4 at the shapes above, 128 blocks
    each).  Each slice stores its share of dk and dv unrounded in f32, and
    a second kernel adds the slices in order and rounds once
    (`linear_attention.kv_slices`).  Smaller groups (the tests' 2 and 4)
    and G = 1 keep the unsplit launch and its bits.
  * `SSD_BWD_Q_WGMMA_STATE_DIMS`, `SSD_BWD_Q_K_RING` — `ssd_bwd_q`'s
    "wgmma" body (bf16 at (Dk, Dv) in `SSD_BWD_Q_WGMMA_STATE_DIMS`,
    mamba2-2.7b's training instance; chunks of `SSD_CHUNK_TOKENS`):
    `ssd_fwd`'s forward chunk walk with the readout dq = S Ω.  k is read
    to a chunk's end and kept in a ring of `SSD_BWD_Q_K_RING` chunks; v
    and Ω are read in a chunk's first half only and kept once (the next
    chunk's load starts half-way).  With the hi and lo bf16 copies of
    S^T and of the (w v) tile that is 100,352 B, two blocks an SM, and
    the 160 blocks of the timing shape run in one wave.  Every operand
    that is not a bf16 input (the decay-masked p o M, the copies of S^T,
    w v) goes as a hi + lo pair, so the f32 dq partials round at ~2^-17
    relative.
  * `SSD_BWD_KV_QO_RING` — the ring depth of q and Ω in `ssd_bwd_kv`'s
    "wgmma" body (bf16 at (Dk, Dv) in `SSD_BWD_KV_WGMMA_STATE_DIMS`,
    mamba2-2.7b's training instance; chunks of `SSD_CHUNK_TOKENS`).  The
    reverse chunk walk reads k and v in the chunk's first half and q and
    Ω to its end, so k and v are kept once (the next chunk's load starts
    half-way) and q and Ω twice: with the hi and lo bf16 copies of the
    state U^T (16 KB each) that is 108,544 B, so two blocks share an SM
    and the 160 blocks of the timing shape run in one wave.  Every
    operand of its products that is not a bf16 input (the decay-masked
    p o M and s o M, exp(cl) o Ω and the copies of U^T) goes as a hi +
    lo pair of bf16 values, two products into one f32 accumulator, so
    the f32 dk partials and dv round at ~2^-17 relative, not bf16's 2^-9.

  * `FLASH_BLOCK_Q`, `FLASH_BLOCK_K` — the query and key tiles (rows)
    of the CUDA flash kernels (`flash_fwd`, `flash_bwd_q`,
    `flash_bwd_kv`), per body; the dtype and the head dim pick the body
    (`flash_attention.flash_body`):
      - "wgmma" (bf16 at D in `FLASH_WGMMA_HEAD_DIMS`, the main path):
        a block is two warpgroups of 64 rows, the M of Hopper's `wgmma`,
        so its resident tile is 128 rows: 128 query rows in `flash_fwd`
        and `flash_bwd_q`, 128 keys in `flash_bwd_kv`.  The streamed
        tiles are 128 keys in `flash_fwd` (a 64 x 128 f32 score
        accumulator, 64 registers a thread, beside the 64 of the output)
        and 64 rows in the backward (S and dP at 32 registers each beside
        the 64 or 128 of the grads' accumulators).  Two stages of each
        fit the 227 KB of shared memory: ~162 KB in `flash_fwd`, ~130 KB
        in the backward;
      - "mma_sync" (f32 at every head dim, bf16 at the others): a block
        runs 4 warps, and a warp owns 16 query rows (or, in
        `flash_bwd_kv`, 16 key rows): the M edge of the tensor cores'
        m16n8k16 `mma.sync`, so a block tile is 64 rows; each KV (or
        query) tile staged in shared memory is 64 rows, which keeps a
        warp's (16, 64) f32 score fragment at 32 registers a thread and a
        block's f32 staging at ~108 KB at D = 128.
    The reference's 128 x 128 is a VMEM tiling of the TPU's MXU.  The
    kernels are compiled for exactly these tiles; their C entry points
    reject any other.
  * `PAGED_DECODE_CLUSTER`, `PAGED_DECODE_WARPS`, `PAGED_DECODE_RING`,
    `DECODE_TILE_ROWS` — the tile stream that every softmax decode entry
    runs (csrc/decode_common.cuh namespace `pc`): `softmax_decode_fused`
    (contiguous cache) and `paged_decode_fused` with a cell per (slot, KV
    head), `paged_attention` with a cell per (slot, query head).  A
    cluster of 4 blocks per cell makes 512 blocks at the serving shape (B
    = 8, Hkv = 16): about four an SM on 132 SMs, where one block per cell
    left one an SM walking 544 keys alone; each block streams a
    contiguous quarter of the cell's live tiles (9 of 34) and the four
    merge through distributed shared memory, within the portable cluster
    size of 8.  4 warps a block: 16 keys scored at once, 8 lanes a key
    (a 16-row tile at a time), and one thread per value column (D = 128)
    for P V.  A tile is at most `DECODE_TILE_ROWS` rows contiguous in
    memory: a page of at most that many rows is one tile (so the paged
    kernel's tiles are its pages at the serving page size of 16), a
    larger page and a contiguous cache's S rows are cut into tiles of
    that many rows (the C entries admit 1..64: a ring of two 64-row
    tiles fits at f32, D = 128, G = 16).  16 rows: on the same keys the
    contiguous kernel then gives the paged kernel's bits at page size 16
    (PERF.md gives its times against 32 and 64 rows).  A ring of 4 tiles
    of K and V (8 KB each in bf16 at 16 rows, D = 128) is 32 KB a block,
    so four blocks keep ~128 KB of bulk copies in flight an SM, where ~1
    us of latency at 3.35 TB/s wants ~26 KB; fewer stages where the
    longest span has fewer tiles (at least 2) or the ring would not fit.
    The result depends on the tile and the cluster through the f32
    summation order, not on the ring.  The reference's `pages_per_block`
    (pages per sequential TPU grid step) has no counterpart: a cluster's
    blocks split the pages between them.

  * `GLA_STAGE_TOKENS` — the same staging size for the decay-gated
    instantiations of the token walks (`gla_fwd`, `gla_bwd_q` and
    `gla_bwd_kv` in f32 and at D < 128: the gated entries have no
    chunked body at D = 64, which no path runs), which also stage each
    token's decay.  The reference's `DEFAULT_TILES["gla"]["chunk"] = 128`
    is the VMEM tile of its Pallas GLA kernels; here too the
    token-by-token walk makes the result independent of it.  The plain GLA scans
    (core/gla.py) take `DEFAULT_SCAN_CHUNK`, as the linear ones do.
  * `GLA_WGMMA_HEAD_DIMS`, `GLA_BWD_Q_WGMMA_HEAD_DIMS`,
    `GLA_BWD_KV_WGMMA_HEAD_DIMS` — the head dims at which `gla_fwd`,
    `gla_bwd_q` and `gla_bwd_kv` in bf16 run the decay-gated instances
    of `la_fwd`'s, `la_bwd_q`'s and `la_bwd_kv`'s "wgmma" bodies (the
    entry, the dtype and D pick the body, `linear_attention.la_fwd_body`
    and `la_bwd_body`), with their chunk `LA_CHUNK_TOKENS`, ring and
    splits.  The decay is kept as a chunk's cumsum of log decays, every
    factor a power of two of a masked difference <= 0 of it.  The gated
    forward also sends A, the readout's copy of S^T and the (w o v) tile
    of its state update as hi + lo pairs of bf16 (134,656 B); the gated
    dq body sends its (w o v) tile as a hi + lo pair too (215,808 B);
    the gated dk/dV' body writes dV' in f32 with its augmented column
    and keeps that column's sums and the step's token weights beside
    its own (200,976 B).

  * `SSD_STAGE_TOKENS` — the same staging size for the token walk of the
    SSD (Mamba-2) kernels (each of `ssd_fwd`, `ssd_bwd_q` and
    `ssd_bwd_kv` in f32 and at the smoke dims), which stage
    q, k, v (and Ω in the backward) and each token's decay.  The reference's
    `DEFAULT_TILES["ssd"]["chunk"] = 128` is the VMEM tile of its Pallas
    SSD kernels; the token-by-token walk makes the result independent of
    it.  At 32 tokens a block of `ssd_bwd_kv` stages ~86 KB, so two
    blocks share an SM.  The plain SSD scans (core/ssd.py) take
    `DEFAULT_SCAN_CHUNK`.
  * `SSD_CHUNK_TOKENS`, `SSD_CHUNK_RING` — the chunk of the three SSD
    "wgmma" bodies and the ring depth of `ssd_fwd`'s "wgmma" body (bf16 at
    (Dk, Dv) in `SSD_WGMMA_STATE_DIMS`: mamba2-2.7b's training instance,
    (128, 64), and zamba2-7b's Mamba-2 layers, (64, 64), where q and k
    are one 64-column box a row, S^T an m64n64 accumulator and, at
    (Dk, Dv) in `SSD_FWD_PAIR_STATE_DIMS`, A, w v and S's copy hi + lo
    pairs of bf16, a block 83,968 B, two an SM; the dtype, the dims and
    the entry pick the body, `ssd.ssd_body`).  The pairs keep o to f32's
    bits before its rounding, which zamba2's step-0 train comparison
    needs: it reads o through the decays' cancelling grads at 3 blocks,
    where mamba2's 64 layers hold the single roundings (PERF.md).  A chunk is
    64 tokens, the M of Hopper's `wgmma`: its four products per chunk
    (q k^T, q S, A v and the state update) are m64nNk16 tiles, and its
    intra-chunk decay matrix is a 64 x 64 f32 accumulator, 32 registers
    a thread beside the state's 64.  Two chunks of q, k and v (40 KB
    each) in the TMA ring, the (w v) tile and the bf16 copy of the state
    come to 108,544 B, so that two blocks share an SM and the 160 blocks
    of the timing shape run in one wave.  Unlike the token walk's stage,
    the chunk moves where the result rounds (A, w v and the readout's
    copy of S are rounded to bf16 once per chunk); the kernel is compiled
    for exactly this chunk and refuses any other.

The CUDA decode steps (`la_decode_fused`, `gla_decode_fused`) launch one
block per (slot, KV head).  At dims the stream does not take both walk
the state by columns and have no tile to choose.  Elsewhere both stream
their f32 state slab through shared memory
(`decode_fused.recurrent_decode_body`):

  * `GLA_DECODE_ROWS` — state rows per chunk: one 1-D bulk copy in and
    one out, 8,256 B at Dv = 128; a run of a multiple of 4 rows starts
    16-byte aligned where Dk % 4 == 0, as the bulk copies need;
  * `GLA_DECODE_ROW_CLASSES` — the threads of a chunk: one per column
    and row class, so 4 (Dv + 1) threads each update every fourth row of
    their column and keep that class's partial dots q . S_new; the
    classes' dots are added in a fixed order after the stream;
  * `GLA_DECODE_RING` — the most chunks in flight: 5 x 8,256 B = 41 KB a
    block at Dv = 128 (one block an SM at the serving shape, where ~26 KB
    of loads in flight an SM cover ~1 us of latency at 3.35 TB/s), fewer
    where the group's q and f rows leave less of the launcher's 48 KB
    (three at G = 16), never more than the slab's chunks;
  * `GLA_DECODE_WIDE_GROUP`, `GLA_DECODE_WIDE_THREADS` — a group of more
    query heads than the first (granite-20b's 48 on one KV head) keeps
    its G partial dots a thread in registers, so its blocks are capped at
    the second (112 registers a thread; 544 threads at Dv = 128), and its
    query rows, rows f and partial dots take shared memory past 48 KB, up
    to the card's opt-in maximum (csrc/la_decode_fused.cu `ds::max_smem`).
"""
from __future__ import annotations

DEFAULT_SCAN_CHUNK = 512
LA_STAGE_TOKENS = 32
GLA_STAGE_TOKENS = 32
SSD_STAGE_TOKENS = 32
SSD_CHUNK_TOKENS = 64
SSD_CHUNK_RING = 2
SSD_WGMMA_STATE_DIMS = ((128, 64), (64, 64))
SSD_FWD_PAIR_STATE_DIMS = ((64, 64),)
SSD_BWD_KV_WGMMA_STATE_DIMS = ((128, 64),)
SSD_BWD_Q_WGMMA_STATE_DIMS = ((128, 64),)
SSD_BWD_Q_K_RING = 2
SSD_BWD_KV_QO_RING = 2
LA_CHUNK_TOKENS = 64
LA_CHUNK_RING = 2
LA_WGMMA_PART = 64
LA_WGMMA_HEAD_DIMS = (64, 128)
LA_BWD_WGMMA_HEAD_DIMS = (64, 128)
GLA_WGMMA_HEAD_DIMS = (128,)
GLA_BWD_Q_WGMMA_HEAD_DIMS = (128,)
GLA_BWD_KV_WGMMA_HEAD_DIMS = (128,)
LA_BWD_RING = 2
LA_BWD_KV_SPLIT_GROUP = 7
H100_SMS = 132
FLASH_BLOCK_Q = {
    "wgmma": {"flash_fwd": 128, "flash_bwd_q": 128, "flash_bwd_kv": 64},
    "mma_sync": {"flash_fwd": 64, "flash_bwd_q": 64, "flash_bwd_kv": 64},
}
FLASH_BLOCK_K = {
    "wgmma": {"flash_fwd": 128, "flash_bwd_q": 64, "flash_bwd_kv": 128},
    "mma_sync": {"flash_fwd": 64, "flash_bwd_q": 64, "flash_bwd_kv": 64},
}
FLASH_WGMMA_HEAD_DIMS = (128,)
PAGED_DECODE_CLUSTER = 4
PAGED_DECODE_WARPS = 4
PAGED_DECODE_RING = 4
DECODE_TILE_ROWS = 16
GLA_DECODE_ROWS = 16
GLA_DECODE_ROW_CLASSES = 4
GLA_DECODE_RING = 5
GLA_DECODE_WIDE_GROUP = 16
GLA_DECODE_WIDE_THREADS = 576
