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
    walk (`la_fwd`, `la_bwd_q` and `la_bwd_kv` in f32 and at D < 128)
    stages in shared memory per iteration.  The kernels walk the
    recurrence one token at a time, so the staging size changes no
    result; each launcher stages fewer where its block would exceed the
    H100's 227 KB of shared memory (large query groups in `la_bwd_kv`).

  * `LA_CHUNK_TOKENS`, `LA_CHUNK_RING`, `LA_WGMMA_SPLIT` — the chunk,
    the ring depth and the blocks per head of `la_fwd`'s "wgmma" body
    (bf16 at D in `LA_WGMMA_HEAD_DIMS`, the paper's training instance;
    the dtype and D pick the body, `linear_attention.la_fwd_body`; f32
    and the other D keep the token walk).  A chunk is 64
    tokens, the M of Hopper's `wgmma`; a head's D = 128 value columns
    are split over two blocks of 64, so each block's state S^T (64 x 128)
    is one m64n128 f32 accumulator, 64 registers a thread, and the grid
    of the timing shape (B = 2, H = 16) is 64 blocks.  Two chunks of q,
    k (64 x 128) and the block's half of v (64 x 64) in bf16 (40 KB
    each) in the TMA ring, the bf16 copy of S^T and the f32 sums z (of
    k) and P (of v) come to 101,888 B.  The chunk moves where o rounds:
    the intra-chunk matrix A = a + b q k^T and the readout's copy of S
    are rounded to bf16 once per chunk (one bf16 step of o at most); g,
    the normalizer and the backward's residual, stays f32 (the row sums
    of the f32 scores and q . z on the CUDA cores).  The kernel is
    compiled for exactly this chunk and refuses any other.
  * `LA_BWD_WGMMA_HEAD_DIMS`, `LA_BWD_Q_SPLIT`, `LA_BWD_KV_SPLIT`,
    `LA_BWD_RING` — the "wgmma" bodies of the analytic backward's
    `la_bwd_q` and `la_bwd_kv` (bf16 at D in `LA_BWD_WGMMA_HEAD_DIMS`,
    the paper's training instance; the entry, the dtype and D pick the
    body, `linear_attention.la_bwd_body`; f32 and the other D keep the
    token walk).  Both walk chunks of
    `LA_CHUNK_TOKENS`.  `la_bwd_q` runs `LA_BWD_Q_SPLIT` = 2 blocks per
    (batch, query head), one per half of dq's columns, so a block's share
    of the state A = Σ k^T v (64 x 128) is one m64n128 f32 accumulator;
    `la_bwd_kv` runs `LA_BWD_KV_SPLIT` = 4 blocks per (batch, KV head),
    dk's two column halves and dv's two, each holding a 64 x 128 slice of
    U = Σ q^T Ω̂ in the orientation its readout needs (128 blocks at the
    timing shape, one wave on 132 SMs).  `LA_BWD_RING` steps of k, v, q
    and the f32 Ω̂ are in flight in the TMA ring: with Ω̂'s hi and lo bf16
    tiles and the state's hi and lo copies that is 183,040 B (`la_bwd_q`)
    and 199,424 B (`la_bwd_kv`), one block an SM.  Every operand that is
    not a bf16 input (Ω̂, the copies of the states, the score tiles) goes
    as a hi + lo pair of bf16 values, so dq, dk and dv stay within one
    bf16 step where q and k share a direction; the kernels are compiled
    for exactly this chunk and refuse any other.
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
  * `SOFTMAX_DECODE_WARPS` — warps per block of the softmax decode
    walk (`decode_common.cuh`): `softmax_decode_fused` (one block per
    (slot, KV head)), the paged `paged_attention` (per (slot, query
    head)), and `paged_decode_fused` (per (slot, KV head)) at the shapes
    its cluster body does not take; each warp walks every
    `SOFTMAX_DECODE_WARPS`-th key of the slot's live prefix with its
    own online softmax, and the block merges the warps' partial sums
    at the end.  8 warps read 8 K/V rows at a time per block; the
    result does not depend on it beyond f32 summation order.  The
    reference's `pages_per_block` (pages per sequential TPU grid step)
    has no counterpart: a block walks all of its slot's pages.
  * `PAGED_DECODE_CLUSTER`, `PAGED_DECODE_WARPS`, `PAGED_DECODE_RING` —
    `paged_decode_fused`'s cluster-split page stream
    (`paged_attention.paged_decode_body`, csrc/paged_decode.cu namespace
    `pc`).  A cluster of 4 blocks per (slot, KV head) makes 512 blocks
    at the serving shape (B = 8, Hkv = 16): about four an SM on 132 SMs,
    where the walk's 128 blocks left one an SM walking 544 keys alone;
    each block streams a contiguous quarter of the slot's live pages
    (9 of 34) and the four merge through distributed shared memory,
    within the portable cluster size of 8.  4 warps a block: 16 keys
    scored at once, 8 lanes a key (a page of 16 rows at a time), and
    one thread per value column (D = 128) for P V.  A ring of 4 pages of
    K and V (8 KB each in bf16 at ps = 16, D = 128) is 32 KB a block,
    so four blocks keep ~128 KB of bulk copies in flight an SM, where
    ~1 us of latency at 3.35 TB/s wants ~26 KB; fewer stages where the
    longest span has fewer pages (at least 2) or the ring would not
    fit.  The result does not depend on the ring; it depends on the
    cluster through the f32 merge order.

  * `GLA_STAGE_TOKENS` — the same staging size for the decay-gated
    instantiations of the token walks (`gla_fwd`, `gla_bwd_q` and
    `gla_bwd_kv` in f32 and at D < 128), which also stage each token's
    decay.  The reference's `DEFAULT_TILES["gla"]["chunk"] = 128` is the
    VMEM tile of its Pallas GLA kernels; here too the token-by-token
    walk makes the result independent of it.  The plain GLA scans
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
    "wgmma" bodies and the ring depth of `ssd_fwd`'s "wgmma" body (bf16 at (Dk, Dv) in
    `SSD_WGMMA_STATE_DIMS`, mamba2-2.7b's training instance; the dtype,
    the dims and the entry pick the body, `ssd.ssd_body`).  A chunk is
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
    (three at G = 16), never more than the slab's chunks.
"""
from __future__ import annotations

DEFAULT_SCAN_CHUNK = 512
LA_STAGE_TOKENS = 32
GLA_STAGE_TOKENS = 32
SSD_STAGE_TOKENS = 32
SSD_CHUNK_TOKENS = 64
SSD_CHUNK_RING = 2
SSD_WGMMA_STATE_DIMS = ((128, 64),)
SSD_BWD_KV_WGMMA_STATE_DIMS = ((128, 64),)
SSD_BWD_Q_WGMMA_STATE_DIMS = ((128, 64),)
SSD_BWD_Q_K_RING = 2
SSD_BWD_KV_QO_RING = 2
LA_CHUNK_TOKENS = 64
LA_CHUNK_RING = 2
LA_WGMMA_SPLIT = 2
LA_WGMMA_HEAD_DIMS = (128,)
LA_BWD_WGMMA_HEAD_DIMS = (128,)
GLA_WGMMA_HEAD_DIMS = (128,)
GLA_BWD_Q_WGMMA_HEAD_DIMS = (128,)
GLA_BWD_KV_WGMMA_HEAD_DIMS = (128,)
LA_BWD_Q_SPLIT = 2
LA_BWD_KV_SPLIT = 4
LA_BWD_RING = 2
FLASH_BLOCK_Q = {
    "wgmma": {"flash_fwd": 128, "flash_bwd_q": 128, "flash_bwd_kv": 64},
    "mma_sync": {"flash_fwd": 64, "flash_bwd_q": 64, "flash_bwd_kv": 64},
}
FLASH_BLOCK_K = {
    "wgmma": {"flash_fwd": 128, "flash_bwd_q": 64, "flash_bwd_kv": 128},
    "mma_sync": {"flash_fwd": 64, "flash_bwd_q": 64, "flash_bwd_kv": 64},
}
FLASH_WGMMA_HEAD_DIMS = (128,)
SOFTMAX_DECODE_WARPS = 8
PAGED_DECODE_CLUSTER = 4
PAGED_DECODE_WARPS = 4
PAGED_DECODE_RING = 4
GLA_DECODE_ROWS = 16
GLA_DECODE_ROW_CLASSES = 4
GLA_DECODE_RING = 5
