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
    backward) that a block of the CUDA linear-attention kernels
    (`la_fwd`, `la_bwd_q`, `la_bwd_kv`) stages in shared memory per
    iteration.  The kernels walk the recurrence one token at a time, so
    the staging size changes no result; each launcher stages fewer where
    its block would exceed the H100's 227 KB of shared memory (large
    query groups in `la_bwd_kv`).

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
    kernels: `softmax_decode_fused` (one block per (slot, KV head)) and
    the paged `paged_attention` (per (slot, query head)) and
    `paged_decode_fused` (per (slot, KV head)); each warp walks every
    `SOFTMAX_DECODE_WARPS`-th key of the slot's live prefix with its
    own online softmax, and the block merges the warps' partial sums
    at the end.  8 warps read 8 K/V rows at a time per block; the
    result does not depend on it beyond f32 summation order.  The
    reference's `pages_per_block` (pages per sequential TPU grid step)
    has no counterpart: a block walks all of its slot's pages.

  * `GLA_STAGE_TOKENS` — the same staging size for the decay-gated
    instantiations of those kernels (`gla_fwd`, `gla_bwd_q`,
    `gla_bwd_kv`), which also stage each token's decay.  The
    reference's `DEFAULT_TILES["gla"]["chunk"] = 128` is the VMEM tile
    of its Pallas GLA kernels; here too the token-by-token walk makes
    the result independent of it.  The plain GLA scans (core/gla.py)
    take `DEFAULT_SCAN_CHUNK`, as the linear ones do.

  * `SSD_STAGE_TOKENS` — the same staging size for the token walk of the
    SSD (Mamba-2) kernels (`ssd_fwd` in f32 and at the smoke dims,
    `ssd_bwd_q`, `ssd_bwd_kv`), which stage q, k, v (and Ω in the
    backward) and each token's decay.  The reference's
    `DEFAULT_TILES["ssd"]["chunk"] = 128` is the VMEM tile of its Pallas
    SSD kernels; the token-by-token walk makes the result independent of
    it.  At 32 tokens a block of `ssd_bwd_kv` stages ~86 KB, so two
    blocks share an SM.  The plain SSD scans (core/ssd.py) take
    `DEFAULT_SCAN_CHUNK`.
  * `SSD_CHUNK_TOKENS`, `SSD_CHUNK_RING` — the chunk and the ring depth
    of `ssd_fwd`'s "wgmma" body (bf16 at (Dk, Dv) in
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
block per (slot, KV head) and have no tile to choose.
"""
from __future__ import annotations

DEFAULT_SCAN_CHUNK = 512
LA_STAGE_TOKENS = 32
GLA_STAGE_TOKENS = 32
SSD_STAGE_TOKENS = 32
SSD_CHUNK_TOKENS = 64
SSD_CHUNK_RING = 2
SSD_WGMMA_STATE_DIMS = ((128, 64),)
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
