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

  * `FLASH_BLOCK_Q`, `FLASH_BLOCK_K` — the tiles of the CUDA flash
    kernels (`flash_fwd`, `flash_bwd_q`, `flash_bwd_kv`).  A block runs
    4 warps, and a warp owns 16 query rows (or, in `flash_bwd_kv`, 16
    key rows): the M edge of the tensor cores' m16n8k16 `mma.sync`, so
    a block tile is 64 rows; each KV (or query) tile staged in shared
    memory is 64 rows, which keeps a warp's (16, 64) f32 score
    fragment at 32 registers a thread and a block's bf16 staging at
    ~56 KB (f32: ~108 KB) at D = 128, so several blocks share an SM.
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

The CUDA decode step (`la_decode_fused`) launches one block per (slot,
KV head) and has no tile to choose.
"""
from __future__ import annotations

DEFAULT_SCAN_CHUNK = 512
LA_STAGE_TOKENS = 32
FLASH_BLOCK_Q = 64
FLASH_BLOCK_K = 64
SOFTMAX_DECODE_WARPS = 8
