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

The CUDA decode step (`la_decode_fused`) launches one block per (slot,
KV head) and has no tile to choose.
"""
from __future__ import annotations

DEFAULT_SCAN_CHUNK = 512
LA_STAGE_TOKENS = 32
