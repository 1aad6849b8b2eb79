"""Default kernel sizes of the port — its own table, not the TPU's.

The reference's table (`repro/kernels/defaults.py`) holds sizes chosen
for a TPU's VMEM and (8, 128) tiling; none of them is a Hopper default.
This table starts with what the serving slice runs:

  * `DEFAULT_SCAN_CHUNK` — tokens per iteration of the plain chunked
    scan that serving prefill runs (core/chunked.py); `LACfg.chunk`
    mirrors it.

The CUDA decode step (`la_decode_fused`) launches one block per (slot,
KV head) and has no tile to choose; a kernel that has one keeps its
default here.
"""
from __future__ import annotations

DEFAULT_SCAN_CHUNK = 512
