"""Softmax-attention backend — the Regular-Attention baseline.

Port of the contiguous-cache path of `repro/mixers/softmax.py`.  Scores
go through the "softmax" KernelImpl family in kernels/ops.py:
cfg.la.backend picks the chunked online softmax ("torch"), the CUDA
flash kernels ("cuda") or the quadratic oracle ("ref"); "auto" picks by
the tensors' device.  Training runs the causal autograd Function with
the flash recomputation backward; continuation prefill runs the flash
forward with per-slot `q_offset`; decode scatters the token at each
slot's own position and runs the fused (or, with
`cfg.la.fused_decode=False`, the unfused) contiguous-cache decode, so
slots at different depths decode exactly.

The KV cache is written IN PLACE by both prefill and decode: one indexed
write per tensor per layer, instead of the O(max_len) copy per layer and
window a functional update would cost (the reference's
`dynamic_update_slice` returns a new array).  Writes clamp as the
reference's `dynamic_update_slice` does: a window whose start lies past
max_len - n is written at max_len - n, so a retired slot whose position
keeps advancing in the batched decode writes the cache's last row, and
its length (pos + 1) is clamped to max_len by the decode kernels.

Left for later slices: the paged cache (`cfg.paging`, ROADMAP.md queue
1 item 8) and `apply_noncausal` (encoder-decoder).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as _ops
from repro_torch.mixers.base import register_backend
from repro_torch.mixers.cache import KVCache
from repro_torch.mixers.qkv import GQAProjectionBackend


def _scatter_window(big: torch.Tensor, new: torch.Tensor,
                    start: torch.Tensor) -> None:
    """Write `new` (B, Hkv, n, hd) into `big` (B, Hkv, S, hd) in place at
    per-slot offsets `start` (B,), each clamped to [0, S - n] as
    `dynamic_update_slice` clamps it."""
    b, _, n, _ = new.shape
    s_len = big.shape[2]
    dev = big.device
    first = torch.clamp(start.to(dev).long(), 0, s_len - n)
    rows = first[:, None] + torch.arange(n, device=dev)[None, :]  # (B, n)
    slots = torch.arange(b, device=dev)[:, None]
    # advanced indices around a slice put the (B, n) axes first
    big[slots, :, rows] = new.transpose(1, 2).to(big.dtype)


@register_backend("softmax")
class SoftmaxAttentionBackend(GQAProjectionBackend):
    def apply(self, p, cfg, x, positions, compute_dtype=None):
        q, k, v = self.project_qkv(p, cfg, x, positions, compute_dtype)
        o = _ops.softmax_attention(q, k, v, causal=True, chunk=cfg.la.chunk,
                                   backend=cfg.la.backend)
        return self.out(p, o, compute_dtype)

    def apply_noncausal(self, *args, **kwargs):
        raise NotImplementedError(
            "non-causal softmax attention runs only on the encoder-decoder "
            "path and comes with that slice (ROADMAP.md queue 1 "
            "'Remaining architectures')")

    def init_cache(self, cfg, batch: int, max_len: int, device="cuda",
                   dtype=torch.bfloat16):
        shape = (batch, cfg.num_kv_heads, max_len, cfg.resolved_head_dim)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    def prefill(self, p, cfg, x, positions, cache, compute_dtype=None):
        """CONTINUATION prefill: the window's k/v are written at each
        slot's absolute offset (in place), then the window's queries
        attend to the cached prefix plus themselves through the per-slot
        `q_offset` causal mask, the KV walk bounded at the deepest slot's
        frontier."""
        q, k, v = self.project_qkv(p, cfg, x, positions, compute_dtype)
        start = positions[:, 0]
        _scatter_window(cache.k, k, start)
        _scatter_window(cache.v, v, start)
        o = _ops.softmax_attention(q, cache.k, cache.v, causal=True,
                                   chunk=cfg.la.chunk, backend=cfg.la.backend,
                                   q_offset=start.to(torch.int32))
        return self.out(p, o, compute_dtype), cache

    def decode(self, p, cfg, x, position, cache, compute_dtype=None):
        """x: (B, 1, C); position: (B, 1) PER-SLOT absolute positions.

        The token's k/v land at each slot's position (in place), then
        slot b attends to its first pos_b + 1 keys."""
        q, k, v = self.project_qkv(p, cfg, x, position, compute_dtype)
        pos = position[:, 0]
        _scatter_window(cache.k, k, pos)
        _scatter_window(cache.v, v, pos)
        decode = (_ops.softmax_decode_fused if cfg.la.fused_decode
                  else _ops.softmax_decode)
        o = decode(q, cache.k, cache.v, (pos + 1).to(torch.int32),
                   backend=cfg.la.backend)
        return self.out(p, o.to(x.dtype), compute_dtype), cache
