"""Softmax-attention backend — the Regular-Attention baseline.

Port of `repro/mixers/softmax.py`.  Scores go through the "softmax"
KernelImpl family in kernels/ops.py: cfg.la.backend picks the chunked
online softmax ("torch"), the CUDA flash kernels ("cuda") or the
quadratic oracle ("ref"); "auto" picks by the tensors' device.  Training
runs the causal autograd Function with the flash recomputation backward;
continuation prefill runs the flash forward with per-slot `q_offset`;
decode writes the token at each slot's own position and attends to each
slot's own length, so slots at different depths decode exactly.  Two
cache layouts:

  contiguous  an O(S) KVCache per layer; decode through the fused (or,
              with `cfg.la.fused_decode=False`, the unfused)
              contiguous-cache decode
  paged       cfg.paging set: a PagedKVCache per layer, fixed-size KV
              pages in an arena shared by the slots, addressed by
              per-slot page tables; prefill writes its window into the
              slot's pages and attends to a page-table gather, decode
              reads K/V through the table in the "paged_decode_fused"
              (or, unfused, "paged") family's kernel

Both caches are written IN PLACE by prefill and decode: one indexed
write per tensor per layer, instead of the copy per layer and window a
functional update would cost (the reference's `dynamic_update_slice`
and `.at[].set` return new arrays).  Writes clamp as the reference's
do: a contiguous window whose start lies past max_len - n is written at
max_len - n, and a paged write whose page index runs past the table
uses the table's last entry, so a retired slot whose position keeps
advancing in the batched decode writes the cache's last row (its
paged row points at the sink page), and its length (pos + 1) is
clamped by the decode kernels.

`apply_noncausal` (the encoder-decoder's bidirectional and cross
attention) runs the plain chunked scan on every impl, as the reference
keeps it on XLA.  With M-RoPE positions (3, B, N) the cache is indexed
by the temporal stream (`_pos2d`), as in the reference.  That stream is
the token index only on a text-only stream: after image patches it lags
the token count, so a later window or decode step writes over earlier
rows and attends to too few keys.  The reference has the same defect
(`repro/mixers/softmax.py::_pos2d`); the engine and the launchers feed
text only (ROADMAP.md queue 3).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as _ops
from repro_torch.kernels.paged_attention import gather_pages
from repro_torch.mixers.base import register_backend
from repro_torch.mixers.cache import KVCache, PagedKVCache
from repro_torch.mixers.qkv import GQAProjectionBackend


def _pos2d(positions: torch.Tensor) -> torch.Tensor:
    """(B, N) positions; M-RoPE's (3, B, N) gives its temporal stream."""
    return positions if positions.dim() == 2 else positions[0]


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


def _write_pages(pages: torch.Tensor, new: torch.Tensor,
                 page_table: torch.Tensor, positions: torch.Tensor) -> None:
    """Write `new` (B, Hkv, n, hd) into the shared (P, Hkv, ps, hd) arena
    in place at ABSOLUTE positions (B, n), routed through the page table
    (B, Pmax).  Slots own their pages exclusively, so the (page, offset)
    pairs of live slots never collide across the batch."""
    b, hkv, n, hd = new.shape
    ps = pages.shape[2]
    pos = positions.to(pages.device).long()
    # clamp the table lookup: a RETIRED slot's position keeps advancing
    # past its table (it decodes on as batch padding), and its whole row
    # points at the engine's sink page anyway
    idx = torch.clamp(pos // ps, max=page_table.shape[1] - 1)
    page = torch.gather(page_table.long(), 1, idx)
    # advanced indices around a slice put the (B * n) axis first
    pages[page.reshape(-1), :, (pos % ps).reshape(-1)] = \
        new.transpose(1, 2).reshape(b * n, hkv, hd).to(pages.dtype)


@register_backend("softmax")
class SoftmaxAttentionBackend(GQAProjectionBackend):
    def apply(self, p, cfg, x, positions, compute_dtype=None):
        q, k, v = self.project_qkv(p, cfg, x, positions, compute_dtype)
        o = _ops.softmax_attention(q, k, v, causal=True, chunk=cfg.la.chunk,
                                   backend=cfg.la.backend)
        return self.out(p, o, compute_dtype)

    def apply_noncausal(self, p, cfg, x, ctx, positions=None,
                        compute_dtype=None):
        q, k, v = self.project_noncausal(p, cfg, x, ctx, positions,
                                         compute_dtype)
        o = _ops.softmax_attention(q, k, v, causal=False, chunk=cfg.la.chunk,
                                   backend=cfg.la.backend)
        return self.out(p, o, compute_dtype)

    def init_cache(self, cfg, batch: int, max_len: int, device="cuda",
                   dtype=torch.bfloat16):
        hd = cfg.resolved_head_dim
        if cfg.paging is not None:
            pg = cfg.paging
            arena = (pg.num_pages, cfg.num_kv_heads, pg.page_size, hd)
            # unallocated table entries point at the LAST arena page: the
            # engine reserves it as the write sink of padding decode, so
            # a slot without pages never writes into a live page
            return PagedKVCache(
                k_pages=torch.zeros(arena, dtype=dtype, device=device),
                v_pages=torch.zeros(arena, dtype=dtype, device=device),
                page_table=torch.full(
                    (batch, -(-max_len // pg.page_size)), pg.num_pages - 1,
                    dtype=torch.int32, device=device))
        shape = (batch, cfg.num_kv_heads, max_len, hd)
        return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                       v=torch.zeros(shape, dtype=dtype, device=device))

    def prefill(self, p, cfg, x, positions, cache, compute_dtype=None):
        """CONTINUATION prefill: the window's k/v are written at each
        slot's absolute offset (in place), then the window's queries
        attend to the cached prefix plus themselves through the per-slot
        `q_offset` causal mask, the KV walk bounded at the deepest slot's
        frontier.  A paged cache takes the window into the slot's own
        pages and attends to a page-table gather of its context (keys
        past the causal frontier, the sink page's included, are
        masked)."""
        q, k, v = self.project_qkv(p, cfg, x, positions, compute_dtype)
        positions = _pos2d(positions)
        start = positions[:, 0]
        if isinstance(cache, PagedKVCache):
            _write_pages(cache.k_pages, k, cache.page_table, positions)
            _write_pages(cache.v_pages, v, cache.page_table, positions)
            kc = gather_pages(cache.k_pages, cache.page_table)
            vc = gather_pages(cache.v_pages, cache.page_table)
        else:
            _scatter_window(cache.k, k, start)
            _scatter_window(cache.v, v, start)
            kc, vc = cache.k, cache.v
        o = _ops.softmax_attention(q, kc, vc, causal=True,
                                   chunk=cfg.la.chunk, backend=cfg.la.backend,
                                   q_offset=start.to(torch.int32))
        return self.out(p, o, compute_dtype), cache

    def decode(self, p, cfg, x, position, cache, compute_dtype=None):
        """x: (B, 1, C); position: (B, 1) PER-SLOT absolute positions.

        The token's k/v land at each slot's position (in place), then
        slot b attends to its first pos_b + 1 keys: in its contiguous
        cache, or through its page-table row in the paged arena."""
        q, k, v = self.project_qkv(p, cfg, x, position, compute_dtype)
        position = _pos2d(position)
        pos = position[:, 0]
        lengths = (pos + 1).to(torch.int32)
        if isinstance(cache, PagedKVCache):
            _write_pages(cache.k_pages, k, cache.page_table, position)
            _write_pages(cache.v_pages, v, cache.page_table, position)
            decode = (_ops.paged_attention_fused if cfg.la.fused_decode
                      else _ops.paged_attention)
            o = decode(q, cache.k_pages, cache.v_pages, cache.page_table,
                       lengths, backend=cfg.la.backend)
        else:
            _scatter_window(cache.k, k, pos)
            _scatter_window(cache.v, v, pos)
            decode = (_ops.softmax_decode_fused if cfg.la.fused_decode
                      else _ops.softmax_decode)
            o = decode(q, cache.k, cache.v, lengths, backend=cfg.la.backend)
        return self.out(p, o.to(x.dtype), compute_dtype), cache
