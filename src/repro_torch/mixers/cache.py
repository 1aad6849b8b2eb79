"""Per-backend decode-cache types (port of `repro/mixers/cache.py`).

  LAState       linear           O(Dk·Dv) recurrent state (the
                                 paper's story)
  KVCache       softmax          O(S) per layer key/value cache,
                                 contiguous
  PagedKVCache  softmax (paged)  fixed-size KV pages shared across
                                 slots + per-slot page table

The GLA and SSM caches come with their backends (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.chunked import LAState, init_state

__all__ = ["LAState", "init_state", "KVCache", "PagedKVCache"]


class KVCache(NamedTuple):
    """Softmax-backend decode cache: O(S) per layer, in the compute
    dtype."""

    k: torch.Tensor  # (B, Hkv, S, hd)
    v: torch.Tensor  # (B, Hkv, S, hd)


class PagedKVCache(NamedTuple):
    """Softmax-backend paged decode cache (cfg.paging).

    The arenas are SHARED across slots: memory is spent on pages
    actually written, not on batch x max_len, and `page_table[b, i]`
    names the arena page holding slot b's tokens [i*ps, (i+1)*ps).
    Unallocated table entries point at the engine's reserved write-sink
    page (arena page num_pages - 1); attention masks by per-slot length,
    so whatever that page holds is never read into a live output.
    """

    k_pages: torch.Tensor     # (num_pages, Hkv, page_size, hd)
    v_pages: torch.Tensor     # (num_pages, Hkv, page_size, hd)
    page_table: torch.Tensor  # (B, ceil(max_len / page_size)) int32
