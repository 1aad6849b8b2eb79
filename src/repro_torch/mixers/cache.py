"""Per-backend decode-cache types (port of `repro/mixers/cache.py`).

  LAState       linear           O(Dk·Dv) recurrent state (the
                                 paper's story)
  GLAState      gla              the same, decay-gated (core/gla.py)
  PagedGLAState gla (paged)      GLA states in a shared page arena: one
                                 state page per slot
  KVCache       softmax          O(S) per layer key/value cache,
                                 contiguous
  PagedKVCache  softmax (paged)  fixed-size KV pages shared across
                                 slots + per-slot page table
  MambaCache    mamba2           SSD state + depthwise-conv window tail
  CrossState    linear cross     precomputed encoder-side LA state
                                 (whisper's cross-attention decode)
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.chunked import LAState, init_state
from repro_torch.core.gla import GLAState, init_gla_state
from repro_torch.core.ssd import SSDState, init_ssd_state

__all__ = ["LAState", "init_state", "GLAState", "init_gla_state",
           "PagedGLAState", "KVCache", "PagedKVCache", "MambaCache",
           "CrossState", "SSDState", "init_ssd_state"]


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


class PagedGLAState(NamedTuple):
    """GLA-backend paged decode cache (cfg.paging).

    A page holds one slot's whole (Hkv, Dk, Dv+1) decayed recurrent state
    (state pages, not KV-row pages), so every request needs exactly ONE
    page whatever its token count.  `page_table[b, 0]` names the arena
    page holding slot b's state; unassigned rows point at the engine's
    reserved write sink (arena page num_pages - 1), where retired slots
    keep decoding as batch padding without touching a live state.
    """

    s_pages: torch.Tensor     # (num_pages, Hkv, Dk, Dv+1) f32
    p_pages: torch.Tensor     # (num_pages, Hkv, Dv+1) f32
    page_table: torch.Tensor  # (B, 1) int32


class MambaCache(NamedTuple):
    """Mamba-2 decode cache: O(1) in the context length.

    The reference nests the state, `MambaCache(ssd=SSDState(s), conv)`;
    the port keeps it flat, so that the engine's `_install` copies a
    finished prefill's rows tensor by tensor as it does for every other
    cache (`SSDState(cache.s)` is the reference's `cache.ssd`).
    """

    s: torch.Tensor     # (B, H, state, hd) f32, the SSD state
    conv: torch.Tensor  # (B, conv_width - 1, conv_ch) in the compute dtype


class CrossState(NamedTuple):
    """The linear backend's cross-attention state, precomputed once from
    the encoder output (f32)."""

    s: torch.Tensor  # (B, Hkv, D, D+1) — sum_j k_j (x) [v_j, 1]
    p: torch.Tensor  # (B, Hkv, D+1)    — sum_j [v_j, 1]
