"""Per-backend decode-cache types (port of `repro/mixers/cache.py`).

  LAState   linear    O(Dk·Dv) recurrent state (the paper's story)
  KVCache   softmax   O(S) per layer key/value cache, contiguous

The paged, GLA and SSM caches come with their backends (ROADMAP.md).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.chunked import LAState, init_state

__all__ = ["LAState", "init_state", "KVCache"]


class KVCache(NamedTuple):
    """Softmax-backend decode cache: O(S) per layer, in the compute
    dtype."""

    k: torch.Tensor  # (B, Hkv, S, hd)
    v: torch.Tensor  # (B, Hkv, S, hd)
