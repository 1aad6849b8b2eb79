"""Per-backend decode-cache types (port of `repro/mixers/cache.py`).

  LAState   linear   O(Dk·Dv) recurrent state (the paper's story)

The KV, paged and SSM caches come with their backends (ROADMAP.md).
"""
from __future__ import annotations

from repro_torch.core.chunked import LAState, init_state

__all__ = ["LAState", "init_state"]
