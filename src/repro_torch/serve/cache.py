"""Serving-cache accounting: exact byte counts of the decode caches.

Port of `repro/serve/cache.py`'s `cache_bytes`, `per_slot_bytes` and
`page_bytes`, the units of the ByteBudget and PagedAdmission policies.
For a context of length S the softmax backend needs O(S * Hkv * hd) KV
bytes per layer and slot, the paper's linear backend an O(Hkv * Dk *
(Dv+1)) state whatever S.  `cache_bytes` builds the model's own
`init_cache` on PyTorch's meta device (shapes and dtypes, no memory), so
it is exact for every backend the port has, as the reference's
eval_shape is.
"""
from __future__ import annotations

from repro_torch.mixers.base import resolve_backend_name
from repro_torch.models import model as mdl
from repro_torch.models.common import dtype_of
from repro_torch.tree import leaves


def cache_bytes(cfg, batch: int, max_len: int) -> int:
    """Exact decode-cache bytes for (cfg, batch, context)."""
    cache = mdl.init_cache(cfg, batch, max_len, device="meta")
    return sum(t.numel() * t.element_size() for t in leaves(cache))


def per_slot_bytes(cfg, max_len: int) -> int:
    """Exact MARGINAL decode-cache bytes of one more concurrent sequence
    at this context, the unit ByteBudget spends: softmax pays O(max_len)
    per slot, the linear state O(D^2) whatever max_len.  GQA-exact: the
    KV leaves are (B, Hkv, S, hd), never the H query heads."""
    return cache_bytes(cfg, 2, max_len) - cache_bytes(cfg, 1, max_len)


def page_bytes(cfg, page_size: int) -> int:
    """Bytes one KV page costs across all layers, the unit
    PagedAdmission spends (page tables are int32 noise and are not
    charged): 2 (k and v) * page_size * Hkv * hd * itemsize per layer,
    in the compute dtype the engine allocates."""
    if resolve_backend_name(cfg) == "gla":
        raise NotImplementedError(
            "gla pages hold one slot's recurrent state each; their price "
            "comes with the GLA slice (ROADMAP.md queue 1 item 9)")
    return (2 * page_size * cfg.num_kv_heads * cfg.resolved_head_dim
            * dtype_of(cfg.compute_dtype).itemsize * cfg.num_layers)
