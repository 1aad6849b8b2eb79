"""Serving-cache accounting and one slot's rows of the batched cache.

Port of `repro/serve/cache.py`'s `cache_bytes`, `per_slot_bytes`,
`state_page_bytes` and `page_bytes`, the units of the ByteBudget and
PagedAdmission policies, and of the engine's slot addressing
(`_cache_batch_dims`, `snap_fn` and `restore_fn` of
`repro/serve/engine.py`): `slot_leaves`, `snapshot_slot` and
`restore_slot`, which preemption uses to evict and restore a victim.
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
from repro_torch.tree import leaves, named_leaves


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


def state_page_bytes(cfg) -> int:
    """Bytes one GLA STATE page costs across all layers: a page holds a
    whole (Hkv, Dk, Dv+1) + (Hkv, Dv+1) decayed recurrent state in f32
    (mixers.cache.PagedGLAState), whatever page_size, because a state
    page is one slot's O(D^2) state, not a run of KV rows."""
    hd = cfg.resolved_head_dim
    per_layer = cfg.num_kv_heads * ((hd + 1) * hd + (hd + 1))
    return per_layer * 4 * cfg.num_layers


def page_bytes(cfg, page_size: int) -> int:
    """Bytes one page costs across all layers, the unit PagedAdmission
    spends (page tables are int32 noise and are not charged).  Softmax
    (KV pages): 2 (k and v) * page_size * Hkv * hd * itemsize per layer,
    in the compute dtype the engine allocates.  GLA (state pages): one
    whole recurrent state per page (`state_page_bytes`)."""
    if resolve_backend_name(cfg) == "gla":
        return state_page_bytes(cfg)
    return (2 * page_size * cfg.num_kv_heads * cfg.resolved_head_dim
            * dtype_of(cfg.compute_dtype).itemsize * cfg.num_layers)


def slot_leaves(cfg, max_len: int) -> list[bool]:
    """Per leaf of the model's cache (in `tree.leaves` order): whether it
    holds rows of its own for every slot, found by growing the batch
    from 1 to 2 on the meta device.  Those leaves carry the slot in dim
    0; the others are the paged arenas, shared by every slot."""
    one = named_leaves(mdl.init_cache(cfg, 1, max_len, device="meta"))
    two = leaves(mdl.init_cache(cfg, 2, max_len, device="meta"))
    out = []
    for (path, a), b in zip(one, two):
        if a.shape == b.shape:
            out.append(False)
        elif a.shape[1:] == b.shape[1:] and (a.shape[0], b.shape[0]) \
                == (1, 2):
            out.append(True)
        else:
            raise ValueError(f"cache leaf {path}: {tuple(a.shape)} at one "
                             f"slot, {tuple(b.shape)} at two; the slot "
                             f"must be dim 0")
    return out


def snapshot_slot(cache, rows: list[bool], slot: int) -> list:
    """Copies of one slot's own rows, on the cache's device: the
    leaves `rows` marks (KV rows or recurrent state, a page-table row,
    the position).  A paged arena is never copied: for the GLA state
    arena the snapshot is the table row and the position only, and the
    state page stays where it is."""
    return [t[slot:slot + 1].clone()
            for t, own in zip(leaves(cache), rows) if own]


def restore_slot(cache, snap: list, rows: list[bool], slot: int) -> None:
    """Write a `snapshot_slot` back into `slot`'s rows, in place (the
    slot may differ from the one it was taken from)."""
    it = iter(snap)
    for t, own in zip(leaves(cache), rows):
        if own:
            t[slot].copy_(next(it)[0])
