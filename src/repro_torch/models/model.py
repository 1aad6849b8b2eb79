"""Dense decoder-only LM: embed -> blocks -> norm -> unembed.

Port of the dense-family path of `repro/models/model.py`: training
(`forward_hidden`, `chunked_cross_entropy`, `loss_fn`) and serving
(`init_params`, `init_cache`, `prefill`, `decode_step`).  Layers are a
Python list of per-layer param dicts (the reference stacks them on axis
0 for lax.scan; convert.py unstacks).  Logits are computed in f32.

`cfg.remat` recomputes each block in the backward
(`torch.utils.checkpoint`, non-reentrant): the counterpart of the
reference's `jax.checkpoint` around its scanned block body, so only the
blocks' inputs stay alive between forward and backward.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.common import dense, dense_init, dtype_of, \
    embed_init, embed_lookup, norm_apply, norm_init

F32 = torch.float32


def _check_family(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet; the port runs the "
            f"dense family (ROADMAP.md queue 1 'Remaining architectures')")
    if cfg.tie_embeddings or cfg.logit_softcap or \
            cfg.rope_kind not in ("standard", "partial", "none"):
        raise NotImplementedError(
            "tied embeddings, logit softcap and sinusoid/M-RoPE positions "
            "are not ported yet (ROADMAP.md queue 1 'Remaining "
            "architectures')")


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights at the reference's scales (N(0, 1/d_in) dense,
    N(0, 0.02^2) embedding), drawn from one seeded torch.Generator on
    `device`.  The numbers differ from the reference's jax.random ones;
    tests carry the reference's weights over with convert.py."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    pd = dtype_of(cfg.param_dtype)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
        "ln_f": norm_init(cfg.d_model, pd, dev),
        "lm_head": dense_init(gen, cfg.d_model, cfg.vocab_size, dtype=pd),
        "blocks": [blk.block_init(gen, cfg, pd)
                   for _ in range(cfg.num_layers)],
    }


def compute_params(params, cfg):
    """Params with every matrix the compute path casts at use stored once
    in cfg.compute_dtype: the numbers equal the reference's cast at each
    call.  The lm_head stays as it is (logits are computed in f32) and
    so do norm params (norms compute in f32)."""
    cdt = dtype_of(cfg.compute_dtype)

    def cast(tree, keep=False):
        if isinstance(tree, dict):
            return {k: cast(v, keep or k in ("lm_head", "ln1", "ln2",
                                             "ln_f"))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v, keep) for v in tree]
        if keep or not tree.is_floating_point() or tree.dim() < 2:
            return tree
        return tree.to(cdt)

    return cast(params)


# ---------------------------------------------------------------------------
# Forward (training) — returns final hidden + aux loss
# ---------------------------------------------------------------------------

def _positions(batch, tokens):
    if "positions" in batch:
        return batch["positions"]
    b, n = tokens.shape
    return torch.arange(n, dtype=torch.int32,
                        device=tokens.device)[None].expand(b, n)


def forward_hidden(params, cfg, batch):
    """batch: {"tokens": (B, N) int}.  Returns (hidden (B, N, d) in the
    compute dtype, aux loss f32: 0 for the dense family)."""
    _check_family(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"]
    positions = _positions(batch, tokens)
    x = embed_lookup(params["embed"], tokens, cdt)
    for lp in params["blocks"]:
        if cfg.remat:
            x = checkpoint(blk.block_apply, lp, cfg, x, positions, cdt,
                           use_reentrant=False)
        else:
            x = blk.block_apply(lp, cfg, x, positions, cdt)
    aux = torch.zeros((), dtype=F32, device=x.device)
    return norm_apply(params["ln_f"], x), aux


# ---------------------------------------------------------------------------
# Loss — sequence-chunked cross-entropy (never materializes (B, N, V))
# ---------------------------------------------------------------------------

def _ce_chunk(h, w, y, m):
    """(sum of masked CE, mask count) of one sequence chunk, f32."""
    logits = torch.matmul(h.float(), w)
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y[..., None].long())[..., 0]
    return ((logz - ll) * m).sum(), m.sum()


def chunked_cross_entropy(hidden, w, labels, mask, chunk: int = 512):
    """hidden: (B, N, d); w: (d, V) f32; labels/mask: (B, N).

    Walks N in chunks; each chunk is checkpointed, so only its inputs
    are kept and the backward recomputes its (B, chunk, V) logits.
    """
    n = hidden.shape[1]
    loss_sum = torch.zeros((), dtype=F32, device=hidden.device)
    count = torch.zeros((), dtype=F32, device=hidden.device)
    for s in range(0, n, chunk):
        ls, cnt = checkpoint(_ce_chunk, hidden[:, s:s + chunk], w,
                             labels[:, s:s + chunk], mask[:, s:s + chunk],
                             use_reentrant=False)
        loss_sum, count = loss_sum + ls, count + cnt
    return loss_sum / torch.clamp(count, min=1.0)


def loss_fn(params, cfg, batch):
    """Next-token CE (+ the MoE aux term, 0 here).  Returns (loss,
    {"ce": ce, "aux": aux})."""
    hidden, aux = forward_hidden(params, cfg, batch)
    tokens = batch["tokens"]
    labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones(tokens.shape, dtype=F32, device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].float()
    ce = chunked_cross_entropy(hidden, params["lm_head"]["w"].float(),
                               labels, mask)
    return ce, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Decode cache for the whole model: per-layer caches (LAStates in
    f32; KV caches, or with cfg.paging paged KV arenas each with its
    own page table at the sink page, in the compute dtype, as the
    reference's) and the per-slot position counter."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)
    return {"blocks": [blk.block_init_cache(cfg, batch, max_len, dev, dtype)
                       for _ in range(cfg.num_layers)],
            "pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _last_logits(params, x_last):
    return dense(params["lm_head"], x_last, F32)[:, 0]


def prefill(params, cfg, batch, cache):
    """Run a prompt (or a continuation window of one) against `cache`;
    batch is {"tokens": (B, N)}.  Returns (last-token logits (B, V) f32,
    new cache).

    Positions and the pos counter CONTINUE from cache["pos"], so chunked
    prefill (window by window, carrying the recurrent state or the KV
    cache) is exact.  A recurrent state comes back as new tensors; a KV
    cache (softmax, contiguous or paged) is written in place and comes
    back as the same tensors, which saves copying max_len rows per layer
    and window.  The
    input's position counter is not modified.
    """
    cdt = dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"]
    n = tokens.shape[1]
    positions = cache["pos"][:, None] + torch.arange(
        n, dtype=torch.int32, device=tokens.device)[None]
    x = embed_lookup(params["embed"], tokens, cdt)
    new_blocks = []
    for lp, lc in zip(params["blocks"], cache["blocks"]):
        x, nc = blk.block_prefill(lp, cfg, x, positions, lc, cdt)
        new_blocks.append(nc)
    x = norm_apply(params["ln_f"], x[:, -1:])
    return _last_logits(params, x), {"blocks": new_blocks,
                                          "pos": cache["pos"] + n}


def decode_step(params, cfg, cache, tokens):
    """tokens: (B,) — one new token per slot.  Returns (logits (B, V) f32,
    cache).

    The cache is updated IN PLACE (the reference's engine donates it):
    the fused decode kernel rewrites each layer's state, or the token's
    k/v land in each layer's KV cache, and the position counter
    advances; the same dict is returned.
    """
    cdt = dtype_of(cfg.compute_dtype)
    pos = cache["pos"]                       # (B,) — per-slot depths
    position = pos[:, None]
    x = embed_lookup(params["embed"], tokens[:, None], cdt)
    for i, lp in enumerate(params["blocks"]):
        x, cache["blocks"][i] = blk.block_decode(
            lp, cfg, x, position, cache["blocks"][i], cdt)
    pos += 1
    x = norm_apply(params["ln_f"], x)
    return _last_logits(params, x), cache
