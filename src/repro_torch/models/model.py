"""The LM: embed -> blocks -> norm -> unembed.

Port of `repro/models/model.py`, every family: the dense stacks of
pythia-1.4b, qwen2.5-3b, stablelm-1.6b, chatglm3-6b and granite-20b, the
vlm qwen2-vl-7b (a dense stack under M-RoPE: positions (3, B, N) from
the batch, the next rope position of each slot in cache["rope_pos"],
which lags the token count after image patches), the MoE stacks of
moonshot-v1-16b-a3b (attention) and deepseek-v2-236b (the MLA mixer),
each with its dense first layers (`prefix_blocks`) before the stack, the
pure Mamba-2 stack of mamba2-2.7b, zamba2-7b's hybrid (groups of Mamba-2
blocks, one SHARED attention block applied after each group, a tail of
Mamba-2 blocks) and whisper-large-v3's encoder-decoder (frames plus
sinusoids through the bidirectional encoder and its norm, then the
cross-attention decoder under sinusoids; serving prefills once, which
builds each layer's cross-attention state, and decodes against it):
training (`forward_hidden`, `chunked_cross_entropy`, `loss_fn`,
`forward_logits`) and serving (`init_params`, `init_cache`, `prefill`,
`decode_step`).  Tied embeddings (mamba2, qwen2.5, whisper) have no
lm_head: the loss and the logits unembed through the embedding table in
f32.  A logit softcap c
tanh(logits / c) applies to `forward_logits` and the last-token logits,
not to the loss, as in the reference.  The MoE blocks' load-balancing
losses are summed over the prefix and the stack, and `loss_fn` adds
`cfg.moe.aux_loss_weight` times that sum.  Layers are Python lists of
per-layer param dicts (the reference stacks them on axis 0 for lax.scan;
convert.py unstacks): `prefix_blocks` and `blocks`, or `mamba_groups` (g
lists of m), `shared_attn` and `tail`, or `enc_blocks` and `dec_blocks`.
Logits are computed in f32.

`cfg.remat` recomputes each block in the backward
(`torch.utils.checkpoint`, non-reentrant): the counterpart of the
reference's `jax.checkpoint` around its scanned block body, so only the
blocks' inputs stay alive between forward and backward.  The prefix
blocks, which the reference runs outside its scan, are recomputed too:
the numbers are the same, the memory less.  The hybrid family is also
recomputed per group, as the reference does, so the shared block's
internals are not kept for every group application.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.mixers.cache import CrossState
from repro_torch.models import blocks as blk
from repro_torch.models.common import dense, dense_init, dtype_of, \
    embed_init, embed_lookup, norm_apply, norm_init, sinusoid_positions, \
    unembed

F32 = torch.float32
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")


def _check_family(cfg):
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}; known: "
                         f"{FAMILIES}")


def _attn_variant(cfg):
    """Config view for zamba2's shared attention block (attention
    mixer)."""
    return dataclasses.replace(cfg, mixer="attention", moe=None)


def prefix_layers(cfg) -> int:
    """The dense first layers of an MoE stack (0 elsewhere)."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


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
    params = {"embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
              "ln_f": norm_init(cfg.d_model, pd, dev, cfg.norm)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                                       dtype=pd)
    if cfg.family == "encdec":
        params["enc_blocks"] = [blk.enc_block_init(gen, cfg, pd)
                                for _ in range(cfg.encoder_layers)]
        params["ln_enc"] = norm_init(cfg.d_model, pd, dev, cfg.norm)
        params["dec_blocks"] = [blk.xdec_block_init(gen, cfg, pd)
                                for _ in range(cfg.num_layers)]
        return params
    if cfg.family == "hybrid":
        g, m, t = cfg.hybrid_groups, cfg.hybrid_mamba_per_group, \
            cfg.hybrid_tail
        params["mamba_groups"] = [[blk.block_init(gen, cfg, pd)
                                   for _ in range(m)] for _ in range(g)]
        params["shared_attn"] = blk.block_init(gen, _attn_variant(cfg), pd)
        if t:
            params["tail"] = [blk.block_init(gen, cfg, pd)
                              for _ in range(t)]
        return params
    n_prefix = prefix_layers(cfg)
    if n_prefix:
        params["prefix_blocks"] = [blk.block_init(gen, cfg, pd,
                                                  dense_ffn=True)
                                   for _ in range(n_prefix)]
    params["blocks"] = [blk.block_init(gen, cfg, pd)
                        for _ in range(cfg.num_layers - n_prefix)]
    return params


def compute_params(params, cfg):
    """Params with every matrix the compute path casts at use stored once
    in cfg.compute_dtype: the numbers equal the reference's cast at each
    call.  The lm_head stays as it is (logits are computed in f32), and
    so do norm params (norms compute in f32), a tied embedding table (it
    also unembeds, in f32 from the param dtype), mamba2's conv_w (its
    decode step convolves in f32 with the weight in the param dtype) and
    an MoE router (f32, its logits computed in f32)."""
    cdt = dtype_of(cfg.compute_dtype)
    kept = ("lm_head", "ln1", "ln2", "ln_f", "conv_w", "router") + (
        ("embed",) if cfg.tie_embeddings else ())

    def cast(tree, keep=False):
        if isinstance(tree, dict):
            return {k: cast(v, keep or k in kept) for k, v in tree.items()}
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


def _apply(fn, cfg, *args):
    """fn(*args), recomputed in the backward where cfg.remat."""
    if cfg.remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _blocks(layers, cfg, x, positions, cdt):
    """x through a list of blocks, each recomputed under cfg.remat; returns
    (x, the sum of their aux losses, f32)."""
    aux = torch.zeros((), dtype=F32, device=x.device)
    for lp in layers:
        x, a = _apply(blk.block_apply, cfg, lp, cfg, x, positions, cdt)
        aux = aux + a
    return x, aux


def _group(group, shared, cfg, x, positions, cdt):
    """One hybrid group: its Mamba-2 blocks, then the shared attention
    block."""
    x, _ = _blocks(group, cfg, x, positions, cdt)
    return blk.block_apply(shared, _attn_variant(cfg), x, positions,
                           cdt)[0]


def _sinusoids(n: int, cfg, cdt, device):
    """The first n sinusoidal position rows, in the compute dtype."""
    return sinusoid_positions(n, cfg.d_model, device=device).to(cdt)


def _encode(params, cfg, frames, cdt):
    """whisper's encoder: frames (B, T, d) plus sinusoids through the
    encoder blocks (each recomputed in the backward under cfg.remat) and
    ln_enc."""
    enc = frames.to(cdt) + _sinusoids(frames.shape[1], cfg, cdt,
                                      frames.device)
    for lp in params["enc_blocks"]:
        enc = _apply(blk.enc_block_apply, cfg, lp, cfg, enc, cdt)
    return norm_apply(params["ln_enc"], enc, cfg.norm)


def forward_hidden(params, cfg, batch):
    """batch: {"tokens": (B, N) int} (+ "positions" (3, B, N) for M-RoPE,
    + "frames" (B, T, d) for the encoder-decoder).  Returns (hidden (B,
    N, d) in the compute dtype, aux loss f32: the MoE blocks' summed, 0
    without MoE)."""
    _check_family(cfg)
    cdt = dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"]
    positions = _positions(batch, tokens)
    x = embed_lookup(params["embed"], tokens, cdt)
    if cfg.family == "encdec":
        enc = _encode(params, cfg, batch["frames"], cdt)
        x = x + _sinusoids(x.shape[1], cfg, cdt, x.device)
        for lp in params["dec_blocks"]:
            x = _apply(blk.xdec_block_apply, cfg, lp, cfg, x, enc,
                       positions, cdt)
        aux = torch.zeros((), dtype=F32, device=x.device)
    elif cfg.family == "hybrid":
        # remat at the group level too: the shared attention block's
        # internals are not kept for every group application
        for group in params["mamba_groups"]:
            x = _apply(_group, cfg, group, params["shared_attn"], cfg, x,
                       positions, cdt)
        x, aux = _blocks(params.get("tail", []), cfg, x, positions, cdt)
    else:
        if cfg.rope_kind == "sinusoid":
            x = x + _sinusoids(x.shape[1], cfg, cdt, x.device)
        x, aux = _blocks(params.get("prefix_blocks", []), cfg, x,
                         positions, cdt)
        x, a = _blocks(params["blocks"], cfg, x, positions, cdt)
        aux = aux + a
    return norm_apply(params["ln_f"], x, cfg.norm), aux


def _softcap(logits, cfg):
    if cfg.logit_softcap:
        return cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def forward_logits(params, cfg, batch):
    """Full (B, N, V) f32 logits, softcapped where cfg.logit_softcap:
    small-scale use only (tests, examples)."""
    hidden, _ = forward_hidden(params, cfg, batch)
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], hidden.float())
    else:
        logits = dense(params["lm_head"], hidden, F32)
    return _softcap(logits, cfg)


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


def _unembed_weight(params, cfg):
    """(d_model, vocab) in f32 for the loss: the tied embedding table
    transposed, or the lm_head."""
    if cfg.tie_embeddings:
        return params["embed"]["table"].float().T
    return params["lm_head"]["w"].float()


def loss_fn(params, cfg, batch):
    """Next-token CE + cfg.moe.aux_loss_weight x the MoE aux loss.
    Returns (loss, {"ce": ce, "aux": aux})."""
    hidden, aux = forward_hidden(params, cfg, batch)
    tokens = batch["tokens"]
    labels = torch.nn.functional.pad(tokens[:, 1:], (0, 1))
    mask = torch.ones(tokens.shape, dtype=F32, device=tokens.device)
    mask[:, -1] = 0.0
    if "loss_mask" in batch:
        mask = mask * batch["loss_mask"].float()
    ce = chunked_cross_entropy(hidden, _unembed_weight(params, cfg), labels,
                               mask)
    aux_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    return ce + aux_w * aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """Decode cache for the whole model: per-layer caches (LAStates and
    GLAStates in f32; KV caches, or with cfg.paging paged KV arenas each
    with its own page table at the sink page, in the compute dtype, as
    the reference's; MambaCaches: the f32 SSD state and the conv tail in
    the compute dtype) and the per-slot position counter.  Dense and ssm:
    {"blocks": [L], "pos"}; vlm: the same + "rope_pos" (B,) int32, each
    slot's next M-RoPE position; moe: {"blocks": [L - p], "prefix": [p]
    (its p dense first layers), "pos"}; hybrid: {"mamba": [g][m],
    "shared": [g] (one cache per application of the shared block), "tail":
    [t], "pos"}; encdec: {"self": [L] decoder self-attention caches,
    "cross": [L] f32 CrossStates (zeros until prefill builds them from the
    encoder output), "pos"}."""
    _check_family(cfg)
    dev = resolve_device(device)
    dtype = dtype_of(cfg.compute_dtype)

    def one(c):
        return blk.block_init_cache(c, batch, max_len, dev, dtype)

    if cfg.family == "encdec":
        hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
        cache = {"self": [one(cfg) for _ in range(cfg.num_layers)],
                 "cross": [CrossState(
                     s=torch.zeros((batch, hkv, hd, hd + 1), dtype=F32,
                                   device=dev),
                     p=torch.zeros((batch, hkv, hd + 1), dtype=F32,
                                   device=dev))
                     for _ in range(cfg.num_layers)]}
    elif cfg.family == "hybrid":
        g, m, t = cfg.hybrid_groups, cfg.hybrid_mamba_per_group, \
            cfg.hybrid_tail
        cache = {"mamba": [[one(cfg) for _ in range(m)] for _ in range(g)],
                 "shared": [one(_attn_variant(cfg)) for _ in range(g)]}
        if t:
            cache["tail"] = [one(cfg) for _ in range(t)]
    else:
        n_prefix = prefix_layers(cfg)
        cache = {"blocks": [one(cfg)
                            for _ in range(cfg.num_layers - n_prefix)]}
        if n_prefix:
            cache["prefix"] = [one(cfg) for _ in range(n_prefix)]
    cache["pos"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.rope_kind == "mrope":
        # the next rope position of each slot (it lags the token count
        # where image patches share t/h/w grid positions)
        cache["rope_pos"] = torch.zeros((batch,), dtype=torch.int32,
                                        device=dev)
    return cache


def _layers(params, cfg, cache):
    """(block params, config view, holder, index) of every block in the
    order the model runs them; the block's cache is holder[index]."""
    if cfg.family != "hybrid":
        return [(lp, cfg, cache["prefix"], i)
                for i, lp in enumerate(params.get("prefix_blocks", []))] + [
            (lp, cfg, cache["blocks"], i)
            for i, lp in enumerate(params["blocks"])]
    acfg = _attn_variant(cfg)
    out = []
    for gi, group in enumerate(params["mamba_groups"]):
        out += [(lp, cfg, cache["mamba"][gi], j)
                for j, lp in enumerate(group)]
        out.append((params["shared_attn"], acfg, cache["shared"], gi))
    return out + [(lp, cfg, cache["tail"], j)
                  for j, lp in enumerate(params.get("tail", []))]


def _new_lists(tree):
    """The cache's dicts and lists anew, its leaves shared."""
    if isinstance(tree, dict):
        return {k: _new_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_new_lists(v) for v in tree]
    return tree


def _last_logits(params, cfg, x_last):
    """(B, V) f32 logits of the last position: through the tied
    embedding table (param dtype, in f32) or the lm_head; softcapped
    where cfg.logit_softcap."""
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], x_last.float())
    else:
        logits = dense(params["lm_head"], x_last, F32)
    return _softcap(logits, cfg)[:, 0]


def prefill(params, cfg, batch, cache):
    """Run a prompt (or a continuation window of one) against `cache`;
    batch is {"tokens": (B, N)} (+ "positions" (3, B, N) under M-RoPE,
    + "frames" (B, T, d) for the encoder-decoder).  Returns (last-token
    logits (B, V) f32, new cache).

    Positions and the pos counter CONTINUE from cache["pos"] (or come
    from batch["positions"]), so chunked prefill (window by window,
    carrying the recurrent state or the KV cache) is exact; under M-RoPE
    cache["rope_pos"] becomes one past the last token's largest stream
    position.  The encoder-decoder prefills once: it runs the encoder,
    builds each layer's cross-attention state from its output, and gives
    the decoder sinusoids from position 0, as the reference does.  A
    recurrent state comes back as new tensors; a KV cache (softmax,
    contiguous or paged) is written in place and comes back as the same
    tensors, which saves copying max_len rows per layer and window.  The
    input's position counters are not modified.
    """
    cdt = dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"]
    n = tokens.shape[1]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = cache["pos"][:, None] + torch.arange(
            n, dtype=torch.int32, device=tokens.device)[None]
    x = embed_lookup(params["embed"], tokens, cdt)
    new = _new_lists(cache)
    if cfg.family == "encdec":
        enc = _encode(params, cfg, batch["frames"], cdt)
        x = x + _sinusoids(n, cfg, cdt, x.device)
        for i, lp in enumerate(params["dec_blocks"]):
            x, nc = blk.xdec_block_prefill(
                lp, cfg, x, enc, positions,
                {"self": new["self"][i], "cross": None}, cdt)
            new["self"][i], new["cross"][i] = nc["self"], nc["cross"]
    else:
        if cfg.rope_kind == "sinusoid":
            x = x + _sinusoids(n, cfg, cdt, x.device)
        for lp, lcfg, holder, i in _layers(params, cfg, new):
            x, holder[i] = blk.block_prefill(lp, lcfg, x, positions,
                                             holder[i], cdt)
        if cfg.rope_kind == "mrope":
            new["rope_pos"] = (positions[:, :, -1].amax(0) + 1).to(
                torch.int32)
    new["pos"] = cache["pos"] + n
    x = norm_apply(params["ln_f"], x[:, -1:], cfg.norm)
    return _last_logits(params, cfg, x), new


def _sinusoid_at(pos, d: int):
    """Per-slot sinusoidal embedding at positions pos (B,) -> (B, 1, d)
    f32."""
    inv = torch.exp(-torch.arange(0, d, 2, dtype=F32, device=pos.device)
                    / d * math.log(10000.0))
    ang = pos.float()[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)[:, None]


def decode_step(params, cfg, cache, tokens):
    """tokens: (B,) — one new token per slot.  Returns (logits (B, V) f32,
    cache).

    The cache is updated IN PLACE (the reference's engine donates it):
    the fused decode kernel rewrites each layer's state, or the token's
    k/v land in each layer's KV cache, or (a Mamba-2 block, whose decode
    is the reference's functional plain step) the layer's new MambaCache
    replaces its entry; the position counters advance (under M-RoPE all
    three streams from cache["rope_pos"], as text does) and the same dict
    is returned.  The encoder-decoder's cross-attention states are read,
    not written.
    """
    cdt = dtype_of(cfg.compute_dtype)
    pos = cache["pos"]                       # (B,) — per-slot depths
    position = pos[:, None]
    if cfg.rope_kind == "mrope":
        position = cache["rope_pos"][None, :, None].expand(
            3, tokens.shape[0], 1)
    x = embed_lookup(params["embed"], tokens[:, None], cdt)
    if cfg.rope_kind == "sinusoid":
        x = x + _sinusoid_at(pos, cfg.d_model).to(cdt)
    if cfg.family == "encdec":
        for i, lp in enumerate(params["dec_blocks"]):
            x, nc = blk.xdec_block_decode(
                lp, cfg, x, position,
                {"self": cache["self"][i], "cross": cache["cross"][i]}, cdt)
            cache["self"][i] = nc["self"]
    else:
        for lp, lcfg, holder, i in _layers(params, cfg, cache):
            x, holder[i] = blk.block_decode(lp, lcfg, x, position,
                                            holder[i], cdt)
    pos += 1
    if cfg.rope_kind == "mrope":
        cache["rope_pos"] += 1
    x = norm_apply(params["ln_f"], x, cfg.norm)
    return _last_logits(params, cfg, x), cache
