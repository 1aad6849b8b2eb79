"""Decoder block: norm + mixer (+ FFN) with residuals.

Port of the decoder half of `repro/models/blocks.py` (training
`block_apply`, serving `block_prefill` / `block_decode`): the dense
block (a norm, the mixer and an FFN of `cfg.mlp_act`, swiglu or gelu,
with the parallel residual of pythia or the sequential one of qwen2.5,
stablelm, chatglm3, granite, zamba2's shared attention block and the moe
family), the MoE block (the routed-expert FFN of models/moe.py with its
shared experts, moonshot-v1-16b-a3b and deepseek-v2-236b; the first
`cfg.moe.first_dense_layers` are dense blocks of `cfg.moe.dense_d_ff`)
and the Mamba-2 block (no FFN: `backend.fuses_ffn`, the mixer carries its
own channel mixing; mamba2 and zamba2's mamba layers).  Then the
encoder-decoder's blocks (whisper): the encoder block (bidirectional
self-attention through the mixer's `apply_noncausal`, and an FFN) and
the cross-attention decoder block (causal self-attention, cross-attention
to the encoder output, an FFN; in serving, prefill builds the
cross-attention's state once and decode reads it).  Norms follow
`cfg.norm`.  The mixer is resolved through the backend registry, so
blocks never branch on backend names.

`block_apply` returns (y, aux): aux is the MoE load-balancing loss (0
for a dense FFN).  Training and prefill route with the capacity factor,
decode dropless, as the reference does.
"""
from __future__ import annotations

import torch

from repro_torch.mixers import get_backend
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import mlp_apply, mlp_init, norm_apply, \
    norm_init

F32 = torch.float32


def _ffn_init(gen, cfg, dtype, dense_ffn: bool = False):
    """MoE unless cfg.moe is None or the layer is forced dense (its width
    then cfg.moe.dense_d_ff, else cfg.d_ff)."""
    if cfg.moe is not None and not dense_ffn:
        return moe_mod.moe_init(gen, cfg, dtype)
    d_ff = cfg.d_ff
    if cfg.moe is not None:
        d_ff = cfg.moe.dense_d_ff or cfg.d_ff
    return mlp_init(gen, cfg.d_model, d_ff, cfg.mlp_act, dtype)


def _ffn_apply(p, cfg, x, compute_dtype, dropless: bool = False):
    """(y, aux): the MoE FFN where the params have a router (the
    structural marker the reference reads), else the dense one with aux
    0."""
    if "router" in p:
        return moe_mod.moe_apply(p, cfg, x, compute_dtype, dropless)
    return mlp_apply(p, x, cfg.mlp_act, compute_dtype), \
        torch.zeros((), dtype=F32, device=x.device)


def block_init(gen: torch.Generator, cfg, dtype=torch.float32,
               dense_ffn: bool = False):
    backend = get_backend(cfg)
    p = {"ln1": norm_init(cfg.d_model, dtype, gen.device, cfg.norm),
         "mixer": backend.init(gen, cfg, dtype)}
    if not backend.fuses_ffn:
        p["ln2"] = norm_init(cfg.d_model, dtype, gen.device, cfg.norm)
        p["ffn"] = _ffn_init(gen, cfg, dtype, dense_ffn)
    return p


def block_init_cache(cfg, batch: int, max_len: int, device="cuda",
                     dtype=torch.bfloat16):
    return get_backend(cfg).init_cache(cfg, batch, max_len, device, dtype)


def _residual(p, cfg, x, attn_out, compute_dtype, dropless=False):
    """(x + attn, 0) (mamba2: the mixer is the whole block), else x + attn
    + ffn, with the parallel residual x + attn(ln1 x) + mlp(ln2 x) (pythia)
    or the sequential one, and the FFN's aux loss."""
    if get_backend(cfg).fuses_ffn:
        return x + attn_out, torch.zeros((), dtype=F32, device=x.device)
    if cfg.parallel_residual:
        ffn_out, aux = _ffn_apply(p["ffn"], cfg,
                                  norm_apply(p["ln2"], x, cfg.norm),
                                  compute_dtype, dropless)
        return x + attn_out + ffn_out, aux
    x = x + attn_out
    ffn_out, aux = _ffn_apply(p["ffn"], cfg, norm_apply(p["ln2"], x,
                                                        cfg.norm),
                              compute_dtype, dropless)
    return x + ffn_out, aux


def block_apply(p, cfg, x, positions, compute_dtype=None):
    """Training: the causal mixer over the whole sequence, then the
    residuals.  Returns (y, aux loss f32)."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out = get_backend(cfg).apply(p["mixer"], cfg, h, positions,
                                      compute_dtype)
    return _residual(p, cfg, x, attn_out, compute_dtype)


def block_prefill(p, cfg, x, positions, cache, compute_dtype=None):
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out, cache = get_backend(cfg).prefill(p["mixer"], cfg, h,
                                               positions, cache,
                                               compute_dtype)
    return _residual(p, cfg, x, attn_out, compute_dtype)[0], cache


def block_decode(p, cfg, x, position, cache, compute_dtype=None):
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out, cache = get_backend(cfg).decode(p["mixer"], cfg, h, position,
                                              cache, compute_dtype)
    return _residual(p, cfg, x, attn_out, compute_dtype,
                     dropless=True)[0], cache


# ---------------------------------------------------------------------------
# Encoder block (bidirectional self-attention; whisper's encoder)
# ---------------------------------------------------------------------------

def enc_block_init(gen: torch.Generator, cfg, dtype=torch.float32):
    return {"ln1": norm_init(cfg.d_model, dtype, gen.device, cfg.norm),
            "attn": get_backend(cfg).init(gen, cfg, dtype),
            "ln2": norm_init(cfg.d_model, dtype, gen.device, cfg.norm),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)}


def enc_block_apply(p, cfg, x, compute_dtype=None):
    h = norm_apply(p["ln1"], x, cfg.norm)
    x = x + get_backend(cfg).apply_noncausal(p["attn"], cfg, h, h,
                                             compute_dtype=compute_dtype)
    return x + mlp_apply(p["ffn"], norm_apply(p["ln2"], x, cfg.norm),
                         cfg.mlp_act, compute_dtype)


# ---------------------------------------------------------------------------
# Cross-attention decoder block (whisper's decoder)
# ---------------------------------------------------------------------------

def xdec_block_init(gen: torch.Generator, cfg, dtype=torch.float32):
    backend = get_backend(cfg)
    return {"ln1": norm_init(cfg.d_model, dtype, gen.device, cfg.norm),
            "self": backend.init(gen, cfg, dtype),
            "ln_x": norm_init(cfg.d_model, dtype, gen.device, cfg.norm),
            "cross": backend.init(gen, cfg, dtype),
            "ln2": norm_init(cfg.d_model, dtype, gen.device, cfg.norm),
            "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)}


def _xdec_tail(p, cfg, x, cross_out, compute_dtype):
    """x + the cross-attention's output, then the FFN's residual."""
    x = x + cross_out
    return x + mlp_apply(p["ffn"], norm_apply(p["ln2"], x, cfg.norm),
                         cfg.mlp_act, compute_dtype)


def xdec_block_apply(p, cfg, x, enc, positions, compute_dtype=None):
    backend = get_backend(cfg)
    h = norm_apply(p["ln1"], x, cfg.norm)
    x = x + backend.apply(p["self"], cfg, h, positions, compute_dtype)
    h = norm_apply(p["ln_x"], x, cfg.norm)
    return _xdec_tail(p, cfg, x, backend.apply_noncausal(
        p["cross"], cfg, h, enc, compute_dtype=compute_dtype), compute_dtype)


def xdec_block_prefill(p, cfg, x, enc, positions, cache, compute_dtype=None):
    """cache: {"self": the mixer's cache, "cross": ignored}; returns (y,
    {"self": its new cache, "cross": the CrossState of enc})."""
    backend = get_backend(cfg)
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out, self_cache = backend.prefill(p["self"], cfg, h, positions,
                                           cache["self"], compute_dtype)
    x = x + attn_out
    cross = backend.cross_precompute(p["cross"], cfg, enc, compute_dtype)
    h = norm_apply(p["ln_x"], x, cfg.norm)
    x = _xdec_tail(p, cfg, x, backend.apply_noncausal(
        p["cross"], cfg, h, enc, compute_dtype=compute_dtype), compute_dtype)
    return x, {"self": self_cache, "cross": cross}


def xdec_block_decode(p, cfg, x, position, cache, compute_dtype=None):
    backend = get_backend(cfg)
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out, self_cache = backend.decode(p["self"], cfg, h, position,
                                          cache["self"], compute_dtype)
    x = x + attn_out
    h = norm_apply(p["ln_x"], x, cfg.norm)
    x = _xdec_tail(p, cfg, x, backend.cross_decode(
        p["cross"], cfg, h, cache["cross"], compute_dtype), compute_dtype)
    return x, {"self": self_cache, "cross": cache["cross"]}
