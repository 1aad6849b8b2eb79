"""Decoder block: norm + mixer (+ FFN) with residuals.

Port of the decoder half of `repro/models/blocks.py` (training
`block_apply`, serving `block_prefill` / `block_decode`): the dense
block (a norm, the mixer and an FFN of `cfg.mlp_act`, swiglu or gelu,
with the parallel residual of pythia or the sequential one of qwen2.5,
stablelm, chatglm3, granite and zamba2's shared attention block) and
the Mamba-2 block (no FFN: `backend.fuses_ffn`, the mixer carries its
own channel mixing; mamba2 and zamba2's mamba layers).  MoE, encoder
and cross-attention blocks come with their architectures.  Norms follow
`cfg.norm`.  The mixer is resolved through the backend registry, so
blocks never branch on backend names.
"""
from __future__ import annotations

import torch

from repro_torch.mixers import get_backend
from repro_torch.models.common import mlp_apply, mlp_init, norm_apply, \
    norm_init


def _check_block(cfg):
    if cfg.moe is not None:
        raise NotImplementedError(
            "the MoE FFN is not ported yet (ROADMAP.md queue 1 item 5, "
            "'MoE and MLA')")


def _ffn_init(gen, cfg, dtype):
    return mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act, dtype)


def _ffn_apply(p, cfg, x, compute_dtype):
    return mlp_apply(p, x, cfg.mlp_act, compute_dtype)


def block_init(gen: torch.Generator, cfg, dtype=torch.float32):
    backend = get_backend(cfg)
    _check_block(cfg)
    p = {"ln1": norm_init(cfg.d_model, dtype, gen.device, cfg.norm),
         "mixer": backend.init(gen, cfg, dtype)}
    if not backend.fuses_ffn:
        p["ln2"] = norm_init(cfg.d_model, dtype, gen.device, cfg.norm)
        p["ffn"] = _ffn_init(gen, cfg, dtype)
    return p


def block_init_cache(cfg, batch: int, max_len: int, device="cuda",
                     dtype=torch.bfloat16):
    return get_backend(cfg).init_cache(cfg, batch, max_len, device, dtype)


def _residual(p, cfg, x, attn_out, compute_dtype):
    """x + attn (mamba2: the mixer is the whole block), else x + attn +
    ffn, with the parallel residual x + attn(ln1 x) + mlp(ln2 x) (pythia)
    or the sequential one."""
    if get_backend(cfg).fuses_ffn:
        return x + attn_out
    if cfg.parallel_residual:
        ffn_out = _ffn_apply(p["ffn"], cfg,
                             norm_apply(p["ln2"], x, cfg.norm), compute_dtype)
        return x + attn_out + ffn_out
    x = x + attn_out
    return x + _ffn_apply(p["ffn"], cfg, norm_apply(p["ln2"], x, cfg.norm),
                          compute_dtype)


def block_apply(p, cfg, x, positions, compute_dtype=None):
    """Training: the causal mixer over the whole sequence, then the
    residuals.  The dense FFN has no aux loss (MoE comes with its
    architectures), so this returns the block's output only."""
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out = get_backend(cfg).apply(p["mixer"], cfg, h, positions,
                                      compute_dtype)
    return _residual(p, cfg, x, attn_out, compute_dtype)


def block_prefill(p, cfg, x, positions, cache, compute_dtype=None):
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out, cache = get_backend(cfg).prefill(p["mixer"], cfg, h,
                                               positions, cache,
                                               compute_dtype)
    return _residual(p, cfg, x, attn_out, compute_dtype), cache


def block_decode(p, cfg, x, position, cache, compute_dtype=None):
    h = norm_apply(p["ln1"], x, cfg.norm)
    attn_out, cache = get_backend(cfg).decode(p["mixer"], cfg, h, position,
                                              cache, compute_dtype)
    return _residual(p, cfg, x, attn_out, compute_dtype), cache
