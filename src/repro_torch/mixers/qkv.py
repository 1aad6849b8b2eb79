"""Shared GQA projection machinery for the attention-shaped backends.

Port of `repro/mixers/qkv.py`: `GQAProjectionBackend` owns the
wq/wk/wv/wo params, head split/merge and rope application (M-RoPE with
the config's sections), and the non-causal projection: q from x, k and
v from a context (the encoder and cross-attention).
"""
from __future__ import annotations

import torch

from repro_torch.mixers.base import AttentionBackend
from repro_torch.models.common import dense, dense_init
from repro_torch.models.rope import apply_rope

F32 = torch.float32


def split_heads(x, heads, hd):
    b, n, _ = x.shape
    return x.reshape(b, n, heads, hd).transpose(1, 2)


def merge_heads(x):
    b, h, n, hd = x.shape
    return x.transpose(1, 2).reshape(b, n, h * hd)


class GQAProjectionBackend(AttentionBackend):
    supports_noncausal = True

    def init(self, gen, cfg, dtype=F32):
        hd = cfg.resolved_head_dim
        return {
            "wq": dense_init(gen, cfg.d_model, cfg.num_heads * hd,
                             bias=cfg.qkv_bias, dtype=dtype),
            "wk": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                             bias=cfg.qkv_bias, dtype=dtype),
            "wv": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd,
                             bias=cfg.qkv_bias, dtype=dtype),
            "wo": dense_init(gen, cfg.num_heads * hd, cfg.d_model,
                             dtype=dtype),
        }

    def project_qkv(self, p, cfg, x, positions, compute_dtype):
        hd = cfg.resolved_head_dim
        q = split_heads(dense(p["wq"], x, compute_dtype), cfg.num_heads, hd)
        k = split_heads(dense(p["wk"], x, compute_dtype),
                        cfg.num_kv_heads, hd)
        v = split_heads(dense(p["wv"], x, compute_dtype),
                        cfg.num_kv_heads, hd)
        if cfg.rope_kind not in ("none", "sinusoid"):
            q, k = self._rope(cfg, q, k, positions)
        return q, k, v

    def project_noncausal(self, p, cfg, x, ctx, positions, compute_dtype):
        """q from x, k and v from ctx (self-bidirectional or cross); rope
        only where positions are given."""
        hd = cfg.resolved_head_dim
        q = split_heads(dense(p["wq"], x, compute_dtype), cfg.num_heads, hd)
        k = split_heads(dense(p["wk"], ctx, compute_dtype),
                        cfg.num_kv_heads, hd)
        v = split_heads(dense(p["wv"], ctx, compute_dtype),
                        cfg.num_kv_heads, hd)
        if positions is not None and cfg.rope_kind not in ("none",
                                                           "sinusoid"):
            q, k = self._rope(cfg, q, k, positions)
        return q, k, v

    @staticmethod
    def _rope(cfg, q, k, positions):
        return tuple(apply_rope(t, positions, cfg.rope_kind,
                                cfg.rope_fraction, cfg.rope_theta,
                                cfg.mrope_sections) for t in (q, k))

    def out(self, p, o_heads, compute_dtype):
        return dense(p["wo"], merge_heads(o_heads), compute_dtype)
