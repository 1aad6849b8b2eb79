"""The paper's linear-attention backend (normalized kernelized attention).

Port of `repro/mixers/linear.py`: f(x) = a + b x scores on l2-normalized
q/k, training through the causal autograd Function with the analytic
O(N D) backward (kernels/ops.py), an O(D^2) recurrent decode state
independent of context length, prefill through the plain chunked scan
and decode through the fused step family (kernels/decode_fused.py).

Learnable coefficients (paper §2.2): with cfg.la.learnable_coeffs, init
adds scalar (la_a, la_b) params and apply routes through the
differentiable-coefficient entry point.
"""
from __future__ import annotations

import torch

from repro_torch.core.linear_attention import la_attention, \
    la_attention_decode, la_attention_learnable, la_attention_prefill
from repro_torch.mixers.base import register_backend
from repro_torch.mixers.cache import init_state
from repro_torch.mixers.qkv import GQAProjectionBackend

F32 = torch.float32


@register_backend("linear")
class LinearAttentionBackend(GQAProjectionBackend):
    def init(self, gen, cfg, dtype=F32):
        p = super().init(gen, cfg, dtype)
        if cfg.la.learnable_coeffs:
            # f(x) = a + b x with learnable per-layer (a, b), initialized
            # at the Taylor coefficients of exp
            p["la_a"] = torch.tensor(cfg.la.a, dtype=F32, device=gen.device)
            p["la_b"] = torch.tensor(cfg.la.b, dtype=F32, device=gen.device)
        return p

    def apply(self, p, cfg, x, positions, compute_dtype=None):
        q, k, v = self.project_qkv(p, cfg, x, positions, compute_dtype)
        if "la_a" in p:
            o = la_attention_learnable(q, k, v, p["la_a"], p["la_b"], cfg.la)
        else:
            o = la_attention(q, k, v, cfg.la, causal=True)
        return self.out(p, o, compute_dtype)

    def init_cache(self, cfg, batch: int, max_len: int, device="cuda",
                   dtype=None):
        # O(D^2) f32 state, independent of max_len and the compute dtype
        hd = cfg.resolved_head_dim
        return init_state(batch, cfg.num_kv_heads, hd, hd, device=device)

    def prefill(self, p, cfg, x, positions, cache, compute_dtype=None):
        q, k, v = self.project_qkv(p, cfg, x, positions, compute_dtype)
        o, cache = la_attention_prefill(q, k, v, cfg.la, state=cache)
        return self.out(p, o, compute_dtype), cache

    def decode(self, p, cfg, x, position, cache, compute_dtype=None):
        q, k, v = self.project_qkv(p, cfg, x, position, compute_dtype)
        cache, o = la_attention_decode(
            cache, q[:, :, 0], k[:, :, 0], v[:, :, 0], cfg.la)
        return self.out(p, o[:, :, None], compute_dtype), cache
