"""The paper's linear-attention backend (normalized kernelized attention).

Port of `repro/mixers/linear.py`: f(x) = a + b x scores on l2-normalized
q/k, training through the causal autograd Function with the analytic
O(N D) backward (kernels/ops.py), an O(D^2) recurrent decode state
independent of context length, prefill through the plain chunked scan
and decode through the fused step family (kernels/decode_fused.py).
The encoder-decoder paths (whisper): `apply_noncausal` (the encoder's
bidirectional self-attention and the decoder's cross-attention, the
plain product chain `la_noncausal`), and for decode `cross_precompute`,
the encoder-side LA state of each layer built once at prefill, and
`cross_decode`, one token's readout against it.

Learnable coefficients (paper §2.2): with cfg.la.learnable_coeffs, init
adds scalar (la_a, la_b) params and apply routes through the
differentiable-coefficient entry point.
"""
from __future__ import annotations

import torch

from repro_torch.core.linear_attention import la_attention, \
    la_attention_decode, la_attention_learnable, la_attention_prefill
from repro_torch.core.numerics import l2_normalize
from repro_torch.mixers.base import register_backend
from repro_torch.mixers.cache import CrossState, init_state
from repro_torch.mixers.qkv import GQAProjectionBackend, split_heads
from repro_torch.models.common import dense

F32 = torch.float32


@register_backend("linear")
class LinearAttentionBackend(GQAProjectionBackend):
    supports_cross_decode = True

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

    def apply_noncausal(self, p, cfg, x, ctx, positions=None,
                        compute_dtype=None):
        q, k, v = self.project_noncausal(p, cfg, x, ctx, positions,
                                         compute_dtype)
        o = la_attention(q, k, v, cfg.la, causal=False)
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

    # -- cross-attention serving state (whisper decode) -----------------

    def cross_precompute(self, p, cfg, ctx, compute_dtype=None) -> CrossState:
        """The LA cross-attention state of the encoder output ctx (B, Nk,
        C): S = sum_j k_j (x) [v_j, 1], P = sum_j [v_j, 1], f32."""
        hd = cfg.resolved_head_dim
        k = split_heads(dense(p["wk"], ctx, compute_dtype),
                        cfg.num_kv_heads, hd)
        v = split_heads(dense(p["wv"], ctx, compute_dtype),
                        cfg.num_kv_heads, hd)
        if cfg.la.normalize_qk:
            k = l2_normalize(k)
        vaug = torch.cat([v.float(), torch.ones(v.shape[:-1] + (1,),
                                                dtype=F32,
                                                device=v.device)], -1)
        s = torch.einsum("bhjd,bhje->bhde", k.float(), vaug)
        return CrossState(s=s, p=vaug.sum(dim=-2))

    def cross_decode(self, p, cfg, x, state: CrossState,
                     compute_dtype=None):
        """One token's cross-attention readout x (B, 1, C) against the
        precomputed state: f = a P + b q S over each KV head's query
        group, o = f[:D] / f[D] (a plain divide, as the reference's)."""
        hd = cfg.resolved_head_dim
        b = x.shape[0]
        q = split_heads(dense(p["wq"], x, compute_dtype), cfg.num_heads, hd)
        if cfg.la.normalize_qk:
            q = l2_normalize(q)
        hkv = state.s.shape[1]
        qg = q[:, :, 0].reshape(b, hkv, cfg.num_heads // hkv, hd).float()
        la = cfg.la
        f = (la.a * state.p[:, :, None, :]
             + la.b * torch.einsum("bhgd,bhde->bhge", qg, state.s))
        o = f[..., :hd] / f[..., hd:]
        o = o.reshape(b, cfg.num_heads, 1, hd).to(x.dtype)
        return self.out(p, o, compute_dtype)
