"""The paper's linear-attention backend (serving half).

Port of `repro/mixers/linear.py`: f(x) = a + b x scores on l2-normalized
q/k, an O(D^2) recurrent decode state independent of context length,
prefill through the plain chunked scan and decode through the fused
step family (kernels/decode_fused.py).
"""
from __future__ import annotations

from repro_torch.core.linear_attention import la_attention_decode, \
    la_attention_prefill
from repro_torch.mixers.base import register_backend
from repro_torch.mixers.cache import init_state
from repro_torch.mixers.qkv import GQAProjectionBackend


@register_backend("linear")
class LinearAttentionBackend(GQAProjectionBackend):
    def apply(self, p, cfg, x, positions, compute_dtype=None):
        raise NotImplementedError(
            "training through the linear backend is not ported yet: "
            "ROADMAP.md queue 1 item 0 'Training slice' ports la_fwd_pallas + "
            "la_bwd_pallas as one torch.autograd.Function")

    def init_cache(self, cfg, batch: int, max_len: int, device="cuda"):
        # O(D^2) state, independent of max_len
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
