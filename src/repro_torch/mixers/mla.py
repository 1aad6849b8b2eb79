"""Multi-head Latent Attention (DeepSeek-V2) with the paper's LA scores.

Port of `repro/mixers/mla.py`.  The low-rank q and kv projections of
DeepSeek-V2 are kept (q: d -> q_lora -> H x (nope + rope); kv: d ->
kv_lora + one shared k_rope; k per head [k_nope from kv_lora, k_rope
rotated once and broadcast to every head]; v per head from kv_lora), and
after the per-head decompression the paper's normalized linear attention
replaces softmax.  With the linear scores the decode cache is the LA
recurrent state over the decompressed per-head dims, (B, H, Dk, Dv + 1)
with Dk = nope + rope and Dv = v_head_dim: deepseek-v2-236b's (192, 128),
so its training runs the LA kernels at Dk != Dv (kernels/
linear_attention.py) and its decode `la_decode_fused` on a 192 x 129
state per (slot, head).
"""
from __future__ import annotations

import torch

from repro_torch.core.linear_attention import la_attention, \
    la_attention_decode, la_attention_prefill
from repro_torch.mixers.base import AttentionBackend, register_backend
from repro_torch.mixers.cache import init_state
from repro_torch.mixers.qkv import merge_heads
from repro_torch.models.common import dense, dense_init, norm_apply, \
    norm_init
from repro_torch.models.rope import apply_rope

F32 = torch.float32


@register_backend("mla")
class MLABackend(AttentionBackend):
    def init(self, gen, cfg, dtype=F32):
        """The reference's leaves: wq_down, q_norm, wq_up, wkv_down,
        kv_norm, wk_up, wv_up and wo."""
        m, h = cfg.mla, cfg.num_heads
        qk_head = m.nope_head_dim + m.rope_head_dim
        dev = gen.device
        return {
            "wq_down": dense_init(gen, cfg.d_model, m.q_lora_rank,
                                  dtype=dtype),
            "q_norm": norm_init(m.q_lora_rank, dtype, dev, cfg.norm),
            "wq_up": dense_init(gen, m.q_lora_rank, h * qk_head,
                                dtype=dtype),
            "wkv_down": dense_init(gen, cfg.d_model,
                                   m.kv_lora_rank + m.rope_head_dim,
                                   dtype=dtype),
            "kv_norm": norm_init(m.kv_lora_rank, dtype, dev, cfg.norm),
            "wk_up": dense_init(gen, m.kv_lora_rank, h * m.nope_head_dim,
                                dtype=dtype),
            "wv_up": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim,
                                dtype=dtype),
            "wo": dense_init(gen, h * m.v_head_dim, cfg.d_model,
                             dtype=dtype),
        }

    def _qkv(self, p, cfg, x, positions, compute_dtype):
        """q, k: (B, H, N, nope + rope), [nope, rope]; v: (B, H, N,
        v_head)."""
        m, h = cfg.mla, cfg.num_heads
        b, n, _ = x.shape

        ql = norm_apply(p["q_norm"], dense(p["wq_down"], x, compute_dtype),
                        cfg.norm)
        q = dense(p["wq_up"], ql, compute_dtype).reshape(
            b, n, h, m.nope_head_dim + m.rope_head_dim).transpose(1, 2)
        q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]

        kv = dense(p["wkv_down"], x, compute_dtype)
        kv_l, k_rope = kv[..., :m.kv_lora_rank], kv[..., m.kv_lora_rank:]
        kv_l = norm_apply(p["kv_norm"], kv_l, cfg.norm)
        k_nope = dense(p["wk_up"], kv_l, compute_dtype).reshape(
            b, n, h, m.nope_head_dim).transpose(1, 2)
        v = dense(p["wv_up"], kv_l, compute_dtype).reshape(
            b, n, h, m.v_head_dim).transpose(1, 2)

        # the shared k_rope: (B, 1, N, rope), rotated once, every head's
        q_rope = apply_rope(q_rope, positions, "standard",
                            theta=cfg.rope_theta)
        k_rope = apply_rope(k_rope[:, None], positions, "standard",
                            theta=cfg.rope_theta).expand(
                                b, h, n, m.rope_head_dim)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope], -1)
        return q, k, v

    def apply(self, p, cfg, x, positions, compute_dtype=None):
        q, k, v = self._qkv(p, cfg, x, positions, compute_dtype)
        o = la_attention(q, k, v, cfg.la, causal=True)
        return dense(p["wo"], merge_heads(o), compute_dtype)

    def init_cache(self, cfg, batch: int, max_len: int, device="cuda",
                   dtype=None):
        # the LA state over the decompressed per-head dims, f32
        m = cfg.mla
        return init_state(batch, cfg.num_heads,
                          m.nope_head_dim + m.rope_head_dim, m.v_head_dim,
                          device=device)

    def prefill(self, p, cfg, x, positions, cache, compute_dtype=None):
        q, k, v = self._qkv(p, cfg, x, positions, compute_dtype)
        o, cache = la_attention_prefill(q, k, v, cfg.la, state=cache)
        return dense(p["wo"], merge_heads(o), compute_dtype), cache

    def decode(self, p, cfg, x, position, cache, compute_dtype=None):
        q, k, v = self._qkv(p, cfg, x, position, compute_dtype)
        cache, o = la_attention_decode(
            cache, q[:, :, 0], k[:, :, 0], v[:, :, 0], cfg.la)
        return dense(p["wo"], merge_heads(o[:, :, None]),
                     compute_dtype), cache
