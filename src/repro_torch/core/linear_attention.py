"""Module-level API for the paper's linear attention.

Port of `repro/core/linear_attention.py`: applies the paper's q/k l2
normalization (Eq. 22) HERE, outside the kernels, then dispatches
training (`la_attention`, `la_attention_learnable`: the causal
autograd Functions of kernels/ops.py; `causal=False`, the encoder and
cross-attention, the plain product chain `la_noncausal`, as the
reference's XLA einsums), prefill (plain chunked scan) and decode (the
fused step family).
"""
from __future__ import annotations

from repro_torch.configs.base import LACfg
from repro_torch.core.chunked import LAState, la_decode_step
from repro_torch.core.numerics import l2_normalize
from repro_torch.kernels import ops as _ops


def la_attention(q, k, v, cfg: LACfg = LACfg(), *, causal: bool = True):
    """q: (B, H, Nq, D); k, v: (B, Hkv, Nk, D) (Nq = Nk where causal).
    Returns (B, H, Nq, D)."""
    if cfg.normalize_qk:
        q, k = l2_normalize(q), l2_normalize(k)
    if causal:
        return _ops.la_causal(q, k, v, cfg.a, cfg.b, cfg.chunk, cfg.backend)
    return _ops.la_noncausal(q, k, v, cfg.a, cfg.b)


def la_attention_learnable(q, k, v, a, b, cfg: LACfg = LACfg()):
    """Causal LA with learnable scalar coefficients (paper §2.2).

    a, b: 0-d tensors (per-layer parameters); gradients flow to q, k, v,
    a and b through the analytic backward in kernels/ops.py.
    """
    if cfg.normalize_qk:
        q, k = l2_normalize(q), l2_normalize(k)
    return _ops.la_causal_learnable(q, k, v, a, b, cfg.chunk, cfg.backend)


def la_attention_prefill(q, k, v, cfg: LACfg = LACfg(),
                         state: LAState | None = None):
    """Serving prefill: returns (o, LAState) for subsequent decode."""
    if cfg.normalize_qk:
        q, k = l2_normalize(q), l2_normalize(k)
    return _ops.la_prefill(q, k, v, cfg.a, cfg.b, cfg.chunk, state=state)


def la_attention_decode(state: LAState, q, k, v, cfg: LACfg = LACfg()):
    """Serving decode: one token.  q: (B, H, D); k, v: (B, Hkv, D).

    cfg.fused_decode routes through the fused single-kernel step family
    (state updated in place); otherwise the functional plain step runs.
    Returns (state, o).
    """
    if cfg.normalize_qk:
        q, k = l2_normalize(q), l2_normalize(k)
    if cfg.fused_decode:
        return _ops.la_decode_step_fused(state, q, k, v, cfg.a, cfg.b,
                                         backend=cfg.backend)
    return la_decode_step(state, q, k, v, cfg.a, cfg.b)


__all__ = ["la_attention", "la_attention_learnable", "la_attention_prefill",
           "la_attention_decode"]
