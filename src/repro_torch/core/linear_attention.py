"""Module-level API for the paper's linear attention (serving half).

Port of `repro/core/linear_attention.py`: applies the paper's q/k l2
normalization (Eq. 22) HERE, outside the kernels, then dispatches
prefill (plain chunked scan) and decode (the fused step family).
Training (`la_attention`) comes with the training slice.
"""
from __future__ import annotations

from repro_torch.configs.base import LACfg
from repro_torch.core.chunked import LAState, la_decode_step
from repro_torch.core.numerics import l2_normalize
from repro_torch.kernels import ops as _ops


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


__all__ = ["la_attention_prefill", "la_attention_decode"]
