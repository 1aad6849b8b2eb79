"""Mamba-2 (SSD) token-mixer backend.

Port of `repro/mixers/mamba2.py`.  The paper (Appendix B, Table 3)
identifies Mamba-2's recurrence S_t = gamma_t S_{t-1} + k_t^T v_t as
decay-gated linear attention; this backend runs it with q = C and k = B
(shared across heads, like MQA: G = 1) and v = the x heads.

Layer structure (Mamba-2 paper / mamba_ssm reference):
  in_proj: d -> [z(d_in), x(d_in), B(state), C(state), dt(H)]
  causal depthwise conv (width 4) + silu over [x, B, C]
  dt = softplus(dt + dt_bias); log_decay = -dt * exp(A_log)
  o = SSD(C, B, x * dt, log_decay) + D ⊙ x
  y = RMSNorm(o ⊙ silu(z)); out_proj: d_in -> d

Training goes through `ops.ssd_causal` (the autograd Function with the
analytic backward; the CUDA SSD kernels on a card) or, with
`cfg.ssm.analytic_bwd=False`, autograd through the plain chunked scan;
prefill runs the plain scan with state in and out and decode the plain
one-token step (core/ssd.py) on every device, as the reference does
(`repro/mixers/mamba2.py:157, :181`: it has no SSD prefill or decode
kernel).  `fuses_ffn = True`: the mamba block IS both token and channel
mixer, so blocks.py adds no separate FFN or second norm around it.
Paging is refused for mamba2 (mixers/base.py): its cache is O(1) in the
context length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.ssd import SSDState, ssd_decode_step, \
    ssd_fwd_chunked
from repro_torch.kernels import ops as _ops
from repro_torch.mixers.base import AttentionBackend, register_backend
from repro_torch.mixers.cache import MambaCache
from repro_torch.models.common import dense, dense_init, norm_apply, \
    norm_init

F32 = torch.float32


def _dims(cfg):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.state_dim
    return d_in, nheads, conv_ch


def _causal_conv(x, w, b, left=None):
    """Depthwise causal conv.  x: (B, N, C); w: (W, C), cast to x's
    dtype.  O(W) per token.

    left: optional (B, W-1, C) context from a previous window (chunked
    prefill); defaults to zeros (sequence start)."""
    width = w.shape[0]
    if left is None:
        pads = F.pad(x, (0, 0, width - 1, 0))
    else:
        pads = torch.cat([left, x], dim=1)
    n = x.shape[1]
    out = sum(pads[:, i:i + n] * w[i].to(x.dtype) for i in range(width))
    return out + b.to(x.dtype)


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_in, nheads, _ = _dims(cfg)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:d_in + d_in + 2 * s.state_dim]
    dt = zxbcdt[..., -nheads:]
    return z, xbc, dt


def _ssd_inputs(cfg, xbc, dt, dt_bias, a_log):
    """conv'd xbc + raw dt -> (q, k, v, v_eff, log_decay) for the SSD.

    q/k (Mamba-2's C/B) are shared across heads: returned as (B, 1, N,
    state) views of xbc; the grouped SSD computes Q K^T once
    (core/ssd.py), and materializing per-head copies would cost an
    H-fold blowup.  v is (B, H, N, hd) and log_decay (B, H, N) f32, both
    transposed views; v_eff = v * dt.
    """
    s = cfg.ssm
    d_in, nheads, _ = _dims(cfg)
    b, n, _ = xbc.shape
    xs = xbc[..., :d_in]
    bmat = xbc[..., d_in:d_in + s.state_dim]
    cmat = xbc[..., d_in + s.state_dim:]
    dt_f = F.softplus(dt.float() + dt_bias)                    # (B, N, H)
    log_decay = (-dt_f * torch.exp(a_log)).transpose(1, 2)     # (B, H, N)
    v = xs.reshape(b, n, nheads, s.head_dim).transpose(1, 2)
    v_eff = v * dt_f.transpose(1, 2)[..., None].to(v.dtype)
    q = cmat[:, None]                                          # (B,1,N,st)
    k = bmat[:, None]
    return q, k, v, v_eff, log_decay


@register_backend("mamba2")
class Mamba2Backend(AttentionBackend):
    fuses_ffn = True  # the mamba block carries no separate FFN

    def init(self, gen, cfg, dtype=F32):
        s = cfg.ssm
        d_in, nheads, conv_ch = _dims(cfg)
        dev = gen.device
        return {
            "in_proj": dense_init(gen, cfg.d_model,
                                  2 * d_in + 2 * s.state_dim + nheads,
                                  dtype=dtype),
            "conv_w": (torch.randn((s.conv_width, conv_ch), generator=gen,
                                   dtype=F32, device=dev)
                       * (1.0 / s.conv_width) ** 0.5).to(dtype),
            "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=dev),
            # exp(a_log) = 1: the decay rate at init
            "a_log": torch.zeros((nheads,), dtype=F32, device=dev),
            "dt_bias": torch.zeros((nheads,), dtype=F32, device=dev),
            "d_skip": torch.ones((nheads,), dtype=F32, device=dev),
            "norm": norm_init(d_in, dtype, dev, kind="rmsnorm"),
            "out_proj": dense_init(gen, d_in, cfg.d_model, dtype=dtype),
        }

    def _out(self, p, cfg, o, v, z, compute_dtype):
        """o + D ⊙ x, gated by silu(z), rmsnorm'd, projected back to d."""
        o = o + p["d_skip"][None, :, None, None].to(o.dtype) * v
        b_, h_, n_, hd = o.shape
        o = o.transpose(1, 2).reshape(b_, n_, h_ * hd)
        y = norm_apply(p["norm"], o * F.silu(z).to(o.dtype), cfg.norm)
        return dense(p["out_proj"], y, compute_dtype)

    def apply(self, p, cfg, x, positions=None, compute_dtype=None):
        zxbcdt = dense(p["in_proj"], x, compute_dtype)
        z, xbc, dt = _split_proj(cfg, zxbcdt)
        xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"]))
        q, k, v, v_eff, log_decay = _ssd_inputs(cfg, xbc, dt, p["dt_bias"],
                                                p["a_log"])
        if cfg.ssm.analytic_bwd:
            o = _ops.ssd_causal(q, k, v_eff, log_decay, cfg.la.chunk,
                                cfg.la.backend)
        else:
            o, _ = ssd_fwd_chunked(q, k, v_eff, log_decay, cfg.la.chunk)
        return self._out(p, cfg, o, v, z, compute_dtype)

    def init_cache(self, cfg, batch: int, max_len: int, device="cuda",
                   dtype=torch.bfloat16):
        # O(1) in max_len: the f32 SSD state and the conv window's tail
        s = cfg.ssm
        _, nheads, conv_ch = _dims(cfg)
        return MambaCache(
            s=torch.zeros((batch, nheads, s.state_dim, s.head_dim),
                          dtype=F32, device=device),
            conv=torch.zeros((batch, s.conv_width - 1, conv_ch),
                             dtype=dtype, device=device))

    def prefill(self, p, cfg, x, positions, cache: MambaCache,
                compute_dtype=None):
        zxbcdt = dense(p["in_proj"], x, compute_dtype)
        z, xbc, dt = _split_proj(cfg, zxbcdt)
        # continuation-correct conv: the left context is the previous
        # window's tail from the cache (zeros on a fresh cache); the new
        # tail spans [left, window] so windows shorter than the conv
        # width still carry the right context
        left = cache.conv.to(xbc.dtype)
        tail = torch.cat([left, xbc], dim=1)[
            :, -(cfg.ssm.conv_width - 1):].to(cache.conv.dtype)
        xbc = F.silu(_causal_conv(xbc, p["conv_w"], p["conv_b"], left=left))
        q, k, v, v_eff, log_decay = _ssd_inputs(cfg, xbc, dt, p["dt_bias"],
                                                p["a_log"])
        o, st = ssd_fwd_chunked(q, k, v_eff, log_decay, cfg.la.chunk,
                                state=SSDState(cache.s))
        return (self._out(p, cfg, o, v, z, compute_dtype),
                MambaCache(st.s, tail))

    def decode(self, p, cfg, x, position, cache: MambaCache,
               compute_dtype=None):
        """x: (B, 1, C), one token per slot; O(state * hd) per head."""
        zxbcdt = dense(p["in_proj"], x, compute_dtype)
        z, xbc, dt = _split_proj(cfg, zxbcdt)
        window = torch.cat([cache.conv.to(xbc.dtype), xbc], dim=1)  # (B,W,C)
        new_conv = window[:, 1:].to(cache.conv.dtype)
        # the reference convolves the decode window in f32
        conv_out = torch.einsum("bwc,wc->bc", window.float(),
                                p["conv_w"].float()) + p["conv_b"].float()
        xbc1 = F.silu(conv_out)[:, None].to(xbc.dtype)
        q, k, v, v_eff, log_decay = _ssd_inputs(cfg, xbc1, dt, p["dt_bias"],
                                                p["a_log"])
        st, o = ssd_decode_step(SSDState(cache.s), q[:, :, 0], k[:, :, 0],
                                v_eff[:, :, 0], log_decay[:, :, 0])
        return (self._out(p, cfg, o[:, :, None], v, z, compute_dtype),
                MambaCache(st.s, new_conv))
