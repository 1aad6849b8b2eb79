"""Minimal functional layer library (port of `repro/models/common.py`).

Params are plain nested dicts of tensors; every layer is an (init,
apply) pair.  Dense weights are (d_in, d_out) and applied as `x @ W`, so
converting the reference's params is a copy.  Matmuls run in the
config's compute dtype; norms always compute in f32.  What the ported
paths run is here: layernorm and rmsnorm, the gelu MLP, the embedding
and the tied unembedding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

F32 = torch.float32


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               bias: bool = False, dtype=F32):
    """N(0, 1/d_in) weights drawn in f32 on the generator's device."""
    w = torch.randn((d_in, d_out), generator=gen, dtype=F32,
                    device=gen.device) * (1.0 / d_in) ** 0.5
    p = {"w": w.to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense(p, x, compute_dtype=None):
    w = p["w"]
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    y = torch.matmul(x, w)
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def norm_init(d: int, dtype=F32, device="cuda", kind: str = "layernorm"):
    """Scale (and, for layernorm, bias) of a norm over d features; the
    reference's rmsnorm has no bias."""
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def norm_apply(p, x, kind: str = "layernorm", eps: float = 1e-5):
    """Layernorm or rmsnorm (`cfg.norm`) in f32, cast back to x's dtype."""
    xf = x.float()
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=F32):
    return {"wi": dense_init(gen, d_model, d_ff, dtype=dtype),
            "wo": dense_init(gen, d_ff, d_model, dtype=dtype)}


def mlp_apply(p, x, compute_dtype=None):
    """The gelu MLP (swiglu comes with the architectures that use it);
    jax.nn.gelu defaults to the tanh approximation, so this uses it."""
    h = F.gelu(dense(p["wi"], x, compute_dtype), approximate="tanh")
    return dense(p["wo"], h, compute_dtype)


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------

def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=F32):
    return {"table": (torch.randn((vocab, d), generator=gen, dtype=F32,
                                  device=gen.device) * 0.02).to(dtype)}


def embed_lookup(p, tokens, compute_dtype=None):
    t = p["table"]
    if compute_dtype is not None:
        t = t.to(compute_dtype)
    return F.embedding(tokens, t)


def unembed(p, x):
    """Logits through the (tied) embedding table in x's dtype: x @
    table^T."""
    return torch.matmul(x, p["table"].to(x.dtype).T)
