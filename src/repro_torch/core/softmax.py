"""Chunked online-softmax attention — the plain path of the softmax baseline.

Port of `repro/core/softmax.py`: the Regular-Attention baseline the paper
compares against, as an online softmax over KV chunks (the scan form of
FlashAttention-2), O(N) memory beyond one (Nq, chunk) score block.  It is
the `torch` impl of the "softmax" family in kernels/ops.py and the plain
version of the flash forward kernel (kernels/flash_attention.py), with
the same feature set:

  * GQA without expanding KV: q is viewed as (B, Hkv, G, Nq, D) against
    the (B, Hkv, Nk, D) keys and values;
  * the training offset: query i is global position i + Nk - Nq;
  * per-slot `q_offset` (B,) for serving continuation prefill, where the
    KV walk stops at the deepest slot's causal frontier;
  * the f32 logsumexp m + log l of every query row when asked (the
    flash backward's residual).

Every product runs in f32 on f32 copies of the inputs.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK

F32 = torch.float32
NEG_INF = -1e30


def softmax_chunked(q, k, v, *, causal: bool = True,
                    chunk: int = DEFAULT_SCAN_CHUNK,
                    q_offset: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q: (B, H, Nq, D); k, v: (B, Hkv, Nk, D), Hkv | H.

    q_offset: optional (B,) int — PER-SEQUENCE global position of query
    0 (each slot's prompt window sits at its own offset inside a max_len
    KV cache and attends to its cached prefix plus itself).  None keeps
    the training convention, query i at position i + Nk - Nq.

    Returns o (B, H, Nq, Dv) in q.dtype, and with `return_lse` also the
    f32 logsumexp (B, H, Nq).  A row that sees no key finalizes through
    the guarded divide l <= 0 -> 1 (o = 0, as the flash kernel does).
    """
    b, h, nq, d = q.shape
    hkv, nk, dv = k.shape[1], k.shape[2], v.shape[-1]
    g = h // hkv
    scale = 1.0 / d ** 0.5
    c = max(1, min(chunk, nk))
    t = -(-nk // c)
    if causal and q_offset is not None:
        # keys beyond the deepest slot's causal frontier contribute
        # exactly zero: bound the walk at that chunk (inference only)
        t = min((int(q_offset.max()) + nq + c - 1) // c, t)
    dev = q.device
    qg = q.reshape(b, hkv, g, nq, d).float()
    iq = torch.arange(nq, device=dev)[:, None]
    offs = nk - nq if q_offset is None else None
    m = torch.full((b, hkv, g, nq), NEG_INF, dtype=F32, device=dev)
    l_sum = torch.zeros((b, hkv, g, nq), dtype=F32, device=dev)
    acc = torch.zeros((b, hkv, g, nq, dv), dtype=F32, device=dev)
    for ti in range(t):
        kc = k[:, :, ti * c:(ti + 1) * c].float()
        vc = v[:, :, ti * c:(ti + 1) * c].float()
        jk = ti * c + torch.arange(kc.shape[2], device=dev)[None, :]
        s = scale * torch.einsum("bhgid,bhjd->bhgij", qg, kc)
        if causal and q_offset is None:
            s = s.masked_fill(~(iq + offs >= jk), NEG_INF)
        elif causal:
            # per-slot offsets: (B, Nq, c) broadcast over (Hkv, G)
            live = iq[None] + q_offset.to(dev).long()[:, None, None] >= jk
            s = s.masked_fill(~live[:, None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_sum = corr * l_sum + p.sum(-1)
        acc = corr[..., None] * acc + torch.einsum("bhgij,bhjd->bhgid", p,
                                                   vc)
        m = m_new
    l_safe = torch.where(l_sum <= 0.0, torch.ones_like(l_sum), l_sum)
    o = (acc / l_safe[..., None]).reshape(b, h, nq, dv).to(q.dtype)
    if not return_lse:
        return o
    return o, (m + torch.log(l_safe)).reshape(b, h, nq)
