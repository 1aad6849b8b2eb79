"""Chunked-scan formulation of the paper's linear attention (plain PyTorch).

Port of `repro/core/chunked.py` (forward and decode; the analytic
backward comes with the training path).  The sequence is processed in
chunks of C tokens and V is augmented with a ones column, so one
carried state gives both the numerator and the normalizer:

    V' = [V, 1]                               (C, D+1)
    S  = sum_{n < chunk} k_n (x) V'_n          (D, D+1)
    P  = sum_{n < chunk} V'_n                  (D+1,)
    F' = a (1 P^T + cumsum V') + b (Q S + tril(Q K^T) V')
    O  = F'[:, :D] / F'[:, D]

Every product runs in f32 on f32 copies of the inputs (bf16 products are
exact in f32, so this equals the reference's bf16 dots with
`preferred_element_type=f32`).  Grouped-query attention is native: q is
(B, H, N, D), k/v are (B, Hkv, N, D) with Hkv | H.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.numerics import safe_div
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK

F32 = torch.float32


class LAState(NamedTuple):
    """Recurrent linear-attention state (decode cache; constant in N).

    s: (B, Hkv, Dk, Dv+1) f32 — sum of k (x) [v, 1]
    p: (B, Hkv, Dv+1) f32     — sum of [v, 1] (last component = token count)
    """

    s: torch.Tensor
    p: torch.Tensor


def init_state(batch: int, num_kv_heads: int, dk: int,
               dv: Optional[int] = None, device="cuda") -> LAState:
    dv = dk if dv is None else dv
    return LAState(
        s=torch.zeros((batch, num_kv_heads, dk, dv + 1), dtype=F32,
                      device=device),
        p=torch.zeros((batch, num_kv_heads, dv + 1), dtype=F32,
                      device=device),
    )


def _pad_seq(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-pad axis 2 (the sequence axis) of a 4-D tensor to length n."""
    pad = n - x.shape[2]
    return x if pad == 0 else F.pad(x, (0, 0, 0, pad))


def la_fwd_chunked(q, k, v, a: float, b: float,
                   chunk: int = DEFAULT_SCAN_CHUNK,
                   state: Optional[LAState] = None):
    """Causal normalized linear attention, chunked scan.

    Returns (o, g, final_state): o (B, H, N, Dv) in q.dtype, g (B, H, N)
    f32 normalizer, final_state an f32 LAState that feeds decode.
    """
    bsz, h, n, dk = q.shape
    dv = v.shape[-1]
    hkv = k.shape[1]
    grp = h // hkv
    c = min(chunk, n)
    t = -(-n // c)
    n_pad = t * c

    qg = _pad_seq(q, n_pad).float().reshape(bsz, hkv, grp, t, c, dk)
    kc = _pad_seq(k, n_pad).float().reshape(bsz, hkv, t, c, dk)
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    # ones column appended BEFORE padding so padded rows contribute
    # nothing to the carried state (count column included)
    vaug = _pad_seq(torch.cat([v, ones], -1), n_pad).float()
    vaug = vaug.reshape(bsz, hkv, t, c, dv + 1)

    tril = torch.tril(torch.ones((c, c), dtype=F32, device=q.device))
    if state is None:
        state = init_state(bsz, hkv, dk, dv, device=q.device)
    s, p = state.s, state.p
    f_chunks = []
    for i in range(t):
        q_i, k_i, va_i = qg[:, :, :, i], kc[:, :, i], vaug[:, :, i]
        att = (a + b * torch.einsum("bhgid,bhjd->bhgij", q_i, k_i)) * tril
        f_intra = torch.einsum("bhgij,bhje->bhgie", att, va_i)
        f_inter = (a * p[:, :, None, None, :]
                   + b * torch.einsum("bhgid,bhde->bhgie", q_i, s))
        f = f_intra + f_inter
        s = s + torch.einsum("bhjd,bhje->bhde", k_i, va_i)
        p = p + va_i.sum(dim=-2)
        f_chunks.append(f)
    # (B, Hkv, G, T, C, Dv+1) -> (B, H, N, Dv+1)
    f_all = torch.stack(f_chunks, dim=3).reshape(bsz, h, n_pad, dv + 1)
    f_all = f_all[:, :, :n]
    g = f_all[..., dv]
    o = safe_div(f_all[..., :dv], g[..., None]).to(q.dtype)
    return o, g, LAState(s, p)


def la_decode_step(state: LAState, q, k, v, a: float, b: float):
    """One-token decode, functional.  q: (B, H, Dk); k, v: (B, Hkv, D).

    Returns (new_state, o) with o (B, H, Dv) in q.dtype.  The fused
    decode family (kernels/decode_fused.py) computes the same function
    with the state updated in place.
    """
    bsz, h, dk = q.shape
    dv = v.shape[-1]
    hkv = k.shape[1]
    kf, vf = k.float(), v.float()
    vaug = torch.cat([vf, torch.ones((bsz, hkv, 1), dtype=F32,
                                     device=v.device)], -1)
    s = state.s + kf[..., :, None] * vaug[..., None, :]
    p = state.p + vaug
    qg = q.reshape(bsz, hkv, h // hkv, dk).float()
    f = a * p[:, :, None, :] + b * torch.einsum("bhgd,bhde->bhge", qg, s)
    o = safe_div(f[..., :dv], f[..., dv:])
    return LAState(s, p), o.reshape(bsz, h, dv).to(q.dtype)
