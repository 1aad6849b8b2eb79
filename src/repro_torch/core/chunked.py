"""Chunked-scan formulation of the paper's linear attention (plain PyTorch).

Port of `repro/core/chunked.py`: forward with state in and out, the
analytic backward (paper Eqs. 19-21) and decode.  The sequence is processed in
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


# ---------------------------------------------------------------------------
# Backward (causal) — paper Eqs. 19-21, chunked
# ---------------------------------------------------------------------------

def la_bwd_prep(o, g, omega):
    """Ω̂ = safe_div(ω, g) and h = Σ o·Ω̂ (paper Eq. 20), both f32:
    om_hat (B, H, N, Dv), h (B, H, N)."""
    om_hat = safe_div(omega.float(), g[..., None])
    return om_hat, (o.float() * om_hat).sum(-1)


def _ones_col(x: torch.Tensor, value: float = 1.0) -> torch.Tensor:
    return torch.full(x.shape[:-1] + (1,), value, dtype=F32,
                      device=x.device)


def la_bwd_q_chunked(k, v, om_hat, h_vec, b: float,
                     chunk: int = DEFAULT_SCAN_CHUNK, out_dtype=None):
    """dQ by a forward chunk scan carrying A = Σ kᵀ[v, 1] (Dk, Dv+1).

    k, v: (B, Hkv, N, D); om_hat (B, H, N, Dv) and h_vec (B, H, N) f32
    from `la_bwd_prep`.  Returns dq (B, H, N, Dk) in out_dtype (k.dtype
    by default).
    """
    bsz, h, n, dv = om_hat.shape
    hkv, dk = k.shape[1], k.shape[-1]
    grp = h // hkv
    c = min(chunk, n)
    t = -(-n // c)
    n_pad = t * c
    kc = _pad_seq(k, n_pad).float().reshape(bsz, hkv, t, c, dk)
    vaug = torch.cat([v.float(), _ones_col(v)], -1)
    vaug = _pad_seq(vaug, n_pad).reshape(bsz, hkv, t, c, dv + 1)
    # gmat = [Ω̂, -h]: padded rows are zero
    gmat = torch.cat([om_hat, -h_vec[..., None]], -1)
    gmat = _pad_seq(gmat, n_pad).reshape(bsz, hkv, grp, t, c, dv + 1)
    tril = torch.tril(torch.ones((c, c), dtype=F32, device=k.device))
    a_st = torch.zeros((bsz, hkv, dk, dv + 1), dtype=F32, device=k.device)
    dq_chunks = []
    for i in range(t):
        k_i, va_i, gm_i = kc[:, :, i], vaug[:, :, i], gmat[:, :, :, i]
        sc = torch.einsum("bhgie,bhje->bhgij", gm_i, va_i) * tril
        dq = (torch.einsum("bhgij,bhjd->bhgid", sc, k_i)
              + torch.einsum("bhgie,bhde->bhgid", gm_i, a_st))
        a_st = a_st + torch.einsum("bhjd,bhje->bhde", k_i, va_i)
        dq_chunks.append(b * dq)
    dq = torch.stack(dq_chunks, 3).reshape(bsz, h, n_pad, dk)[:, :, :n]
    return dq.to(out_dtype or k.dtype)


def la_bwd_kv_chunked(q, k, v, om_hat, h_vec, a: float, b: float,
                      chunk: int = DEFAULT_SCAN_CHUNK):
    """dK and dV by a reverse chunk scan carrying U = Σ [q, 1]ᵀ[Ω̂, h]
    (Dk+1, Dv+1), with the G query heads of a KV head summed into U, so
    the grads land on the unexpanded (B, Hkv, N, D) k and v."""
    bsz, h, n, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    grp = h // hkv
    c = min(chunk, n)
    t = -(-n // c)
    n_pad = t * c
    qc = _pad_seq(q, n_pad).float().reshape(bsz, hkv, grp, t, c, dk)
    qaug = torch.cat([qc, torch.ones(qc.shape[:-1] + (1,), dtype=F32,
                                     device=q.device)], -1)
    kc = _pad_seq(k, n_pad).float().reshape(bsz, hkv, t, c, dk)
    vneg = torch.cat([v.float(), _ones_col(v, -1.0)], -1)
    vneg = _pad_seq(vneg, n_pad).reshape(bsz, hkv, t, c, dv + 1)
    # g2 = [Ω̂, +h]: padded rows are zero, so they add nothing to U
    g2 = torch.cat([om_hat, h_vec[..., None]], -1)
    g2 = _pad_seq(g2, n_pad).reshape(bsz, hkv, grp, t, c, dv + 1)
    tril = torch.tril(torch.ones((c, c), dtype=F32, device=q.device))
    u = torch.zeros((bsz, hkv, dk + 1, dv + 1), dtype=F32, device=q.device)
    dk_chunks, dv_chunks = [None] * t, [None] * t
    for i in reversed(range(t)):
        q_i, qa_i, k_i = qc[:, :, :, i], qaug[:, :, :, i], kc[:, :, i]
        vn_i, g2_i = vneg[:, :, i], g2[:, :, :, i]
        om_i = g2_i[..., :dv]
        # dK intra: Σ_{i >= p} q_i (Ω̂_i·v_p - h_i)
        sc = torch.einsum("bhgie,bhpe->bhgip", g2_i, vn_i) * tril
        dk_ = (torch.einsum("bhgip,bhgid->bhpd", sc, q_i)
               + torch.einsum("bhpe,bhde->bhpd", vn_i, u[..., :dk, :]))
        # dV intra: Σ_{i >= p} (a + b q_i·k_p) Ω̂_i
        att = (a + b * torch.einsum("bhgid,bhpd->bhgip", q_i, k_i)) * tril
        dv_ = (torch.einsum("bhgip,bhgij->bhpj", att, om_i)
               + b * torch.einsum("bhpd,bhdj->bhpj", k_i, u[..., :dk, :dv])
               + a * u[..., dk, :dv][:, :, None, :])
        u = u + torch.einsum("bhgic,bhgie->bhce", qa_i, g2_i)
        dk_chunks[i], dv_chunks[i] = b * dk_, dv_
    dk_o = torch.stack(dk_chunks, 2).reshape(bsz, hkv, n_pad, dk)[:, :, :n]
    dv_o = torch.stack(dv_chunks, 2).reshape(bsz, hkv, n_pad, dv)[:, :, :n]
    return dk_o.to(k.dtype), dv_o.to(v.dtype)


def la_bwd_chunked(q, k, v, o, g, omega, a: float, b: float,
                   chunk: int = DEFAULT_SCAN_CHUNK):
    """Analytic gradient from residuals {q, k, v, o, g} and upstream grad
    omega (the plain backward).  Returns (dq, dk, dv) in the respective
    input dtypes."""
    om_hat, h_vec = la_bwd_prep(o, g, omega)
    dq = la_bwd_q_chunked(k, v, om_hat, h_vec, b, chunk, out_dtype=q.dtype)
    dk, dv = la_bwd_kv_chunked(q, k, v, om_hat, h_vec, a, b, chunk)
    return dq, dk, dv


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
