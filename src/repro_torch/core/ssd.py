"""Chunked state-space duality (SSD / Mamba-2) — scalar-decay linear
attention (plain PyTorch).

Port of `repro/core/ssd.py`.  The paper (Appendix B, Table 3) identifies
Mamba-2's recurrence

    S_t = gamma_t S_{t-1} + k_t^T v_t,   o_t = q_t S_t

with gamma_t = exp(log_decay_t) in (0, 1] as gated linear attention with
no normalizer.  q and k are GROUPED: (B, G, N, Dk) with G | H, shared by
the H/G heads of a group (Mamba-2's B and C projections, G = 1 at full
width), while v is (B, H, N, Dv) and log_decay (B, H, N) per head.  The
Q K^T product of a chunk is computed once per group; only the decay
masks and the value contractions run per head.  Within a chunk the
decay exponents are differences of a non-increasing cumsum; the mask
clamps them at 0 before exp (`core.gla._decay_mask`), so nothing
overflows above the diagonal where the mask zeroes them anyway.

The analytic backward from residuals {q, k, v, log_decay, o} (O(N D)),
with Ω the upstream grad of o:

    dq_t  = sum_{h in group} S^h_t Ω^h_t          (forward chunk scan)
    U_n   = sum_{i >= n} M_in q_i Ω_i^T           (reverse chunk scan)
    dk_n  = sum_{h} U^h_n v^h_n ,  dv_n = U_n^T k_n
    dcl_j = Ω_j . o_j - v_j . dv_j ;  dld_t = sum_{j >= t} dcl_j

with M_in = prod_{m=n+1..i} gamma_m.  It is split as the CUDA kernels are
(kernels/ssd.py): `ssd_bwd_q_chunked` and `ssd_bwd_kv_chunked` return
the PER-HEAD partials of dq and dk in f32, as the reference's Pallas
kernels write them (`repro/kernels/ssd.py:236, :268`), and dv in f32;
`ssd_bwd_epilogue` sums the partials over each group and forms dld.
Every product runs in f32 on f32 copies of the inputs.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core.chunked import _pad_seq
from repro_torch.core.gla import _chunked_ld, _decay_mask, _tiles
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK

F32 = torch.float32


class SSDState(NamedTuple):
    """Decayed recurrent SSD state (decode cache; constant in N)."""

    s: torch.Tensor  # (B, H, Dk, Dv) f32


def init_ssd_state(batch: int, heads: int, dk: int, dv: int,
                   device="cuda") -> SSDState:
    return SSDState(s=torch.zeros((batch, heads, dk, dv), dtype=F32,
                                  device=device))


def _chunks(q, v, log_decay, chunk):
    """Shapes, tiles and the chunked f32 log decay shared by the scans:
    (B, G, H/G, Dk, Dv, c, t, n_pad, tril, ld (B, G, H/G, T, C))."""
    bsz, g, n, dk = q.shape
    h, dv = v.shape[1], v.shape[-1]
    c, t, n_pad, tril = _tiles(n, chunk, q.device)
    ldc = _chunked_ld(log_decay, n_pad, t, c).reshape(bsz, g, h // g, t, c)
    return bsz, g, h // g, dk, dv, c, t, n_pad, tril, ldc


def _rows(x, n_pad, t, c):
    """(B, G, N, D) -> (B, G, T, C, D) f32, zero-padded."""
    return _pad_seq(x, n_pad).float().reshape(*x.shape[:2], t, c,
                                              x.shape[-1])


def _head_rows(x, g, n_pad, t, c):
    """(B, H, N, D) -> (B, G, H/G, T, C, D) f32, zero-padded."""
    b, h = x.shape[:2]
    return _pad_seq(x, n_pad).float().reshape(b, g, h // g, t, c,
                                              x.shape[-1])


# ---------------------------------------------------------------------------
# Forward (causal), state in and out
# ---------------------------------------------------------------------------

def ssd_fwd_chunked(q, k, v, log_decay, chunk: int = DEFAULT_SCAN_CHUNK,
                    state: Optional[SSDState] = None):
    """q, k: (B, G, N, Dk) shared per group (G | H); v: (B, H, N, Dv);
    log_decay: (B, H, N) <= 0.  Returns (o (B, H, N, Dv) in v.dtype,
    final SSDState (B, H, Dk, Dv) f32)."""
    bsz, g, hg, dk, dv, c, t, n_pad, tril, ldc = _chunks(q, v, log_decay,
                                                         chunk)
    n = q.shape[2]
    qc, kc = _rows(q, n_pad, t, c), _rows(k, n_pad, t, c)
    vc = _head_rows(v, g, n_pad, t, c)
    if state is None:
        state = init_ssd_state(bsz, g * hg, dk, dv, device=q.device)
    s = state.s.float().reshape(bsz, g, hg, dk, dv)
    o_chunks = []
    for i in range(t):
        q_i, k_i, v_i = qc[:, :, i], kc[:, :, i], vc[:, :, :, i]
        cl = torch.cumsum(ldc[:, :, :, i], dim=-1)       # (B, G, Hg, C)
        total = cl[..., -1:]
        # Q K^T once per group; the decay mask per head
        att = torch.einsum("bgid,bgjd->bgij", q_i, k_i)
        w = att[:, :, None] * _decay_mask(cl, tril)
        o_intra = torch.einsum("bghij,bghje->bghie", w, v_i)
        o_inter = torch.exp(cl)[..., None] * torch.einsum(
            "bgid,bghde->bghie", q_i, s)
        o_chunks.append(o_intra + o_inter)
        # the state: weight v (per head) instead of broadcasting k
        vw = torch.exp(total - cl)[..., None] * v_i
        s = (torch.exp(total)[..., None] * s
             + torch.einsum("bgjd,bghje->bghde", k_i, vw))
    # (B, G, Hg, T, C, Dv) -> (B, H, N, Dv)
    o = torch.stack(o_chunks, dim=3).reshape(bsz, g * hg, n_pad, dv)
    return (o[:, :, :n].to(v.dtype),
            SSDState(s.reshape(bsz, g * hg, dk, dv)))


# ---------------------------------------------------------------------------
# Decode (serving): O(Dk Dv) per head and token
# ---------------------------------------------------------------------------

def ssd_decode_step(state: SSDState, q, k, v, log_decay):
    """One-token decode, functional.  q, k: (B, G, Dk); v: (B, H, Dv);
    log_decay: (B, H).  Returns (new SSDState, o (B, H, Dv) in v.dtype)."""
    bsz, g, dk = q.shape
    h = v.shape[1]
    gamma = torch.exp(log_decay.float())[..., None, None]
    kf = k.float().repeat_interleave(h // g, dim=1)      # (B, H, Dk)
    s = gamma * state.s.float() + kf[..., :, None] * v.float()[..., None, :]
    qf = q.float().repeat_interleave(h // g, dim=1)
    o = torch.einsum("bhd,bhde->bhe", qf, s)
    return SSDState(s), o.to(v.dtype)


# ---------------------------------------------------------------------------
# Analytic backward: dq partials, then dk partials and dv, then the epilogue
# ---------------------------------------------------------------------------

def ssd_bwd_q_chunked(k, v, log_decay, omega,
                      chunk: int = DEFAULT_SCAN_CHUNK):
    """Per-head dq partials by a forward chunk scan carrying the
    forward's decayed state S: dq^h_i = S^h_i Ω^h_i.

    k: (B, G, N, Dk); v, omega: (B, H, N, Dv); log_decay: (B, H, N).
    Returns (B, H, N, Dk) f32 (summed over each group by the epilogue).
    """
    bsz, g, hg, dk, dv, c, t, n_pad, tril, ldc = _chunks(k, v, log_decay,
                                                         chunk)
    n = k.shape[2]
    kc = _rows(k, n_pad, t, c)
    vc, omc = _head_rows(v, g, n_pad, t, c), _head_rows(omega, g, n_pad,
                                                         t, c)
    s = torch.zeros((bsz, g, hg, dk, dv), dtype=F32, device=k.device)
    dq_chunks = []
    for i in range(t):
        k_i, v_i, om_i = kc[:, :, i], vc[:, :, :, i], omc[:, :, :, i]
        cl = torch.cumsum(ldc[:, :, :, i], dim=-1)
        total = cl[..., -1:]
        # w[i, n] = (Ω_i . v_n) M_in, n <= i
        p = torch.einsum("bghie,bghne->bghin", om_i, v_i)
        w = p * _decay_mask(cl, tril)
        dq_intra = torch.einsum("bghin,bgnd->bghid", w, k_i)
        omw = torch.exp(cl)[..., None] * om_i
        dq_inter = torch.einsum("bghde,bghie->bghid", s, omw)
        dq_chunks.append(dq_intra + dq_inter)
        vw = torch.exp(total - cl)[..., None] * v_i
        s = (torch.exp(total)[..., None] * s
             + torch.einsum("bgjd,bghje->bghde", k_i, vw))
    dq = torch.stack(dq_chunks, dim=3).reshape(bsz, g * hg, n_pad, dk)
    return dq[:, :, :n]


def ssd_bwd_kv_chunked(q, k, v, log_decay, omega,
                       chunk: int = DEFAULT_SCAN_CHUNK):
    """Per-head dk partials and dv by a reverse chunk scan carrying
    U^h_n = sum_{i >= n} M_in q_i Ω^h_i^T: dk^h_n = U^h_n v^h_n, dv^h_n =
    U^h_n^T k_n.  Returns (dk partials (B, H, N, Dk) f32, dv (B, H, N, Dv)
    f32)."""
    bsz, g, hg, dk, dv, c, t, n_pad, tril, ldc = _chunks(q, v, log_decay,
                                                         chunk)
    n = q.shape[2]
    qc, kc = _rows(q, n_pad, t, c), _rows(k, n_pad, t, c)
    vc, omc = _head_rows(v, g, n_pad, t, c), _head_rows(omega, g, n_pad,
                                                         t, c)
    u = torch.zeros((bsz, g, hg, dk, dv), dtype=F32, device=q.device)
    dk_chunks, dv_chunks = [None] * t, [None] * t
    for i in reversed(range(t)):
        q_i, k_i = qc[:, :, i], kc[:, :, i]
        v_i, om_i = vc[:, :, :, i], omc[:, :, :, i]
        cl = torch.cumsum(ldc[:, :, :, i], dim=-1)
        total = cl[..., -1:]
        e_n = torch.exp(total - cl)                      # token -> end
        # m_hi[n, i] = M_in for i >= n (the transposed mask)
        m_hi = _decay_mask(cl, tril).transpose(-1, -2)
        p = torch.einsum("bghie,bghne->bghni", om_i, v_i)  # Ω_i . v_n
        dk_intra = torch.einsum("bghni,bgid->bghnd", p * m_hi, q_i)
        s_qk = torch.einsum("bgid,bgnd->bgni", q_i, k_i)   # q_i . k_n
        dv_intra = torch.einsum("bghni,bghie->bghne",
                                s_qk[:, :, None] * m_hi, om_i)
        dk_inter = e_n[..., None] * torch.einsum("bghde,bghne->bghnd", u,
                                                 v_i)
        dv_inter = e_n[..., None] * torch.einsum("bghde,bgnd->bghne", u,
                                                 k_i)
        dk_chunks[i], dv_chunks[i] = dk_intra + dk_inter, dv_intra + dv_inter
        omw = torch.exp(cl)[..., None] * om_i
        u = (torch.exp(total)[..., None] * u
             + torch.einsum("bgid,bghie->bghde", q_i, omw))
    dk_p = torch.stack(dk_chunks, dim=3).reshape(bsz, g * hg, n_pad, dk)
    dv_o = torch.stack(dv_chunks, dim=3).reshape(bsz, g * hg, n_pad, dv)
    return dk_p[:, :, :n], dv_o[:, :, :n]


def ssd_bwd_epilogue(q, k, v, log_decay, o, omega, dq_part, dk_part, dv):
    """(dq, dk, dv, dlog_decay) from the per-head partials: dq and dk
    summed over each group (the reference sums outside its kernels too),
    dcl = Ω.o - v.dv in f32 and dld its reverse cumsum over tokens.  Each
    comes back in its input's dtype."""
    bsz, g, n, dk = q.shape
    h = v.shape[1]
    dq = dq_part.reshape(bsz, g, h // g, n, dk).sum(2)
    dk_o = dk_part.reshape(bsz, g, h // g, n, dk).sum(2)
    dcl = ((omega.float() * o.float()).sum(-1)
           - (v.float() * dv.float()).sum(-1))               # (B, H, N)
    dld = torch.flip(torch.cumsum(torch.flip(dcl, [-1]), -1), [-1])
    return (dq.to(q.dtype), dk_o.to(k.dtype), dv.to(v.dtype),
            dld.to(log_decay.dtype))


def ssd_bwd_chunked(q, k, v, log_decay, o, omega,
                    chunk: int = DEFAULT_SCAN_CHUNK):
    """Analytic gradient from residuals {q, k, v, log_decay, o} and the
    upstream grad omega (the plain backward).  Returns (dq, dk, dv,
    dlog_decay); dq and dk are group-summed to (B, G, N, Dk)."""
    dq_p = ssd_bwd_q_chunked(k, v, log_decay, omega, chunk)
    dk_p, dv = ssd_bwd_kv_chunked(q, k, v, log_decay, omega, chunk)
    return ssd_bwd_epilogue(q, k, v, log_decay, o, omega, dq_p, dk_p, dv)
