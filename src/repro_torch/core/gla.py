"""Chunked decay-gated (GLA-style) normalized linear attention (plain PyTorch).

Port of `repro/core/gla.py`: the paper's chunked scan (core/chunked.py)
with a learned per-KV-head, per-token decay gamma_t = exp(log_decay_t) in
(0, 1] multiplying the running state:

    S_t = gamma_t S_{t-1} + k_t (x) [v_t, 1]      (D, D+1)
    P_t = gamma_t P_{t-1} + [v_t, 1]              (D+1,)
    F_t = a P_t + b q_t S_t ;  o_t = F[:D] / F[D]

so the weight of key n at query i is M_in (a + b q_i.k_n) with
M_in = prod_{m=n+1..i} gamma_m.  log_decay == 0 is exactly the linear
family (la_fwd_chunked).  Within a chunk the decay exponents are
differences of a non-increasing cumsum; `_decay_mask` clamps them at 0
before exp, so no exp() overflows under strong decay.

The backward from residuals {q, k, v, log_decay, o, g} (O(N D)): with
om_hat = omega / g, h_i = o_i . om_hat_i and gmat = [om_hat, -h],

    dq_i  = b S_i gmat_i                          (forward chunk scan)
    dk_n  = b U_n[:D] V'_n                        (reverse chunk scan,
    dV'_n = b U_n[:D]^T k_n + a U_n[D]             U = decayed qaug^T gmat)
    dcl_n = -V'_n . dV'_n ;  dld_t = sum_{n >= t} dcl_n

It is split as the CUDA kernels are (`gla_bwd_q_chunked`,
`gla_bwd_kv_chunked` returning dV' in f32, `gla_bwd_epilogue`), so each
kernel has its plain version.  Every product runs in f32 on f32 copies
of the inputs.  Grouped-query attention is native: q is (B, H, N, D),
k, v are (B, Hkv, N, D) and log_decay is (B, Hkv, N).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.chunked import _ones_col, _pad_seq, la_bwd_prep
from repro_torch.core.numerics import safe_div
from repro_torch.kernels.defaults import DEFAULT_SCAN_CHUNK

F32 = torch.float32


class GLAState(NamedTuple):
    """Decayed recurrent GLA state (decode cache; constant in N).

    The linear family's shapes, s (B, Hkv, Dk, Dv+1) and p (B, Hkv, Dv+1)
    in f32, but every accumulated term carries the decay from its token
    to the state's frontier.
    """

    s: torch.Tensor
    p: torch.Tensor


def init_gla_state(batch: int, num_kv_heads: int, dk: int,
                   dv: Optional[int] = None, device="cuda") -> GLAState:
    dv = dk if dv is None else dv
    return GLAState(
        s=torch.zeros((batch, num_kv_heads, dk, dv + 1), dtype=F32,
                      device=device),
        p=torch.zeros((batch, num_kv_heads, dv + 1), dtype=F32,
                      device=device),
    )


def _decay_mask(cl: torch.Tensor, tril: torch.Tensor) -> torch.Tensor:
    """(..., C) cumulative log decay -> (..., C, C) M_in for n <= i, else
    0.  The exponent is clamped at 0: above the diagonal the differences
    are positive and would overflow under strong decay before the mask
    zeroes them."""
    diff = torch.clamp(cl[..., :, None] - cl[..., None, :], max=0.0)
    return torch.where(tril, torch.exp(diff), torch.zeros((), dtype=F32,
                                                          device=cl.device))


def _chunked_ld(log_decay, n_pad, t, c):
    """(B, Hkv, N) log decay -> (B, Hkv, T, C) f32; padded rows are 0 (no
    decay), so padding never shrinks the carried state."""
    ld = F.pad(log_decay.float(), (0, n_pad - log_decay.shape[-1]))
    return ld.reshape(ld.shape[0], ld.shape[1], t, c)


def _tiles(n, chunk, device):
    c = min(chunk, n)
    t = -(-n // c)
    return c, t, t * c, torch.tril(torch.ones((c, c), dtype=torch.bool,
                                              device=device))


# ---------------------------------------------------------------------------
# Forward (causal)
# ---------------------------------------------------------------------------

def gla_fwd_chunked(q, k, v, log_decay, a: float, b: float,
                    chunk: int = DEFAULT_SCAN_CHUNK,
                    state: Optional[GLAState] = None):
    """Causal decay-gated normalized linear attention, chunked scan.

    q: (B, H, N, Dk); k, v: (B, Hkv, N, D); log_decay: (B, Hkv, N) <= 0.
    Returns (o, g, final_state): o (B, H, N, Dv) in q.dtype, g (B, H, N)
    f32 normalizer, final_state an f32 GLAState that feeds decode.
    """
    bsz, h, n, dk = q.shape
    dv = v.shape[-1]
    hkv = k.shape[1]
    grp = h // hkv
    c, t, n_pad, tril = _tiles(n, chunk, q.device)

    qg = _pad_seq(q, n_pad).float().reshape(bsz, hkv, grp, t, c, dk)
    kc = _pad_seq(k, n_pad).float().reshape(bsz, hkv, t, c, dk)
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    # ones column appended BEFORE padding so padded rows contribute
    # nothing to the carried state
    vaug = _pad_seq(torch.cat([v, ones], -1), n_pad).float()
    vaug = vaug.reshape(bsz, hkv, t, c, dv + 1)
    ldc = _chunked_ld(log_decay, n_pad, t, c)

    if state is None:
        state = init_gla_state(bsz, hkv, dk, dv, device=q.device)
    s, p = state.s.float(), state.p.float()
    f_chunks = []
    for i in range(t):
        q_i, k_i, va_i = qg[:, :, :, i], kc[:, :, i], vaug[:, :, i]
        cl = torch.cumsum(ldc[:, :, i], dim=-1)          # (B, Hkv, C)
        total = cl[..., -1:]
        att = a + b * torch.einsum("bhgid,bhjd->bhgij", q_i, k_i)
        att = att * _decay_mask(cl, tril)[:, :, None]
        f_intra = torch.einsum("bhgij,bhje->bhgie", att, va_i)
        f_inter = torch.exp(cl)[:, :, None, :, None] * (
            a * p[:, :, None, None, :]
            + b * torch.einsum("bhgid,bhde->bhgie", q_i, s))
        f_chunks.append(f_intra + f_inter)
        vw = torch.exp(total - cl)[..., None] * va_i
        s = (torch.exp(total)[..., None] * s
             + torch.einsum("bhjd,bhje->bhde", k_i, vw))
        p = torch.exp(total) * p + vw.sum(dim=-2)
    # (B, Hkv, G, T, C, Dv+1) -> (B, H, N, Dv+1)
    f_all = torch.stack(f_chunks, dim=3).reshape(bsz, h, n_pad, dv + 1)
    f_all = f_all[:, :, :n]
    g = f_all[..., dv]
    o = safe_div(f_all[..., :dv], g[..., None]).to(q.dtype)
    return o, g, GLAState(s, p)


# ---------------------------------------------------------------------------
# Backward (causal): dq, then dk and dV', then the log-decay epilogue
# ---------------------------------------------------------------------------

def gla_bwd_q_chunked(k, v, log_decay, om_hat, h_vec, b: float,
                      chunk: int = DEFAULT_SCAN_CHUNK, out_dtype=None):
    """dq by a forward chunk scan carrying the forward's decayed state S.

    k, v: (B, Hkv, N, D); log_decay (B, Hkv, N); om_hat (B, H, N, Dv)
    and h_vec (B, H, N) f32 from `la_bwd_prep`.  Returns dq (B, H, N, Dk)
    in out_dtype (k.dtype by default).
    """
    bsz, h, n, dv = om_hat.shape
    hkv, dk = k.shape[1], k.shape[-1]
    grp = h // hkv
    c, t, n_pad, tril = _tiles(n, chunk, k.device)
    kc = _pad_seq(k, n_pad).float().reshape(bsz, hkv, t, c, dk)
    vaug = torch.cat([v.float(), _ones_col(v)], -1)
    vaug = _pad_seq(vaug, n_pad).reshape(bsz, hkv, t, c, dv + 1)
    # gmat = [om_hat, -h]: padded rows are zero
    gmat = torch.cat([om_hat, -h_vec[..., None]], -1)
    gmat = _pad_seq(gmat, n_pad).reshape(bsz, hkv, grp, t, c, dv + 1)
    ldc = _chunked_ld(log_decay, n_pad, t, c)
    s = torch.zeros((bsz, hkv, dk, dv + 1), dtype=F32, device=k.device)
    dq_chunks = []
    for i in range(t):
        k_i, va_i, gm_i = kc[:, :, i], vaug[:, :, i], gmat[:, :, :, i]
        cl = torch.cumsum(ldc[:, :, i], dim=-1)
        total = cl[..., -1:]
        sc = torch.einsum("bhgie,bhje->bhgij", gm_i, va_i)
        sc = sc * _decay_mask(cl, tril)[:, :, None]
        dq = (torch.einsum("bhgij,bhjd->bhgid", sc, k_i)
              + torch.exp(cl)[:, :, None, :, None]
              * torch.einsum("bhgie,bhde->bhgid", gm_i, s))
        vw = torch.exp(total - cl)[..., None] * va_i
        s = (torch.exp(total)[..., None] * s
             + torch.einsum("bhjd,bhje->bhde", k_i, vw))
        dq_chunks.append(b * dq)
    dq = torch.stack(dq_chunks, 3).reshape(bsz, h, n_pad, dk)[:, :, :n]
    return dq.to(out_dtype or k.dtype)


def gla_bwd_kv_chunked(q, k, v, log_decay, om_hat, h_vec, a: float,
                       b: float, chunk: int = DEFAULT_SCAN_CHUNK):
    """dk and the augmented dV' by a reverse chunk scan carrying
    U = the decayed suffix sum of [q, 1]^T [om_hat, -h] (Dk+1, Dv+1), the
    G query heads of a KV head summed into U.  Returns dk (B, Hkv, N, Dk)
    in k.dtype and dV' (B, Hkv, N, Dv+1) in f32."""
    bsz, h, n, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    grp = h // hkv
    c, t, n_pad, tril = _tiles(n, chunk, q.device)
    qc = _pad_seq(q, n_pad).float().reshape(bsz, hkv, grp, t, c, dk)
    qaug = torch.cat([qc, torch.ones(qc.shape[:-1] + (1,), dtype=F32,
                                     device=q.device)], -1)
    kc = _pad_seq(k, n_pad).float().reshape(bsz, hkv, t, c, dk)
    vaug = torch.cat([v.float(), _ones_col(v)], -1)
    vaug = _pad_seq(vaug, n_pad).reshape(bsz, hkv, t, c, dv + 1)
    # gmat = [om_hat, -h]: padded rows are zero, so they add nothing to U
    gmat = torch.cat([om_hat, -h_vec[..., None]], -1)
    gmat = _pad_seq(gmat, n_pad).reshape(bsz, hkv, grp, t, c, dv + 1)
    ldc = _chunked_ld(log_decay, n_pad, t, c)
    u = torch.zeros((bsz, hkv, dk + 1, dv + 1), dtype=F32, device=q.device)
    dk_chunks, dva_chunks = [None] * t, [None] * t
    for i in reversed(range(t)):
        q_i, qa_i, k_i = qc[:, :, :, i], qaug[:, :, :, i], kc[:, :, i]
        va_i, gm_i = vaug[:, :, i], gmat[:, :, :, i]
        cl = torch.cumsum(ldc[:, :, i], dim=-1)
        total = cl[..., -1:]
        e_p = torch.exp(total - cl)                      # token -> end
        # m_hi[p, i] = exp(cl_i - cl_p) for i >= p (the transposed mask)
        m_hi = _decay_mask(cl, tril).transpose(-1, -2)
        # dk intra: sum_{i >= p} M_ip (gmat_i . V'_p) q_i
        sc = torch.einsum("bhgie,bhpe->bhgpi", gm_i, va_i) * m_hi[:, :, None]
        dk_ = (torch.einsum("bhgpi,bhgid->bhpd", sc, q_i)
               + e_p[..., None] * torch.einsum("bhpe,bhde->bhpd", va_i,
                                               u[..., :dk, :]))
        # dV' intra: sum_{i >= p} M_ip (a + b q_i.k_p) gmat_i
        att = a + b * torch.einsum("bhgid,bhpd->bhgpi", q_i, k_i)
        att = att * m_hi[:, :, None]
        dva = (torch.einsum("bhgpi,bhgie->bhpe", att, gm_i)
               + e_p[..., None] * (
                   b * torch.einsum("bhpd,bhde->bhpe", k_i, u[..., :dk, :])
                   + a * u[..., dk, :][:, :, None, :]))
        omw = torch.exp(cl)[:, :, None, :, None] * gm_i
        u = (torch.exp(total)[..., None] * u
             + torch.einsum("bhgic,bhgie->bhce", qa_i, omw))
        dk_chunks[i], dva_chunks[i] = b * dk_, dva
    dk_o = torch.stack(dk_chunks, 2).reshape(bsz, hkv, n_pad, dk)[:, :, :n]
    dva_o = torch.stack(dva_chunks, 2).reshape(bsz, hkv, n_pad,
                                               dv + 1)[:, :, :n]
    return dk_o.to(k.dtype), dva_o


def gla_bwd_epilogue(v, dva, log_decay):
    """(dv, dlog_decay) from the augmented dV' (B, Hkv, N, Dv+1) f32:
    dcl = -[v, 1] . dV' (the row term df_i . f_i vanishes under the
    normalization) and dld = its reverse cumsum over tokens."""
    dv = v.shape[-1]
    dcl = -((v.float() * dva[..., :dv]).sum(-1) + dva[..., dv])
    dld = torch.flip(torch.cumsum(torch.flip(dcl, [-1]), -1), [-1])
    return dva[..., :dv].to(v.dtype), dld.to(log_decay.dtype)


def gla_bwd_chunked(q, k, v, log_decay, o, g, omega, a: float, b: float,
                    chunk: int = DEFAULT_SCAN_CHUNK):
    """Analytic gradient from residuals {q, k, v, ld, o, g} and upstream
    grad omega (the plain backward).  Returns (dq, dk, dv, dlog_decay) in
    the respective input dtypes."""
    om_hat, h_vec = la_bwd_prep(o, g, omega)
    dq = gla_bwd_q_chunked(k, v, log_decay, om_hat, h_vec, b, chunk,
                           out_dtype=q.dtype)
    dk, dva = gla_bwd_kv_chunked(q, k, v, log_decay, om_hat, h_vec, a, b,
                                 chunk)
    dv, dld = gla_bwd_epilogue(v, dva, log_decay)
    return dq, dk, dv, dld


# ---------------------------------------------------------------------------
# Decode (serving): O(D^2) per token, state independent of context length
# ---------------------------------------------------------------------------

def gla_decode_step(state: GLAState, q, k, v, log_decay, a: float,
                    b: float):
    """One-token decode, functional.  q: (B, H, Dk); k, v: (B, Hkv, D);
    log_decay: (B, Hkv).  Returns (new_state, o) with o (B, H, Dv) in
    q.dtype.  The fused decode family (kernels/decode_fused.py) computes
    the same function with the state updated in place."""
    bsz, h, dk = q.shape
    dv = v.shape[-1]
    hkv = k.shape[1]
    kf, vf = k.float(), v.float()
    gamma = torch.exp(log_decay.float())                 # (B, Hkv)
    vaug = torch.cat([vf, torch.ones((bsz, hkv, 1), dtype=F32,
                                     device=v.device)], -1)
    s = (gamma[..., None, None] * state.s.float()
         + kf[..., :, None] * vaug[..., None, :])
    p = gamma[..., None] * state.p.float() + vaug
    qg = q.reshape(bsz, hkv, h // hkv, dk).float()
    f = a * p[:, :, None, :] + b * torch.einsum("bhgd,bhde->bhge", qg, s)
    o = safe_div(f[..., :dv], f[..., dv:])
    return GLAState(s, p), o.reshape(bsz, h, dv).to(q.dtype)
