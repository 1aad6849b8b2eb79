"""Quadratic oracles of the linear, GLA, SSD and softmax families (port of
`repro/kernels/ref.py`: `expand_kv`, `la_ref`, `gla_ref`, `ssd_ref`,
`softmax_ref`).

Each materializes the full N x N score matrix and is a correctness
reference only; all accumulation is f32.  The oracle is grouped-native:
queries are viewed as (B, Hkv, G, N, D) and contracted against the
unexpanded (B, Hkv, N, D) keys and values.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def expand_kv(x: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """Repeat KV heads (B, Hkv, N, D) -> (B, H, N, D): query head h reads
    KV head h // G.  Materializes the H/Hkv-fold copy."""
    hkv = x.shape[1]
    if hkv == num_q_heads:
        return x
    if num_q_heads % hkv != 0:
        raise ValueError(f"H={num_q_heads} is not a multiple of Hkv={hkv}")
    return x.repeat_interleave(num_q_heads // hkv, dim=1)


def la_weights(q, k, a: float = 1.0, b: float = 1.0, causal: bool = True):
    """(a + b q.k) scores (B, Hkv, G, Nq, Nk) in f32, causal-masked."""
    bq, h, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    qg = q.reshape(bq, hkv, h // hkv, nq, d).float()
    w = a + b * torch.einsum("bkgid,bkjd->bkgij", qg, k.float())
    if causal:
        mask = torch.ones((nq, nk), dtype=torch.bool,
                          device=q.device).tril(nk - nq)
        w = torch.where(mask, w, torch.zeros((), dtype=F32,
                                             device=q.device))
    return w


def la_ref(q, k, v, a: float = 1.0, b: float = 1.0, causal: bool = True):
    """Normalized linear attention, paper Eq. 4:

        o_ij = sum_n (a + b q_i.k_n) v_nj / sum_n (a + b q_i.k_n)

    q: (B, H, Nq, D); k, v: (B, Hkv, Nk, D) with Hkv | H.  Returns
    (B, H, Nq, Dv) in q.dtype.  O(N^2 D) time and O(N^2) memory.
    """
    bq, h, nq, _ = q.shape
    w = la_weights(q, k, a, b, causal)
    o = torch.einsum("bkgij,bkjd->bkgid", w, v.float()) \
        / w.sum(-1, keepdim=True)
    return o.reshape(bq, h, nq, v.shape[-1]).to(q.dtype)


def gla_ref(q, k, v, log_decay, a: float = 1.0, b: float = 1.0,
            return_g: bool = False):
    """Decay-gated normalized linear attention oracle (GLA family):

        o_i = sum_{n<=i} M_in (a + b q_i.k_n) v_n / sum_{n<=i} M_in (a + b
        q_i.k_n),  M_in = prod_{m=n+1..i} exp(ld_m)

    q: (B, H, N, D); k, v: (B, Hkv, N, D) with Hkv | H; log_decay:
    (B, Hkv, N) <= 0, one decay per KV head shared by its query group.
    log_decay == 0 is exactly `la_ref`.  Returns (B, H, N, Dv) in
    q.dtype, and with return_g also the (B, H, N) f32 normalizer (the
    `ref` impl's residual, so it cannot drift from the oracle's masking).
    """
    bq, h, n, d = q.shape
    hkv = k.shape[1]
    qg = q.reshape(bq, hkv, h // hkv, n, d).float()
    cl = torch.cumsum(log_decay.float(), dim=-1)          # (B, Hkv, N)
    diff = cl[..., :, None] - cl[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    zero = torch.zeros((), dtype=F32, device=q.device)
    # double where: the masked exponents are large positive differences
    # that overflow and would give autograd of the oracle nan grads
    m = torch.where(mask, torch.exp(torch.where(mask, diff, zero)), zero)
    w = (a + b * torch.einsum("bkgid,bkjd->bkgij", qg, k.float())) \
        * m[:, :, None]
    g = w.sum(-1, keepdim=True)
    o = torch.einsum("bkgij,bkjd->bkgid", w, v.float()) / g
    o = o.reshape(bq, h, n, v.shape[-1]).to(q.dtype)
    if return_g:
        return o, g[..., 0].reshape(bq, h, n)
    return o


def ssd_ref(q, k, v, log_decay):
    """State-space-duality (Mamba-2) oracle: scalar-decay linear attention
    with no normalizer,

        o_i = sum_{n<=i} M_in (q_i.k_n) v_n,  M_in = prod_{m=n+1..i}
        exp(ld_m)

    q, k: (B, G, N, Dk) with G | H, shared by the H/G heads of a group
    (not expanded); v: (B, H, N, Dv); log_decay: (B, H, N) <= 0, one
    decay per head.  Returns (B, H, N, Dv) in v.dtype.
    """
    b, grp, n, _ = q.shape
    h = v.shape[1]
    vf = v.float().reshape(b, grp, h // grp, n, v.shape[-1])
    cl = torch.cumsum(log_decay.float(), dim=-1).reshape(b, grp, h // grp, n)
    diff = cl[..., :, None] - cl[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    zero = torch.zeros((), dtype=F32, device=q.device)
    # double where, as in gla_ref: no overflow above the diagonal
    m = torch.where(mask, torch.exp(torch.where(mask, diff, zero)), zero)
    s = torch.einsum("bkid,bkjd->bkij", q.float(), k.float())  # per group
    o = torch.einsum("bkij,bkgij,bkgjd->bkgid", s, m, vf)
    return o.reshape(b, h, n, v.shape[-1]).to(v.dtype)


def softmax_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """Regular softmax attention, paper Eq. 2/3.

    q: (B, H, Nq, D); k, v: (B, Hkv, Nk, D) with Hkv | H; causal masks
    at the training offset (query i sees keys j <= i + Nk - Nq).
    Returns (B, H, Nq, Dv) in q.dtype.  O(N^2) memory — tests only.
    """
    bq, h, nq, d = q.shape
    hkv, nk = k.shape[1], k.shape[2]
    qg = q.reshape(bq, hkv, h // hkv, nq, d).float()
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s = torch.einsum("bkgid,bkjd->bkgij", qg, k.float()) * scale
    if causal:
        mask = torch.ones((nq, nk), dtype=torch.bool,
                          device=q.device).tril(nk - nq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bkjd->bkgid", p, v.float())
    return o.reshape(bq, h, nq, v.shape[-1]).to(q.dtype)
