"""The chunked wgmma bodies of the analytic linear-attention backward,
`la_bwd_q` and `la_bwd_kv`: their launch plans, their arithmetic emulated
on the CPU against the JAX package, and on the card both kernels against
their plain versions.

In bf16 at D = 128 `la_bwd_q` runs a forward chunked scan on the tensor
cores, two blocks per (batch, query head), one per half of dq's columns;
`la_bwd_kv` a reverse chunked scan, four blocks per (batch, KV head), for
dk's two column halves and dv's two.  Every operand of their products
that is not a bf16 input (Ω̂, the copies of the states, the score tiles)
goes as a hi + lo pair of bf16 values.  f32 and D < 128 keep the token
walk; `gla_bwd_kv` and `gla_bwd_q` in bf16 at D = 128 run the gated
instances of the two bodies (tests/test_torch_gated_sm90.py,
tests/test_torch_gla_q_decode_sm90.py).

  * plan tests on meta tensors at N = 8192, 1000, 65 and 1, G = 1 and 4:
    the bodies' geometry, shared memory within the H100's 232,448 bytes
    (one block an SM), chunks that cover [0, N) exactly, each dq, dk and
    dv element written by one block, and the walk's plans as they were;
  * each body's arithmetic, emulated in f32 with the kernel's rounding
    points, against the JAX package's `la_bwd_chunked` at H = 4, N = 300
    (a ragged last chunk), G = 1 and 2, for unit random q and k and for q
    and k that share a direction (as the l2-normalized keys of a trained
    model do: Σ k grows with t and the terms of [Ω̂, -h] cancel), within
    one bf16 step (2^-7 of the largest |value|), the limit `chip_smoke.py`
    holds the kernels to; with the lo halves dropped the dq emulation
    misses that limit in the shared regime;
  * a `gpu`-marked test (skips without a card): both kernels against
    their plain versions at ragged N with G = 1 and 2 and in the shared
    regime, and twice for bit-equal outputs.

The machine with the card has no JAX; there the gpu test runs alone
(`--noconftest -m gpu`).
"""
import functools

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import chunked as jchunked

    # one compile per shape (a, b and the chunk are static)
    _jax_la_bwd = jax.jit(jchunked.la_bwd_chunked, static_argnums=(6, 7, 8))
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.core import chunked as tchunked
from repro_torch.kernels import gla as tkgla
from repro_torch.kernels import linear_attention as tkla
from repro_torch.kernels import plan
from repro_torch.kernels.defaults import GLA_STAGE_TOKENS, LA_CHUNK_TOKENS, \
    LA_STAGE_TOKENS

BF16, F32 = torch.bfloat16, torch.float32
D = 128
BF16_REL = 2.0 ** -7
SM_SMEM = 233472   # an SM's shared memory; each block also holds 1 KB
C = LA_CHUNK_TOKENS
# csrc/la_bwd.cu's `bq::kSmem`: two chunks of k's half (64 x 64), v
# (64 x 128) in bf16 and Ω̂ (64 x 128) in f32; Ω̂'s hi and lo bf16 tiles,
# A's hi and lo copies (64 x 128 each); z twice, h, and 2 KB
Q_SMEM = 2 * (8192 + 16384 + 32768) + 4 * 16384 + 512 + 256 + 2048
# `bkv::kSmem`: two steps of a k or v tile, a q tile (bf16) and Ω̂ (f32);
# Ω̂'s hi and lo tiles, U's hi and lo copies; the sums twice, h, and 2 KB
KV_SMEM = 2 * (16384 + 16384 + 32768) + 4 * 16384 + 512 + 256 + 2048


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _plans(dtype, b, h, hkv, n, d=D):
    q, kv = _meta(b, h, n, d, dtype=dtype), _meta(b, hkv, n, d, dtype=dtype)
    om, h_vec = _meta(b, h, n, d, dtype=F32), _meta(b, h, n, dtype=F32)
    return (tkla.plan_la_bwd_q(kv, kv, om, h_vec, 1.0),
            tkla.plan_la_bwd_kv(q, kv, kv, om, h_vec, 1.0, 1.0))


def _written_once(launch, name):
    """Every element of output `name` lies in exactly one block's tile."""
    acc = {a.name: a for a in launch.accesses}[name]
    seen = np.zeros(acc.shape, int)
    for blk in launch.blocks():
        for t in acc.tile(blk):
            seen[tuple(slice(lo, hi) for lo, hi in t.ranges)] += 1
    return bool((seen == 1).all())


@pytest.mark.parametrize("g", [1, 4])
def test_wgmma_plans_geometry_chunks_and_boxes(g):
    """la_bwd_q in bf16 at D = 128: (B H, 2) blocks of one warpgroup,
    183,040 B; la_bwd_kv: (B Hkv, 4) blocks of one warpgroup, 199,424 B;
    each one block an SM, the chunk as the C call's stage.  Chunks cover
    [0, N) exactly; dq, dk and dv each have one writer, by column halves
    (dk's from blocks y = 0, 1, dv's from y = 2, 3)."""
    b, h, hkv = 2, 16, 16 // g
    for entry in ("la_bwd_q", "la_bwd_kv"):
        assert tkla.la_bwd_body(entry, BF16, D) == "wgmma"
    for n in (8192, 1000, 65, 1):
        pq, pkv = _plans(BF16, b, h, hkv, n)
        assert (pq.grid, pq.threads, pq.smem) == ((b * h, 2, 1), 128, Q_SMEM)
        assert (pkv.grid, pkv.threads, pkv.smem) == ((b * hkv, 4, 1), 128,
                                                     KV_SMEM)
        for p in (pq, pkv):
            assert p.smem <= plan.MAX_SMEM < 2 * (p.smem + 1024)
            assert p.smem + 1024 <= SM_SMEM
            assert p.stage == p.args[5] == p.plan_args[5] == C
            spans = [(t0, min(t0 + C, n)) for t0 in range(0, n, p.stage)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
        assert pkv.grid[0] * pkv.grid[1] <= 132
    small_q, small_kv = _plans(BF16, 2, 4, 4 // g, 65)
    assert _written_once(small_q, "dq")
    for name in ("dk", "dv"):
        assert _written_once(small_kv, name), name
    tiles = {a.name: a for a in small_kv.accesses}
    assert [tiles["dk"].tile((0, y, 0))[0].ranges[2:] for y in range(4)] == \
        [((0, 65), (0, 64)), ((0, 65), (64, 128)), ((0, 0), (0, 128)),
         ((0, 0), (0, 128))]
    assert [tiles["dv"].tile((0, y, 0))[0].ranges[2:] for y in range(4)] == \
        [((0, 0), (0, 128)), ((0, 0), (0, 128)), ((0, 65), (0, 64)),
         ((0, 65), (64, 128))]


def test_walk_plans_unchanged():
    """f32 at D = 128 and bf16 at D = 64 keep the token walk: one block
    per (batch, query head) of D threads, or per (batch, KV head) of 2 D
    threads, 32 staged tokens; so do gla_bwd_q and gla_bwd_kv in f32 and
    at D = 64, which in bf16 at D = 128 run the gated wgmma bodies
    (tests/test_torch_gated_sm90.py, tests/test_torch_gla_q_decode_sm90.py):
    gla_bwd_q then (B H, 2) blocks of one warpgroup, the chunk staged."""
    for dtype, d in ((F32, 128), (BF16, 64), (F32, 32)):
        for entry in ("la_bwd_q", "la_bwd_kv"):
            assert tkla.la_bwd_body(entry, dtype, d) == "walk"
        for n in (8192, 1000, 65, 1):
            pq, pkv = _plans(dtype, 2, 16, 4, n, d)
            assert (pq.grid, pq.threads, pq.stage) == ((32, 1, 1), d,
                                                       LA_STAGE_TOKENS)
            assert pq.smem == LA_STAGE_TOKENS * (3 * (d + 16) + 1) * 4
            assert (pkv.grid, pkv.threads) == ((8, 1, 1), 2 * d)
            assert pkv.stage == plan.fit(
                LA_STAGE_TOKENS, ((2 * 4 + 2) * (d + 16) + 4) * 4)[0]
    assert tkla.la_bwd_body("gla_bwd_q", BF16, D) == "wgmma"
    assert tkla.la_bwd_body("gla_bwd_kv", BF16, D) == "wgmma"
    for dtype, d in ((BF16, D), (F32, D), (BF16, 64)):
        q, kv = _meta(2, 16, 1000, d, dtype=dtype), _meta(2, 16, 1000, d,
                                                          dtype=dtype)
        ld = _meta(2, 16, 1000, dtype=F32)
        om, h_vec = _meta(2, 16, 1000, d, dtype=F32), _meta(2, 16, 1000,
                                                            dtype=F32)
        gq = tkgla.plan_gla_bwd_q(kv, kv, ld, om, h_vec, 1.0)
        if dtype == BF16 and d == D:
            assert (gq.grid, gq.threads, gq.stage) == ((32, 2, 1), 128, C)
            continue
        assert tkla.la_bwd_body("gla_bwd_q", dtype, d) == "walk"
        assert (gq.grid, gq.threads, gq.stage) == ((32, 1, 1), d,
                                                   GLA_STAGE_TOKENS)
        assert tkla.la_bwd_body("gla_bwd_kv", dtype, d) == "walk"
        gkv = tkgla.plan_gla_bwd_kv(q, kv, kv, ld, om, h_vec, 1.0, 1.0)
        assert (gkv.grid, gkv.threads) == ((32, 1, 1), 2 * d)


# ---------------------------------------------------------------------------
# the bodies' arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def _parts(x, lo=True):
    """x as its hi + lo bf16 pair (sm90::pack_bf16_split), each in f32;
    only hi where `lo` is False."""
    hi = x.to(BF16).float()
    return (hi, (x - hi).to(BF16).float()) if lo else (hi,)


def _mm(x, y, lo=True):
    """A product with x a hi + lo operand and y a bf16 input."""
    return sum(p @ y for p in _parts(x, lo))


def _mm2(x, y, lo=True):
    """A product of two hi + lo operands: hi hi + lo hi + hi lo."""
    xs, ys = _parts(x, lo), _parts(y, lo)
    out = xs[0] @ ys[0]
    return out + xs[1] @ ys[0] + xs[0] @ ys[1] if lo else out


def _pad(x, n_pad):
    shape = list(x.shape)
    shape[2] = n_pad - shape[2]
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype)], 2)


def _emulate_la_bwd_q(k, v, om, h_vec, b, lo=True):
    """la_bwd_q's wgmma body in f32, chunks in order: P = Ω̂ v^T - h on
    j <= i, R = Ω̂ A^T, dq = b (R + P k - h z^T); then A += k^T v, z +=
    Σ k.  Ω̂, A's copy and P go as hi + lo pairs (only hi: `lo` False).
    dq in bf16."""
    bsz, h, n, d = om.shape
    grp = torch.arange(h) // (h // k.shape[1])
    n_pad = -(-n // C) * C
    kf, vf = _pad(k.float()[:, grp], n_pad), _pad(v.float()[:, grp], n_pad)
    omf, hf = _pad(om, n_pad), _pad(h_vec[..., None], n_pad)
    a_st, z = torch.zeros(bsz, h, d, d), torch.zeros(bsz, h, 1, d)
    lower = torch.ones(C, C, dtype=torch.bool).tril()
    dq = torch.empty(bsz, h, n_pad, d)
    for t0 in range(0, n_pad, C):
        kc, vc, oc, hc = (x[:, :, t0:t0 + C] for x in (kf, vf, omf, hf))
        p = torch.where(lower, _mm(oc, vc.transpose(-1, -2), lo) - hc,
                        torch.zeros(()))
        dq[:, :, t0:t0 + C] = b * (_mm2(oc, a_st.transpose(-1, -2), lo)
                                   + _mm(p, kc, lo) - hc * z)
        a_st = a_st + kc.transpose(-1, -2) @ vc
        z = z + kc.sum(2, keepdim=True)
    return dq[:, :, :n].to(BF16)


def _emulate_la_bwd_kv(q, k, v, om, h_vec, a, b, lo=True):
    """la_bwd_kv's wgmma body in f32, chunks from the last, summed over
    the group: dk = b (v U^T - u_h + T q) with T = v Ω̂^T - 1 h^T on
    i >= p; dv = b k U + a u_Ω + A Ω̂ with A = a + b k q^T on i >= p; then
    U += q^T Ω̂, u_h += q^T h, u_Ω += Σ Ω̂.  Ω̂, U's copies, T and A go as
    hi + lo pairs.  dk and dv in bf16."""
    bsz, h, n, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    n_pad = -(-n // C) * C

    def grouped(x):
        return _pad(x, n_pad).reshape(bsz, hkv, g, n_pad, -1)

    qf, omf, hf = grouped(q.float()), grouped(om), grouped(h_vec[..., None])
    kf, vf = _pad(k.float(), n_pad)[:, :, None], _pad(v.float(),
                                                      n_pad)[:, :, None]
    u = torch.zeros(bsz, hkv, 1, d, d)
    u_h, u_om = torch.zeros(bsz, hkv, 1, 1, d), torch.zeros(bsz, hkv, 1, 1, d)
    upper = torch.ones(C, C, dtype=torch.bool).triu()
    dk, dv = torch.empty(bsz, hkv, n_pad, d), torch.empty(bsz, hkv, n_pad, d)
    for t0 in reversed(range(0, n_pad, C)):
        sl = slice(t0, t0 + C)
        qc, oc, hc, kc, vc = qf[..., sl, :], omf[..., sl, :], hf[..., sl, :], \
            kf[..., sl, :], vf[..., sl, :]
        t_sc = sum(vc @ p.transpose(-1, -2) for p in _parts(oc, lo))
        t_sc = torch.where(upper, t_sc - hc.transpose(-1, -2),
                           torch.zeros(()))
        att = torch.where(upper, a + b * (kc @ qc.transpose(-1, -2)),
                          torch.zeros(()))
        dk_c = sum(vc @ p.transpose(-1, -2) for p in _parts(u, lo)) - u_h \
            + _mm(t_sc, qc, lo).sum(2, keepdim=True)
        dv_c = b * sum(kc @ p for p in _parts(u, lo)) + a * u_om \
            + _mm2(att, oc, lo).sum(2, keepdim=True)
        dk[:, :, sl], dv[:, :, sl] = b * dk_c[:, :, 0], dv_c[:, :, 0]
        u = u + sum(qc.transpose(-1, -2) @ p
                    for p in _parts(oc, lo)).sum(2, keepdim=True)
        u_h = u_h + (qc * hc).sum((2, 3), keepdim=True)
        u_om = u_om + oc.sum((2, 3), keepdim=True)
    return dk[:, :, :n].to(BF16), dv[:, :, :n].to(BF16)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _case(hkv, shared):
    """Unit q and k rows (l2-normalized, as the model hands them over),
    their noise plus `shared` times one common unit direction; normal v
    and upstream grad; the plain forward's o and g, and from them the JAX
    package's chunked backward and the port's Ω̂ and h.  B = 2, H = 4,
    N = 300."""
    rng = np.random.default_rng(23 + hkv)
    b, h, n = 2, 4, 300
    u = rng.standard_normal(D).astype(np.float32)
    u /= np.linalg.norm(u)

    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32) / np.sqrt(D) \
            + shared * u
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    q = torch.from_numpy(unit(b, h, n, D)).to(BF16)
    k = torch.from_numpy(unit(b, hkv, n, D)).to(BF16)
    v = torch.from_numpy(rng.standard_normal((b, hkv, n, D)).astype(
        np.float32)).to(BF16)
    omega = rng.standard_normal((b, h, n, D)).astype(np.float32)
    o, g = tkla.la_fwd_torch(q, k, v, 1.0, 1.0)
    om, h_vec = tchunked.la_bwd_prep(o, g, torch.from_numpy(omega))
    jq, jk, jv, jo = (jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
                      for x in (q, k, v, o))
    want = _jax_la_bwd(jq, jk, jv, jo, jnp.asarray(g.numpy()),
                       jnp.asarray(omega), 1.0, 1.0, 128)
    return (q, k, v, om, h_vec), tuple(np.asarray(w.astype(jnp.float32))
                                       for w in want)


# the regimes: unit random q and k, and q and k whose shared direction
# carries ~10x the norm of their noise
REGIMES = {"random": 0.0, "shared": 10.0}


def test_emulated_la_bwd_q_matches_jax_reference():
    """la_bwd_q's hi + lo operands keep dq within one bf16 step of the
    JAX package's chunked backward at G = 1 and 2, for random and shared
    q and k; with the lo halves dropped the shared regime misses it (dq
    shrinks as the shared direction grows while the cancelling terms do
    not: 3.3x and 7.7x the limit at G = 1 and 2 here, 3.4x on a single
    head at N = 8192 in a CPU study)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    for hkv in (4, 2):
        for regime, shared in REGIMES.items():
            (q, k, v, om, h_vec), (want, _, _) = _case(hkv, shared)
            got = _emulate_la_bwd_q(k, v, om, h_vec, 1.0)
            assert np.isfinite(got.float().numpy()).all()
            assert _rel(got.float(), want) <= BF16_REL, (hkv, regime)
            if regime == "shared":
                hi_only = _emulate_la_bwd_q(k, v, om, h_vec, 1.0, lo=False)
                assert _rel(hi_only.float(), want) > BF16_REL, hkv


def test_emulated_la_bwd_kv_matches_jax_reference():
    """la_bwd_kv's hi + lo operands keep dk and dv within one bf16 step of
    the JAX package's chunked backward at G = 1 and 2, for random and
    shared q and k.  (With the lo halves dropped, dk and dv stay within
    the limit on these inputs, at up to 0.7x of it; in a CPU study of
    single heads at N = 300 one seed of a weaker shared direction reached
    1.5x on dk, and at N = 8192 0.9x: the pairs keep the margin.)"""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    for hkv in (4, 2):
        for regime, shared in REGIMES.items():
            (q, k, v, om, h_vec), (_, want_dk, want_dv) = _case(hkv, shared)
            dk, dv = _emulate_la_bwd_kv(q, k, v, om, h_vec, 1.0, 1.0)
            assert np.isfinite(dk.float().numpy()).all()
            assert np.isfinite(dv.float().numpy()).all()
            assert _rel(dk.float(), want_dk) <= BF16_REL, (hkv, regime)
            assert _rel(dv.float(), want_dv) <= BF16_REL, (hkv, regime)


@pytest.mark.gpu
def test_cuda_la_bwd_bodies_match_plain():
    """la_bwd_q and la_bwd_kv (bf16, D = 128) against their plain versions
    at ragged N (65, 300, 1000) with G = 1 and 2, random and shared q and
    k: dq, dk and dv within one bf16 step; a second launch gives bit-equal
    outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    for hkv, n, shared in ((4, 300, 0.0), (2, 65, 0.0), (4, 1000, 10.0),
                           (2, 300, 10.0)):
        u = torch.randn(D, generator=gen, device=dev)
        u = u / u.norm()

        def unit(*shape):
            x = torch.randn(shape, generator=gen, device=dev) / D ** 0.5 \
                + shared * u
            return (x / x.norm(dim=-1, keepdim=True)).to(BF16)

        q, k = unit(2, 4, n, D), unit(2, hkv, n, D)
        v = torch.randn((2, hkv, n, D), generator=gen, device=dev).to(BF16)
        omega = torch.randn((2, 4, n, D), generator=gen, device=dev)
        o, g = tkla.la_fwd_torch(q, k, v, 1.0, 1.0)
        om, h_vec = tchunked.la_bwd_prep(o, g, omega)
        got = (tkla.la_bwd_q_cuda(k, v, om, h_vec, 1.0),
               *tkla.la_bwd_kv_cuda(q, k, v, om, h_vec, 1.0, 1.0))
        again = (tkla.la_bwd_q_cuda(k, v, om, h_vec, 1.0),
                 *tkla.la_bwd_kv_cuda(q, k, v, om, h_vec, 1.0, 1.0))
        torch.cuda.synchronize()
        want = (tkla.la_bwd_q_torch(k, v, om, h_vec, 1.0),
                *tkla.la_bwd_kv_torch(q, k, v, om, h_vec, 1.0, 1.0))
        for name, x, y, w in zip(("dq", "dk", "dv"), got, again, want):
            assert x.dtype == BF16 and torch.equal(x, y), (name, hkv, n)
            assert _rel(x.float().cpu(), w.float().cpu()) <= BF16_REL, (
                name, hkv, n, shared)
