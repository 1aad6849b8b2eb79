"""The chunked wgmma bodies of `ssd_bwd_q`, `gla_fwd` and `gla_bwd_kv`:
their launch plans, their arithmetic emulated on the CPU against the JAX
package, and on the card the kernels against their plain versions.

`ssd_bwd_q` in bf16 at (Dk, Dv) = (128, 64) runs `ssd_fwd`'s forward
chunked scan with the readout dq = S Ω, one block per (batch, head), its
operands that are not bf16 inputs sent as hi + lo pairs of bf16.
`gla_fwd` and `gla_bwd_kv` in bf16 at D = 128 run the decay-gated
instances of `la_fwd`'s and `la_bwd_kv`'s chunked bodies: the decays as
a chunk's cumsum of log decays, every factor a power of two of a masked
difference <= 0 of it, their non-input operands as hi + lo pairs, dV' in
f32 with its augmented column.  f32, the other dims and `gla_bwd_q` keep
the token walk.

  * plan tests on meta tensors at N = 8192, 1000, 65 and 1, G = 1 and 4:
    the bodies' geometry, shared memory within the H100's 232,448 bytes
    and the blocks per SM each claims, chunks that cover [0, N) exactly,
    each output element written by one block, and the walk's plans as
    they were;
  * the bodies' arithmetic, emulated in f32 at the kernels' rounding
    points, against the JAX package at H = 4, N = 300 (a ragged last
    chunk), G = 1 and 2, under a fresh layer's and the strong U[-5, 0]
    decays: `ssd_bwd_q`'s dq partials, summed over the group, within
    1e-4 of their largest |value|; `gla_fwd`'s o within one bf16 step
    (2^-7) and g within 1e-4; `gla_bwd_kv` through the port's epilogue:
    dk and dv within one bf16 step, dld within 1e-3 and dV' within 1e-4
    of the port's plain version: the limits `chip_smoke.py` holds the
    kernels to;
  * a `gpu`-marked test (skips without a card): the kernels against
    their plain versions at small ragged shapes, and twice for bit-equal
    outputs.

Where JAX is installed the reference runs on the CPU, in f32 (JAX on a
card computes an f32 dot in TF32 by default); the machine with the card
has JAX with a CUDA backend, so the pin matters there.
"""
import numpy as np
import pytest
import torch

try:
    import jax

    # the reference on the CPU, where an f32 dot is an f32 dot (JAX on a
    # card computes it in TF32 by default)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from repro.core import gla as jgla
    from repro.core import ssd as jssd

    # one compile per shape (the chunk is static; a and b too)
    _jax_ssd_bwd = jax.jit(jssd.ssd_bwd_chunked, static_argnums=(6,))
    _jax_gla_fwd = jax.jit(jgla.gla_fwd_chunked, static_argnums=(4, 5, 6))
    _jax_gla_bwd = jax.jit(jgla.gla_bwd_chunked, static_argnums=(7, 8, 9))
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.core import chunked as tchunked
from repro_torch.core import gla as tgla
from repro_torch.kernels import gla as tkgla
from repro_torch.kernels import linear_attention as tkla
from repro_torch.kernels import plan
from repro_torch.kernels import ssd as tkssd
from repro_torch.kernels.defaults import LA_CHUNK_TOKENS, SSD_CHUNK_TOKENS, \
    SSD_STAGE_TOKENS

BF16, F32 = torch.bfloat16, torch.float32
DK, DV = 128, 64
SEQ_F32_REL = 1e-4
SM_SMEM = 233472   # an SM's shared memory; each block also holds 1 KB
LOG2E = 1.4426950408889634
# csrc/ssd.cu's `sq::kSmem`: the hi and lo bf16 copies of S^T (64 x 128),
# two chunks of k (64 x 128), one of v and Ω (64 x 64), the hi and lo
# (w v) tiles, and 2 KB
SSD_SMEM = 2 * 16384 + 2 * 16384 + 2 * 8192 + 2 * 8192 + 2048
D = 128
BF16_REL = 2.0 ** -7
DLD_REL = 1e-3
C = LA_CHUNK_TOKENS
# csrc/la_fwd.cu's `lc::Layout<true>::kSmem`: two chunks of q, k (64 x
# 128) and the block's half of v (64 x 64) in bf16, S^T's hi and lo
# copies (64 x 128), the hi and lo (w v) tiles (64 x 64), z and P twice
# in f32, and 2 KB
GLA_FWD_SMEM = 2 * (2 * 16384 + 8192) + 2 * 16384 + 2 * 8192 \
    + 2 * 4 * (128 + 64) + 2048
# csrc/la_bwd.cu's `bkv::Layout<true>::kSmem`: la_bwd_kv's 199,424 B, the
# augmented column's f32 sums (u_h over 128 columns and Σ h, twice) and
# the step's token weights 2^cl and 2^cl h (64 each)
GLA_BWD_KV_SMEM = 2 * (16384 + 16384 + 32768) + 4 * 16384 + 512 + 256 \
    + 2 * 4 * 128 + 16 + 2 * 4 * 64 + 2048


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _ssd_plan(dtype, b, g, h, n, dk=DK, dv=DV):
    k = _meta(b, g, n, dk, dtype=dtype)
    v = _meta(b, h, n, dv, dtype=dtype)
    return tkssd.plan_ssd_bwd_q(k, v, _meta(b, h, n, dtype=F32), v)


def _spans(n, chunk):
    spans = [(t0, min(t0 + chunk, n)) for t0 in range(0, n, chunk)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    return spans


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
    """ssd_bwd_q in bf16 at (128, 64): B H blocks of one warpgroup,
    100,352 B, two to an SM (160 blocks in one wave on 132 SMs), the
    chunk as its C call's stage.  Chunks cover [0, N) exactly; each dq
    element has one writer."""
    b, h = 2, 80 if g == 1 else 16
    assert tkssd.ssd_body("ssd_bwd_q", BF16, DK, DV) == "wgmma"
    for n in (8192, 1000, 65, 1):
        s = _ssd_plan(BF16, b, g, h, n)
        assert (s.grid, s.threads, s.smem) == ((b * h, 1, 1), 128, SSD_SMEM)
        assert 2 * (s.smem + 1024) <= SM_SMEM and s.smem <= plan.MAX_SMEM
        assert s.stage == s.args[6] == s.plan_args[6] == SSD_CHUNK_TOKENS
        assert len(_spans(n, s.stage)) == -(-n // SSD_CHUNK_TOKENS)
    assert _written_once(_ssd_plan(BF16, 2, g, 8, 65), "dq")


def test_walk_plans_unchanged():
    """ssd_bwd_q in f32 and at the smoke dims keeps its row-tiled walk
    (32 staged tokens)."""
    for dtype, dk, dv, threads, smem in ((F32, 128, 64, 128, 32 * 1796),
                                         (BF16, 16, 32, 32, 32 * 708),
                                         (F32, 16, 32, 32, 32 * 708)):
        assert tkssd.ssd_body("ssd_bwd_q", dtype, dk, dv) == "walk"
        for n in (8192, 1000, 65, 1):
            p = _ssd_plan(dtype, 2, 4, 16, n, dk, dv)
            assert (p.grid, p.threads, p.smem, p.stage) == (
                (32, 1, 1), threads, smem, SSD_STAGE_TOKENS), (dtype, dk, n)
            assert p.args[6] == SSD_STAGE_TOKENS


def _gla_plans(dtype, b, h, hkv, n, d=D):
    q, kv = _meta(b, h, n, d, dtype=dtype), _meta(b, hkv, n, d, dtype=dtype)
    ld = _meta(b, hkv, n, dtype=F32)
    om, h_vec = _meta(b, h, n, d, dtype=F32), _meta(b, h, n, dtype=F32)
    return (tkgla.plan_gla_fwd(q, kv, kv, ld, 1.0, 1.0),
            tkgla.plan_gla_bwd_kv(q, kv, kv, ld, om, h_vec, 1.0, 1.0))


def test_gla_wgmma_plans_geometry_chunks_and_boxes():
    """gla_fwd in bf16 at D = 128: (B H, 2) blocks of one warpgroup,
    134,656 B; gla_bwd_kv: (B Hkv, 4) blocks, 200,976 B; each one block
    an SM, the chunk as the C call's stage, at G = 1 and 4.  Chunks cover
    [0, N) exactly; o, g, dk and dV' each have one writer: o by value
    column halves (g from the first), dk from blocks y = 0, 1 by halves,
    dV' from y = 2, 3 by halves, its column D from y = 2."""
    assert tkla.la_fwd_body(BF16, D, "gla_fwd") == "wgmma"
    assert tkla.la_bwd_body("gla_bwd_kv", BF16, D) == "wgmma"
    for g in (1, 4):
        b, h, hkv = 2, 16, 16 // g
        for n in (8192, 1000, 65, 1):
            pf, pkv = _gla_plans(BF16, b, h, hkv, n)
            assert (pf.grid, pf.threads, pf.smem) == ((b * h, 2, 1), 128,
                                                      GLA_FWD_SMEM)
            assert (pkv.grid, pkv.threads, pkv.smem) == ((b * hkv, 4, 1), 128,
                                                         GLA_BWD_KV_SMEM)
            for p in (pf, pkv):
                assert p.smem <= plan.MAX_SMEM < 2 * (p.smem + 1024)
                assert p.smem + 1024 <= SM_SMEM
                assert p.stage == p.args[5] == p.plan_args[5] == C
                assert len(_spans(n, p.stage)) == -(-n // C)
        small_f, small_kv = _gla_plans(BF16, 2, 4, 4 // g, 65)
        for launch, name in ((small_f, "o"), (small_f, "g"),
                             (small_kv, "dk"), (small_kv, "dva")):
            assert _written_once(launch, name), (g, name)
        dva = {a.name: a for a in small_kv.accesses}["dva"]
        assert [[t.ranges[2:] for t in dva.tile((0, y, 0))]
                for y in range(4)] == [
            [((0, 0), (0, 64))], [((0, 0), (64, 128))],
            [((0, 65), (0, 64)), ((0, 65), (128, 129))],
            [((0, 65), (64, 128))]]


# ---------------------------------------------------------------------------
# the bodies' arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def _bf(x):
    return x.to(BF16).float()


def _split(x):
    """x as its hi + lo bf16 pair (sm90::pack_bf16_split), each in f32."""
    hi = _bf(x)
    return hi, _bf(x - hi)


def _pad(x, n_pad, dim=2):
    shape = list(x.shape)
    shape[dim] = n_pad - shape[dim]
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype)], dim)


def _decay(cl, mask):
    """2^(cl_i - cl_j) where mask (j <= i), else 0: the exponent of a
    masked difference only."""
    diff = cl[..., :, None] - cl[..., None, :]
    return torch.where(mask, torch.exp2(torch.where(mask, diff,
                                                    torch.zeros(()))),
                       torch.zeros(()))


def _emulate_ssd_bwd_q(k, v, log_decay, omega, chunk=SSD_CHUNK_TOKENS):
    """ssd_bwd_q's wgmma body in f32: per chunk, p = Ω v^T, W = p o D, dq
    = 2^cl (Ω S) + W k, S^T = 2^cl_last S^T + (w v)^T k, with W, the copy
    of S^T and w v each taken as its hi + lo bf16 pair.  Per-head dq
    partials, f32."""
    bsz, g, n, dk = k.shape
    h, dv = v.shape[1], v.shape[3]
    grp = torch.arange(h) // (h // g)
    n_pad = -(-n // chunk) * chunk
    kf = _pad(k.float()[:, grp], n_pad)
    vf, omf = _pad(v.float(), n_pad), _pad(omega.float(), n_pad)
    ld = _pad(log_decay.float() * LOG2E, n_pad)
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    st = torch.zeros(bsz, h, dv, dk)
    dq = torch.empty(bsz, h, n_pad, dk)

    def pair_mm(x, y):
        hi, lo = _split(x)
        return hi @ y + lo @ y

    for t0 in range(0, n_pad, chunk):
        sl = slice(t0, t0 + chunk)
        kc, vc, omc = kf[:, :, sl], vf[:, :, sl], omf[:, :, sl]
        cl = torch.cumsum(ld[:, :, sl], -1)
        total = cl[..., -1:]
        wmat = (omc @ vc.transpose(-1, -2)) * _decay(cl, mask)
        s_hi, s_lo = _split(st)
        dq[:, :, sl] = torch.exp2(cl)[..., None] * (omc @ s_hi + omc @ s_lo) \
            + pair_mm(wmat, kc)
        w = torch.exp2(total - cl)
        st = torch.exp2(total)[..., None] * st + pair_mm(
            (w[..., None] * vc).transpose(-1, -2), kc)
    return dq[:, :, :n]


def _gla_log_decay(rng, shape, regime):
    """A fresh GLA layer's gate, log_sigmoid(N(0, 1) + 6), or the strong
    U[-5, 0]."""
    x = rng.standard_normal(shape)
    ld = {"init": -np.log1p(np.exp(-(x + 6.0))),
          "strong": -5.0 * rng.random(shape)}[regime]
    return torch.from_numpy(ld.astype(np.float32))


def _gla_inputs(rng, b, h, hkv, n, regime):
    """Unit q and k rows in bf16 (l2-normalized, as the model hands them
    over), normal v in bf16, a log decay per KV head and an f32 upstream
    grad."""
    def unit(*shape):
        x = rng.standard_normal(shape)
        return torch.from_numpy((x / np.linalg.norm(x, axis=-1,
                                                    keepdims=True)
                                 ).astype(np.float32)).to(BF16)

    return (unit(b, h, n, D), unit(b, hkv, n, D),
            torch.from_numpy(rng.standard_normal((b, hkv, n, D)).astype(
                np.float32)).to(BF16),
            _gla_log_decay(rng, (b, hkv, n), regime),
            torch.from_numpy(rng.standard_normal((b, h, n, D)).astype(
                np.float32)))


def _pair_mm(x, y):
    """x as a hi + lo pair times the bf16 input y."""
    return sum(p @ y for p in _split(x))


def _pair_mm2(x, y):
    """A product of two hi + lo pairs: hi hi + lo hi + hi lo."""
    (xh, xl), (yh, yl) = _split(x), _split(y)
    return xh @ yh + xl @ yh + xh @ yl


def _emulate_gla_fwd(q, k, v, log_decay, a, b):
    """gla_fwd's wgmma body in f32, chunks in order, with cl the chunk's
    cumsum of log decays (base 2): A = (a + b q k^T) o 2^(cl_i - cl_j) on
    j <= i; g = rowsum A + 2^cl_i (a n + b q . z); f = 2^cl_i (b q S + a
    P) + A v; S = 2^total S + k^T (w v), w = 2^(total - cl); z, P and n
    likewise.  A, S's copy and w v go as hi + lo pairs.  (o bf16, g)."""
    bsz, h, n, d = q.shape
    grp = torch.arange(h) // (h // k.shape[1])
    n_pad = -(-n // C) * C
    qf = _pad(q.float(), n_pad)
    kf, vf = _pad(k.float()[:, grp], n_pad), _pad(v.float()[:, grp], n_pad)
    l2 = _pad(log_decay.float()[:, grp] * LOG2E, n_pad)
    s_st, z, p = torch.zeros(bsz, h, d, d), torch.zeros(bsz, h, 1, d), \
        torch.zeros(bsz, h, 1, d)
    cnt = torch.zeros(bsz, h, 1, 1)
    lower = torch.ones(C, C, dtype=torch.bool).tril()
    o, g = torch.empty(bsz, h, n_pad, d), torch.empty(bsz, h, n_pad)
    for t0 in range(0, n_pad, C):
        sl = slice(t0, t0 + C)
        qc, kc, vc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl]
        cl = torch.cumsum(l2[:, :, sl], -1)
        total = cl[..., -1:, None]
        att = (a + b * (qc @ kc.transpose(-1, -2))) * _decay(cl, lower)
        e = torch.exp2(cl)[..., None]
        gc = att.sum(-1, keepdim=True) + e * (
            a * cnt + b * (qc * z).sum(-1, keepdim=True))
        f = e * (b * _pair_mm(s_st.transpose(-1, -2),
                              qc.transpose(-1, -2)).transpose(-1, -2)
                 + a * p) + _pair_mm(att, vc)
        o[:, :, sl] = torch.where(gc.abs() < 1e-30, torch.zeros(()),
                                  f / gc)
        g[:, :, sl] = gc[..., 0]
        w = torch.exp2(total - cl[..., None])
        s_st = torch.exp2(total) * s_st + _pair_mm(
            (w * vc).transpose(-1, -2), kc).transpose(-1, -2)
        z = torch.exp2(total) * z + (w * kc).sum(2, keepdim=True)
        p = torch.exp2(total) * p + (w * vc).sum(2, keepdim=True)
        cnt = torch.exp2(total) * cnt + w.sum(2, keepdim=True)
    return o[:, :, :n].to(BF16), g[:, :, :n]


def _emulate_gla_bwd_kv(q, k, v, log_decay, om, h_vec, a, b):
    """gla_bwd_kv's wgmma body in f32, chunks from the last, summed over
    the group, with e_p = 2^(total - cl_p) and W = 2^(cl_i - cl_p) on
    i >= p: dk = b (e_p (v U^T - u_h) + T q), T = W o (v Ω̂^T - 1 h^T);
    dV' = [e_p (b k U + a u_Ω) + A Ω̂, -(e_p (b k . u_h + a Σ h) + A h)],
    A = W o (a + b k q^T); then U = 2^total U + (2^cl o q)^T Ω̂ and the
    sums likewise.  The dk blocks weight q (a pair times Ω̂'s pair), the
    dv blocks Ω̂; Ω̂, U's copies, T and A go as hi + lo pairs.  (dk bf16,
    dV' f32)."""
    bsz, h, n, d = q.shape
    hkv = k.shape[1]
    g = h // hkv
    n_pad = -(-n // C) * C

    def grouped(x):
        return _pad(x, n_pad).reshape(bsz, hkv, g, n_pad, -1)

    qf, omf, hf = grouped(q.float()), grouped(om), grouped(h_vec[..., None])
    kf, vf = _pad(k.float(), n_pad)[:, :, None], _pad(v.float(),
                                                      n_pad)[:, :, None]
    l2 = _pad(log_decay.float() * LOG2E, n_pad)[:, :, None]
    u_k, u_v = torch.zeros(bsz, hkv, 1, d, d), torch.zeros(bsz, hkv, 1, d, d)
    u_h, u_om = torch.zeros(bsz, hkv, 1, 1, d), torch.zeros(bsz, hkv, 1, 1, d)
    h_sum = torch.zeros(bsz, hkv, 1, 1, 1)
    lower = torch.ones(C, C, dtype=torch.bool).tril()
    dk, dva = torch.empty(bsz, hkv, n_pad, d), torch.empty(bsz, hkv, n_pad,
                                                           d + 1)
    for t0 in reversed(range(0, n_pad, C)):
        sl = slice(t0, t0 + C)
        qc, oc, hc, kc, vc = qf[..., sl, :], omf[..., sl, :], \
            hf[..., sl, :], kf[..., sl, :], vf[..., sl, :]
        cl = torch.cumsum(l2[..., sl], -1)
        total = cl[..., -1:, None]
        e_p = torch.exp2(total - cl[..., None])
        wmat = _decay(cl, lower).transpose(-1, -2)     # rows p, columns i
        t_sc = wmat * (_pair_mm(oc, vc.transpose(-1, -2)).transpose(-1, -2)
                       - hc.transpose(-1, -2))
        att = wmat * (a + b * (kc @ qc.transpose(-1, -2)))
        dk_c = e_p * (_pair_mm(u_k, vc.transpose(-1, -2)).transpose(-1, -2)
                      - u_h) + _pair_mm(t_sc, qc).sum(2, keepdim=True)
        dv_c = e_p * (b * _pair_mm(u_v.transpose(-1, -2),
                                   kc.transpose(-1, -2)).transpose(-1, -2)
                      + a * u_om) + _pair_mm2(att, oc).sum(2, keepdim=True)
        xd = e_p * (b * (kc * u_h).sum(-1, keepdim=True) + a * h_sum) \
            + (att @ hc).sum(2, keepdim=True)
        dk[:, :, sl] = b * dk_c[:, :, 0]
        dva[:, :, sl, :d], dva[:, :, sl, d] = dv_c[:, :, 0], -xd[:, :, 0, :, 0]
        w = torch.exp2(cl[..., None])
        decay = torch.exp2(total)
        u_k = decay * u_k + _pair_mm2((w * qc).transpose(-1, -2),
                                      oc).sum(2, keepdim=True)
        u_v = decay * u_v + _pair_mm((w * oc).transpose(-1, -2),
                                     qc).transpose(-1, -2).sum(2, keepdim=True)
        u_h = decay * u_h + (w * qc * hc).sum((2, 3), keepdim=True)
        u_om = decay * u_om + (w * oc).sum((2, 3), keepdim=True)
        h_sum = decay * h_sum + (w * hc).sum((2, 3), keepdim=True)
    return dk[:, :, :n].to(BF16), dva[:, :, :n]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _log_decay(rng, shape, regime):
    """A fresh SSD layer's -softplus(N(0, 1)), or the strong U[-5, 0]."""
    x = rng.standard_normal(shape)
    ld = {"init": -np.log1p(np.exp(x)),
          "strong": -5.0 * rng.random(shape)}[regime]
    return torch.from_numpy(ld.astype(np.float32))


def _ssd_inputs(rng, b, g, h, n, regime):
    def bf16(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(BF16)

    return (bf16(b, g, n, DK, scale=0.5), bf16(b, h, n, DV),
            _log_decay(rng, (b, h, n), regime), bf16(b, h, n, DV))


def _np(x):
    return jnp.asarray(x.float().numpy())


def test_emulated_ssd_bwd_q_matches_jax_reference():
    """ssd_bwd_q's hi + lo operands keep the dq partials, summed over the
    group, within 1e-4 of the JAX package's chunked SSD backward, under a
    fresh layer's decays and the strong U[-5, 0], at G = 1 and 2 with a
    ragged last chunk (N = 300)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(31)
    b, h, n = 2, 4, 300
    for g, regime in ((1, "init"), (2, "strong")):
        k, v, ld, om = _ssd_inputs(rng, b, g, h, n, regime)
        dq_p = _emulate_ssd_bwd_q(k, v, ld, om)
        want_dq, _, _, _ = _jax_ssd_bwd(
            _np(k), _np(k), _np(v), jnp.asarray(ld.numpy()),
            jnp.zeros(v.shape, jnp.float32), _np(om), 128)
        dq = dq_p.reshape(b, g, h // g, n, DK).sum(2)
        assert np.isfinite(dq.numpy()).all()
        assert _rel(dq, want_dq) <= SEQ_F32_REL, (g, regime)


def test_emulated_gla_fwd_matches_jax_reference():
    """gla_fwd's gated body keeps o within one bf16 step and g within 1e-4
    of the JAX package's chunked GLA forward, under a fresh layer's gate
    and the strong U[-5, 0], at G = 1 and 2 with a ragged last chunk
    (N = 300)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(41)
    for g, regime in ((1, "init"), (2, "strong")):
        q, k, v, ld, _ = _gla_inputs(rng, 2, 4, 4 // g, 300, regime)
        o, gn = _emulate_gla_fwd(q, k, v, ld, 1.0, 0.5)
        want_o, want_g, _ = _jax_gla_fwd(_np(q), _np(k), _np(v),
                                         jnp.asarray(ld.numpy()), 1.0, 0.5,
                                         128)
        assert np.isfinite(o.float().numpy()).all()
        assert _rel(o.float(), want_o) <= BF16_REL, (g, regime)
        assert _rel(gn, want_g) <= SEQ_F32_REL, (g, regime)


def test_emulated_gla_bwd_kv_matches_jax_reference():
    """gla_bwd_kv's gated body, through the port's epilogue: dk and dv
    within one bf16 step and dld within 1e-3 of the JAX package's chunked
    GLA backward, and dV' within 1e-4 of the port's plain version, under
    a fresh layer's gate and the strong U[-5, 0], at G = 1 and 2 with a
    ragged last chunk (N = 300)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(42)
    a, b = 1.0, 0.5
    for g, regime in ((1, "init"), (2, "strong")):
        q, k, v, ld, om = _gla_inputs(rng, 2, 4, 4 // g, 300, regime)
        args = (_np(q), _np(k), _np(v), jnp.asarray(ld.numpy()))
        o, gn, _ = _jax_gla_fwd(*args, a, b, 128)
        _, want_dk, want_dv, want_dld = _jax_gla_bwd(
            *args, o, gn, jnp.asarray(om.numpy()), a, b, 128)
        om_hat, h_vec = tchunked.la_bwd_prep(
            torch.from_numpy(np.array(o)), torch.from_numpy(np.array(gn)),
            om)
        dk, dva = _emulate_gla_bwd_kv(q, k, v, ld, om_hat, h_vec, a, b)
        dv, dld = tgla.gla_bwd_epilogue(v, dva, ld)
        _, plain_dva = tkgla.gla_bwd_kv_torch(q, k, v, ld, om_hat, h_vec, a,
                                              b, 128)
        assert np.isfinite(dva.numpy()).all()
        assert _rel(dk.float(), want_dk) <= BF16_REL, (g, regime)
        assert _rel(dv.float(), want_dv) <= BF16_REL, (g, regime)
        assert _rel(dld, want_dld) <= DLD_REL, (g, regime)
        assert _rel(dva, plain_dva) <= SEQ_F32_REL, (g, regime)


@pytest.mark.gpu
def test_cuda_gated_bodies_match_plain():
    """ssd_bwd_q (bf16, (128, 64)) against its plain version at ragged N
    (1, 65, 300) with G = 1 and 2, under both decay regimes: the dq
    partials within 1e-4; gla_fwd and gla_bwd_kv (bf16, D = 128, their
    gated wgmma bodies) at N = 300 and 65 with G = 1 and 2: o within one
    bf16 step, g within 1e-4, dk within one bf16 step, dV' within 1e-4
    and dld within 1e-3.  A second launch of each gives bit-equal
    outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(32)
    for g_, h, n, regime in ((1, 8, 300, "init"), (2, 4, 65, "strong"),
                             (1, 4, 1, "init")):
        k, v, ld, om = (x.to(dev) for x in _ssd_inputs(rng, 2, g_, h, n,
                                                       regime))
        dq = tkssd.ssd_bwd_q_cuda(k, v, ld, om)
        dq2 = tkssd.ssd_bwd_q_cuda(k, v, ld, om)
        torch.cuda.synchronize()
        want = tkssd.ssd_bwd_q_torch(k, v, ld, om)
        assert torch.equal(dq, dq2)
        assert _rel(dq.cpu(), want.cpu()) <= SEQ_F32_REL
    for g_, n, regime in ((1, 300, "init"), (2, 65, "strong")):
        q, k, v, ld, om = (x.to(dev) for x in _gla_inputs(rng, 2, 4, 4 // g_,
                                                          n, regime))
        assert tkla.la_fwd_body(q.dtype, D, "gla_fwd") == "wgmma"
        o, gn = tkgla.gla_fwd_cuda(q, k, v, ld, 1.0, 0.5)
        o2, gn2 = tkgla.gla_fwd_cuda(q, k, v, ld, 1.0, 0.5)
        torch.cuda.synchronize()
        o_t, g_t = tkgla.gla_fwd_torch(q, k, v, ld, 1.0, 0.5)
        assert torch.equal(o, o2) and torch.equal(gn, gn2)
        assert _rel(o.float().cpu(), o_t.float().cpu()) <= BF16_REL
        assert _rel(gn.cpu(), g_t.cpu()) <= SEQ_F32_REL
        om_hat, h_vec = tchunked.la_bwd_prep(o_t, g_t, om)
        dk, dva = tkgla.gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, 1.0, 0.5)
        dk2, dva2 = tkgla.gla_bwd_kv_cuda(q, k, v, ld, om_hat, h_vec, 1.0,
                                          0.5)
        torch.cuda.synchronize()
        dk_t, dva_t = tkgla.gla_bwd_kv_torch(q, k, v, ld, om_hat, h_vec, 1.0,
                                             0.5)
        assert torch.equal(dk, dk2) and torch.equal(dva, dva2)
        assert _rel(dk.float().cpu(), dk_t.float().cpu()) <= BF16_REL
        assert _rel(dva.cpu(), dva_t.cpu()) <= SEQ_F32_REL
        dld = tgla.gla_bwd_epilogue(v, dva, ld)[1]
        dld_t = tgla.gla_bwd_epilogue(v, dva_t, ld)[1]
        assert _rel(dld.cpu(), dld_t.cpu()) <= DLD_REL
