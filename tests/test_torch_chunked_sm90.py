"""The chunked wgmma bodies of `la_fwd` and `ssd_bwd_kv`: their launch
plans, their arithmetic emulated on the CPU against the JAX package, and
on the card both kernels against their plain versions.

`la_fwd` in bf16 at D = 64 and 128 runs a chunked scan on the tensor
cores, D / 64 blocks per (batch, query head), one per 64 value columns;
`ssd_bwd_kv` in bf16 at (Dk, Dv) = (128, 64) a reverse chunked scan, one
block per (batch, head), its operands that are not bf16 inputs sent as
hi + lo pairs of bf16.  f32 and the other dims keep the token walk
(`ssd_bwd_q`'s chunked body and the gated instances `gla_fwd` and
`gla_bwd_kv` run in bf16 at D = 128 are held by
tests/test_torch_gated_sm90.py).

  * plan tests on meta tensors at N = 8192, 1000, 65 and 1, G = 1 and 4
    (la_fwd at D = 64 and 128):
    the bodies' geometry, shared memory within the H100's 232,448 bytes
    and the blocks per SM each claims, chunks that cover [0, N) exactly,
    each output element written by one block, and the token walk's plans
    as they were;
  * each body's arithmetic, emulated in f32 with the kernel's rounding
    points (la_fwd: the intra-chunk matrix A and the readout's copy of S
    in bf16; ssd_bwd_kv: every operand as its hi + lo bf16 pair), against
    the JAX package's chunked scans at H = 4, N = 300 (a ragged last
    chunk), G = 1 and 2, la_fwd at D = 64 and 128, and for the SSD a
    fresh layer's and the hard
    U[-5, 0] decays, within the limits `chip_smoke.py` holds the kernels
    to: o one bf16 step (2^-7 of its largest |value|), g, the dk partials
    and dv 1e-4;
  * a `gpu`-marked test (skips without a card): both kernels against
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

    from repro.core import chunked as jchunked
    from repro.core import ssd as jssd

    # one compile per shape (a, b and the chunk are static)
    _jax_la_fwd = jax.jit(jchunked.la_fwd_chunked, static_argnums=(3, 4, 5))
    _jax_ssd_bwd = jax.jit(jssd.ssd_bwd_chunked, static_argnums=(6,))
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.kernels import gla as tkgla
from repro_torch.kernels import linear_attention as tkla
from repro_torch.kernels import plan
from repro_torch.kernels import ssd as tkssd
from repro_torch.kernels.defaults import GLA_STAGE_TOKENS, LA_CHUNK_TOKENS, \
    LA_STAGE_TOKENS, SSD_CHUNK_TOKENS, SSD_STAGE_TOKENS

BF16, F32 = torch.bfloat16, torch.float32
D, DK, DV = 128, 128, 64
BF16_REL = 2.0 ** -7
SEQ_F32_REL = 1e-4
SM_SMEM = 233472   # an SM's shared memory; each block also holds 1 KB
# csrc/la_fwd.cu's `lc::Layout<D, false>::kSmem`: two chunks of q, k (64 x
# D) and the block's 64 columns of v (64 x 64) in bf16, the bf16 copy of
# S^T (64 x D), z and P twice in f32, and 2 KB of barriers and alignment
# pad: 101,888 B at D = 128, 60,416 B at 64
LA_SMEM = {d: 2 * (2 * 128 * d + 8192) + 128 * d + 2 * 4 * (d + 64) + 2048
           for d in (64, 128)}
# the blocks an SM holds by that shared memory (each block also takes 1 KB)
LA_BLOCKS_PER_SM = {128: 2, 64: 3}
# csrc/ssd.cu's `sk::kSmem`: the hi and lo bf16 copies of U^T (64 x 128),
# two chunks of q (64 x 128) and Ω (64 x 64), one of k and v, and 2 KB
SSD_SMEM = 2 * 16384 + 2 * (16384 + 8192) + (16384 + 8192) + 2048


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _la_plan(dtype, b, h, hkv, n, d=D):
    q = _meta(b, h, n, d, dtype=dtype)
    kv = _meta(b, hkv, n, d, dtype=dtype)
    return tkla.plan_la_fwd(q, kv, kv, 1.0, 1.0)


def _ssd_plan(dtype, b, g, h, n, dk=DK, dv=DV):
    q = _meta(b, g, n, dk, dtype=dtype)
    v = _meta(b, h, n, dv, dtype=dtype)
    return tkssd.plan_ssd_bwd_kv(q, q, v, _meta(b, h, n, dtype=F32), v)


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


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", [1, 4])
def test_wgmma_plans_geometry_chunks_and_boxes(g, d):
    """la_fwd in bf16 at D = 128: (B H, 2) blocks of one warpgroup,
    101,888 B, two would fit an SM (64 blocks at the timing shape); at
    D = 64: (B H, 1) blocks, 60,416 B, three would fit; the chunk as the
    C call's stage.  ssd_bwd_kv in bf16 at (128, 64): B H blocks of one
    warpgroup, 108,544 B, two to an SM (160 blocks in one wave on 132
    SMs).  Chunks cover [0, N) exactly; each o, g, dk and dv element has
    one writer."""
    b, parts = 2, d // 64
    assert tkla.la_fwd_body(BF16, d) == "wgmma"
    assert tkssd.ssd_body("ssd_bwd_kv", BF16, DK, DV) == "wgmma"
    for n in (8192, 1000, 65, 1):
        p = _la_plan(BF16, b, 16, 16 // g, n, d)
        assert (p.grid, p.threads, p.smem) == ((b * 16, parts, 1), 128,
                                               LA_SMEM[d])
        assert p.smem <= plan.MAX_SMEM and p.grid[0] * p.grid[1] <= 132
        assert SM_SMEM // (p.smem + 1024) == LA_BLOCKS_PER_SM[d]
        assert p.stage == p.args[5] == p.plan_args[5] == LA_CHUNK_TOKENS
        assert len(_spans(n, p.stage)) == -(-n // LA_CHUNK_TOKENS)
        h = 80 if g == 1 else 16
        s = _ssd_plan(BF16, b, g, h, n)
        assert (s.grid, s.threads, s.smem) == ((b * h, 1, 1), 128, SSD_SMEM)
        assert 2 * (s.smem + 1024) <= SM_SMEM and s.smem <= plan.MAX_SMEM
        assert s.stage == s.args[6] == s.plan_args[6] == SSD_CHUNK_TOKENS
        assert len(_spans(n, s.stage)) == -(-n // SSD_CHUNK_TOKENS)
    small_la, small_ssd = _la_plan(BF16, 2, 4, 4 // g, 65, d), \
        _ssd_plan(BF16, 2, g, 8, 65)
    for name in ("o", "g"):
        assert _written_once(small_la, name), name
    v_tiles = {a.name: a for a in small_la.accesses}["v"]
    assert [v_tiles.tile((0, y, 0))[0].ranges[3] for y in range(parts)] == \
        [(0, 64), (64, 128)][:parts]
    for name in ("dk", "dv"):
        assert _written_once(small_ssd, name), name


def test_walk_plans_unchanged():
    """f32 at D = 128, 64 and 32 keep la_fwd's token walk (D + 32 threads,
    32 staged tokens), and so does gla_fwd (its gated walk, one staged
    decay more per token) there and in bf16 at D = 64, where la_fwd runs
    its chunked body; gla_fwd in bf16 at D = 128 runs the gated wgmma body
    (tests/test_torch_gated_sm90.py); f32 and the smoke dims
    keep ssd_bwd_kv's walk (row and column tiles, 32 staged tokens).
    zamba2-7b's shapes: la_fwd's walk at D = 112 has 128 value threads
    (whole warps) and the normalizer warp, gla_fwd refuses 112, and
    ssd_bwd_kv walks (64, 64) with 128 row and 128 column threads."""
    for dtype, d in ((F32, 128), (F32, 64), (BF16, 64), (F32, 32)):
        # bf16 at D = 64: la_fwd's chunked body (the plan test above)
        linear_walks = (dtype, d) != (BF16, 64)
        assert tkla.la_fwd_body(dtype, d) == ("walk" if linear_walks
                                              else "wgmma")
        assert tkla.la_fwd_body(dtype, d, "gla_fwd") == "walk"
        for n in (8192, 1000, 65, 1):
            if linear_walks:
                p = _la_plan(dtype, 2, 16, 4, n, d)
                assert (p.grid, p.threads, p.stage) == ((32, 1, 1), d + 32,
                                                        LA_STAGE_TOKENS)
                assert p.smem == LA_STAGE_TOKENS * (3 * (d + 16) + d + 1) * 4
            q = _meta(2, 16, n, d, dtype=dtype)
            kv = _meta(2, 4, n, d, dtype=dtype)
            gp = tkgla.plan_gla_fwd(q, kv, kv, _meta(2, 4, n, dtype=F32),
                                    1.0, 1.0)
            assert (gp.grid, gp.threads, gp.stage) == ((32, 1, 1), d + 32,
                                                       GLA_STAGE_TOKENS)
            assert gp.smem == GLA_STAGE_TOKENS * (3 * (d + 16) + d + 2) * 4
    for dtype in (F32, BF16):
        assert tkla.la_fwd_body(dtype, 112) == "walk"
        for n in (8192, 1000, 1):
            p = _la_plan(dtype, 2, 32, 8, n, 112)
            assert (p.grid, p.threads, p.stage) == ((64, 1, 1), 160,
                                                    LA_STAGE_TOKENS)
            assert p.smem == LA_STAGE_TOKENS * (3 * 128 + 113) * 4
            q, kv = _meta(2, 32, n, 112, dtype=dtype), _meta(2, 8, n, 112,
                                                             dtype=dtype)
            with pytest.raises(ValueError, match="head dim 112"):
                tkgla.plan_gla_fwd(q, kv, kv, _meta(2, 8, n, dtype=F32),
                                   1.0, 1.0)
    assert tkla.la_fwd_body(BF16, D, "gla_fwd") == "wgmma"
    for dtype, dk, dv, smem in ((F32, 128, 64, 32 * 2692),
                                (BF16, 16, 32, 32 * 964),
                                (F32, 16, 32, 32 * 964),
                                (BF16, 64, 64, 32 * 2052),
                                (F32, 64, 64, 32 * 2052)):
        assert tkssd.ssd_body("ssd_bwd_kv", dtype, dk, dv) == "walk"
        for n in (8192, 1000, 65, 1):
            p = _ssd_plan(dtype, 2, 4, 16, n, dk, dv)
            assert (p.grid, p.threads, p.smem, p.stage) == (
                (32, 1, 1), 64 if dk == 16 else 256, smem,
                SSD_STAGE_TOKENS), (dtype, dk, n)


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


def _emulate_la_fwd(q, k, v, a, b, chunk=LA_CHUNK_TOKENS):
    """la_fwd's wgmma body in f32: per chunk, g = a (t + 1) + b (rowsum of
    the masked f32 scores + q . z), A = bf16(a + b q k^T on j <= i), f =
    b q bf16(S) + a P + A v, o = f / g (0 where |g| < 1e-30); then S +=
    k^T v, P += sum v, z += sum k.  o in bf16, g f32."""
    bsz, h, n, d = q.shape
    grp = torch.arange(h) // (h // k.shape[1])
    n_pad = -(-n // chunk) * chunk
    qf = _pad(q.float(), n_pad)
    kf, vf = _pad(k.float()[:, grp], n_pad), _pad(v.float()[:, grp], n_pad)
    s_st = torch.zeros(bsz, h, d, d)
    p_st, z_st = torch.zeros(bsz, h, d), torch.zeros(bsz, h, d)
    mask = torch.ones(chunk, chunk, dtype=torch.bool).tril()
    o, g = torch.empty(bsz, h, n_pad, d), torch.empty(bsz, h, n_pad)
    for t0 in range(0, n_pad, chunk):
        qc, kc, vc = (x[:, :, t0:t0 + chunk] for x in (qf, kf, vf))
        sc = torch.where(mask, qc @ kc.transpose(-1, -2), torch.zeros(()))
        cnt = torch.arange(t0 + 1, t0 + chunk + 1, dtype=F32)
        gc = a * cnt + b * (sc.sum(-1) + (qc @ z_st[..., None])[..., 0])
        amat = _bf(torch.where(mask, a + b * sc, torch.zeros(())))
        f = b * (qc @ _bf(s_st)) + a * p_st[:, :, None] + amat @ vc
        safe = gc.abs() >= 1e-30
        o[:, :, t0:t0 + chunk] = torch.where(
            safe[..., None], f / torch.where(safe, gc, torch.ones(()))[
                ..., None], torch.zeros(()))
        g[:, :, t0:t0 + chunk] = gc
        s_st = s_st + kc.transpose(-1, -2) @ vc
        p_st, z_st = p_st + vc.sum(2), z_st + kc.sum(2)
    return o[:, :, :n].to(BF16), g[:, :, :n]


def _emulate_ssd_bwd_kv(q, k, v, log_decay, omega, chunk=SSD_CHUNK_TOKENS):
    """ssd_bwd_kv's wgmma body in f32, chunks from the last: p = v Ω^T, s
    = k q^T, M = exp(cl_i - cl_n) on i >= n, e = exp(total - cl);
    dk = e (v U^T) + (p o M) q, dv = e (k U) + (s o M) Ω, U^T = exp(total)
    U^T + (exp(cl) o Ω)^T q, with p o M, s o M, exp(cl) o Ω and the copy
    of U^T each taken as its hi + lo bf16 pair.  Per-head dk partials and
    dv, f32."""
    bsz, g, n, dk = q.shape
    h, dv = v.shape[1], v.shape[3]
    grp = torch.arange(h) // (h // g)
    n_pad = -(-n // chunk) * chunk
    qf, kf = _pad(q.float()[:, grp], n_pad), _pad(k.float()[:, grp], n_pad)
    vf, omf = _pad(v.float(), n_pad), _pad(omega.float(), n_pad)
    ld = _pad(log_decay.float(), n_pad)
    upper = torch.ones(chunk, chunk, dtype=torch.bool).triu()
    ut = torch.zeros(bsz, h, dv, dk)
    dk_o, dv_o = torch.empty(bsz, h, n_pad, dk), torch.empty(bsz, h, n_pad, dv)

    def pair_mm(x, y):
        hi, lo = _split(x)
        return hi @ y + lo @ y

    for t0 in reversed(range(0, n_pad, chunk)):
        sl = slice(t0, t0 + chunk)
        qc, kc, vc, omc = qf[:, :, sl], kf[:, :, sl], vf[:, :, sl], \
            omf[:, :, sl]
        cl = torch.cumsum(ld[:, :, sl], -1)
        total = cl[..., -1:]
        diff = cl[..., None, :] - cl[..., :, None]      # [n, i] = cl_i - cl_n
        m = torch.where(upper, torch.exp(torch.where(upper, diff,
                                                     torch.zeros(()))),
                        torch.zeros(()))
        e_n = torch.exp(total - cl)[..., None]
        u_hi, u_lo = _split(ut)
        dk_o[:, :, sl] = e_n * (vc @ u_hi + vc @ u_lo) + pair_mm(
            (vc @ omc.transpose(-1, -2)) * m, qc)
        dv_o[:, :, sl] = e_n * (kc @ u_hi.transpose(-1, -2)
                                + kc @ u_lo.transpose(-1, -2)) + pair_mm(
            (kc @ qc.transpose(-1, -2)) * m, omc)
        ut = torch.exp(total)[..., None] * ut + pair_mm(
            (torch.exp(cl)[..., None] * omc).transpose(-1, -2), qc)
    return dk_o[:, :, :n], dv_o[:, :, :n]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _la_inputs(rng, b, h, hkv, n, d=D):
    """Unit q and k rows (as the model hands them over after l2
    normalization) and normal v of d columns, bf16."""
    def unit(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return torch.from_numpy(x / np.linalg.norm(x, axis=-1,
                                                   keepdims=True)).to(BF16)
    return unit(b, h, n, d), unit(b, hkv, n, d), torch.from_numpy(
        rng.standard_normal((b, hkv, n, d)).astype(np.float32)).to(BF16)


def _ssd_inputs(rng, b, g, h, n, regime):
    def bf16(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(BF16)

    if regime == "init":
        ld = -np.log1p(np.exp(rng.standard_normal((b, h, n))))
    else:
        ld = -5.0 * rng.random((b, h, n))
    return (bf16(b, g, n, DK, scale=0.5), bf16(b, g, n, DK, scale=0.5),
            bf16(b, h, n, DV), torch.from_numpy(ld.astype(np.float32)),
            bf16(b, h, n, DV))


def _np(x):
    return jnp.asarray(x.float().numpy())


@pytest.mark.parametrize("d", [64, 128])
def test_emulated_la_fwd_matches_jax_reference(d):
    """la_fwd's rounding points keep o within one bf16 step and g within
    1e-4 of the JAX package's chunked scan, at D = 64 and 128, G = 1 and
    2 with a ragged last chunk (N = 300)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(20)
    for hkv in (4, 2):
        q, k, v = _la_inputs(rng, 2, 4, hkv, 300, d)
        o, g = _emulate_la_fwd(q, k, v, 1.0, 1.0)
        want_o, want_g, _ = _jax_la_fwd(_np(q), _np(k), _np(v), 1.0, 1.0,
                                        128)
        assert np.isfinite(o.float().numpy()).all()
        assert _rel(o.float(), want_o) <= BF16_REL, (d, hkv)
        assert _rel(g, want_g) <= SEQ_F32_REL, (d, hkv)


def test_emulated_ssd_bwd_kv_matches_jax_reference():
    """ssd_bwd_kv's hi + lo operands keep the dk partials (summed over the
    group) and dv within 1e-4 of the JAX package's chunked SSD backward,
    under a fresh layer's decays and the hard U[-5, 0], at G = 1 and 2
    with a ragged last chunk (N = 300)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(21)
    b, h, n = 2, 4, 300
    for g, regime in ((1, "init"), (2, "strong")):
        q, k, v, ld, om = _ssd_inputs(rng, b, g, h, n, regime)
        dk_p, dv = _emulate_ssd_bwd_kv(q, k, v, ld, om)
        _, want_dk, want_dv, _ = _jax_ssd_bwd(
            _np(q), _np(k), _np(v), jnp.asarray(ld.numpy()),
            jnp.zeros(v.shape, jnp.float32), _np(om), 128)
        dk = dk_p.reshape(b, g, h // g, n, DK).sum(2)
        assert np.isfinite(dk.numpy()).all() and np.isfinite(dv.numpy()).all()
        assert _rel(dk, want_dk) <= SEQ_F32_REL, (g, regime)
        assert _rel(dv, want_dv) <= SEQ_F32_REL, (g, regime)


@pytest.mark.gpu
def test_cuda_chunked_bodies_match_plain():
    """la_fwd (bf16, D = 128 and 64) and ssd_bwd_kv (bf16, (128, 64))
    against their plain versions at ragged N (1, 65, 300, 1000) with G =
    1, 2 and 4: o within one bf16 step, g, the dk partials and dv within
    1e-4; a second launch gives bit-equal outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    for hkv, n, d in ((4, 300, 128), (2, 65, 128), (4, 1, 128),
                      (4, 300, 64), (1, 1000, 64), (2, 1, 64)):
        q, k, v = (x.to(dev) for x in _la_inputs(rng, 2, 4, hkv, n, d))
        o, g = tkla.la_fwd_cuda(q, k, v, 1.0, 1.0)
        o2, g2 = tkla.la_fwd_cuda(q, k, v, 1.0, 1.0)
        torch.cuda.synchronize()
        want_o, want_g = tkla.la_fwd_torch(q, k, v, 1.0, 1.0)
        assert torch.equal(o, o2) and torch.equal(g, g2)
        assert _rel(o.float().cpu(), want_o.float().cpu()) <= BF16_REL, d
        assert _rel(g.cpu(), want_g.cpu()) <= SEQ_F32_REL, d
    for g_, h, n, regime in ((1, 8, 300, "init"), (2, 4, 65, "strong"),
                             (1, 4, 1, "init")):
        q, k, v, ld, om = (x.to(dev) for x in _ssd_inputs(rng, 2, g_, h, n,
                                                           regime))
        dk_p, dv = tkssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
        dk2, dv2 = tkssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
        torch.cuda.synchronize()
        want_dk, want_dv = tkssd.ssd_bwd_kv_torch(q, k, v, ld, om)
        assert torch.equal(dk_p, dk2) and torch.equal(dv, dv2)
        assert _rel(dk_p.cpu(), want_dk.cpu()) <= SEQ_F32_REL
        assert _rel(dv.cpu(), want_dv.cpu()) <= SEQ_F32_REL
