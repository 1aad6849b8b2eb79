"""The chunked wgmma body of `ssd_bwd_q`: its launch plan, its
arithmetic emulated on the CPU against the JAX package, and on the card
the kernel against its plain version.

`ssd_bwd_q` in bf16 at (Dk, Dv) = (128, 64) runs `ssd_fwd`'s forward
chunked scan with the readout dq = S Ω, one block per (batch, head), its
operands that are not bf16 inputs sent as hi + lo pairs of bf16.  f32 and
the other dims keep the token walk.

  * plan tests on meta tensors at N = 8192, 1000, 65 and 1, G = 1 and 4:
    the body's geometry, shared memory within the H100's 232,448 bytes
    and two blocks per SM, chunks that cover [0, N) exactly, each dq
    element written by one block, and the walk's plans as they were;
  * the body's arithmetic, emulated in f32 at the kernel's rounding
    points, against the JAX package at H = 4, N = 300 (a ragged last
    chunk), G = 1 and 2, under a fresh layer's and the strong U[-5, 0]
    decays: the group sum of the dq partials within 1e-4 of its largest
    |value|, the limit `chip_smoke.py` holds the kernel to;
  * a `gpu`-marked test (skips without a card): the kernel against its
    plain version at small ragged shapes, and twice for bit-equal
    outputs.

The machine with the card has no JAX; there the gpu test runs alone
(`--noconftest -m gpu`).
"""
import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from repro.core import ssd as jssd

    # one compile per shape (the chunk is static)
    _jax_ssd_bwd = jax.jit(jssd.ssd_bwd_chunked, static_argnums=(6,))
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.kernels import plan
from repro_torch.kernels import ssd as tkssd
from repro_torch.kernels.defaults import SSD_CHUNK_TOKENS, SSD_STAGE_TOKENS

BF16, F32 = torch.bfloat16, torch.float32
DK, DV = 128, 64
SEQ_F32_REL = 1e-4
SM_SMEM = 233472   # an SM's shared memory; each block also holds 1 KB
LOG2E = 1.4426950408889634
# csrc/ssd.cu's `sq::kSmem`: the hi and lo bf16 copies of S^T (64 x 128),
# two chunks of k (64 x 128), one of v and Ω (64 x 64), the hi and lo
# (w v) tiles, and 2 KB
SSD_SMEM = 2 * 16384 + 2 * 16384 + 2 * 8192 + 2 * 8192 + 2048


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


@pytest.mark.gpu
def test_cuda_ssd_bwd_q_matches_plain():
    """ssd_bwd_q (bf16, (128, 64)) against its plain version at ragged N
    (1, 65, 300) with G = 1 and 2, under both decay regimes: the dq
    partials within 1e-4; a second launch gives bit-equal partials."""
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
