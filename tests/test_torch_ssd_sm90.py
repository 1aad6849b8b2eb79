"""The launch plans of `ssd_fwd`'s chunked wgmma body, its arithmetic
emulated on the CPU against the JAX package, and on the card the bf16
kernel against its plain version.

`ssd_fwd` in bf16 at (Dk, Dv) = (128, 64) runs the wgmma body: one
warpgroup per (batch, head) walking chunks of 64 tokens, four tensor-core
products per chunk, the state an f32 accumulator; f32 at every shape and
bf16 at (16, 32) keep the token walk, as do both backward kernels.

  * plan tests on meta tensors at N = 8192, 1000, 65 and 1, G = 1 and 4:
    the body's geometry, shared memory within the H100's 232,448 bytes,
    chunks that cover [0, N) exactly, and the token walk's plans as they
    were;
  * the body's arithmetic, emulated in f32 with A, w v and the readout's
    copy of S rounded to bf16 where the kernel rounds them, against the
    JAX package's chunked SSD (its xla path, the Pallas kernel's plain
    reference) at H = 4, N = 300, G = 1 and 2, within 2^-7 of the
    reference's largest |o| (one bf16 step, the limit `chip_smoke.py`
    holds the kernel to); at log_decay = 0 against unnormalized causal
    linear attention;
  * a `gpu`-marked test (skips without a card): the kernel against
    `ssd_fwd_torch` at small ragged shapes, within the same limit, and
    twice for bit-equal o.

The machine with the card has no JAX; there the gpu test runs alone
(`--noconftest -m gpu`).
"""
import numpy as np
import pytest
import torch

try:
    import jax.numpy as jnp

    from repro.core import ssd as jssd
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.kernels import plan
from repro_torch.kernels import ssd as tkssd
from repro_torch.kernels.defaults import SSD_CHUNK_TOKENS, SSD_STAGE_TOKENS

BF16, F32 = torch.bfloat16, torch.float32
DK, DV = 128, 64
BF16_REL = 2.0 ** -7
# csrc/ssd.cu's `sc::kSmem`: two chunks of q, k (64 x 128) and v (64 x 64)
# in bf16, the (w v) tile, the bf16 copy of S^T and 2 KB of barriers and
# alignment pad
WGMMA_SMEM = 2 * (2 * 16384 + 8192) + 8192 + 16384 + 2048


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _fwd_plan(dtype, b, g, h, n, dk=DK, dv=DV):
    q = _meta(b, g, n, dk, dtype=dtype)
    return tkssd.plan_ssd_fwd(q, q, _meta(b, h, n, dv, dtype=dtype),
                              _meta(b, h, n, dtype=F32))


@pytest.mark.parametrize("g", [1, 4])
def test_wgmma_plan_geometry_and_chunks(g):
    """bf16 at (128, 64): one warpgroup per (batch, head), 108,544 B of
    shared memory (two blocks to an SM), the chunk as the C call's stage;
    its chunks cover [0, N) exactly; the backward entries keep the walk."""
    b, h = 2, 16 if g == 4 else 80
    for n in (8192, 1000, 65, 1):
        p = _fwd_plan(BF16, b, g, h, n)
        assert tkssd.ssd_body("ssd_fwd", BF16, DK, DV) == "wgmma"
        assert (p.grid, p.threads, p.smem) == ((b * h, 1, 1), 128,
                                               WGMMA_SMEM)
        assert 2 * (p.smem + 1024) <= 233472 and p.smem <= plan.MAX_SMEM
        assert p.stage == SSD_CHUNK_TOKENS == 64
        assert p.args[6] == p.plan_args[6] == SSD_CHUNK_TOKENS
        starts = range(0, n, p.stage)
        spans = [(t0, min(t0 + p.stage, n)) for t0 in starts]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b_[0] for a, b_ in zip(spans, spans[1:]))
        assert len(spans) == -(-n // SSD_CHUNK_TOKENS)
    for entry in ("ssd_bwd_q", "ssd_bwd_kv"):
        assert tkssd.ssd_body(entry, BF16, DK, DV) == "walk"


def test_walk_plans_unchanged():
    """f32 at both dims and bf16 at (16, 32) keep the token walk's plans:
    column tiles of 128 (or 32) threads, 32 staged tokens of padded f32
    rows."""
    for dtype, dk, dv, threads, smem in ((F32, 128, 64, 128, 32 * 1860),
                                         (BF16, 16, 32, 32, 32 * 644),
                                         (F32, 16, 32, 32, 32 * 644)):
        assert tkssd.ssd_body("ssd_fwd", dtype, dk, dv) == "walk"
        for n in (8192, 1000, 65, 1):
            p = _fwd_plan(dtype, 2, 4, 16, n, dk, dv)
            assert (p.grid, p.threads, p.smem, p.stage) == (
                (32, 1, 1), threads, smem, SSD_STAGE_TOKENS), (dtype, dk, n)
            assert p.args[6] == SSD_STAGE_TOKENS


def test_wgmma_plan_boxes_cover_heads():
    """Each block reads its group's q and k rows and its head's v and log
    decays over [0, N), and writes its head's o rows: every (batch, head,
    token) of o exactly once (TMA zero-fills the last chunk's rows past
    N, so no box reaches past it)."""
    for g, h, n in ((1, 8, 65), (4, 8, 1000), (2, 4, 1)):
        p = _fwd_plan(BF16, 2, g, h, n)
        acc = {a.name: a for a in p.accesses}
        seen = np.zeros((2, h), int)
        for blk in p.blocks():
            bi, hi = divmod(blk[0], h)
            (o_t,), (q_t,) = acc["o"].tile(blk), acc["q"].tile(blk)
            assert o_t.ranges == ((bi, bi + 1), (hi, hi + 1), (0, n),
                                  (0, DV))
            assert q_t.ranges[1] == (hi // (h // g), hi // (h // g) + 1)
            assert acc["k"].tile(blk)[0].ranges == q_t.ranges
            seen[bi, hi] += 1
        assert (seen == 1).all()


def _emulate_wgmma_body(q, k, v, log_decay, chunk=SSD_CHUNK_TOKENS):
    """The wgmma body's arithmetic in f32 on the CPU: per chunk of `chunk`
    tokens, with cl the inclusive cumsum of its log decays and S^T the
    f32 state, o = exp(cl_i) q S + A v with A = bf16((q k^T) o
    exp(cl_i - cl_j), j <= i) and S read from its bf16 copy, then S^T =
    exp(cl_last) S^T + bf16(w v)^T k, w = exp(cl_last - cl); o in bf16."""
    def bf(x):
        return x.to(BF16).float()

    bsz, g, n, dk = q.shape
    h, dv = v.shape[1], v.shape[3]
    grp = torch.arange(h) // (h // g)
    qh, kh, vf = q.float()[:, grp], k.float()[:, grp], v.float()
    o = torch.empty(bsz, h, n, dv)
    st = torch.zeros(bsz, h, dv, dk)
    for t0 in range(0, n, chunk):
        t1 = min(t0 + chunk, n)
        qc, kc, vc = qh[:, :, t0:t1], kh[:, :, t0:t1], vf[:, :, t0:t1]
        cl = torch.cumsum(log_decay[:, :, t0:t1].float(), -1)
        total = cl[..., -1:]
        mask = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool).tril()
        diff = torch.where(mask, cl[..., :, None] - cl[..., None, :],
                           torch.zeros(()))
        a = bf(torch.where(mask, (qc @ kc.transpose(-1, -2))
                           * torch.exp(diff), torch.zeros(())))
        acc = torch.exp(cl)[..., None] * (qc @ bf(st).transpose(-1, -2))
        o[:, :, t0:t1] = acc + a @ vc
        wv = bf(torch.exp(total - cl)[..., None] * vc)
        st = torch.exp(total)[..., None] * st + wv.transpose(-1, -2) @ kc
    return o.to(BF16)


def _ssd_inputs(rng, b, g, h, n, regime):
    def bf16(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).to(BF16)

    if regime == "init":
        ld = -np.log1p(np.exp(rng.standard_normal((b, h, n))))
    elif regime == "strong":
        ld = -5.0 * rng.random((b, h, n))
    else:
        ld = np.zeros((b, h, n))
    return (bf16(b, g, n, DK, scale=0.5), bf16(b, g, n, DK, scale=0.5),
            bf16(b, h, n, DV), torch.from_numpy(ld.astype(np.float32)))


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def test_emulated_body_matches_jax_reference():
    """The body's rounding points keep o within one bf16 step of the JAX
    package's chunked SSD, under a fresh layer's decays and the hard
    U[-5, 0], at G = 1 and 2, with a ragged last chunk (N = 300); at
    log_decay = 0 it is unnormalized causal linear attention."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(19)
    b, h, n = 2, 4, 300
    for g, regime in ((1, "init"), (2, "strong"), (2, "zero")):
        q, k, v, ld = _ssd_inputs(rng, b, g, h, n, regime)
        got = _emulate_wgmma_body(q, k, v, ld).float().numpy()
        arrs = [jnp.asarray(x.float().numpy()) for x in (q, k, v)]
        want, _ = jssd.ssd_fwd_chunked(
            *(a.astype(jnp.bfloat16) for a in arrs), jnp.asarray(ld.numpy()))
        want = np.asarray(want.astype(jnp.float32))
        assert np.isfinite(got).all()
        assert _rel(got, want) <= BF16_REL, (g, regime)
        if regime == "zero":
            qf, kf, vf = (x.float() for x in (q, k, v))
            grp = torch.arange(h) // (h // g)
            scores = (qf[:, grp] @ kf[:, grp].transpose(-1, -2)).tril()
            assert _rel(got, (scores @ vf).numpy()) <= BF16_REL


@pytest.mark.gpu
def test_cuda_wgmma_ssd_fwd_matches_plain():
    """The bf16 (128, 64) kernel (the wgmma body) against ssd_fwd_torch at
    ragged N (1, 65, 300) with G = 1 and 2, within one bf16 step of the
    plain version's largest |o|; a second launch gives bit-equal o."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(20)
    for g, h, n, regime in ((1, 8, 300, "init"), (2, 4, 65, "strong"),
                            (1, 4, 1, "init")):
        q, k, v, ld = (x.to(dev) for x in _ssd_inputs(rng, 2, g, h, n,
                                                      regime))
        o = tkssd.ssd_fwd_cuda(q, k, v, ld)
        again = tkssd.ssd_fwd_cuda(q, k, v, ld)
        torch.cuda.synchronize()
        want = tkssd.ssd_fwd_torch(q, k, v, ld)
        assert o.dtype == BF16 and torch.equal(o, again)
        assert _rel(o.float().cpu(), want.float().cpu()) <= BF16_REL
