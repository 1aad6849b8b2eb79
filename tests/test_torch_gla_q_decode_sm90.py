"""The gated chunked wgmma body of `gla_bwd_q` and the state stream of
`gla_decode_fused` and `la_decode_fused`: their launch plans, their
arithmetic emulated on the CPU against the JAX package, and on the card
the kernels against their plain versions.

`gla_bwd_q` in bf16 at D = 128 runs the gated instance of `la_bwd_q`'s
chunked body (csrc/la_bwd.cu, namespace `bq`): two blocks per (batch,
query head), one per half of dq's columns; per chunk of 64 tokens, with
cl the chunk's cumsum of log decays (base 2), P = (Ω̂ v^T - h) o
2^(cl_i - cl_j) on j <= i, dq = b (2^cl_i (Ω̂ A^T - h z^T) + P k), then A
= 2^total A + k^T (w o v) and z likewise, w_j = 2^(total - cl_j).  Ω̂, A's
copy, P and w o v go as hi + lo pairs of bf16.  f32 and D < 128 keep the
token walk.

`gla_decode_fused` and `la_decode_fused` stream each (slot, KV head)'s
f32 state slab through a ring of 16-row chunks in shared memory
(csrc/la_decode_fused.cu, namespace `ds`, the linear instance with γ = 1
and no log decay), 4 (Dv+1) threads each updating every fourth row of
one column exactly as the column walk does, keeping its row class's
partial dots q . S_new and adding the four classes' in a fixed order.

  * plan tests on meta tensors: `gla_bwd_q`'s wgmma geometry at G = 1 and
    4, N = 8192, 1000, 65 and 1, chunks that cover [0, N), one writer per
    dq element; the stream's geometry (both entries) at G = 1 and 4 with
    one writer per S, P and o element, and the column walk at odd Dk;
  * the dq body's arithmetic emulated in f32 at its rounding points
    against the JAX package's chunked GLA backward at N = 1000 (a ragged
    last chunk), G = 1 and 4, under a fresh layer's gate and the strong
    U[-5, 0] decays, within one bf16 step (2^-7 of the largest |value|),
    the limit `chip_smoke.py` holds the kernel to;
  * the stream's chunked update and fixed-order reduction emulated
    against the JAX package's fused decode steps (impl "xla"; gated, and
    linear with γ = 1) at D = 128, G = 1 and 4, with a slot whose
    normalizer is exactly zero: o within
    one bf16 step, S and P within 1e-5, and the new state equal, bit for
    bit, to the plain elementwise update (bf16 inputs make k_i v_j exact
    in f32, so the kernel's fmaf and the plain multiply-then-add round
    once alike);
  * a `gpu`-marked test (skips without a card): the three kernels
    against their plain versions, and twice for bit-equal outputs.

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
    from repro.core import gla as jgla
    from repro.kernels import ops as jops

    # one compile per shape (a, b and the chunk are static)
    _jax_gla_fwd = jax.jit(jgla.gla_fwd_chunked, static_argnums=(4, 5, 6))
    _jax_gla_bwd = jax.jit(jgla.gla_bwd_chunked, static_argnums=(7, 8, 9))
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.core import chunked as tchunked
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels import gla as tkgla
from repro_torch.kernels import linear_attention as tkla
from repro_torch.kernels import plan
from repro_torch.kernels.defaults import GLA_DECODE_RING, \
    GLA_DECODE_ROW_CLASSES, GLA_DECODE_ROWS, LA_CHUNK_TOKENS

BF16, F32 = torch.bfloat16, torch.float32
D = 128
C = LA_CHUNK_TOKENS
BF16_REL = 2.0 ** -7
F32_REL = 1e-5
LOG2E = 1.4426950408889634
SM_SMEM = 233472   # an SM's shared memory; each block also holds 1 KB
# csrc/la_bwd.cu's `bq::Layout<true>::kSmem`: la_bwd_q's 183,040 B (two
# chunks of k's half, v and the f32 Ω̂; Ω̂'s and A's hi and lo tiles; z
# twice, h, 2 KB) and the hi and lo (w o v) tiles (64 x 128 bf16 each)
GLA_Q_SMEM = 2 * (8192 + 16384 + 32768) + 4 * 16384 + 512 + 256 + 2048 \
    + 2 * 16384


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _written_once(launch, name):
    """Every element of operand `name` lies in exactly one block's tile."""
    acc = {a.name: a for a in launch.accesses}[name]
    seen = np.zeros(acc.shape, int)
    for blk in launch.blocks():
        for t in acc.tile(blk):
            seen[tuple(slice(lo, hi) for lo, hi in t.ranges)] += 1
    return bool((seen == 1).all())


def _q_plan(dtype, b, h, hkv, n, d=D):
    kv = _meta(b, hkv, n, d, dtype=dtype)
    return tkgla.plan_gla_bwd_q(kv, kv, _meta(b, hkv, n, dtype=F32),
                                _meta(b, h, n, d, dtype=F32),
                                _meta(b, h, n, dtype=F32), 1.0)


@pytest.mark.parametrize("g", [1, 4])
def test_gla_bwd_q_wgmma_plan(g):
    """gla_bwd_q in bf16 at D = 128: (B H, 2) blocks of one warpgroup,
    215,808 B (one block an SM), the chunk as the C call's stage.  Chunks
    cover [0, N) exactly; each dq element has one writer, by column
    halves."""
    b, h, hkv = 2, 16, 16 // g
    assert tkla.la_bwd_body("gla_bwd_q", BF16, D) == "wgmma"
    assert GLA_Q_SMEM == 215808
    for n in (8192, 1000, 65, 1):
        p = _q_plan(BF16, b, h, hkv, n)
        assert (p.grid, p.threads, p.smem) == ((b * h, 2, 1), 128,
                                               GLA_Q_SMEM)
        assert p.smem <= plan.MAX_SMEM < 2 * (p.smem + 1024)
        assert p.smem + 1024 <= SM_SMEM
        assert p.stage == p.args[5] == p.plan_args[5] == C
        spans = [(t0, min(t0 + C, n)) for t0 in range(0, n, p.stage)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
    small = _q_plan(BF16, 2, 4, 4 // g, 65)
    assert _written_once(small, "dq")
    dq = {a.name: a for a in small.accesses}["dq"]
    assert [dq.tile((0, y, 0))[0].ranges[2:] for y in range(2)] == \
        [((0, 65), (0, 64)), ((0, 65), (64, 128))]


def _decode_plans(b, h, hkv, dk=D, dv=D):
    state = (_meta(b, hkv, dk, dv + 1, dtype=F32),
             _meta(b, hkv, dv + 1, dtype=F32))
    step = (_meta(b, h, dk), _meta(b, hkv, dk), _meta(b, hkv, dv))
    return (tdf.plan_gla_decode_fused(*state, *step,
                                      _meta(b, hkv, dtype=F32), 1.0, 1.0),
            tdf.plan_la_decode_fused(*state, *step, 1.0, 1.0))


def test_gla_decode_stream_plan():
    """gla_decode_fused and la_decode_fused at D = 128 stream: one block
    per (slot, KV head) of 4 x 129 threads rounded up to 17 warps, the
    ring of 5 chunks of 16 rows (8,256 B each) beside k, [v, 1], the G
    query rows and f, and an mbarrier a stage, within the launcher's 48 KB
    (43,376 B at G = 1, 46,464 B at G = 4; three stages at G = 16).  Each
    S, P and o element has one writer.  Odd Dk and wide Dv keep the column
    walk, for both entries.  A group of 48 (granite-20b) streams in
    blocks of at most 576 threads past 48 KB, and Dk = Dv = 112 (zamba2-7b)
    streams within it."""
    assert tdf.recurrent_decode_body(D, D) == "stream"
    assert tdf.recurrent_decode_body(30, 32) == \
        tdf.recurrent_decode_body(128, 256) == "walk"
    chunk = GLA_DECODE_ROWS * (D + 1) * 4
    assert (chunk, GLA_DECODE_RING, GLA_DECODE_ROW_CLASSES) == (8256, 5, 4)
    for g, smem in ((1, 43376), (4, 46464)):
        b, h, hkv = 8, 16, 16 // g
        rows = (D + (D + 1) + g * D + g * (D + 1)) * 4
        # the mbarriers 8-byte aligned after the f32 rows
        assert smem == -(-(GLA_DECODE_RING * chunk + rows) // 8) * 8 \
            + 8 * GLA_DECODE_RING
        for p in _decode_plans(b, h, hkv):
            assert (p.grid, p.threads, p.smem) == ((b * hkv, 1, 1), 544,
                                                   smem)
            assert p.smem <= tdf.RECURRENT_MAX_SMEM == p.smem_limit
        for p in _decode_plans(3, 4 * g, 4):
            for name in ("s", "p", "o"):
                assert _written_once(p, name), (p.name, g, name)
    for p in _decode_plans(8, 16, 1):
        assert p.smem == -(-(3 * chunk + (D + 129 + 16 * (D + 129)) * 4)
                           // 8) * 8 + 8 * 3
        assert p.smem <= tdf.RECURRENT_MAX_SMEM
    for p in _decode_plans(2, 4, 2, dk=30, dv=32):
        assert (p.threads, p.smem) == (64, (30 + 33 + 2 * (30 + 33)) * 4)
    # granite-20b's 48 query heads on one KV head: blocks of at most 576
    # threads (544 at Dv = 128), and the 48 query rows, rows f and the
    # classes' partial dots past 48 KB, within the card's opt-in maximum;
    # zamba2-7b's D = 112: 4 x 113 threads rounded up to 15 warps
    assert tdf.recurrent_decode_body(D, D, 48) == "stream"
    assert tdf.recurrent_decode_body(D, 160, 48) == "walk"
    parts = 3 * 48 * 129 * 4
    for p in _decode_plans(4, 48, 1):
        assert (p.grid, p.threads) == ((4, 1, 1), 544)
        assert p.smem == -(-(parts + (D + 129 + 48 * (D + 129)) * 4)
                           // 8) * 8 + 8 * GLA_DECODE_RING
        assert tdf.RECURRENT_MAX_SMEM < p.smem <= plan.MAX_SMEM \
            == p.smem_limit
        for name in ("s", "p", "o"):
            assert _written_once(p, name), (p.name, name)
    for p in _decode_plans(4, 32, 32, dk=112, dv=112):
        assert (p.grid, p.threads) == ((128, 1, 1), 480)
        assert p.smem <= tdf.RECURRENT_MAX_SMEM == p.smem_limit


# ---------------------------------------------------------------------------
# the bodies' arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def _bf(x):
    return x.to(BF16).float()


def _split(x):
    """x as its hi + lo bf16 pair (sm90::pack_bf16_split), each in f32."""
    hi = _bf(x)
    return hi, _bf(x - hi)


def _pad(x, n_pad):
    shape = list(x.shape)
    shape[2] = n_pad - shape[2]
    return torch.cat([x, torch.zeros(shape, dtype=x.dtype)], 2)


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _emulate_gla_bwd_q(k, v, log_decay, om, h_vec, b):
    """gla_bwd_q's gated wgmma body in f32, chunks in order, with cl the
    chunk's cumsum of the KV head's log decays (base 2): P = (Ω̂ v^T - h)
    o 2^(cl_i - cl_j) on j <= i; dq = b (2^cl_i (Ω̂ A^T - h z^T) + P k);
    A = 2^total A + k^T (w o v), z = 2^total z + Σ w k, w_j = 2^(total -
    cl_j).  Ω̂ (a pair times v; with A's pair, hi hi + lo hi + hi lo), P
    and w o v go as hi + lo pairs.  dq in bf16."""
    bsz, h, n, d = om.shape
    grp = torch.arange(h) // (h // k.shape[1])
    n_pad = -(-n // C) * C
    kf, vf = _pad(k.float()[:, grp], n_pad), _pad(v.float()[:, grp], n_pad)
    omf, hf = _pad(om, n_pad), _pad(h_vec[..., None], n_pad)
    l2 = _pad(log_decay.float()[:, grp] * LOG2E, n_pad)
    av, z = torch.zeros(bsz, h, d, d), torch.zeros(bsz, h, 1, d)
    lower = torch.ones(C, C, dtype=torch.bool).tril()
    dq = torch.empty(bsz, h, n_pad, d)
    for t0 in range(0, n_pad, C):
        sl = slice(t0, t0 + C)
        kc, vc, oc, hc = kf[:, :, sl], vf[:, :, sl], omf[:, :, sl], \
            hf[:, :, sl]
        cl = torch.cumsum(l2[:, :, sl], -1)
        total = cl[..., -1:, None]
        diff = torch.where(lower, cl[..., :, None] - cl[..., None, :],
                           torch.zeros(()))
        decay = torch.where(lower, torch.exp2(diff), torch.zeros(()))
        oh, ol = _split(oc)
        p = ((oh + ol) @ vc.transpose(-1, -2) - hc) * decay
        ah, al = _split(av.transpose(-1, -2))
        r = oh @ ah + ol @ ah + oh @ al
        dq[:, :, sl] = b * (torch.exp2(cl)[..., None] * (r - hc * z)
                            + sum(x @ kc for x in _split(p)))
        w = torch.exp2(total - cl[..., None])
        av = torch.exp2(total) * av + sum(kc.transpose(-1, -2) @ x
                                          for x in _split(w * vc))
        z = torch.exp2(total) * z + (w * kc).sum(2, keepdim=True)
    return dq[:, :, :n].to(BF16)


def _gla_log_decay(rng, shape, regime):
    """A fresh GLA layer's gate, log_sigmoid(N(0, 1) + 6), or the strong
    U[-5, 0]."""
    x = rng.standard_normal(shape)
    ld = {"init": -np.log1p(np.exp(-(x + 6.0))),
          "strong": -5.0 * rng.random(shape)}[regime]
    return torch.from_numpy(ld.astype(np.float32))


def _unit(rng, *shape):
    """Unit rows in bf16 (l2-normalized, as the model hands them over)."""
    x = rng.standard_normal(shape)
    return torch.from_numpy((x / np.linalg.norm(x, axis=-1, keepdims=True)
                             ).astype(np.float32)).to(BF16)


def _normal(rng, *shape, dtype=F32):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(dtype)


def _np(x):
    return jnp.asarray(x.float().numpy())


def test_emulated_gla_bwd_q_matches_jax_reference():
    """gla_bwd_q's gated body keeps dq within one bf16 step of the JAX
    package's chunked GLA backward, under a fresh layer's gate and the
    strong U[-5, 0], at G = 1 and 4 with a ragged last chunk (N =
    1000)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(51)
    a, b, n = 1.0, 0.5, 1000
    for g, regime in ((1, "init"), (4, "strong"), (1, "strong"),
                      (4, "init")):
        hkv = 4 // g
        q, k = _unit(rng, 1, 4, n, D), _unit(rng, 1, hkv, n, D)
        v = _normal(rng, 1, hkv, n, D, dtype=BF16)
        ld = _gla_log_decay(rng, (1, hkv, n), regime)
        om = _normal(rng, 1, 4, n, D)
        args = (_np(q), _np(k), _np(v), jnp.asarray(ld.numpy()))
        o, gn, _ = _jax_gla_fwd(*args, a, b, 128)
        want_dq = _jax_gla_bwd(*args, o, gn, jnp.asarray(om.numpy()), a, b,
                               128)[0]
        om_hat, h_vec = tchunked.la_bwd_prep(
            torch.from_numpy(np.array(o)), torch.from_numpy(np.array(gn)),
            om)
        dq = _emulate_gla_bwd_q(k, v, ld, om_hat, h_vec, b)
        assert np.isfinite(dq.float().numpy()).all()
        assert _rel(dq.float(), want_dq) <= BF16_REL, (g, regime)


def _emulate_stream(s, p, q, k, v, log_decay, a, b):
    """The stream body of gla_decode_fused (log_decay given) and
    la_decode_fused (log_decay None: γ = 1, the linear instance): S
    updated chunk by chunk of GLA_DECODE_ROWS rows, row i of a chunk by
    row class i % 4, each element γ S + k_i v_j; each class's partial dots
    over its rows in order, then added in the fixed order 0, 1, 2, 3; P =
    γ P + [v, 1] (as fmaf: one rounding, through float64); o = f[:Dv] /
    f[Dv].  s and p are updated in place; returns o."""
    bsz, h, dk = q.shape
    hkv, dv = k.shape[1], v.shape[-1]
    g = h // hkv
    vaug = torch.cat([v.float(), torch.ones(bsz, hkv, 1)], -1)
    gam = torch.ones(bsz, hkv, 1) if log_decay is None else \
        torch.exp(log_decay)[..., None]
    qg = q.reshape(bsz, hkv, g, dk).float()
    acc = torch.zeros(GLA_DECODE_ROW_CLASSES, bsz, hkv, g, dv + 1)
    for c0 in range(0, dk, GLA_DECODE_ROWS):
        for i in range(c0, min(c0 + GLA_DECODE_ROWS, dk)):
            row = gam * s[:, :, i] + k.float()[:, :, i, None] * vaug
            s[:, :, i] = row
            ry = (i - c0) % GLA_DECODE_ROW_CLASSES
            acc[ry] = acc[ry] + qg[..., i, None] * row[:, :, None]
    dot = acc[0]
    for ry in range(1, GLA_DECODE_ROW_CLASSES):
        dot = dot + acc[ry]
    p.copy_((gam.double() * p.double() + vaug.double()).float())
    f = a * p[:, :, None] + b * dot
    den = f[..., dv:]
    o = torch.where(den.abs() < 1e-30, torch.zeros(()), f[..., :dv] / den)
    return o.reshape(bsz, h, dv).to(q.dtype)


def test_emulated_decode_stream_matches_jax_reference():
    """The stream's chunked update and fixed-order reduction, at D = 128
    (8 chunks) and G = 1 and 4 in bf16 with a slot whose normalizer is
    exactly zero: o within one bf16 step and S, P within 1e-5 of the JAX
    package's fused decode step (impl "xla"), o = 0 on the zero
    normalizer, and the new S bit-equal to the plain elementwise update;
    gated under both decay regimes, and with γ = 1 (the linear entry,
    against the JAX package's linear decode step)."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(52)
    a, b = 1.0, 0.5
    for g, regime in ((1, "init"), (4, "strong"), (1, None), (4, None)):
        bsz, hkv = 3, 2
        s = _normal(rng, bsz, hkv, D, D + 1)
        p = _normal(rng, bsz, hkv, D + 1).abs()
        q, k = _unit(rng, bsz, hkv * g, D), _unit(rng, bsz, hkv, D)
        v = _normal(rng, bsz, hkv, D, dtype=BF16)
        ld = None if regime is None else \
            _gla_log_decay(rng, (bsz, hkv), regime)
        # slot 0, KV head 0: after the step p[Dv] == 0 and q == 0, so the
        # normalizer is exactly 0
        if ld is not None:
            ld[0, 0] = 0.0
        p[0, 0, D] = -1.0
        q[0, :g] = 0.0
        step = (_np(q).astype(jnp.bfloat16), _np(k).astype(jnp.bfloat16),
                _np(v).astype(jnp.bfloat16))
        s_e, p_e, s_t, p_t = s.clone(), p.clone(), s.clone(), p.clone()
        o = _emulate_stream(s_e, p_e, q, k, v, ld, a, b)
        if ld is None:
            want_s, want_o = jops.la_decode_step_fused(
                jchunked.LAState(_np(s), _np(p)), *step, a, b,
                backend="xla")
            tdf.la_decode_fused_torch(s_t, p_t, q, k, v, a, b)
        else:
            want_s, want_o = jops.gla_decode_step_fused(
                jgla.GLAState(_np(s), _np(p)), *step,
                jnp.asarray(ld.numpy()), a, b, backend="xla")
            tdf.gla_decode_fused_torch(s_t, p_t, q, k, v, ld, a, b)
        assert torch.equal(s_e, s_t), g
        assert float(o[0, :g].float().abs().max()) == 0.0
        assert _rel(o.float(), want_o) <= BF16_REL, (g, regime)
        assert _rel(s_e, want_s.s) <= F32_REL and \
            _rel(p_e, want_s.p) <= F32_REL, (g, regime)


@pytest.mark.gpu
def test_cuda_gla_bwd_q_and_decode_stream_match_plain():
    """gla_bwd_q (bf16, D = 128, the gated wgmma body) against its plain
    version at N = 300 and 65 with G = 1 and 2 under both decay regimes,
    dq within one bf16 step; gla_decode_fused and la_decode_fused (the
    stream) at D = 128, G = 1 and 4: S bit-equal to the plain version
    (bf16 inputs), P within 1e-5, o within one bf16 step.  A second
    launch of each gives bit-equal outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    rng = np.random.default_rng(53)
    for g, n, regime in ((1, 300, "init"), (2, 65, "strong")):
        hkv = 4 // g
        k = _unit(rng, 2, hkv, n, D).to(dev)
        v = _normal(rng, 2, hkv, n, D, dtype=BF16).to(dev)
        ld = _gla_log_decay(rng, (2, hkv, n), regime).to(dev)
        om_hat, h_vec = _normal(rng, 2, 4, n, D).to(dev), \
            _normal(rng, 2, 4, n).to(dev)
        dq = tkgla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec, 0.5)
        dq2 = tkgla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec, 0.5)
        torch.cuda.synchronize()
        want = tkgla.gla_bwd_q_torch(k, v, ld, om_hat, h_vec, 0.5)
        assert torch.equal(dq, dq2)
        assert _rel(dq.float().cpu(), want.float().cpu()) <= BF16_REL
    for g in (1, 4):
        bsz, hkv = 8, 16 // g
        s = _normal(rng, bsz, hkv, D, D + 1).to(dev)
        p = _normal(rng, bsz, hkv, D + 1).abs().to(dev)
        q, k = _unit(rng, bsz, 16, D).to(dev), _unit(rng, bsz, hkv, D).to(dev)
        v = _normal(rng, bsz, hkv, D, dtype=BF16).to(dev)
        ld = _gla_log_decay(rng, (bsz, hkv), "strong").to(dev)
        for kernel, plain, gate in (
                (tdf.gla_decode_fused_cuda, tdf.gla_decode_fused_torch,
                 (ld,)),
                (tdf.la_decode_fused_cuda, tdf.la_decode_fused_torch, ())):
            outs = []
            for _ in range(2):
                s_k, p_k = s.clone(), p.clone()
                outs.append((kernel(s_k, p_k, q, k, v, *gate, 1.0, 0.5),
                             s_k, p_k))
            torch.cuda.synchronize()
            s_t, p_t = s.clone(), p.clone()
            o_t = plain(s_t, p_t, q, k, v, *gate, 1.0, 0.5)
            assert all(torch.equal(x, y) for x, y in zip(*outs))
            o_k, s_k, p_k = outs[0]
            assert torch.equal(s_k, s_t)
            assert _rel(p_k.cpu(), p_t.cpu()) <= F32_REL
            assert _rel(o_k.float().cpu(), o_t.float().cpu()) <= BF16_REL
