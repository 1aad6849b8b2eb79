"""`la_bwd_kv` (and its gated instance `gla_bwd_kv`) split over the query
group, and `ssd_fwd`'s chunked wgmma body at (Dk, Dv) = (64, 64): their
launch plans, their arithmetic emulated on the CPU against the JAX
package, and on the card both kernels against their plain versions.

From G = 7 query heads a KV head (qwen2-vl-7b's 7, qwen2.5-3b's 8,
chatglm3-6b's 16, granite-20b's 48) `la_bwd_kv`'s chunked body cuts the
group into S slices of consecutive heads, slice s the heads [s G / S,
(s + 1) G / S), each walked by a block of its own (grid z); each slice
stores its part of dk and dv unrounded in f32 and a second kernel adds
the slices in order and rounds once (no atomics, no cluster).  Smaller
groups and G = 1 keep the unsplit launch.  zamba2-7b's Mamba-2 layers,
(64, 64), run `ssd_fwd`'s chunked body templated on Dk: q and k one
64-column box a row, S^T an m64n64 accumulator, A, w v and the readout's
copy of S as hi + lo bf16 pairs, 83,968 B a block.

  * plan tests on meta tensors: `la_bwd_kv` and `gla_bwd_kv` at G = 1
    keep the unsplit geometry and shared memory; at G = 7 and 48 every
    query head lies in exactly one slice, in order, the grid is one wave
    of blocks with no cluster, and dk, dv and the f32 partials each have
    one writer; `ssd_fwd` at (64, 64) runs the wgmma body, its chunks
    cover [0, N), its boxes cover the heads;
  * the split body emulated in f32 (tests/test_torch_la_bwd_sm90.py's
    emulator per slice, its hi + lo operands, the slices summed in order)
    against the JAX package's backward at G = 7 over 4 uneven slices (1,
    2, 2, 2 heads), N = 300, D = 128: the f32 sums within 1e-4 of dk's
    and dv's largest |value|, the rounded ones within one bf16 step;
  * `sc` at (64, 64) emulated (tests/test_torch_ssd_sm90.py's emulator,
    its roundings as hi + lo pairs) against the JAX package's chunked SSD
    under a fresh layer's decays and U[-5, 0], N = 300: o within 2^-7;
  * a `gpu`-marked test (skips without a card): both kernels against
    their plain versions at small ragged shapes, twice for bit-equal
    outputs.
"""
import numpy as np
import pytest
import torch

from test_torch_la_bwd_sm90 import _emulate_la_bwd_kv, _written_once
from test_torch_ssd_sm90 import _emulate_wgmma_body

try:
    import jax

    # the reference on the CPU, where an f32 dot is an f32 dot (JAX on a
    # card computes it in TF32 by default)
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from repro.core import chunked as jchunked
    from repro.core import ssd as jssd
except ImportError:   # the port alone, on the machine with the card
    jnp = None

from repro_torch.core import chunked as tchunked
from repro_torch.kernels import gla as tkgla
from repro_torch.kernels import linear_attention as tkla
from repro_torch.kernels import plan
from repro_torch.kernels import ssd as tkssd
from repro_torch.kernels.defaults import H100_SMS, SSD_CHUNK_TOKENS

BF16, F32 = torch.bfloat16, torch.float32
BF16_REL = 2.0 ** -7
F32_REL = 1e-4
D = 128
# `bkv::Layout<128, false / true>::kSmem`, as before the split
KV_SMEM, GLA_KV_SMEM = 199424, 200976
# `sc::Layout<64, true>::kSmem`: two chunks of q, k (64 x 64) and v (64 x
# 64) in bf16, the hi and lo (w v) tiles and copies of S^T (64 x 64), 2 KB
SC64_SMEM = 2 * 3 * 8192 + 2 * 8192 + 2 * 8192 + 2048
SM_SMEM = 233472   # an SM's shared memory; each block also holds 1 KB


def _meta(*shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype, device="meta")


def _kv_plans(b, h, hkv, n, d=D):
    q, kv = _meta(b, h, n, d), _meta(b, hkv, n, d)
    om, h_vec = _meta(b, h, n, d, dtype=F32), _meta(b, h, n, dtype=F32)
    ld = _meta(b, hkv, n, dtype=F32)
    return (tkla.plan_la_bwd_kv(q, kv, kv, om, h_vec, 1.0, 1.0),
            tkgla.plan_gla_bwd_kv(q, kv, kv, ld, om, h_vec, 1.0, 1.0))


def test_group_of_one_keeps_the_unsplit_plan():
    """At G = 1 (pythia-1.4b's B = 2, H = Hkv = 16) and below the split's
    group (G = 4), la_bwd_kv and gla_bwd_kv launch as before: (B Hkv, 4, 1)
    blocks of one warpgroup, 199,424 and 200,976 B, null partials."""
    for h, hkv in ((16, 16), (16, 4)):
        for n in (8192, 65):
            for p, smem in zip(_kv_plans(2, h, hkv, n),
                               (KV_SMEM, GLA_KV_SMEM)):
                assert (p.grid, p.threads, p.smem) == ((2 * hkv, 4, 1), 128,
                                                       smem)
                assert p.pointers[-2:] == (None, None)
                assert not [a for a in p.accesses if a.role == "scratch"]
                assert tkla.kv_slices(p.name, BF16, 2, h, hkv, D) == 1


@pytest.mark.parametrize("h,hkv,slices", [(28, 4, 4), (48, 1, 16)])
def test_split_plan_slices_cover_the_group(h, hkv, slices):
    """qwen2-vl-7b's G = 7 and granite-20b's G = 48 at B = 2: S = 4 slices
    of 1, 2, 2, 2 heads and 16 of 3; every query head of a KV head lies in
    exactly one slice, in order; the grid is (B Hkv, 4, S), 128 blocks on
    132 SMs, no cluster, shared memory unchanged (<= 232,448 B, one block
    an SM); dk, dv (dV') and each f32 partial have one writer."""
    b, group = 2, h // hkv
    for n in (8192, 1000, 65):
        for p, smem in zip(_kv_plans(b, h, hkv, n), (KV_SMEM, GLA_KV_SMEM)):
            assert (p.grid, p.threads, p.smem) == ((b * hkv, 4, slices), 128,
                                                   smem)
            assert p.grid[0] * p.grid[1] * p.grid[2] <= H100_SMS
            assert p.smem <= plan.MAX_SMEM and \
                SM_SMEM // (p.smem + 1024) == 1
            assert p.pointers[-2:] == tuple(
                a.name for a in p.accesses if a.role == "scratch")
    spans = [tkla.slice_heads(group, slices, z) for z in range(slices)]
    assert spans[0][0] == 0 and spans[-1][1] == group
    assert all(x[1] == y[0] and x[0] < x[1] for x, y in zip(spans, spans[1:]))
    if group == 7:
        assert [hi - lo for lo, hi in spans] == [1, 2, 2, 2]
    for p in _kv_plans(b, h, hkv, 65):
        acc = {a.name: a for a in p.accesses}
        seen = np.zeros((b, h), int)
        for blk in p.blocks():
            if blk[1] == 0:   # one block per (cell, slice) of each role
                for t in acc["q"].tile(blk):
                    (b0, b1), (h0, h1) = t.ranges[:2]
                    seen[b0:b1, h0:h1] += 1
                    lo, hi = tkla.slice_heads(group, slices, blk[2])
                    assert (h0, h1) == (blk[0] % hkv * group + lo,
                                        blk[0] % hkv * group + hi)
        assert (seen == 1).all()
        for a in p.accesses:
            if a.role in ("out", "scratch"):
                assert _written_once_or_read(p, a), (p.name, a.name)


def _written_once_or_read(launch, access):
    """Outputs: one writer per element; scratch: every element written by
    the one block of its slice and read back by the slice sum's."""
    if access.role == "out":
        return _written_once(launch, access.name)
    seen = np.zeros(access.shape, int)
    for blk in launch.blocks():
        for t in access.tile(blk):
            if t.ranges[2] == (blk[2], blk[2] + 1):   # the block's write
                seen[tuple(slice(lo, hi) for lo, hi in t.ranges)] += 1
    return bool((seen == 1).all())


def test_ssd_fwd_plan_at_64_64():
    """zamba2-7b's (64, 64) in bf16: ssd_fwd runs the wgmma body, one
    warpgroup per (batch, head), 83,968 B (two blocks an SM), the chunk
    as the C call's stage; chunks cover [0, N) exactly and each (batch,
    head) of o is one block's; the backward keeps its walks there."""
    assert tkssd.ssd_body("ssd_fwd", BF16, 64, 64) == "wgmma"
    assert tkssd.ssd_body("ssd_fwd", F32, 64, 64) == "walk"
    for entry in ("ssd_bwd_q", "ssd_bwd_kv"):
        assert tkssd.ssd_body(entry, BF16, 64, 64) == "walk"
    for g, h, n in ((1, 112, 8192), (1, 8, 1000), (2, 4, 65), (1, 4, 1)):
        q = _meta(2, g, n, 64)
        p = tkssd.plan_ssd_fwd(q, q, _meta(2, h, n, 64),
                               _meta(2, h, n, dtype=F32))
        assert (p.grid, p.threads, p.smem) == ((2 * h, 1, 1), 128,
                                               SC64_SMEM)
        assert SM_SMEM // (p.smem + 1024) == 2 and p.smem <= plan.MAX_SMEM
        assert p.stage == p.args[6] == p.plan_args[6] == SSD_CHUNK_TOKENS
        spans = [(t0, min(t0 + p.stage, n)) for t0 in range(0, n, p.stage)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(x[1] == y[0] for x, y in zip(spans, spans[1:]))
        if n <= 1000:
            assert _written_once(p, "o")
            acc = {a.name: a for a in p.accesses}
            for blk in p.blocks():
                bi, hi = divmod(blk[0], h)
                (q_t,) = acc["q"].tile(blk)
                assert q_t.ranges == ((bi, bi + 1), (hi // (h // g),
                                                     hi // (h // g) + 1),
                                      (0, n), (0, 64))


# ---------------------------------------------------------------------------
# the arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------

def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_emulated_split_bkv_matches_jax_reference():
    """G = 7 (H = 7 on one KV head) over the 4 slices qwen2-vl-7b's shape
    takes (1, 2, 2, 2 heads), B = 2, N = 300, D = 128: each slice's f32 dk
    and dv from the body's emulation on its own heads (hi + lo operands),
    added in slice order, are within 1e-4 of the largest |value| of the
    JAX package's f32 backward; rounded once to bf16, within one bf16
    step."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(33)
    b, h, hkv, n = 2, 7, 1, 300
    slices = tkla.kv_slices("la_bwd_kv", BF16, 2, 28, 4, D)
    assert slices == 4
    q = torch.from_numpy(_unit(rng, b, h, n, D)).to(BF16)
    k = torch.from_numpy(_unit(rng, b, hkv, n, D)).to(BF16)
    v = torch.from_numpy(rng.standard_normal((b, hkv, n, D)).astype(
        np.float32)).to(BF16)
    omega = rng.standard_normal((b, h, n, D)).astype(np.float32)
    o, g = tkla.la_fwd_torch(q, k, v, 1.0, 1.0)
    om, h_vec = tchunked.la_bwd_prep(o, g, torch.from_numpy(omega))
    dk = dv = 0.0
    for z in range(slices):
        lo, hi = tkla.slice_heads(h // hkv, slices, z)
        pk, pv = _emulate_la_bwd_kv(q[:, lo:hi], k, v, om[:, lo:hi],
                                    h_vec[:, lo:hi], 1.0, 1.0, rounded=False)
        dk, dv = dk + pk, dv + pv
    # the reference in f32 on the same (bf16-exact) values
    jq, jk, jv, jo = (jnp.asarray(x.float().numpy()) for x in (q, k, v, o))
    _, want_dk, want_dv = jchunked.la_bwd_chunked(
        jq, jk, jv, jo, jnp.asarray(g.numpy()), jnp.asarray(omega), 1.0,
        1.0, 128)
    for got, want in ((dk, want_dk), (dv, want_dv)):
        want = np.asarray(want, np.float32)
        assert np.isfinite(got.numpy()).all()
        assert _rel(got, want) <= F32_REL
        assert _rel(got.to(BF16).float(), want) <= BF16_REL


def test_emulated_sc_at_64_64_matches_jax_reference():
    """sc at zamba2-7b's (64, 64) (G = 1, H = 4, B = 2, N = 300, a ragged
    last chunk): the body's rounding points (hi + lo pairs) keep o within
    one bf16 step of the JAX package's chunked SSD under a fresh layer's
    decays and the hard U[-5, 0]."""
    if jnp is None:
        pytest.skip("the JAX reference is not installed here")
    rng = np.random.default_rng(34)
    b, g, h, n = 2, 1, 4, 300
    for regime in ("init", "strong"):
        q, k = (torch.from_numpy((0.5 * rng.standard_normal((b, g, n, 64)))
                                 .astype(np.float32)).to(BF16)
                for _ in range(2))
        v = torch.from_numpy(rng.standard_normal((b, h, n, 64)).astype(
            np.float32)).to(BF16)
        ld = (-np.log1p(np.exp(rng.standard_normal((b, h, n))))
              if regime == "init" else -5.0 * rng.random((b, h, n)))
        ld = torch.from_numpy(ld.astype(np.float32))
        got = _emulate_wgmma_body(q, k, v, ld, pairs=True).float().numpy()
        want, _ = jssd.ssd_fwd_chunked(
            *(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
              for x in (q, k, v)), jnp.asarray(ld.numpy()))
        want = np.asarray(want.astype(jnp.float32))
        assert np.isfinite(got).all()
        assert _rel(got, want) <= BF16_REL, regime


@pytest.mark.gpu
def test_cuda_split_and_sc64_match_plain():
    """On the card: la_bwd_kv split at G = 7 (B = 2, H = 28, Hkv = 4: 4
    uneven slices) and G = 48 (16 slices) and gla_bwd_kv split at G = 8,
    N = 300 and 65, against their plain versions within one bf16 step
    (dV' within 1e-4); ssd_fwd at (64, 64), N = 300, 65 and 1, G = 1 and
    2, o within one bf16 step; each launched twice for bit-equal
    outputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(36)

    def unit(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        return (x / x.norm(dim=-1, keepdim=True)).to(BF16)

    for h, hkv, n, gated in ((28, 4, 300, False), (48, 1, 65, False),
                             (16, 2, 300, True), (16, 2, 65, True)):
        q, k = unit(2, h, n, D), unit(2, hkv, n, D)
        v = torch.randn((2, hkv, n, D), generator=gen, device=dev).to(BF16)
        omega = torch.randn((2, h, n, D), generator=gen, device=dev)
        o, g = tkla.la_fwd_torch(q, k, v, 1.0, 1.0)
        om, h_vec = tchunked.la_bwd_prep(o, g, omega)
        assert tkla.kv_slices("gla_bwd_kv" if gated else "la_bwd_kv", BF16,
                              2, h, hkv, D) > 1
        if gated:
            ld = -5.0 * torch.rand((2, hkv, n), generator=gen, device=dev)
            args = (q, k, v, ld, om, h_vec, 1.0, 1.0)
            got, again = (tkgla.gla_bwd_kv_cuda(*args) for _ in range(2))
            want = tkgla.gla_bwd_kv_torch(*args)
            rels = (BF16_REL, F32_REL)
        else:
            args = (q, k, v, om, h_vec, 1.0, 1.0)
            got, again = (tkla.la_bwd_kv_cuda(*args) for _ in range(2))
            want = tkla.la_bwd_kv_torch(*args)
            rels = (BF16_REL, BF16_REL)
        torch.cuda.synchronize()
        for x, y, w, rel in zip(got, again, want, rels):
            assert torch.equal(x, y), (h, hkv, n, gated)
            assert _rel(x.float().cpu(), w.float().cpu()) <= rel, (
                h, hkv, n, gated)
    for g, h, n in ((1, 8, 300), (2, 4, 65), (1, 4, 1)):
        q, k = ((0.5 * torch.randn((2, g, n, 64), generator=gen,
                                   device=dev)).to(BF16) for _ in range(2))
        v = torch.randn((2, h, n, 64), generator=gen, device=dev).to(BF16)
        ld = -torch.nn.functional.softplus(
            torch.randn((2, h, n), generator=gen, device=dev))
        o, again = (tkssd.ssd_fwd_cuda(q, k, v, ld) for _ in range(2))
        torch.cuda.synchronize()
        want = tkssd.ssd_fwd_torch(q, k, v, ld)
        assert o.dtype == BF16 and torch.equal(o, again)
        assert _rel(o.float().cpu(), want.float().cpu()) <= BF16_REL
