"""The port's SSD / Mamba-2 path held against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages as numpy
arrays; the mixer and model runs carry the reference's weights over
(`params_from_jax` for the model).  Every sequence comparison runs
under both decay regimes: `init` = -softplus(N(0, 1)) (the decay of a
fresh layer, exp(a_log) = 1), and the hard `strong` = U[-5, 0], where an
off-by-one in the decay index fails.

Tolerances, each relative to the reference's largest |value| (the SSD
grads differ by ~1e-6 of their magnitude between two chunkings of the
reference itself, so absolute limits would not measure them):

  * F32_REL = 1e-5: f32 outputs, states and decode steps (float32
    rounding of sums taken in other orders and chunkings);
  * GRAD_REL = 1e-5 for dq, dk, dv and dlog_decay, each scaled to its
    own largest |value| (dlog_decay is a reverse cumsum and grows with
    N);
  * MODEL_REL = 1e-4: mamba2 smoke mixer and model outputs, logits, loss
    and every grad (float32 rounding through the conv, the SSD, the
    rmsnorms and the tied f32 unembedding);
  * BF16_REL = 2^-7: bf16 outputs, one bf16 rounding step;
  * the `gpu` test: the CUDA kernels against their plain versions on the
    card, f32 results to 1e-4 (the kernels sum token by token, the plain
    scans chunk by chunk), bf16 o to one bf16 step.

The cases are grouped into 7 tests so that pytest-xdist's loadfile
distribution queues the file after the long `test_property.py`.
"""
import dataclasses

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from helpers import run_engine_greedy
    from repro.configs.registry import get_config as jget_config
    from repro.core import ssd as jssd
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels import ssd as jkssd
    from repro.mixers import get_backend as jget_backend
    from repro.mixers.cache import MambaCache as JMambaCache
    from repro.models import model as jmdl
    from repro.serve import cache as jcache
except ImportError:  # the port alone, on the machine with the card
    jax = None
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import ssd as tssd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd as tkssd
from repro_torch.mixers import get_backend
from repro_torch.mixers.cache import MambaCache
from repro_torch.models import model as tmdl
from repro_torch.serve import cache as tcache
from repro_torch.serve.engine import Engine, Request
from repro_torch.tree import named_leaves

F32_REL = 1e-5
GRAD_REL = 1e-5
MODEL_REL = 1e-4
BF16_REL = 2.0 ** -7
GPU_F32_REL = 1e-4
REGIMES = ("init", "strong")


def _assert_rel(got, want, rel, label=""):
    got = got.detach().float().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{label}: max err {err} > {rel} * {scale}"


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference is not installed here")


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def _log_decay(rng, shape, regime):
    if regime == "init":
        return -np.logaddexp(0.0, rng.standard_normal(shape)).astype(
            np.float32)                                    # -softplus
    return rng.uniform(-5.0, 0.0, shape).astype(np.float32)


def _seq(rng, b, g, h, n, dk, dv, regime):
    """Grouped q, k (B, G, N, Dk), v and the upstream grad (B, H, N, Dv),
    a log decay (B, H, N); q and k at the scale of a conv'd silu output."""
    return (0.5 * rng.standard_normal((b, g, n, dk)).astype(np.float32),
            0.5 * rng.standard_normal((b, g, n, dk)).astype(np.float32),
            rng.standard_normal((b, h, n, dv)).astype(np.float32),
            _log_decay(rng, (b, h, n), regime),
            rng.standard_normal((b, h, n, dv)).astype(np.float32))


# ---------------------------------------------------------------------------
# (1) Forward with state in and out, continuation prefill
# ---------------------------------------------------------------------------

def test_ssd_forward_state_and_prefill_match_jax():
    """B=2, H=4, N=51, Dk=8, Dv=6, G in {1, 2}: o and the final state of
    `ssd_fwd_chunked` (state in, chunks 4 and 16) against the reference's
    scan, and o against both oracles (`ssd_ref`); prefill of 37 tokens
    then 14 more with the carried state equals the 51 at once; the Pallas
    forward in interpret mode at N=21 (odd, chunk 8)."""
    for regime in REGIMES:
        for g in (1, 2):
            rng = np.random.default_rng(1)
            q, k, v, ld, _ = _seq(rng, 2, g, 4, 51, 8, 6, regime)
            s0 = rng.standard_normal((2, 4, 8, 6)).astype(np.float32)
            jo, jst = jssd.ssd_fwd_chunked(
                *(jnp.asarray(x[:, :, :37]) for x in (q, k, v, ld)), 8,
                state=jssd.SSDState(jnp.asarray(s0)))
            label = f"{regime} G={g}"
            for chunk in (4, 16):
                to, tst = tssd.ssd_fwd_chunked(
                    *(_t(x[:, :, :37]) for x in (q, k, v, ld)), chunk,
                    state=tssd.SSDState(_t(s0)))
                _assert_rel(to, jo, F32_REL, f"{label} chunk {chunk} o")
                _assert_rel(tst.s, jst.s, F32_REL, f"{label} {chunk} state")
            whole, wst = tssd.ssd_fwd_chunked(*(_t(x) for x in (q, k, v, ld)),
                                              16)
            want = jref.ssd_ref(*(jnp.asarray(x) for x in (q, k, v, ld)))
            _assert_rel(whole, want, F32_REL, f"{label} vs ssd_ref")
            _assert_rel(tref.ssd_ref(*(_t(x) for x in (q, k, v, ld))), want,
                        F32_REL, f"{label} port's ssd_ref")
            o1, st = tssd.ssd_fwd_chunked(*(_t(x[:, :, :37]) for x in (
                q, k, v, ld)), 16)
            o2, st = tssd.ssd_fwd_chunked(*(_t(x[:, :, 37:]) for x in (
                q, k, v, ld)), 16, state=st)
            _assert_rel(torch.cat([o1, o2], 2), whole.numpy(), F32_REL,
                        f"{label} continuation o")
            _assert_rel(st.s, wst.s.numpy(), F32_REL, f"{label} state")
            jpo = jkssd.ssd_fwd_pallas(
                *(jnp.asarray(x[:1, :, :21]) for x in (q, k, v, ld)),
                chunk=8, interpret=True)
            _assert_rel(tkssd.ssd_fwd_torch(*(_t(x[:1, :, :21]) for x in (
                q, k, v, ld)), 8), jpo, F32_REL, f"{label} vs pallas")


# ---------------------------------------------------------------------------
# (2) Decode
# ---------------------------------------------------------------------------

def test_ssd_decode_step_matches_jax():
    """B=3, H=4, Dk=8, Dv=6, G in {1, 2}, f32 and bf16: the step against
    the reference's `ssd_decode_step`, and a prefill of 9 tokens then 4
    decode steps against the prefill of all 13."""
    for regime in REGIMES:
        for g in (1, 2):
            for dtype in (torch.float32, torch.bfloat16):
                rng = np.random.default_rng(3)
                q, k, v, ld, _ = _seq(rng, 3, g, 4, 13, 8, 6, regime)
                s0 = rng.standard_normal((3, 4, 8, 6)).astype(np.float32)
                jdt = {torch.float32: jnp.float32,
                       torch.bfloat16: jnp.bfloat16}[dtype]
                jst, jo = jssd.ssd_decode_step(
                    jssd.SSDState(jnp.asarray(s0)),
                    *(jnp.asarray(x[:, :, 0], jdt) for x in (q, k, v)),
                    jnp.asarray(ld[:, :, 0]))
                st, o = tssd.ssd_decode_step(
                    tssd.SSDState(_t(s0)),
                    *(_t(x[:, :, 0], dtype) for x in (q, k, v)),
                    _t(ld[:, :, 0]))
                label = f"{regime} G={g} {dtype}"
                assert o.dtype == dtype and st.s.dtype == torch.float32
                rel = F32_REL if dtype == torch.float32 else BF16_REL
                _assert_rel(o, jo, rel, f"{label} o")
                _assert_rel(st.s, jst.s, F32_REL, f"{label} state")
            # prefill then decode equals the whole prefill (f32)
            tq, tk, tv, tld = (_t(x) for x in (q, k, v, ld))
            want, _ = tssd.ssd_fwd_chunked(tq, tk, tv, tld, 4)
            _, st = tssd.ssd_fwd_chunked(
                *(x[:, :, :9] for x in (tq, tk, tv, tld)), 4)
            for i in range(9, 13):
                st, o = tssd.ssd_decode_step(st, tq[:, :, i], tk[:, :, i],
                                             tv[:, :, i], tld[:, :, i])
                _assert_rel(o, want[:, :, i].numpy(), F32_REL,
                            f"{regime} G={g} decode {i}")


# ---------------------------------------------------------------------------
# (3) Training: ssd_causal's grads, dlog_decay included
# ---------------------------------------------------------------------------

def _jax_grads(q, k, v, ld, om, chunk, impl):
    fn = lambda q, k, v, ld: jops.ssd_causal(  # noqa: E731
        q, k, v, ld, chunk, impl)
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, ld)))
    return o, vjp(jnp.asarray(om))


def test_ssd_causal_grads_match_jax():
    """H=4, odd N=37, Dk=8, Dv=6, G in {1, 2}: o and dq, dk, dv, dld of
    `ops.ssd_causal` ("torch" at chunks 4 and 16, "ref" falling back to
    the plain backward) against `jax.vjp` through the reference's
    `ssd_causal` ("xla"; "pallas_interpret" at N=21), each grad to
    GRAD_REL of its own largest |value|; the kernel module's split
    backward (the per-head partials, then the epilogue) equals the whole
    plain one."""
    names = ("dq", "dk", "dv", "dld")
    for regime in REGIMES:
        for g in (1, 2):
            rng = np.random.default_rng(2)
            q, k, v, ld, om = _seq(rng, 2, g, 4, 37, 8, 6, regime)
            label = f"{regime} G={g}"
            jo, jgr = _jax_grads(q, k, v, ld, om, 8, "xla")
            for impl, chunk in (("torch", 4), ("torch", 16), ("ref", 16)):
                leaves = [_t(x).requires_grad_(True) for x in (q, k, v, ld)]
                o = tops.ssd_causal(*leaves, chunk, impl)
                _assert_rel(o, jo, F32_REL, f"{label} {impl} o")
                grads = torch.autograd.grad(o, leaves, _t(om))
                for name, got, want in zip(names, grads, jgr):
                    _assert_rel(got, want, GRAD_REL,
                                f"{label} {impl} chunk {chunk} {name}")
            tq, tk, tv, tld, tom = (_t(x) for x in (q, k, v, ld, om))
            o = tkssd.ssd_fwd_torch(tq, tk, tv, tld, 16)
            dq_p = tkssd.ssd_bwd_q_torch(tk, tv, tld, tom, 16)
            dk_p, dv = tkssd.ssd_bwd_kv_torch(tq, tk, tv, tld, tom, 16)
            assert dq_p.shape == (2, 4, 37, 8) == dk_p.shape
            split = tssd.ssd_bwd_epilogue(tq, tk, tv, tld, o, tom, dq_p, dk_p,
                                          dv)
            whole = tkssd.ssd_bwd_torch(tq, tk, tv, tld, o, tom, 16)
            for name, got, want in zip(names, split, whole):
                assert torch.equal(got, want), f"{label} split {name}"
            # the Pallas backward in interpret mode
            small = [x[:1, :, :21] for x in (q, k, v, ld, om)]
            _, jpgr = _jax_grads(*small, 8, "pallas_interpret")
            leaves = [_t(x).requires_grad_(True) for x in small[:4]]
            grads = torch.autograd.grad(
                tops.ssd_causal(*leaves, 8, "torch"), leaves, _t(small[4]))
            for name, got, want in zip(names, grads, jpgr):
                _assert_rel(got, want, GRAD_REL, f"{label} vs pallas {name}")


# ---------------------------------------------------------------------------
# (4) The mamba2 mixer: apply, prefill, decode
# ---------------------------------------------------------------------------

def _smoke():
    return jget_config("mamba2-2.7b", smoke=True), \
        get_config("mamba2-2.7b", smoke=True)


def _mixer_params(jcfg, seed):
    """The reference's mixer params, with a_log and dt_bias moved off
    their init zeros so that the decay is not the same for every head."""
    jp = jget_backend(jcfg).init(jax.random.PRNGKey(seed), jcfg)
    jp = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed)
    h = jp["a_log"].shape[0]
    jp["a_log"] = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    jp["dt_bias"] = rng.uniform(-1.0, 1.0, h).astype(np.float32)
    jp["conv_b"] = 0.1 * rng.standard_normal(jp["conv_b"].shape).astype(
        np.float32)
    tp = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else _t(v)) for k, v in jp.items()}
    return jp, tp


def test_mamba2_mixer_matches_jax():
    """The smoke mixer (d_model 64, 4 heads of 32, state 16, conv width
    4) on the reference's weights: `apply` on both paths (analytic
    backward through `ssd_causal`, and autograd through the plain scan)
    with the grads of every mixer param and of x; prefill in windows of
    1, 2 and 5 tokens (shorter than the conv width, so the tail must
    span [left, window]) with the caches after each; then 3 decode
    steps."""
    jcfg, cfg = _smoke()
    jp, tp = _mixer_params(jcfg, 5)
    jb, tb = jget_backend(jcfg), get_backend(cfg)
    assert tb.fuses_ffn and not get_backend("linear").fuses_ffn
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jb.apply(p, jcfg, xx) * jnp.asarray(dy))
    jy = jb.apply(jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(x))
    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    for analytic in (True, False):
        c = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, analytic_bwd=analytic))
        named = named_leaves(tp)
        for _, t in named:
            t.requires_grad_(True)
        tx = _t(x).requires_grad_(True)
        y = tb.apply(tp, c, tx)
        _assert_rel(y, jy, MODEL_REL, f"analytic={analytic} apply")
        grads = torch.autograd.grad(y, [t for _, t in named] + [tx], _t(dy))
        for (path, _), gr in zip(named, grads):
            want = jgp
            for part in path.split("."):
                want = want[part]
            _assert_rel(gr, want, MODEL_REL, f"analytic={analytic} d{path}")
        _assert_rel(grads[-1], jgx, MODEL_REL, f"analytic={analytic} dx")
        for _, t in named:
            t.requires_grad_(False)

    jcache_ = jb.init_cache(jcfg, 2, 32, jnp.float32)
    tcache_ = tb.init_cache(cfg, 2, 32, "cpu", torch.float32)
    assert isinstance(tcache_, MambaCache)
    jpj = jax.tree.map(jnp.asarray, jp)
    start = 0
    for width in (1, 2, 5):
        xs = x[:, start:start + width]
        jy, jcache_ = jb.prefill(jpj, jcfg, jnp.asarray(xs), None, jcache_)
        ty, tcache_ = tb.prefill(tp, cfg, _t(xs), None, tcache_)
        label = f"prefill window {start}:{start + width}"
        _assert_rel(ty, jy, MODEL_REL, label)
        _assert_rel(tcache_.s, jcache_.ssd.s, MODEL_REL, label + " state")
        _assert_rel(tcache_.conv, jcache_.conv, F32_REL, label + " conv")
        start += width
    for i in range(start, start + 3):
        jy, jcache_ = jb.decode(jpj, jcfg, jnp.asarray(x[:, i:i + 1]), None,
                                jcache_)
        ty, tcache_ = tb.decode(tp, cfg, _t(x[:, i:i + 1]), None, tcache_)
        _assert_rel(ty, jy, MODEL_REL, f"decode {i}")
        _assert_rel(tcache_.s, jcache_.ssd.s, MODEL_REL, f"decode {i} state")
        _assert_rel(tcache_.conv, jcache_.conv, F32_REL, f"decode {i} conv")
    assert isinstance(jcache_, JMambaCache)


# ---------------------------------------------------------------------------
# (5) mamba2 smoke: the model, tied embeddings
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref():
    """The reference's mamba2 smoke params, tokens, prefill and decode
    logits, loss and grads, built once."""
    jcfg, _ = _smoke()
    params = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(4).integers(
        3, jcfg.vocab_size, size=(2, 21)).astype(np.int32)
    prefill = jax.jit(jmdl.prefill, static_argnums=1)
    decode = jax.jit(jmdl.decode_step, static_argnums=1)
    logits, cache = prefill(params, jcfg,
                            {"tokens": jnp.asarray(tokens[:, :17])},
                            jmdl.init_cache(jcfg, 2, 32))
    steps = [np.asarray(logits)]
    for i in range(17, 21):
        logits, cache = decode(params, jcfg, cache, jnp.asarray(tokens[:, i]))
        steps.append(np.asarray(logits))
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(params)
    return {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
            "logits": steps, "loss": float(loss),
            "grads": jax.tree.map(np.asarray, grads)}


def _jax_leaf(tree, path):
    parts = path.split(".")
    layer = None
    if parts[0] == "blocks":
        layer, parts = int(parts[1]), ["blocks"] + parts[2:]
    for p in parts:
        tree = tree[p]
    tree = np.asarray(tree)
    return tree if layer is None else tree[layer]


def test_mamba2_smoke_model_matches_jax(ref):
    """`params_from_jax` carries the tied tree (no lm_head, rmsnorms
    without bias, blocks without an FFN) across; prefill and 4 decode
    steps' logits, the loss and every param grad (the embedding table
    takes both the lookup's and the unembedding's) within MODEL_REL, on
    both training paths."""
    _, cfg = _smoke()
    params = params_from_jax(cfg, ref["params"], device="cpu")
    assert "lm_head" not in params and "lm_head" not in ref["params"]
    assert set(params["ln_f"]) == {"scale"}
    assert set(params["blocks"][0]) == {"ln1", "mixer"}
    init = tmdl.init_params(cfg, device="cpu")
    assert sorted(p for p, _ in named_leaves(init)) == \
        sorted(p for p, _ in named_leaves(params))
    tokens = torch.from_numpy(ref["tokens"])
    cache = tmdl.init_cache(cfg, 2, 32, device="cpu")
    logits, cache = tmdl.prefill(params, cfg, {"tokens": tokens[:, :17]},
                                 cache)
    out = [logits]
    for i in range(17, 21):
        logits, cache = tmdl.decode_step(params, cfg, cache, tokens[:, i])
        out.append(logits)
    for i, (got, want) in enumerate(zip(out, ref["logits"])):
        _assert_rel(got, want, MODEL_REL, f"step {i}")
    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    for analytic in (True, False):
        c = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, analytic_bwd=analytic))
        loss, _ = tmdl.loss_fn(params, c, {"tokens": tokens})
        assert abs(float(loss.detach()) - ref["loss"]) \
            <= MODEL_REL * abs(ref["loss"])
        grads = torch.autograd.grad(loss, [t for _, t in named])
        for (path, _), g in zip(named, grads):
            _assert_rel(g, _jax_leaf(ref["grads"], path), MODEL_REL,
                        f"analytic={analytic} {path}")
    # compute_params keeps the tied table and conv_w in the param dtype
    bf = tmdl.compute_params(params, dataclasses.replace(
        cfg, compute_dtype="bfloat16"))
    assert bf["embed"]["table"].dtype == torch.float32
    assert bf["blocks"][0]["mixer"]["conv_w"].dtype == torch.float32
    assert bf["blocks"][0]["mixer"]["in_proj"]["w"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# (6) Serving: the engine
# ---------------------------------------------------------------------------

# 3 requests on 2 slots: request 2 takes the slot request 0 frees, and
# its installed prefill must overwrite both cache tensors of that slot
_REQS = [(0, list(range(3, 12)), 2), (1, list(range(20, 45)), 5),
         (2, list(range(7, 16)), 3)]


def test_mamba2_engine_greedy_tokens_identical_to_jax(ref):
    """Greedy tokens of the port's Engine identical to the JAX Engine's on
    mamba2 smoke, more requests than slots, one-shot and chunked prefill
    (windows of 2, shorter than the conv width); the flat MambaCache's
    per-slot bytes equal the reference's nested one, and at full width
    64 x (80 x 128 x 64 x 4 + 3 x 5376 x 2) B of layer caches plus the
    4-byte position counter; paging is refused for mamba2."""
    jcfg, cfg = _smoke()
    jparams = jax.tree.map(jnp.asarray, ref["params"])
    params = params_from_jax(cfg, ref["params"], device="cpu")
    for chunk in (None, 2):
        want, _ = run_engine_greedy(jcfg, jparams, reqs=_REQS, max_slots=2,
                                    prefill_chunk=chunk)
        eng = Engine(cfg, params, max_slots=2, max_len=64, eos_id=-1,
                     prefill_chunk=chunk, device="cpu")
        for rid, prompt, mn in _REQS:
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mn))
        assert eng.run() == want, chunk
    for jc, tc in ((jcfg, cfg), (jget_config("mamba2-2.7b"),
                                 get_config("mamba2-2.7b"))):
        assert tcache.per_slot_bytes(tc, 64) == jcache.per_slot_bytes(jc, 64)
    assert tcache.per_slot_bytes(get_config("mamba2-2.7b"), 544) == \
        64 * (80 * 128 * 64 * 4 + 3 * 5376 * 2) + 4 == 169_836_548
    with pytest.raises(ValueError, match="mamba2"):
        Engine(cfg, params, max_slots=2, max_len=64, page_size=4,
               device="cpu")


# ---------------------------------------------------------------------------
# (7) The CUDA kernels (card only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_ssd_kernels_match_plain():
    """ssd_fwd, ssd_bwd_q and ssd_bwd_kv against their plain versions on
    the card, at both instantiated (Dk, Dv): (16, 32) with G in {1, 2}
    and (128, 64) with G = 1, odd N = 61, f32 and bf16, both decay
    regimes; each launch counted once; (Dk, Dv) outside the
    instantiations refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    for regime in REGIMES:
        for g, h, dk, dv in ((1, 4, 16, 32), (2, 4, 16, 32),
                             (1, 4, 128, 64)):
            for dtype in (torch.float32, torch.bfloat16):
                rng = np.random.default_rng(7)
                q, k, v, ld, om = _seq(rng, 2, g, h, 61, dk, dv, regime)
                q, k, v, om = (_t(x, dtype).to(dev) for x in (q, k, v, om))
                ld = _t(ld).to(dev)
                before = dict(tkssd.launches)
                o_k = tkssd.ssd_fwd_cuda(q, k, v, ld)
                dq_k = tkssd.ssd_bwd_q_cuda(k, v, ld, om)
                dk_k, dv_k = tkssd.ssd_bwd_kv_cuda(q, k, v, ld, om)
                torch.cuda.synchronize()
                assert {n: tkssd.launches[n] - before[n] for n in before} \
                    == {"ssd_fwd": 1, "ssd_bwd_q": 1, "ssd_bwd_kv": 1}
                o_t = tkssd.ssd_fwd_torch(q, k, v, ld, 16)
                dq_t = tkssd.ssd_bwd_q_torch(k, v, ld, om, 16)
                dk_t, dv_t = tkssd.ssd_bwd_kv_torch(q, k, v, ld, om, 16)
                label = f"{regime} G={g} ({dk}, {dv}) {dtype}"
                assert o_k.dtype == dtype
                rel = GPU_F32_REL if dtype == torch.float32 else BF16_REL
                for name, got, want, r in (
                        ("o", o_k, o_t, rel), ("dq", dq_k, dq_t, GPU_F32_REL),
                        ("dk", dk_k, dk_t, GPU_F32_REL),
                        ("dv", dv_k, dv_t, GPU_F32_REL)):
                    _assert_rel(got, want.float().cpu().numpy(), r,
                                f"{label} {name}")
                got = tkssd.ssd_bwd_cuda(q, k, v, ld, o_t, om)
                want = tkssd.ssd_bwd_torch(q, k, v, ld, o_t, om, 16)
                for name, a, b in zip(("dq", "dk", "dv", "dld"), got, want):
                    assert a.dtype == b.dtype, name
                    _assert_rel(a, b.float().cpu().numpy(),
                                rel if name != "dld" else GPU_F32_REL,
                                f"{label} epilogue {name}")
    x = torch.zeros((1, 1, 8, 32), device=dev)
    with pytest.raises(ValueError, match="not in"):
        tkssd.ssd_fwd_cuda(x, x, torch.zeros((1, 2, 8, 32), device=dev),
                           torch.zeros((1, 2, 8), device=dev))
