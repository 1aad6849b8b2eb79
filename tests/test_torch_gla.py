"""The port's decay-gated (GLA) path held against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages as numpy
arrays; model-level runs carry the reference's weights over with
`params_from_jax`.  Every comparison runs under both decay regimes the
trained gate and a hard one give, because an off-by-one in the decay
index passes at log_decay ~ 0 and fails only under strong decay:
`trained` = log_sigmoid(N(0, 1) + 6), `strong` = U[-5, 0].

Tolerances, each relative to the reference's largest |value|:

  * F32_REL = 1e-5: f32 outputs, states and decode steps (float32
    rounding of sums taken in other orders and chunkings);
  * GRAD_REL = 1e-5 for dq, dk, dv and dlog_decay, each scaled to its
    own largest |value|: dlog_decay is a reverse cumsum over tokens and
    grows with N, so an absolute tolerance would not measure it;
  * MODEL_REL = 1e-4: pythia smoke logits, loss and every grad (float32
    rounding through two layers and the f32 unembedding);
  * BF16_REL = 2^-7: bf16 outputs, one bf16 rounding step;
  * the `gpu` test: the CUDA kernels against their plain versions on the
    card, f32 to 1e-4 (the kernels sum token by token over up to 64
    tokens, the plain scans chunk by chunk), bf16 to one bf16 step.

Covered: the forward with state in and out against `gla_fwd_chunked`
("xla") and `gla_ref`, continuation prefill, log_decay = 0 against the
linear family, and the Pallas forward in interpret mode; `gla_causal`'s
grads (dlog_decay included) at G = 2 and odd N against `jax.vjp`
through the reference's `gla_causal` (xla, and Pallas interpret at a
tiny size); the fused decode step, state in place, with a zero
normalizer; pythia smoke with `attention_backend="gla"`; greedy Engine
tokens against the JAX Engine, one-shot and chunked; the paged GLA
engine.  The cases are grouped into 7 tests so that pytest-xdist's
loadfile distribution queues the file after the long `test_property.py`.
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
    from repro.core import chunked as jchunked
    from repro.core import gla as jgla
    from repro.kernels import gla as jkgla
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.models import model as jmdl
    from repro.serve import cache as jcache
except ImportError:  # the port alone, on the machine with the card
    jax = None
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import chunked as tchunked
from repro_torch.core import gla as tgla
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels import gla as tkgla
from repro_torch.kernels import linear_attention as tkla
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.models import model as tmdl
from repro_torch.serve import cache as tcache
from repro_torch.serve import paging as tpaging
from repro_torch.serve.engine import Engine, Request
from repro_torch.tree import named_leaves

F32_REL = 1e-5
GRAD_REL = 1e-5
MODEL_REL = 1e-4
BF16_REL = 2.0 ** -7
GPU_F32_REL = 1e-4
REGIMES = ("trained", "strong")


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


def _unit_rows(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _log_decay(rng, shape, regime):
    if regime == "trained":
        x = rng.standard_normal(shape) + 6.0
        return -np.logaddexp(0.0, -x).astype(np.float32)  # log_sigmoid
    return rng.uniform(-5.0, 0.0, shape).astype(np.float32)


def _seq(rng, b, h, hkv, n, d, regime):
    """Unit q/k rows (as the mixer hands them over after l2
    normalization), normal v and upstream grad, and a log decay."""
    return (_unit_rows(rng, (b, h, n, d)), _unit_rows(rng, (b, hkv, n, d)),
            rng.standard_normal((b, hkv, n, d)).astype(np.float32),
            _log_decay(rng, (b, hkv, n), regime),
            rng.standard_normal((b, h, n, d)).astype(np.float32))


# ---------------------------------------------------------------------------
# Forward with state, continuation prefill, the linear limit
# ---------------------------------------------------------------------------

def test_forward_state_prefill_and_linear_limit():
    """B=2, H=4, Hkv=2, N=37, D=8: o, g and the final state against
    `gla_fwd_chunked` (state in and out, chunks 4 and 16) and o and g
    against `gla_ref`; prefill of 37 tokens then 14 more with the carried
    state equals the 51 at once; log_decay = 0 gives the linear family;
    and the Pallas forward in interpret mode at N=16 (strong decay)."""
    for regime in REGIMES:
        rng = np.random.default_rng(1)
        q, k, v, ld, _ = _seq(rng, 2, 4, 2, 51, 8, regime)
        s0 = rng.standard_normal((2, 2, 8, 9)).astype(np.float32)
        p0 = np.abs(rng.standard_normal((2, 2, 9))).astype(np.float32)
        jo, jg, jst = jgla.gla_fwd_chunked(
            *(jnp.asarray(x[:, :, :37]) for x in (q, k, v, ld)), 1.0, 0.5,
            8, state=jgla.GLAState(jnp.asarray(s0), jnp.asarray(p0)))
        for chunk in (4, 16):
            to, tg, tst = tgla.gla_fwd_chunked(
                *(_t(x[:, :, :37]) for x in (q, k, v, ld)), 1.0, 0.5, chunk,
                state=tgla.GLAState(_t(s0), _t(p0)))
            for name, got, want in (("o", to, jo), ("g", tg, jg),
                                    ("s", tst.s, jst.s), ("p", tst.p, jst.p)):
                _assert_rel(got, want, F32_REL, f"{regime} {chunk} {name}")
        whole = tgla.gla_fwd_chunked(*(_t(x) for x in (q, k, v, ld)), 1.0,
                                     0.5, 16)
        _assert_rel(whole[0], jref.gla_ref(*(jnp.asarray(x) for x in (
            q, k, v, ld)), 1.0, 0.5), F32_REL, f"{regime} vs gla_ref")
        o1, st = tops.gla_prefill(*(_t(x[:, :, :37]) for x in (q, k, v, ld)),
                                  1.0, 0.5, 16)
        o2, st = tops.gla_prefill(*(_t(x[:, :, 37:]) for x in (q, k, v, ld)),
                                  1.0, 0.5, 16, state=st)
        _assert_rel(torch.cat([o1, o2], 2), whole[0].numpy(), F32_REL,
                    f"{regime} continuation o")
        _assert_rel(st.s, whole[2].s.numpy(), F32_REL, f"{regime} state")
        # the oracle's own normalizer feeds the ref impl's residual
        ro, rg = tref.gla_ref(*(_t(x) for x in (q, k, v, ld)), 1.0, 0.5,
                              return_g=True)
        _assert_rel(ro, whole[0].numpy(), F32_REL, f"{regime} ref o")
        _assert_rel(rg, whole[1].numpy(), F32_REL, f"{regime} ref g")
    # the Pallas forward in interpret mode, under strong decay
    jpo, jpg = jkgla.gla_fwd_pallas(
        *(jnp.asarray(x[:1, :, :16]) for x in (q, k, v, ld)), 1.0, 0.5,
        chunk=8, interpret=True)
    to, tg = tkgla.gla_fwd_torch(*(_t(x[:1, :, :16]) for x in (
        q, k, v, ld)), 1.0, 0.5, 8)
    _assert_rel(to, jpo, F32_REL, "vs pallas interpret o")
    _assert_rel(tg, jpg, F32_REL, "vs pallas interpret g")
    # log_decay == 0: exactly the linear family's state, and its output
    # and normalizer to float32 rounding (the gate's exp(0) factors)
    zero = np.zeros_like(ld)
    lo, lg, lst = tchunked.la_fwd_chunked(*(_t(x) for x in (q, k, v)), 1.0,
                                          0.5, 16)
    go, gg, gst = tgla.gla_fwd_chunked(*(_t(x) for x in (q, k, v, zero)),
                                       1.0, 0.5, 16)
    _assert_rel(go, lo.numpy(), F32_REL, "ld=0 o vs linear")
    _assert_rel(gg, lg.numpy(), F32_REL, "ld=0 g vs linear")
    _assert_rel(gst.s, lst.s.numpy(), F32_REL, "ld=0 state vs linear")
    jlo, _, _ = jchunked.la_fwd_chunked(*(jnp.asarray(x) for x in (q, k, v)),
                                        1.0, 0.5, 16)
    _assert_rel(go, jlo, F32_REL, "ld=0 o vs the reference's linear")


# ---------------------------------------------------------------------------
# Training: gla_causal's grads, dlog_decay included
# ---------------------------------------------------------------------------

def _jax_grads(q, k, v, ld, om, chunk, impl):
    fn = lambda q, k, v, ld: jops.gla_causal(  # noqa: E731
        q, k, v, ld, 1.0, 0.5, chunk, impl)
    o, vjp = jax.vjp(fn, *(jnp.asarray(x) for x in (q, k, v, ld)))
    return o, vjp(jnp.asarray(om))


def test_gla_causal_grads_match_jax():
    """G = 2 (H=4, Hkv=2), odd N = 37, D = 8: o and dq, dk, dv, dld of
    `ops.gla_causal` ("torch" at chunks 4 and 16, "ref" falling back to
    the plain backward) against `jax.vjp` through the reference's
    `gla_causal` ("xla"), each grad to GRAD_REL of its own largest
    |value|; the Pallas backward in interpret mode at N=16 (strong
    decay); the kernel
    module's split backward (dq, then dk and dV', then the epilogue)
    equals the whole plain one."""
    names = ("dq", "dk", "dv", "dld")
    for regime in REGIMES:
        rng = np.random.default_rng(2)
        q, k, v, ld, om = _seq(rng, 2, 4, 2, 37, 8, regime)
        jo, jgr = _jax_grads(q, k, v, ld, om, 8, "xla")
        for impl, chunk in (("torch", 4), ("torch", 16), ("ref", 16)):
            leaves = [_t(x).requires_grad_(True) for x in (q, k, v, ld)]
            o = tops.gla_causal(*leaves, 1.0, 0.5, chunk, impl)
            _assert_rel(o, jo, F32_REL, f"{regime} {impl} o")
            grads = torch.autograd.grad(o, leaves, _t(om))
            for name, got, want in zip(names, grads, jgr):
                _assert_rel(got, want, GRAD_REL,
                            f"{regime} {impl} chunk {chunk} {name}")
        tq, tk, tv, tld, tom = (_t(x) for x in (q, k, v, ld, om))
        o, g = tkgla.gla_fwd_torch(tq, tk, tv, tld, 1.0, 0.5, 16)
        om_hat, h_vec = tchunked.la_bwd_prep(o, g, tom)
        dq = tkgla.gla_bwd_q_torch(tk, tv, tld, om_hat, h_vec, 0.5, 16)
        dk, dva = tkgla.gla_bwd_kv_torch(tq, tk, tv, tld, om_hat, h_vec,
                                         1.0, 0.5, 16)
        split = (dq, dk, *tgla.gla_bwd_epilogue(tv, dva, tld))
        whole = tkgla.gla_bwd_torch(tq, tk, tv, tld, o, g, tom, 1.0, 0.5, 16)
        for name, got, want in zip(names, split, whole):
            assert torch.equal(got, want), f"{regime} split {name}"
    # the Pallas backward in interpret mode, under strong decay
    small = [x[:1, :, :16] for x in (q, k, v, ld, om)]
    _, jpgr = _jax_grads(*small, 8, "pallas_interpret")
    leaves = [_t(x).requires_grad_(True) for x in small[:4]]
    grads = torch.autograd.grad(
        tops.gla_causal(*leaves, 1.0, 0.5, 8, "torch"), leaves, _t(small[4]))
    for name, got, want in zip(names, grads, jpgr):
        _assert_rel(got, want, GRAD_REL, f"vs pallas {name}")


# ---------------------------------------------------------------------------
# Decode: the fused step, state in place
# ---------------------------------------------------------------------------

def test_fused_decode_step_matches_jax():
    """B=3, Hkv=2, D=8, G in {1, 4}, f32 and bf16, both decay regimes:
    the "torch" and "ref" impls of the fused family against the
    reference's `gla_decode_step_fused` ("xla" and "pallas_interpret"),
    ("pallas_interpret" once per regime), the state updated in place;
    the unfused functional step against the reference's; a row whose
    normalizer is exactly zero gives 0."""
    for regime in REGIMES:
        for g in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                rng = np.random.default_rng(3)
                b, hkv, d = 3, 2, 8
                s = rng.standard_normal((b, hkv, d, d + 1)).astype(
                    np.float32)
                p = np.abs(rng.standard_normal((b, hkv, d + 1))).astype(
                    np.float32)
                q = _unit_rows(rng, (b, hkv * g, d))
                k = _unit_rows(rng, (b, hkv, d))
                v = rng.standard_normal((b, hkv, d)).astype(np.float32)
                ld = _log_decay(rng, (b, hkv), regime)
                # slot 0, KV head 0: after the step p[dv] == 0 and q == 0,
                # so the normalizer is exactly 0 (numerators are not)
                ld[0, 0] = 0.0
                p[0, 0, d] = -1.0
                q[0, :g] = 0.0
                jdt = {torch.float32: jnp.float32,
                       torch.bfloat16: jnp.bfloat16}[dtype]
                jst = jgla.GLAState(jnp.asarray(s), jnp.asarray(p))
                jargs = [jnp.asarray(x, jdt) for x in (q, k, v)]
                # the Pallas kernel in interpret mode once per regime
                jimpls = ("xla", "pallas_interpret") if (
                    g == 4 and dtype == torch.float32) else ("xla",)
                want = {impl: jops.gla_decode_step_fused(
                    jst, *jargs, jnp.asarray(ld), 1.0, 0.5, backend=impl)
                    for impl in jimpls}
                rel = F32_REL if dtype == torch.float32 else BF16_REL
                for impl in ("torch", "ref"):
                    st = tgla.GLAState(_t(s), _t(p))
                    ptrs = (st.s.data_ptr(), st.p.data_ptr())
                    st2, o = tops.gla_decode_step_fused(
                        st, *(_t(x, dtype) for x in (q, k, v)), _t(ld), 1.0,
                        0.5, backend=impl)
                    assert st2 is st and (st.s.data_ptr(),
                                          st.p.data_ptr()) == ptrs
                    assert o.dtype == dtype
                    assert float(o[0, :g].abs().max()) == 0.0
                    for jimpl, (jnew, jo) in want.items():
                        label = f"{regime} g={g} {dtype} {impl}/{jimpl}"
                        _assert_rel(o, jo, rel, label + " o")
                        _assert_rel(st.s, jnew.s, F32_REL, label + " s")
                        _assert_rel(st.p, jnew.p, F32_REL, label + " p")
                # the unfused functional step against the reference's
                new, o = tops.gla_decode_step(
                    tgla.GLAState(_t(s), _t(p)),
                    *(_t(x, dtype) for x in (q, k, v)), _t(ld), 1.0, 0.5)
                jnew, jo = jops.gla_decode_step(jst, *jargs,
                                                jnp.asarray(ld), 1.0, 0.5)
                _assert_rel(o, jo, rel, f"{regime} g={g} unfused o")
                _assert_rel(new.s, jnew.s, F32_REL,
                            f"{regime} g={g} unfused s")


# ---------------------------------------------------------------------------
# pythia smoke with the gla backend
# ---------------------------------------------------------------------------

def _smoke():
    return (jget_config("pythia-1.4b", smoke=True, attention_backend="gla"),
            get_config("pythia-1.4b", smoke=True, attention_backend="gla"))


@pytest.fixture(scope="module")
def ref():
    """The reference's pythia smoke (gla) params, tokens, prefill and
    decode logits, loss and grads, built once."""
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


def test_pythia_smoke_gla_matches_jax(ref):
    """`params_from_jax` carries every layer's gate `wg` (weight and
    bias) across; prefill and 4 decode steps' logits (fused and unfused
    decode), the loss and every param grad within MODEL_REL."""
    _, cfg = _smoke()
    params = params_from_jax(cfg, ref["params"], device="cpu")
    for i in range(cfg.num_layers):
        wg = params["blocks"][i]["mixer"]["wg"]
        assert tuple(wg["w"].shape) == (cfg.d_model, cfg.num_kv_heads)
        for key in ("w", "b"):
            assert np.array_equal(wg[key].numpy(), ref["params"]["blocks"][
                "mixer"]["wg"][key][i])
    tokens = torch.from_numpy(ref["tokens"])
    for fused in (True, False):
        c = dataclasses.replace(cfg, la=dataclasses.replace(
            cfg.la, fused_decode=fused))
        cache = tmdl.init_cache(c, 2, 32, device="cpu")
        logits, cache = tmdl.prefill(params, c, {"tokens": tokens[:, :17]},
                                     cache)
        out = [logits]
        for i in range(17, 21):
            logits, cache = tmdl.decode_step(params, c, cache, tokens[:, i])
            out.append(logits)
        for i, (got, want) in enumerate(zip(out, ref["logits"])):
            _assert_rel(got, want, MODEL_REL, f"fused={fused} step {i}")
    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = tmdl.loss_fn(params, cfg, {"tokens": tokens})
    assert abs(float(loss.detach()) - ref["loss"]) \
        <= MODEL_REL * abs(ref["loss"])
    grads = torch.autograd.grad(loss, [t for _, t in named])
    assert any(p.endswith("mixer.wg.b") for p, _ in named)
    for (path, _), g in zip(named, grads):
        _assert_rel(g, _jax_leaf(ref["grads"], path), MODEL_REL, path)


# ---------------------------------------------------------------------------
# Serving: the engine, contiguous and paged
# ---------------------------------------------------------------------------

# slots finish at different steps; with 2 slots for 3 requests the page
# request 0 frees goes to request 2 (LIFO) while request 1 still decodes
_REQS = [(0, list(range(3, 12)), 2), (1, list(range(20, 45)), 5),
         (2, list(range(7, 16)), 3)]
_CHUNKS = (None, 5)


@pytest.fixture(scope="module")
def engine_ref(ref):
    jcfg, _ = _smoke()
    params = jax.tree.map(jnp.asarray, ref["params"])
    return {chunk: run_engine_greedy(jcfg, params, reqs=_REQS, max_slots=2,
                                     prefill_chunk=chunk)[0]
            for chunk in _CHUNKS}


def _run(cfg, params, **kw):
    eng = Engine(cfg, params, max_slots=2, max_len=64, eos_id=-1,
                 device="cpu", **kw)
    for rid, prompt, mn in _REQS:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mn))
    return eng


def test_gla_engine_greedy_tokens_identical_to_jax(ref, engine_ref):
    """One-shot and chunked prefill (window 5), fused decode, against the
    JAX Engine on the same weights."""
    _, cfg = _smoke()
    params = params_from_jax(cfg, ref["params"], device="cpu")
    for chunk in _CHUNKS:
        assert _run(cfg, params, prefill_chunk=chunk).run() \
            == engine_ref[chunk], chunk


def test_paged_gla_engine(ref, engine_ref):
    """The state-paged engine: greedy tokens identical to the contiguous
    path's (hence the JAX Engine's), one-shot and chunked; one state page
    per request whatever its prompt length; request 2 reuses request 0's
    freed page, which `_place` zeroes first (its stale state would
    otherwise seed request 2's recurrence); every page back and every
    table row at the sink at the end; `state_page_bytes` and `page_bytes`
    exactly as in JAX; PagedAdmission buys state pages; a request the
    arena can never hold is refused at submit, naming state pages."""
    jcfg, cfg = _smoke()
    params = params_from_jax(cfg, ref["params"], device="cpu")
    for chunk in _CHUNKS:
        eng = _run(cfg, params, prefill_chunk=chunk, page_size=16)
        assert eng.pool.num_pages == 2     # 2 slots x 1 page (+ the sink)
        tables, got = {}, {}
        while eng.scheduler.has_work():
            held = {rid for rid, _, _ in _REQS if eng.pool.holds(rid)}
            for out in eng.step():
                if out.finished:
                    got[out.rid] = eng.request(out.rid).generated
            for rid, _, _ in _REQS:
                if eng.pool.holds(rid) and rid not in held:
                    # admitted in this step: one page, whatever its prompt
                    tables[rid] = eng.pool.table(rid)
                    assert len(tables[rid]) == 1
        assert got == engine_ref[chunk], chunk
        assert tables[2] == tables[0], "request 2 reuses request 0's page"
        stats = eng.page_stats()
        assert stats["pages_in_use"] == 0 and stats["free_pages"] == 2
        for layer in eng.cache["blocks"]:
            assert torch.equal(layer.page_table,
                               torch.full((2, 1), 2, dtype=torch.int32))
    # the wipe, directly: a dirty page handed to a new request is zero
    # before its first window
    eng = Engine(cfg, params, max_slots=1, max_len=64, eos_id=-1,
                 page_size=16, device="cpu")
    for layer in eng.cache["blocks"]:
        layer.s_pages.fill_(7.0)
        layer.p_pages.fill_(7.0)
    eng.submit(Request(rid=0, prompt=list(range(3, 40)), max_new_tokens=2))
    for slot, req in eng.scheduler.admit(eng._can_admit):
        eng._place(slot, req)
    page = eng.pool.table(0)[0]
    for layer in eng.cache["blocks"]:
        assert float(layer.s_pages[page].abs().max()) == 0.0
        assert float(layer.p_pages[page].abs().max()) == 0.0
        assert float(layer.s_pages[1].min()) == 7.0     # the sink: untouched
    # byte accounting against the reference
    for jc, tc in ((jcfg, cfg), (jget_config("pythia-1.4b",
                                             attention_backend="gla"),
                                 get_config("pythia-1.4b",
                                            attention_backend="gla"))):
        assert tcache.state_page_bytes(tc) == jcache.state_page_bytes(jc)
        for ps in (1, 16):
            assert tcache.page_bytes(tc, ps) == jcache.page_bytes(jc, ps) \
                == tcache.state_page_bytes(tc)
        assert tcache.per_slot_bytes(tc, 64) == jcache.per_slot_bytes(jc, 64)
    assert tcache.state_page_bytes(get_config(
        "pythia-1.4b", attention_backend="gla")) == 25_560_576
    pol = tpaging.PagedAdmission(5 * tcache.state_page_bytes(cfg),
                                 page_size=16, max_slots=4)
    eng = Engine(cfg, params, max_len=64, eos_id=-1, policy=pol,
                 device="cpu")
    assert eng.pool.num_pages == 4 and eng.num_slots == 4
    eng = Engine(cfg, params, max_slots=2, max_len=64, eos_id=-1,
                 page_size=16, num_pages=1 + 1, device="cpu")
    eng.pool.num_pages = 0     # a request needs 1 page; none can exist
    with pytest.raises(ValueError, match="state pages"):
        eng.submit(Request(rid=0, prompt=list(range(3, 9)),
                           max_new_tokens=2))


# ---------------------------------------------------------------------------
# The CUDA kernels (card only)
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_cuda_gla_kernels_match_plain():
    """gla_decode_fused (G in {1, 4}, state in place, a zero normalizer),
    gla_fwd, gla_bwd_q and gla_bwd_kv (odd N = 61, D = 32, G in {1, 4})
    against their plain versions on the card, f32 and bf16, both decay
    regimes; at log_decay = 0 the gated kernels against the linear ones
    within a few f32 ulps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    for regime in REGIMES:
        for g in (1, 4):
            for dtype in (torch.float32, torch.bfloat16):
                rel = GPU_F32_REL if dtype == torch.float32 else BF16_REL
                rng = np.random.default_rng(5)
                q, k, v, ld, om = _seq(rng, 2, 2 * g, 2, 61, 32, regime)
                q, k, v = (_t(x, dtype).to(dev) for x in (q, k, v))
                ld, om = _t(ld).to(dev), _t(om).to(dev)
                before = dict(tkgla.launches)
                o_k, g_k = tkgla.gla_fwd_cuda(q, k, v, ld, 1.0, 0.5)
                o_t, g_t = tkgla.gla_fwd_torch(q, k, v, ld, 1.0, 0.5, 16)
                om_hat, h_vec = tchunked.la_bwd_prep(o_t, g_t, om)
                dq_k = tkgla.gla_bwd_q_cuda(k, v, ld, om_hat, h_vec, 0.5)
                dk_k, dva_k = tkgla.gla_bwd_kv_cuda(q, k, v, ld, om_hat,
                                                    h_vec, 1.0, 0.5)
                torch.cuda.synchronize()
                assert {n: tkgla.launches[n] - before[n] for n in before} \
                    == {"gla_fwd": 1, "gla_bwd_q": 1, "gla_bwd_kv": 1}
                dq_t = tkgla.gla_bwd_q_torch(k, v, ld, om_hat, h_vec, 0.5,
                                             16)
                dk_t, dva_t = tkgla.gla_bwd_kv_torch(q, k, v, ld, om_hat,
                                                     h_vec, 1.0, 0.5, 16)
                label = f"{regime} g={g} {dtype}"
                for name, got, want, r in (
                        ("o", o_k, o_t, rel), ("g", g_k, g_t, GPU_F32_REL),
                        ("dq", dq_k, dq_t, rel), ("dk", dk_k, dk_t, rel),
                        ("dva", dva_k, dva_t, GPU_F32_REL)):
                    _assert_rel(got, want.float().cpu().numpy(), r,
                                f"{label} {name}")
                _, dld_k = tgla.gla_bwd_epilogue(v, dva_k, ld)
                _, dld_t = tgla.gla_bwd_epilogue(v, dva_t, ld)
                _assert_rel(dld_k, dld_t.cpu().numpy(), GPU_F32_REL,
                            f"{label} dld")
                # decode: state in place, a zero normalizer
                b_, hkv, d = 3, 2, 32
                s = torch.randn((b_, hkv, d, d + 1), device=dev)
                p = torch.randn((b_, hkv, d + 1), device=dev).abs()
                qd = _t(_unit_rows(rng, (b_, hkv * g, d)), dtype).to(dev)
                kd = _t(_unit_rows(rng, (b_, hkv, d)), dtype).to(dev)
                vd = torch.randn((b_, hkv, d), device=dev).to(dtype)
                ldd = _t(_log_decay(rng, (b_, hkv), regime)).to(dev)
                ldd[0, 0], p[0, 0, d], qd[0, :g] = 0.0, -1.0, 0.0
                s_k, p_k = s.clone(), p.clone()
                ptr = s_k.data_ptr()
                o_k = tdf.gla_decode_fused_cuda(s_k, p_k, qd, kd, vd, ldd,
                                                1.0, 0.5)
                torch.cuda.synchronize()
                o_t = tdf.gla_decode_fused_torch(s, p, qd, kd, vd, ldd, 1.0,
                                                 0.5)
                assert s_k.data_ptr() == ptr
                _assert_rel(o_k, o_t.float().cpu().numpy(), rel,
                            f"{label} decode o")
                _assert_rel(s_k, s.cpu().numpy(), 1e-5, f"{label} decode s")
                assert float(o_k[0, :g].abs().max()) == 0.0
    # log_decay = 0: the gated kernels reduce to the linear ones
    rng = np.random.default_rng(6)
    q, k, v, _, om = _seq(rng, 2, 4, 2, 61, 32, "trained")
    q, k, v, om = (_t(x).to(dev) for x in (q, k, v, om))
    zero = torch.zeros((2, 2, 61), device=dev)
    o_g, g_g = tkgla.gla_fwd_cuda(q, k, v, zero, 1.0, 0.5)
    o_l, g_l = tkla.la_fwd_cuda(q, k, v, 1.0, 0.5)
    om_hat, h_vec = tchunked.la_bwd_prep(o_l, g_l, om)
    dk_g, dva_g = tkgla.gla_bwd_kv_cuda(q, k, v, zero, om_hat, h_vec, 1.0,
                                        0.5)
    dk_l, dv_l = tkla.la_bwd_kv_cuda(q, k, v, om_hat, h_vec, 1.0, 0.5)
    for name, got, want in (
            ("o", o_g, o_l), ("g", g_g, g_l),
            ("dq", tkgla.gla_bwd_q_cuda(k, v, zero, om_hat, h_vec, 0.5),
             tkla.la_bwd_q_cuda(k, v, om_hat, h_vec, 0.5)),
            ("dk", dk_g, dk_l), ("dv", dva_g[..., :32], dv_l)):
        _assert_rel(got, want.cpu().numpy(), 1e-6, f"ld=0 {name}")
