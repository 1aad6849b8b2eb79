"""The port's MoE family and DeepSeek's MLA mixer, held against the JAX
package on the CPU.

  * `moe_apply` (the routed-expert FFN with shared experts) with capacity
    drops and dropless: the output, the Switch aux loss and the grads of
    x and every param;
  * the MLA mixer's apply, prefill (output and LA state) and decode;
  * the LA plain path at Dk != Dv (the MLA heads' shape, small) against
    the reference's `la_causal` (xla and Pallas interpret): o and grads;
  * the smoke configs of moonshot-v1-16b-a3b and deepseek-v2-236b (3
    layers: 1 dense prefix + 2 MoE): the loss, every param grad, the
    prefill logits and 4 greedy decode steps;
  * the `Engine` on moonshot smoke against the JAX engine: greedy tokens
    per request, and one `snapshot` preemption, whose slot snapshot
    carries the prefix caches.

Every value within REL = 1e-4 of the reference's largest |value| (each
grad of its own).  Inputs come from numpy seeds and the reference's random
parameters are carried over by `params_from_jax`.  The JAX reference runs
on the CPU (pinned before it first runs) and each reference is built once
per module.
"""
import dataclasses

import jax

# the reference on the CPU, where an f32 dot is an f32 dot (JAX on a card
# computes it in TF32 by default)
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.mixers import get_backend as jget_backend  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.obs import ServeTracer as JTracer  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.mixers import get_backend  # noqa: E402
from repro_torch.mixers.cache import init_state  # noqa: E402
from repro_torch.models import model as tmdl  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.obs import ServeTracer  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REL = 1e-4
B, N, STEPS = 2, 11, 4
MOONSHOT, DEEPSEEK = "moonshot-v1-16b-a3b", "deepseek-v2-236b"


def _assert_rel(got, want, label=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{label}: max err {err} > {REL} * {scale}"


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    """A numpy tree (dicts) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax_run(jcfg, jparams, tokens):
    """The reference's loss and grads over all tokens, then the prefill
    of the first N and STEPS greedy decode steps."""
    batch = {"tokens": jnp.asarray(tokens)}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, jcfg, batch), has_aux=True))(jparams)
    cache = jmdl.init_cache(jcfg, B, N + STEPS)
    logits, cache = jmdl.prefill(jparams, jcfg,
                                 {"tokens": jnp.asarray(tokens[:, :N])},
                                 cache)
    out, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = jmdl.decode_step(jparams, jcfg, cache, tok)
        out.append(np.asarray(logits))
    return float(loss), _np(grads), out, toks


@pytest.fixture(scope="module")
def refs():
    """arch -> (jax cfg, jax params, port cfg, port params, tokens), each
    built once; the reference's run is built on first use."""
    built, runs = {}, {}

    def get(arch, run=False):
        if arch not in built:
            jcfg = jget_config(arch, smoke=True)
            cfg = get_config(arch, smoke=True)
            jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
            params = params_from_jax(cfg, _np(jparams), device="cpu")
            tokens = np.random.default_rng(0).integers(
                3, jcfg.vocab_size, size=(B, N + STEPS)).astype(np.int32)
            built[arch] = (jcfg, jparams, cfg, params, tokens)
        if run and arch not in runs:
            runs[arch] = _jax_run(*built[arch][:2], built[arch][4])
        return built[arch] + ((runs[arch],) if run else ())
    return get


@pytest.mark.parametrize("dropless", [False, True])
def test_moe_apply_output_aux_and_grads_match_jax(refs, dropless):
    """Capacity factor 0.5 on 2 x 11 tokens, 8 experts, top 2: capacity 3
    of the 44 replicas' ~5.5 an expert, so replicas drop (dropless:
    none); two shared experts; the router f32."""
    jcfg, jparams, cfg, params, _ = refs(MOONSHOT)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.5))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=0.5))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["ffn"])
    p = params["blocks"][0]["ffn"]
    assert sorted(p) == ["experts", "router", "shared"]
    assert p["router"]["w"].dtype == torch.float32
    x = np.random.default_rng(1).standard_normal(
        (B, N, cfg.d_model)).astype(np.float32)
    w = np.random.default_rng(2).standard_normal(x.shape).astype(np.float32)

    def jloss(jp_, x_):
        y, aux = jmoe.moe_apply(jp_, jcfg, x_, dropless=dropless)
        return jnp.sum(y * w) + 3.0 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(jp, jnp.asarray(x))
    tokens = B * N
    cap = tmoe.capacity(cfg, tokens, dropless)
    assert cap == (tokens * 2 if dropless else 3)
    _, ids, _ = tmoe.route(p, cfg, torch.from_numpy(x).reshape(tokens, -1))
    counts = np.bincount(ids.reshape(-1).numpy(), minlength=8)
    assert (counts.max() > cap) != dropless, counts

    named = named_leaves(p)
    leaves = iter([t.clone().requires_grad_(True) for _, t in named])
    tree = {k: {kk: next(leaves) for kk in v} for k, v in p.items()}
    leaves = [t for _, t in named_leaves(tree)]
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.moe_apply(tree, cfg, xt, dropless=dropless)
    _assert_rel(y, jy, "y")
    _assert_rel(aux, jaux, "aux")
    (torch.sum(y * torch.from_numpy(w)) + 3.0 * aux).backward()
    _assert_rel(xt.grad, jgx, "dx")
    for (path, want), t in zip(named_leaves(_t(_np(jgp))), leaves):
        _assert_rel(t.grad, want.numpy(), f"d{path}")


def test_mla_apply_prefill_and_decode_match_jax(refs):
    """deepseek smoke's MLA mixer (4 heads, q/k nope 16 + rope 8, v 16):
    training's apply, a prefill against a warm state and one decode
    step, output and state."""
    jcfg, jparams, cfg, params, _ = refs(DEEPSEEK)
    jb, b = jget_backend(jcfg), get_backend(cfg)
    assert b.name == "mla"
    japply = jax.jit(lambda *a: jb.apply(*a[:1], jcfg, *a[1:]))
    jprefill = jax.jit(lambda *a: jb.prefill(*a[:1], jcfg, *a[1:]))
    jdecode = jax.jit(lambda *a: jb.decode(*a[:1], jcfg, *a[1:]))
    jp = jax.tree.map(lambda a: a[0], jparams["blocks"]["mixer"])
    p = params["blocks"][0]["mixer"]
    assert sorted(p) == sorted(jp)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, N, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(N, dtype=np.int32) + 5, (B, N)).copy()
    _assert_rel(b.apply(p, cfg, torch.from_numpy(x), torch.from_numpy(pos)),
                japply(jp, jnp.asarray(x), jnp.asarray(pos)),
                "apply")
    jstate = jb.init_cache(jcfg, B, 32)
    state = b.init_cache(cfg, B, 32, device="cpu")
    assert tuple(state.s.shape) == (B, 4, 24, 17) == jstate.s.shape
    # a warm state: one prefill, then a window continuing it
    jo, jstate = jprefill(jp, jnp.asarray(x[:, :5]),
                          jnp.asarray(pos[:, :5]), jstate)
    o, state = b.prefill(p, cfg, torch.from_numpy(x[:, :5]),
                         torch.from_numpy(pos[:, :5]), state)
    _assert_rel(o, jo, "prefill")
    jo, jstate = jprefill(jp, jnp.asarray(x[:, 5:10]),
                          jnp.asarray(pos[:, 5:10]), jstate)
    o, state = b.prefill(p, cfg, torch.from_numpy(x[:, 5:10]),
                         torch.from_numpy(pos[:, 5:10]), state)
    _assert_rel(o, jo, "prefill window")
    _assert_rel(state.s, jstate.s, "state s")
    _assert_rel(state.p, jstate.p, "state p")
    jo, jstate = jdecode(jp, jnp.asarray(x[:, 10:]),
                         jnp.asarray(pos[:, 10:]), jstate)
    o, state = b.decode(p, cfg, torch.from_numpy(x[:, 10:]),
                        torch.from_numpy(pos[:, 10:]), state)
    _assert_rel(o, jo, "decode")
    _assert_rel(state.s, jstate.s, "decode state s")
    _assert_rel(state.p, jstate.p, "decode state p")


def test_la_plain_path_at_dk_ne_dv_matches_jax():
    """The LA autograd Function's plain path at (Dk, Dv) = (24, 16) and GQA
    G = 2, odd N, against the reference's la_causal in xla and in Pallas
    interpret mode: o and dq, dk, dv; and the LA state a (Dk, Dv + 1)
    slab."""
    rng = np.random.default_rng(4)
    b, h, hkv, n, dk, dv = 2, 4, 2, 37, 24, 16

    def unit(*shape):
        z = rng.standard_normal(shape).astype(np.float32)
        return z / np.linalg.norm(z, axis=-1, keepdims=True)

    q, k = unit(b, h, n, dk), unit(b, hkv, n, dk)
    v = rng.standard_normal((b, hkv, n, dv)).astype(np.float32)
    om = rng.standard_normal((b, h, n, dv)).astype(np.float32)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o = tops.la_causal(*leaves, 1.0, 0.5, 16, "torch")
    o.backward(torch.from_numpy(om))
    for impl in ("xla", "pallas_interpret"):
        @jax.jit
        def run(q_, k_, v_, om_):
            jo, vjp = jax.vjp(
                lambda *a: jops.la_causal(*a, 1.0, 0.5, 16, impl), q_, k_,
                v_)
            return jo, vjp(om_)

        jo, jgrads = run(*(jnp.asarray(a) for a in (q, k, v, om)))
        _assert_rel(o, jo, f"o {impl}")
        for name, t, want in zip(("dq", "dk", "dv"), leaves, jgrads):
            _assert_rel(t.grad, want, f"{name} {impl}")
    assert tuple(init_state(b, hkv, dk, dv, device="cpu").s.shape) == (
        b, hkv, dk, dv + 1)


def _check_arch(refs, arch):
    """The port's loss, every grad, prefill logits and greedy decode
    against the reference's run."""
    _, _, cfg, params, tokens, (jloss, jgrads, jlogits, jtoks) = refs(
        arch, run=True)
    assert len(params["prefix_blocks"]) == cfg.moe.first_dense_layers == 1
    assert "router" not in params["prefix_blocks"][0]["ffn"]
    assert len(params["blocks"]) == cfg.num_layers - 1
    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss, parts = tmdl.loss_fn(params, cfg,
                               {"tokens": torch.from_numpy(tokens).long()})
    grads = torch.autograd.grad(loss, [t for _, t in named])
    for _, t in named:
        t.requires_grad_(False)
    assert float(parts["aux"].detach()) > 0.0
    _assert_rel(loss, np.float32(jloss), f"{arch} loss")
    want = named_leaves(params_from_jax(cfg, jgrads, device="cpu"))
    assert [p for p, _ in want] == [p for p, _ in named]
    for (path, w), g in zip(want, grads):
        _assert_rel(g, w.numpy(), f"{arch} grad {path}")

    t = torch.from_numpy(tokens).long()
    cache = tmdl.init_cache(cfg, B, N + STEPS, device="cpu")
    assert len(cache["prefix"]) == 1 and len(cache["blocks"]) == 2
    logits, cache = tmdl.prefill(params, cfg, {"tokens": t[:, :N]}, cache)
    _assert_rel(logits, jlogits[0], f"{arch} prefill")
    for i in range(STEPS):
        tok = logits.argmax(-1)
        assert tok.tolist() == jtoks[i].tolist(), (arch, i)
        logits, cache = tmdl.decode_step(params, cfg, cache, tok)
        _assert_rel(logits, jlogits[i + 1], f"{arch} decode step {i}")
    assert cache["pos"].tolist() == [N + STEPS] * B


@pytest.mark.parametrize("arch", [MOONSHOT, DEEPSEEK])
def test_moe_arch_loss_grads_and_greedy_decode_match_jax(refs, arch):
    _check_arch(refs, arch)


PROMPTS = [list(range(3, 15)), list(range(20, 27)), list(range(40, 49))]


def _engine_run(pkg, cfg, params, script, **kw):
    """Greedy tokens per rid and the preemption policies of a traced
    engine of `pkg` (the port's or the reference's) driven by
    `script`."""
    engine_cls, request_cls, tracer_cls, extra = pkg
    tr = tracer_cls()
    eng = engine_cls(cfg, params, max_len=64, eos_id=-1, prefill_chunk=4,
                     tracer=tr, **extra, **kw)
    for op, arg in script:
        if op == "submit":
            eng.submit(request_cls(**arg))
        else:
            for _ in range(arg):
                eng.step()
    while eng.scheduler.has_work():
        eng.step()
    recs = {r.rid: r for r in tr.records()}
    return ({rid: list(eng.request(rid).generated) for rid in recs},
            eng.preemption_count,
            {rid: ([p for _, _, p in r.preempt_events],
                   [p for _, _, p in r.resume_events])
             for rid, r in recs.items() if r.preempt_events})


def test_engine_tokens_and_moonshot_snapshot_match_jax_engine(refs):
    """moonshot smoke through both engines: three requests on two slots
    with prompts longer than a prefill window (the windows decide which
    replicas the capacity drops), then rid 1 at priority 5 evicting rid 0
    from the only slot (`snapshot`, the prefix caches with the stack's);
    the engine refuses paging where the cache has dense-prefix layers."""
    port = (Engine, Request, ServeTracer, {"device": "cpu"})
    ref = (JEngine, JRequest, JTracer, {})
    batch = [("submit", dict(rid=i, prompt=p, max_new_tokens=5))
             for i, p in enumerate(PROMPTS)]
    preempt = [("submit", dict(rid=0, prompt=PROMPTS[0], max_new_tokens=8)),
               ("steps", 6),
               ("submit", dict(rid=1, prompt=PROMPTS[1], max_new_tokens=3,
                               priority=5))]
    jcfg, jparams, cfg, params = refs(MOONSHOT)[:4]
    for script, kw in ((batch, {"max_slots": 2}), (preempt,
                                                   {"max_slots": 1})):
        want = _engine_run(ref, jcfg, jparams, script, **kw)
        got = _engine_run(port, cfg, params, script, **kw)
        assert got == want, (got, want)
        assert all(len(got[0][a["rid"]]) == a["max_new_tokens"]
                   for op, a in script if op == "submit")
    assert got[1] == 1 and got[2] == {0: (["snapshot"], ["snapshot"])}
    soft = dataclasses.replace(cfg, attention_backend="softmax")
    with pytest.raises(NotImplementedError, match="prefix"):
        Engine(soft, tmdl.init_params(soft, seed=0, device="cpu"),
               max_slots=2, max_len=32, page_size=4, device="cpu")
