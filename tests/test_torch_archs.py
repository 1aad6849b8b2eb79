"""The port's other dense architectures and the zamba2 hybrid, held against
the JAX package on the CPU.

Smoke configs (2 layers, d_model 64, f32; zamba2: 2 groups of 2 Mamba-2
blocks, the shared attention block after each, 1 tail block) with the
reference's random parameters carried over by `params_from_jax`, token
ids from a numpy seed:

  * swiglu `mlp_apply`, a sequential-residual block (qwen2.5's first)
    and the logit softcap c tanh(logits / c) of `forward_logits` and the
    last-token logits;
  * qwen2.5-3b, stablelm-1.6b, chatglm3-6b and granite-20b: the loss and
    every param grad, the prefill logits and 4 greedy decode steps (each
    step's logits, and the same greedy tokens);
  * zamba2-7b: the same, through its groups, shared block and tail;
  * the `Engine` on zamba2 and qwen2.5 against the JAX engine: the same
    greedy tokens per request, and on zamba2 one `snapshot` preemption;
    the serving launcher refuses the backends whose card kernels do not
    take an architecture's shapes.

Every value within REL = 1e-4 of the reference's largest |value| (each
grad of its own: float32 rounding through a few layers).  The JAX
reference runs on the CPU (pinned before it first runs) and each
reference is built once per module.
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
from repro.models import blocks as jblk  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.obs import ServeTracer as JTracer  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import backend_refusal  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.models import blocks as tblk  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmdl  # noqa: E402
from repro_torch.obs import ServeTracer  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REL = 1e-4
B, N, STEPS = 2, 11, 4
DENSE = ("qwen2.5-3b", "stablelm-1.6b", "chatglm3-6b", "granite-20b")


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


def _jax_run(jcfg, jparams, tokens):
    """The reference's loss and grads over all tokens, then the prefill
    of the first N and STEPS greedy decode steps: (loss, grads, [logits
    of the prefill and each step], [greedy tokens])."""
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
    """arch -> (jax cfg, jax params, port cfg, port params, tokens, the
    reference's run), each built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg = jget_config(arch, smoke=True)
            cfg = get_config(arch, smoke=True)
            jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
            params = params_from_jax(cfg, _np(jparams), device="cpu")
            tokens = np.random.default_rng(0).integers(
                3, jcfg.vocab_size, size=(B, N + STEPS)).astype(np.int32)
            built[arch] = (jcfg, jparams, cfg, params, tokens,
                           _jax_run(jcfg, jparams, tokens))
        return built[arch]
    return get


def _check_arch(refs, arch):
    """The port's loss, every grad, prefill logits and greedy decode
    against the reference's run."""
    _, _, cfg, params, tokens, (jloss, jgrads, jlogits, jtoks) = refs(arch)
    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = tmdl.loss_fn(params, cfg,
                           {"tokens": torch.from_numpy(tokens).long()})
    grads = torch.autograd.grad(loss, [t for _, t in named])
    for _, t in named:
        t.requires_grad_(False)
    _assert_rel(loss, np.float32(jloss), f"{arch} loss")
    want = named_leaves(params_from_jax(cfg, jgrads, device="cpu"))
    assert [p for p, _ in want] == [p for p, _ in named]
    for (path, w), g in zip(want, grads):
        _assert_rel(g, w.numpy(), f"{arch} grad {path}")

    t = torch.from_numpy(tokens).long()
    cache = tmdl.init_cache(cfg, B, N + STEPS, device="cpu")
    logits, cache = tmdl.prefill(params, cfg, {"tokens": t[:, :N]}, cache)
    _assert_rel(logits, jlogits[0], f"{arch} prefill")
    for i in range(STEPS):
        tok = logits.argmax(-1)
        assert tok.tolist() == jtoks[i].tolist(), (arch, i)
        logits, cache = tmdl.decode_step(params, cfg, cache, tok)
        _assert_rel(logits, jlogits[i + 1], f"{arch} decode step {i}")
    assert cache["pos"].tolist() == [N + STEPS] * B


def test_swiglu_sequential_block_and_softcap_match_jax(refs):
    jcfg, jparams, cfg, params, tokens, _ = refs("qwen2.5-3b")
    assert cfg.mlp_act == "swiglu" and not cfg.parallel_residual
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, N, cfg.d_model)).astype(np.float32)
    # swiglu: silu(x wg) * (x wi), then wo, with the reference's leaves
    jffn = jax.tree.map(lambda a: a[0], jparams["blocks"]["ffn"])
    assert sorted(params["blocks"][0]["ffn"]) == ["wg", "wi", "wo"]
    _assert_rel(tcommon.mlp_apply(params["blocks"][0]["ffn"],
                                  torch.from_numpy(x), "swiglu"),
                jcommon.mlp_apply(jffn, jnp.asarray(x), "swiglu"), "swiglu")
    # a sequential-residual block: x + attn(ln1 x), then + ffn(ln2 .)
    pos = np.broadcast_to(np.arange(N, dtype=np.int32), (B, N))
    jlp = jax.tree.map(lambda a: a[0], jparams["blocks"])
    want, _ = jblk.block_apply(jlp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got, aux = tblk.block_apply(params["blocks"][0], cfg,
                                torch.from_numpy(x),
                                torch.from_numpy(pos.copy()))
    _assert_rel(got, want, "sequential block")
    assert float(aux) == 0.0   # a dense FFN has no aux loss
    # the logit softcap, on forward_logits and the last-token logits; the
    # loss does not apply it (as the reference's)
    # (a cap below the smoke logits' largest |value|, ~0.6, so it bends)
    jcap = dataclasses.replace(jcfg, logit_softcap=0.25)
    cap = dataclasses.replace(cfg, logit_softcap=0.25)
    t = tokens[:, :N]
    want = np.asarray(jmdl.forward_logits(jparams, jcap,
                                          {"tokens": jnp.asarray(t)}))
    got = tmdl.forward_logits(params, cap, {"tokens": torch.from_numpy(t)})
    _assert_rel(got, want, "softcapped logits")
    assert float(got.abs().max()) < 0.25 < float(
        tmdl.forward_logits(params, cfg,
                            {"tokens": torch.from_numpy(t)}).abs().max())
    jlast, _ = jmdl.prefill(jparams, jcap, {"tokens": jnp.asarray(t)},
                            jmdl.init_cache(jcap, B, N))
    last, _ = tmdl.prefill(params, cap, {"tokens": torch.from_numpy(t)},
                           tmdl.init_cache(cap, B, N, device="cpu"))
    _assert_rel(last, jlast, "softcapped last-token logits")
    _assert_rel(last, got[:, -1].detach().numpy(), "last vs forward")
    batch = {"tokens": torch.from_numpy(tokens).long()}
    assert torch.equal(tmdl.loss_fn(params, cap, batch)[0],
                       tmdl.loss_fn(params, cfg, batch)[0])


@pytest.mark.parametrize("arch", DENSE)
def test_dense_arch_loss_grads_and_greedy_decode_match_jax(refs, arch):
    _check_arch(refs, arch)


def test_zamba2_hybrid_loss_grads_and_greedy_decode_match_jax(refs):
    cfg, params = refs("zamba2-7b")[2:4]
    g, m, t = (cfg.hybrid_groups, cfg.hybrid_mamba_per_group,
               cfg.hybrid_tail)
    assert [len(x) for x in params["mamba_groups"]] == [m] * g
    assert len(params["tail"]) == t and "blocks" not in params
    cache = tmdl.init_cache(cfg, B, N, device="cpu")
    assert len(cache["shared"]) == g and len(cache["tail"]) == t
    _check_arch(refs, "zamba2-7b")
    # remat (per block and per group) changes no value
    jcfg, jparams, _, _, tokens, (jloss, _, _, _) = refs("zamba2-7b")
    loss, _ = tmdl.loss_fn(params, dataclasses.replace(cfg, remat=True),
                           {"tokens": torch.from_numpy(tokens).long()})
    _assert_rel(loss, np.float32(jloss), "zamba2 loss, remat")


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


def test_engine_tokens_and_zamba2_snapshot_match_jax_engine(refs):
    port = (Engine, Request, ServeTracer, {"device": "cpu"})
    ref = (JEngine, JRequest, JTracer, {})
    batch = [("submit", dict(rid=i, prompt=p, max_new_tokens=5))
             for i, p in enumerate(PROMPTS)]
    # rid 1 (priority 5) arrives once rid 0 decodes on the only slot
    preempt = [("submit", dict(rid=0, prompt=PROMPTS[0], max_new_tokens=8)),
               ("steps", 6),
               ("submit", dict(rid=1, prompt=PROMPTS[1], max_new_tokens=3,
                               priority=5))]
    runs = [("qwen2.5-3b", batch, {"max_slots": 2}),
            ("zamba2-7b", batch, {"max_slots": 2}),
            ("zamba2-7b", preempt, {"max_slots": 1})]
    for arch, script, kw in runs:
        jcfg, jparams, cfg, params = refs(arch)[:4]
        want = _engine_run(ref, jcfg, jparams, script, **kw)
        got = _engine_run(port, cfg, params, script, **kw)
        assert got == want, (arch, got, want)
        assert all(len(got[0][a["rid"]]) == a["max_new_tokens"]
                   for op, a in script if op == "submit")
    assert got[1] == 1 and got[2] == {0: (["snapshot"], ["snapshot"])}
    # the serving launcher refuses, before building a model, the backends
    # whose card kernels do not take the shapes: zamba2's softmax and gla,
    # the full granite-20b's softmax decode at 48 query heads a KV head
    for argv in (["--arch", "zamba2-7b", "--backend", "gla"],
                 ["--arch", "granite-20b", "--full", "--backend", "softmax"]):
        with pytest.raises(SystemExit):
            tlaunch.main(argv + ["--device", "cpu"])
    granite = get_config("granite-20b")
    assert backend_refusal(granite, "softmax", serving=False) is None
    assert backend_refusal(granite, "linear", serving=True) is None
    assert backend_refusal(get_config("granite-20b", smoke=True), "softmax",
                           serving=True) is None
