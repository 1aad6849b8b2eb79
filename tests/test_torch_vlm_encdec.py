"""The port's VLM (qwen2-vl-7b: M-RoPE) and encoder-decoder
(whisper-large-v3) families, held against the JAX package on the CPU.

  * M-RoPE on vision positions, `sinusoid_positions` and `_sinusoid_at`;
  * `la_noncausal` with GQA, Nq != Nk and an all-zero-denominator row: o
    and the grads of q, k and v; the linear mixer's `cross_precompute`
    and `cross_decode`; both mixers' `apply_noncausal` (softmax at
    G = 2);
  * qwen2-vl smoke: the loss, every param grad, the prefill logits on a
    (1, 3, 3) image grid, `rope_pos` and 4 greedy decode steps;
  * whisper smoke: the same with encoder frames, and each decoder
    layer's self-attention state and CrossState after prefill;
  * the `Engine` on qwen2-vl smoke against the JAX engine: greedy tokens
    with windowed prefill, one `snapshot` preemption, and the
    encoder-decoder refusal (the engines' and the launchers'; the train
    launcher's qwen2-vl batches carry M-RoPE positions);
  * backend resolution on the encoder-decoder family (softmax and gla
    refused), and the static check REPRO-R002: clean on the port's
    mixers, firing on planted backends.

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
from repro.core.chunked import la_noncausal as jla_noncausal  # noqa: E402
from repro.mixers import get_backend as jget_backend  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.models.common import \
    sinusoid_positions as jsinusoid_positions  # noqa: E402
from repro.models.frontends import \
    vision_positions_stub as jvision_positions  # noqa: E402
from repro.models.rope import apply_rope as japply_rope  # noqa: E402
from repro.obs import ServeTracer as JTracer  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.check.registry_audit import check_mixer_flags  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.core.chunked import la_noncausal  # noqa: E402
from repro_torch.mixers import get_backend  # noqa: E402
from repro_torch.mixers.base import AttentionBackend  # noqa: E402
from repro_torch.models import model as tmdl  # noqa: E402
from repro_torch.models.common import sinusoid_positions  # noqa: E402
from repro_torch.models.frontends import audio_frames_stub, \
    vision_positions_stub  # noqa: E402
from repro_torch.models.rope import apply_rope  # noqa: E402
from repro_torch.obs import ServeTracer  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.tree import named_leaves  # noqa: E402

REL = 1e-4
B, N, STEPS = 2, 13, 4
VLM, ENCDEC = "qwen2-vl-7b", "whisper-large-v3"
GRID = (1, 3, 3)


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


def _clone(tree):
    """A copy of a cache: dicts, lists and state tuples rebuilt, tensors
    cloned."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(_clone(v) for v in tree))
    return tree.clone()


def _batch(cfg, tokens, frames, n):
    """numpy inputs of the first n tokens: + M-RoPE positions of a GRID
    image then text, + encoder frames."""
    batch = {"tokens": tokens[:, :n]}
    if cfg.rope_kind == "mrope":
        batch["positions"] = np.asarray(jvision_positions(B, n, GRID))
    if cfg.family == "encdec":
        batch["frames"] = frames
    return batch


def _jax_run(jcfg, jparams, tokens, frames):
    """The reference's loss and grads over all tokens, then the prefill
    of the first N (its cache kept) and STEPS greedy decode steps."""
    batch = {k: jnp.asarray(v)
             for k, v in _batch(jcfg, tokens, frames, N + STEPS).items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jmdl.loss_fn(p, jcfg, batch), has_aux=True))(jparams)
    cache = jmdl.init_cache(jcfg, B, N + STEPS)
    logits, cache = jmdl.prefill(
        jparams, jcfg,
        {k: jnp.asarray(v) for k, v in _batch(jcfg, tokens, frames,
                                              N).items()}, cache)
    prefilled = _np(cache)
    out, toks = [np.asarray(logits)], []
    for _ in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = jmdl.decode_step(jparams, jcfg, cache, tok)
        out.append(np.asarray(logits))
    return float(loss), _np(grads), out, toks, prefilled, _np(cache)


@pytest.fixture(scope="module")
def refs():
    """arch -> (jax cfg, jax params, port cfg, port params, tokens,
    frames), each built once; the reference's run is built on first
    use."""
    built, runs = {}, {}

    def get(arch, run=False):
        if arch not in built:
            jcfg = jget_config(arch, smoke=True)
            cfg = get_config(arch, smoke=True)
            jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
            params = params_from_jax(cfg, _np(jparams), device="cpu")
            rng = np.random.default_rng(0)
            tokens = rng.integers(3, jcfg.vocab_size,
                                  size=(B, N + STEPS)).astype(np.int32)
            frames = (rng.standard_normal(
                (B, jcfg.encoder_seq, jcfg.d_model)) * 0.02).astype(
                    np.float32)
            built[arch] = (jcfg, jparams, cfg, params, tokens, frames)
        if run and arch not in runs:
            jcfg, jparams, _, _, tokens, frames = built[arch]
            runs[arch] = _jax_run(jcfg, jparams, tokens, frames)
        return built[arch] + ((runs[arch],) if run else ())
    return get


def test_mrope_and_sinusoids_match_jax():
    """M-RoPE with qwen2-vl's sections (16, 24, 24) at D = 128 on a (1, 4,
    5) image grid then text, in f32 and bf16; whisper's sinusoids at an
    offset and per slot; the frontends' stubs."""
    rng = np.random.default_rng(1)
    n, d = 27, 128
    pos = vision_positions_stub(B, n, grid=(1, 4, 5))
    jpos = np.asarray(jvision_positions(B, n, (1, 4, 5)))
    assert pos.dtype == torch.int32 and pos.tolist() == jpos.tolist()
    assert int(pos[0, 0, -1]) == n - 20  # text continues after the grid
    x = rng.standard_normal((B, 3, n, d)).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = apply_rope(torch.from_numpy(x).to(dt), pos, "mrope",
                         theta=1e6, mrope_sections=(16, 24, 24))
        want = japply_rope(jnp.asarray(x, jdt), jnp.asarray(jpos), "mrope",
                           theta=1e6, mrope_sections=(16, 24, 24))
        assert got.dtype == dt
        _assert_rel(got.float(), np.asarray(want, np.float32),
                    f"mrope {dt}")
    with pytest.raises(ValueError, match="3, B, N"):
        apply_rope(torch.from_numpy(x), pos[0], "mrope")
    _assert_rel(sinusoid_positions(40, 64, offset=7),
                jsinusoid_positions(40, 64, offset=7), "sinusoids")
    # slots across whisper's decoder context (448 tokens); past it an f32
    # angle's own rounding (ulp(1024) = 1.2e-4) reaches REL, since XLA's
    # and torch's exp differ by one ulp on some frequencies
    slots = np.array([0, 5, 447], np.int32)
    _assert_rel(tmdl._sinusoid_at(torch.from_numpy(slots), 1280),
                jmdl._sinusoid_at(jnp.asarray(slots), 1280), "sinusoid_at")
    gen = torch.Generator().manual_seed(0)
    frames = audio_frames_stub(gen, B, 12, 64)
    assert frames.shape == (B, 12, 64) and 0.01 < frames.std() < 0.03


def test_la_noncausal_and_cross_decode_match_jax(refs):
    """GQA G = 2, Nq = 9 against Nk = 14, (a, b) = (1, 0.5) and (0, 1); one
    query row zero, whose denominator at a = 0 is exactly 0 (o and its
    grads 0 through safe_div); then whisper smoke's cross-attention state
    of one layer and a one-token readout against it, and the linear and
    softmax mixers' `apply_noncausal` (softmax at G = 2, Nq = 1 and 5)."""
    rng = np.random.default_rng(2)
    b, h, hkv, nq, nk, d = 2, 4, 2, 9, 14, 16

    def unit(*shape):
        z = rng.standard_normal(shape).astype(np.float32)
        return z / np.linalg.norm(z, axis=-1, keepdims=True)

    q, k = unit(b, h, nq, d), unit(b, hkv, nk, d)
    q[1, 3, 4] = 0.0
    v = rng.standard_normal((b, hkv, nk, d)).astype(np.float32)
    om = rng.standard_normal((b, h, nq, d)).astype(np.float32)
    for a_, b_ in ((1.0, 0.5), (0.0, 1.0)):
        leaves = [torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v)]
        o = la_noncausal(*leaves, a_, b_)
        o.backward(torch.from_numpy(om))
        jo, vjp = jax.vjp(lambda *x: jla_noncausal(*x, a_, b_),
                          *(jnp.asarray(x) for x in (q, k, v)))
        _assert_rel(o, jo, f"o a={a_}")
        for name, t, want in zip(("dq", "dk", "dv"), leaves,
                                 vjp(jnp.asarray(om))):
            _assert_rel(t.grad, want, f"{name} a={a_}")
    assert float(o.detach()[1, 3, 4].abs().max()) == 0.0

    jcfg, jparams, cfg, params = refs(ENCDEC)[:4]
    jb, tb = jget_backend(jcfg), get_backend(cfg)
    assert tb.supports_noncausal and tb.supports_cross_decode
    jp = jax.tree.map(lambda x: x[1], jparams["dec_blocks"]["cross"])
    p = params["dec_blocks"][1]["cross"]
    ctx = rng.standard_normal((B, 12, cfg.d_model)).astype(np.float32)
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    jstate = jb.cross_precompute(jp, jcfg, jnp.asarray(ctx))
    state = tb.cross_precompute(p, cfg, torch.from_numpy(ctx))
    _assert_rel(state.s, jstate.s, "cross s")
    _assert_rel(state.p, jstate.p, "cross p")
    _assert_rel(tb.cross_decode(p, cfg, torch.from_numpy(x), state),
                jb.cross_decode(jp, jcfg, jnp.asarray(x), jstate),
                "cross decode")
    _assert_rel(tb.apply_noncausal(p, cfg, torch.from_numpy(x),
                                   torch.from_numpy(ctx)),
                jb.apply_noncausal(jp, jcfg, jnp.asarray(x),
                                   jnp.asarray(ctx)), "apply_noncausal")
    # the softmax mixer's non-causal path at G = 2: the same projections
    # with k and v cut to the first two KV heads, Nq = 1 and 5 on Nk = 12
    hd = cfg.resolved_head_dim

    def kv_heads2(tree):
        return {n: ({f: w[..., :2 * hd] for f, w in leaf.items()}
                    if n in ("wk", "wv") else leaf)
                for n, leaf in tree.items()}

    cfg2 = dataclasses.replace(cfg, num_kv_heads=2)
    jcfg2 = dataclasses.replace(jcfg, num_kv_heads=2)
    sm, jsm = get_backend("softmax"), jget_backend("softmax")
    x5 = rng.standard_normal((B, 5, cfg.d_model)).astype(np.float32)
    for xq in (x, x5):
        _assert_rel(sm.apply_noncausal(kv_heads2(p), cfg2,
                                       torch.from_numpy(xq),
                                       torch.from_numpy(ctx)),
                    jsm.apply_noncausal(kv_heads2(jp), jcfg2,
                                        jnp.asarray(xq), jnp.asarray(ctx)),
                    f"softmax apply_noncausal Nq={xq.shape[1]}")


def _check_arch(refs, arch):
    """The port's loss, every grad, prefill logits and cache, and greedy
    decode against the reference's run; returns (the port's prefilled
    cache, the reference's, the port's final cache, the reference's)."""
    _, _, cfg, params, tokens, frames, run = refs(arch, run=True)
    jloss, jgrads, jlogits, jtoks, jcache0, jcache = run

    def batch(n):
        return {k: torch.from_numpy(np.array(v)).long()
                if k == "tokens" else torch.from_numpy(np.array(v))
                for k, v in _batch(cfg, tokens, frames, n).items()}

    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = tmdl.loss_fn(params, cfg, batch(N + STEPS))
    grads = torch.autograd.grad(loss, [t for _, t in named])
    for _, t in named:
        t.requires_grad_(False)
    _assert_rel(loss, np.float32(jloss), f"{arch} loss")
    want = named_leaves(params_from_jax(cfg, jgrads, device="cpu"))
    assert [p for p, _ in want] == [p for p, _ in named]
    for (path, w), g in zip(want, grads):
        _assert_rel(g, w.numpy(), f"{arch} grad {path}")

    cache = tmdl.init_cache(cfg, B, N + STEPS, device="cpu")
    logits, cache = tmdl.prefill(params, cfg, batch(N), cache)
    _assert_rel(logits, jlogits[0], f"{arch} prefill")
    cache0 = _clone(cache)
    for i in range(STEPS):
        tok = logits.argmax(-1)
        assert tok.tolist() == jtoks[i].tolist(), (arch, i)
        logits, cache = tmdl.decode_step(params, cfg, cache, tok)
        _assert_rel(logits, jlogits[i + 1], f"{arch} decode step {i}")
    assert cache["pos"].tolist() == [N + STEPS] * B
    return cache0, jcache0, cache, jcache


def test_vlm_loss_grads_prefill_and_decode_match_jax(refs):
    """qwen2-vl smoke (2 layers, 4 heads on 2, M-RoPE sections (2, 3, 3)):
    the first 9 prompt tokens an image grid, so rope_pos lags the token
    count: N - 9 + 1 after prefill, + STEPS after decoding."""
    cache0, jcache0, cache, jcache = _check_arch(refs, VLM)
    assert cache0["rope_pos"].tolist() == jcache0["rope_pos"].tolist() \
        == [N - 9 + 1] * B
    assert cache["rope_pos"].tolist() == [N - 9 + 1 + STEPS] * B
    for i, st in enumerate(cache["blocks"]):
        _assert_rel(st.s, jcache["blocks"].s[i], f"layer {i} state s")


def test_encdec_loss_grads_prefill_and_decode_match_jax(refs):
    """whisper smoke (2 encoder and 2 decoder layers, 12 frames): every
    decoder layer's self-attention state and CrossState after prefill,
    and the self state after decoding."""
    cache0, jcache0, cache, jcache = _check_arch(refs, ENCDEC)
    assert sorted(cache0) == ["cross", "pos", "self"]
    for i in range(2):
        for name, got, want in (
                ("self s", cache0["self"][i].s, jcache0["self"].s[i]),
                ("self p", cache0["self"][i].p, jcache0["self"].p[i]),
                ("cross s", cache0["cross"][i].s, jcache0["cross"].s[i]),
                ("cross p", cache0["cross"][i].p, jcache0["cross"].p[i]),
                ("decoded self s", cache["self"][i].s,
                 jcache["self"].s[i])):
            _assert_rel(got, want, f"layer {i} {name}")


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


def test_engine_vlm_tokens_snapshot_and_encdec_refusal(refs, tmp_path):
    """qwen2-vl smoke through both engines: three requests on two slots
    with prompts longer than a prefill window (text positions from each
    carry's rope_pos), then rid 1 at priority 5 evicting rid 0 from the
    only slot (`snapshot`: rope_pos is a leaf of the slot); both engines
    refuse the encoder-decoder."""
    port = (Engine, Request, ServeTracer, {"device": "cpu"})
    ref = (JEngine, JRequest, JTracer, {})
    batch = [("submit", dict(rid=i, prompt=p, max_new_tokens=5))
             for i, p in enumerate(PROMPTS)]
    preempt = [("submit", dict(rid=0, prompt=PROMPTS[0], max_new_tokens=8)),
               ("steps", 6),
               ("submit", dict(rid=1, prompt=PROMPTS[1], max_new_tokens=3,
                               priority=5))]
    jcfg, jparams, cfg, params = refs(VLM)[:4]
    for script, kw in ((batch, {"max_slots": 2}), (preempt,
                                                   {"max_slots": 1})):
        want = _engine_run(ref, jcfg, jparams, script, **kw)
        got = _engine_run(port, cfg, params, script, **kw)
        assert got == want, (got, want)
        assert all(len(got[0][a["rid"]]) == a["max_new_tokens"]
                   for op, a in script if op == "submit")
    assert got[1] == 1 and got[2] == {0: (["snapshot"], ["snapshot"])}
    jcfg, jparams, cfg, params = refs(ENCDEC)[:4]
    with pytest.raises(NotImplementedError, match="encoder frames"):
        JEngine(jcfg, jparams, max_slots=2, max_len=32)
    with pytest.raises(NotImplementedError, match="encoder frames"):
        Engine(cfg, params, max_slots=2, max_len=32, device="cpu")
    # the launchers: qwen2-vl trains on stub M-RoPE positions, whisper is
    # refused by both with the reason
    rec = launch_train.main(["--arch", VLM, "--device", "cpu", "--steps",
                             "1", "--batch", "2", "--seq", "16",
                             "--checkpoint-dir", str(tmp_path)])
    assert rec["steps"] == 1 and np.isfinite(rec["first_loss"])
    for launcher in (launch_train, launch_serve):
        with pytest.raises(SystemExit):
            launcher.main(["--arch", ENCDEC, "--device", "cpu"])


class _ClaimsNoncausal(AttentionBackend):
    supports_noncausal = True     # without apply_noncausal


class _HidesCrossDecode(AttentionBackend):
    def cross_precompute(self, p, cfg, ctx, compute_dtype=None):
        return None

    def cross_decode(self, p, cfg, x, state, compute_dtype=None):
        return x


def test_encdec_backend_resolution_and_mixer_flags():
    """The encoder-decoder resolves only to a backend with encoder and
    cross-decode paths (linear), as in the reference; REPRO-R002 is clean
    on the port's five mixers and fires on a backend that claims a flag
    without its methods, and on one that hides implemented methods."""
    cfg = get_config(ENCDEC, smoke=True)
    assert get_backend(cfg).name == "linear"
    for name in ("softmax", "gla"):
        bad = dataclasses.replace(cfg, attention_backend=name)
        with pytest.raises(ValueError, match="cross") as exc:
            get_backend(bad)
        assert "capable backends: ['linear']" in str(exc.value)
        with pytest.raises(ValueError, match="cross"):
            jget_backend(dataclasses.replace(jget_config(ENCDEC, smoke=True),
                                             attention_backend=name))
    assert get_backend("softmax").supports_noncausal
    assert not get_backend("gla").supports_noncausal
    assert check_mixer_flags() == []
    found = check_mixer_flags({"claims": _ClaimsNoncausal(),
                               "hides": _HidesCrossDecode()})
    assert [(f.rule, f.where) for f in found] == [
        ("REPRO-R002", "mixers[claims]"), ("REPRO-R002", "mixers[hides]")]
    assert "apply_noncausal" in found[0].detail
    assert "hidden" in found[1].detail
