"""The port's softmax baseline held against the JAX package on the CPU.

Inputs are made from a numpy seed and handed to both packages as numpy
arrays; every model-level run carries the reference's weights over with
`params_from_jax`.  Tolerances, each relative to the reference's largest
|value| (each grad to its own, since their magnitudes differ by orders):

  * F32_REL = 1e-5: f32 kernels' outputs, lse and grads (float32
    rounding of sums taken in other orders);
  * MODEL_REL = 1e-4: f32 logits, loss and grads of pythia smoke
    (float32 rounding through two layers and the f32 unembedding);
  * BF16_REL = 2^-7: bf16 outputs (one bf16 rounding step).

Covered: `softmax_attention` o against the reference's "xla" and
"pallas_interpret" impls and lse against `flash_attention_pallas`;
`softmax_causal` grads against `jax.vjp` through "xla" and against
`flash_attention_bwd_pallas`, G in {1, 4} at odd N; continuation
prefill with per-slot q_offset; `softmax_decode` and
`softmax_decode_fused` with per-slot lengths (length 0 and lengths past
the cache included); the clamped cache writes; the mixer's prefill then
decode against a longer prefill; pythia smoke logits, greedy engine
tokens (one-shot and chunked prefill, slots finishing at different
steps), loss and every grad against JAX; `params_from_jax`; the
`get_backend` family check; the launchers.  The interpret-mode calls use
N <= 64 and 16-row blocks.  `gpu`-marked tests hold the CUDA kernels to
their plain versions and skip without a card.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

try:
    import jax
    import jax.numpy as jnp

    from helpers import run_engine_greedy
    from repro.configs.registry import get_config as jget_config
    from repro.kernels import decode_fused as jdf
    from repro.kernels import flash_attention as jfl
    from repro.kernels import ops as jops
    from repro.mixers import softmax as jsoftmax
    from repro.models import model as jmdl
except ImportError:  # the port alone, on the machine with the card
    jax = None
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core import softmax as tsoftmax_core
from repro_torch.kernels import decode_fused as tdf
from repro_torch.kernels import flash_attention as tfl
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tlaunch_serve
from repro_torch.launch import train as tlaunch_train
from repro_torch.mixers import get_backend
from repro_torch.mixers import softmax as tsoftmax
from repro_torch.models import model as tmdl
from repro_torch.serve.engine import Engine, Request
from repro_torch.tree import named_leaves

F32_REL = 1e-5
MODEL_REL = 1e-4
BF16_REL = 2.0 ** -7
# the CUDA kernels against their plain versions on the card: bf16 o one
# bf16 step (the kernels round P to bf16 before P V, as FlashAttention-2
# does), bf16 grads 2^-5 (P and dS rounded to bf16 before three more
# products), f32 1e-4 (sums in other orders over up to N terms)
GPU_BF16_O_REL = 2.0 ** -7
GPU_BF16_GRAD_REL = 2.0 ** -5
GPU_F32_REL = 1e-4
BLOCK = 16   # interpret-mode flash tiles


def _assert_rel(got, want, rel, label=""):
    got = got.detach().float().cpu().numpy() if isinstance(
        got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{label}: max err {err} > {rel} * {scale}"


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


@pytest.fixture(autouse=True)
def _needs_reference(request):
    if jax is None and request.node.get_closest_marker("gpu") is None:
        pytest.skip("the JAX reference is not installed here")


def _qkv(rng, b, h, hkv, nq, d, nk=None):
    nk = nq if nk is None else nk
    return (rng.standard_normal((b, h, nq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, nk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, nk, d)).astype(np.float32))


def _jnp(*xs):
    return [jnp.asarray(x) for x in xs]


# ---------------------------------------------------------------------------
# Kernels: forward, lse, grads, q_offset, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("jimpl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("g", [1, 4])
def test_softmax_attention_and_lse_match_jax(jimpl, g):
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 2 * g, 2, 37, 16)
    want = jops.softmax_attention(*_jnp(q, k, v), chunk=8, backend=jimpl)
    o = tops.softmax_attention(_t(q), _t(k), _t(v), chunk=8,
                               backend="torch")
    _assert_rel(o, want, F32_REL, "o")
    _, jlse = jfl.flash_attention_pallas(*_jnp(q, k, v), block_q=BLOCK,
                                         block_k=BLOCK, interpret=True,
                                         return_lse=True)
    _, lse = tfl.flash_fwd_torch(_t(q), _t(k), _t(v), chunk=8)
    _assert_rel(lse, jlse, F32_REL, "lse")
    o_ref = tops.softmax_attention(_t(q), _t(k), _t(v), backend="ref")
    _assert_rel(o_ref, want, F32_REL, "ref o")


@pytest.mark.parametrize("g,n", [(1, 37), (4, 29)])
def test_softmax_causal_grads_match_jax(g, n):
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 2 * g, 2, n, 16)
    omega = rng.standard_normal(q.shape).astype(np.float32)
    @jax.jit
    def xla_vjp(a, b_, c, om):
        out, vjp = jax.vjp(lambda x, y, z: jops.softmax_attention(
            x, y, z, chunk=8, backend="xla"), a, b_, c)
        return out, vjp(om)

    jo, jgrads = xla_vjp(*_jnp(q, k, v, omega))
    leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
    o = tops.softmax_causal(*leaves, 8, "torch")
    o.backward(_t(omega))
    _assert_rel(o, jo, F32_REL, "o")
    for name, x, want in zip(("dq", "dk", "dv"), leaves, jgrads):
        _assert_rel(x.grad, want, F32_REL, f"{name} vs xla vjp")
    # the Pallas recomputation backward from the same residuals
    @jax.jit
    def pallas_bwd(a, b_, c, om):
        o2, lse = jfl.flash_attention_pallas(a, b_, c, block_q=BLOCK,
                                             block_k=BLOCK, interpret=True,
                                             return_lse=True)
        return jfl.flash_attention_bwd_pallas(a, b_, c, o2, lse, om,
                                              block_q=BLOCK, block_k=BLOCK,
                                              interpret=True)

    pgrads = pallas_bwd(*_jnp(q, k, v, omega))
    for name, x, want in zip(("dq", "dk", "dv"), leaves, pgrads):
        _assert_rel(x.grad, want, F32_REL, f"{name} vs pallas bwd")


def test_ref_impl_grads_match_torch_impl():
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, 4, 2, 21, 8)
    omega = _t(rng.standard_normal((1, 4, 21, 8)))
    grads = {}
    for impl in ("ref", "torch"):
        leaves = [_t(x).requires_grad_(True) for x in (q, k, v)]
        tops.softmax_attention(*leaves, chunk=4, backend=impl).backward(
            omega)
        grads[impl] = [x.grad for x in leaves]
    for name, got, want in zip(("dq", "dk", "dv"), grads["torch"],
                               grads["ref"]):
        _assert_rel(got, want.numpy(), F32_REL, name)


@pytest.mark.parametrize("chunk", [4, 64])
def test_continuation_prefill_q_offset_matches_jax(chunk):
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 3, 4, 2, 5, 16, nk=24)
    off = np.array([0, 7, 19], np.int32)
    want = jops.softmax_attention(*_jnp(q, k, v), chunk=chunk,
                                  backend="xla", q_offset=jnp.asarray(off))
    got = tops.softmax_attention(_t(q), _t(k), _t(v), chunk=chunk,
                                 backend="torch",
                                 q_offset=torch.from_numpy(off))
    _assert_rel(got, want, F32_REL, "o")
    pal = jfl.flash_attention_pallas(*_jnp(q, k, v), block_q=BLOCK,
                                     block_k=BLOCK, interpret=True,
                                     q_offset=jnp.asarray(off))
    _assert_rel(got, pal, F32_REL, "o vs pallas")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_softmax_decode_matches_jax(fused, g, dtype):
    rng = np.random.default_rng(5)
    b, hkv, s_len, d = 4, 2, 24, 16
    q = rng.standard_normal((b, hkv * g, 1, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, hkv, s_len, d)).astype(np.float32)
            for _ in range(2))
    # per-slot lengths; 0 and one past the cache (a retired slot) included
    lengths = np.array([0, 3, 24, 31], np.int32)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jfn = jops.softmax_decode_fused if fused else jops.softmax_decode
    want = jfn(*(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
               jnp.asarray(lengths), backend="xla")
    fn = tops.softmax_decode_fused if fused else tops.softmax_decode
    got = fn(_t(q, dtype), _t(k, dtype), _t(v, dtype),
             torch.from_numpy(lengths), backend="auto")
    assert got.dtype == dtype
    rel = BF16_REL if dtype == torch.bfloat16 else F32_REL
    _assert_rel(got, np.asarray(want.astype(jnp.float32)), rel, "o")
    if fused:
        # the Pallas kernel on lengths >= 1 (it writes zeros at 0, the
        # plain composition averages all S rows there)
        pal = jdf.softmax_decode_fused_pallas(
            *(jnp.asarray(x).astype(jdt) for x in (q, k, v)),
            jnp.asarray(lengths), block_k=8, interpret=True)
        _assert_rel(got[1:], np.asarray(pal.astype(jnp.float32))[1:], rel,
                    "o vs pallas")
        assert float(jnp.abs(pal[0]).max()) == 0.0


def test_scatter_window_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(6)
    big = rng.standard_normal((3, 2, 8, 4)).astype(np.float32)
    new = rng.standard_normal((3, 2, 3, 4)).astype(np.float32)
    start = np.array([0, 6, 11], np.int32)   # 6 and 11 run past 8 - 3
    want = jsoftmax._scatter_window(jnp.asarray(big), jnp.asarray(new),
                                    jnp.asarray(start))
    got = _t(big)
    tsoftmax._scatter_window(got, _t(new), torch.from_numpy(start))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Model, engine, training
# ---------------------------------------------------------------------------

def _configs(**la):
    jcfg = jget_config("pythia-1.4b", smoke=True,
                       attention_backend="softmax")
    cfg = get_config("pythia-1.4b", smoke=True, attention_backend="softmax")
    if la:
        jcfg = dataclasses.replace(jcfg, la=dataclasses.replace(jcfg.la,
                                                                **la))
        cfg = dataclasses.replace(cfg, la=dataclasses.replace(cfg.la, **la))
    return jcfg, cfg


B, N, STEPS = 2, 11, 4
if jax is not None:
    _jit_prefill = jax.jit(jmdl.prefill, static_argnums=1)
    _jit_decode = jax.jit(jmdl.decode_step, static_argnums=1)


@pytest.fixture(scope="module")
def ref():
    """The JAX reference on pythia smoke with the softmax backend, built
    once: params, tokens, prefill logits and each decode step's logits."""
    jcfg, _ = _configs()
    params = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        3, jcfg.vocab_size, size=(B, N + STEPS)).astype(np.int32)
    cache = jmdl.init_cache(jcfg, B, N + STEPS)
    logits, cache = _jit_prefill(params, jcfg,
                                 {"tokens": jnp.asarray(tokens[:, :N])},
                                 cache)
    steps = []
    for i in range(STEPS):
        lg, cache = _jit_decode(params, jcfg, cache,
                                jnp.asarray(tokens[:, N + i]))
        steps.append(np.asarray(lg))
    return {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
            "prefill": np.asarray(logits), "steps": steps}


def test_params_from_jax_carries_the_softmax_mixer(ref):
    _, cfg = _configs()
    params = params_from_jax(cfg, ref["params"], device="cpu")
    mixer = params["blocks"][1]["mixer"]
    assert set(mixer) == {"wq", "wk", "wv", "wo"}   # no la_a / la_b
    for name in mixer:
        np.testing.assert_array_equal(
            mixer[name]["w"].numpy(),
            ref["params"]["blocks"]["mixer"][name]["w"][1])
    init = tmdl.init_params(cfg, seed=0, device="cpu")
    assert set(init["blocks"][0]["mixer"]) == set(mixer)


@pytest.mark.parametrize("impl,fused", [("auto", True), ("ref", True),
                                        ("auto", False)])
def test_prefill_and_decode_logits_match_jax(ref, impl, fused):
    _, cfg = _configs(backend=impl, fused_decode=fused)
    params = params_from_jax(cfg, ref["params"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    cache = tmdl.init_cache(cfg, B, N + STEPS, device="cpu")
    assert cache["blocks"][0].k.dtype == torch.float32   # compute dtype
    logits, cache = tmdl.prefill(params, cfg, {"tokens": tokens[:, :N]},
                                 cache)
    _assert_rel(logits, ref["prefill"], MODEL_REL, "prefill")
    for i in range(STEPS):
        logits, cache = tmdl.decode_step(params, cfg, cache,
                                         tokens[:, N + i])
        _assert_rel(logits, ref["steps"][i], MODEL_REL, f"decode {i}")
    assert cache["pos"].tolist() == [N + STEPS] * B


@pytest.mark.parametrize("window", [3, 5])
def test_prefill_then_decode_equals_longer_prefill(ref, window):
    """Chunked prefill of N tokens, then decode steps, against one-shot
    prefills of the longer prefixes (the last logits of each)."""
    _, cfg = _configs()
    params = params_from_jax(cfg, ref["params"], device="cpu")
    tokens = torch.from_numpy(ref["tokens"])
    cache = tmdl.init_cache(cfg, B, N + STEPS, device="cpu")
    for start in range(0, N, window):
        logits, cache = tmdl.prefill(
            params, cfg, {"tokens": tokens[:, start:min(start + window, N)]},
            cache)
    for i in range(STEPS):
        want, _ = tmdl.prefill(params, cfg,
                               {"tokens": tokens[:, :N + i]},
                               tmdl.init_cache(cfg, B, N + STEPS, "cpu"))
        _assert_rel(logits, want.numpy(), MODEL_REL, f"step {i}")
        logits, cache = tmdl.decode_step(params, cfg, cache,
                                         tokens[:, N + i])


def test_decode_past_max_len_clamps_like_jax(ref):
    """A retired slot keeps decoding as padding: positions run past
    max_len, writes clamp to the last row and the attended length to
    max_len, as in the reference."""
    jcfg, cfg = _configs()
    max_len = N + 2
    tokens = ref["tokens"]
    jparams = jax.tree.map(jnp.asarray, ref["params"])
    jcache = jmdl.init_cache(jcfg, B, max_len)
    _, jcache = _jit_prefill(jparams, jcfg,
                             {"tokens": jnp.asarray(tokens[:, :N])}, jcache)
    params = params_from_jax(cfg, ref["params"], device="cpu")
    cache = tmdl.init_cache(cfg, B, max_len, device="cpu")
    _, cache = tmdl.prefill(params, cfg,
                            {"tokens": torch.from_numpy(tokens[:, :N])},
                            cache)
    for i in range(STEPS):          # 2 steps in range, 2 past max_len
        jl, jcache = _jit_decode(jparams, jcfg, jcache,
                                 jnp.asarray(tokens[:, N + i]))
        tl, cache = tmdl.decode_step(params, cfg, cache,
                                     torch.from_numpy(tokens[:, N + i]))
        _assert_rel(tl, np.asarray(jl), MODEL_REL, f"decode {i}")
    np.testing.assert_allclose(cache["blocks"][0].k.numpy(),
                               np.asarray(jcache["blocks"].k[0]),
                               rtol=MODEL_REL, atol=MODEL_REL)


# slots finish at different steps, and with 2 slots for 3 requests the
# slot freed by request 0 takes request 2 while request 1 still decodes;
# 9-token prompts in windows of 4 end on a ragged window (one prompt
# length and two window lengths keep the reference's compiles few)
_REQS = [(0, list(range(3, 12)), 2), (1, list(range(20, 29)), 5),
         (2, list(range(7, 16)), 3)]
_CHUNKS = [None, 4]


@pytest.fixture(scope="module")
def engine_ref(ref):
    jcfg, _ = _configs()
    params = jax.tree.map(jnp.asarray, ref["params"])
    return {chunk: run_engine_greedy(jcfg, params, reqs=_REQS, max_slots=2,
                                     prefill_chunk=chunk)[0]
            for chunk in _CHUNKS}


@pytest.mark.parametrize("chunk", _CHUNKS)
def test_greedy_tokens_identical_to_jax_engine(ref, engine_ref, chunk):
    _, cfg = _configs()
    params = params_from_jax(cfg, ref["params"], device="cpu")
    eng = Engine(cfg, params, max_slots=2, max_len=64, eos_id=-1,
                 prefill_chunk=chunk, device="cpu")
    for rid, prompt, mn in _REQS:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=mn))
    got = eng.run()
    assert got == engine_ref[chunk]
    assert {r: len(t) for r, t in got.items()} == {r: mn for r, _, mn in
                                                   _REQS}


def _jax_leaf(tree, path):
    parts = path.split(".")
    layer = None
    if parts[0] == "blocks":
        layer, parts = int(parts[1]), ["blocks"] + parts[2:]
    for p in parts:
        tree = tree[p]
    tree = np.asarray(tree)
    return tree if layer is None else tree[layer]


@pytest.fixture(scope="module")
def grad_ref(ref):
    """The reference's loss and grads on one batch (computed once)."""
    jcfg, _ = _configs()
    tokens = np.random.default_rng(8).integers(
        3, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
    fn = jax.jit(jax.value_and_grad(
        lambda p, t: jmdl.loss_fn(p, jcfg, {"tokens": t})[0]))
    jloss, jgrads = fn(jax.tree.map(jnp.asarray, ref["params"]),
                       jnp.asarray(tokens))
    return tokens, float(jloss), jgrads


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_grad_match_jax(ref, grad_ref, remat):
    _, cfg = _configs()
    cfg = dataclasses.replace(cfg, remat=remat)
    tokens, jloss, jgrads = grad_ref
    params = params_from_jax(cfg, ref["params"], device="cpu")
    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss, _ = tmdl.loss_fn(params, cfg, {"tokens": torch.from_numpy(
        tokens)})
    assert math.isclose(float(loss.detach()), jloss, rel_tol=MODEL_REL)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    assert len(grads) == len(named) > 10
    for (path, _), g in zip(named, grads):
        _assert_rel(g, _jax_leaf(jgrads, path), MODEL_REL, path)


# ---------------------------------------------------------------------------
# Registry, backend resolution, launchers
# ---------------------------------------------------------------------------

def test_get_backend_checks_the_resolved_backends_family():
    """`la.backend` is validated against the family of the resolved
    backend (softmax -> "softmax"), as the reference does."""
    _, cfg = _configs(backend="cuda")
    assert get_backend(cfg).name == "softmax"
    _, cfg = _configs(backend="ref")
    assert get_backend(cfg).name == "softmax"
    _, cfg = _configs(backend="pallas")
    with pytest.raises(ValueError, match=r"'softmax' family; registered: "
                       r"\['cuda', 'ref', 'torch'\]"):
        get_backend(cfg)
    lin = dataclasses.replace(get_config("pythia-1.4b", smoke=True),
                              la=dataclasses.replace(cfg.la, backend="ref"))
    assert get_backend(lin).name == "linear"


def test_softmax_registry_and_cuda_on_cpu_raises():
    assert tops.kernel_names("softmax") == ["cuda", "ref", "torch"]
    assert tops.kernel_names("softmax_decode_fused") == ["cuda", "ref",
                                                         "torch"]
    assert tops.kernel_names("softmax_decode") == ["ref", "torch"]
    rng = np.random.default_rng(9)
    q, k, v = (_t(x) for x in _qkv(rng, 1, 2, 2, 8, 32))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.softmax_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.softmax_decode_fused(q[:, :, :1], k, v,
                                  torch.tensor([3], dtype=torch.int32),
                                  backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.softmax_attention(q, k, v, causal=False, backend="cuda")
    _, cfg = _configs()
    # the encoder-decoder's non-causal attention: the plain chunked scan
    # over the mixer's non-causal projections (q from x, k and v from ctx)
    sm = get_backend("softmax")
    gen = torch.Generator().manual_seed(0)
    p = sm.init(gen, cfg)
    x = torch.randn((1, 5, cfg.d_model), generator=gen)
    ctx = torch.randn((1, 7, cfg.d_model), generator=gen)
    qn, kn, vn = sm.project_noncausal(p, cfg, x, ctx, None, None)
    want = sm.out(p, tsoftmax_core.softmax_chunked(qn, kn, vn, causal=False,
                                                   chunk=cfg.la.chunk), None)
    assert torch.equal(sm.apply_noncausal(p, cfg, x, ctx), want)
    from repro_torch.configs.base import PagingCfg
    # paging is served (tests/test_torch_paging.py); a config without an
    # arena of at least 2 pages (one of them the sink) is refused
    with pytest.raises(ValueError, match="num_pages >= 2"):
        get_backend(dataclasses.replace(cfg, paging=PagingCfg()))


def test_launchers_run_softmax_on_cpu(tmp_path):
    rec = tlaunch_serve.main(["--device", "cpu", "--backend", "softmax",
                              "--requests", "3", "--max-new", "3",
                              "--slots", "2", "--prefill-chunk", "5"])
    assert rec["backend"] == "softmax" and rec["generated_tokens"] == 9
    assert rec["kernel"] == "torch"
    rec = tlaunch_train.main(["--device", "cpu", "--backend", "softmax",
                              "--steps", "2", "--batch", "2", "--seq",
                              "16", "--checkpoint-dir", str(tmp_path)])
    assert rec["steps"] == 2 and math.isfinite(rec["last_loss"])
    rec = tlaunch_serve.main(["--device", "cpu", "--backend", "gla",
                              "--requests", "3", "--max-new", "3",
                              "--slots", "2", "--prefill-chunk", "5"])
    assert rec["backend"] == "gla" and rec["generated_tokens"] == 9
    with pytest.raises(KeyError, match="registered backends"):
        tlaunch_serve.main(["--device", "cpu", "--backend", "bogus"])


# ---------------------------------------------------------------------------
# The CUDA kernels (card only)
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
def test_cuda_flash_kernels_match_plain(dtype, g):
    """flash_fwd (training and q_offset prefill), flash_bwd_delta,
    flash_bwd_q and flash_bwd_kv against their plain versions at odd N."""
    dev = _card()
    rng = np.random.default_rng(10)
    q, k, v = (_t(x, dtype).to(dev) for x in _qkv(rng, 2, 2 * g, 2, 77, 64))
    do = _t(rng.standard_normal(q.shape), dtype).to(dev)
    o_rel = GPU_BF16_O_REL if dtype == torch.bfloat16 else GPU_F32_REL
    g_rel = GPU_BF16_GRAD_REL if dtype == torch.bfloat16 else GPU_F32_REL
    before = dict(tfl.launches)
    o, lse = tfl.flash_fwd_cuda(q, k, v)
    o_t, lse_t = tfl.flash_fwd_torch(q, k, v, chunk=16)
    dq, dk, dv = tfl.flash_bwd_cuda(q, k, v, o_t, lse_t, do)
    torch.cuda.synchronize()
    assert {n: tfl.launches[n] - before[n] for n in before} == {
        "flash_fwd": 1, "flash_bwd_delta": 1, "flash_bwd_q": 1,
        "flash_bwd_kv": 1}
    _assert_rel(o, o_t.float().cpu().numpy(), o_rel, "o")
    _assert_rel(lse, lse_t.cpu().numpy(), GPU_F32_REL, "lse")
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv),
                               tfl.flash_bwd_torch(q, k, v, o_t, lse_t, do,
                                                   16)):
        assert got.dtype == dtype
        _assert_rel(got, want.float().cpu().numpy(), g_rel, name)
    # continuation prefill: a window of 20 queries at per-slot offsets
    qw = q[:, :, :20].contiguous()
    off = torch.tensor([0, 57], dtype=torch.int32, device=dev)
    ow, _ = tfl.flash_fwd_cuda(qw, k, v, off, return_lse=False)
    _assert_rel(ow, tfl.flash_fwd_torch(qw, k, v, off, 16)[0].float().cpu()
                .numpy(), o_rel, "o (q_offset)")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g", [1, 4])
def test_cuda_softmax_decode_matches_plain(dtype, g):
    dev = _card()
    rng = np.random.default_rng(11)
    b, hkv, s_len, d = 4, 2, 70, 64
    q = _t(rng.standard_normal((b, hkv * g, 1, d)), dtype).to(dev)
    k, v = (_t(rng.standard_normal((b, hkv, s_len, d)), dtype).to(dev)
            for _ in range(2))
    lengths = torch.tensor([0, 1, 70, 90], dtype=torch.int32, device=dev)
    before = tdf.launches["softmax_decode_fused"]
    o = tdf.softmax_decode_fused_cuda(q, k, v, lengths)
    torch.cuda.synchronize()
    assert tdf.launches["softmax_decode_fused"] == before + 1
    want = tdf.softmax_decode_fused_torch(q, k, v, lengths)
    rel = GPU_BF16_O_REL if dtype == torch.bfloat16 else GPU_F32_REL
    _assert_rel(o[1:], want[1:].float().cpu().numpy(), rel, "o")
    assert float(o[0].abs().max()) == 0.0     # length 0: zeros
