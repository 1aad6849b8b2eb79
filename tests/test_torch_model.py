"""The port's dense model held against `repro.models.model` on the CPU.

pythia-1.4b smoke (2 layers, d_model 64, f32): the reference's random
parameters are carried over with `repro_torch.convert.params_from_jax`,
token ids come from a numpy seed, and the prefill logits, the logits of
4 decode steps after it, and chunked-vs-one-shot prefill must agree
within 1e-4 of the reference logits' magnitude (float32 rounding
through two layers and the f32 unembedding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.models import model as jmdl
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import model as tmdl

REL = 1e-4
B, N, STEPS = 2, 11, 4


def _assert_rel(got, want, label=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{label}: max err {err} > {REL} * {scale}"


@pytest.fixture(scope="module")
def ref():
    """The JAX reference run, built once: params, tokens, the prefill
    logits and each decode step's logits."""
    jcfg = jget_config("pythia-1.4b", smoke=True)
    params = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(
        3, jcfg.vocab_size, size=(B, N + STEPS)).astype(np.int32)
    cache = jmdl.init_cache(jcfg, B, N + STEPS)
    logits, cache = jmdl.prefill(params, jcfg,
                                 {"tokens": jnp.asarray(tokens[:, :N])},
                                 cache)
    steps = []
    for i in range(STEPS):
        lg, cache = jmdl.decode_step(params, jcfg, cache,
                                     jnp.asarray(tokens[:, N + i]))
        steps.append(np.asarray(lg))
    return {"params": jax.tree.map(np.asarray, params), "tokens": tokens,
            "prefill": np.asarray(logits), "steps": steps}


def _port(ref):
    cfg = get_config("pythia-1.4b", smoke=True)
    return cfg, params_from_jax(cfg, ref["params"], device="cpu")


def test_params_from_jax_unstacks_layers(ref):
    cfg, params = _port(ref)
    assert len(params["blocks"]) == cfg.num_layers
    wq = params["blocks"][1]["mixer"]["wq"]["w"]
    np.testing.assert_array_equal(
        wq.numpy(), ref["params"]["blocks"]["mixer"]["wq"]["w"][1])
    assert tuple(wq.shape) == (cfg.d_model, cfg.num_heads
                               * cfg.resolved_head_dim)


@pytest.mark.parametrize("impl,fused", [("auto", True), ("torch", True),
                                        ("ref", True), ("auto", False)])
def test_prefill_and_decode_logits_match_jax(ref, impl, fused):
    cfg, params = _port(ref)
    tokens = torch.from_numpy(ref["tokens"])
    cache = tmdl.init_cache(cfg, B, N + STEPS, device="cpu")
    logits, cache = tmdl.prefill(params, cfg, {"tokens": tokens[:, :N]},
                                 cache)
    _assert_rel(logits, ref["prefill"], "prefill")
    # fused=False: the functional plain step instead of the fused family
    cfg = dataclasses.replace(cfg, la=dataclasses.replace(
        cfg.la, backend=impl, fused_decode=fused))
    for i in range(STEPS):
        logits, cache = tmdl.decode_step(params, cfg, cache,
                                         tokens[:, N + i])
        _assert_rel(logits, ref["steps"][i], f"decode step {i}")
    assert cache["pos"].tolist() == [N + STEPS] * B


@pytest.mark.parametrize("window", [3, 5])
def test_chunked_prefill_equals_one_shot(ref, window):
    cfg, params = _port(ref)
    tokens = torch.from_numpy(ref["tokens"][:, :N])
    cache = tmdl.init_cache(cfg, B, N, device="cpu")
    for start in range(0, N, window):
        logits, cache = tmdl.prefill(
            params, cfg, {"tokens": tokens[:, start:start + window]}, cache)
    _assert_rel(logits, ref["prefill"], "chunked prefill")
    one_cache = tmdl.prefill(params, cfg, {"tokens": tokens},
                             tmdl.init_cache(cfg, B, N, device="cpu"))[1]
    for lc, oc in zip(cache["blocks"], one_cache["blocks"]):
        _assert_rel(lc.s, oc.s.numpy(), "state")


def test_compute_params_keeps_f32_logits_path(ref):
    cfg, params = _port(ref)
    bf = tmdl.compute_params(params, dataclasses.replace(
        cfg, compute_dtype="bfloat16"))
    assert bf["lm_head"]["w"].dtype == torch.float32
    assert bf["ln_f"]["scale"].dtype == torch.float32
    assert bf["blocks"][0]["ln1"]["bias"].dtype == torch.float32
    assert bf["blocks"][0]["mixer"]["wq"]["w"].dtype == torch.bfloat16
    assert bf["embed"]["table"].dtype == torch.bfloat16
    assert tmdl.compute_params(params, cfg)["embed"]["table"] is \
        params["embed"]["table"]


def test_entry_points_need_a_card_unless_cpu_is_asked():
    cfg = get_config("pythia-1.4b", smoke=True)
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        tmdl.init_params(cfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tmdl.init_cache(cfg, 1, 8)
