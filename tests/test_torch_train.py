"""The port's training path held against the JAX package on the CPU.

pythia-1.4b smoke (2 layers, d_model 64, f32): the reference's random
parameters are carried over with `params_from_jax`, token ids come from
`SyntheticLM` (numpy-seeded, bit-identical in both packages).

  * loss and every param grad of `loss_fn` with remat on and off, and
    with learnable (a, b): each grad within 1e-4 of its own largest
    |value| (float32 rounding through two layers; the grads' magnitudes
    differ by orders, so each is scaled to its own)
  * AdamW after 3 steps with clipping active, and the cosine schedule,
    against `repro.optim`, to 1e-6 relative (float32 rounding of the
    update arithmetic)
  * `SyntheticLM` batches bit-identical
  * 20 steps of `Trainer` against the reference's jitted
    `build_train_step`, microbatch 0 and 2: every step's loss within
    1e-4 relative (float32 rounding compounding through 20 AdamW
    updates)
  * the Trainer's retry of a failed step, and `launch/train.py`'s main()
    in-process on the CPU
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jmdl
from repro.optim import adamw as jadamw
from repro.optim import schedules as jsched
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmdl
from repro_torch.optim import adamw, schedules
from repro_torch.train.loop import Trainer
from repro_torch.train.step import build_train_step
from repro_torch.tree import leaves, named_leaves

GRAD_REL = 1e-4
OPT_REL = 1e-6
CURVE_REL = 1e-4
B, N = 4, 16


def _assert_rel(got, want, rel, label=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    assert np.isfinite(got).all(), label
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{label}: max err {err} > {rel} * {scale}"


def _jax_leaf(tree, path):
    """The reference leaf of a port path: `blocks.<i>.rest` indexes the
    layer axis of the reference's stacked block leaf."""
    parts = path.split(".")
    layer = None
    if parts[0] == "blocks":
        layer, parts = int(parts[1]), ["blocks"] + parts[2:]
    for p in parts:
        tree = tree[p]
    tree = np.asarray(tree)
    return tree if layer is None else tree[layer]


def _configs(learnable=False):
    jcfg = jget_config("pythia-1.4b", smoke=True)
    cfg = get_config("pythia-1.4b", smoke=True)
    if learnable:
        jcfg = dataclasses.replace(jcfg, la=dataclasses.replace(
            jcfg.la, learnable_coeffs=True))
        cfg = dataclasses.replace(cfg, la=dataclasses.replace(
            cfg.la, learnable_coeffs=True))
    return jcfg, cfg


_REF = {}


def _reference(learnable):
    """The reference's params, batch, loss and grads (computed once)."""
    if learnable not in _REF:
        jcfg, _ = _configs(learnable)
        params = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
        tokens = JSyntheticLM(jcfg.vocab_size, N, B, seed=0).batch_at(0)
        fn = jax.jit(jax.value_and_grad(
            lambda p, t: jmdl.loss_fn(p, jcfg, {"tokens": t}),
            has_aux=True))
        (loss, _), grads = fn(params, jnp.asarray(tokens))
        _REF[learnable] = (jax.tree.map(np.asarray, params), tokens,
                           float(loss), jax.tree.map(np.asarray, grads))
    return _REF[learnable]


@pytest.mark.parametrize("remat,learnable", [(False, False), (True, False),
                                             (True, True)])
def test_loss_and_every_grad_match_jax(remat, learnable):
    jparams, tokens, jloss, jgrads = _reference(learnable)
    _, cfg = _configs(learnable)
    cfg = dataclasses.replace(cfg, remat=remat)
    params = params_from_jax(cfg, jparams, device="cpu")
    named = named_leaves(params)
    for _, t in named:
        t.requires_grad_(True)
    loss, aux = tmdl.loss_fn(params, cfg, {"tokens": torch.from_numpy(
        tokens)})
    assert float(aux["aux"]) == 0.0
    assert math.isclose(float(loss.detach()), jloss, rel_tol=GRAD_REL)
    grads = torch.autograd.grad(loss, [t for _, t in named])
    # every reference leaf: the unstacked ones, and each stacked block
    # leaf once per layer
    n_block = len(jax.tree.leaves(jgrads["blocks"]))
    assert len(grads) == (len(jax.tree.leaves(jgrads)) - n_block
                          + cfg.num_layers * n_block)
    if learnable:
        assert {"blocks.0.mixer.la_a", "blocks.1.mixer.la_b"} <= \
            {p for p, _ in named}
    for (path, _), g in zip(named, grads):
        _assert_rel(g, _jax_leaf(jgrads, path), GRAD_REL, path)


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "norm": {"scale": rng.standard_normal(5).astype(np.float32)},
            "blocks": [rng.standard_normal((3, 4)).astype(np.float32)]}


def test_adamw_three_steps_with_clipping_match_jax():
    rng = np.random.default_rng(3)
    p0 = _opt_tree(rng)
    gseq = [jax.tree.map(lambda x: (3 * x).astype(np.float32),
                         _opt_tree(rng)) for _ in range(3)]
    kw = dict(beta1=0.9, beta2=0.95, weight_decay=0.1, grad_clip=0.5)
    jp, js = jax.tree.map(jnp.asarray, p0), None
    js = jadamw.init(jp)
    tp = jax.tree.map(torch.from_numpy, p0)
    ts = adamw.init(tp)
    for i, g in enumerate(gseq):
        lr = 1e-2 * (i + 1)
        jp, js, jm = jadamw.apply(jp, jax.tree.map(jnp.asarray, g), js,
                                  lr=lr, **kw)
        tgrads = [torch.from_numpy(np.asarray(x)) for _, x in
                  named_leaves(g)]
        tp, ts, tm = adamw.apply(tp, tgrads, ts, lr=lr, **kw)
        # clipping is active: the norm before clipping exceeds 0.5
        assert float(jm["grad_norm"]) > kw["grad_clip"]
        _assert_rel(tm["grad_norm"], jm["grad_norm"], OPT_REL, "norm")
    assert ts.step == int(js.step) == 3
    for (path, t), mu, nu in zip(named_leaves(tp), ts.mu, ts.nu):
        _assert_rel(t, _jax_leaf(jp, path), OPT_REL, path)
        _assert_rel(mu, _jax_leaf(js.mu, path), OPT_REL, f"mu {path}")
        _assert_rel(nu, _jax_leaf(js.nu, path), OPT_REL, f"nu {path}")


def test_cosine_schedule_matches_jax():
    kw = dict(max_lr=1e-3, min_lr=5e-5, warmup_steps=10, total_steps=100)
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        want = float(jsched.cosine_warmup_decay(step, **kw))
        got = schedules.cosine_warmup_decay(step, **kw)
        assert math.isclose(got, want, rel_tol=OPT_REL, abs_tol=1e-12), step


def test_synthetic_lm_batches_are_bit_identical():
    ref = JSyntheticLM(50304, 33, 3, seed=5)
    port = SyntheticLM(50304, 33, 3, seed=5)
    for i in (0, 1, 7):
        got, want = port.batch_at(i), ref.batch_at(i)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(next(iter(port)), ref.batch_at(0))


@pytest.mark.parametrize("microbatch", [0, 2])
def test_trainer_loss_curve_tracks_jax(microbatch):
    steps = 20
    jparams, _, _, _ = _reference(False)
    jcfg, cfg = _configs()
    kw = dict(total_steps=steps, warmup_steps=2, microbatch=microbatch)
    data = JSyntheticLM(jcfg.vocab_size, N, B, seed=0)
    jstep = jax.jit(jbuild_train_step(jcfg, JTrainConfig(**kw)))
    p, o = jax.tree.map(jnp.asarray, jparams), None
    o = jadamw.init(p)
    want = []
    for i in range(steps):
        p, o, m = jstep(p, o, {"tokens": jnp.asarray(data.batch_at(i))}, i)
        want.append(float(m["loss"]))
    trainer = Trainer(cfg, TrainConfig(**kw),
                      params_from_jax(cfg, jparams, device="cpu"),
                      SyntheticLM(cfg.vocab_size, N, B, seed=0))
    got = [r["loss"] for r in trainer.run(steps)]
    assert len(got) == steps and want[-1] < want[0] - 0.1
    np.testing.assert_allclose(got, want, rtol=CURVE_REL)


def test_trainer_retries_a_failed_step_fresh(tmp_path):
    _, cfg = _configs()
    params = tmdl.init_params(cfg, seed=0, device="cpu")
    # no checkpoint under its (empty) directory: the retry is fresh
    trainer = Trainer(cfg, TrainConfig(total_steps=3, warmup_steps=1,
                                       checkpoint_dir=str(tmp_path)),
                      params, SyntheticLM(cfg.vocab_size, N, 2, seed=0))
    failed = []

    def inject(step):
        if step == 1 and not failed:
            failed.append(step)
            raise RuntimeError("injected")

    hist = trainer.run(3, fail_injector=inject)
    assert [h["step"] for h in hist] == [0, 1, 2] and failed == [1]
    assert trainer.opt_state.step == 3


def test_nonfinite_loss_leaves_params_untouched():
    _, cfg = _configs()
    params = tmdl.init_params(cfg, seed=0, device="cpu")
    params["lm_head"]["w"].data[0, 0] = float("nan")
    before = [t.detach().clone() for t in leaves(params)]
    step = build_train_step(cfg, TrainConfig())
    state = adamw.init(params)
    batch = {"tokens": torch.from_numpy(
        SyntheticLM(cfg.vocab_size, N, 2).batch_at(0))}
    with pytest.raises(FloatingPointError, match="not updated"):
        step(params, state, batch, 0)
    for t, b in zip(leaves(params), before):
        assert torch.equal(t.detach(), b) or torch.isnan(b).any()
    assert state.step == 0


def test_launch_train_main_on_cpu(capsys, tmp_path):
    rec = tlaunch.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--checkpoint-dir",
                        str(tmp_path / "a")])
    assert set(rec) == {"first_loss", "last_loss", "steps", "stragglers"}
    assert rec["steps"] == 3 and math.isfinite(rec["last_loss"])
    assert '"first_loss"' in capsys.readouterr().out
    rec = tlaunch.main(["--device", "cpu", "--backend", "gla", "--steps",
                        "2", "--batch", "2", "--seq", "16",
                        "--checkpoint-dir", str(tmp_path / "b")])
    assert rec["steps"] == 2 and math.isfinite(rec["last_loss"])
    with pytest.raises(KeyError, match="registered backends"):
        tlaunch.main(["--device", "cpu", "--backend", "bogus"])
