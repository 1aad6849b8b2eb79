"""The port's checkpoint store, the Trainer's save / restore / rollback,
the memmap data source, the byte tokenizer and the launcher's
--checkpoint-dir / --resume, held against the JAX package on the CPU.

  * the store's contract, cases of one test, each run through both
    stores: round trip, newest step, an incomplete `.tmp` invisible,
    corruption (IOError), structure mismatch (ValueError), the
    manifest's contents, and bf16 leaves (the port's uint16 form round
    trip; the reference's ml_dtypes files read by the port);
  * across packages: on a flat tree with keys in sorted order (where
    JAX's sorted flattening and the port's insertion order agree) every
    `.npy` file is byte-identical and every manifest leaf entry equal,
    and each store restores the other's checkpoint bit-equal;
  * an async save followed at once by an in-place AdamW step restores
    the values from before the step; a writer that raises makes
    `_wait_save` raise;
  * the Trainer on pythia-1.4b smoke (the reference's parameters carried
    over by `params_from_jax`), checkpoints every 2 steps and one
    injected failure, against the JAX Trainer under the same injector:
    the same sequence of (step, replayed) and losses within 1e-4
    relative (`tests/test_torch_train.py`'s limit for float32 rounding
    through up to 20 AdamW updates); and the port's recovered run
    bit-equal to its own uninterrupted one, params, moments and step;
  * `MemmapLM` batches, `Prefetcher`, `ByteTokenizer` and
    `StragglerMonitor.needs_remesh` equal to the reference's;
  * `launch/train.py`'s main(): --steps 4, then --resume --steps 6.
"""
import hashlib
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import get_config as jget_config
from repro.data.pipeline import MemmapLM as JMemmapLM
from repro.data.pipeline import Prefetcher as JPrefetcher
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.data.tokenizer import ByteTokenizer as JByteTokenizer
from repro.launch import train as jlaunch
from repro.models import model as jmdl
from repro.train.loop import StragglerMonitor as JStragglerMonitor
from repro.train.loop import Trainer as JTrainer
from repro.train.step import build_train_step as jbuild_train_step
from repro_torch.checkpoint import store
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.convert import params_from_jax
from repro_torch.data.pipeline import MemmapLM, Prefetcher, SyntheticLM
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.launch import train as tlaunch
from repro_torch.train.loop import StragglerMonitor, Trainer
from repro_torch.tree import named_leaves

CURVE_REL = 1e-4
B, N = 4, 16


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((8, 16)).astype(np.float32),
            "b": {"c": np.arange(10, dtype=np.int32),
                  "d": np.float32(3.5)}}


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _zeros_like(tree):
    return {k: (_zeros_like(v) if isinstance(v, dict) else torch.zeros_like(v))
            for k, v in tree.items()}


def _assert_tree_equal(got, want):
    got, want = named_leaves(got), named_leaves(want)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = w.numpy() if isinstance(w, torch.Tensor) else np.asarray(w)
        assert g.dtype == w.dtype and np.array_equal(g, w), p


def _flip_last_byte(path):
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 0xFF
    open(path, "wb").write(bytes(data))


def _store_case(case, tmp_path):
    ref = _np_tree()
    jt = jax.tree.map(jnp.asarray, ref)
    tt = _torch_tree(ref)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    if case == "roundtrip":
        jstore.save(jdir, jt, step=3)
        store.save(tdir, tt, step=3)
        jout, jstep = jstore.restore(jdir, jt)
        like = _zeros_like(tt)
        out, step = store.restore(tdir, like)
        assert step == jstep == 3
        assert out["a"] is like["a"]       # restored in place
        _assert_tree_equal(out, ref)
        _assert_tree_equal(jax.tree.map(np.asarray, jout), ref)
    elif case == "latest_step":
        for s in (1, 5, 3):
            jstore.save(jdir, jt, step=s)
            store.save(tdir, tt, step=s)
        assert store.latest_step(tdir) == jstore.latest_step(jdir) == 5
        assert store.latest_step(str(tmp_path / "none")) is None
        assert jstore.latest_step(str(tmp_path / "none")) is None
    elif case == "incomplete":
        # a crash mid-save at step 2: a .tmp directory, no manifest
        for d, save_fn, t in ((jdir, jstore.save, jt),
                              (tdir, store.save, tt)):
            save_fn(d, t, step=1)
            os.makedirs(os.path.join(d, "step_00000002.tmp"))
        assert store.latest_step(tdir) == jstore.latest_step(jdir) == 1
        _, step = store.restore(tdir, _zeros_like(tt))
        assert step == 1
    elif case == "corruption":
        _flip_last_byte(os.path.join(jstore.save(jdir, jt, step=1),
                                     "leaf_00000.npy"))
        _flip_last_byte(os.path.join(store.save(tdir, tt, step=1),
                                     "leaf_00000.npy"))
        with pytest.raises(IOError, match="hash mismatch"):
            jstore.restore(jdir, jt)
        with pytest.raises(IOError, match="hash mismatch"):
            store.restore(tdir, _zeros_like(tt))
    elif case == "structure":
        jstore.save(jdir, jt, step=1)
        store.save(tdir, tt, step=1)
        with pytest.raises(ValueError, match="leaves"):
            jstore.restore(jdir, {"only": jnp.zeros(3)})
        with pytest.raises(ValueError, match="leaves"):
            store.restore(tdir, {"only": torch.zeros(3)})
        # the port also refuses a shape or dtype the manifest does not
        # have, before copying anything
        like = _zeros_like(tt)
        like["b"]["c"] = torch.zeros(10, dtype=torch.int64)
        with pytest.raises(ValueError, match="int32"):
            store.restore(tdir, like)
        assert not like["a"].any()
    elif case == "manifest":
        jman = json.load(open(os.path.join(jstore.save(jdir, jt, step=7),
                                           "manifest.json")))
        man = json.load(open(os.path.join(store.save(tdir, tt, step=7),
                                          "manifest.json")))
        assert man["step"] == jman["step"] == 7
        assert man["treedef"] == ["a", "b.c", "b.d"]
        assert isinstance(man["time"], float)
        want = [{"file": f"leaf_{i:05d}.npy", "shape": list(x.shape),
                 "dtype": str(x.dtype),
                 "sha256": hashlib.sha256(x.tobytes()).hexdigest()}
                for i, x in enumerate(jax.tree.leaves(ref))]
        assert man["leaves"] == jman["leaves"] == want
    else:  # bf16: the port's form, and the reference's files
        rng = np.random.default_rng(1)
        w = rng.standard_normal((5, 7)).astype(np.float32)
        tb = {"v": torch.from_numpy(w[0]).bfloat16(),
              "w": torch.from_numpy(w).bfloat16()}
        store.save(tdir, tb, step=2)
        man = json.load(open(os.path.join(tdir, "step_00000002",
                                          "manifest.json")))
        assert [m["dtype"] for m in man["leaves"]] == ["bfloat16"] * 2
        out, _ = store.restore(tdir, {k: torch.zeros_like(v)
                                      for k, v in tb.items()})
        for k in tb:
            assert out[k].dtype == torch.bfloat16
            assert torch.equal(out[k].view(torch.int16),
                               tb[k].view(torch.int16))
        # the reference's bf16 leaves (ml_dtypes) read by the port; the
        # reference reads the port's files as the uint16 bits
        jb = {"v": w[0].astype(ml_dtypes.bfloat16),
              "w": w.astype(ml_dtypes.bfloat16)}
        jstore.save(jdir, jb, step=2)
        jman = json.load(open(os.path.join(jdir, "step_00000002",
                                           "manifest.json")))
        out, _ = store.restore(jdir, {k: torch.zeros_like(v)
                                      for k, v in tb.items()})
        for k in ("v", "w"):
            assert torch.equal(out[k].view(torch.int16),
                               tb[k].view(torch.int16))
        assert man["leaves"] == jman["leaves"]
        jout, _ = jstore.restore(tdir, jb)
        for k in ("v", "w"):
            assert np.asarray(jout[k]).dtype == np.uint16
            assert np.array_equal(jout[k], jb[k].view(np.uint16))


# the contract's cases, two items of them (a file of at most 7 items is
# queued after the slowest file by `--dist loadfile`)
STORE_CASES = {"files": ("roundtrip", "latest_step", "incomplete",
                         "manifest"),
               "faults": ("corruption", "structure", "bf16")}


@pytest.mark.parametrize("group", sorted(STORE_CASES))
def test_store_contract_matches_jax(group, tmp_path):
    for case in STORE_CASES[group]:
        _store_case(case, tmp_path / case)


def test_stores_read_each_others_files(tmp_path):
    rng = np.random.default_rng(2)
    ref = {"a": rng.standard_normal((6, 5)).astype(np.float32),
           "b": rng.integers(-9, 9, size=11).astype(np.int32),
           "c": np.float32(-1.25), "d": np.int32(42)}
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jckpt = jstore.save(jdir, jax.tree.map(jnp.asarray, ref), step=9)
    tckpt = store.save(tdir, _torch_tree(ref), step=9)
    jman = json.load(open(os.path.join(jckpt, "manifest.json")))
    man = json.load(open(os.path.join(tckpt, "manifest.json")))
    assert man["leaves"] == jman["leaves"] and man["step"] == jman["step"]
    for leaf in man["leaves"]:
        with open(os.path.join(jckpt, leaf["file"]), "rb") as f:
            jbytes = f.read()
        with open(os.path.join(tckpt, leaf["file"]), "rb") as f:
            assert f.read() == jbytes, leaf["file"]
    out, step = store.restore(jdir, _zeros_like(_torch_tree(ref)))
    assert step == 9
    _assert_tree_equal(out, ref)
    jout, step = jstore.restore(tdir, jax.tree.map(jnp.zeros_like, ref))
    assert step == 9
    _assert_tree_equal(jax.tree.map(np.asarray, jout), ref)


def _configs():
    return (jget_config("pythia-1.4b", smoke=True),
            get_config("pythia-1.4b", smoke=True))


_JREF = {}


def _jax_params():
    if "params" not in _JREF:
        jcfg, _ = _configs()
        _JREF["params"] = jax.tree.map(
            np.asarray, jmdl.init_params(jcfg, jax.random.PRNGKey(0)))
    return _JREF["params"]


def _clone_state(trainer):
    return ([t.detach().clone() for _, t in named_leaves(trainer.params)],
            trainer.opt_state.step,
            [t.clone() for t in trainer.opt_state.mu + trainer.opt_state.nu])


def test_async_save_snapshots_before_inplace_step(tmp_path, monkeypatch):
    _, cfg = _configs()
    tc = TrainConfig(total_steps=4, warmup_steps=1, checkpoint_every=0,
                     checkpoint_dir=str(tmp_path))
    trainer = Trainer(cfg, tc, params_from_jax(cfg, _jax_params(),
                                               device="cpu"),
                      SyntheticLM(cfg.vocab_size, N, B, seed=0))
    trainer.run(1)
    before = _clone_state(trainer)
    # hold the writer until the in-place step below has run
    gate = threading.Event()
    name = store._leaf_name
    monkeypatch.setattr(store, "_leaf_name",
                        lambda i: (gate.wait(10), name(i))[1])
    trainer.save(blocking=False)
    assert store.latest_step(str(tmp_path)) is None
    # the next step at once: AdamW updates params and moments in place
    _, trainer.opt_state, _ = trainer.step_fn(
        trainer.params, trainer.opt_state, trainer._batch(1), 1)
    gate.set()
    trainer._wait_save()
    after = _clone_state(trainer)
    assert not torch.equal(after[0][0], before[0][0])
    assert trainer.try_restore() and trainer.step_idx == 1
    restored = _clone_state(trainer)
    assert restored[1] == before[1] == 1
    for got, want in zip(restored[0] + restored[2], before[0] + before[2]):
        assert torch.equal(got, want)

    def broken(i):
        raise OSError("disk gone")

    monkeypatch.setattr(store, "_leaf_name", broken)
    trainer.save(blocking=False)
    with pytest.raises(OSError, match="disk gone"):
        trainer._wait_save()
    trainer._wait_save()    # raised once, then cleared
    assert store.latest_step(str(tmp_path)) == 1


def _histories(hist):
    """(step, replayed) of every history record."""
    seen, out = set(), []
    for h in hist:
        out.append((h["step"], h["step"] in seen))
        seen.add(h["step"])
    return out


def test_trainer_rollback_matches_jax(tmp_path):
    """A failure at step 4 finds the checkpoint just started at 4 (the
    reference's restore does not wait for a pending save, so its
    injector waits); at step 5 it rolls back to 4 and replays it."""
    steps = 8
    jcfg, cfg = _configs()
    kw = dict(total_steps=steps, warmup_steps=2, checkpoint_every=2)
    jparams = _jax_params()
    jstep = jax.jit(jbuild_train_step(jcfg, JTrainConfig(**kw)))

    def injector(trainer, fail_at, wait):
        fired = []

        def inject(step):
            if step == fail_at and not fired:
                if wait:
                    trainer._wait_save()
                fired.append(step)
                raise RuntimeError("injected node failure")
        return inject, fired

    def port(name, fail_at=None):
        tr = Trainer(cfg, TrainConfig(checkpoint_dir=str(tmp_path / name),
                                      **kw),
                     params_from_jax(cfg, jparams, device="cpu"),
                     SyntheticLM(cfg.vocab_size, N, B, seed=0))
        inject, fired = injector(tr, fail_at, wait=False)
        return tr, tr.run(steps, fail_injector=inject), fired

    clean, _, _ = port("clean")
    want_state = _clone_state(clean)
    assert clean.step_idx == want_state[1] == steps
    for fail_at in (4, 5):
        jtr = JTrainer(jcfg, JTrainConfig(
            checkpoint_dir=str(tmp_path / f"j{fail_at}"), **kw),
            jax.tree.map(jnp.asarray, jparams),
            JSyntheticLM(jcfg.vocab_size, N, B, seed=0), step_fn=jstep)
        inject, jfired = injector(jtr, fail_at, wait=True)
        jhist = jtr.run(steps, fail_injector=inject)
        tr, hist, fired = port(f"t{fail_at}", fail_at)
        assert fired == jfired == [fail_at]
        want = [(s, False) for s in range(steps)]
        if fail_at == 5:
            want.insert(5, (4, True))
        assert _histories(hist) == _histories(jhist) == want
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   [h["loss"] for h in jhist],
                                   rtol=CURVE_REL)
        got = _clone_state(tr)
        assert tr.step_idx == steps and got[1] == steps
        for g, w in zip(got[0] + got[2], want_state[0] + want_state[2]):
            assert torch.equal(g, w), fail_at


def test_data_tokenizer_and_remesh_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "tokens.bin")
    rng.integers(0, 50304, size=1000, dtype=np.int32).tofile(path)
    ref, port = JMemmapLM(path, seq_len=16, global_batch=4), \
        MemmapLM(path, seq_len=16, global_batch=4)
    # windows of 64 tokens wrap modulo 936 after the 14th
    for i in range(40):
        got, want = port.batch_at(i), ref.batch_at(i)
        assert got.dtype == want.dtype and np.array_equal(got, want), i
    assert np.array_equal(next(iter(port)), ref.batch_at(0))

    batches = [port.batch_at(i) for i in range(5)]
    got, want = list(Prefetcher(iter(batches))), \
        list(JPrefetcher(iter(batches)))
    assert len(got) == len(want) == 5
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    pf = Prefetcher(iter(port), depth=2)     # an endless source, closed
    assert all(np.array_equal(next(pf), ref.batch_at(i)) for i in range(3))
    pf.close()
    pf.t.join(timeout=10)
    assert not pf.t.is_alive()

    pool = list("abcXYZ 09\n") + ["é", "ß", "中", "文", "😀", "Ω"]
    text = "".join(rng.choice(pool, size=300))
    tok, jtok = ByteTokenizer(), JByteTokenizer()
    assert tok.vocab_size == jtok.vocab_size
    for bos, eos in ((True, False), (False, True), (True, True)):
        assert tok.encode(text, bos, eos) == jtok.encode(text, bos, eos)
    ids = tok.encode(text, eos=True)
    assert tok.decode(ids) == jtok.decode(ids) == text
    cut = tok.encode("ab中")[:-1] + [0, 2, 1]  # a split character, specials
    assert tok.decode(cut) == jtok.decode(cut)

    times = 1.0 + 0.1 * rng.random(80)
    times[rng.random(80) < 0.2] *= 6
    mon, jmon = StragglerMonitor(2.0), JStragglerMonitor(2.0)
    flips = set()
    for dt in times:
        assert mon.record(float(dt)) == jmon.record(float(dt))
        assert mon.needs_remesh == jmon.needs_remesh
        flips.add(mon.needs_remesh)
    assert flips == {False, True} and mon.flagged == jmon.flagged


def test_launch_train_checkpoint_and_resume(tmp_path, monkeypatch, capsys):
    argv = ["--device", "cpu", "--batch", "2", "--seq", "16",
            "--checkpoint-dir", str(tmp_path / "port")]
    rec = tlaunch.main(argv + ["--steps", "4"])
    assert rec["steps"] == 4
    assert sorted(os.listdir(tmp_path / "port")) == ["step_00000002",
                                                     "step_00000004"]
    rec = tlaunch.main(argv + ["--steps", "6", "--resume"])
    assert rec["steps"] == 2 and np.isfinite(rec["last_loss"])
    # the AdamW step count went on from the restored 4
    man = json.load(open(tmp_path / "port" / "step_00000006" /
                         "manifest.json"))
    i = man["treedef"].index("opt.0")
    assert int(np.load(tmp_path / "port" / "step_00000006" /
                       man["leaves"][i]["file"])) == 6
    assert '"first_loss"' in capsys.readouterr().out
    # the reference's launcher writes the same steps
    jdir = str(tmp_path / "jax")
    for extra in (["--steps", "4"], ["--steps", "6", "--resume"]):
        monkeypatch.setattr(sys, "argv", ["train"] + argv[2:-1] + [jdir]
                            + extra)
        jlaunch.main()
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tmp_path / "port"))
