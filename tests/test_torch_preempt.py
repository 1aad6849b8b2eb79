"""The port's priority preemption held against the JAX engine on the CPU.

Both engines get the same weights (the reference's, carried over by
`params_from_jax`), f32 compute, and the traffic of
tests/test_scheduler_v2.py: one slot, max_len 64, window 4; rid 0 at
priority 0 with A_PROMPT and 10 new tokens, then after 6 steps rid 1 at
priority 5 with B_PROMPT and 3 new tokens.  Per eviction policy
(pythia smoke linear and softmax: snapshot; softmax paged, page size 8:
recompute; gla paged, page size 8 and 4 pages: page_keep; gla paged with
pages as the blocker, and a head that has to reclaim the page a
preempted request kept: recompute; mamba2 smoke: snapshot) the port and
the reference give identical greedy tokens per rid, the same finish
order, the same `preemption_count` and the same preempt / resume policy
lists, each read from its own package's ServeTracer.

One more item: the priority-ordering case, `last_step_budget` per step
against the reference's, no page or state page left after a
preemption-heavy run, a seeded (temperature > 0) stream across a
preemption equal to the port's own uninterrupted run (sampled tokens
differ from the reference's by design: torch generators, not jax.random
keys), and the constructor's refusals.

The JAX reference runs on the CPU (pinned before it first runs).
"""
import dataclasses

import jax

# the reference on the CPU, where an f32 dot is an f32 dot (JAX on a card
# computes it in TF32 by default)
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.obs import ServeTracer as JTracer  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.obs import ServeTracer  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.serve.sampling import SamplingParams  # noqa: E402
from repro_torch.serve.scheduler import RequestState  # noqa: E402

A_PROMPT = list(range(3, 15))    # 12 tokens -> 3 windows at chunk 4
B_PROMPT = list(range(20, 24))   # 4 tokens  -> 1 window
C_PROMPT = list(range(30, 36))   # 6 tokens  -> 2 windows

PORT = (Engine, Request, ServeTracer, {"device": "cpu"})
REF = (JEngine, JRequest, JTracer, {})


def _preempt_script(new0=10):
    """tests/test_scheduler_v2.py's `_preempted_run`."""
    return [("submit", dict(rid=0, prompt=A_PROMPT, max_new_tokens=new0)),
            ("steps", 6), ("decoding", 0),
            ("submit", dict(rid=1, prompt=B_PROMPT, max_new_tokens=3,
                            priority=5))]


# rid 1 (priority 5) preempts rid 0 with page_keep and is still mid
# prefill when rid 2 (priority 9) arrives: no slot, no free page and no
# decoding victim, so rid 2 reclaims rid 0's kept page (rid 0 resumes by
# recompute), then preempts rid 1 once it decodes
_RECLAIM_SCRIPT = [
    ("submit", dict(rid=0, prompt=A_PROMPT, max_new_tokens=10)),
    ("steps", 6), ("decoding", 0),
    ("submit", dict(rid=1, prompt=A_PROMPT, max_new_tokens=3, priority=5)),
    ("steps", 1),
    ("submit", dict(rid=2, prompt=B_PROMPT, max_new_tokens=3, priority=9))]

# case -> (arch, attention backend, [(script, engine kwargs), ...])
CASES = {
    "linear_snapshot": ("pythia-1.4b", "linear",
                        [(_preempt_script(), {})]),
    "softmax_snapshot": ("pythia-1.4b", "softmax",
                         [(_preempt_script(), {})]),
    "paged_softmax_recompute": ("pythia-1.4b", "softmax",
                                [(_preempt_script(), {"page_size": 8})]),
    "paged_gla_page_keep": ("pythia-1.4b", "gla", [(
        _preempt_script(), {"page_size": 8, "num_pages": 4})]),
    # two slots, one allocatable page: pages block the head; then the
    # reclaim branch on one slot and two allocatable pages
    "gla_page_blocked_reclaim": ("pythia-1.4b", "gla", [
        (_preempt_script(), {"max_slots": 2, "page_size": 8,
                             "num_pages": 2}),
        (_RECLAIM_SCRIPT, {"page_size": 8, "num_pages": 3})]),
    "mamba2_snapshot": ("mamba2-2.7b", None, [(_preempt_script(), {})]),
}
# the policies each case must show, per rid: (preempted, resumed)
WANT_POLICIES = {
    "linear_snapshot": [{0: (["snapshot"], ["snapshot"])}],
    "softmax_snapshot": [{0: (["snapshot"], ["snapshot"])}],
    "paged_softmax_recompute": [{0: (["recompute"], ["recompute"])}],
    "paged_gla_page_keep": [{0: (["page_keep"], ["page_keep"])}],
    "gla_page_blocked_reclaim": [
        {0: (["recompute"], ["recompute"])},
        {0: (["page_keep"], ["recompute"]),
         1: (["page_keep"], ["page_keep"])}],
    "mamba2_snapshot": [{0: (["snapshot"], ["snapshot"])}],
}


@pytest.fixture(scope="module")
def models():
    """(jax cfg, jax params, port cfg, port params) per (arch, backend),
    built once."""
    cache = {}

    def get(arch, backend):
        if (arch, backend) not in cache:
            kw = {} if backend is None else {"attention_backend": backend}
            jcfg = jget_config(arch, smoke=True, **kw)
            cfg = get_config(arch, smoke=True, **kw)
            jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
            params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                                     device="cpu")
            cache[arch, backend] = (jcfg, jparams, cfg, params)
        return cache[arch, backend]
    return get


def _drive(pkg, cfg, params, script, **kw):
    """Run `script` on a fresh traced engine of `pkg`, then drain it."""
    engine_cls, request_cls, tracer_cls, extra = pkg
    tr = tracer_cls()
    kw = {"max_slots": 1, **kw}
    eng = engine_cls(cfg, params, max_len=64, eos_id=-1, prefill_chunk=4,
                     tracer=tr, **extra, **kw)
    order, steps = [], []

    def step():
        order.extend(o.rid for o in eng.step() if o.finished)
        steps.append(dict(eng.last_step_budget))

    for op, arg in script:
        if op == "submit":
            eng.submit(request_cls(**arg))
        elif op == "steps":
            for _ in range(arg):
                step()
        else:
            assert eng.request(arg).state.value == "decoding", op
    while eng.scheduler.has_work():
        step()
    recs = {r.rid: r for r in tr.records()}
    return {"tokens": {rid: list(eng.request(rid).generated)
                       for rid in recs},
            "order": order, "preemptions": eng.preemption_count,
            "policies": {rid: ([p for _, _, p in r.preempt_events],
                               [p for _, _, p in r.resume_events])
                         for rid, r in recs.items() if r.preempt_events},
            "records": {rid: (r.tokens, r.preemptions, r.closed,
                              r.finish_reason) for rid, r in recs.items()},
            "budgets": steps}, eng


def _assert_drained(eng):
    """Nothing suspended, no prefill job, every page back."""
    assert not eng._suspended and not eng._jobs
    if eng.pool is not None:
        assert eng.pool.pages_in_use == 0
        assert eng.pool.free_pages == eng.pool.num_pages


@pytest.mark.parametrize("case", list(CASES))
def test_preemption_matches_jax_engine(models, case):
    arch, backend, runs = CASES[case]
    jcfg, jparams, cfg, params = models(arch, backend)
    for (script, kw), want in zip(runs, WANT_POLICIES[case]):
        ref, _ = _drive(REF, jcfg, jparams, script, **kw)
        got, eng = _drive(PORT, cfg, params, script, **kw)
        for key in ("tokens", "order", "preemptions", "policies",
                    "records"):
            assert got[key] == ref[key], (case, key, got[key], ref[key])
        assert got["policies"] == want, (case, got["policies"])
        # every request finished with its full budget, the urgent first
        assert all(len(t) == n for t, n in zip(
            got["tokens"].values(),
            [a["max_new_tokens"] for op, a in script if op == "submit"]))
        assert got["order"][-1] == 0
        _assert_drained(eng)


def _solo(cfg, params, **req):
    eng = Engine(cfg, params, max_slots=1, max_len=64, eos_id=-1,
                 prefill_chunk=4, device="cpu")
    eng.submit(Request(**req))
    return eng.run()[req["rid"]]


def test_ordering_budget_leaks_seeded_stream_and_refusals(models):
    jcfg, jparams, cfg, params = models("pythia-1.4b", "linear")
    # priority classes drain in order, FIFO within a class, and the
    # preempted request resumes at its original arrival order
    ordering = [("submit", dict(rid=0, prompt=A_PROMPT, max_new_tokens=8)),
                ("steps", 5)] + [
        ("submit", dict(rid=rid, prompt=B_PROMPT, max_new_tokens=2,
                        priority=prio))
        for rid, prio in ((1, 0), (2, 5), (3, 5), (4, 10))]
    ref, _ = _drive(REF, jcfg, jparams, ordering)
    got, _ = _drive(PORT, cfg, params, ordering)
    assert got["order"] == ref["order"] == [4, 2, 3, 0, 1]
    assert got["tokens"] == ref["tokens"]
    assert got["preemptions"] == ref["preemptions"] >= 1

    # the token budget per step, two slots, budget 6, two 8-token prompts
    budget = [("submit", dict(rid=0, prompt=list(range(3, 11)),
                              max_new_tokens=4)),
              ("submit", dict(rid=1, prompt=list(range(5, 13)),
                              max_new_tokens=4))]
    ref, _ = _drive(REF, jcfg, jparams, budget, max_slots=2, token_budget=6)
    got, eng = _drive(PORT, cfg, params, budget, max_slots=2,
                      token_budget=6)
    assert got["budgets"] == ref["budgets"]
    assert got["tokens"] == ref["tokens"]
    assert sum(b["prefill"] for b in got["budgets"]) == 16
    assert eng.token_budget == 6

    # no page or state page left after preemption-heavy runs
    for backend, kw in (("softmax", {"page_size": 8}),
                        ("gla", {"page_size": 8, "num_pages": 4}),
                        ("gla", {"page_size": 8, "num_pages": 3})):
        c, p = models("pythia-1.4b", backend)[2:]
        script = _RECLAIM_SCRIPT if kw.get("num_pages") == 3 \
            else _preempt_script()
        got, eng = _drive(PORT, c, p, script, **kw)
        assert got["preemptions"] >= 1
        _assert_drained(eng)

    # a seeded stream across a preemption equals the uninterrupted run,
    # whatever the policy (the generator's state is saved and restored)
    sp = SamplingParams(temperature=1.0, top_k=40)
    for backend, kw in (("linear", {}), ("softmax", {"page_size": 8}),
                        ("gla", {"page_size": 8, "num_pages": 4})):
        c, p = models("pythia-1.4b", backend)[2:]
        solo = _solo(c, p, rid=0, prompt=A_PROMPT, max_new_tokens=10,
                     sampling=sp)
        script = [("submit", dict(rid=0, prompt=A_PROMPT, max_new_tokens=10,
                                  sampling=sp))] + _preempt_script()[1:]
        got, _ = _drive(PORT, c, p, script, **kw)
        assert got["preemptions"] == 1, backend
        assert got["tokens"][0] == solo, backend
        assert solo != _solo(c, p, rid=0, prompt=A_PROMPT,
                             max_new_tokens=10), backend

    # the constructor: token_budget, kernel_backend, encdec
    assert Engine(cfg, params, max_slots=3, max_len=64, prefill_chunk=5,
                  device="cpu").token_budget == 3 + 5
    with pytest.raises(ValueError, match="token_budget"):
        Engine(cfg, params, max_slots=2, max_len=32, token_budget=0,
               device="cpu")
    with pytest.raises(ValueError, match="unknown kernel impl"):
        Engine(cfg, params, max_len=32, kernel_backend="pallas",
               device="cpu")
    eng = Engine(cfg, params, max_len=32, kernel_backend="ref", device="cpu")
    assert eng.cfg.la.backend == "ref"
    with pytest.raises(NotImplementedError, match="decoder-only"):
        Engine(dataclasses.replace(cfg, family="encdec"), params,
               device="cpu")
    eng = Engine(cfg, params, max_slots=1, max_len=64, eos_id=-1,
                 prefill_chunk=4, device="cpu")
    eng.submit(Request(rid=0, prompt=A_PROMPT, max_new_tokens=8))
    for _ in range(6):
        eng.step()
    eng.submit(Request(rid=1, prompt=B_PROMPT, max_new_tokens=2,
                       priority=3))
    outs = list(eng.stream())
    pre = [o for o in outs if o.state is RequestState.PREEMPTED]
    assert [(o.rid, o.token, o.finished) for o in pre] == [(0, None, False)]
    assert [o.rid for o in outs if o.finished] == [1, 0]
