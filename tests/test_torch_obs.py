"""The port's serving tracer (`repro_torch.obs`) held against `repro.obs`
on the CPU.

  * metrics: `percentiles`, `Histogram` percentiles, counts and edges,
    `log_buckets`, the JSON snapshot and the Prometheus text, on the
    same numpy samples in both packages;
  * traced engine tokens equal untraced ones (linear contiguous and
    softmax paged);
  * on the same traffic (paged softmax, page size 8, a preemption, a
    rejected submit) the hook calls of the port's engine, scheduler and
    pool, in order and with their arguments, equal the reference's; so
    do each RequestRecord's token count, preemptions and finish, and
    `export_chrome_trace`'s events (phase, track, name, keys; not the
    times);
  * `python -m repro_torch.obs report` on a port trace;
  * `python -m repro_torch.launch.serve --device cpu --kernel torch
    --trace-out ... --metrics-json ...` on the smoke config.

No assertion reads a wall-clock time.  The JAX reference runs on the CPU
(pinned before it first runs).
"""
import json
import os
import pathlib
import subprocess
import sys

import jax

# the reference on the CPU, where an f32 dot is an f32 dot (JAX on a card
# computes it in TF32 by default)
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.configs.registry import get_config as jget_config  # noqa: E402
from repro.models import model as jmdl  # noqa: E402
from repro.serve.engine import Engine as JEngine  # noqa: E402
from repro.serve.engine import Request as JRequest  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tlaunch  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
A_PROMPT = list(range(3, 15))
B_PROMPT = list(range(20, 24))


def test_metrics_match_reference():
    rng = np.random.default_rng(3)
    samples = [rng.lognormal(-5.0, 2.0, n).tolist() for n in (1, 2, 7, 100)]
    samples.append([0.0, 1e-9, 1e-5, 100.0, 1e3, 1e-5 * 10 ** 0.125])
    ps = (0, 1, 50, 90, 99, 99.9, 100)
    assert tobs.percentiles([], ps) == jobs.percentiles([], ps)
    for xs in samples:
        assert tobs.percentiles(xs, ps) == jobs.percentiles(xs, ps)
    for spec in ((), (1e-3, 10.0, 4), (0.5, 2.0, 1)):
        assert tobs.log_buckets(*spec) == jobs.log_buckets(*spec)
    assert tobs.LATENCY_BUCKETS == jobs.LATENCY_BUCKETS
    assert tobs.BUCKET_RATIO == jobs.BUCKET_RATIO
    for bad in ((0.0, 1.0), (2.0, 1.0), (1e-3, 1.0, 0)):
        for mod in (tobs, jobs):
            with pytest.raises(ValueError):
                mod.log_buckets(*bad)
    with pytest.raises(ValueError):
        tobs.percentiles([1.0], [101])

    regs = []
    for mod in (tobs, jobs):
        reg = mod.MetricsRegistry()
        reg.counter("c_total", "a counter").inc(3)
        reg.gauge("g", "a gauge").set(0.25)
        reg.gauge("unset")
        hists = [reg.histogram(f"h{i}_seconds", "latency")
                 for i in range(len(samples))]
        edges = reg.histogram("edges", buckets=(1.0, 2.0, 4.0))
        for h, xs in zip(hists, samples):
            for x in xs:
                h.observe(x)
        # on a bound, just above it, past the last one
        for x in (1.0, 1.0000001, 2.0, 4.0, 4.5):
            edges.observe(x)
        with pytest.raises(TypeError):
            reg.gauge("c_total")
        with pytest.raises(ValueError):
            reg.counter("c_total").inc(-1)
        with pytest.raises(ValueError):
            mod.Histogram("bad", buckets=(2.0, 1.0))
        regs.append((reg, hists + [edges]))
    (treg, th), (jreg, jh) = regs
    for a, b in zip(th, jh):
        assert a.counts == b.counts and a.total == b.total
        for p in ps:
            assert a.percentile(p) == b.percentile(p)
    # v <= bound lands in that bound's bucket: (<=1], (1, 2], (2, 4], +Inf
    assert th[-1].counts == [1, 2, 1, 1]
    assert treg.to_json() == jreg.to_json()
    assert treg.prometheus_text() == jreg.prometheus_text()


@pytest.fixture(scope="module")
def pythia():
    """The reference's pythia smoke weights (linear and softmax), and the
    port's copies."""
    out = {}
    for backend in ("linear", "softmax"):
        jcfg = jget_config("pythia-1.4b", smoke=True,
                           attention_backend=backend)
        cfg = get_config("pythia-1.4b", smoke=True, attention_backend=backend)
        jparams = jmdl.init_params(jcfg, jax.random.PRNGKey(0))
        out[backend] = (jcfg, jparams, cfg, params_from_jax(
            cfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return out


def _submit_all(eng, request_cls):
    for rid, prompt in enumerate((A_PROMPT, B_PROMPT, list(range(5, 14)))):
        eng.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=4))


@pytest.mark.parametrize("backend,kw", [("linear", {}),
                                        ("softmax", {"page_size": 8})])
def test_traced_tokens_equal_untraced(pythia, backend, kw):
    cfg, params = pythia[backend][2:]
    runs = []
    for tracer in (None, tobs.ServeTracer()):
        eng = Engine(cfg, params, max_slots=2, max_len=64, eos_id=-1,
                     prefill_chunk=4, tracer=tracer, device="cpu", **kw)
        _submit_all(eng, Request)
        runs.append(eng.run())
    assert runs[0] == runs[1]
    assert tracer.summary()["tokens"] == 12
    assert all(r.closed and r.tokens == 4 for r in tracer.records())


def _recording(base):
    """`base` (a ServeTracer class) that also logs every hook call with
    its arguments, times left out."""

    class Recording(base):
        def __init__(self):
            super().__init__()
            self.calls = []

    def wrap(name, time_at):
        def hook(self, *args):
            keep = [a for i, a in enumerate(args) if i != time_at]
            self.calls.append((name, *keep))
            return getattr(base, name)(self, *args)
        return hook

    for name in ("request_submitted", "request_queued", "request_rejected",
                 "admission_blocked", "request_admitted", "token_emitted",
                 "request_preempted", "request_resumed", "pages_changed",
                 "cow_fork", "sink_repoint"):
        setattr(Recording, name, wrap(name, None))
    # the argument that is a time
    for name, at in (("prefill_window", 3), ("engine_step", 0),
                     ("request_finished", 2)):
        setattr(Recording, name, wrap(name, at))
    return Recording


def _traced_run(engine_cls, request_cls, tracer_cls, cfg, params, **extra):
    """Paged softmax, one slot: a request the arena can never hold is
    refused, rid 0 is preempted by rid 1 (priority 5) and recomputed."""
    tr = _recording(tracer_cls)()
    eng = engine_cls(cfg, params, max_slots=1, max_len=64, eos_id=-1,
                     prefill_chunk=4, page_size=8, num_pages=5, tracer=tr,
                     **extra)
    with pytest.raises(ValueError):
        eng.submit(request_cls(rid=9, prompt=list(range(3, 40)),
                               max_new_tokens=2))
    eng.submit(request_cls(rid=0, prompt=A_PROMPT, max_new_tokens=10))
    for _ in range(6):
        eng.step()
    eng.submit(request_cls(rid=1, prompt=B_PROMPT, max_new_tokens=3,
                           priority=5))
    done = eng.run()
    return tr, done


def _structure(doc):
    """A Chrome trace's events without their times."""
    return [(e["ph"], e["pid"], e.get("tid"), e["name"], sorted(e),
             sorted(e.get("args", {}))) for e in doc["traceEvents"]]


def test_tracer_events_records_and_chrome_trace_match_reference(
        pythia, tmp_path):
    jcfg, jparams, cfg, params = pythia["softmax"]
    jtr, jdone = _traced_run(JEngine, JRequest, jobs.ServeTracer, jcfg,
                             jparams)
    ttr, tdone = _traced_run(Engine, Request, tobs.ServeTracer, cfg, params,
                             device="cpu")
    assert tdone == jdone
    assert ttr.calls == jtr.calls
    kinds = [c[0] for c in ttr.calls]
    for kind in ("request_rejected", "request_preempted", "request_resumed",
                 "sink_repoint", "pages_changed", "admission_blocked"):
        assert kind in kinds, kind

    def rec(r):
        return (r.rid, r.prompt_len, r.max_new, r.slot, r.tokens,
                r.finish_reason, r.blocked, r.closed, r.preemptions,
                [p for _, _, p in r.preempt_events],
                [p for _, _, p in r.resume_events], len(r.prefill_windows))

    assert [rec(r) for r in ttr.records()] == \
        [rec(r) for r in jtr.records()]
    assert ttr.records()[0].preempted_s is not None   # rid 0, evicted
    tsum, jsum = ttr.summary(), jtr.summary()
    for key in ("requests", "finished", "tokens", "preemptions", "steps",
                "occupancy"):
        assert tsum[key] == jsum[key], key
    assert sorted(tsum) == sorted(jsum)
    tdoc = ttr.export_chrome_trace(str(tmp_path / "t" / "trace.json"))
    jdoc = jtr.export_chrome_trace()
    assert _structure(tdoc) == _structure(jdoc)
    assert sorted(tdoc) == sorted(jdoc)
    assert [sorted(r) for r in tdoc["repro_records"]] == \
        [sorted(r) for r in jdoc["repro_records"]]
    assert json.loads((tmp_path / "t" / "trace.json").read_text()) == tdoc
    assert sorted(ttr.metrics.to_json()["metrics"]) == \
        sorted(jtr.metrics.to_json()["metrics"])


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], env=env,
                          capture_output=True, text=True, timeout=300)


def test_report_cli_on_a_port_trace(pythia, tmp_path):
    cfg, params = pythia["linear"][2:]
    tr = tobs.ServeTracer()
    eng = Engine(cfg, params, max_slots=2, max_len=64, eos_id=-1,
                 prefill_chunk=4, tracer=tr, device="cpu")
    _submit_all(eng, Request)
    eng.run()
    path = tmp_path / "trace.json"
    tr.export_chrome_trace(str(path))
    out = _cli("repro_torch.obs", "report", str(path))
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].split()[:3] == ["rid", "prompt", "toks"]
    assert [ln.split()[:3] for ln in lines[1:4]] == \
        [["0", "12", "4"], ["1", "4", "4"], ["2", "9", "4"]]
    assert "3/3 requests finished, 12 tokens" in out.stdout
    out = _cli("repro_torch.obs", "report", str(path), "--json")
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["summary"]["tokens"] == 12
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"traceEvents": []}))
    out = _cli("repro_torch.obs", "report", str(bare))
    assert out.returncode == 1 and "no repro_records" in out.stderr


def test_launch_serve_traces_and_writes_metrics(tmp_path):
    trace, metrics = tmp_path / "trace.json", tmp_path / "metrics.json"
    record = tlaunch.main(["--device", "cpu", "--kernel", "torch",
                           "--requests", "3", "--max-new", "3",
                           "--prefill-chunk", "5", "--trace-out", str(trace),
                           "--metrics-json", str(metrics)])
    assert record["kernel"] == "torch" and record["generated_tokens"] == 9
    assert record["latency"]["tokens"] == 9
    assert record["latency"]["finished"] == 3
    doc = json.loads(trace.read_text())
    assert len(doc["repro_records"]) == 3
    snap = json.loads(metrics.read_text())
    assert snap["version"] == 1
    assert snap["metrics"]["serve_tokens_total"]["value"] == 9
    assert snap["metrics"]["serve_requests_finished_total"]["value"] == 3
    with pytest.raises(ValueError, match="unknown kernel impl"):
        tlaunch.main(["--device", "cpu", "--kernel", "pallas",
                      "--requests", "1"])
