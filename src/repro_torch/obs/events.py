"""Per-request span/event recorder + Chrome trace-event export.

Port of `repro/obs/events.py`.  The engine's end-of-run tokens/s number
hides the request LIFECYCLE behind it —

    SUBMIT -> QUEUED -> ADMITTED -> PREFILL[window spans]
           -> DECODE[per-token ticks] -> FINISHED

— which this module records, so queue wait, time-to-first-token,
inter-token deltas and the prefill / decode split are measurable per
request.

Two layers:

  Tracer       the nil-by-default instrumentation protocol.  Every hook
               is a no-op; serve/engine.py, serve/scheduler.py and
               serve/paging.py call hooks only when a tracer is
               installed (`if tracer is not None`), so the disabled
               engine path costs one host-side None check per event and
               touches no device code; engine output with tracing on is
               token-identical to tracing off.
  ServeTracer  the real recorder: builds one RequestRecord span tree
               per rid, feeds a MetricsRegistry (obs/metrics.py), and
               exports a Chrome trace-event JSON loadable in Perfetto
               (one track per engine slot, one per request).

Timestamps come EXCLUSIVELY from `repro_torch.tune.timer.now()`, the
port's one monotonic clock (lint rules REPRO-L001/L004 keep it so).
Span ends are stamped on hook receipt; span starts (`t0`) are stamped
by the caller via `Tracer.clock()` so a span never includes the hook
dispatch itself.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

from repro_torch.obs.metrics import MetricsRegistry, percentiles
from repro_torch.tune import timer


class Tracer:
    """Nil instrumentation protocol — subclass and override.

    Hook order per request: request_submitted, request_queued, zero or
    more admission_blocked, request_admitted, one prefill_window per
    prompt chunk, one token_emitted per generated token (the first tick
    defines ttft), request_finished.  A preempted request additionally
    sees request_preempted (policy: "snapshot" | "page_keep" |
    "recompute", serve/engine.py) followed later by request_resumed —
    possibly several such pairs.  Engine-level: engine_step once
    per Engine.step(); pool-level: pages_changed / cow_fork /
    sink_repoint.  request_rejected replaces the whole tree for
    requests refused at submit.
    """

    @staticmethod
    def clock() -> float:
        """Span-start stamp for callers (tune.timer.now passthrough)."""
        return timer.now()

    # -- request lifecycle --------------------------------------------
    def request_submitted(self, rid: int, prompt_len: int,
                          max_new: int) -> None:
        pass

    def request_queued(self, rid: int) -> None:
        pass

    def request_rejected(self, rid: int, reason: str) -> None:
        pass

    def admission_blocked(self, rid: int, reason: str) -> None:
        pass

    def request_admitted(self, rid: int, slot: int) -> None:
        pass

    def prefill_window(self, rid: int, slot: int, tokens: int,
                       t0: float) -> None:
        pass

    def token_emitted(self, rid: int, slot: int) -> None:
        pass

    def request_preempted(self, rid: int, slot: int,
                          policy: str) -> None:
        pass

    def request_resumed(self, rid: int, slot: int, policy: str) -> None:
        pass

    def request_finished(self, rid: int, reason: str,
                         t: Optional[float] = None) -> None:
        pass

    # -- engine / pool level ------------------------------------------
    def engine_step(self, t0: float, active: int, slots: int,
                    queued: int) -> None:
        pass

    def pages_changed(self, in_use: int, free: int) -> None:
        pass

    def cow_fork(self) -> None:
        pass

    def sink_repoint(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Per-request derived record
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RequestRecord:
    """One request's span tree, with the derived latency quantities the
    scheduler roadmap items are judged on."""

    rid: int
    prompt_len: int = 0
    max_new: int = 0
    submit_t: Optional[float] = None
    queued_t: Optional[float] = None
    admitted_t: Optional[float] = None
    slot: Optional[int] = None
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    finish_reason: Optional[str] = None
    blocked: int = 0                      # admission_blocked events seen
    token_ts: List[float] = dataclasses.field(default_factory=list)
    # (t0, t1, tokens) per prefill window, in execution order
    prefill_windows: List[tuple] = dataclasses.field(default_factory=list)
    # (t, slot, policy) per eviction / per resume, in order
    preempt_events: List[tuple] = dataclasses.field(default_factory=list)
    resume_events: List[tuple] = dataclasses.field(default_factory=list)

    # -- derived -------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self.finish_t is not None

    @property
    def tokens(self) -> int:
        return len(self.token_ts)

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.admitted_t is None or self.queued_t is None:
            return None
        return self.admitted_t - self.queued_t

    @property
    def ttft_s(self) -> Optional[float]:
        """First token minus submit — the user-visible first-byte wait
        (queue wait + prefill + first sample)."""
        start = self.submit_t if self.submit_t is not None else self.queued_t
        if self.first_token_t is None or start is None:
            return None
        return self.first_token_t - start

    @property
    def inter_token_s(self) -> List[float]:
        return [b - a for a, b in zip(self.token_ts, self.token_ts[1:])]

    @property
    def preemptions(self) -> int:
        return len(self.preempt_events)

    @property
    def preempted_s(self) -> Optional[float]:
        """Total time spent evicted (sum of preempt -> resume spans);
        None if the request was never preempted."""
        if not self.preempt_events:
            return None
        total = 0.0
        for (t0, _, _), (t1, _, _) in zip(self.preempt_events,
                                          self.resume_events):
            total += t1 - t0
        return total

    @property
    def prefill_s(self) -> Optional[float]:
        if not self.prefill_windows:
            return None
        return sum(t1 - t0 for t0, t1, _ in self.prefill_windows)

    @property
    def decode_s(self) -> Optional[float]:
        if self.finish_t is None or self.first_token_t is None:
            return None
        return self.finish_t - self.first_token_t

    @property
    def total_s(self) -> Optional[float]:
        start = self.submit_t if self.submit_t is not None else self.queued_t
        if self.finish_t is None or start is None:
            return None
        return self.finish_t - start

    def to_json(self) -> dict:
        itl = percentiles(self.inter_token_s, (50, 99))
        return {
            "rid": self.rid, "prompt_len": self.prompt_len,
            "max_new": self.max_new, "slot": self.slot,
            "tokens": self.tokens, "finish_reason": self.finish_reason,
            "blocked": self.blocked, "closed": self.closed,
            "submit_t": self.submit_t, "finish_t": self.finish_t,
            "queue_wait_s": self.queue_wait_s, "ttft_s": self.ttft_s,
            "prefill_s": self.prefill_s, "decode_s": self.decode_s,
            "total_s": self.total_s,
            "prefill_windows": len(self.prefill_windows),
            "preemptions": self.preemptions,
            "preempted_s": self.preempted_s,
            "inter_token_p50_s": itl[50], "inter_token_p99_s": itl[99],
        }


# ---------------------------------------------------------------------------
# The real recorder
# ---------------------------------------------------------------------------

def _ms(ps: Dict[float, Optional[float]]) -> Dict[str, Optional[float]]:
    return {f"p{int(p)}": None if v is None else round(v * 1e3, 4)
            for p, v in ps.items()}


class ServeTracer(Tracer):
    """Records every event, derives RequestRecords, feeds metrics."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._reqs: Dict[int, RequestRecord] = {}
        self._steps: List[tuple] = []   # (t0, t1, active, slots, queued)
        self._t0: Optional[float] = None
        m = self.metrics
        self._c_submitted = m.counter(
            "serve_requests_submitted_total", "requests submitted")
        self._c_accept = m.counter(
            "serve_admission_accept_total", "requests admitted to a slot")
        self._c_block = m.counter(
            "serve_admission_block_total",
            "admission attempts blocked (head of FIFO queue waiting on "
            "slots or pages)")
        self._c_reject = m.counter(
            "serve_admission_reject_total",
            "requests refused at submit (can never be admitted)")
        self._c_finished = m.counter(
            "serve_requests_finished_total", "requests finished")
        self._c_tokens = m.counter(
            "serve_tokens_total", "tokens emitted")
        self._c_forks = m.counter(
            "serve_page_cow_forks_total", "copy-on-write page-table forks")
        self._c_sink = m.counter(
            "serve_sink_repoints_total",
            "freed slots re-pointed at the arena sink page")
        self._c_preempt = m.counter(
            "serve_preemptions_total",
            "requests evicted mid-decode for higher-priority work")
        self._c_resume = m.counter(
            "serve_resumes_total",
            "preempted requests re-admitted (page swap, snapshot "
            "restore, or drop-and-recompute)")
        self._g_active = m.gauge(
            "serve_slots_active", "slots decoding this step")
        self._g_occ = m.gauge(
            "serve_slot_occupancy",
            "batch utilization: active slots / total slots (padded "
            "decode rows are wasted compute)")
        self._g_queue = m.gauge(
            "serve_queue_depth", "requests waiting in the FIFO queue")
        self._g_pages_used = m.gauge(
            "serve_pages_in_use", "arena pages allocated")
        self._g_pages_free = m.gauge(
            "serve_pages_free", "arena pages on the free list")
        self._h_ttft = m.histogram(
            "serve_ttft_seconds", "submit -> first token")
        self._h_itl = m.histogram(
            "serve_inter_token_seconds", "delta between consecutive "
            "tokens of one request")
        self._h_queue = m.histogram(
            "serve_queue_wait_seconds", "queued -> admitted")
        self._h_prefill = m.histogram(
            "serve_prefill_window_seconds", "one chunked-prefill window")
        self._h_step = m.histogram(
            "serve_step_seconds", "one Engine.step() iteration")
        self._h_e2e = m.histogram(
            "serve_e2e_seconds", "submit -> finished")
        self._h_preempted = m.histogram(
            "serve_preempted_seconds", "one preempt -> resume span")

    # -- internals -----------------------------------------------------
    def _rec(self, rid: int) -> RequestRecord:
        rec = self._reqs.get(rid)
        if rec is None:
            rec = self._reqs[rid] = RequestRecord(rid=rid)
        return rec

    def _stamp(self, t: Optional[float] = None) -> float:
        t = timer.now() if t is None else t
        if self._t0 is None or t < self._t0:
            self._t0 = t
        return t

    # -- Tracer hooks --------------------------------------------------
    def request_submitted(self, rid, prompt_len, max_new):
        rec = self._rec(rid)
        rec.submit_t = self._stamp()
        rec.prompt_len = prompt_len
        rec.max_new = max_new
        self._c_submitted.inc()

    def request_queued(self, rid):
        self._rec(rid).queued_t = self._stamp()

    def request_rejected(self, rid, reason):
        rec = self._rec(rid)
        rec.finish_t = self._stamp()
        rec.finish_reason = f"rejected:{reason}"
        self._c_reject.inc()

    def admission_blocked(self, rid, reason):
        self._rec(rid).blocked += 1
        self._c_block.inc()

    def request_admitted(self, rid, slot):
        rec = self._rec(rid)
        rec.admitted_t = self._stamp()
        rec.slot = slot
        self._c_accept.inc()
        if rec.queued_t is not None:
            self._h_queue.observe(rec.admitted_t - rec.queued_t)

    def prefill_window(self, rid, slot, tokens, t0):
        t1 = self._stamp()
        self._rec(rid).prefill_windows.append((t0, t1, tokens))
        self._h_prefill.observe(t1 - t0)

    def token_emitted(self, rid, slot):
        rec = self._rec(rid)
        t = self._stamp()
        if not rec.token_ts:
            rec.first_token_t = t
            start = rec.submit_t if rec.submit_t is not None \
                else rec.queued_t
            if start is not None:
                self._h_ttft.observe(t - start)
        else:
            self._h_itl.observe(t - rec.token_ts[-1])
        rec.token_ts.append(t)
        self._c_tokens.inc()

    def request_preempted(self, rid, slot, policy):
        self._rec(rid).preempt_events.append(
            (self._stamp(), slot, policy))
        self._c_preempt.inc()

    def request_resumed(self, rid, slot, policy):
        rec = self._rec(rid)
        t = self._stamp()
        rec.resume_events.append((t, slot, policy))
        self._c_resume.inc()
        if rec.preempt_events:
            self._h_preempted.observe(t - rec.preempt_events[-1][0])

    def request_finished(self, rid, reason, t=None):
        rec = self._rec(rid)
        rec.finish_t = self._stamp(t)
        rec.finish_reason = reason
        self._c_finished.inc()
        if rec.total_s is not None:
            self._h_e2e.observe(rec.total_s)

    def engine_step(self, t0, active, slots, queued):
        t1 = self._stamp()
        self._steps.append((t0, t1, active, slots, queued))
        self._g_active.set(active)
        self._g_occ.set(active / slots if slots else 0.0)
        self._g_queue.set(queued)
        self._h_step.observe(t1 - t0)

    def pages_changed(self, in_use, free):
        self._g_pages_used.set(in_use)
        self._g_pages_free.set(free)

    def cow_fork(self):
        self._c_forks.inc()

    def sink_repoint(self):
        self._c_sink.inc()

    def reset(self) -> None:
        """Drop every record, step span and metric sample, keeping the
        tracer OBJECT (the engine, scheduler and page pool all hold a
        reference to it).  Lets a caller run a warm-up workload (kernel
        builds, first launches) through the instrumented engine and then
        measure from a clean slate."""
        self.__init__()

    # -- derived views -------------------------------------------------
    def records(self) -> List[RequestRecord]:
        return [self._reqs[rid] for rid in sorted(self._reqs)]

    def occupancy(self) -> Optional[float]:
        """Mean active-slots / total-slots over the engine steps seen:
        the batch utilization."""
        if not self._steps:
            return None
        return sum(a / s for _, _, a, s, _ in self._steps if s) \
            / len(self._steps)

    def summary(self) -> dict:
        """Exact p50/p99 over the raw per-request samples
        (obs.metrics.percentiles), plus occupancy and preemptions."""
        recs = self.records()
        ttfts = [r.ttft_s for r in recs if r.ttft_s is not None]
        waits = [r.queue_wait_s for r in recs
                 if r.queue_wait_s is not None]
        itl = [d for r in recs for d in r.inter_token_s]
        occ = self.occupancy()
        return {
            "requests": len(recs),
            "finished": sum(1 for r in recs if r.closed),
            "tokens": sum(r.tokens for r in recs),
            "ttft_ms": _ms(percentiles(ttfts, (50, 99))),
            "inter_token_ms": _ms(percentiles(itl, (50, 99))),
            "queue_wait_ms": _ms(percentiles(waits, (50, 99))),
            "occupancy": None if occ is None else round(occ, 4),
            "preemptions": sum(r.preemptions for r in recs),
            "steps": len(self._steps),
        }

    # -- Chrome trace export -------------------------------------------
    def export_chrome_trace(self, path: Optional[str] = None) -> dict:
        """Chrome trace-event JSON (chrome://tracing / Perfetto).

        Tracks: pid 0 "engine" (step spans), pid 1 "slots" (one tid per
        slot: prefill windows + token instants — what each batch lane
        was doing), pid 2 "requests" (one tid per rid: queued / prefill
        / decode phase spans + token instants — each request's own
        timeline).  Extra top-level keys (`repro_records`,
        `repro_summary`) carry the derived records; Perfetto ignores
        them, `python -m repro_torch.obs report` reads them.
        """
        t0 = self._t0 if self._t0 is not None else 0.0

        def us(t):
            return round((t - t0) * 1e6, 1)

        ev: List[dict] = []

        def meta(pid, name, tid=None):
            if tid is None:
                ev.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": name}})
            else:
                ev.append({"ph": "M", "name": "thread_name", "pid": pid,
                           "tid": tid, "args": {"name": name}})

        def span(pid, tid, name, a, b, **args):
            ev.append({"ph": "X", "pid": pid, "tid": tid, "name": name,
                       "ts": us(a), "dur": max(round((b - a) * 1e6, 1), 0),
                       "args": args})

        def instant(pid, tid, name, t, **args):
            ev.append({"ph": "i", "s": "t", "pid": pid, "tid": tid,
                       "name": name, "ts": us(t), "args": args})

        meta(0, "engine")
        meta(0, "steps", tid=0)
        meta(1, "slots")
        meta(2, "requests")

        for s0, s1, active, slots, queued in self._steps:
            span(0, 0, "step", s0, s1, active=active, slots=slots,
                 queued=queued)

        slots_seen = set()
        last_t = max([s1 for _, s1, *_ in self._steps] or [t0])
        for rec in self.records():
            end = rec.finish_t if rec.finish_t is not None else last_t
            start = rec.submit_t if rec.submit_t is not None \
                else rec.queued_t
            meta(2, f"req {rec.rid}", tid=rec.rid)
            if start is not None:
                span(2, rec.rid, f"request {rec.rid}", start, end,
                     prompt_len=rec.prompt_len, tokens=rec.tokens,
                     finish_reason=rec.finish_reason)
            if rec.queued_t is not None and rec.admitted_t is not None:
                span(2, rec.rid, "queued", rec.queued_t, rec.admitted_t,
                     blocked=rec.blocked)
            if rec.admitted_t is not None and rec.first_token_t is not None:
                span(2, rec.rid, "prefill", rec.admitted_t,
                     rec.first_token_t,
                     windows=len(rec.prefill_windows))
            if rec.first_token_t is not None:
                span(2, rec.rid, "decode", rec.first_token_t, end,
                     tokens=rec.tokens)
            for (p0, _, policy), (p1, _, _) in zip(rec.preempt_events,
                                                   rec.resume_events):
                span(2, rec.rid, "preempted", p0, p1, policy=policy)
            for t in rec.token_ts:
                instant(2, rec.rid, "tok", t)
            if rec.slot is not None:
                slots_seen.add(rec.slot)
                for w0, w1, ntok in rec.prefill_windows:
                    span(1, rec.slot, f"prefill rid={rec.rid}", w0, w1,
                         tokens=ntok)
                for t in rec.token_ts:
                    instant(1, rec.slot, f"tok rid={rec.rid}", t)
        for slot in sorted(slots_seen):
            meta(1, f"slot {slot}", tid=slot)

        doc = {"traceEvents": ev, "displayTimeUnit": "ms",
               "repro_records": [r.to_json() for r in self.records()],
               "repro_summary": self.summary()}
        if path:
            parent = os.path.dirname(path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(path, "w") as f:
                json.dump(doc, f, indent=1)
        return doc
