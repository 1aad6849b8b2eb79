"""Request lifecycle + admission for the serving engine.

Port of `repro/serve/scheduler.py`.  Requests move through

  QUEUED -> PREFILLING -> DECODING -> FINISHED(finish_reason)
                 ^             |
                 |             v
                 + <------ PREEMPTED   (requeued at its original
                                        arrival order within its class)

The queue is a priority queue (higher `priority` first, strict FIFO
within a class); each engine step spends a `TokenBudget` that mixes one
decode token per decoding slot with chunked-prefill window tokens, and
a blocked higher-priority request may preempt a lower-priority decoding
victim (`pick_victim`, `preempt`); the engine evicts and restores the
victim's cache.
finish_reason is "stop" (eos or a stop token) or "length".  An
`AdmissionPolicy` resolves the engine's slot count: `FixedSlots`, or
`ByteBudget` from the exact per-slot decode-cache bytes
(serve/cache.py); the paged engine's `PagedAdmission` (serve/paging.py)
admits by the pages a request needs.  An optional tracer (repro_torch.obs)
receives queued / admitted / blocked events; without one every hook site
is a single `is not None` check.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Iterator, List, Optional, Tuple

from repro_torch.serve.cache import per_slot_bytes
from repro_torch.tune import timer


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class StepOutput:
    """One emitted token (or state transition) of one request."""

    rid: int
    token: Optional[int]
    state: RequestState
    finished: bool = False
    finish_reason: Optional[str] = None  # "stop" | "length"
    # emission timestamp (tune.timer.now seconds); finish outputs carry
    # the scheduler's release stamp
    t: float = dataclasses.field(default_factory=timer.now)


class AdmissionPolicy:
    """Resolves how many concurrent slots a (cfg, max_len) engine runs."""

    def resolve_slots(self, cfg, max_len: int) -> int:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class FixedSlots(AdmissionPolicy):
    """Admit up to a fixed number of concurrent sequences."""

    slots: int = 4

    def resolve_slots(self, cfg, max_len: int) -> int:
        if self.slots < 1:
            raise ValueError(f"FixedSlots needs >= 1 slot, got {self.slots}")
        return self.slots


@dataclasses.dataclass(frozen=True)
class ByteBudget(AdmissionPolicy):
    """Admit while the decode-cache cost fits a device byte budget.

    A slot costs the exact marginal decode-cache bytes of one sequence
    (serve/cache.py's `per_slot_bytes`), so the same budget admits far
    more O(D^2)-state linear sequences than O(S)-KV softmax ones: the
    paper's memory story as admission control.
    """

    budget_bytes: int
    max_slots: int = 256  # batch-size guard, not a memory limit

    def resolve_slots(self, cfg, max_len: int) -> int:
        per = per_slot_bytes(cfg, max_len)
        n = min(self.max_slots, self.budget_bytes // per)
        if n < 1:
            raise ValueError(
                f"byte budget {self.budget_bytes} cannot admit even one "
                f"sequence: one slot's decode cache at max_len={max_len} "
                f"is {per} bytes (backend-resolved from cfg)")
        return int(n)


class TokenBudget:
    """One engine step's token ledger: decode first (one token per
    decoding slot), then prefill-window tokens while the next window
    fits.  The engine forces one window when nothing else ran, so a
    budget smaller than the chunk cannot livelock prefill."""

    def __init__(self, total: int):
        self.total = int(total)
        self.decode_tokens = 0
        self.prefill_tokens = 0

    @property
    def spent(self) -> int:
        return self.decode_tokens + self.prefill_tokens

    @property
    def remaining(self) -> int:
        return max(self.total - self.spent, 0)

    def fits(self, n: int) -> bool:
        return n <= self.remaining

    def spend_decode(self, n: int) -> None:
        self.decode_tokens += n

    def spend_prefill(self, n: int) -> None:
        self.prefill_tokens += n


class Scheduler:
    """Priority admission over a fixed slot array (slots index the
    engine's batched cache).  Within a priority class the queue is
    strictly FIFO by arrival, and it never skips its head.  A preempted
    request re-enters the queue under its ORIGINAL arrival order, so it
    resumes ahead of later arrivals of its own class."""

    def __init__(self, num_slots: int, tracer=None):
        self.num_slots = num_slots
        # heap of (-priority, arrival_seq, request)
        self.queue: List[tuple] = []
        self.slots: List[Optional[object]] = [None] * num_slots
        self.tracer = tracer   # repro_torch.obs.Tracer hooks, or None
        self._seq = 0          # arrival order, assigned once per request
        self._seq_of: dict = {}        # rid -> arrival seq
        self._admit_seq = 0            # admission recency (victim tie-break)
        self._admitted_at: dict = {}   # rid -> admission seq
        # why the queue head still waited after the last admit():
        # "resources" (can_admit refused it), "slots" or None
        self.blocked: Optional[str] = None

    def _push(self, req) -> None:
        prio = getattr(req, "priority", 0)
        heapq.heappush(self.queue, (-prio, self._seq_of[req.rid], req))

    def submit(self, req) -> None:
        req.state = RequestState.QUEUED
        self._seq_of[req.rid] = self._seq
        self._seq += 1
        self._push(req)
        if self.tracer is not None:
            self.tracer.request_queued(req.rid)

    def requeue(self, req) -> None:
        """Re-enter a preempted request under its original arrival seq
        (ahead of anything submitted after it in its priority class)."""
        req.state = RequestState.PREEMPTED
        self._push(req)

    def peek(self):
        """The next request admission would try, or None."""
        return self.queue[0][2] if self.queue else None

    def queued(self) -> Iterator[object]:
        """Waiting requests in admission order (heap order, exact)."""
        return (entry[2] for entry in sorted(self.queue))

    def admit(self, can_admit=None) -> List[Tuple[int, object]]:
        """Fill free slots from the queue head; returns [(slot, request)].

        `can_admit(req) -> bool` gates each admission beyond a free slot
        (the paged engine's free-page check).  A True verdict is ALWAYS
        followed by admission of that request, so the callback may
        reserve resources as its answer.  The queue never skips: when
        the head does not fit, admission stops rather than admit a later
        request past it, so a large request is not starved by small
        ones."""
        admitted = []
        self.blocked = None
        for i, occupant in enumerate(self.slots):
            if occupant is None and self.queue:
                head = self.queue[0][2]
                if can_admit is not None and not can_admit(head):
                    self.blocked = "resources"
                    break
                heapq.heappop(self.queue)
                self.slots[i] = head
                self._admitted_at[head.rid] = self._admit_seq
                self._admit_seq += 1
                admitted.append((i, head))
                if self.tracer is not None:
                    self.tracer.request_admitted(head.rid, i)
        if self.blocked is None and self.queue:
            self.blocked = "slots"
        if self.blocked is not None and self.tracer is not None:
            self.tracer.admission_blocked(self.queue[0][2].rid, self.blocked)
        return admitted

    def pick_victim(self, min_priority: int) -> Optional[int]:
        """Slot of the best preemption victim for a blocked request of
        `min_priority`: a DECODING occupant of strictly lower priority,
        lowest priority first, most recently admitted on ties (the newest
        work loses the least progress).  None if no slot holds an
        eligible victim (a PREFILLING slot is never preempted: its
        partial window state is not restorable)."""
        best = None
        for i, req in enumerate(self.slots):
            if req is None or req.state is not RequestState.DECODING:
                continue
            prio = getattr(req, "priority", 0)
            if prio >= min_priority:
                continue
            key = (prio, -self._admitted_at.get(req.rid, 0))
            if best is None or key < best[0]:
                best = (key, i)
        return None if best is None else best[1]

    def preempt(self, slot: int) -> object:
        """Evict the slot's occupant back into the queue (PREEMPTED, at
        its original arrival order).  The engine evicts and restores its
        cache around this call."""
        req = self.slots[slot]
        if req is None:
            raise ValueError(f"slot {slot} is empty; nothing to preempt")
        self.slots[slot] = None
        self.requeue(req)
        return req

    def release(self, slot: int, finish_reason: Optional[str] = None
                ) -> float:
        """Free the slot; stamps and returns the finish timestamp and
        propagates `finish_reason` onto the occupant."""
        t = timer.now()
        req = self.slots[slot]
        if req is not None and finish_reason is not None:
            req.finish_reason = finish_reason
        self.slots[slot] = None
        return t

    def active(self) -> Iterator[Tuple[int, object]]:
        """Occupied slots, whatever their occupant's state."""
        return ((i, r) for i, r in enumerate(self.slots) if r is not None)

    def decoding(self) -> Iterator[Tuple[int, object]]:
        """Slots whose occupant is past prefill."""
        return ((i, r) for i, r in enumerate(self.slots)
                if r is not None and r.state is RequestState.DECODING)

    def prefilling(self) -> List[Tuple[int, object]]:
        """Slots mid-prefill, in (priority desc, admission order) — the
        order the engine feeds them prefill-window budget."""
        rows = [(i, r) for i, r in enumerate(self.slots)
                if r is not None and r.state is RequestState.PREFILLING]
        rows.sort(key=lambda ir: (-getattr(ir[1], "priority", 0),
                                  self._admitted_at.get(ir[1].rid, 0)))
        return rows

    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slots)
