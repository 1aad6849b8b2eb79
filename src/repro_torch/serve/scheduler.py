"""Request lifecycle + admission for the serving engine.

Port of `repro/serve/scheduler.py` without preemption, ByteBudget
admission and the tracer hooks (all on ROADMAP.md).  Requests move through

  QUEUED -> PREFILLING -> DECODING -> FINISHED(finish_reason)

The queue is a priority queue (higher `priority` first, strict FIFO
within a class); each engine step spends a `TokenBudget` that mixes one
decode token per decoding slot with chunked-prefill window tokens.
finish_reason is "stop" (eos or a stop token) or "length".
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
from typing import Iterator, List, Optional, Tuple

from repro_torch.tune import timer


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
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


@dataclasses.dataclass(frozen=True)
class FixedSlots:
    """Admit up to a fixed number of concurrent sequences."""

    slots: int = 4

    def resolve_slots(self, cfg, max_len: int) -> int:
        if self.slots < 1:
            raise ValueError(f"FixedSlots needs >= 1 slot, got {self.slots}")
        return self.slots


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
    strictly FIFO by arrival, and it never skips its head."""

    def __init__(self, num_slots: int):
        self.num_slots = num_slots
        # heap of (-priority, arrival_seq, request)
        self.queue: List[tuple] = []
        self.slots: List[Optional[object]] = [None] * num_slots
        self._seq = 0
        self._admit_seq = 0
        self._admitted_at: dict = {}   # rid -> admission seq

    def submit(self, req) -> None:
        req.state = RequestState.QUEUED
        prio = getattr(req, "priority", 0)
        heapq.heappush(self.queue, (-prio, self._seq, req))
        self._seq += 1

    def admit(self) -> List[Tuple[int, object]]:
        """Fill free slots from the queue head; returns [(slot, request)]."""
        admitted = []
        for i, occupant in enumerate(self.slots):
            if occupant is None and self.queue:
                _, _, head = heapq.heappop(self.queue)
                self.slots[i] = head
                self._admitted_at[head.rid] = self._admit_seq
                self._admit_seq += 1
                admitted.append((i, head))
        return admitted

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
