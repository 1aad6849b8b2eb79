"""Continuous-batching serving engine, contiguous or paged KV cache.

Port of `repro/serve/engine.py` without preemption and the tracer:

  sampling.SamplingParams   per-request temperature / top-k / top-p /
                            stop tokens / seed
  scheduler.Scheduler       priority queue + slot array; an
                            AdmissionPolicy (FixedSlots, ByteBudget,
                            paging.PagedAdmission) resolves the slot
                            count
  Engine                    owns the batched cache; step() advances one
                            engine iteration and returns StepOutputs,
                            stream() yields them, run() drains to a
                            rid -> tokens dict

Every `step()` spends a TokenBudget: first one decode token per decoding
slot, then as many chunked-prefill window tokens as still fit (at least
one window whenever prefill work exists).  A mid-prefill request keeps
its own batch-1 cache (the carry); only its final window writes the
carry into the slot's rows of the batched cache and samples the first
token from the prefill's last logits.  Decode runs over every slot at
once, updating the batched cache in place; empty, retired and
mid-prefill slots decode as padding, and a completing prefill overwrites
whatever padding wrote into its rows.

Paged (`page_size`, `num_pages` or a PagedAdmission policy): every
layer keeps its cache in an arena of pages shared by the slots.  The
softmax backend pages its KV (fixed-size pages of KV rows); the gla
backend pages its recurrent state, one page per request whatever its
length (a page is one slot's whole O(D^2) state).  Admission reserves
the pages a request needs for its whole life (KV: prompt + max_new - 1
positions; state: one page) from a PagePool, strictly FIFO: a head
whose pages are not free blocks the queue.  The carry of a
paged prefill is not a cache of its own: it holds the engine's arena
tensors (the windows write the request's pages in place) with the
request's own page-table row and position, so installing it copies the
row and the position only.  The last arena page is a write sink: every
row of a slot without pages (never admitted, mid-prefill or retired)
points at it, so padding decode never writes into a live page; freed
pages are reused LIFO and a new request masks the stale rows by length.
A state page accumulates instead, so `_place` zeroes a request's state
page before its first window.

Left for later slices (ROADMAP.md): preemption (with GLA's page-keep
policy), applying copy-on-write forks and the tracer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import PagingCfg
from repro_torch.device import resolve_device
from repro_torch.mixers import get_backend, resolve_backend_name
from repro_torch.models import model as mdl
from repro_torch.serve import sampling as smp
from repro_torch.serve.paging import PagedAdmission, PagePool
from repro_torch.serve.scheduler import AdmissionPolicy, ByteBudget, \
    FixedSlots, RequestState, Scheduler, StepOutput, TokenBudget


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list                     # token ids
    max_new_tokens: int = 32
    temperature: float = 0.0         # shorthand; `sampling` wins if set
    priority: int = 0                # higher admits first
    sampling: Optional[smp.SamplingParams] = None
    generated: Optional[list] = None
    state: RequestState = RequestState.QUEUED
    finish_reason: Optional[str] = None

    def resolved_sampling(self) -> smp.SamplingParams:
        return self.sampling or smp.SamplingParams(
            temperature=self.temperature)


@dataclasses.dataclass
class _PrefillJob:
    """Progress of one partially-prefilled slot: the prompt windows still
    to run and the request's own batch-1 cache (`carry`)."""

    req: Request
    windows: List[list]
    carry: dict


class Engine:
    def __init__(self, cfg, params, *, max_slots: int = 4,
                 max_len: int = 4096, eos_id: int = 2, seed: int = 0,
                 policy: Optional[AdmissionPolicy] = None,
                 prefill_chunk: Optional[int] = None,
                 fused_decode: Optional[bool] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        if fused_decode is not None:
            # deployment knob: the fused decode kernels or the unfused
            # composition (cfg.la.fused_decode)
            cfg = dataclasses.replace(
                cfg, la=dataclasses.replace(cfg.la,
                                            fused_decode=fused_decode))
        self.policy = policy if policy is not None else FixedSlots(max_slots)
        # paged-KV mode: PagedAdmission implies it (arena sized from its
        # byte budget); page_size / num_pages ask for it explicitly
        if isinstance(self.policy, PagedAdmission):
            if page_size is not None or num_pages is not None:
                raise ValueError(
                    "PagedAdmission already fixes page_size/num_pages "
                    "from its byte budget; drop the engine kwargs")
            page_size = self.policy.page_size
            num_pages = self.policy.resolve_num_pages(cfg)
        elif page_size is not None and isinstance(self.policy, ByteBudget):
            # ByteBudget's per-slot charge shrinks to the int32 table row
            # once the arena has no batch dim: the page-aware byte policy
            # is PagedAdmission
            raise ValueError(
                "ByteBudget admission cannot size a paged engine; use "
                "PagedAdmission(budget_bytes, page_size=...) instead")
        if num_pages is not None and page_size is None:
            raise ValueError(
                "num_pages without page_size: set page_size to enable "
                "the paged-KV cache")
        # gla pages hold one slot's recurrent STATE each; softmax pages
        # hold page_size KV rows
        self._state_paged = (page_size is not None
                             and resolve_backend_name(cfg) == "gla")
        if page_size is not None:
            if num_pages is None:
                # default arena: worst case for every slot, plus the sink
                per_seq = 1 if self._state_paged \
                    else -(-max_len // page_size)
                num_pages = self.policy.resolve_slots(cfg, max_len) \
                    * per_seq + 1
            cfg = dataclasses.replace(
                cfg, paging=PagingCfg(page_size=page_size,
                                      num_pages=num_pages))
        self.cfg = cfg
        get_backend(cfg)  # validates cfg before anything is allocated
        # one copy of each matrix in the compute dtype (same numbers as a
        # cast at every call)
        self.params = mdl.compute_params(params, cfg)
        self.max_len = max_len
        self.eos_id = eos_id
        self.seed = seed
        self.prefill_chunk = prefill_chunk
        self.num_slots = self.policy.resolve_slots(cfg, max_len)
        self.scheduler = Scheduler(self.num_slots)
        # per-step token budget: a decode token for every slot + one
        # prefill window
        self.token_budget = self.num_slots + (prefill_chunk or max_len)
        self.decode_steps = 0   # batched decode steps run so far

        n = self.num_slots
        # a paged cache starts with every table row at the sink page
        # (the mixer's init_cache fills it so)
        self.cache = mdl.init_cache(cfg, n, max_len, self.device)
        self.pool: Optional[PagePool] = None
        if cfg.paging is not None:
            self._sink_page = cfg.paging.num_pages - 1
            self._pages_per_seq = self.cache["blocks"][0].page_table.shape[1]
            self.pool = PagePool(cfg.paging.num_pages - 1,
                                 cfg.paging.page_size)
        self.next_tokens = np.zeros((n,), np.int64)
        self.remaining = np.zeros((n,), np.int64)
        # per-slot sampling state, handed to sampling.sample each step
        self._temp = torch.zeros((n,), dtype=torch.float32)
        self._topk = torch.zeros((n,), dtype=torch.int32)
        self._topp = torch.ones((n,), dtype=torch.float32)
        self._gens: List[Optional[torch.Generator]] = [None] * n
        self._params_of: List[Optional[smp.SamplingParams]] = [None] * n
        self._requests: Dict[int, Request] = {}
        self._jobs: Dict[int, _PrefillJob] = {}

    # -- public API ----------------------------------------------------
    def request(self, rid: int) -> Request:
        """The submitted Request (generated tokens, state and
        finish_reason update in place as the engine advances)."""
        return self._requests[rid]

    def submit(self, req: Request):
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request {req.rid}: max_new_tokens must be >= 1 (the "
                f"prompt's final logits always yield one sampled "
                f"token), got {req.max_new_tokens}")
        if len(req.prompt) == 0:
            raise ValueError(
                f"request {req.rid}: empty prompt (prefill needs at "
                f"least one token to produce logits)")
        live = self._requests.get(req.rid)
        if live is not None and live.state is not RequestState.FINISHED:
            raise ValueError(
                f"request id {req.rid} is already live "
                f"(state={live.state.value})")
        need = len(req.prompt) + req.max_new_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)} tokens) + "
                f"max_new_tokens ({req.max_new_tokens}) needs {need} cache "
                f"positions but the engine was built with max_len="
                f"{self.max_len}")
        if self.pool is not None \
                and self._req_pages(req) > self.pool.num_pages:
            # would never admit: the queue would deadlock behind it
            kind = "state" if self._state_paged else "KV"
            detail = "a page holds one slot's whole recurrent state" \
                if self._state_paged \
                else f"page_size={self.pool.page_size}"
            raise ValueError(
                f"request {req.rid} needs {self._req_pages(req)} {kind} "
                f"pages but the whole arena has {self.pool.num_pages} "
                f"allocatable pages ({detail})")
        if req.generated is None:
            req.generated = []
        self._requests[req.rid] = req
        self.scheduler.submit(req)

    def step(self) -> List[StepOutput]:
        """Admit, decode one token per decoding slot, then run prefill
        windows with the remaining budget.  Returns the StepOutputs."""
        budget = TokenBudget(self.token_budget)
        for slot, req in self.scheduler.admit(self._can_admit):
            self._place(slot, req)
        outputs = self._decode_once(budget)
        self._prefill_round(budget, outputs)
        return outputs

    def stream(self) -> Iterator[StepOutput]:
        """Yield StepOutputs until queue and slots drain."""
        while self.scheduler.has_work():
            yield from self.step()

    def run(self) -> Dict[int, list]:
        """Run until queue + slots drain.  Returns rid -> generated ids."""
        done: Dict[int, list] = {}
        for out in self.stream():
            if out.finished:
                done[out.rid] = self._requests[out.rid].generated
        return done

    # -- admission + prefill ---------------------------------------------
    def _can_admit(self, req: Request) -> bool:
        """Beyond a free slot, a paged engine needs the request's pages
        free RIGHT NOW (its whole token footprint).  The check RESERVES
        them: `Scheduler.admit` may probe several queued requests for
        one batch of free slots before any is prefilled, and a True
        verdict is always followed by admission, so a reservation never
        leaks."""
        if self.pool is None:
            return True
        need = self._req_pages(req)
        if need > self.pool.free_pages:
            return False
        self.pool.allocate_pages(req.rid, need)
        return True

    def _place(self, slot: int, req: Request) -> None:
        if self.pool is None:
            carry = mdl.init_cache(self.cfg, 1, self.max_len, self.device)
        else:
            # the engine's own arenas, written in place by the windows;
            # only the page-table row and the position are the request's
            pages = self.pool.table(req.rid)
            self._zero_state_pages(pages)
            row = self._page_row(pages)[None]
            carry = {"blocks": [big._replace(page_table=row)
                                for big in self.cache["blocks"]],
                     "pos": torch.zeros((1,), dtype=torch.int32,
                                        device=self.device)}
        self._jobs[slot] = _PrefillJob(req=req,
                                       windows=self._windows(req.prompt),
                                       carry=carry)
        req.state = RequestState.PREFILLING

    def _windows(self, prompt: list) -> List[list]:
        w = self.prefill_chunk
        if w is None or len(prompt) <= w:
            return [list(prompt)]
        return [prompt[i:i + w] for i in range(0, len(prompt), w)]

    def _run_window(self, job: _PrefillJob):
        window = job.windows.pop(0)
        tokens = torch.tensor([window], dtype=torch.int64,
                              device=self.device)
        logits, job.carry = mdl.prefill(self.params, self.cfg,
                                        {"tokens": tokens}, job.carry)
        return logits

    def _install(self, slot: int, carry: dict) -> None:
        """Write a finished batch-1 carry into the slot's rows of the
        batched cache (overwriting what padding decode wrote there)."""
        for big, small in zip(self.cache["blocks"], carry["blocks"]):
            for b_t, s_t in zip(big, small):
                # a paged arena is the carry's own tensor, written in
                # place: only its page-table row is copied
                if b_t is not s_t:
                    b_t[slot].copy_(s_t[0])
        self.cache["pos"][slot] = carry["pos"][0]

    def _set_sampling(self, slot: int, req: Request) -> None:
        sp = req.resolved_sampling()
        self._params_of[slot] = sp
        self._temp[slot] = sp.temperature
        self._topk[slot] = sp.top_k
        self._topp[slot] = sp.top_p
        self._gens[slot] = smp.request_generator(sp, self.seed, req.rid,
                                                 self.device)

    def _run_final_window(self, slot: int, job: _PrefillJob) -> StepOutput:
        logits = self._run_window(job)
        self._install(slot, job.carry)
        del self._jobs[slot]
        req = job.req
        self._set_sampling(slot, req)
        tok = int(smp.sample(logits, self._gens[slot:slot + 1],
                             self._temp[slot:slot + 1],
                             self._topk[slot:slot + 1],
                             self._topp[slot:slot + 1])[0])
        self.next_tokens[slot] = tok
        self.remaining[slot] = req.max_new_tokens - 1
        req.generated.append(tok)
        req.state = RequestState.DECODING
        reason = self._finish_reason(slot, tok, self._params_of[slot])
        if reason:
            return self._finish(slot, req, tok, reason)
        return StepOutput(req.rid, tok, req.state)

    def _prefill_round(self, budget: TokenBudget,
                       outputs: List[StepOutput]) -> None:
        """Spend the remaining budget on prefill windows, round-robin
        over mid-prefill slots in (priority, admission) order; at least
        ONE window runs whenever prefill work exists."""
        ran_any = False
        while True:
            progressed = False
            for slot, _ in self.scheduler.prefilling():
                job = self._jobs[slot]
                if not budget.fits(len(job.windows[0])):
                    continue
                self._spend_window(slot, job, budget, outputs)
                progressed = ran_any = True
            if not progressed:
                break
        if not ran_any:
            cands = self.scheduler.prefilling()
            if cands:
                slot = cands[0][0]
                self._spend_window(slot, self._jobs[slot], budget, outputs)

    def _spend_window(self, slot: int, job: _PrefillJob,
                      budget: TokenBudget,
                      outputs: List[StepOutput]) -> None:
        budget.spend_prefill(len(job.windows[0]))
        if len(job.windows) == 1:
            outputs.append(self._run_final_window(slot, job))
        else:
            self._run_window(job)

    # -- decode ----------------------------------------------------------
    def _decode_once(self, budget: TokenBudget) -> List[StepOutput]:
        decoding = list(self.scheduler.decoding())
        if not decoding:
            return []
        budget.spend_decode(len(decoding))
        tokens = torch.from_numpy(self.next_tokens).to(self.device)
        # the batched cache is updated in place (the reference donates it)
        logits, self.cache = mdl.decode_step(self.params, self.cfg,
                                             self.cache, tokens)
        self.decode_steps += 1
        nxt = smp.sample(logits, self._gens, self._temp, self._topk,
                         self._topp).cpu().numpy()
        outputs = []
        for slot, req in decoding:
            tok = int(nxt[slot])
            req.generated.append(tok)
            self.next_tokens[slot] = tok
            self.remaining[slot] -= 1
            reason = self._finish_reason(slot, tok, self._params_of[slot])
            if reason:
                outputs.append(self._finish(slot, req, tok, reason))
            else:
                outputs.append(StepOutput(req.rid, tok, req.state))
        return outputs

    # -- lifecycle -------------------------------------------------------
    def _finish_reason(self, slot: int, tok: int,
                       sp: smp.SamplingParams) -> Optional[str]:
        if tok == self.eos_id or tok in sp.stop:
            return "stop"
        if self.remaining[slot] <= 0:
            return "length"
        return None

    def _finish(self, slot: int, req: Request, tok: int,
                reason: str) -> StepOutput:
        req.state = RequestState.FINISHED
        t_fin = self.scheduler.release(slot, finish_reason=reason)
        if self.pool is not None:
            # return the pages and re-point the slot at the sink page: the
            # retired slot keeps decoding as batch padding, and its writes
            # must not land in pages the free list may re-issue
            self.pool.free(req.rid)
            self._set_sink_row(slot)
        self._params_of[slot] = None
        self._gens[slot] = None
        self._temp[slot] = 0.0  # freed slots decode greedily (masked out)
        return StepOutput(req.rid, tok, req.state, finished=True,
                          finish_reason=reason, t=t_fin)

    # -- paged KV and paged state ---------------------------------------
    def _page_row(self, pages: List[int]) -> torch.Tensor:
        """A (Pmax,) int32 page-table row: `pages`, then the sink page."""
        row = torch.full((self._pages_per_seq,), self._sink_page,
                         dtype=torch.int32)
        row[:len(pages)] = torch.tensor(pages, dtype=torch.int32)
        return row.to(self.device)

    def _set_sink_row(self, slot: int) -> None:
        """Point the BATCHED cache's page-table row of `slot` (every
        layer) at the sink page (the reference's `_set_page_row(slot,
        [])`): a completing prefill installs a live row from its
        carry."""
        row = self._page_row([])
        for layer in self.cache["blocks"]:
            layer.page_table[slot] = row

    def _zero_state_pages(self, pages: List[int]) -> None:
        """A paged gla state accumulates: a page handed to a new request
        (freed pages come back LIFO, still holding their last request's
        state) must not seed its recurrence.  KV pages need no wipe:
        attention masks them by length."""
        if not self._state_paged:
            return
        idx = torch.tensor(pages, dtype=torch.long, device=self.device)
        for layer in self.cache["blocks"]:
            layer.s_pages.index_fill_(0, idx, 0.0)
            layer.p_pages.index_fill_(0, idx, 0.0)

    def _req_pages(self, req: Request) -> int:
        """Arena pages the request needs for its whole lifetime."""
        if self._state_paged:
            return 1   # one O(D^2) state page, whatever its tokens
        return self.pool.pages_needed(self._token_footprint(req))

    @staticmethod
    def _token_footprint(req: Request) -> int:
        # cache positions written: len(prompt) prefill + max_new - 1
        # decode (max_new >= 1 is enforced at submit)
        return len(req.prompt) + req.max_new_tokens - 1

    def page_stats(self) -> Optional[Dict[str, int]]:
        """None unless paged; else allocatable / free / in-use pages."""
        if self.pool is None:
            return None
        return {"page_size": self.pool.page_size,
                "num_pages": self.pool.num_pages,
                "free_pages": self.pool.free_pages,
                "pages_in_use": self.pool.pages_in_use}
