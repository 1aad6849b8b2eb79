"""Paged-KV page pool and page-based admission (port of
`repro/serve/paging.py`, without the tracer hooks).

The contiguous serving cache reserves batch x max_len KV rows up front,
so admission must charge every request the worst case.  The paged cache
instead keeps each layer's KV in a shared arena of fixed-size pages:

  PagePool        host-side manager of the arena's pages: a LIFO free
                  list, per-request page tables, ref-counted pages with
                  copy-on-write `fork` (identical prompt prefixes share
                  full pages).  The pool keeps BOOKKEEPING only: the
                  tensors live in the engine's cache
                  (mixers/cache.py's PagedKVCache), and CoW page copies
                  are returned as (src, dst) pairs for a caller to apply.
  PagedAdmission  resolves a device byte budget into arena pages and
                  lets the engine admit by the pages a request actually
                  needs (ceil(tokens / page_size)), not by worst-case
                  max_len bytes per slot.

Pure Python: it runs on the host between engine steps, like the
Scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serve.cache import page_bytes
from repro_torch.serve.scheduler import AdmissionPolicy


class PoolExhausted(RuntimeError):
    """Raised when an allocation asks for more pages than are free."""


def pages_for(num_tokens: int, page_size: int) -> int:
    """Pages needed to hold `num_tokens` KV entries."""
    return -(-max(num_tokens, 0) // page_size)


class PagePool:
    """Fixed arena of `num_pages` KV pages, allocated from a free list.

    Pages are ref-counted: `fork` shares a prefix's FULL pages between
    two requests (copy-on-write: the partial tail page is copied, so a
    writable frontier is never shared) and `free` returns a page to the
    free list only when its last owner drops it.  The free list is LIFO:
    recently freed pages are reused first, keeping the hot arena
    footprint small.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 1 or page_size < 1:
            raise ValueError(
                f"PagePool needs num_pages >= 1 and page_size >= 1, got "
                f"{num_pages} / {page_size}")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._refcount = [0] * num_pages
        self._tables: Dict[int, List[int]] = {}   # rid -> page ids

    # -- introspection -------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refcount[page]

    def table(self, rid: int) -> List[int]:
        """The request's page ids, in token order (a copy)."""
        return list(self._tables[rid])

    def holds(self, rid: int) -> bool:
        """Whether the request currently holds an allocation."""
        return rid in self._tables

    def pages_needed(self, num_tokens: int) -> int:
        return pages_for(num_tokens, self.page_size)

    def can_allocate(self, num_tokens: int) -> bool:
        return self.pages_needed(num_tokens) <= len(self._free)

    # -- lifecycle -----------------------------------------------------
    def _take(self, n: int) -> List[int]:
        if n > len(self._free):
            raise PoolExhausted(
                f"need {n} pages but only {len(self._free)} of "
                f"{self.num_pages} are free")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._refcount[p] = 1
        return pages

    def allocate(self, rid: int, num_tokens: int) -> List[int]:
        """Allocate pages for a new request covering `num_tokens`."""
        return self.allocate_pages(rid, self.pages_needed(num_tokens))

    def allocate_pages(self, rid: int, n_pages: int) -> List[int]:
        """Allocate an explicit page COUNT."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already holds pages")
        pages = self._take(n_pages)
        self._tables[rid] = pages
        return pages

    def extend(self, rid: int, num_tokens: int) -> List[int]:
        """Grow a request's table to cover `num_tokens` total; returns
        the newly allocated pages ([] if it already fits)."""
        table = self._tables[rid]
        need = self.pages_needed(num_tokens) - len(table)
        if need <= 0:
            return []
        new = self._take(need)
        table.extend(new)
        return new

    def free(self, rid: int) -> List[int]:
        """Drop the request's references; returns the pages actually
        freed (refcount reached zero: shared prefix pages survive)."""
        freed = []
        for p in self._tables.pop(rid):
            self._refcount[p] -= 1
            if self._refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed

    def fork(self, src_rid: int, dst_rid: int,
             shared_tokens: int) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Copy-on-write fork: dst shares src's first `shared_tokens`
        tokens.  Full pages of the shared prefix are SHARED (refcount+1,
        zero copies); a partial tail page is backed by a fresh page and
        returned as a (src_page, dst_page) copy for the caller to apply
        to the arenas, so neither request can clobber the other's
        tokens.

        Returns (dst's page table so far, arena copies to perform).
        """
        if dst_rid in self._tables:
            raise ValueError(f"request {dst_rid} already holds pages")
        src = self._tables[src_rid]
        if shared_tokens > len(src) * self.page_size:
            raise ValueError(
                f"fork of {shared_tokens} tokens exceeds request "
                f"{src_rid}'s {len(src)} pages")
        full, rem = divmod(shared_tokens, self.page_size)
        shared = src[:full]
        for p in shared:
            self._refcount[p] += 1
        copies: List[Tuple[int, int]] = []
        table = list(shared)
        if rem:
            [tail] = self._take(1)
            copies.append((src[full], tail))
            table.append(tail)
        self._tables[dst_rid] = table
        return table, copies


def num_pages_for_budget(cfg, budget_bytes: int, page_size: int) -> int:
    """Arena pages (in all, the engine's reserved sink page included)
    that fit a device byte budget for this config."""
    return budget_bytes // page_bytes(cfg, page_size)


@dataclasses.dataclass(frozen=True)
class PagedAdmission(AdmissionPolicy):
    """Admit by free PAGES instead of worst-case bytes.

    The byte budget buys `num_pages = budget // page_bytes(cfg)` arena
    pages (one of them the engine's reserved write sink).  A request is
    admitted when ceil((prompt + max_new - 1) / page_size) pages are
    free, its ACTUAL footprint, so at the same budget a long-context
    request that ByteBudget's per-slot max_len charge would refuse is
    admissible as long as its tokens fit.  `max_slots` bounds the batch,
    not memory.
    """

    budget_bytes: int
    page_size: int = 16
    max_slots: int = 4
    num_pages: Optional[int] = None   # override: skip the budget math

    def resolve_num_pages(self, cfg) -> int:
        n = self.num_pages if self.num_pages is not None else \
            num_pages_for_budget(cfg, self.budget_bytes, self.page_size)
        if n < 2:
            raise ValueError(
                f"byte budget {self.budget_bytes} buys {n} page(s) of "
                f"{page_bytes(cfg, self.page_size)} bytes "
                f"(page_size={self.page_size}); the paged arena needs "
                f">= 2 (one allocatable + the reserved sink page)")
        return int(n)

    def resolve_slots(self, cfg, max_len: int) -> int:
        if self.max_slots < 1:
            raise ValueError(
                f"PagedAdmission needs >= 1 slot, got {self.max_slots}")
        self.resolve_num_pages(cfg)   # fail fast on impossible budgets
        return self.max_slots
