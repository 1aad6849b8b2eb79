"""Serving launcher: batched generation through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch pythia-1.4b \
        --requests 8 --max-new 16 [--backend softmax|gla] [--full] \
        [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \
        --device cpu --requests 3 --max-new 4

Flag names follow `repro/launch/serve.py` for the flags kept.  Weights
are random, drawn from seed 0; prompts are random token ids drawn from
seed 0.  `--backend` swaps the attention backend (linear, the paper's,
by default; gla, its decay-gated variant; softmax, the baseline); it
is refused for an architecture without attention (mamba2-2.7b, whose
mixer is fixed), and so is paging there (`get_backend`).
`--full` serves the full-width config instead of the smoke one;
`--device` defaults to cuda and raises without a card.  Admission
defaults to fixed slots; `--budget-mb` switches to ByteBudget (the slot
count then resolves from the backend's exact per-slot decode-cache
bytes).  `--page-size` switches to a paged cache: KV pages of that many
tokens for softmax, one recurrent-state page per request for gla (the
token count is then ignored).  With `--budget-mb` the budget buys the
arena (PagedAdmission: requests admit by the pages they actually need),
otherwise `--num-pages` (or a worst-case default) sizes it.
Prints one JSON record, with a `paging` record (page stats and
`peak_pages_in_use`) when paged, and writes it to --json-out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops as _ops
from repro_torch.mixers import get_backend, resolve_backend_name
from repro_torch.models import model as mdl
from repro_torch.serve.cache import per_slot_bytes
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.paging import PagedAdmission
from repro_torch.serve.sampling import SamplingParams
from repro_torch.serve.scheduler import ByteBudget, FixedSlots
from repro_torch.tune.timer import now


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pythia-1.4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--backend", default=None,
                    help="attention backend (linear: the paper's; gla: "
                         "its decay-gated variant; softmax: the baseline)")
    ap.add_argument("--budget-mb", type=float, default=None,
                    help="ByteBudget admission instead of fixed slots "
                         "(with --page-size: PagedAdmission)")
    ap.add_argument("--page-size", type=int, default=None,
                    help="paged cache: tokens per KV page (softmax), or "
                         "the paged recurrent-state arena (gla: one state "
                         "page per request, the token count is ignored)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="paged arena pages incl. the reserved sink "
                         "(default: worst case for every slot)")
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="chunked prefill window (tokens)")
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--json-out", default=None,
                    help="also write the result record to this path")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the smoke one")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)

    if args.num_pages is not None and args.page_size is None:
        ap.error("--num-pages requires --page-size (it sizes the paged "
                 "arena; without a page size the cache stays contiguous)")
    cfg = get_config(args.arch, smoke=not args.full)
    if args.backend:
        if cfg.mixer != "attention":
            ap.error(f"--backend switches the attention backend; "
                     f"{args.arch} has no attention (mixer {cfg.mixer!r})")
        cfg = dataclasses.replace(cfg, attention_backend=args.backend)
    get_backend(cfg)  # fail fast on a bad --backend, naming the valid ones
    params = mdl.init_params(cfg, seed=0, device=args.device)
    page_kwargs = {}
    if args.budget_mb is not None and args.page_size is not None:
        policy = PagedAdmission(int(args.budget_mb * 1024 * 1024),
                                page_size=args.page_size,
                                max_slots=args.slots,
                                num_pages=args.num_pages)
    elif args.budget_mb is not None:
        policy = ByteBudget(int(args.budget_mb * 1024 * 1024))
    else:
        policy = FixedSlots(args.slots)
        page_kwargs = {"page_size": args.page_size,
                       "num_pages": args.num_pages}
    engine = Engine(cfg, params, max_len=args.max_len, policy=policy,
                    prefill_chunk=args.prefill_chunk, device=args.device,
                    **page_kwargs)
    del params   # the engine keeps its compute-dtype copy

    sp = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                        top_p=args.top_p)
    rng = np.random.default_rng(0)
    for rid in range(args.requests):
        prompt = rng.integers(3, cfg.vocab_size,
                              size=args.prompt_len).tolist()
        engine.submit(Request(rid=rid, prompt=prompt,
                              max_new_tokens=args.max_new, sampling=sp))
    t0 = now()
    done, peak_pages = {}, 0
    for out in engine.stream():
        if engine.pool is not None:
            peak_pages = max(peak_pages, engine.pool.pages_in_use)
        if out.finished:
            done[out.rid] = engine.request(out.rid).generated
    dt = now() - t0
    total_tokens = sum(len(v) for v in done.values())
    record = {
        "arch": args.arch,
        "full": args.full,
        "device": str(engine.device),
        "backend": resolve_backend_name(engine.cfg),
        "kernel": _ops.resolve_impl(engine.cfg.la.backend, engine.device),
        "policy": type(engine.policy).__name__,
        "slots": engine.num_slots,
        "per_slot_bytes": per_slot_bytes(cfg, args.max_len),
        "requests": len(done),
        "generated_tokens": total_tokens,
        "decode_steps": engine.decode_steps,
        "wall_s": dt,
        "tokens_per_s": total_tokens / dt,
    }
    if engine.pool is not None:
        record["paging"] = dict(engine.page_stats(),
                                peak_pages_in_use=peak_pages)
    print(json.dumps(record))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=2)
    return record


if __name__ == "__main__":
    main()
