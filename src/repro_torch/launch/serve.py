"""Serving launcher: batched generation through the port's engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch pythia-1.4b \
        --requests 8 --max-new 16 [--backend softmax] [--full] \
        [--device cuda]

Flag names follow `repro/launch/serve.py` for the flags kept.  Weights
are random, drawn from seed 0; prompts are random token ids drawn from
seed 0.  `--backend` swaps the attention backend (linear, the paper's,
by default; softmax, the baseline).  `--full` serves the full-width
config instead of the smoke one;
`--device` defaults to cuda and raises without a card.  Prints one JSON
record (and writes it to --json-out).
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops as _ops
from repro_torch.mixers import get_backend
from repro_torch.models import model as mdl
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.sampling import SamplingParams
from repro_torch.tune.timer import now


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pythia-1.4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--backend", default=None,
                    help="attention backend (linear: the paper's; "
                         "softmax: the baseline)")
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

    cfg = get_config(args.arch, smoke=not args.full)
    if args.backend:
        cfg = dataclasses.replace(cfg, attention_backend=args.backend)
    get_backend(cfg)  # fail fast on a bad --backend, naming the valid ones
    params = mdl.init_params(cfg, seed=0, device=args.device)
    engine = Engine(cfg, params, max_slots=args.slots, max_len=args.max_len,
                    prefill_chunk=args.prefill_chunk, device=args.device)
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
    done = engine.run()
    dt = now() - t0
    total_tokens = sum(len(v) for v in done.values())
    record = {
        "arch": args.arch,
        "full": args.full,
        "device": str(engine.device),
        "backend": engine.cfg.attention_backend,
        "kernel": _ops.resolve_impl(engine.cfg.la.backend, engine.device),
        "slots": engine.num_slots,
        "requests": len(done),
        "generated_tokens": total_tokens,
        "decode_steps": engine.decode_steps,
        "wall_s": dt,
        "tokens_per_s": total_tokens / dt,
    }
    print(json.dumps(record))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=2)
    return record


if __name__ == "__main__":
    main()
