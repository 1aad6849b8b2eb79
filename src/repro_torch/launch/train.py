"""Training launcher: --arch / --steps CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch pythia-1.4b \
        --steps 50 --batch 8 --seq 128 [--full] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-2.7b \
        --device cpu --steps 5 --batch 2 --seq 32

Flag names follow `repro/launch/train.py` for the flags kept; the
checkpoint (`--checkpoint-dir`, `--resume`) and autotune
(`--autotune`, `--tune-cache`) flags wait for their slices (ROADMAP.md).
Weights are random from the train config's seed and data is
`SyntheticLM` from the same seed.  `--backend` swaps the attention
backend and is refused for an architecture without attention
(mamba2-2.7b, whose mixer is fixed).  `--full` trains the full-width
config instead of the smoke one; `--device` defaults to cuda and raises
without a card.  Prints one JSON record: first_loss, last_loss, steps,
stragglers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.mixers import get_backend
from repro_torch.models import model as mdl
from repro_torch.train.loop import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="pythia-1.4b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--backend", default=None,
                    help="attention backend (linear: the paper's; gla: "
                         "its decay-gated variant; softmax: the baseline)")
    ap.add_argument("--full", action="store_true",
                    help="full-width config instead of the smoke one")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    if args.backend:
        if cfg.mixer != "attention":
            ap.error(f"--backend switches the attention backend; "
                     f"{args.arch} has no attention (mixer {cfg.mixer!r})")
        cfg = dataclasses.replace(cfg, attention_backend=args.backend)
    get_backend(cfg)  # fail fast on a bad --backend, naming the valid ones
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1))
    params = mdl.init_params(cfg, seed=tc.seed, device=args.device)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=tc.seed)
    trainer = Trainer(cfg, tc, params, data)
    history = trainer.run(args.steps)
    record = {"first_loss": history[0]["loss"],
              "last_loss": history[-1]["loss"],
              "steps": len(history),
              "stragglers": trainer.monitor.flagged}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
