"""Training launcher: --arch / --steps CLI.

    PYTHONPATH=src python -m repro_torch.launch.train --arch pythia-1.4b \
        --steps 50 --batch 8 --seq 128 [--full] [--device cuda]
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
        --device cpu --steps 5 --batch 2 --seq 32
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --steps 4 --checkpoint-dir ckpt; ... --steps 6 --resume

Flag names follow `repro/launch/train.py` for the flags kept; the
autotune flags (`--autotune`, `--tune-cache`) wait for their slice
(ROADMAP.md). Checkpoints go to `--checkpoint-dir` (default
`checkpoints`) every max(steps // 2, 1) steps, asynchronously, and a
failed step rolls back to the newest one; `--resume` restores the newest
before training and then trains up to `--steps` in all, as the
reference does. `--arch` takes
every id of `configs/registry.py` but whisper-large-v3, whose encoder
frames SyntheticLM does not make (as in the reference;
`repro_torch.launch.family_refusal`). Weights are random from the train
config's seed and data is `SyntheticLM` from the same seed;
qwen2-vl-7b's batches add M-RoPE positions of an image grid then text
(`models/frontends.py::StubBatches`). `--backend` swaps the
attention backend as the reference does (mamba2-2.7b and
deepseek-v2-236b, whose MLA mixer always runs the linear scores, ignore
it; zamba2-7b refuses softmax and gla, whose kernels do not take its
head dim 112 yet). The MoE family (moonshot-v1-16b-a3b,
deepseek-v2-236b) adds its load-balancing loss to the objective.
`--full` trains the full-width config instead of the smoke one;
`--device` defaults to cuda and raises without a card. Prints one JSON
record: first_loss, last_loss, steps (those this run trained),
stragglers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import backend_refusal, family_refusal
from repro_torch.mixers import get_backend
from repro_torch.models import model as mdl
from repro_torch.models.frontends import StubBatches
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
    ap.add_argument("--checkpoint-dir", default="checkpoints")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain path)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=not args.full)
    refusal = family_refusal(cfg, serving=False)
    if refusal:
        ap.error(refusal)
    if args.backend:
        refusal = backend_refusal(cfg, args.backend, serving=False)
        if refusal:
            ap.error(refusal)
        cfg = dataclasses.replace(cfg, attention_backend=args.backend)
    get_backend(cfg)  # fail fast on a bad --backend, naming the valid ones
    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     warmup_steps=max(args.steps // 10, 1),
                     checkpoint_every=max(args.steps // 2, 1),
                     checkpoint_dir=args.checkpoint_dir)
    params = mdl.init_params(cfg, seed=tc.seed, device=args.device)
    data = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=tc.seed)
    if cfg.rope_kind == "mrope":
        data = StubBatches(cfg, data, device=args.device)
    trainer = Trainer(cfg, tc, params, data)
    if args.resume:
        trainer.try_restore()
    history = trainer.run(args.steps - trainer.step_idx)
    record = {"first_loss": history[0]["loss"],
              "last_loss": history[-1]["loss"],
              "steps": len(history),
              "stragglers": trainer.monitor.flagged}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
