"""Trainer: the outer training loop (port of `repro/train/loop.py`).

  * straggler tracking — per-step wall time against a running median;
    a step slower than `straggler_threshold x median` is counted (the
    elastic re-mesh that reads the count comes with the multi-GPU
    slice);
  * bounded retry — a failed step (an exception, or a non-finite loss,
    which the step raises before touching the params) is retried fresh
    from the same batch index, as the reference does when it has no
    checkpoint yet; `max_retries` consecutive failures re-raise.

Checkpoint save and restore wait for the checkpoint slice (ROADMAP.md
queue 1 item 14).  The step time is taken on the port's one host clock
around a device synchronize, so it includes the step's device work.
"""
from __future__ import annotations

import logging
import math
import statistics

import numpy as np
import torch

from repro_torch.optim import adamw
from repro_torch.train.step import build_train_step
from repro_torch.tree import leaves
from repro_torch.tune.timer import now

log = logging.getLogger("repro_torch.train")


class StragglerMonitor:
    def __init__(self, threshold: float = 3.0, window: int = 50):
        self.threshold = threshold
        self.times: list[float] = []
        self.window = window
        self.flagged = 0

    def record(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        is_straggler = False
        if len(self.times) >= 5:
            med = statistics.median(self.times[-self.window:])
            is_straggler = dt > self.threshold * med
        self.times.append(dt)
        if is_straggler:
            self.flagged += 1
        return is_straggler


class Trainer:
    def __init__(self, cfg, train_cfg, params, data_it, *, step_fn=None,
                 max_retries: int = 3):
        self.cfg = cfg
        self.tc = train_cfg
        self.params = params
        self.device = leaves(params)[0].device
        self.opt_state = adamw.init(params)
        self.data_it = data_it
        self.step_fn = step_fn or build_train_step(cfg, train_cfg)
        self.monitor = StragglerMonitor(train_cfg.straggler_threshold)
        self.max_retries = max_retries
        self.step_idx = 0
        self.history: list[dict] = []

    def _batch(self, i: int) -> dict:
        b = self.data_it.batch_at(i)
        if isinstance(b, np.ndarray):
            b = {"tokens": b}
        return {k: torch.from_numpy(np.asarray(v)).to(self.device)
                for k, v in b.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, num_steps: int, fail_injector=None):
        """Train for num_steps (from the current step_idx)."""
        retries = 0
        target = self.step_idx + num_steps
        while self.step_idx < target:
            batch = self._batch(self.step_idx)
            t0 = now()
            try:
                if fail_injector is not None:
                    fail_injector(self.step_idx)
                params, opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch, self.step_idx)
                loss = float(metrics["loss"])
                if not math.isfinite(loss):
                    raise FloatingPointError(
                        f"non-finite loss {loss} at step {self.step_idx}")
                self.params, self.opt_state = params, opt_state
                self._sync()
            except Exception as e:  # noqa: BLE001 — the step-failure path
                retries += 1
                log.warning("step %d failed (%s); retry %d/%d", self.step_idx,
                            e, retries, self.max_retries)
                if retries > self.max_retries:
                    raise
                continue  # no checkpoint: retry the same step fresh
            retries = 0
            dt = now() - t0
            slow = self.monitor.record(dt)
            self.history.append({"step": self.step_idx, "loss": loss,
                                 "dt": dt, "straggler": slow})
            self.step_idx += 1
        return self.history
