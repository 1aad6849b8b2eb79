"""Trainer: the fault-tolerant outer loop (port of `repro/train/loop.py`).

  * checkpoint/restart — an async checkpoint (`checkpoint/store.py`) of
    {"params", "opt"} every `checkpoint_every` steps; on a failed step
    (an exception, or a non-finite loss, which the step raises before
    touching the params) the newest checkpoint is restored and the data
    stream replayed from its step (`batch_at` is index-deterministic);
    with no checkpoint yet the same step is retried fresh;
  * straggler tracking — per-step wall time against a running median;
    a step slower than `straggler_threshold x median` is counted, and
    `needs_remesh` says when they persist (the elastic re-mesh that
    reads it comes with the multi-GPU slice);
  * bounded retry — `max_retries` consecutive failures re-raise.

Where it differs from the reference, deliberately: `try_restore` first
waits for a pending save, so which checkpoint a rollback finds does not
depend on the writer's speed; a writer's exception is raised by the
next `save`, `try_restore` or the end of `run`, never dropped; restore
copies into the live tensors in place.  The step time is taken on the
port's one host clock around a device synchronize, so it includes the
step's device work.
"""
from __future__ import annotations

import logging
import math
import statistics

import numpy as np
import torch

from repro_torch.checkpoint import store
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

    @property
    def needs_remesh(self) -> bool:
        # persistent stragglers: >10% of recent steps flagged
        recent = min(len(self.times), self.window)
        return recent >= 20 and self.flagged > 0.1 * recent


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
        self._pending_save = None

    def _batch(self, i: int) -> dict:
        b = self.data_it.batch_at(i)
        if isinstance(b, np.ndarray):
            b = {"tokens": b}
        return {k: (v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.asarray(v))).to(self.device)
                for k, v in b.items()}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- checkpointing ------------------------------------------------
    def _tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def save(self, blocking: bool = False):
        """Checkpoint the current step; returns once every leaf is on the
        host, the files written by a thread unless `blocking`."""
        self._wait_save()
        out = store.save(self.tc.checkpoint_dir, self._tree(),
                         self.step_idx, blocking=blocking)
        if not blocking:
            self._pending_save = out[1]

    def _wait_save(self):
        if self._pending_save is not None:
            pending, self._pending_save = self._pending_save, None
            pending.join()

    def try_restore(self) -> bool:
        self._wait_save()
        step = store.latest_step(self.tc.checkpoint_dir)
        if step is None:
            return False
        tree, step = store.restore(self.tc.checkpoint_dir, self._tree(),
                                   step)
        self.params, self.opt_state = tree["params"], tree["opt"]
        self.step_idx = step
        self._sync()
        log.info("restored checkpoint at step %d", step)
        return True

    # -- the loop -----------------------------------------------------
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
                log.warning("step %d failed (%s); retry %d/%d from last "
                            "checkpoint", self.step_idx, e, retries,
                            self.max_retries)
                if retries > self.max_retries:
                    raise
                # replay from the newest checkpoint, or with none yet
                # retry the same step fresh
                self.try_restore()
                continue
            retries = 0
            dt = now() - t0
            slow = self.monitor.record(dt)
            self.history.append({"step": self.step_idx, "loss": loss,
                                 "dt": dt, "straggler": slow})
            self.step_idx += 1
            if self.tc.checkpoint_every and \
                    self.step_idx % self.tc.checkpoint_every == 0:
                self.save(blocking=False)
        self._wait_save()
        return self.history
