"""The train step (port of `repro/train/step.py::build_train_step`).

`build_train_step(cfg, train_cfg)` returns step(params, opt_state,
batch, step_idx) -> (params, opt_state, metrics):

  * gradients of `models.model.loss_fn` by `torch.autograd.grad` over
    the param leaves, with microbatched accumulation in f32 when
    `train_cfg.microbatch > 1` (the batch dim split in that many parts);
  * a non-finite loss raises FloatingPointError BEFORE the update, so
    a failed step leaves params and moments as they were (the reference
    discards the new pytrees instead);
  * the cosine warmup/decay rate and AdamW (in place), with global-norm
    clipping;
  * mixed precision as in the reference: f32 params and moments, the
    model computing in cfg.compute_dtype.

The compressed (int8 error-feedback) step waits for the multi-GPU
slice (ROADMAP.md queue 1 item 14).
"""
from __future__ import annotations

import torch

from repro_torch.models import model as mdl
from repro_torch.optim import adamw, schedules
from repro_torch.tree import leaves

F32 = torch.float32


def _microbatches(batch, n: int):
    """Split every batch entry along dim 0 into n equal parts."""
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: v[i * (b // n):(i + 1) * (b // n)] for k, v in batch.items()}
            for i in range(n)]


def build_train_step(cfg, train_cfg):
    """Returns step(params, opt_state, batch, step_idx) -> (...)."""
    def lr_at(step_idx):
        return schedules.cosine_warmup_decay(
            step_idx, max_lr=train_cfg.learning_rate,
            min_lr=train_cfg.min_learning_rate,
            warmup_steps=train_cfg.warmup_steps,
            total_steps=train_cfg.total_steps)

    def grad_fn(ps, params, batch):
        l, aux = mdl.loss_fn(params, cfg, batch)
        return l.detach(), {k: v.detach() for k, v in aux.items()}, \
            torch.autograd.grad(l, ps)

    def compute_grads(params, batch):
        ps = leaves(params)
        for p in ps:
            if not p.requires_grad:
                p.requires_grad_(True)
        n = train_cfg.microbatch
        if n and n > 1:
            acc = [torch.zeros(p.shape, dtype=F32, device=p.device)
                   for p in ps]
            losses, ces, auxes = [], [], []
            for mb in _microbatches(batch, n):
                l, aux, gs = grad_fn(ps, params, mb)
                for a, g in zip(acc, gs):
                    a.add_(g.float())
                losses.append(l)
                ces.append(aux["ce"])
                auxes.append(aux["aux"])
            grads = [a / n for a in acc]
            metrics = {"loss": torch.stack(losses).mean(),
                       "ce": torch.stack(ces).mean(),
                       "aux": torch.stack(auxes).mean()}
        else:
            l, aux, grads = grad_fn(ps, params, batch)
            metrics = {"loss": l, **aux}
        return grads, metrics

    def step(params, opt_state, batch, step_idx):
        grads, metrics = compute_grads(params, batch)
        if not bool(torch.isfinite(metrics["loss"])):
            raise FloatingPointError(
                f"non-finite loss {float(metrics['loss'])} at step "
                f"{step_idx}; params not updated")
        lr = lr_at(step_idx)
        params, opt_state, om = adamw.apply(
            params, grads, opt_state, lr=lr, beta1=train_cfg.beta1,
            beta2=train_cfg.beta2, weight_decay=train_cfg.weight_decay,
            grad_clip=train_cfg.grad_clip)
        metrics.update(om)
        metrics["lr"] = lr
        return params, opt_state, metrics

    return step
