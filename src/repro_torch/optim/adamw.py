"""AdamW with decoupled weight decay and global-norm clipping.

Port of `repro/optim/adamw.py`.  Moments are f32 whatever the param
dtype; decay applies to >=2-D params only (norms and biases skip it).
Where the reference returns new pytrees, this updates the params and
the moments IN PLACE, one leaf at a time, so the update's temporaries
never exceed one leaf: at full width the params, grads and two moments
already take 16 bytes per parameter.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import leaves

F32 = torch.float32


class AdamWState(NamedTuple):
    step: int
    mu: list      # f32 tensors, one per param leaf
    nu: list


def init(params) -> AdamWState:
    zeros = [torch.zeros(p.shape, dtype=F32, device=p.device)
             for p in leaves(params)]
    return AdamWState(step=0, mu=zeros,
                      nu=[torch.zeros_like(z) for z in zeros])


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every grad, f32 (a 0-d tensor)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


@torch.no_grad()
def apply(params, grads, state: AdamWState, *, lr, beta1=0.9, beta2=0.95,
          eps=1e-8, weight_decay=0.1, grad_clip=0.0):
    """One AdamW step.  grads: one tensor per leaf of `params`, in the
    order of `tree.leaves`.  Updates params and moments in place and
    returns (params, new state, {"grad_norm": the norm before clipping})."""
    ps = leaves(params)
    if len(grads) != len(ps):
        raise ValueError(f"{len(grads)} grads for {len(ps)} params")
    gnorm = global_norm(grads)
    scale = None
    if grad_clip:
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    step = state.step + 1
    b1c = 1 - beta1 ** step
    b2c = 1 - beta2 ** step
    for p, g, mu, nu in zip(ps, grads, state.mu, state.nu):
        g = g.float() if scale is None else g.float() * scale
        mu.mul_(beta1).add_(g, alpha=1 - beta1)
        nu.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        delta = (mu / b1c) / (torch.sqrt(nu / b2c) + eps)
        if p.dim() >= 2 and weight_decay:
            delta.add_(p.float(), alpha=weight_decay)
        p.copy_(p.float() - lr * delta)
    return params, AdamWState(step, state.mu, state.nu), {"grad_norm": gnorm}
