"""LR schedules — cosine warmup/decay per the paper's §5.2 recipe
(min 5e-5, max 1e-3, cosine warmup and decay).  Port of
`repro/optim/schedules.py`; the step is a host integer, so the rate is
a Python float."""
from __future__ import annotations

import math


def cosine_warmup_decay(step, *, max_lr: float, min_lr: float,
                        warmup_steps: int, total_steps: int) -> float:
    """Linear warmup to max_lr, cosine decay to min_lr."""
    step = float(step)
    if step < warmup_steps:
        return max_lr * step / max(warmup_steps, 1)
    t = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                0.0), 1.0)
    return min_lr + 0.5 * (max_lr - min_lr) * (1 + math.cos(math.pi * t))
