"""Numerical helpers shared by the linear-attention core (paper §3.3)."""
from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1,
                 eps: float = 1e-6) -> torch.Tensor:
    """Row-wise l2 normalization, paper Eq. 22: q_i <- q_i / ||q_i||.

    x / sqrt(sum x^2 + eps), with eps INSIDE the sqrt (this is not
    `F.normalize`, which clamps the norm), computed in f32 and cast back
    so bf16 inputs do not lose the scale.
    """
    xf = x.float()
    inv = 1.0 / torch.sqrt((xf * xf).sum(dim=dim, keepdim=True) + eps)
    return (xf * inv).to(x.dtype)


def safe_div(num: torch.Tensor, den: torch.Tensor,
             eps: float = 1e-30) -> torch.Tensor:
    """num / den with |den| < eps (padding rows) mapped to 0."""
    zero = den.abs() < eps
    den_safe = torch.where(zero, torch.ones_like(den), den)
    return torch.where(zero, torch.zeros_like(num), num / den_safe)
