"""Rotary position embeddings: standard and partial (pythia, stablelm).

Port of `repro/models/rope.py`; M-RoPE (qwen2-vl) comes with the vision
slice.  q/k are (B, H, N, D); positions are (B, N).
"""
from __future__ import annotations

import torch

F32 = torch.float32


def _rope_angles(positions, dim: int, theta: float):
    """positions (..., N) -> cos/sin (..., N, dim/2)."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=F32,
                                       device=positions.device) / dim)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """Rotate-half (GPT-NeoX style) on the last dim. x: (..., N, dim)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def apply_rope(x, positions, kind: str = "standard", fraction: float = 1.0,
               theta: float = 10000.0):
    """x: (B, H, N, D); positions: (B, N).  Computed in f32, cast back;
    `partial` rotates the first int(D * fraction) dims (even-rounded)."""
    if kind in ("none", "sinusoid"):
        return x
    if kind not in ("standard", "partial"):
        raise NotImplementedError(
            f"rope kind {kind!r} is not ported yet (M-RoPE waits for the "
            f"vision slice, ROADMAP.md queue 1 'Remaining architectures')")
    d = x.shape[-1]
    xf = x.float()
    rot_dim = d if kind == "standard" else int(d * fraction)
    rot_dim -= rot_dim % 2
    cos, sin = _rope_angles(positions, rot_dim, theta)   # (B, N, rot/2)
    cos, sin = cos[:, None], sin[:, None]                # broadcast heads
    x_rot = _rotate(xf[..., :rot_dim], cos, sin)
    if rot_dim < d:
        x_rot = torch.cat([x_rot, xf[..., rot_dim:]], -1)
    return x_rot.to(x.dtype)
